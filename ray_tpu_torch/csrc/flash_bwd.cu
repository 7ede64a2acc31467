// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel, plain C entry points.
//
// Replace the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkdv_kernel`
// (ray_tpu/ops/attention.py, launched by `_flash_backward`). Both recompute
// the probabilities from the forward's logsumexp, P = exp(scale * Q Kᵀ -
// lse) (masked entries are exactly 0), and take δ = rowsum(dO ∘ O), which
// the wrapper computes in float32 outside the kernels as the TPU path does.
//
//   q, dO  [B, Hq, Sq, D]    k, v [B, Hkv, Sk, D]    (contiguous, f32 or bf16)
//   lse, δ [B, Hq, Sq]       float32
//   dQ     [B, Hq, Sq, D]    dK, dV [B, Hkv, Sk, D]  (input dtype)
//
// Rounding points, as in the TPU kernels: dS = P ∘ (dO Vᵀ − δ) · scale is
// rounded to q's dtype before both the dQ product and the dK product (the
// scale is inside dS, so no scale is applied after them), and P is rounded
// to dO's dtype before the dV product.
//
// Design. dQ: one block per (64-row q tile, q head, batch row) walks the k
// tiles up to the diagonal and keeps dQ in registers, so no atomics. dK/dV:
// one block per (64-row k tile, kv head, batch row) walks every q tile at
// or below the diagonal for each q head of its GQA group, so the sum over
// the group is taken in float32 inside the block: no atomics and no
// [B, Hq, S, D] intermediate (the TPU kernel writes dK/dV at q-head count
// and the caller sums them). Ragged tails are zero-filled and masked.
//
// Bound on this card: operations (three 64 x 64 x D products per tile pair
// for dQ, four for dK/dV). As in flash_fwd.cu, they run as float32 FMAs
// from shared memory, not on the tensor cores. Both kernels here serve the
// float32 route; bf16 takes flash_dq_sm90.cu and flash_dkdv_sm90.cu
// (wgmma, TMA). They still take bf16 inputs, so chip_smoke.py times them
// on bf16 beside the kernels that replace them there.

#include "flash_common.cuh"

namespace {

using namespace flash;

// p[i][j] = P and ds[i][j] = dS (rounded to T) for the thread's 4 x 4 block of the
// (q tile at q0) x (k tile at k0) pair, from Q/K/dO/V tiles in smem.
template <typename T, int D>
__device__ __forceinline__ void probs_and_ds(
    const float* q_s, const float* k_s, const float* do_s, const float* v_s,
    const float (&lse_r)[4], const float (&dl_r)[4], int q0, int k0, int sq,
    int sk, float scale, int causal, int ty, int tx, float (&p)[4][4],
    float (&ds)[4][4]) {
  float s[4][4] = {}, dp[4][4] = {};
  tile_abt<D>(q_s, k_s, ty, tx, s);
  tile_abt<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = live(q0 + ty * 4 + i, k0 + tx + 16 * j, sq, sk, causal);
      // masked scores (-1e30 on the TPU) underflow to p = 0
      p[i][j] = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
      ds[i][j] = round_to<T>(p[i][j] * (dp[i][j] - dl_r[i]) * scale);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int hq, int hkv, int sq, int sk,
                float scale, int causal) {
  using Dm = Dims<D>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + Dm::kTile;
  float* k_s = do_s + Dm::kTile;
  float* v_s = k_s + Dm::kTile;
  float* ds_s = v_s + Dm::kTile;           // [64 q][kSStride]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBlock;
  const int hk = h / (hq / hkv);
  const size_t qoff = ((size_t)b * hq + h) * sq;
  const size_t koff = ((size_t)b * hkv + hk) * sk;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<T, D>(q_s, q + qoff * D, q0, sq);
  load_tile<T, D>(do_s, dout + qoff * D, q0, sq);
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    lse_r[i] = qi < sq ? lse[qoff + qi] : 0.f;
    dl_r[i] = qi < sq ? delta[qoff + qi] : 0.f;
  }

  float acc[4][Dm::kCols] = {};
  int n_kt = (sk + kBlock - 1) / kBlock;
  if (causal) n_kt = min(n_kt, (q0 + kBlock - 1) / kBlock + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();
    load_tile<T, D>(k_s, k + koff * D, k0, sk);
    load_tile<T, D>(v_s, v + koff * D, k0, sk);
    __syncthreads();

    float p[4][4], ds[4][4];
    probs_and_ds<T, D>(q_s, k_s, do_s, v_s, lse_r, dl_r, q0, k0, sq, sk, scale,
                       causal, ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ds_s[(ty * 4 + i) * kSStride + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // acc[i][c] += sum_kk dS[ty*4 + i][kk] * K[kk][tx + 16c]
#pragma unroll 2
    for (int kk = 0; kk < kBlock; kk += 4) {
      float4 dv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dv4[i] = *reinterpret_cast<const float4*>(ds_s + (ty * 4 + i) * kSStride + kk);
#pragma unroll
      for (int c = 0; c < Dm::kCols; ++c) {
        const float* kc = k_s + kk * Dm::kStride + tx + 16 * c;
        const float k0v = kc[0], k1v = kc[Dm::kStride], k2v = kc[2 * Dm::kStride],
                    k3v = kc[3 * Dm::kStride];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][c];
          a = fmaf(dv4[i].x, k0v, a);
          a = fmaf(dv4[i].y, k1v, a);
          a = fmaf(dv4[i].z, k2v, a);
          a = fmaf(dv4[i].w, k3v, a);
          acc[i][c] = a;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= sq) continue;
    T* row = dq + (qoff + qi) * D;
#pragma unroll
    for (int c = 0; c < Dm::kCols; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv,
                  int sq, int sk, float scale, int causal) {
  using Dm = Dims<D>;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + Dm::kTile;
  float* q_s = v_s + Dm::kTile;
  float* do_s = q_s + Dm::kTile;
  float* p_s = do_s + Dm::kTile;           // [64 q][kSStride]
  float* ds_s = p_s + kBlock * kSStride;   // [64 q][kSStride]

  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kBlock;
  const int rep = hq / hkv;
  const size_t koff = ((size_t)b * hkv + hk) * sk;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<T, D>(k_s, k + koff * D, k0, sk);
  load_tile<T, D>(v_s, v + koff * D, k0, sk);

  // Rows of dK/dV this thread owns: k rows ty*4 + i, columns tx + 16c.
  float dk_acc[4][Dm::kCols] = {}, dv_acc[4][Dm::kCols] = {};
  const int n_qt = (sq + kBlock - 1) / kBlock;
  // Causal: q tiles with q_start + 63 >= k_start only.
  const int qt0 = causal ? blockIdx.x : 0;
  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const size_t qoff = ((size_t)b * hq + h) * sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();
      load_tile<T, D>(q_s, q + qoff * D, q0, sq);
      load_tile<T, D>(do_s, dout + qoff * D, q0, sq);
      float lse_r[4], dl_r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        lse_r[i] = qi < sq ? lse[qoff + qi] : 0.f;
        dl_r[i] = qi < sq ? delta[qoff + qi] : 0.f;
      }
      __syncthreads();

      // Scores with q rows ty*4 + i and k columns tx + 16j.
      float p[4][4], ds[4][4];
      probs_and_ds<T, D>(q_s, k_s, do_s, v_s, lse_r, dl_r, q0, k0, sq, sk,
                         scale, causal, ty, tx, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = (ty * 4 + i) * kSStride + tx + 16 * j;
          p_s[at] = round_to<T>(p[i][j]);  // P rounded to dO's dtype for dV
          ds_s[at] = ds[i][j];
        }
      __syncthreads();

      // dv_acc[i][c] += sum_qq P[qq][ty*4 + i] * dO[qq][tx + 16c]
      // dk_acc[i][c] += sum_qq dS[qq][ty*4 + i] * Q[qq][tx + 16c]
#pragma unroll 2
      for (int qq = 0; qq < kBlock; ++qq) {
        const float4 pq = *reinterpret_cast<const float4*>(p_s + qq * kSStride + ty * 4);
        const float4 dq4 = *reinterpret_cast<const float4*>(ds_s + qq * kSStride + ty * 4);
        const float pr[4] = {pq.x, pq.y, pq.z, pq.w};
        const float dr[4] = {dq4.x, dq4.y, dq4.z, dq4.w};
#pragma unroll
        for (int c = 0; c < Dm::kCols; ++c) {
          const float dov = do_s[qq * Dm::kStride + tx + 16 * c];
          const float qv = q_s[qq * Dm::kStride + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] = fmaf(pr[i], dov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dr[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty * 4 + i;
    if (kr >= sk) continue;
    T* dkrow = dk + (koff + kr) * D;
    T* dvrow = dv + (koff + kr) * D;
#pragma unroll
    for (int c = 0; c < Dm::kCols; ++c) {
      dkrow[tx + 16 * c] = from_f<T>(dk_acc[i][c]);
      dvrow[tx + 16 * c] = from_f<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int hq,
              int hkv, int sq, int sk, float scale, int causal, cudaStream_t stream) {
  const int smem = (4 * Dims<D>::kTile + kBlock * kSStride) * (int)sizeof(float);
  auto kern = flash_dq_kernel<T, D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + kBlock - 1) / kBlock, hq, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), hq, hkv, sq, sk,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int b,
                int hq, int hkv, int sq, int sk, float scale, int causal,
                cudaStream_t stream) {
  const int smem = (4 * Dims<D>::kTile + 2 * kBlock * kSStride) * (int)sizeof(float);
  auto kern = flash_dkdv_kernel<T, D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sk + kBlock - 1) / kBlock, hkv, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      hq, hkv, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dq_dim(int d, const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int b, int hq, int hkv,
           int sq, int sk, float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dq<T, 16>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, scale, causal, s);
    case 32: return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, scale, causal, s);
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, scale, causal, s);
    case 128: return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, scale, causal, s);
    default: return -1;
  }
}

template <typename T>
int dkdv_dim(int d, const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, int b, int hq,
             int hkv, int sq, int sk, float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dkdv<T, 16>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, scale, causal, s);
    case 32: return launch_dkdv<T, 32>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, scale, causal, s);
    case 64: return launch_dkdv<T, 64>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, scale, causal, s);
    case 128: return launch_dkdv<T, 128>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, scale, causal, s);
    default: return -1;
  }
}

}  // namespace

// Both return 0 on success, a cudaError_t value if the launch was refused,
// or -1 for a shape or dtype no template covers (dtype 0 = float32,
// 1 = bfloat16; head_dim 16/32/64/128; Hq a multiple of Hkv).
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int b, int hq,
                               int hkv, int sq, int sk, int d, float scale,
                               int causal, int dtype, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dq_dim<float>(d, q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 1)
    return dq_dim<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, scale,
                                 causal, s);
  return -1;
}

extern "C" int flash_dkdv_launch(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int b,
                                 int hq, int hkv, int sq, int sk, int d,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dkdv_dim<float>(d, q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, scale,
                           causal, s);
  if (dtype == 1)
    return dkdv_dim<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk,
                                   scale, causal, s);
  return -1;
}
