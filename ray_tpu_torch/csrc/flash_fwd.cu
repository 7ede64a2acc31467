// Flash-attention forward for Hopper (sm_90a), plain C entry point.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (ray_tpu/ops/attention.py,
// launched by `_flash_forward` through the `flash_attention` custom VJP).
// Same function: tiled attention with an online softmax in float32, causal
// tiles strictly above the diagonal skipped, GQA by mapping q head h to kv
// head h / (Hq / Hkv) (no repeated K/V in memory), and the logsumexp
// residual m + log(max(l, 1e-30)) that the backward kernels read.
//
//   q    [B, Hq, Sq, D]    k, v [B, Hkv, Sk, D]    (contiguous, f32 or bf16)
//   o    [B, Hq, Sq, D]    in the input dtype
//   lse  [B, Hq, Sq]       float32 (the TPU's lane-replicated
//                          [B, Hq, S, 128] layout is not kept)
//
// Design. One block per (64-row q tile, q head, batch row). The block
// holds its Q tile in shared memory and walks 64-row K/V tiles: scores
// S = scale * Q Kᵀ, masked entries set to -1e30, the running max m and sum
// l per row, P = exp(S - m) written to shared memory rounded to V's dtype
// (l sums the unrounded P, as the TPU kernel does), acc = acc * alpha + P V.
// Any S works: the ragged tail of a tile is zero-filled and masked.
//
// Bound on this card: operations. At llama3-1b training shapes (S 2048,
// D 64) a tile does 2 * 64 * 64 * 64 * 2 flops per 16 KB of K/V, far above
// the ~295 flops per byte ridge. This kernel runs those products as
// float32 FMAs from shared memory (4 x 4 register blocking, 16-byte shared
// loads), not on the tensor cores: exact float32 products. It is the
// forward of the float32 route; bf16 takes flash_fwd_sm90.cu (wgmma, TMA).

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                 float scale, int causal) {
  using Dm = Dims<D>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + Dm::kTile;
  float* v_s = k_s + Dm::kTile;
  float* p_s = v_s + Dm::kTile;            // [64][kSStride]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBlock;
  const int hk = h / (hq / hkv);
  const size_t qoff = ((size_t)b * hq + h) * sq;
  const size_t koff = ((size_t)b * hkv + hk) * sk;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<T, D>(q_s, q + qoff * D, q0, sq);

  float m[4], l[4], acc[4][Dm::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Dm::kCols; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (sk + kBlock - 1) / kBlock;
  // Causal: tiles with k_start <= q_start + 63 only.
  if (causal) n_kt = min(n_kt, (q0 + kBlock - 1) / kBlock + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();                       // last tile's k_s/v_s/p_s reads done
    load_tile<T, D>(k_s, k + koff * D, k0, sk);
    load_tile<T, D>(v_s, v + koff * D, k0, sk);
    __syncthreads();

    float s[4][4] = {};
    tile_abt<D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live(qi, k0 + tx + 16 * j, sq, sk, causal) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;                           // l sums the unrounded p
        // p is rounded to V's dtype before the PV product
        p_s[(ty * 4 + i) * kSStride + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(rs);
#pragma unroll
      for (int c = 0; c < Dm::kCols; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

    // acc[i][c] += sum_kk P[ty*4 + i][kk] * V[kk][tx + 16c]
#pragma unroll 2
    for (int kk = 0; kk < kBlock; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty * 4 + i) * kSStride + kk);
#pragma unroll
      for (int c = 0; c < Dm::kCols; ++c) {
        const float* vc = v_s + kk * Dm::kStride + tx + 16 * c;
        const float v0 = vc[0], v1 = vc[Dm::kStride], v2 = vc[2 * Dm::kStride],
                    v3 = vc[3 * Dm::kStride];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][c];
          a = fmaf(pv[i].x, v0, a);
          a = fmaf(pv[i].y, v1, a);
          a = fmaf(pv[i].z, v2, a);
          a = fmaf(pv[i].w, v3, a);
          acc[i][c] = a;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= sq) continue;
    T* orow = o + (qoff + qi) * D;
#pragma unroll
    for (int c = 0; c < Dm::kCols; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / l[i]);
    if (tx == 0) lse[qoff + qi] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int hq, int hkv, int sq, int sk, float scale, int causal,
           cudaStream_t stream) {
  const int smem = (3 * Dims<D>::kTile + kBlock * kSStride) * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + kBlock - 1) / kBlock, hq, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), hq, hkv, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int d, const void* q, const void* k, const void* v, void* o,
                 void* lse, int b, int hq, int hkv, int sq, int sk, float scale,
                 int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal, s);
    default: return -1;
  }
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch was refused, or
// -1 for a shape or dtype no template covers (dtype 0 = float32,
// 1 = bfloat16; head_dim 16/32/64/128; Hq a multiple of Hkv).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int b, int hq, int hkv,
                                int sq, int sk, int d, float scale, int causal,
                                int dtype, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(d, q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(d, q, k, v, o, lse, b, hq, hkv, sq, sk, scale,
                                       causal, s);
  return -1;
}
