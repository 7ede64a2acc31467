// Flash-attention forward for Hopper (sm_90a) on bf16: wgmma products fed
// by TMA. Plain C entry point.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (ray_tpu/ops/attention.py)
// on the bf16 route; float32 keeps the exact-FMA kernel of flash_fwd.cu.
// Same function as that kernel and as `flash_forward_plain`: scores
// S = scale * Q Kᵀ with masked entries at -1e30 (q_id >= k_id on absolute
// ids when causal, k_id < Sk always), an online softmax in float32, P
// rounded to bf16 before the PV product while the row sum l adds the
// unrounded P, O = acc / l in bf16, lse = m + log(max(l, 1e-30)) in float32.
// P is rounded against the running max, not the final one, as the
// exact-FMA kernel does; the difference is within one bf16 rounding of O.
//
//   q   [B, Hq, Sq, D]  k, v [B, Hkv, Sk, D]  bf16, contiguous
//   o   [B, Hq, Sq, D]  bf16     lse [B, Hq, Sq] float32
//
// Bound on this card: operations. At llama3-1b's training shape (q
// [8, 32, 2048, 64], causal) the function does 1.4e11 flops on 0.17 GB of
// inputs and outputs, ~800 flops per byte against the ~295 ridge. So every
// product runs on the tensor cores, and K/V tiles, which the 16 q tiles of
// a head share, come from L2 after their first read.
//
// Design. One block per (128-row q tile, q head, batch row), 384 threads:
//   * warpgroup 0, the producer, gives up registers (setmaxnreg 24); one
//     thread loads the Q tile once and streams 128-row K and V tiles by
//     TMA through a ring of kStages stages, each with a full and an empty
//     mbarrier;
//   * warpgroups 1 and 2, the consumers (setmaxnreg 240), own 64 q rows
//     each: S = Q Kᵀ by wgmma from shared memory (both K-major) into f32
//     registers, mask and online softmax in registers (row max and sum
//     over the quad that shares a row), O rescaled by alpha, then
//     O += P V by wgmma with P as the register A operand (the accumulator
//     layout is the A layout, sm90_common.cuh) and V MN-major from shared
//     memory. Each consumer warp releases the stage when its products are
//     done.
// GQA maps q head h to kv head h / (Hq / Hkv): nothing is repeated in
// memory. Causal tiles above the diagonal are never loaded, only the
// diagonal tile and a ragged last tile are masked, and blocks are launched
// heaviest first (blockIdx.x reversed). TMA reads rows past S as zeros.
//
// Left for later: ping-pong between the consumer warpgroups, overlap of
// the softmax with the next tile's Q Kᵀ inside a warpgroup, persistent
// blocks, TMA stores of O, clusters.
//
// Profiling: chip_smoke.py finds this kernel's device time by the name
// of its entry point with "_launch" replaced by "_kernel", so the entry
// is flash_fwd_sm90_launch and the kernel flash_fwd_sm90_kernel.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128;        // q rows per block, 64 per consumer warpgroup
constexpr int kBN = 128;        // k/v rows per streamed tile
constexpr int kStages = 2;
constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;

template <int D>
struct FwdSmem {
  using QT = Tile<D, kBM>;
  using KT = Tile<D, kBN>;
  static constexpr int kQ = 0;
  static constexpr int kK = QT::kBytes;                    // kStages K tiles
  static constexpr int kV = kK + kStages * KT::kBytes;     // kStages V tiles
  static constexpr int kBar = kV + kStages * KT::kBytes;   // q_full, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int hq,
                      int hkv, int sq, int sk, float scale, int causal) {
  using QT = Tile<D, kBM>;
  using KT = Tile<D, kBN>;
  using L = FwdSmem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest causal rows first
  const int head = blockIdx.y, b = blockIdx.z;
  const int bhq = b * hq + head, bhk = b * hkv + head / (hq / hkv);
  const int q0 = qt * kBM;
  int n_kt = (sk + kBN - 1) / kBN;
  if (causal) n_kt = min(n_kt, qt + 1);   // tiles with k0 <= q0 + kBM - 1 (kBM == kBN)

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer. Its other 127 threads have nothing to do and leave.
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, QT::kBytes);
      tma_load_tile<D, kBM>(q_s, &tm_q, q_full, q0, bhq);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        // the first pass over the ring finds every stage free
        mbar_wait(empty0 + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full0 + 8 * s, 2 * KT::kBytes);
        tma_load_tile<D, kBN>(k_s + s * KT::kBytes, &tm_k, full0 + 8 * s, j * kBN, bhk);
        tma_load_tile<D, kBN>(v_s + s * KT::kBytes, &tm_v, full0 + 8 * s, j * kBN, bhk);
      }
    }
    return;
  }

  // Consumers.
  regs_inc<240>();
  const int cw = wg - 1;                      // which 64 rows of the q tile
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = q0 + 64 * cw + 16 * warp + lane / 4;   // and row0 + 8
  const float scale_log2 = scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running max (of scale * log2(e) * S) and this thread's share of the
  // row sum, for rows row0 and row0 + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    mbar_wait(full0 + 8 * s, (j / kStages) & 1);
    const uint32_t ks = k_s + s * KT::kBytes, vs = v_s + s * KT::kBytes;

    float sc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kBN>::ss(sc, QT::kmajor(q_s, 64 * cw, kk), KT::kmajor(ks, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(sc);

    // Only the diagonal tile and a ragged last tile hold masked scores.
    const int k0 = j * kBN;
    const bool edge = k0 + kBN > sk || (causal && k0 + kBN - 1 > q0 + 64 * cw);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int r = row0 + acc_row8(i), c = k0 + acc_col(i, lane);
        if (c >= sk || (causal && c > r)) x = kNegInf;
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    // P = exp(S - m): l adds it unrounded, the PV product takes it in bf16.
    uint32_t pa[kBN / 4];
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const float p0 = exp2f(sc[i] - m[h]), p1 = exp2f(sc[i + 1] - m[h]);
      l[h] += p0 + p1;
      pa[i / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      Wgmma<D>::rs(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                   KT::mnmajor(vs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    keep(acc);
    keep(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // Epilogue: the quad's shares of l, O = acc / l in bf16, lse.
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int h = (i >> 1) & 1, r = row0 + 8 * h;
    if (r < sq)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bhq * sq + r) * D + acc_col(i, lane)) =
          __floats2bfloat162_rn(acc[i] / l[h], acc[i + 1] / l[h]);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r < sq) lse[(size_t)bhq * sq + r] = m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f));
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int b, int hq,
           int hkv, int sq, int sk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = make_tile_map<D, kBM>(&tm_q, q, b * hq, sq);
  if (rc == 0) rc = make_tile_map<D, kBN>(&tm_k, k, b * hkv, sk);
  if (rc == 0) rc = make_tile_map<D, kBN>(&tm_v, v, b * hkv, sk);
  if (rc != 0) return rc;
  auto kern = flash_fwd_sm90_kernel<D>;
  const int smem = FwdSmem<D>::kBytes;
  const cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + kBM - 1) / kBM, hq, b);
  kern<<<grid, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
                                         static_cast<float*>(lse), hq, hkv, sq, sk, scale,
                                         causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch was refused, -2
// or -3 if the TMA descriptors could not be made, or -1 for a shape or
// dtype no template covers (dtype must be 1 = bfloat16; head_dim
// 16/32/64/128; Hq a multiple of Hkv).
extern "C" int flash_fwd_sm90_launch(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int b, int hq, int hkv, int sq, int sk, int d,
                                     float scale, int causal, int dtype, void* stream) {
  if (dtype != 1 || b < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal, s);
    case 32: return launch<32>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal, s);
    case 64: return launch<64>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal, s);
    case 128: return launch<128>(q, k, v, o, lse, b, hq, hkv, sq, sk, scale, causal, s);
    default: return -1;
  }
}
