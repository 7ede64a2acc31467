// Flash-attention dQ for Hopper (sm_90a) on bf16: wgmma products fed by
// TMA. Plain C entry point.
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` (ray_tpu/ops/attention.py)
// on the bf16 route; float32 keeps the exact-FMA dQ of flash_bwd.cu. Same
// function as that kernel and as `flash_dq_plain`: P = exp(scale * Q Kᵀ -
// lse) with masked entries exactly 0 (q_id >= k_id on absolute ids when
// causal, k_id < Sk always), dS = P ∘ (dO Vᵀ - δ) · scale rounded to bf16
// before the dQ product (the scale is inside dS), dQ = dS K accumulated in
// float32 and stored in bf16.
//
//   q, dO  [B, Hq, Sq, D] bf16     k, v [B, Hkv, Sk, D] bf16
//   lse, δ [B, Hq, Sq] float32     dQ   [B, Hq, Sq, D] bf16
//
// Bound on this card: operations. Three S x S x D products per head (half
// of each when causal): at llama3-1b's training shape (q [8, 32, 2048, 64])
// 2.1e11 flops on 0.17 GB of inputs and outputs, far above the ~295
// flops-per-byte ridge. So every product runs on the tensor cores, and the
// K/V tiles that the q tiles of a head share come from L2.
//
// Design. The forward's skeleton (flash_fwd_sm90.cu). One block per
// (q tile, q head, batch row), heaviest causal tiles first:
//   * warpgroup 0, the producer: one thread loads the block's Q and dO
//     tiles once, then streams 64-row K and V tiles by TMA through a ring
//     of kStages stages with full and empty mbarriers, over the k tiles
//     at or below the diagonal only;
//   * each consumer warpgroup owns 64 q rows. It reads its rows' lse and
//     δ once from device memory (two rows a thread, zero past Sq) and,
//     for every k tile:
//       S  = Q Kᵀ       wgmma, A = Q and B = K from shared memory, K-major
//       dP = dO Vᵀ      wgmma, A = dO, B = V, K-major
//       P  = exp2(S · scale · log2 e - lse · log2 e), masked entries 0
//       dS = P ∘ (dP - δ) · scale, rounded to bf16 as it is packed into
//            the register A operand (accumulator layout = A layout,
//            sm90_common.cuh)
//       dQ += dS K      wgmma, A = dS from registers, B = K MN-major from
//                       the same tile, as the forward reads V for P V
//     then releases the stage. A k tile wholly above the diagonal for a
//     warpgroup's rows is released without a product.
// dQ stays in f32 registers across the k walk and is stored once, in
// bf16: no atomics and no score tile in shared memory. Rows past Sq read
// as zeros (TMA), with lse = δ = 0 they give dS = 0, and are never stored.
//
// Registers. A consumer thread holds S and dP (kBN / 2 = 32 floats each),
// dQ (D / 2) and the packed dS (16). ptxas budgets each thread by
// __launch_bounds__: 168 registers at 384 threads. D <= 64 runs two
// consumer warpgroups (128-row q tiles, 384 threads, setmaxnreg 24/240);
// D = 128 (dQ alone is 64 registers) runs one (64-row q tiles, 256
// threads, a 255-register budget), as flash_dkdv_sm90.cu does.
//
// Left for later: overlap of one tile's dQ product with the next tile's
// S and dP, ping-pong between the consumer warpgroups, persistent blocks,
// TMA stores of dQ, clusters.
//
// Profiling: chip_smoke.py finds this kernel's device time by the name
// of its entry point with "_launch" replaced by "_kernel", so the entry
// is flash_dq_sm90_launch and the kernel flash_dq_sm90_kernel.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kBN = 64;         // k/v rows per streamed tile
constexpr int kStages = 3;

template <int D>
struct DqCfg {
  static constexpr int kConsumers = D == 128 ? 1 : 2;   // warpgroups of 64 q rows
  static constexpr int kBM = 64 * kConsumers;            // q rows per block
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kConsumerWarps = 4 * kConsumers;
};

template <int D>
struct DqSmem {
  using QT = Tile<D, DqCfg<D>::kBM>;
  using KT = Tile<D, kBN>;
  static constexpr int kQ = 0;
  static constexpr int kDO = QT::kBytes;
  static constexpr int kK = 2 * QT::kBytes;                 // kStages K tiles
  static constexpr int kV = kK + kStages * KT::kBytes;      // kStages V tiles
  static constexpr int kBar = kV + kStages * KT::kBytes;    // q_full, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int hq, int hkv, int sq, int sk,
                     float scale, int causal) {
  using C = DqCfg<D>;
  constexpr int kBM = C::kBM;
  using QT = Tile<D, kBM>;
  using KT = Tile<D, kBN>;
  using L = DqSmem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ, do_s = base + L::kDO;
  const uint32_t k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest causal rows first
  const int head = blockIdx.y, b = blockIdx.z;
  const int bhq = b * hq + head, bhk = b * hkv + head / (hq / hkv);
  const int q0 = qt * kBM;
  int n_kt = (sk + kBN - 1) / kBN;
  if (causal) n_kt = min(n_kt, (q0 + kBM - 1) / kBN + 1);   // tiles with k0 <= last q row

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, C::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer. Its other 127 threads have nothing to do and leave.
    if constexpr (C::kConsumers == 2) regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, 2 * QT::kBytes);
      tma_load_tile<D, kBM>(q_s, &tm_q, q_full, q0, bhq);
      tma_load_tile<D, kBM>(do_s, &tm_do, q_full, q0, bhq);
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
  if constexpr (C::kConsumers == 2) regs_inc<240>();
  const int cw = wg - 1;                      // which 64 rows of the q tile
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int qw0 = q0 + 64 * cw;               // this warpgroup's first q row
  const int row0 = qw0 + 16 * warp + lane / 4;   // and row0 + 8
  const float scale_log2 = scale * kLog2e;

  // lse (as log2) and δ of rows row0 and row0 + 8; zero past Sq
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    lse2[h] = r < sq ? lse[(size_t)bhq * sq + r] * kLog2e : 0.f;
    dl[h] = r < sq ? delta[(size_t)bhq * sq + r] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    const int k0 = j * kBN;
    mbar_wait(full0 + 8 * s, (j / kStages) & 1);
    if (causal && k0 > qw0 + 63) {
      // every entry of this tile is masked for this warpgroup's rows
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      continue;
    }
    const uint32_t ks = k_s + s * KT::kBytes, vs = v_s + s * KT::kBytes;

    float sc[kBN / 2], dp[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kBN>::ss(sc, QT::kmajor(q_s, 64 * cw, kk), KT::kmajor(ks, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kBN>::ss(dp, QT::kmajor(do_s, 64 * cw, kk), KT::kmajor(vs, 0, kk), kk);
    wgmma_commit();

    // P while dP is still in flight. Only the diagonal tile and a ragged
    // last tile hold masked entries.
    wgmma_wait<1>();
    keep(sc);
    const bool edge = k0 + kBN > sk || (causal && k0 + kBN - 1 > qw0);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2f(sc[i] * scale_log2 - lse2[h]);
      if (edge) {
        const int r = row0 + 8 * h, c = k0 + acc_col(i, lane);
        if (c >= sk || (causal && c > r)) p = 0.f;
      }
      sc[i] = p;
    }
    wgmma_wait<0>();
    keep(dp);

    // bf16(dS) as the register A operand of dQ += dS K.
    uint32_t da[kBN / 4];
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int h = (i >> 1) & 1;
      da[i / 2] = pack_bf16(sc[i] * (dp[i] - dl[h]) * scale,
                            sc[i + 1] * (dp[i + 1] - dl[h]) * scale);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      Wgmma<D>::rs(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                   KT::mnmajor(ks, kk));
    wgmma_commit();
    wgmma_wait<0>();
    keep(acc);
    keep(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = row0 + acc_row8(i);
    if (r < sq)
      *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t)bhq * sq + r) * D + acc_col(i, lane)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int b, int hq, int hkv, int sq, int sk, float scale,
           int causal, cudaStream_t stream) {
  using C = DqCfg<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int rc = make_tile_map<D, C::kBM>(&tm_q, q, b * hq, sq);
  if (rc == 0) rc = make_tile_map<D, C::kBM>(&tm_do, dout, b * hq, sq);
  if (rc == 0) rc = make_tile_map<D, kBN>(&tm_k, k, b * hkv, sk);
  if (rc == 0) rc = make_tile_map<D, kBN>(&tm_v, v, b * hkv, sk);
  if (rc != 0) return rc;
  auto kern = flash_dq_sm90_kernel<D>;
  const int smem = DqSmem<D>::kBytes;
  const cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + C::kBM - 1) / C::kBM, hq, b);
  kern<<<grid, C::kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), hq, hkv, sq, sk,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch was refused, -2
// or -3 if the TMA descriptors could not be made, or -1 for a shape or
// dtype no template covers (dtype must be 1 = bfloat16; head_dim
// 16/32/64/128; Hq a multiple of Hkv).
extern "C" int flash_dq_sm90_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int b, int hq, int hkv, int sq, int sk, int d,
                                    float scale, int causal, int dtype, void* stream) {
  if (dtype != 1 || b < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, scale, causal, s);
    case 32:
      return launch<32>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, scale, causal, s);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, scale, causal, s);
    default: return -1;
  }
}
