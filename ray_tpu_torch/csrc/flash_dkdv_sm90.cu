// Flash-attention dK/dV for Hopper (sm_90a) on bf16: wgmma products fed
// by TMA. Plain C entry point.
//
// Replaces the Pallas TPU kernel `_bwd_dkdv_kernel` (ray_tpu/ops/attention.py)
// on the bf16 route; float32 keeps the exact-FMA kernel of flash_bwd.cu.
// Same function as that kernel and as `flash_dkdv_plain`: P = exp(scale *
// Q Kᵀ - lse) with masked entries 0 (q_id >= k_id on absolute ids when
// causal; q_id < Sq, k_id < Sk), dS = P ∘ (dO Vᵀ - δ) · scale rounded to
// bf16 before the dK product, P rounded to bf16 before the dV product,
// dV = P̂ᵀ dO and dK = dSᵀ Q summed over the q heads of the GQA group in
// float32 inside the block (no atomics, no [B, Hq, S, D] intermediate).
//
//   q, dO [B, Hq, Sq, D] bf16     k, v [B, Hkv, Sk, D] bf16
//   lse, δ [B, Hq, Sq] float32    dK, dV [B, Hkv, Sk, D] bf16
//
// Bound on this card: operations (four S x S x D products per head, half
// of each when causal).
//
// Design. One block per (k tile, kv head, batch row). Warpgroup 0, the
// producer, loads K and V once by TMA, then streams, for every q head of
// the group and every 64-row q tile at or below the diagonal, the Q and
// dO tiles (TMA) and that tile's lse and δ (one warp's plain loads, zero
// past Sq) through a ring of kStages stages with full and empty
// mbarriers. The consumer warpgroups own 64 k rows each and compute the
// transposed products, so that no score tile touches shared memory:
//     Sᵀ  = K Qᵀ        wgmma, A = K and B = Q from shared memory, K-major
//     dPᵀ = V dOᵀ       wgmma, A = V, B = dO, K-major
//     Pᵀ  = exp(scale Sᵀ - lse[q]), dSᵀ = Pᵀ ∘ (dPᵀ - δ[q]) · scale
//     dV += bf16(Pᵀ) dO  wgmma, A = Pᵀ from registers, B = dO MN-major
//     dK += bf16(dSᵀ) Q  wgmma, A = dSᵀ from registers, B = Q MN-major
// dK and dV stay in f32 registers across the whole group and are stored
// once, in bf16. In the transposed tiles the q index is the accumulator's
// column, so lse and δ are read per column from the stage.
//
// Registers. A consumer holds dK and dV (D floats per k row, 2 x D / 2
// registers a thread) beside Sᵀ and dPᵀ (32 each). ptxas budgets every
// warpgroup by __launch_bounds__, not by setmaxnreg: 168 registers a
// thread at 384 threads, which D = 128 (~230 needed) overflows (272 bytes
// spilled and wgmma serialised, ptxas C7512). So D <= 64 runs two
// consumer warpgroups (128-row k tiles, 384 threads, setmaxnreg 24/240),
// and D = 128 one (64-row k tiles, 256 threads, a 255-register budget).
//
// Left for later: ping-pong between the consumer warpgroups, overlap of
// the exponentials with the next tile's products, persistent blocks, TMA
// stores of dK/dV, clusters.
//
// Profiling: chip_smoke.py finds this kernel's device time by the name
// of its entry point with "_launch" replaced by "_kernel", so the entry
// is flash_dkdv_sm90_launch and the kernel flash_dkdv_sm90_kernel.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 64;         // q rows per streamed tile
constexpr int kStages = 2;

template <int D>
struct DkdvCfg {
  static constexpr int kConsumers = D == 128 ? 1 : 2;   // warpgroups of 64 k rows
  static constexpr int kBN = 64 * kConsumers;            // k rows per block
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kConsumerWarps = 4 * kConsumers;
};

template <int D>
struct DkdvSmem {
  using KT = Tile<D, DkdvCfg<D>::kBN>;
  using QT = Tile<D, kBM>;
  static constexpr int kK = 0;
  static constexpr int kV = KT::kBytes;
  static constexpr int kQ = 2 * KT::kBytes;                  // kStages Q tiles
  static constexpr int kDO = kQ + kStages * QT::kBytes;      // kStages dO tiles
  static constexpr int kLse = kDO + kStages * QT::kBytes;    // float [kStages][kBM]
  static constexpr int kDelta = kLse + kStages * kBM * 4;    // float [kStages][kBM]
  static constexpr int kBar = kDelta + kStages * kBM * 4;    // kv_full, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(DkdvCfg<D>::kThreads, 1)
flash_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                       int hq, int hkv, int sq, int sk, float scale, int causal) {
  using C = DkdvCfg<D>;
  constexpr int kBN = C::kBN;
  using KT = Tile<D, kBN>;
  using QT = Tile<D, kBM>;
  using L = DkdvSmem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t q_s = base + L::kQ, do_s = base + L::kDO;
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* delta_s = reinterpret_cast<float*>(smem + L::kDelta);
  const uint32_t kv_full = base + L::kBar;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * kStages;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kBN;
  const int rep = hq / hkv;
  const int bhk = b * hkv + hk;
  const int n_qt = (sq + kBM - 1) / kBM;
  // Causal: q tiles with q0 + kBM - 1 >= k0 only.
  const int qt0 = causal ? min(k0 / kBM, n_qt) : 0;
  const int per_head = n_qt - qt0;
  const int n_it = rep * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);   // the loading warp's 32 lanes
      mbar_init(empty0 + 8 * s, C::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 0) {
    // Producer: warp 0 loads, the other three warps leave.
    if constexpr (C::kConsumers == 2) regs_dec<24>();
    if (threadIdx.x < 32) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * KT::kBytes);
        tma_load_tile<D, kBN>(k_s, &tm_k, kv_full, k0, bhk);
        tma_load_tile<D, kBN>(v_s, &tm_v, kv_full, k0, bhk);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int bhq = b * hq + hk * rep + it / per_head;
        const int q0 = (qt0 + it % per_head) * kBM;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        for (int r = lane; r < kBM; r += 32) {
          const bool in = q0 + r < sq;
          lse_s[s * kBM + r] = in ? lse[(size_t)bhq * sq + q0 + r] : 0.f;
          delta_s[s * kBM + r] = in ? delta[(size_t)bhq * sq + q0 + r] : 0.f;
        }
        // Each lane's arrive publishes its own stores; lane 0's also
        // expects the two TMA tiles.
        if (lane == 0) {
          mbar_arrive_expect_tx(full0 + 8 * s, 2 * QT::kBytes);
          tma_load_tile<D, kBM>(q_s + s * QT::kBytes, &tm_q, full0 + 8 * s, q0, bhq);
          tma_load_tile<D, kBM>(do_s + s * QT::kBytes, &tm_do, full0 + 8 * s, q0, bhq);
        } else {
          mbar_arrive(full0 + 8 * s);
        }
      }
    }
    return;
  }

  // Consumers.
  if constexpr (C::kConsumers == 2) regs_inc<240>();
  const int cw = wg - 1;                      // which 64 rows of the k tile
  const int warp = (threadIdx.x % 128) / 32;
  const int kr0 = k0 + 64 * cw;               // this warpgroup's first k row
  const int row0 = kr0 + 16 * warp + lane / 4;   // and row0 + 8
  const float scale_log2 = scale * kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int q0 = (qt0 + it % per_head) * kBM;
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    const uint32_t qs = q_s + s * QT::kBytes, dos = do_s + s * QT::kBytes;
    const float* ls = lse_s + s * kBM;
    const float* ds = delta_s + s * kBM;

    float st[kBM / 2], dpt[kBM / 2];
#pragma unroll
    for (int i = 0; i < kBM / 2; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kBM>::ss(st, KT::kmajor(k_s, 64 * cw, kk), QT::kmajor(qs, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kBM>::ss(dpt, KT::kmajor(v_s, 64 * cw, kk), QT::kmajor(dos, 0, kk), kk);
    wgmma_commit();

    // Pᵀ while dPᵀ is still in flight. Masked entries (and the zero rows
    // TMA returns past Sq or Sk) are exactly 0.
    wgmma_wait<1>();
    keep(st);
    const bool edge = q0 + kBM > sq || kr0 + 64 > sk || (causal && q0 < kr0 + 63);
#pragma unroll
    for (int i = 0; i < kBM / 2; ++i) {
      const int c = acc_col(i, lane);
      float p = exp2f(st[i] * scale_log2 - ls[c] * kLog2e);
      if (edge) {
        const int qi = q0 + c, r = row0 + acc_row8(i);
        if (qi >= sq || r >= sk || (causal && qi < r)) p = 0.f;
      }
      st[i] = p;
    }
    wgmma_wait<0>();
    keep(dpt);

    // bf16(Pᵀ) and bf16(dSᵀ) as register A operands.
    uint32_t pa[kBM / 4], da[kBM / 4];
#pragma unroll
    for (int i = 0; i < kBM / 2; i += 2) {
      const int c = acc_col(i, lane);
      pa[i / 2] = pack_bf16(st[i], st[i + 1]);
      da[i / 2] = pack_bf16(st[i] * (dpt[i] - ds[c]) * scale,
                            st[i + 1] * (dpt[i + 1] - ds[c + 1]) * scale);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk)
      Wgmma<D>::rs(dv_acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                   QT::mnmajor(dos, kk));
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk)
      Wgmma<D>::rs(dk_acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                   QT::mnmajor(qs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    keep(dv_acc);
    keep(dk_acc);
    keep(pa);
    keep(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = row0 + acc_row8(i);
    if (r < sk) {
      const size_t at = ((size_t)bhk * sk + r) * D + acc_col(i, lane);
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
           float scale, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int rc = make_tile_map<D, kBM>(&tm_q, q, b * hq, sq);
  if (rc == 0) rc = make_tile_map<D, kBM>(&tm_do, dout, b * hq, sq);
  if (rc == 0) rc = make_tile_map<D, DkdvCfg<D>::kBN>(&tm_k, k, b * hkv, sk);
  if (rc == 0) rc = make_tile_map<D, DkdvCfg<D>::kBN>(&tm_v, v, b * hkv, sk);
  if (rc != 0) return rc;
  using C = DkdvCfg<D>;
  auto kern = flash_dkdv_sm90_kernel<D>;
  const int smem = DkdvSmem<D>::kBytes;
  const cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sk + C::kBN - 1) / C::kBN, hkv, b);
  kern<<<grid, C::kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), hq, hkv, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch was refused, -2
// or -3 if the TMA descriptors could not be made, or -1 for a shape or
// dtype no template covers (dtype must be 1 = bfloat16; head_dim
// 16/32/64/128; Hq a multiple of Hkv).
extern "C" int flash_dkdv_sm90_launch(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int b, int hq, int hkv, int sq,
                                      int sk, int d, float scale, int causal, int dtype,
                                      void* stream) {
  if (dtype != 1 || b < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, scale, causal, s);
    case 32:
      return launch<32>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, scale, causal, s);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, scale, causal,
                         s);
    default: return -1;
  }
}
