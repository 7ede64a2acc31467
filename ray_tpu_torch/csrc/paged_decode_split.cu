// Paged-attention decode step for Hopper (sm_90a) on bf16, split over the
// pages (split-K, as flash-decoding does). Plain C entry point.
//
// Replaces the Pallas TPU kernel `_decode_kernel` (launched by
// `paged_decode_attention` in ray_tpu/ops/paged_attention.py) on the bf16
// route; float32 keeps paged_decode.cu. Same function as that kernel and
// as `paged_decode_plain`: for each slot, the pool pages
// [0, min(ceil(base / page), covered)) read through the slot's block table
// with positions >= base masked, then the staging rows [0, sl]; scores,
// softmax statistics and accumulation in float32; P rounded to bf16 before
// the PV product, against the running max of the split (the plain version
// rounds against the final max; the difference is within one bf16
// rounding); output in bf16.
//
//   q            [slots, KH, G, D]        bf16, current-token queries
//   k/v pool     [P, KH, page, D]         bf16, ONE layer of the pool
//   block_tables [slots, max_pages] int32
//   base         [slots] int32            the pool holds positions [0, base)
//   k/v stage    [slots, KH, SC, D]       bf16, ONE layer; rows [0, sl] live
//   out          [slots, KH, G, D]        bf16
//   ws           float32 workspace, slots * KH * n_split * G * (D + 2)
//   tickets      int32 [slots * KH], zero between launches
//
// Bound on this card: bytes. Every live K/V row is read once and takes
// 4 * G * D flops, far below the ~295 flops-per-byte ridge, so what
// matters is keeping enough copies in flight on every SM; the tensor cores
// do not.
//
// Design. The grid is (split, kv head, slot). The split count and the
// pages per split come from the host (`paged_split_plan` in
// ops/paged_attention.py: slots, KH, `covered` and the SM count only, never
// base, which lives on the device), so one (head, slot) is spread over
// n_split blocks of 128 threads and a long slot no longer serialises the
// step. Split s walks pages [s * per, min((s + 1) * per, n_live)); the
// last split also folds the staging rows, so every (head, slot) sees its
// current token and ends with l > 0. A split with no live page writes an
// empty partial (m = -1e30, l = 0, acc = 0).
//   * Copies: a page's rows for one kv head are contiguous ([page, D] in
//     the [P, KH, page, D] pool), so each K and V tile is 16-byte
//     cp.async copies of its live rows into a ring of kStages buffers:
//     two tiles are in flight while one is scored. Rows are padded by 16
//     bytes so the 16-byte reads of a quarter warp, one row a thread, hit
//     distinct banks.
//   * Per tile: scores G x page (one thread per (g, row), 16-byte reads),
//     the online-softmax update (one warp per query row), then
//     acc = acc * alpha + P V (one thread per output pair).
//   * Combine in one launch: each split writes (m, l, acc) to the
//     workspace, fences, and takes a ticket for its (head, slot); the last
//     to arrive combines the partials in split order (so the result does
//     not depend on which block finished first), writes out, and resets
//     the ticket to 0. With one split the block normalises directly.
//
// Left for later: TMA bulk copies, a CUDA graph over the decode step (the
// step is bound by the host's launches, not by this kernel), the tp split
// over kv heads.
//
// Profiling: chip_smoke.py finds this kernel's device time by the name
// of its entry point with "_launch" replaced by "_kernel", so the entry
// is paged_decode_split_launch and the kernel paged_decode_split_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 16;
constexpr int kMaxSplit = 32;
constexpr int kStages = 3;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int D, int PAGE>
struct Layout {
  static constexpr int kRowBytes = D * 2 + 16;   // padded, 16-byte aligned
  static constexpr int kTileBytes = PAGE * kRowBytes;
  static constexpr int kVecs = D / 8;            // 16-byte vectors per row
  static constexpr int kPairs = (kMaxG * D / 2 + kThreads - 1) / kThreads;
  // shared memory: kStages K and V tiles, then float q [G][D], p [G][PAGE],
  // m, l, alpha [G], the combine's weights [kMaxSplit][G], one flag
  static constexpr int kTiles = 2 * kStages * kTileBytes;
  static size_t bytes(int g) {
    return (size_t)kTiles + 4 * ((size_t)g * D + g * PAGE + 3 * g + kMaxSplit * g + 4);
  }
};

// One tile of a split's walk: its K and V rows and how many are live.
struct TileSrc {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int live;
};

// A block's walk: its pool pages [p_begin, p_begin + n_pool), then (last
// split only) the staging rows [0, sl] in page-sized tiles.
struct Walk {
  const __nv_bfloat16 *k_pool, *v_pool, *k_stage, *v_stage;
  const int* bt;          // the slot's block table
  size_t head;            // slot * KH + kv head
  int kh, h, b, sc, sl, p_begin, n_pool;
};

template <int D, int PAGE>
__device__ __forceinline__ TileSrc tile_src(const Walk& w, int i) {
  if (i < w.n_pool) {
    const int p = w.p_begin + i;
    const size_t off = ((size_t)w.bt[p] * w.kh + w.h) * PAGE * D;
    return {w.k_pool + off, w.v_pool + off, min(PAGE, w.b - p * PAGE)};
  }
  const int r0 = (i - w.n_pool) * PAGE;
  const size_t off = (w.head * w.sc + r0) * D;
  return {w.k_stage + off, w.v_stage + off, min(PAGE, w.sl + 1 - r0)};
}

// Start the 16-byte copies of tile i's live K and V rows into ring buffer
// i % kStages (if the walk has a tile i), then close one copy group.
template <int D, int PAGE>
__device__ __forceinline__ void prefetch_tile(const Walk& w, int i, int n_tiles,
                                              uint32_t tiles) {
  using L = Layout<D, PAGE>;
  if (i < n_tiles) {
    const TileSrc src = tile_src<D, PAGE>(w, i);
    const uint32_t kd = tiles + (i % kStages) * 2 * L::kTileBytes;
    const uint32_t vd = kd + L::kTileBytes;
    for (int e = threadIdx.x; e < src.live * L::kVecs; e += kThreads) {
      const int r = e / L::kVecs, c = e - r * L::kVecs;
      cp_async16(kd + r * L::kRowBytes + c * 16, src.k + e * 8);
      cp_async16(vd + r * L::kRowBytes + c * 16, src.v + e * 8);
    }
  }
  cp_async_commit();   // one group per tile slot, empty or not
}

template <int D, int PAGE>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ base, const __nv_bfloat16* __restrict__ k_stage,
    const __nv_bfloat16* __restrict__ v_stage, __nv_bfloat16* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ tickets, int slots, int kh, int g,
    int max_pages, int covered, int sc, int sl, int n_split, int per, float scale) {
  using L = Layout<D, PAGE>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t tiles = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float* q_s = reinterpret_cast<float*>(smem + L::kTiles);   // [G][D]
  float* p_s = q_s + g * D;                                  // [G][PAGE]
  float* m_s = p_s + g * PAGE;                               // [G]
  float* l_s = m_s + g;                                      // [G]
  float* a_s = l_s + g;                                      // [G]
  float* w_s = a_s + g;                                      // [kMaxSplit][G]
  int* flag = reinterpret_cast<int*>(w_s + kMaxSplit * g);

  const int split = blockIdx.x, h = blockIdx.y, slot = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gd = g * D;
  const size_t head = (size_t)slot * kh + h;
  const bool last = split == n_split - 1;

  for (int i = tid; i < gd; i += kThreads) q_s[i] = __bfloat162float(q[head * gd + i]);
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  float acc[L::kPairs][2];
#pragma unroll
  for (int j = 0; j < L::kPairs; ++j) acc[j][0] = acc[j][1] = 0.f;

  const int b = base[slot];
  const int n_live = max(0, min((b + PAGE - 1) / PAGE, covered));
  const int p_begin = split * per;
  const int n_pool = max(0, min(p_begin + per, n_live) - p_begin);
  const int n_tiles = n_pool + (last ? sl / PAGE + 1 : 0);
  const Walk walk{k_pool, v_pool, k_stage, v_stage,
                  block_tables + (size_t)slot * max_pages, head, kh, h, b, sc, sl,
                  p_begin, n_pool};

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) prefetch_tile<D, PAGE>(walk, i, n_tiles, tiles);
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile i landed
    __syncthreads();                // everyone's; and tile i - 1 is done
    prefetch_tile<D, PAGE>(walk, i + kStages - 1, n_tiles, tiles);   // into i - 1's buffer
    const int live = tile_src<D, PAGE>(walk, i).live;
    const uint8_t* kt = smem + (i % kStages) * 2 * L::kTileBytes;
    const uint8_t* vt = kt + L::kTileBytes;

    // Scores s[g][t] = scale * q[g] . k[t]; rows past `live` get -1e30.
    for (int e = tid; e < g * PAGE; e += kThreads) {
      const int gi = e / PAGE, t = e - gi * PAGE;
      float s = kNegInf;
      if (t < live) {
        const uint4* kr = reinterpret_cast<const uint4*>(kt + t * L::kRowBytes);
        const float4* qr = reinterpret_cast<const float4*>(q_s + gi * D);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < L::kVecs; ++c) {
          const uint4 kv = kr[c];
          const float4 qa = qr[2 * c], qb = qr[2 * c + 1];
          const float2 k0 = bf2(kv.x), k1 = bf2(kv.y), k2 = bf2(kv.z), k3 = bf2(kv.w);
          dot += qa.x * k0.x + qa.y * k0.y + qa.z * k1.x + qa.w * k1.y +
                 qb.x * k2.x + qb.y * k2.y + qb.z * k3.x + qb.w * k3.y;
        }
        s = dot * scale;
      }
      p_s[e] = s;
    }
    __syncthreads();

    // Online-softmax update, one warp per query row; P rounded to bf16
    // for the PV product, the row sum taking it unrounded.
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      float* pr = p_s + gi * PAGE;
      float mx = kNegInf;
      for (int t = lane; t < PAGE; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < PAGE; t += 32) {
        const float e = expf(pr[t] - m_new);
        sum += e;
        pr[t] = __bfloat162float(__float2bfloat16(e));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over the live rows, two columns a thread.
#pragma unroll
    for (int j = 0; j < L::kPairs; ++j) {
      const int pi = tid + j * kThreads;
      if (pi < gd / 2) {
        const int gi = pi / (D / 2), d2 = pi - gi * (D / 2);
        const float* pr = p_s + gi * PAGE;
        float sx = 0.f, sy = 0.f;
#pragma unroll 4
        for (int t = 0; t < live; ++t) {
          const float2 vv = bf2(*reinterpret_cast<const uint32_t*>(vt + t * L::kRowBytes + d2 * 4));
          sx += pr[t] * vv.x;
          sy += pr[t] * vv.y;
        }
        const float a = a_s[gi];
        acc[j][0] = acc[j][0] * a + sx;
        acc[j][1] = acc[j][1] * a + sy;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // m_s, l_s final (also when this split had no tile)

  if (n_split == 1) {
#pragma unroll
    for (int j = 0; j < L::kPairs; ++j) {
      const int pi = tid + j * kThreads;
      if (pi < gd / 2) {
        const float inv = 1.f / l_s[pi / (D / 2)];
        reinterpret_cast<__nv_bfloat162*>(out + head * gd)[pi] =
            __floats2bfloat162_rn(acc[j][0] * inv, acc[j][1] * inv);
      }
    }
    return;
  }

  // Partials: ml [slots * KH * n_split][G] (m, l), then acc [..][G][D].
  float2* ws_ml = reinterpret_cast<float2*>(ws);
  float* ws_acc = ws + (size_t)2 * slots * kh * n_split * g;
  const size_t part = head * n_split + split;
  for (int i = tid; i < g; i += kThreads) ws_ml[part * g + i] = make_float2(m_s[i], l_s[i]);
#pragma unroll
  for (int j = 0; j < L::kPairs; ++j) {
    const int pi = tid + j * kThreads;
    if (pi < gd / 2)
      reinterpret_cast<float2*>(ws_acc + part * gd)[pi] = make_float2(acc[j][0], acc[j][1]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(tickets + head, 1) == n_split - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // The last split of this (head, slot): combine in split order.
  const size_t part0 = head * n_split;
  for (int gi = tid; gi < g; gi += kThreads) {
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, __ldcg(&ws_ml[(part0 + s) * g + gi]).x);
    float lsum = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float2 ml = __ldcg(&ws_ml[(part0 + s) * g + gi]);
      const float w = expf(ml.x - mx);
      w_s[s * g + gi] = w;
      lsum += ml.y * w;
    }
    l_s[gi] = lsum;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < L::kPairs; ++j) {
    const int pi = tid + j * kThreads;
    if (pi < gd / 2) {
      const int gi = pi / (D / 2);
      float ox = 0.f, oy = 0.f;
      for (int s = 0; s < n_split; ++s) {
        const float2 a = __ldcg(reinterpret_cast<const float2*>(ws_acc + (part0 + s) * gd) + pi);
        const float w = w_s[s * g + gi];
        ox += a.x * w;
        oy += a.y * w;
      }
      const float inv = 1.f / l_s[gi];
      reinterpret_cast<__nv_bfloat162*>(out + head * gd)[pi] =
          __floats2bfloat162_rn(ox * inv, oy * inv);
    }
  }
  if (tid == 0) atomicExch(tickets + head, 0);
}

template <int D, int PAGE>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* block_tables,
           const void* base, const void* k_stage, const void* v_stage, void* out, void* ws,
           void* tickets, int slots, int kh, int g, int max_pages, int covered, int sc,
           int sl, int n_split, int per, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D, PAGE>::bytes(g);
  auto kern = paged_decode_split_kernel<D, PAGE>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_split, kh, slots);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(base), static_cast<const __nv_bfloat16*>(k_stage),
      static_cast<const __nv_bfloat16*>(v_stage), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets), slots, kh, g, max_pages, covered,
      sc, sl, n_split, per, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_page(int page_size, const void* q, const void* k_pool, const void* v_pool,
                  const void* block_tables, const void* base, const void* k_stage,
                  const void* v_stage, void* out, void* ws, void* tickets, int slots, int kh,
                  int g, int max_pages, int covered, int sc, int sl, int n_split, int per,
                  float scale, cudaStream_t stream) {
#define RTT_PAGE(P)                                                                      \
  case P:                                                                                \
    return launch<D, P>(q, k_pool, v_pool, block_tables, base, k_stage, v_stage, out,    \
                        ws, tickets, slots, kh, g, max_pages, covered, sc, sl, n_split,  \
                        per, scale, stream);
  switch (page_size) {
    RTT_PAGE(8)
    RTT_PAGE(16)
    RTT_PAGE(32)
    RTT_PAGE(64)
    default:
      return -1;
  }
#undef RTT_PAGE
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch was refused, or
// -1 for a shape or dtype no template covers (dtype must be 1 = bfloat16;
// head_dim 16/32/64/128; page 8/16/32/64; G <= 16; 1 <= n_split <= 32).
extern "C" int paged_decode_split_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* block_tables,
    const void* base, const void* k_stage, const void* v_stage, void* out, void* ws,
    void* tickets, int slots, int kh, int g, int d, int page_size, int max_pages,
    int covered, int sc, int sl, int n_split, int per, float scale, int dtype,
    void* stream) {
  if (dtype != 1 || g < 1 || g > kMaxG || sl < 0 || sl >= sc || n_split < 1 ||
      n_split > kMaxSplit || per < 0 || (long long)n_split * per < covered)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_DIM(DD)                                                                       \
  case DD:                                                                                \
    return dispatch_page<DD>(page_size, q, k_pool, v_pool, block_tables, base, k_stage,   \
                             v_stage, out, ws, tickets, slots, kh, g, max_pages, covered, \
                             sc, sl, n_split, per, scale, s);
  switch (d) {
    RTT_DIM(16)
    RTT_DIM(32)
    RTT_DIM(64)
    RTT_DIM(128)
    default:
      return -1;
  }
#undef RTT_DIM
}
