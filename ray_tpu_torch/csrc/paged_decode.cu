// Paged-attention decode step for Hopper (sm_90a), plain C entry point.
//
// Replaces the Pallas TPU kernel `_decode_kernel` launched by
// `paged_decode_attention` in ray_tpu/ops/paged_attention.py on the float32
// route; bf16, the serving path, takes the split-K kernel of
// paged_decode_split.cu. This kernel still takes bf16, so chip_smoke.py
// checks and times it there beside the split kernel. Semantics are
// the same: one decode step of attention per slot over a read-only paged KV
// pool, read through the slot's block table, then a fold of the slot's
// staging rows, then the normalise.
//
//   q            [slots, KH, G, D]        current-token queries, grouped by kv head
//   k/v pool     [P, KH, page, D]         ONE layer of the [L, P, KH, page, D] pool
//   block_tables [slots, max_pages] int32
//   base         [slots] int32            the pool holds positions [0, base)
//   k/v stage    [slots, KH, SC, D]       ONE layer of staging; rows [0, sl] live
//   out          [slots, KH, G, D]        in the input dtype
//
// Design. One thread block per (kv head, slot). The block walks the slot's
// pool pages [0, min(ceil(base / page), covered)), copies each page's K and V
// rows into shared memory, scores the G query rows against them, and keeps
// the online-softmax state (running max m, running sum l, accumulator acc)
// in float32. Probabilities are rounded to the input dtype before the PV
// product, as the TPU kernel does. After the pool pages the staging rows are
// folded the same way, a page-sized tile at a time, then acc / l is written.
//
// Bound on this card: bytes. A decode step reads every live K/V row once and
// does 4 * G * D flops per row, far below the H100's ~295 flops per byte
// ridge. At llama3-1b (8 slots x 8 kv heads) the grid is only 64 blocks on
// 132 SMs, and each block loads a tile and then computes on it with no
// overlap: this first kernel aims at being right. paged_decode_split.cu
// spreads the page walk over many blocks and keeps copies in flight.
//
// Shared-memory rows are padded by one 32-bit word so that the threads of a
// warp, each scoring a different row, hit different banks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

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

template <typename T, int D>
struct Layout {
  static constexpr int kVec = D * (int)sizeof(T) / 16;   // 16-byte vectors per row
  static constexpr int kRowWords = D * (int)sizeof(T) / 4 + 1;
  static constexpr int kAcc = (kMaxG * D + kThreads - 1) / kThreads;
};

// Fold `live` rows (the first `live` rows of a tile of at most PAGE rows)
// into the online-softmax state. Rows past `live` are masked: they are
// neither loaded nor read.
template <typename T, int D, int PAGE>
__device__ __forceinline__ void fold_tile(
    const T* __restrict__ ksrc, const T* __restrict__ vsrc, int live, int g,
    float scale, uint32_t* k_tile, uint32_t* v_tile, const float* q_s,
    float* p_s, float* m_s, float* l_s, float* a_s,
    float (&acc)[Layout<T, D>::kAcc]) {
  using L = Layout<T, D>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. K and V rows into shared memory, 16 bytes per load.
  const uint4* k4 = reinterpret_cast<const uint4*>(ksrc);
  const uint4* v4 = reinterpret_cast<const uint4*>(vsrc);
  for (int i = tid; i < live * L::kVec; i += kThreads) {
    const int r = i / L::kVec;
    const int c = i - r * L::kVec;
    const uint4 kv = k4[i];
    const uint4 vv = v4[i];
    uint32_t* kd = k_tile + r * L::kRowWords + c * 4;
    uint32_t* vd = v_tile + r * L::kRowWords + c * 4;
    kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
    vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
  }
  __syncthreads();

  // 2. Scores s[g][t] = scale * q[g] . k[t]; masked rows get -1e30.
  for (int i = tid; i < g * PAGE; i += kThreads) {
    const int gi = i / PAGE;
    const int t = i - gi * PAGE;
    float s = kNegInf;
    if (t < live) {
      const T* krow = reinterpret_cast<const T*>(k_tile + t * L::kRowWords);
      const float* qr = q_s + gi * D;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qr[d] * to_f(krow[d]);
      s = dot * scale;
    }
    p_s[i] = s;
  }
  __syncthreads();

  // 3. Online-softmax update, one warp per query row.
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
      pr[t] = to_f(from_f<T>(e));  // p rounded to the V dtype for the PV product
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

  // 4. acc = acc * alpha + P . V over the live rows.
#pragma unroll
  for (int j = 0; j < L::kAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < g * D) {
      const int gi = i / D;
      const int d = i - gi * D;
      const float* pr = p_s + gi * PAGE;
      float sum = 0.f;
      for (int t = 0; t < live; ++t)
        sum += pr[t] * to_f(reinterpret_cast<const T*>(v_tile + t * L::kRowWords)[d]);
      acc[j] = acc[j] * a_s[gi] + sum;
    }
  }
  __syncthreads();  // the next tile overwrites k_tile, v_tile and p_s
}

template <typename T, int D, int PAGE>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ base, const T* __restrict__ k_stage,
    const T* __restrict__ v_stage, T* __restrict__ out, int kh, int g,
    int max_pages, int covered, int sc, int sl, float scale) {
  using L = Layout<T, D>;
  extern __shared__ uint32_t smem[];
  uint32_t* k_tile = smem;                              // [PAGE][kRowWords]
  uint32_t* v_tile = k_tile + PAGE * L::kRowWords;      // [PAGE][kRowWords]
  float* q_s = reinterpret_cast<float*>(v_tile + PAGE * L::kRowWords);  // [G][D]
  float* p_s = q_s + g * D;                             // [G][PAGE]
  float* m_s = p_s + g * PAGE;                          // [G]
  float* l_s = m_s + g;                                 // [G]
  float* a_s = l_s + g;                                 // [G]

  const int h = blockIdx.x;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int gd = g * D;
  const size_t head = (size_t)slot * kh + h;

  const T* q_row = q + head * gd;
  for (int i = tid; i < gd; i += kThreads) q_s[i] = to_f(q_row[i]);
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  float acc[L::kAcc];
#pragma unroll
  for (int j = 0; j < L::kAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  // Pool pages: positions [0, b), never past the `covered` page bound.
  const int b = base[slot];
  int n_pages = (b + PAGE - 1) / PAGE;
  if (n_pages > covered) n_pages = covered;
  const int* bt = block_tables + (size_t)slot * max_pages;
  for (int p = 0; p < n_pages; ++p) {
    const size_t off = ((size_t)bt[p] * kh + h) * PAGE * D;
    const int live = min(PAGE, b - p * PAGE);
    fold_tile<T, D, PAGE>(k_pool + off, v_pool + off, live, g, scale, k_tile,
                          v_tile, q_s, p_s, m_s, l_s, a_s, acc);
  }

  // Staging rows [0, sl]: the last one is the current token, always live,
  // so even b == 0 normalises to the staged values.
  const size_t soff = head * sc * D;
  for (int r0 = 0; r0 <= sl; r0 += PAGE) {
    const int live = min(PAGE, sl + 1 - r0);
    fold_tile<T, D, PAGE>(k_stage + soff + (size_t)r0 * D,
                          v_stage + soff + (size_t)r0 * D, live, g, scale,
                          k_tile, v_tile, q_s, p_s, m_s, l_s, a_s, acc);
  }

  T* o_row = out + head * gd;
#pragma unroll
  for (int j = 0; j < L::kAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < gd) o_row[i] = from_f<T>(acc[j] / l_s[i / D]);
  }
}

template <typename T, int D, int PAGE>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_tables, const void* base, const void* k_stage,
           const void* v_stage, void* out, int slots, int kh, int g,
           int max_pages, int covered, int sc, int sl, float scale,
           cudaStream_t stream) {
  using L = Layout<T, D>;
  const size_t smem = (size_t)2 * PAGE * L::kRowWords * 4 +
                      (size_t)(g * D + g * PAGE + 3 * g) * 4;
  auto kern = paged_decode_kernel<T, D, PAGE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(kh, slots);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(base), static_cast<const T*>(k_stage),
      static_cast<const T*>(v_stage), static_cast<T*>(out), kh, g, max_pages,
      covered, sc, sl, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_page(int page_size, const void* q, const void* k_pool,
                  const void* v_pool, const void* block_tables,
                  const void* base, const void* k_stage, const void* v_stage,
                  void* out, int slots, int kh, int g, int max_pages,
                  int covered, int sc, int sl, float scale,
                  cudaStream_t stream) {
#define RTT_PAGE(P)                                                           \
  case P:                                                                     \
    return launch<T, D, P>(q, k_pool, v_pool, block_tables, base, k_stage,    \
                           v_stage, out, slots, kh, g, max_pages, covered, sc, \
                           sl, scale, stream);
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

template <typename T>
int dispatch_dim(int d, int page_size, const void* q, const void* k_pool,
                 const void* v_pool, const void* block_tables,
                 const void* base, const void* k_stage, const void* v_stage,
                 void* out, int slots, int kh, int g, int max_pages,
                 int covered, int sc, int sl, float scale,
                 cudaStream_t stream) {
#define RTT_DIM(DD)                                                           \
  case DD:                                                                    \
    return dispatch_page<T, DD>(page_size, q, k_pool, v_pool, block_tables,   \
                                base, k_stage, v_stage, out, slots, kh, g,    \
                                max_pages, covered, sc, sl, scale, stream);
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

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch was refused, or
// -1 for a shape or dtype no template covers (dtype 0 = float32,
// 1 = bfloat16; head_dim 16/32/64/128; page 8/16/32/64; G <= 16).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* base, const void* k_stage,
    const void* v_stage, void* out, int slots, int kh, int g, int d,
    int page_size, int max_pages, int covered, int sc, int sl, float scale,
    int dtype, void* stream) {
  if (g < 1 || g > kMaxG || sl < 0 || sl >= sc) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(d, page_size, q, k_pool, v_pool, block_tables,
                               base, k_stage, v_stage, out, slots, kh, g,
                               max_pages, covered, sc, sl, scale, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(d, page_size, q, k_pool, v_pool,
                                       block_tables, base, k_stage, v_stage,
                                       out, slots, kh, g, max_pages, covered,
                                       sc, sl, scale, s);
  return -1;
}
