// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout of every kernel: 256 threads, tiles of 64 query rows by 64 key
// rows. Thread (ty, tx) = (tid / 16, tid % 16) owns score rows ty*4 + i
// (i < 4) and score columns tx + 16*j (j < 4) of a 64 x 64 tile, and
// output columns tx + 16*c (c < D/16) of the rows it owns in an output
// tile. The 16 threads of one ty sit in one half-warp, so a row's max and
// sum are shuffles within it.
//
// Operand tiles are held in shared memory as float32, whatever the input
// type: a bf16 input is exact in float32, and every product is then a
// float32 FMA (float32 accumulation always). Rows are padded by 4 floats
// (16 bytes) so that the 16-byte reads of 16 different rows by one
// half-warp fall in distinct banks. Score tiles have a row stride of 68.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr int kBlock = 64;      // query rows and key rows per tile
constexpr int kThreads = 256;
constexpr int kSStride = 68;    // row stride of a 64 x 64 score tile in smem
// Masked scores take this value, not -inf, as the TPU kernel does: exp of
// (masked - running max) underflows to exactly 0.
constexpr float kNegInf = -1e30f;

template <int D>
struct Dims {
  static constexpr int kStride = D + 4;      // padded row of an operand tile
  static constexpr int kCols = D / 16;       // output columns per thread
  static constexpr int kTile = kBlock * kStride;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded to T and back: the places where the TPU kernel casts an
// intermediate (p, dS) to the input dtype before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// 16 bytes of T, as float32, into out[0 .. 16 / sizeof(T)).
__device__ __forceinline__ void unpack(const uint4& raw, float* out, float) {
  *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(&raw);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out, __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

// Rows [row0, row0 + 64) of a contiguous [rows, D] matrix into an operand
// tile, as float32. Rows at or past `rows` (the ragged tail) are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int rows) {
  constexpr int kVec = 16 / (int)sizeof(T);   // elements per 16-byte load
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kBlock * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    float* out = dst + r * Dims<D>::kStride + c;
    if (row0 + r < rows) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * D + c));
      unpack(raw, out, T());
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = 0.f;
    }
  }
}

// acc[i][j] += sum_d a[ty*4 + i][d] * b[tx + 16*j][d] over two operand
// tiles: the 4 x 4 block of a 64 x 64 product A Bᵀ that this thread owns.
template <int D>
__device__ __forceinline__ void tile_abt(const float* a, const float* b,
                                         int ty, int tx, float (&acc)[4][4]) {
  constexpr int S = Dims<D>::kStride;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * S + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * S + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// Max and sum over the 16 threads that share a ty (one half-warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whether score (q_id, k_id) takes part: inside both sequences and, when
// causal, q_id >= k_id. This is the TPU kernel's rule (absolute ids, no
// sk - sq offset); it agrees with mha_reference's tril(k = sk - sq) only
// when sq == sk, which the training path always has.
__device__ __forceinline__ bool live(int q_id, int k_id, int sq, int sk, int causal) {
  return q_id < sq && k_id < sk && (!causal || q_id >= k_id);
}

template <typename Kern>
inline cudaError_t set_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace flash
