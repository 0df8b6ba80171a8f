// Shared pieces of the neighborhood-attention kernels (na2d_fwd.cu,
// na2d_bwd.cu): type conversions, the clamped-window start, the warp sum and
// the attention-dropout keep bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace na2d {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// First index of the clamped window along one axis; neighbour j sits at
// start + dilation * j (ops/natten.py::_axis_neighbor_indices).
__device__ __forceinline__ int window_start(int i, int length, int ks,
                                            int dil) {
  const int coset = i % dil;
  const int pos = i / dil;
  const int coset_len = (length - coset + dil - 1) / dil;
  const int start = min(max(pos - ks / 2, 0), coset_len - ks);
  return coset + dil * start;
}

// Element strides of a (B, H, W, heads, head_dim) view; head_dim is unit
// stride.
struct Strides {
  long long b, h, w, n;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Attention dropout. The keep bit of window slot j of query-head
// `query` (the flat index ((b * H + h) * W + w) * heads + head) is a pure
// function of (seed, query, j), so the backward redraws the forward's mask
// at any launch geometry. ops/natten.py::dropout_keep_mask computes the
// same bits with torch integer ops; keep the two in step.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// Keep when the top 24 of the 32 hashed bits, as an integer u in
// [0, 2^24), reach `threshold` = ceil(p * 2^24): u / 2^24 >= p.
__device__ __forceinline__ bool keep_bit(uint32_t seed, long long query,
                                         int j, uint32_t threshold) {
  uint32_t x = mix32(seed ^ 0x9e3779b9u);
  x = mix32(x ^ (uint32_t)(query & 0xffffffffll));
  x = mix32(x ^ (uint32_t)(query >> 32));
  x = mix32(x ^ (uint32_t)j);
  return (x >> 8) >= threshold;
}

// Inverted-dropout parameters as the kernels take them: a device pointer to
// the int32 seed (read on the card, so drawing it never waits on the host),
// the integer keep threshold and 1 / (1 - p) in fp32.
struct Dropout {
  const int* seed;
  uint32_t threshold;
  float inv_keep;
};

}  // namespace na2d
