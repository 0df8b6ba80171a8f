// Shared pieces of the temporal-attention kernels (temporal_fwd.cu,
// temporal_bwd.cu): row loads and stores of one head's channels, the dot
// product and the softmax statistics. Both kernels compute every logit and
// softmax weight with these functions, in the same order, so the backward's
// recomputed weights are the forward's bit for bit.
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "na2d_common.cuh"

namespace temporal {

using na2d::from_float;
using na2d::to_float;

constexpr int kThreads = 256;

// Element strides of an (N, T, C) view along N and T; C is unit-stride.
struct Strides {
  long long n, t;
};

// Elements in 16 bytes.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void unpack(const uint4& raw, float* r, float) {
  r[0] = __uint_as_float(raw.x);
  r[1] = __uint_as_float(raw.y);
  r[2] = __uint_as_float(raw.z);
  r[3] = __uint_as_float(raw.w);
}

// Two bf16 per 32-bit word, the first in the low half; a bf16 is the top
// half of the fp32 with the same value.
__device__ __forceinline__ void unpack(const uint4& raw, float* r,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[2 * i] = __uint_as_float(w[i] << 16);
    r[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float* r, float) {
  return make_uint4(__float_as_uint(r[0]), __float_as_uint(r[1]),
                    __float_as_uint(r[2]), __float_as_uint(r[3]));
}

__device__ __forceinline__ uint4 pack(const float* r, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(r[2 * i]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16(r[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// r[0, hd) = the row's hd values in fp32, r[hd, MAXD) = 0. `vec`: 16-byte
// loads (the row is 16-byte aligned and hd a multiple of Vec<T>::n).
template <typename T, int MAXD>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int hd,
                                         bool vec, float (&r)[MAXD]) {
  constexpr int V = Vec<T>::n;
  static_assert(MAXD % V == 0, "MAXD must hold whole 16-byte chunks");
  if (vec) {
#pragma unroll
    for (int c = 0; c < MAXD; c += V) {
      if (c < hd) {
        unpack(__ldg(reinterpret_cast<const uint4*>(p + c)), r + c, T());
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) r[c + i] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < MAXD; ++d) r[d] = d < hd ? to_float(p[d]) : 0.f;
  }
}

template <typename T, int MAXD>
__device__ __forceinline__ void store_row(T* __restrict__ p, int hd, bool vec,
                                          const float (&r)[MAXD]) {
  constexpr int V = Vec<T>::n;
  if (vec) {
#pragma unroll
    for (int c = 0; c < MAXD; c += V)
      if (c < hd) *reinterpret_cast<uint4*>(p + c) = pack(r + c, T());
  } else {
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < hd) p[d] = from_float<T>(r[d]);
  }
}

// fp32 dot product over d in four interleaved partial sums (a shorter
// chain of dependent FMAs than one running sum); the zero tail adds exact
// zeros.
template <int MAXD>
__device__ __forceinline__ float dot(const float (&a)[MAXD],
                                     const float (&b)[MAXD]) {
  static_assert(MAXD % 4 == 0, "MAXD must be a multiple of 4");
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < MAXD; ++d) acc[d % 4] = fmaf(a[d], b[d], acc[d % 4]);
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// Max and 1 / denominator of the softmax over s of qs . k_s (qs already
// scaled by head_dim^-0.5), in one sweep over S with the running
// denominator rescaled whenever the max grows; the weight of step s is then
// expf(qs . k_s - m) * inv.
template <typename T, int MAXD>
__device__ __forceinline__ void softmax_stats(const float (&qs)[MAXD],
                                              const T* __restrict__ kb,
                                              long long kstride, int S,
                                              int hd, bool vec, float& m,
                                              float& inv) {
  m = -INFINITY;
  float denom = 0.f;
  for (int s = 0; s < S; ++s) {
    float kr[MAXD];
    load_row<T, MAXD>(kb + s * kstride, hd, vec, kr);
    const float l = dot(qs, kr);
    if (l > m) {
      denom *= expf(m - l);
      m = l;
    }
    denom += expf(l - m);
  }
  inv = 1.0f / denom;
}

// Calls f(std::integral_constant<int, MAXD>()) with the register width for
// head_dim: the smallest of 8, 16, 32, 64, 128 that holds it.
template <typename F>
int with_head_dim(int hd, F&& f) {
  if (hd < 1) return (int)cudaErrorInvalidValue;
  if (hd <= 8) return f(std::integral_constant<int, 8>());
  if (hd <= 16) return f(std::integral_constant<int, 16>());
  if (hd <= 32) return f(std::integral_constant<int, 32>());
  if (hd <= 64) return f(std::integral_constant<int, 64>());
  if (hd <= 128) return f(std::integral_constant<int, 128>());
  return (int)cudaErrorInvalidValue;
}

}  // namespace temporal
