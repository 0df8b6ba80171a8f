// Per-pixel multi-head attention along the time axis, forward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cultionet_tpu/ops/temporal_pallas.py::_fwd_kernel.
// It computes the same math, not the TPU layout: no lane fold, no group mask,
// no _reduce_groups matmul, no row bands. For every pixel n, head h and query
// step t: a softmax in fp32 over the S key steps of
// (q[n, t, h] * head_dim^-0.5) . k[n, s, h], then the weighted sum of
// v[n, s, h], accumulated in fp32 and written once in the input type.
//
// Bound on the card: bytes. q, k, v are read once and out written once from
// device memory; the arithmetic is 4 * S * head_dim operations per (pixel,
// head, step) (two dot products per key step), about 12 per byte moved at
// the model's T = 12 in bf16, far below the card's fp32 rate per byte. The
// kernel recomputes each logit twice and its threads of one (pixel, head)
// each convert the same k and v rows, so it executes several times those
// operations.
//
// Design (first, simple version). T is tiny (about 12) and the pixels many
// (156,800 per predict batch), so there is no reduction across threads at
// all, and no warp shuffles (the NA kernels' latency bound, PERF.md):
//  - One thread per (pixel, step, head), the head fastest: a warp's
//    threads read and write neighbouring head slices of the same rows, so
//    its q loads and out stores are contiguous, and the threads of one
//    (pixel, head) load the same k and v rows, one request serving all of
//    them. (Ordering the threads step-major in tiles of pixels, so that a
//    warp's threads read distinct rows, ran 1.2 to 1.6 times slower on an
//    H100.)
//  - head_dim values of q (scaled in fp32), of the running output and of
//    one k or v row live in registers (a template width MAXD >= head_dim,
//    the tail zero), loaded with 16-byte loads where the rows are aligned.
//  - Two loops over S: the max and the denominator in one sweep
//    (softmax_stats, shared with the backward), then the weighted sum of v
//    with the weights expf(l - m) * (1 / denominator). The logits are
//    recomputed in the second loop rather than stored, so any S works with
//    nothing S-sized held.
// Inputs may be strided views (the thirds of a fused qkv projection; a
// pooling query broadcast over pixels with stride 0 along N) as long as the
// channel axis is unit-stride.

#include "temporal_common.cuh"

namespace {

using namespace temporal;

// out[n, t, head h] for one (pixel, step, head).
template <typename T, int MAXD>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, Strides sq,
                                       Strides sk, Strides sv, long long n,
                                       int t, int h, int Tq, int S, int H,
                                       int hd, float scale, bool vec) {
  float qs[MAXD];
  load_row<T, MAXD>(q + n * sq.n + t * sq.t + h * hd, hd, vec, qs);
#pragma unroll
  for (int d = 0; d < MAXD; ++d) qs[d] *= scale;

  const T* kb = k + n * sk.n + h * hd;
  const T* vb = v + n * sv.n + h * hd;
  float m, inv;
  softmax_stats<T, MAXD>(qs, kb, sk.t, S, hd, vec, m, inv);

  float acc[MAXD];
#pragma unroll
  for (int d = 0; d < MAXD; ++d) acc[d] = 0.f;
  for (int s = 0; s < S; ++s) {
    float kr[MAXD], vr[MAXD];
    load_row<T, MAXD>(kb + s * sk.t, hd, vec, kr);
    const float w = expf(dot(qs, kr) - m) * inv;
    load_row<T, MAXD>(vb + s * sv.t, hd, vec, vr);
#pragma unroll
    for (int d = 0; d < MAXD; ++d) acc[d] = fmaf(w, vr[d], acc[d]);
  }
  store_row<T, MAXD>(out + ((n * Tq + t) * H + h) * hd, hd, vec, acc);
}

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
    temporal_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        Strides sq, Strides sk, Strides sv, long long N,
                        int Tq, int S, int H, int hd, float scale, bool vec) {
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= N * Tq * H) return;
  const long long nt = item / H;  // n * Tq + t
  attend<T, MAXD>(q, k, v, out, sq, sk, sv, nt / Tq, (int)(nt % Tq),
                  (int)(item % H), Tq, S, H, hd, scale, vec);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const long long* strides, long long N, int Tq, int S, int H,
           int hd, bool vec, cudaStream_t stream) {
  const Strides sq{strides[0], strides[1]};
  const Strides sk{strides[2], strides[3]};
  const Strides sv{strides[4], strides[5]};
  // head_dim^-0.5 rounded once from double, as the host frameworks round it.
  const float scale = (float)(1.0 / sqrt((double)hd));
  const long long blocks = (N * Tq * H + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return with_head_dim(hd, [&](auto maxd) {
    constexpr int MAXD = decltype(maxd)::value;
    temporal_fwd_kernel<T, MAXD><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), sq, sk, sv, N, Tq, S,
        H, hd, scale, vec);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is (N, Tq, H * hd), k and v
// (N, S, H * hd); strides: 6 element strides, (n, t) of q, then k, then v;
// the channel axis is unit-stride and out is contiguous (N, Tq, H * hd).
// vec != 0 promises 16-byte aligned rows (pointers, strides and hd multiples
// of 16 bytes). head_dim <= 128. Returns a cudaError_t (0 = launched).
extern "C" int temporal_fwd(int dtype, const void* q, const void* k,
                            const void* v, void* out,
                            const long long* strides, long long N, int Tq,
                            int S, int H, int hd, int vec, void* stream) {
  if (Tq < 1 || S < 1 || H < 1 || hd < 1 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, strides, N, Tq, S, H, hd, vec != 0, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, strides, N, Tq, S, H, hd,
                                 vec != 0, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* temporal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
