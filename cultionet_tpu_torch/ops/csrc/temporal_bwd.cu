// Per-pixel multi-head attention along the time axis, backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cultionet_tpu/ops/temporal_pallas.py::_bwd_kernel:
// dq, dk and dv of temporal_fwd.cu at cotangent g, in one launch, with the
// softmax weights recomputed from (q, k, v) and nothing T x S-sized stored in
// device memory. With w_ts the forward's weights and qs_t = q_t *
// head_dim^-0.5:
//   dw_ts    = g_t . v_s,          delta_t = sum_s w_ts dw_ts,
//   dlogit   = w_ts (dw_ts - delta_t),
//   dq_t     = head_dim^-0.5 sum_s dlogit_ts k_s,
//   dk_s     = sum_t dlogit_ts qs_t,   dv_s = sum_t w_ts g_t,
// all in fp32, each output written once in the input type.
//
// Bound on the card: bytes (q, k, v, g read once, dq, dk, dv written once;
// about 10 * S * head_dim operations per (pixel, head, step)).
//
// Design (first, simple version). Every pixel is independent, so one block
// takes a tile of whole pixels and each output element has one writer: no
// atomics, and the result is deterministic. The tile is large enough that
// the smaller of two thread mappings fills the block (the pooling call has
// one query step per pixel, so a tile sized for its 12 key steps would
// leave phase 1 with a tenth of the threads; on an H100 that made the
// pooling's backward three times slower). The mappings are separated by
// __syncthreads:
//  - Phase 1, one thread per (pixel, query step t, head): the softmax
//    statistics with the forward's code (softmax_stats), then delta_t and
//    dq_t in one more loop over S (dq_t as the sums of w dw k_s and of
//    w k_s, combined with delta_t after the loop). It stores (max,
//    1 / denominator, delta_t) in shared memory, 12 bytes per (pixel, t,
//    head).
//  - Phase 2, one thread per (pixel, key step s, head): dk_s and dv_s over
//    t, each weight rebuilt as expf(qs_t . k_s - max_t) * inv_t from the
//    same dot product, so it equals the forward's weight bit for bit.
// As in the forward, head_dim values of each row live in registers (width
// MAXD >= head_dim) and the logits are recomputed instead of stored.

#include "temporal_common.cuh"

namespace {

using namespace temporal;

constexpr int kStatSmemLimit = 227 * 1024;

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
    temporal_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        T* __restrict__ dq, T* __restrict__ dk,
                        T* __restrict__ dv, Strides sq, Strides sk,
                        Strides sv, Strides sg, long long N, int Tq, int S,
                        int H, int hd, float scale, int pixels, bool vec) {
  // (m, inv, delta) of each (pixel, step, head), in phase 1's order.
  extern __shared__ float stats[];
  const long long n0 = (long long)blockIdx.x * pixels;
  const int np = (int)min((long long)pixels, N - n0);
  const long long C = (long long)H * hd;

  // Threads in (pixel, step, head) order, the head fastest, as in the
  // forward.
  const int items_q = np * Tq * H;
  for (int i = threadIdx.x; i < items_q; i += blockDim.x) {
    const int h = i % H;
    const int t = (i / H) % Tq;
    const long long n = n0 + i / (H * Tq);
    float qs[MAXD], gr[MAXD];
    load_row<T, MAXD>(q + n * sq.n + t * sq.t + h * hd, hd, vec, qs);
#pragma unroll
    for (int d = 0; d < MAXD; ++d) qs[d] *= scale;
    load_row<T, MAXD>(g + n * sg.n + t * sg.t + h * hd, hd, vec, gr);
    const T* kb = k + n * sk.n + h * hd;
    const T* vb = v + n * sv.n + h * hd;
    float m, inv;
    softmax_stats<T, MAXD>(qs, kb, sk.t, S, hd, vec, m, inv);

    // delta and dq in one loop: dq_t / scale = sum_s w dw k_s - delta
    // sum_s w k_s.
    float delta = 0.f, wdk[MAXD], wk[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) wdk[d] = wk[d] = 0.f;
    for (int s = 0; s < S; ++s) {
      float kr[MAXD], vr[MAXD];
      load_row<T, MAXD>(kb + s * sk.t, hd, vec, kr);
      load_row<T, MAXD>(vb + s * sv.t, hd, vec, vr);
      const float w = expf(dot(qs, kr) - m) * inv;
      const float wdw = w * dot(gr, vr);
      delta += wdw;
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        wdk[d] = fmaf(wdw, kr[d], wdk[d]);
        wk[d] = fmaf(w, kr[d], wk[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      wdk[d] = scale * fmaf(-delta, wk[d], wdk[d]);
    store_row<T, MAXD>(dq + (n * Tq + t) * C + h * hd, hd, vec, wdk);
    stats[3 * i] = m;
    stats[3 * i + 1] = inv;
    stats[3 * i + 2] = delta;
  }
  __syncthreads();

  const int items_k = np * S * H;
  for (int i = threadIdx.x; i < items_k; i += blockDim.x) {
    const int h = i % H;
    const int s = (i / H) % S;
    const int p = i / (H * S);
    const long long n = n0 + p;
    float kr[MAXD], vr[MAXD], dkr[MAXD], dvr[MAXD];
    load_row<T, MAXD>(k + n * sk.n + s * sk.t + h * hd, hd, vec, kr);
    load_row<T, MAXD>(v + n * sv.n + s * sv.t + h * hd, hd, vec, vr);
#pragma unroll
    for (int d = 0; d < MAXD; ++d) dkr[d] = dvr[d] = 0.f;
    for (int t = 0; t < Tq; ++t) {
      float qs[MAXD], gr[MAXD];
      load_row<T, MAXD>(q + n * sq.n + t * sq.t + h * hd, hd, vec, qs);
#pragma unroll
      for (int d = 0; d < MAXD; ++d) qs[d] *= scale;
      load_row<T, MAXD>(g + n * sg.n + t * sg.t + h * hd, hd, vec, gr);
      const float* st = stats + 3 * ((p * Tq + t) * H + h);
      const float w = expf(dot(qs, kr) - st[0]) * st[1];
      const float dl = w * (dot(gr, vr) - st[2]);
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        dvr[d] = fmaf(w, gr[d], dvr[d]);
        dkr[d] = fmaf(dl, qs[d], dkr[d]);
      }
    }
    const long long row = (n * S + s) * C + h * hd;
    store_row<T, MAXD>(dk + row, hd, vec, dkr);
    store_row<T, MAXD>(dv + row, hd, vec, dvr);
  }
}

// A launch over tiles of whole pixels: `pixels` per block, so that the
// smaller of the kernel's thread mappings (`per_pixel_min` items per pixel)
// fills about kThreads threads, as far as the statistics of `pixels` pixels
// (`stat_bytes` each) fit in shared memory, and `threads` (a multiple of 32,
// at most kThreads) for the larger (`per_pixel_max`); threads loop over a
// mapping's items.
struct Tile {
  int pixels, threads;
  long long blocks;
};

inline Tile pixel_tile(long long N, long long per_pixel_min,
                       long long per_pixel_max, long long stat_bytes) {
  Tile tile;
  long long pixels = per_pixel_min >= kThreads ? 1 : kThreads / per_pixel_min;
  const long long fit = kStatSmemLimit / stat_bytes;
  tile.pixels = (int)(pixels < fit ? pixels : (fit > 1 ? fit : 1));
  const long long items = tile.pixels * per_pixel_max;
  tile.threads = items >= kThreads ? kThreads : (int)((items + 31) / 32 * 32);
  tile.blocks = (N + tile.pixels - 1) / tile.pixels;
  return tile;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g,
           void* dq, void* dk, void* dv, const long long* strides,
           long long N, int Tq, int S, int H, int hd, bool vec,
           cudaStream_t stream) {
  const Strides sq{strides[0], strides[1]};
  const Strides sk{strides[2], strides[3]};
  const Strides sv{strides[4], strides[5]};
  const Strides sg{strides[6], strides[7]};
  const float scale = (float)(1.0 / sqrt((double)hd));
  // Enough pixels per block that the smaller phase fills the block (the
  // pooling's phase 1 has one step per pixel); the larger phase loops.
  const long long stat_bytes = (long long)Tq * H * 3 * sizeof(float);
  const Tile tile = pixel_tile(N, (long long)H * (Tq < S ? Tq : S),
                               (long long)H * (Tq > S ? Tq : S), stat_bytes);
  const long long smem = tile.pixels * stat_bytes;
  if (smem > kStatSmemLimit) return (int)cudaErrorInvalidValue;
  if (tile.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return with_head_dim(hd, [&](auto maxd) {
    constexpr int MAXD = decltype(maxd)::value;
    auto kernel = temporal_bwd_kernel<T, MAXD>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(unsigned)tile.blocks, tile.threads, (size_t)smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
        sv, sg, N, Tq, S, H, hd, scale, tile.pixels, vec);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q and g are (N, Tq, H * hd), k and v
// (N, S, H * hd); strides: 8 element strides, (n, t) of q, k, v, then g; the
// channel axis is unit-stride. dq, dk, dv are contiguous, shaped like q, k,
// v. vec != 0 promises 16-byte aligned rows. head_dim <= 128, and
// Tq * H * 12 bytes must fit in a block's shared memory. Returns a
// cudaError_t (0 = launched).
extern "C" int temporal_bwd(int dtype, const void* q, const void* k,
                            const void* v, const void* g, void* dq, void* dk,
                            void* dv, const long long* strides, long long N,
                            int Tq, int S, int H, int hd, int vec,
                            void* stream) {
  if (Tq < 1 || S < 1 || H < 1 || hd < 1 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, g, dq, dk, dv, strides, N, Tq, S, H, hd,
                         vec != 0, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, strides, N, Tq, S,
                                 H, hd, vec != 0, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* temporal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
