// 2-D neighborhood attention (NATTEN semantics), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernels cultionet_tpu/ops/natten_pallas.py::
// _na2d_fwd_kernel (na2d_fwd below) and _na2d_fwd_drop_kernel
// (na2d_fwd_drop), both bodies of _na2d_fwd_impl. It computes the same math,
// not the TPU layout: no lane packing, no batch->lane fold, no row bands, no
// DMA halos. For every query pixel and head: a softmax in fp32 of
// (q * D^-0.5) . k over the clamped, dilated kernel_size x kernel_size
// window, then the weighted sum of v, written back in the input type. The
// dropout variant multiplies each post-softmax weight by its keep bit times
// 1 / (1 - p) (inverted dropout), as the Pallas kernel does.
//
// Bound on the card: bytes. Each query reads D values of q and writes D of
// out; k and v are read k*k times per query, but neighbouring queries share
// them, so they come from L1/L2 and device memory sees each about once. The
// arithmetic is 4*k*k*D operations per query-head (k=3: 36*D), far below the
// card's fp32 rate per byte moved. This first version does not reach that
// bound: each warp's k*k dependent shuffle reductions over one short row
// leave it latency-bound (about 7% of the byte bound at the model's 140x140
// shape on an H100 SXM, PERF.md).
//
// Design (first, simple version): one warp per (b, h, w, head) query.
//  - The lanes stride over D. q is upcast to fp32 and scaled by D^-0.5 in
//    fp32 (as the Pallas kernel does), and kept in shared memory.
//  - For each of the k*k neighbours the lanes form partial dot products and
//    a butterfly of warp shuffles sums them in fp32; lane 0 stores the logit
//    in the warp's shared-memory row.
//  - Max-subtracted softmax over the k*k logits (every lane reads them all
//    from shared memory); exact 1.0f / denom; the weights go to a second
//    shared-memory row, so any kernel_size fits.
//  - Dropout (template flag, so the plain forward carries no trace of it):
//    the keep bit is a counter-based hash of (seed, query, window slot)
//    (na2d_common.cuh), so the mask does not depend on this grid and the
//    backward (na2d_bwd.cu) redraws it exactly. At p = 0 every bit keeps and
//    the factor is 1.0f, so the result equals na2d_fwd bit for bit.
//  - Each lane accumulates its D/32 output channels in fp32 over the window.
// The backward kernels recompute the logits with the same code and order of
// summation (na2d_bwd.cu), so their softmax weights are the ones used here.
// Window indices follow _axis_neighbor_indices (ops/natten.py): exact for any
// length, dilation and ragged coset. Inputs may be strided views (the thirds
// of a fused qkv projection) as long as the head_dim axis is unit-stride.

#include <math.h>

#include "na2d_common.cuh"

namespace {

using namespace na2d;

template <typename T, bool kDrop>
__global__ void na2d_fwd_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ out,
                                Strides sq, Strides sk, Strides sv, int H,
                                int W, int N, int D, int ks, int dil,
                                float scale, long long total, Dropout drop) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int kk = ks * ks;
  float* qs = smem + warp * (D + 2 * kk);
  float* logits = qs + D;
  float* wts = logits + kk;

  const long long query = (long long)blockIdx.x * warps + warp;
  if (query >= total) return;  // the whole warp leaves together
  long long t = query;
  const int n = (int)(t % N);
  t /= N;
  const int w = (int)(t % W);
  t /= W;
  const int h = (int)(t % H);
  const long long b = t / H;

  const T* qp = q + b * sq.b + h * sq.h + w * sq.w + n * sq.n;
  for (int c = lane; c < D; c += kWarp) qs[c] = to_float(qp[c]) * scale;
  __syncwarp();

  const int h0 = window_start(h, H, ks, dil);
  const int w0 = window_start(w, W, ks, dil);
  const T* kb = k + b * sk.b + n * sk.n;
  const T* vb = v + b * sv.b + n * sv.n;

  for (int jh = 0; jh < ks; ++jh) {
    const T* krow = kb + (long long)(h0 + dil * jh) * sk.h;
    for (int jw = 0; jw < ks; ++jw) {
      const T* kp = krow + (long long)(w0 + dil * jw) * sk.w;
      float part = 0.f;
      for (int c = lane; c < D; c += kWarp) part += qs[c] * to_float(kp[c]);
      part = warp_sum(part);
      if (lane == 0) logits[jh * ks + jw] = part;
    }
  }
  __syncwarp();

  float m = -INFINITY;
  for (int j = 0; j < kk; ++j) m = fmaxf(m, logits[j]);
  float denom = 0.f;
  for (int j = 0; j < kk; ++j) denom += expf(logits[j] - m);
  const float inv = 1.0f / denom;
  uint32_t seed = 0;
  if (kDrop) seed = (uint32_t)(*drop.seed);
  for (int j = lane; j < kk; j += kWarp) {
    float wj = expf(logits[j] - m) * inv;
    if (kDrop)
      wj = keep_bit(seed, query, j, drop.threshold) ? wj * drop.inv_keep : 0.f;
    wts[j] = wj;
  }
  __syncwarp();

  T* op = out + query * D;
  for (int c = lane; c < D; c += kWarp) {
    float acc = 0.f;
    for (int jh = 0; jh < ks; ++jh) {
      const T* vrow = vb + (long long)(h0 + dil * jh) * sv.h + c;
      for (int jw = 0; jw < ks; ++jw)
        acc += wts[jh * ks + jw] * to_float(vrow[(long long)(w0 + dil * jw) * sv.w]);
    }
    op[c] = from_float<T>(acc);
  }
}

template <typename T, bool kDrop>
int launch(const void* q, const void* k, const void* v, void* out,
           const long long* strides, int B, int H, int W, int N, int D,
           int ks, int dil, Dropout drop, cudaStream_t stream) {
  const long long total = (long long)B * H * W * N;
  const int row_bytes = (D + 2 * ks * ks) * (int)sizeof(float);
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && warps * row_bytes > kStaticSmemLimit) warps /= 2;
  if (warps * row_bytes > kStaticSmemLimit) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + warps - 1) / warps;
  const Strides sq{strides[0], strides[1], strides[2], strides[3]};
  const Strides sk{strides[4], strides[5], strides[6], strides[7]};
  const Strides sv{strides[8], strides[9], strides[10], strides[11]};
  // D^-0.5 rounded once from double, as the host frameworks round it.
  const float scale = (float)(1.0 / sqrt((double)D));
  na2d_fwd_kernel<T, kDrop><<<(unsigned)blocks, warps * kWarp,
                              warps * row_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, sv, H, W, N, D,
      ks, dil, scale, total, drop);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             void* out, const long long* strides, int B, int H, int W, int N,
             int D, int ks, int dil, Dropout drop, void* stream) {
  if (ks < 1 || dil < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kDrop>(q, k, v, out, strides, B, H, W, N, D, ks,
                                dil, drop, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kDrop>(q, k, v, out, strides, B, H, W, N, D,
                                        ks, dil, drop, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (b, h, w,
// head) for q, then k, then v; the head_dim axis must be unit-stride and out
// is contiguous (B, H, W, N, D). Returns a cudaError_t (0 = launched).
extern "C" int na2d_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* out, const long long* strides,
                        int B, int H, int W, int N, int D, int ks, int dil,
                        void* stream) {
  return dispatch<false>(dtype, q, k, v, out, strides, B, H, W, N, D, ks, dil,
                         Dropout{nullptr, 0u, 1.0f}, stream);
}

// As na2d_fwd, with inverted dropout on the attention weights: `seed` is a
// device pointer to one int32, `threshold` = ceil(p * 2^24) and `inv_keep`
// = 1 / (1 - p).
extern "C" int na2d_fwd_drop(int dtype, const void* q, const void* k,
                             const void* v, void* out,
                             const long long* strides, int B, int H, int W,
                             int N, int D, int ks, int dil, const int* seed,
                             unsigned int threshold, float inv_keep,
                             void* stream) {
  if (seed == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(dtype, q, k, v, out, strides, B, H, W, N, D, ks, dil,
                        Dropout{seed, threshold, inv_keep}, stream);
}

extern "C" const char* na2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
