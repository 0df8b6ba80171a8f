// 2-D neighborhood attention (NATTEN semantics), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernels cultionet_tpu/ops/natten_pallas.py::
// _na2d_fwd_kernel (na2d_fwd below) and _na2d_fwd_drop_kernel
// (na2d_fwd_drop), both bodies of _na2d_fwd_impl. It computes the same math,
// not the TPU layout: for every query pixel and head a softmax in fp32 of
// (q * D^-0.5) . k over the clamped, dilated kernel_size x kernel_size
// window, then the weighted sum of v, written back in the input type. The
// dropout variant multiplies each post-softmax weight by its keep bit times
// 1 / (1 - p) (inverted dropout), as the Pallas kernel does.
//
// Bound on the card: bytes. It must read q, k and v once and write out once
// (4 * D values per query-head); the arithmetic, 4 * k * k * D operations
// per query-head, is 4.5 operations per byte at k = 3 in bf16, far under
// the H100's fp32 rate per HBM byte. What costs is reading each key k * k
// times, once per query that holds it.
//
// Design: query tiles that share a k/v halo in shared memory.
//  - A block owns one (b, head, coset) and a th x tw tile of that coset's
//    positions (ops/natten_cuda.py::_tile_plan picks the tile). A dilated
//    image is dense in coset coordinates, so dilation 2 costs nothing.
//  - The window start steps by 0 or 1 along a coset, so the tile's keys are
//    one rectangle of at most (th + k - 1) x (tw + k - 1) positions. The
//    block copies that rectangle of k and of v into shared memory once, in
//    the input type, with 16-byte cp.async (each pixel's head vector is
//    contiguous, even inside the strided thirds of a fused qkv projection).
//    Device memory then sees each key about (th + k - 1)(tw + k - 1) /
//    (th * tw) times, 1.4 at the model's 8 x 16 tiles and k = 3.
//  - Each query goes to `group` lanes (ceil(D / 16), a power of two): a lane
//    holds up to 16 channels of q in registers, scaled by D^-0.5 in fp32.
//    The k * k logits are independent sums, each closed by a butterfly of
//    log2(group) shuffles (2 steps at D = 64 in bf16), with the slots'
//    loads and products interleaved (window_dots in na2d_common.cuh, the
//    code the backward's first pass runs too).
//  - Max-subtracted softmax with exact 1.0f / denom; slot j's weight is
//    formed by lane j % group into the query's shared-memory row, then
//    every lane sums its channels of the weighted v from the halo and
//    stores them with 16-byte stores.
//  - Dropout (template flag, so the plain forward carries no trace of it):
//    the keep bit is a counter-based hash of (seed, query, window slot),
//    with `query` the flat (b, h, w, head) index (na2d_common.cuh), so the
//    mask does not depend on the tiles and the backward (na2d_bwd.cu)
//    redraws it exactly. At p = 0 every bit keeps and the factor is 1.0f,
//    so the result equals na2d_fwd bit for bit.
//  - VEC = 16 / sizeof(T) elements per chunk when the host found every
//    pointer and stride 16-byte aligned and D * sizeof(T) a multiple of 16;
//    otherwise VEC = 1, the same kernel with scalar loads. KS = 3 is the
//    model's window, unrolled at compile time; KS = 0 reads it at run time.
// Measured share of the byte bound (chip_smoke.py, H100 80GB HBM3 at 700 W,
// PERF.md): in bf16 40% at the model's 140 x 140 d2 site (0.237 ms, 5.4x
// the warp-per-query kernel before it), 27-37% at its smaller sites, 33%
// for the dropout variant at 100 x 100 d2; in fp32, whose bytes double,
// 72%. bf16 is held by instructions (conversions, the shared-memory reads
// of each window), not by bytes.
// Window indices follow _axis_neighbor_indices (ops/natten.py): exact for
// any length, dilation and ragged coset.

#include <math.h>

#include "na2d_common.cuh"

namespace {

using namespace na2d;

template <typename T, int VEC, int KS, bool kDrop>
__global__ void __launch_bounds__(kMaxThreads)
    na2d_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, Strides sq,
                    Strides sk, Strides sv, Geometry geo, Plan pl,
                    float scale, Dropout drop) {
  const int ks = KS > 0 ? KS : geo.ks;
  const int kk = ks * ks;
  const int nchunks = geo.D / VEC;
  Tile t;
  if (!block_tile(pl, geo, t)) return;  // the whole block leaves together
  const Pixel me = thread_pixel(pl, t);
  const Halo halo = key_halo(t, ks);

  unsigned char* smem = dynamic_smem();
  const int halo_bytes = (pl.cap * pl.pix * (int)sizeof(T) + 15) / 16 * 16;
  T* kh = reinterpret_cast<T*>(smem);
  T* vh = reinterpret_cast<T*>(smem + halo_bytes);
  float* row = reinterpret_cast<float*>(smem + 2 * halo_bytes) + me.slot * kk;

  const int row0 = t.ch + geo.dil * halo.h0, col0 = t.cw + geo.dil * halo.w0;
  load_halo<T, VEC>(kh, k + t.b * sk.b + t.n * sk.n, sk.h, sk.w, row0, col0,
                    geo.dil, halo, nchunks, pl.pix);
  load_halo<T, VEC>(vh, v + t.b * sv.b + t.n * sv.n, sv.h, sv.w, row0, col0,
                    geo.dil, halo, nchunks, pl.pix);

  const int h = t.ch + geo.dil * me.ph, w = t.cw + geo.dil * me.pw;
  LaneVec<VEC> qr;
  load_lane<T, VEC>(pl, me.lane, nchunks,
                    q + t.b * sq.b + h * sq.h + w * sq.w + t.n * sq.n, scale,
                    qr);
  uint32_t seed = 0;
  if (kDrop) seed = (uint32_t)(*drop.seed);
  cp_async_wait_all();
  __syncthreads();

  const int base = (coset_start(me.ph, t.clen_h, ks) - halo.h0) * halo.cols +
                   (coset_start(me.pw, t.clen_w, ks) - halo.w0);
  window_dots<false, KS, T, VEC>(pl, me.lane, nchunks, ks, qr, qr, kh, vh,
                                 base, halo.cols, row, nullptr);
  float m, inv;
  softmax_stats(row, kk, m, inv);
  __syncwarp();
  const long long query = ((t.b * geo.H + h) * geo.W + w) * geo.N + t.n;
  for (int j = me.lane; j < kk; j += pl.group) {
    float wj = expf(row[j] - m) * inv;
    if (kDrop)
      wj = keep_bit(seed, query, j, drop.threshold) ? wj * drop.inv_keep : 0.f;
    row[j] = wj;
  }
  __syncwarp();

  LaneVec<VEC> acc;
#pragma unroll
  for (int i = 0; i < LaneVec<VEC>::kChunks; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc.x[i][e] = 0.f;
#pragma unroll
  for (int jh = 0; jh < ks; ++jh)
#pragma unroll
    for (int jw = 0; jw < ks; ++jw)
      axpy_lane<T, VEC>(pl, me.lane, nchunks,
                        vh + (base + jh * halo.cols + jw) * pl.pix,
                        row[jh * ks + jw], acc);
  if (me.valid) store_lane<T, VEC>(pl, me.lane, nchunks, out + query * geo.D,
                                   1.0f, acc);
}

template <typename T, int VEC, int KS, bool kDrop>
int launch(const void* q, const void* k, const void* v, void* out,
           const Strides* s, int B, const Geometry& geo, const Plan& pl,
           Dropout drop, cudaStream_t stream) {
  const int kk = geo.ks * geo.ks;
  const int threads = block_threads(pl);
  const int halo_bytes = align16((long long)pl.cap * pl.pix * sizeof(T));
  const int needed = 2 * halo_bytes + threads / pl.group * kk * 4;
  if (needed != pl.smem || threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  auto kernel = na2d_fwd_kernel<T, VEC, KS, kDrop>;
  if (pl.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != cudaSuccess) return (int)e;
  }
  // D^-0.5 rounded once from double, as the host frameworks round it.
  const float scale = (float)(1.0 / sqrt((double)geo.D));
  const dim3 grid(pl.tiles_h * pl.tiles_w * geo.dil * geo.dil, geo.N, B);
  kernel<<<grid, threads, pl.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s[0], s[1], s[2], geo,
      pl, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T, bool kDrop>
int launch_vec(int vec, const void* q, const void* k, const void* v,
               void* out, const Strides* s, int B, const Geometry& geo,
               const Plan& pl, Dropout drop, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec && geo.D % kVec == 0) {
    if (geo.ks == 3)
      return launch<T, kVec, 3, kDrop>(q, k, v, out, s, B, geo, pl, drop,
                                       stream);
    return launch<T, kVec, 0, kDrop>(q, k, v, out, s, B, geo, pl, drop,
                                     stream);
  }
  if (vec == 1) {
    if (geo.ks == 3)
      return launch<T, 1, 3, kDrop>(q, k, v, out, s, B, geo, pl, drop,
                                    stream);
    return launch<T, 1, 0, kDrop>(q, k, v, out, s, B, geo, pl, drop, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kDrop>
int dispatch(int dtype, int vec, const void* q, const void* k, const void* v,
             void* out, const long long* strides, int B, int H, int W, int N,
             int D, int ks, int dil, const int* plan, Dropout drop,
             void* stream) {
  if (ks < 1 || dil < 1 || D < 1 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || N == 0) return 0;
  const Strides s[3] = {{strides[0], strides[1], strides[2], strides[3]},
                        {strides[4], strides[5], strides[6], strides[7]},
                        {strides[8], strides[9], strides[10], strides[11]}};
  const Geometry geo{H, W, N, D, ks, dil};
  const Plan pl = read_plan(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_vec<float, kDrop>(vec, q, k, v, out, s, B, geo, pl, drop,
                                    st);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16, kDrop>(vec, q, k, v, out, s, B, geo, pl,
                                            drop, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: elements per load, 16 / itemsize
// (every pointer and stride 16-byte aligned, D * itemsize a multiple of 16)
// or 1. strides: 12 element strides, (b, h, w, head) for q, then k, then v;
// the head_dim axis must be unit-stride and out is contiguous
// (B, H, W, N, D). plan: the 11 ints of ops/natten_cuda.py::
// TilePlan.args. Returns a cudaError_t (0 = launched).
extern "C" int na2d_fwd(int dtype, int vec, const void* q, const void* k,
                        const void* v, void* out, const long long* strides,
                        int B, int H, int W, int N, int D, int ks, int dil,
                        const int* plan, void* stream) {
  return dispatch<false>(dtype, vec, q, k, v, out, strides, B, H, W, N, D, ks,
                         dil, plan, Dropout{nullptr, 0u, 1.0f}, stream);
}

// As na2d_fwd, with inverted dropout on the attention weights: `seed` is a
// device pointer to one int32, `threshold` = ceil(p * 2^24) and `inv_keep`
// = 1 / (1 - p).
extern "C" int na2d_fwd_drop(int dtype, int vec, const void* q, const void* k,
                             const void* v, void* out,
                             const long long* strides, int B, int H, int W,
                             int N, int D, int ks, int dil, const int* plan,
                             const int* seed, unsigned int threshold,
                             float inv_keep, void* stream) {
  if (seed == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(dtype, vec, q, k, v, out, strides, B, H, W, N, D, ks,
                        dil, plan, Dropout{seed, threshold, inv_keep}, stream);
}

extern "C" const char* na2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
