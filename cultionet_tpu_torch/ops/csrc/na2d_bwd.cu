// 2-D neighborhood attention (NATTEN semantics), backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels cultionet_tpu/ops/natten_pallas.py::
// _na2d_bwd_kernel (na2d_bwd below) and _na2d_bwd_drop_kernel
// (na2d_bwd_drop), both bodies of _na2d_bwd_impl: the flash-style backward
// of na2d_fwd.cu, which recomputes the softmax from q and k instead of
// storing it. Given g = dL/dout it returns dq, dk and dv in the input type.
// With out = sum_j w~_j v_j, w~_j = m_j w_j / (1 - p) (m_j the keep bit, all
// ones without dropout) and r_j = (m_j / (1 - p)) g . v_j:
//   D      = sum_j w_j r_j                      (the Pallas kernel's dot_term)
//   dl_j   = w_j (r_j - D)                      (softmax backward)
//   dq     = D^-0.5 sum_j dl_j k_j
//   dk_key = sum over the queries whose window holds key of dl_j q D^-0.5
//   dv_key = sum over the same queries of w~_j g
//
// Bound on the card: bytes. It must read q, k, v and g once and write dq,
// dk and dv once (7 * D values per query-head); the arithmetic, about
// 10 * k * k * D operations per query-head, is 6.4 operations per byte at
// k = 3 in bf16, far under the H100's fp32 rate per HBM byte.
//
// Design: two launches, both tiled like the forward, no atomics, the same
// bits from run to run.
//  - Pass 1, query tiles (na2d_bwd_query_kernel) with the forward's k/v
//    halo in shared memory: it recomputes the logits with the forward's
//    window_dots and softmax_stats (na2d_common.cuh), so its weights are
//    the forward's bit for bit, and forms g . v_j in the same sweep. It
//    writes dq with 16-byte stores and, per query-head and window slot, two
//    fp32 values to a scratch: ds_j = dl_j and w~_j, the weight after
//    dropout (2 * k * k floats, 72 bytes a query-head at k = 3, against the
//    7 * 64 * 2 = 896 bytes the bound moves at D = 64).
//  - Pass 2, key tiles (na2d_bwd_key_kernel): the queries whose windows
//    hold a key of the tile are one rectangle of coset positions (the tile
//    widened by at most k - 1 on each side; first_query / last_query), so
//    the block copies their q and g, and their scratch rows, into shared
//    memory once. Each key then sums dk = D^-0.5 sum ds_j q and
//    dv = sum w~_j g in fp32 over exactly the queries that hold it, in a
//    fixed order: no dot products, no shuffles, one writer per key.
//  - Dropout is a template flag of pass 1 only: the keep bit is the
//    forward's hash of (seed, query, slot) (na2d_common.cuh), drawn where
//    w~_j is formed; pass 2 reads w~_j.
// Measured share of the byte bound (chip_smoke.py, H100 80GB HBM3 at 700 W,
// PERF.md): in bf16 22% at the train path's 100 x 100 d2 site (0.193 ms,
// 8.5x the warp-per-pixel kernel before it), 10-19% at its smaller sites;
// 32-33% in fp32. The two passes take about half each.

#include <math.h>

#include "na2d_common.cuh"

namespace {

using namespace na2d;

template <typename T, int VEC, int KS, bool kDrop>
__global__ void __launch_bounds__(kMaxThreads) na2d_bwd_query_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dq,
    float* __restrict__ scratch, Strides sq, Strides sk, Strides sv,
    Strides sg, Geometry geo, Plan pl, float scale, Dropout drop) {
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
  // Two rows per query: logits, then weights, then dl_j; g . v_j, then r_j.
  float* wrow =
      reinterpret_cast<float*>(smem + 2 * halo_bytes) + me.slot * 2 * kk;
  float* rrow = wrow + kk;

  const int row0 = t.ch + geo.dil * halo.h0, col0 = t.cw + geo.dil * halo.w0;
  load_halo<T, VEC>(kh, k + t.b * sk.b + t.n * sk.n, sk.h, sk.w, row0, col0,
                    geo.dil, halo, nchunks, pl.pix);
  load_halo<T, VEC>(vh, v + t.b * sv.b + t.n * sv.n, sv.h, sv.w, row0, col0,
                    geo.dil, halo, nchunks, pl.pix);

  const int h = t.ch + geo.dil * me.ph, w = t.cw + geo.dil * me.pw;
  LaneVec<VEC> qr, gr;
  load_lane<T, VEC>(pl, me.lane, nchunks,
                    q + t.b * sq.b + h * sq.h + w * sq.w + t.n * sq.n, scale,
                    qr);
  load_lane<T, VEC>(pl, me.lane, nchunks,
                    g + t.b * sg.b + h * sg.h + w * sg.w + t.n * sg.n, 1.0f,
                    gr);
  uint32_t seed = 0;
  if (kDrop) seed = (uint32_t)(*drop.seed);
  cp_async_wait_all();
  __syncthreads();

  const int base = (coset_start(me.ph, t.clen_h, ks) - halo.h0) * halo.cols +
                   (coset_start(me.pw, t.clen_w, ks) - halo.w0);
  window_dots<true, KS, T, VEC>(pl, me.lane, nchunks, ks, qr, gr, kh, vh,
                                base, halo.cols, wrow, rrow);
  float m, inv;
  softmax_stats(wrow, kk, m, inv);
  __syncwarp();
  const long long query = ((t.b * geo.H + h) * geo.W + w) * geo.N + t.n;
  float* out_row = scratch + query * 2 * kk;  // ds_j, then w~_j
  for (int j = me.lane; j < kk; j += pl.group) {
    const float wj = expf(wrow[j] - m) * inv;
    float r = rrow[j], w_drop = wj;
    if (kDrop) {
      const bool keep = keep_bit(seed, query, j, drop.threshold);
      r = keep ? r * drop.inv_keep : 0.f;
      w_drop = keep ? wj * drop.inv_keep : 0.f;
    }
    wrow[j] = wj;
    rrow[j] = r;
    if (me.valid) out_row[kk + j] = w_drop;
  }
  __syncwarp();
  // Every lane forms the whole sum D, in the same order.
  float dot = 0.f;
  for (int j = 0; j < kk; ++j) dot += wrow[j] * rrow[j];
  __syncwarp();
  for (int j = me.lane; j < kk; j += pl.group) {
    const float dl = wrow[j] * (rrow[j] - dot);
    wrow[j] = dl;
    if (me.valid) out_row[j] = dl;
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
                        kh + (base + jh * halo.cols + jw) * pl.pix,
                        wrow[jh * ks + jw], acc);
  if (me.valid) store_lane<T, VEC>(pl, me.lane, nchunks, dq + query * geo.D,
                                   scale, acc);
}

template <typename T, int VEC, int KS>
__global__ void __launch_bounds__(kMaxThreads) na2d_bwd_key_kernel(
    const T* __restrict__ q, const T* __restrict__ g,
    const float* __restrict__ scratch, T* __restrict__ dk,
    T* __restrict__ dv, Strides sq, Strides sg, Geometry geo, Plan pl,
    float scale) {
  const int ks = KS > 0 ? KS : geo.ks;
  const int kk = ks * ks;
  const int nchunks = geo.D / VEC;
  Tile t;
  if (!block_tile(pl, geo, t)) return;  // the whole block leaves together
  const Pixel me = thread_pixel(pl, t);
  const Halo halo = query_halo(t, ks);

  unsigned char* smem = dynamic_smem();
  const int halo_bytes = (pl.cap * pl.pix * (int)sizeof(T) + 15) / 16 * 16;
  T* qh = reinterpret_cast<T*>(smem);
  T* gh = reinterpret_cast<T*>(smem + halo_bytes);
  float* rows = reinterpret_cast<float*>(smem + 2 * halo_bytes);

  const int row0 = t.ch + geo.dil * halo.h0, col0 = t.cw + geo.dil * halo.w0;
  load_halo<T, VEC>(qh, q + t.b * sq.b + t.n * sq.n, sq.h, sq.w, row0, col0,
                    geo.dil, halo, nchunks, pl.pix);
  load_halo<T, VEC>(gh, g + t.b * sg.b + t.n * sg.n, sg.h, sg.w, row0, col0,
                    geo.dil, halo, nchunks, pl.pix);
  // The halo queries' scratch rows (ds_j, w~_j), 2 * kk floats each.
  const int row_len = 2 * kk;
  const int total = halo.rows * halo.cols * row_len;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int e = idx % row_len;
    const int px = idx / row_len;
    const int qh_ = t.ch + geo.dil * (halo.h0 + px / halo.cols);
    const int qw_ = t.cw + geo.dil * (halo.w0 + px % halo.cols);
    const long long query = ((t.b * geo.H + qh_) * geo.W + qw_) * geo.N + t.n;
    rows[idx] = scratch[query * row_len + e];
  }
  cp_async_wait_all();
  __syncthreads();

  // The queries holding this key: rows [a_h, b_h], columns [a_w, b_w].
  const int a_h = first_query(me.ph, t.clen_h, ks);
  const int b_h = last_query(me.ph, t.clen_h, ks);
  const int a_w = first_query(me.pw, t.clen_w, ks);
  const int b_w = last_query(me.pw, t.clen_w, ks);
  LaneVec<VEC> dk_acc, dv_acc;
#pragma unroll
  for (int i = 0; i < LaneVec<VEC>::kChunks; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) dk_acc.x[i][e] = dv_acc.x[i][e] = 0.f;
  for (int ph = a_h; ph <= b_h; ++ph) {
    const int jh = me.ph - coset_start(ph, t.clen_h, ks);
    for (int pw = a_w; pw <= b_w; ++pw) {
      const int j = jh * ks + me.pw - coset_start(pw, t.clen_w, ks);
      const int px = (ph - halo.h0) * halo.cols + (pw - halo.w0);
      const float ds = rows[px * row_len + j];
      const float w_drop = rows[px * row_len + kk + j];
#pragma unroll
      for (int i = 0; i < LaneVec<VEC>::kChunks; ++i) {
        const int c = lane_chunk(pl, me.lane, i);
        if (i < pl.chunks_per_lane && c < nchunks) {
          float f[VEC];
          load_chunk<T, VEC>(qh + px * pl.pix + c * VEC, f);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dk_acc.x[i][e] += ds * (f[e] * scale);
          load_chunk<T, VEC>(gh + px * pl.pix + c * VEC, f);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dv_acc.x[i][e] += w_drop * f[e];
        }
      }
    }
  }
  if (me.valid) {
    const int h = t.ch + geo.dil * me.ph, w = t.cw + geo.dil * me.pw;
    const long long key = ((t.b * geo.H + h) * geo.W + w) * geo.N + t.n;
    store_lane<T, VEC>(pl, me.lane, nchunks, dk + key * geo.D, 1.0f, dk_acc);
    store_lane<T, VEC>(pl, me.lane, nchunks, dv + key * geo.D, 1.0f, dv_acc);
  }
}

template <typename T>
int set_smem(T* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int VEC, int KS, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* g,
           void* dq, void* dk, void* dv, float* scratch, const Strides* s,
           int B, const Geometry& geo, const Plan& p1, const Plan& p2,
           Dropout drop, cudaStream_t stream) {
  const int kk = geo.ks * geo.ks;
  const int threads1 = block_threads(p1), threads2 = block_threads(p2);
  const int halo1 = align16((long long)p1.cap * p1.pix * sizeof(T));
  const int halo2 = align16((long long)p2.cap * p2.pix * sizeof(T));
  if (2 * halo1 + threads1 / p1.group * 2 * kk * 4 != p1.smem ||
      2 * halo2 + p2.cap * 2 * kk * 4 != p2.smem ||
      threads1 > kMaxThreads || threads2 > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  // D^-0.5 rounded once from double, as in the forward.
  const float scale = (float)(1.0 / sqrt((double)geo.D));
  const T* qt = static_cast<const T*>(q);
  const T* gt = static_cast<const T*>(g);

  auto pass1 = na2d_bwd_query_kernel<T, VEC, KS, kDrop>;
  int code = set_smem(pass1, p1.smem);
  if (code != 0) return code;
  const dim3 grid1(p1.tiles_h * p1.tiles_w * geo.dil * geo.dil, geo.N, B);
  pass1<<<grid1, threads1, p1.smem, stream>>>(
      qt, static_cast<const T*>(k), static_cast<const T*>(v), gt,
      static_cast<T*>(dq), scratch, s[0], s[1], s[2], s[3], geo, p1, scale,
      drop);
  code = (int)cudaGetLastError();
  if (code != 0) return code;

  auto pass2 = na2d_bwd_key_kernel<T, VEC, KS>;
  code = set_smem(pass2, p2.smem);
  if (code != 0) return code;
  const dim3 grid2(p2.tiles_h * p2.tiles_w * geo.dil * geo.dil, geo.N, B);
  pass2<<<grid2, threads2, p2.smem, stream>>>(
      qt, gt, scratch, static_cast<T*>(dk), static_cast<T*>(dv), s[0], s[3],
      geo, p2, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool kDrop>
int launch_vec(int vec, const void* q, const void* k, const void* v,
               const void* g, void* dq, void* dk, void* dv, float* scratch,
               const Strides* s, int B, const Geometry& geo, const Plan& p1,
               const Plan& p2, Dropout drop, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec && geo.D % kVec == 0) {
    if (geo.ks == 3)
      return launch<T, kVec, 3, kDrop>(q, k, v, g, dq, dk, dv, scratch, s, B,
                                       geo, p1, p2, drop, stream);
    return launch<T, kVec, 0, kDrop>(q, k, v, g, dq, dk, dv, scratch, s, B,
                                     geo, p1, p2, drop, stream);
  }
  if (vec == 1) {
    if (geo.ks == 3)
      return launch<T, 1, 3, kDrop>(q, k, v, g, dq, dk, dv, scratch, s, B,
                                    geo, p1, p2, drop, stream);
    return launch<T, 1, 0, kDrop>(q, k, v, g, dq, dk, dv, scratch, s, B, geo,
                                  p1, p2, drop, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kDrop>
int dispatch(int dtype, int vec, const void* q, const void* k, const void* v,
             const void* g, void* dq, void* dk, void* dv, float* scratch,
             const long long* strides, int B, int H, int W, int N, int D,
             int ks, int dil, const int* plan_query, const int* plan_key,
             Dropout drop, void* stream) {
  if (ks < 1 || dil < 1 || D < 1 || plan_query == nullptr ||
      plan_key == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || N == 0) return 0;
  const Strides s[4] = {{strides[0], strides[1], strides[2], strides[3]},
                        {strides[4], strides[5], strides[6], strides[7]},
                        {strides[8], strides[9], strides[10], strides[11]},
                        {strides[12], strides[13], strides[14], strides[15]}};
  const Geometry geo{H, W, N, D, ks, dil};
  const Plan p1 = read_plan(plan_query), p2 = read_plan(plan_key);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_vec<float, kDrop>(vec, q, k, v, g, dq, dk, dv, scratch, s,
                                    B, geo, p1, p2, drop, st);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16, kDrop>(vec, q, k, v, g, dq, dk, dv,
                                            scratch, s, B, geo, p1, p2, drop,
                                            st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: as in na2d_fwd. strides: 16
// element strides, (b, h, w, head) for q, k, v, then g; the head_dim axis
// of each must be unit-stride. dq, dk and dv are contiguous (B, H, W, N, D)
// in the input type; scratch is fp32 of B * H * W * N * 2 * ks * ks floats.
// plan_query and plan_key: the TilePlan.args of the two passes. Returns a
// cudaError_t (0 = both passes launched).
extern "C" int na2d_bwd(int dtype, int vec, const void* q, const void* k,
                        const void* v, const void* g, void* dq, void* dk,
                        void* dv, float* scratch, const long long* strides,
                        int B, int H, int W, int N, int D, int ks, int dil,
                        const int* plan_query, const int* plan_key,
                        void* stream) {
  return dispatch<false>(dtype, vec, q, k, v, g, dq, dk, dv, scratch, strides,
                         B, H, W, N, D, ks, dil, plan_query, plan_key,
                         Dropout{nullptr, 0u, 1.0f}, stream);
}

// As na2d_bwd for na2d_fwd_drop's output, with the same seed pointer,
// threshold and 1 / (1 - p).
extern "C" int na2d_bwd_drop(int dtype, int vec, const void* q,
                             const void* k, const void* v, const void* g,
                             void* dq, void* dk, void* dv, float* scratch,
                             const long long* strides, int B, int H, int W,
                             int N, int D, int ks, int dil,
                             const int* plan_query, const int* plan_key,
                             const int* seed, unsigned int threshold,
                             float inv_keep, void* stream) {
  if (seed == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(dtype, vec, q, k, v, g, dq, dk, dv, scratch, strides,
                        B, H, W, N, D, ks, dil, plan_query, plan_key,
                        Dropout{seed, threshold, inv_keep}, stream);
}

extern "C" const char* na2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
