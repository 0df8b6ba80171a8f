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
// Bound on the card: bytes. Reads q, k, v and g once and writes dq, dk and
// dv once (7 tensors of B*H*W*heads*D); the arithmetic is about 10*k*k*D
// operations per query-head, far below the fp32 rate per byte. Like the
// forward, this first version is latency-bound on warp-shuffle reductions.
//
// Design (first, simple version): two passes, no atomics, deterministic.
//  - Pass 1, query-centric, one warp per (b, h, w, head) query as in the
//    forward: recompute the k*k logits with the forward's code and order of
//    summation, so the weights are the forward's bit for bit; form g . v_j
//    in the same loop; write dq, and the query's softmax max, 1 / denom and
//    D to a small fp32 scratch (3 floats per query-head).
//  - Pass 2, key-centric, one warp per (b, h, w, head) key: the queries
//    whose clamped window holds the key lie in the key's coset, within
//    k - 1 coset steps along each axis (at most (2k - 1)^2 candidates); a
//    candidate is kept when its window_start puts the key inside its
//    window, at slot (jh, jw). For each kept query the warp recomputes the
//    logit and g . v, rebuilds w_j from the stored max and 1 / denom
//    exactly as pass 1 did, redraws the keep bit of (query, slot), and
//    accumulates dk and dv for the key in fp32. Each key's sums have one
//    writer, so no atomics are needed and the result does not change from
//    run to run.
//  - Dropout is a template flag: the keep bit is the forward's hash of
//    (seed, query, slot) (na2d_common.cuh), independent of either grid.

#include <math.h>

#include "na2d_common.cuh"

namespace {

using namespace na2d;

template <typename T, bool kDrop>
__global__ void na2d_bwd_query_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dq,
    float* __restrict__ stats, Strides sq, Strides sk, Strides sv,
    Strides sg, int H, int W, int N, int D, int ks, int dil, float scale,
    long long total, Dropout drop) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int kk = ks * ks;
  float* qs = smem + warp * (2 * D + 3 * kk);
  float* gs = qs + D;
  float* logits = gs + D;
  float* gv = logits + kk;
  float* dl = gv + kk;

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
  const T* gp = g + b * sg.b + h * sg.h + w * sg.w + n * sg.n;
  for (int c = lane; c < D; c += kWarp) {
    qs[c] = to_float(qp[c]) * scale;
    gs[c] = to_float(gp[c]);
  }
  __syncwarp();

  const int h0 = window_start(h, H, ks, dil);
  const int w0 = window_start(w, W, ks, dil);
  const T* kb = k + b * sk.b + n * sk.n;
  const T* vb = v + b * sv.b + n * sv.n;

  for (int jh = 0; jh < ks; ++jh) {
    const long long hh = h0 + dil * jh;
    for (int jw = 0; jw < ks; ++jw) {
      const long long ww = w0 + dil * jw;
      const T* kp = kb + hh * sk.h + ww * sk.w;
      const T* vp = vb + hh * sv.h + ww * sv.w;
      float part_l = 0.f, part_g = 0.f;
      for (int c = lane; c < D; c += kWarp) {
        part_l += qs[c] * to_float(kp[c]);
        part_g += gs[c] * to_float(vp[c]);
      }
      part_l = warp_sum(part_l);
      part_g = warp_sum(part_g);
      if (lane == 0) {
        logits[jh * ks + jw] = part_l;
        gv[jh * ks + jw] = part_g;
      }
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

  // Every lane forms the whole sum D (same values, same order), then the
  // lanes split the k*k terms dl_j between them.
  float dot = 0.f;
  for (int j = 0; j < kk; ++j) {
    float r = gv[j];
    if (kDrop)
      r = keep_bit(seed, query, j, drop.threshold) ? r * drop.inv_keep : 0.f;
    dot += (expf(logits[j] - m) * inv) * r;
  }
  for (int j = lane; j < kk; j += kWarp) {
    const float wj = expf(logits[j] - m) * inv;
    float r = gv[j];
    if (kDrop)
      r = keep_bit(seed, query, j, drop.threshold) ? r * drop.inv_keep : 0.f;
    dl[j] = wj * (r - dot);
  }
  __syncwarp();

  T* dqp = dq + query * D;
  for (int c = lane; c < D; c += kWarp) {
    float acc = 0.f;
    for (int jh = 0; jh < ks; ++jh) {
      const T* krow = kb + (long long)(h0 + dil * jh) * sk.h + c;
      for (int jw = 0; jw < ks; ++jw)
        acc += dl[jh * ks + jw] * to_float(krow[(long long)(w0 + dil * jw) * sk.w]);
    }
    dqp[c] = from_float<T>(acc * scale);
  }
  if (lane == 0) {
    stats[3 * query] = m;
    stats[3 * query + 1] = inv;
    stats[3 * query + 2] = dot;
  }
}

// Range of coset positions p whose clamped window (along one axis) may hold
// coset position `pk`: windows span k positions, so |p - pk| < k.
__device__ __forceinline__ void candidate_range(int pk, int coset_len, int ks,
                                                int* lo, int* hi) {
  *lo = max(0, pk - (ks - 1));
  *hi = min(coset_len - 1, pk + (ks - 1));
}

template <typename T, bool kDrop>
__global__ void na2d_bwd_key_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv,
    Strides sq, Strides sk, Strides sv, Strides sg, int H, int W, int N,
    int D, int ks, int dil, float scale, long long total, Dropout drop) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  // Each lane reads and writes only its own channels c = lane + 32 i, so
  // the rows need no warp synchronisation.
  float* kr = smem + warp * 4 * D;
  float* vr = kr + D;
  float* dk_acc = vr + D;
  float* dv_acc = dk_acc + D;

  const long long key = (long long)blockIdx.x * warps + warp;
  if (key >= total) return;  // the whole warp leaves together
  long long t = key;
  const int n = (int)(t % N);
  t /= N;
  const int kw = (int)(t % W);
  t /= W;
  const int kh = (int)(t % H);
  const long long b = t / H;

  const T* kp = k + b * sk.b + kh * sk.h + kw * sk.w + n * sk.n;
  const T* vp = v + b * sv.b + kh * sv.h + kw * sv.w + n * sv.n;
  for (int c = lane; c < D; c += kWarp) {
    kr[c] = to_float(kp[c]);
    vr[c] = to_float(vp[c]);
    dk_acc[c] = 0.f;
    dv_acc[c] = 0.f;
  }
  uint32_t seed = 0;
  if (kDrop) seed = (uint32_t)(*drop.seed);

  const int coset_h = kh % dil, coset_w = kw % dil;
  int lo_h, hi_h, lo_w, hi_w;
  candidate_range(kh / dil, (H - coset_h + dil - 1) / dil, ks, &lo_h, &hi_h);
  candidate_range(kw / dil, (W - coset_w + dil - 1) / dil, ks, &lo_w, &hi_w);

  for (int ph = lo_h; ph <= hi_h; ++ph) {
    const int qh = coset_h + dil * ph;
    const int sh = window_start(qh, H, ks, dil);
    if (kh < sh || (kh - sh) / dil >= ks) continue;
    const int jh = (kh - sh) / dil;
    for (int pw = lo_w; pw <= hi_w; ++pw) {
      const int qw = coset_w + dil * pw;
      const int sw = window_start(qw, W, ks, dil);
      if (kw < sw || (kw - sw) / dil >= ks) continue;
      const int j = jh * ks + (kw - sw) / dil;

      const long long query = ((b * H + qh) * W + qw) * N + n;
      const T* qp = q + b * sq.b + qh * sq.h + qw * sq.w + n * sq.n;
      const T* gp = g + b * sg.b + qh * sg.h + qw * sg.w + n * sg.n;
      // The logit and g . v_key as pass 1 and the forward form them.
      float part_l = 0.f, part_g = 0.f;
      for (int c = lane; c < D; c += kWarp) {
        part_l += (to_float(qp[c]) * scale) * kr[c];
        part_g += to_float(gp[c]) * vr[c];
      }
      part_l = warp_sum(part_l);
      part_g = warp_sum(part_g);

      const float* st = stats + 3 * query;
      const float wj = expf(part_l - st[0]) * st[1];
      float r = part_g, w_drop = wj;
      if (kDrop) {
        const bool keep = keep_bit(seed, query, j, drop.threshold);
        r = keep ? part_g * drop.inv_keep : 0.f;
        w_drop = keep ? wj * drop.inv_keep : 0.f;
      }
      const float ds = wj * (r - st[2]);
      for (int c = lane; c < D; c += kWarp) {
        dk_acc[c] += ds * (to_float(qp[c]) * scale);
        dv_acc[c] += w_drop * to_float(gp[c]);
      }
    }
  }

  T* dkp = dk + key * D;
  T* dvp = dv + key * D;
  for (int c = lane; c < D; c += kWarp) {
    dkp[c] = from_float<T>(dk_acc[c]);
    dvp[c] = from_float<T>(dv_acc[c]);
  }
}

int warps_for(int row_bytes) {
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && warps * row_bytes > kStaticSmemLimit) warps /= 2;
  return warps * row_bytes > kStaticSmemLimit ? 0 : warps;
}

template <typename T, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* g,
           void* dq, void* dk, void* dv, float* stats,
           const long long* strides, int B, int H, int W, int N, int D,
           int ks, int dil, Dropout drop, cudaStream_t stream) {
  const long long total = (long long)B * H * W * N;
  const Strides sq{strides[0], strides[1], strides[2], strides[3]};
  const Strides sk{strides[4], strides[5], strides[6], strides[7]};
  const Strides sv{strides[8], strides[9], strides[10], strides[11]};
  const Strides sg{strides[12], strides[13], strides[14], strides[15]};
  // D^-0.5 rounded once from double, as in the forward.
  const float scale = (float)(1.0 / sqrt((double)D));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);

  const int row1 = (2 * D + 3 * ks * ks) * (int)sizeof(float);
  const int warps1 = warps_for(row1);
  if (warps1 == 0) return (int)cudaErrorInvalidValue;
  na2d_bwd_query_kernel<T, kDrop>
      <<<(unsigned)((total + warps1 - 1) / warps1), warps1 * kWarp,
         warps1 * row1, stream>>>(qt, kt, vt, gt, static_cast<T*>(dq), stats,
                                  sq, sk, sv, sg, H, W, N, D, ks, dil, scale,
                                  total, drop);
  int code = (int)cudaGetLastError();
  if (code != 0) return code;

  const int row2 = 4 * D * (int)sizeof(float);
  const int warps2 = warps_for(row2);
  if (warps2 == 0) return (int)cudaErrorInvalidValue;
  na2d_bwd_key_kernel<T, kDrop>
      <<<(unsigned)((total + warps2 - 1) / warps2), warps2 * kWarp,
         warps2 * row2, stream>>>(qt, kt, vt, gt, stats, static_cast<T*>(dk),
                                  static_cast<T*>(dv), sq, sk, sv, sg, H, W, N,
                                  D, ks, dil, scale, total, drop);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* g, void* dq, void* dk, void* dv, float* stats,
             const long long* strides, int B, int H, int W, int N, int D,
             int ks, int dil, Dropout drop, void* stream) {
  if (ks < 1 || dil < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kDrop>(q, k, v, g, dq, dk, dv, stats, strides, B, H,
                                W, N, D, ks, dil, drop, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kDrop>(q, k, v, g, dq, dk, dv, stats,
                                        strides, B, H, W, N, D, ks, dil, drop,
                                        s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 16 element strides, (b, h, w,
// head) for q, k, v, then g; the head_dim axis of each must be unit-stride.
// dq, dk and dv are contiguous (B, H, W, N, D) in the input type; stats is
// fp32 scratch of 3 * B * H * W * N floats. Returns a cudaError_t (0 = both
// passes launched).
extern "C" int na2d_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* g, void* dq, void* dk,
                        void* dv, float* stats, const long long* strides,
                        int B, int H, int W, int N, int D, int ks, int dil,
                        void* stream) {
  return dispatch<false>(dtype, q, k, v, g, dq, dk, dv, stats, strides, B, H,
                         W, N, D, ks, dil, Dropout{nullptr, 0u, 1.0f},
                         stream);
}

// As na2d_bwd for na2d_fwd_drop's output, with the same seed pointer,
// threshold and 1 / (1 - p).
extern "C" int na2d_bwd_drop(int dtype, const void* q, const void* k,
                             const void* v, const void* g, void* dq,
                             void* dk, void* dv, float* stats,
                             const long long* strides, int B, int H, int W,
                             int N, int D, int ks, int dil, const int* seed,
                             unsigned int threshold, float inv_keep,
                             void* stream) {
  if (seed == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(dtype, q, k, v, g, dq, dk, dv, stats, strides, B, H,
                        W, N, D, ks, dil, Dropout{seed, threshold, inv_keep},
                        stream);
}

extern "C" const char* na2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
