// Per-pixel multi-head attention along the time axis, backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cultionet_tpu/ops/temporal_pallas.py::_bwd_kernel:
// dq, dk and dv of temporal_fwd.cu at cotangent g, in one launch, with the
// softmax weights recomputed from (q, k, v) and nothing T x S-sized stored in
// device memory. With P the forward's weights and qs_t = q_t *
// head_dim^-0.5:
//   dP_ts = g_t . v_s,   delta_t = sum_s P_ts dP_ts,
//   dS_ts = P_ts (dP_ts - delta_t),
//   dq_t = head_dim^-0.5 sum_s dS_ts k_s,
//   dk_s = sum_t dS_ts qs_t,   dv_s = sum_t P_ts g_t,
// accumulated in fp32, each output written once in the input type.
//
// Bound on the card: bytes (q, k, v, g read once, dq, dk, dv written once;
// about 10 * S * head_dim operations per (pixel, head, step)). The design
// is temporal_fwd.cu's: a persistent grid over tiles of whole pixels whose
// q, k, v and g rows are copied once into shared memory with 16-byte
// cp.async (the next tile's under this tile's math), and whose outputs
// leave as 16-byte stores. Every pixel is independent, so each output
// element has one writer: no atomics, no scratch in device memory, and two
// launches give equal bits.
//  - bf16, a layer call: one warp per (pixel, head) on the tensor cores
//    (mma.sync.m16n8k16, ldmatrix operands), with the forward's fragment
//    code (temporal_common.cuh::dots16). For T <= 16 (the model's T = 12)
//    in one pass: S = Q K^T and dP = dO V^T, the softmax and delta = rowsum
//    (P dP) in the accumulator fragments, dS = P (dP - delta) rounded to
//    bf16 (as the TPU kernel feeds dlogit to its MXU), dq = scale dS K, and
//    P and dS transposed through a 16 x 16 scratch of the warp into the A
//    fragments of dv = P^T g and dk = scale dS^T q. For T > 16 a first sweep
//    over the key chunks keeps each query row's max, 1 / denominator and
//    delta in shared memory; then per chunk of 16 keys over the query
//    chunks, dq accumulated in fp32 staging rows only this warp touches.
//  - bf16, the pooling call (one query row, S <= 16, at most 8 heads): one
//    warp per pixel, as temporal_fwd.cu's pool_mma, plus dP from V times
//    the block-diagonal g row; dq = scale dS^T K on the tensor cores, dk and
//    dv elementwise and stored from registers as 16-byte chunks.
//  - fp32: SIMT on the same tiles. Phase 1, one thread per (pixel, query
//    step, head): the statistics, delta and dq in one online sweep over S.
//    Phase 2, one thread per (pixel, key step, head): dk and dv over the
//    query steps, each weight rebuilt from the same dot product and
//    statistics.

#include "temporal_common.cuh"

namespace {

using namespace temporal;

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const T* g;
  T* dq;
  T* dk;
  T* dv;
  Strides sq, sk, sv, sg;
  long long N;
  int Tq, S, H, hd;
  float scale, scale2;  // head_dim^-0.5, and times log2(e)
  bool vec;
};

// Staged rows of one (pixel, head): inputs and outputs at the head's first
// column, and its statistics (max, 1 / denominator, delta of query row t at
// stats + t * srs).
template <typename T>
struct Item {
  const T *q, *k, *v, *g;
  float* dq;
  T *dk, *dv;
  float* stats;
  int rsq, rskv, rsg, rsdq, rso, srs;
};

// Stores rows [r0, r0 + 16) (those below `rows`) of 16 x (8 ND) C
// fragments times `scale` at base (rs elements a row) in type D.
template <bool kFull, int ND, typename D>
__device__ __forceinline__ void store_frags(D* base, int rs, int r0, int rows,
                                            int hd, float scale,
                                            const float (&x)[ND][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      const int col = dn * 8 + 2 * c;
      if (row >= rows) continue;
      const float x0 = x[dn][2 * h] * scale, x1 = x[dn][2 * h + 1] * scale;
      D* p = base + row * rs + col;
      if constexpr (kFull && std::is_same<D, float>::value) {
        *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
      } else if constexpr (kFull) {
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(x0, x1);
      } else {
        if (col < hd) p[0] = from_float<D>(x0);
        if (col + 1 < hd) p[1] = from_float<D>(x1);
      }
    }
  }
}

// P^T and dS^T of one chunk as A fragments: P and dS (C fragments, rows t,
// columns s) rounded to bf16 into the warp's two 16 x 16 scratch blocks,
// then read back transposed.
__device__ __forceinline__ void transpose_pair(const float (&p)[2][4],
                                               const float (&ds)[2][4],
                                               bf16* scr, uint32_t (&pa)[4],
                                               uint32_t (&sa)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  bf16* sd = scr + kChunk * kScratchRow;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (g + 8 * h) * kScratchRow + nt * 8 + 2 * c;
      *reinterpret_cast<uint32_t*>(scr + at) =
          pack_bf16(p[nt][2 * h], p[nt][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(sd + at) =
          pack_bf16(ds[nt][2 * h], ds[nt][2 * h + 1]);
    }
  }
  __syncwarp();
  ldsm_at(pa, scr, kScratchRow);
  ldsm_at(sa, sd, kScratchRow);
  __syncwarp();
}

// One (pixel, head) with Tq <= 16 and S <= 16 (the model's T = 12): every
// product a single chunk, computed once.
template <bool kFull, int MAXD>
__device__ __forceinline__ void grads_mma_one(const Item<bf16>& it, bf16* scr,
                                              int Tq, int S, int hd,
                                              float scale, float scale2) {
  constexpr int KD = MAXD / 16, ND = MAXD / 8;
  uint32_t qa[KD][4], ga[KD][4];
  load_a<kFull, KD>(it.q, it.rsq, Tq, hd, qa);
  load_a<kFull, KD>(it.g, it.rsg, Tq, hd, ga);
  float p[2][4], dp[2][4], mx[2];
  dots16<kFull, KD>(qa, it.k, it.rskv, S, hd, p);
  dots16<kFull, KD>(ga, it.v, it.rskv, S, hd, dp);
  mask_and_max(p, S, scale2, mx);
  float l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[nt][e] = exp2f(p[nt][e] - mx[e >> 1]);
      l[e >> 1] += p[nt][e];
      dd[e >> 1] = fmaf(p[nt][e], dp[nt][e], dd[e >> 1]);
    }
  }
  // Rows past Tq have zero q and g rows: their dS is 0 and their P meets
  // zero g rows, so they add nothing.
  float ds[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.0f / quad_sum(l[r]);
    const float delta = quad_sum(dd[r]) * inv;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        p[nt][e] *= inv;
        ds[nt][e] = p[nt][e] * (dp[nt][e] - delta);
      }
    }
  }
  uint32_t dsa[4], pa[4], sa[4];
  c_to_a(ds, dsa);
  float dq[ND][4] = {};
  accumulate16<kFull, ND>(dsa, it.k, it.rskv, S, hd, dq);
  store_frags<kFull, ND>(it.dq, it.rsdq, 0, Tq, hd, scale, dq);
  transpose_pair(p, ds, scr, pa, sa);
  float dk[ND][4] = {}, dv[ND][4] = {};
  accumulate16<kFull, ND>(pa, it.g, it.rsg, Tq, hd, dv);
  accumulate16<kFull, ND>(sa, it.q, it.rsq, Tq, hd, dk);
  store_frags<kFull, ND>(it.dk, it.rso, 0, S, hd, scale, dk);
  store_frags<kFull, ND>(it.dv, it.rso, 0, S, hd, 1.f, dv);
}

// Any Tq and S: a sweep over the key chunks for each query row's
// statistics (kept in shared memory), then per key chunk over the query
// chunks, dq accumulated in its fp32 staging rows.
template <bool kFull, int MAXD>
__device__ __forceinline__ void grads_mma(const Item<bf16>& it, bf16* scr,
                                          int Tq, int S, int hd, float scale,
                                          float scale2) {
  constexpr int KD = MAXD / 16, ND = MAXD / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  for (int q0 = 0; q0 < Tq; q0 += kChunk) {
    uint32_t qa[KD][4], ga[KD][4];
    load_a<kFull, KD>(it.q + q0 * it.rsq, it.rsq, Tq - q0, hd, qa);
    load_a<kFull, KD>(it.g + q0 * it.rsg, it.rsg, Tq - q0, hd, ga);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < S; k0 += kChunk) {
      float s[2][4], dp[2][4], mx[2];
      dots16<kFull, KD>(qa, it.k + k0 * it.rskv, it.rskv, S - k0, hd, s);
      dots16<kFull, KD>(ga, it.v + k0 * it.rskv, it.rskv, S - k0, hd, dp);
      mask_and_max(s, S - k0, scale2, mx);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], mx[r]);
        const float corr = exp2f(m[r] - mn);
        m[r] = mn;
        l[r] *= corr;
        dd[r] *= corr;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[nt][e] - m[e >> 1]);
          l[e >> 1] += pe;
          dd[e >> 1] = fmaf(pe, dp[nt][e], dd[e >> 1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.0f / quad_sum(l[r]);
      const float delta = quad_sum(dd[r]) * inv;
      const int row = q0 + g + 8 * r;
      if (c == 0 && row < Tq) {
        float* st = it.stats + row * it.srs;
        st[0] = m[r];
        st[1] = inv;
        st[2] = delta;
      }
    }
  }
  __syncwarp();

  for (int k0 = 0; k0 < S; k0 += kChunk) {
    const int krows = S - k0;
    const bf16* kc = it.k + k0 * it.rskv;
    const bf16* vc = it.v + k0 * it.rskv;
    float dk[ND][4] = {}, dv[ND][4] = {};
    for (int q0 = 0; q0 < Tq; q0 += kChunk) {
      const int qrows = Tq - q0;
      uint32_t qa[KD][4], ga[KD][4];
      load_a<kFull, KD>(it.q + q0 * it.rsq, it.rsq, qrows, hd, qa);
      load_a<kFull, KD>(it.g + q0 * it.rsg, it.rsg, qrows, hd, ga);
      float p[2][4], dp[2][4], mx[2];
      dots16<kFull, KD>(qa, kc, it.rskv, krows, hd, p);
      dots16<kFull, KD>(ga, vc, it.rskv, krows, hd, dp);
      mask_and_max(p, krows, scale2, mx);
      // Rows past Tq: weight 0, so they add nothing to dk and dv.
      float rm[2], ri[2], rd[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + g + 8 * r;
        const float* st = it.stats + row * it.srs;
        rm[r] = row < Tq ? st[0] : 0.f;
        ri[r] = row < Tq ? st[1] : 0.f;
        rd[r] = row < Tq ? st[2] : 0.f;
      }
      float ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          p[nt][e] = exp2f(p[nt][e] - rm[r]) * ri[r];
          ds[nt][e] = p[nt][e] * (dp[nt][e] - rd[r]);
        }
      }
      // dq (+)= scale dS K, in this warp's fp32 accumulator rows.
      uint32_t dsa[4], pa[4], sa[4];
      c_to_a(ds, dsa);
      float dq[ND][4] = {};
      accumulate16<kFull, ND>(dsa, kc, it.rskv, krows, hd, dq);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + g + 8 * (e >> 1);
          const int col = dn * 8 + 2 * c + (e & 1);
          if (row < Tq && col < hd) {
            float* x = it.dq + row * it.rsdq + col;
            *x = (k0 == 0 ? 0.f : *x) + scale * dq[dn][e];
          }
        }
      }
      transpose_pair(p, ds, scr, pa, sa);
      accumulate16<kFull, ND>(pa, it.g + q0 * it.rsg, it.rsg, qrows, hd, dv);
      accumulate16<kFull, ND>(sa, it.q + q0 * it.rsq, it.rsq, qrows, hd, dk);
    }
    store_frags<kFull, ND>(it.dk, it.rso, k0, S, hd, scale, dk);
    store_frags<kFull, ND>(it.dv, it.rso, k0, S, hd, 1.f, dv);
  }
}

// The pooling call's gradients on the tensor cores, one pixel per warp (as
// temporal_fwd.cu::pool_mma): P from K times the block-diagonal query,
// dP = V times the block-diagonal g row, delta and dS down each head's
// column; dq = scale dS^T K (each head its own columns) on the tensor
// cores; dk_s = scale dS_s q and dv_s = P_s g elementwise, the lanes over
// (key row, 16-byte chunk), stored straight to the pixel's contiguous rows
// in device memory (dkb, dvb; rso elements a row). Scratch: dS^T in bf16
// (16 x 8), then P and dS in fp32 (16 x 8 each).
__device__ __forceinline__ void pool_grads_mma(
    const uint2* qfrag, const bf16* qrow, const bf16* kb, const bf16* vb,
    int rskv, const bf16* grow, float* dqrow, bf16* dkb, bf16* dvb, int rso,
    unsigned char* scr, int S, int H, int hd, int C, float scale,
    float scale2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int h0 = g * hd, h1 = g < H ? h0 + hd : h0;
  float L[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0, ks = 0; k0 < C; k0 += 16, ++ks) {
    uint32_t a[4];
    ldsm_a(a, kb + k0, rskv);
    const uint2 b = qfrag[ks * 32 + lane];
    mma_bf16(L, a, b.x, b.y);
    ldsm_a(a, vb + k0, rskv);
    auto g_at = [&](int kk) {
      return kk >= h0 && kk < h1 ? bits(grow[kk]) : 0u;
    };
    const int kk = k0 + 2 * c;
    mma_bf16(dp, a, g_at(kk) | g_at(kk + 1) << 16,
             g_at(kk + 8) | g_at(kk + 9) << 16);
  }
  float m[2], inv[2], delta[2], p[4], ds[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    L[e] = g + 8 * (e >> 1) < S ? L[e] * scale2 : -INFINITY;
#pragma unroll
  for (int j = 0; j < 2; ++j) m[j] = column_max(fmaxf(L[j], L[j + 2]));
#pragma unroll
  for (int e = 0; e < 4; ++e) p[e] = exp2f(L[e] - m[e & 1]);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    inv[j] = 1.0f / column_sum(p[j] + p[j + 2]);
    p[j] *= inv[j];
    p[j + 2] *= inv[j];
    delta[j] = column_sum(p[j] * dp[j] + p[j + 2] * dp[j + 2]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) ds[e] = p[e] * (dp[e] - delta[e & 1]);
  bf16* st = reinterpret_cast<bf16*>(scr);
  float* sp = reinterpret_cast<float*>(scr + 256);
  float* sds = sp + kChunk * 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int at = (g + 8 * h) * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(st + at) =
        pack_bf16(ds[2 * h], ds[2 * h + 1]);
    *reinterpret_cast<float2*>(sp + at) = make_float2(p[2 * h], p[2 * h + 1]);
    *reinterpret_cast<float2*>(sds + at) =
        make_float2(ds[2 * h], ds[2 * h + 1]);
  }
  __syncwarp();
  uint32_t t[2];
  ldsm_x2_trans(t, st + (lane & 15) * 8);
  const uint32_t a[4] = {t[0], 0u, t[1], 0u};  // dS^T: rows h, keys along k
  for (int d0 = 0; d0 < C; d0 += 16) {
    float o[2][4] = {};
    uint32_t b[4];
    ldsm_b(b, kb + d0, rskv);
    mma_bf16(o[0], a, b[0], b[1]);
    mma_bf16(o[1], a, b[2], b[3]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = d0 + nt * 8 + 2 * c + e;
        if (col >= h0 && col < h1) dqrow[col] = scale * o[nt][e];
      }
    }
  }
  // dk and dv: lanes over (key row, 8-channel chunk).
  const int chunks = C / 8;
  for (int i = lane; i < S * chunks; i += 32) {
    const int s = i / chunks, c0 = (i - s * chunks) * 8;
    float fk[8], fv[8];
    int h = c0 / hd, next = (h + 1) * hd;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (c0 + e == next) {
        ++h;
        next += hd;
      }
      fk[e] = scale * sds[s * 8 + h] * to_float(qrow[c0 + e]);
      fv[e] = sp[s * 8 + h] * to_float(grow[c0 + e]);
    }
    na2d::store_chunk<bf16, 8>(dkb + s * rso + c0, fk);
    na2d::store_chunk<bf16, 8>(dvb + s * rso + c0, fv);
  }
  __syncwarp();
}

// Phase 1 of the SIMT path for query step t (rows at t already): its
// statistics and dq in one online sweep over S.
template <typename T, int MAXD>
__device__ __forceinline__ void query_grads_simt(const Item<T>& it, int t,
                                                 int S, int hd, float scale) {
  float qs[MAXD], gr[MAXD], wdk[MAXD], wk[MAXD];
  load_row<T, MAXD>(it.q + t * it.rsq, hd, scale, qs);
  load_row<T, MAXD>(it.g + t * it.rsg, hd, 1.f, gr);
#pragma unroll
  for (int d = 0; d < MAXD; ++d) wdk[d] = wk[d] = 0.f;
  float m = -INFINITY, den = 0.f, dd = 0.f;
  for (int s = 0; s < S; ++s) {
    const T* kr = it.k + s * it.rskv;
    const float l = dot_row<T, MAXD>(qs, kr, hd);
    const float dw = dot_row<T, MAXD>(gr, it.v + s * it.rskv, hd);
    if (l > m) {
      const float corr = expf(m - l);
      den *= corr;
      dd *= corr;
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        wdk[d] *= corr;
        wk[d] *= corr;
      }
      m = l;
    }
    const float w = expf(l - m);
    den += w;
    dd = fmaf(w, dw, dd);
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < hd) {
        const float kd = to_float(kr[d]);
        wdk[d] = fmaf(w * dw, kd, wdk[d]);
        wk[d] = fmaf(w, kd, wk[d]);
      }
    }
  }
  const float inv = 1.0f / den;
  const float delta = dd * inv;
  float* dq = it.dq + t * it.rsdq;
#pragma unroll
  for (int d = 0; d < MAXD; ++d)
    if (d < hd) dq[d] = scale * inv * fmaf(-delta, wk[d], wdk[d]);
  float* st = it.stats + t * it.srs;
  st[0] = m;
  st[1] = inv;
  st[2] = delta;
}

// Phase 2 of the SIMT path for key step s: dk and dv over the query steps,
// each logit and g . v formed with phase 1's products in phase 1's order.
template <typename T, int MAXD>
__device__ __forceinline__ void key_grads_simt(const Item<T>& it, int s,
                                               int Tq, int hd, float scale) {
  float kr[MAXD], vr[MAXD], dk[MAXD], dv[MAXD];
  load_row<T, MAXD>(it.k + s * it.rskv, hd, 1.f, kr);
  load_row<T, MAXD>(it.v + s * it.rskv, hd, 1.f, vr);
#pragma unroll
  for (int d = 0; d < MAXD; ++d) dk[d] = dv[d] = 0.f;
  for (int t = 0; t < Tq; ++t) {
    const T* qrow = it.q + t * it.rsq;
    const T* grow = it.g + t * it.rsg;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < hd)
        acc[d % 4] = fmaf(to_float(qrow[d]) * scale, kr[d], acc[d % 4]);
    const float l = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    const float dw = dot_row<T, MAXD>(vr, grow, hd);
    const float* st = it.stats + t * it.srs;
    const float w = expf(l - st[0]) * st[1];
    const float dl = w * (dw - st[2]);
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < hd) {
        dv[d] = fmaf(w, to_float(grow[d]), dv[d]);
        dk[d] = fmaf(dl, to_float(qrow[d]) * scale, dk[d]);
      }
    }
  }
  store_row<T, MAXD>(it.dk + s * it.rso, hd, 1.f, dk);
  store_row<T, MAXD>(it.dv + s * it.rso, hd, 1.f, dv);
}

template <typename T, int MAXD, int kPath, bool kFull>
__global__ void __launch_bounds__(kThreads)
    temporal_bwd_kernel(const Args<T> a, const Plan pl) {
  unsigned char* smem = smem_base();
  const int C = a.H * a.hd;
  constexpr int kSize = sizeof(T);
  if (pl.q_bcast)
    copy_in<T>(smem, 0, pl.rs_q, a.q, a.sq, 0, 1, a.Tq, C, a.vec);
  if constexpr (kPath != kSimt) {
    for (int stage = 0; stage < pl.stages; ++stage) {
      unsigned char* st = smem + pl.stage0 + stage * pl.stage_bytes;
      if (pl.fused) {
        zero_rows(st, pl.pix_bytes, pl.pixels, pl.rs_kv * kSize, a.S,
                  pl.s_rows);
      } else {
        if (!pl.q_bcast)
          zero_rows(st + pl.q_off, pl.pix_bytes, pl.pixels, pl.rs_q * kSize,
                    a.Tq, pl.tq_rows);
        zero_rows(st + pl.k_off, pl.pix_bytes, pl.pixels, pl.rs_kv * kSize,
                  a.S, pl.s_rows);
        zero_rows(st + pl.v_off, pl.pix_bytes, pl.pixels, pl.rs_kv * kSize,
                  a.S, pl.s_rows);
      }
      zero_rows(st + pl.g_off, pl.pix_bytes, pl.pixels, pl.rs_g * kSize,
                a.Tq, pl.tq_rows);
    }
    if (pl.q_bcast)
      zero_rows(smem, 0, 1, pl.rs_q * kSize, a.Tq, pl.tq_rows);
  }
  if constexpr (kPath == kPool) {
    uint2* qfrag = reinterpret_cast<uint2*>(smem + pl.qfrag_off);
    for (int i = threadIdx.x; i < C / 16 * 32; i += blockDim.x) {
      const int l = i % 32, g = l >> 2, k0 = i / 32 * 16 + 2 * (l & 3);
      auto q_at = [&](int kk) {
        const bool own = g < a.H && kk >= g * a.hd && kk < (g + 1) * a.hd;
        return own ? to_float(a.q[kk]) : 0.f;
      };
      qfrag[i] = make_uint2(pack_bf16(q_at(k0), q_at(k0 + 1)),
                            pack_bf16(q_at(k0 + 8), q_at(k0 + 9)));
    }
  }
  auto pixels_of = [&](int tile, long long& n0) {
    n0 = (long long)tile * pl.pixels;
    return (int)min((long long)pl.pixels, a.N - n0);
  };
  auto stage_at = [&](int stage) {
    return smem + pl.stage0 + stage * pl.stage_bytes;
  };
  auto issue = [&](int tile, int stage) {
    long long n0;
    const int np = pixels_of(tile, n0);
    unsigned char* st = stage_at(stage);
    if (pl.fused) {
      copy_in<T>(st, pl.pix_bytes, pl.rs_kv, a.q, a.sq, n0, np, a.S, 3 * C,
                 a.vec);
    } else {
      if (!pl.q_bcast)
        copy_in<T>(st + pl.q_off, pl.pix_bytes, pl.rs_q, a.q, a.sq, n0, np,
                   a.Tq, C, a.vec);
      copy_in<T>(st + pl.k_off, pl.pix_bytes, pl.rs_kv, a.k, a.sk, n0, np,
                 a.S, C, a.vec);
      copy_in<T>(st + pl.v_off, pl.pix_bytes, pl.rs_kv, a.v, a.sv, n0, np,
                 a.S, C, a.vec);
    }
    copy_in<T>(st + pl.g_off, pl.pix_bytes, pl.rs_g, a.g, a.sg, n0, np, a.Tq,
               C, a.vec);
  };
  auto compute = [&](int tile, int stage) {
    long long n0;
    const int np = pixels_of(tile, n0);
    const unsigned char* st = stage_at(stage);
    auto item_of = [&](int p, int h) {
      const unsigned char* in = st + p * pl.pix_bytes;
      unsigned char* out = smem + pl.out0 + p * pl.out_pix_bytes;
      const int col = h * a.hd;
      Item<T> it;
      it.q = reinterpret_cast<const T*>(pl.q_bcast ? smem : in + pl.q_off) +
             col;
      it.k = reinterpret_cast<const T*>(in + pl.k_off) + col;
      it.v = reinterpret_cast<const T*>(in + pl.v_off) + col;
      it.g = reinterpret_cast<const T*>(in + pl.g_off) + col;
      it.dq = reinterpret_cast<float*>(out) + col;
      it.dk = reinterpret_cast<T*>(out + pl.dk_off) + col;
      it.dv = reinterpret_cast<T*>(out + pl.dv_off) + col;
      it.stats = reinterpret_cast<float*>(out + pl.stats_off) + 3 * h;
      it.rsq = pl.rs_q;
      it.rskv = pl.rs_kv;
      it.rsg = pl.rs_g;
      it.rsdq = pl.rs_dq;
      it.rso = pl.rs_out;
      it.srs = 3 * a.H;
      return it;
    };
    const int warp = threadIdx.x / 32;
    unsigned char* scr = smem + pl.scratch0 + warp * pl.scratch_warp;
    if constexpr (kPath == kPool) {
      const uint2* qfrag = reinterpret_cast<const uint2*>(smem + pl.qfrag_off);
      for (int p = warp; p < np; p += kWarps) {
        const Item<T> it = item_of(p, 0);
        const long long rows = (n0 + p) * a.S * C;  // dk, dv straight out
        pool_grads_mma(qfrag, it.q, it.k, it.v, pl.rs_kv, it.g, it.dq,
                       a.dk + rows, a.dv + rows, C, scr, a.S, a.H, a.hd, C,
                       a.scale, a.scale2);
      }
    } else if constexpr (kPath == kMma) {
      const bool one = a.Tq <= kChunk && a.S <= kChunk;
      for (int item = warp; item < np * a.H; item += kWarps) {
        const Item<T> it = item_of(item / a.H, item % a.H);
        if (one)
          grads_mma_one<kFull, MAXD>(it, reinterpret_cast<bf16*>(scr), a.Tq,
                                     a.S, a.hd, a.scale, a.scale2);
        else
          grads_mma<kFull, MAXD>(it, reinterpret_cast<bf16*>(scr), a.Tq, a.S,
                                 a.hd, a.scale, a.scale2);
      }
    } else {
      for (int item = threadIdx.x; item < np * a.Tq * a.H;
           item += blockDim.x) {
        const int t = (item / a.H) % a.Tq;
        query_grads_simt<T, MAXD>(item_of(item / (a.H * a.Tq), item % a.H),
                                  t, a.S, a.hd, a.scale);
      }
      __syncthreads();
      for (int item = threadIdx.x; item < np * a.S * a.H;
           item += blockDim.x) {
        const int s = (item / a.H) % a.S;
        key_grads_simt<T, MAXD>(item_of(item / (a.H * a.S), item % a.H), s,
                                a.Tq, a.hd, a.scale);
      }
    }
  };
  auto store = [&](int tile) {
    long long n0;
    const int np = pixels_of(tile, n0);
    const unsigned char* out = smem + pl.out0;
    copy_out<T, float>(a.dq, out, pl.out_pix_bytes, pl.rs_dq, n0, np, a.Tq,
                       C, a.vec);
    if constexpr (kPath != kPool) {
      copy_out<T, T>(a.dk, out + pl.dk_off, pl.out_pix_bytes, pl.rs_out, n0,
                     np, a.S, C, a.vec);
      copy_out<T, T>(a.dv, out + pl.dv_off, pl.out_pix_bytes, pl.rs_out, n0,
                     np, a.S, C, a.vec);
    }
  };
  walk_tiles(pl, issue, compute, store);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g,
           void* dq, void* dk, void* dv, const long long* strides,
           long long N, int Tq, int S, int H, int hd, bool vec,
           const int* plan, cudaStream_t stream) {
  const Plan pl = read_plan(plan);
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  if (!plan_fits(pl, N, Tq, S, kBf16)) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)hd));
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(g),
                  static_cast<T*>(dq), static_cast<T*>(dk),
                  static_cast<T*>(dv), Strides{strides[0], strides[1]},
                  Strides{strides[2], strides[3]},
                  Strides{strides[4], strides[5]},
                  Strides{strides[6], strides[7]}, N, Tq, S, H, hd, scale,
                  scale * kLog2e, vec};
  auto run = [&](auto kernel) {
    if (pl.smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<pl.grid, kThreads, pl.smem, stream>>>(a, pl);
    return (int)cudaGetLastError();
  };
  if constexpr (kBf16) {
    if (pl.pool) return run(temporal_bwd_kernel<T, 16, kPool, true>);
    if (!pl.mma) return (int)cudaErrorInvalidValue;
    return with_width<16, 32, 64, 128>(hd, [&](auto w) {
      constexpr int MAXD = decltype(w)::value;
      if (hd == MAXD) return run(temporal_bwd_kernel<T, MAXD, kMma, true>);
      return run(temporal_bwd_kernel<T, MAXD, kMma, false>);
    });
  } else {
    if (pl.mma || pl.pool) return (int)cudaErrorInvalidValue;
    return with_width<8, 16, 32, 64, 128>(hd, [&](auto w) {
      return run(temporal_bwd_kernel<T, decltype(w)::value, kSimt, false>);
    });
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q and g are (N, Tq, H * hd), k and v
// (N, S, H * hd); strides: 8 element strides, (n, t) of q, k, v, then g; the
// channel axis is unit-stride. dq, dk, dv are contiguous, shaped like q, k,
// v (dq is (N, Tq, H * hd) also where q is broadcast along N). vec != 0
// promises 16-byte aligned rows. plan: the int fields of
// ops/temporal_cuda.py::TilePlan. head_dim <= 128. Returns a cudaError_t
// (0 = launched).
extern "C" int temporal_bwd(int dtype, const void* q, const void* k,
                            const void* v, const void* g, void* dq, void* dk,
                            void* dv, const long long* strides, long long N,
                            int Tq, int S, int H, int hd, int vec,
                            const int* plan, void* stream) {
  if (Tq < 1 || S < 1 || H < 1 || hd < 1 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, g, dq, dk, dv, strides, N, Tq, S, H, hd,
                         vec != 0, plan, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, strides, N, Tq, S, H, hd,
                        vec != 0, plan, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* temporal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
