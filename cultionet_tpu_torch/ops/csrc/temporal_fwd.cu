// Per-pixel multi-head attention along the time axis, forward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cultionet_tpu/ops/temporal_pallas.py::_fwd_kernel.
// It computes the same math, not the TPU layout (no lane fold, group mask or
// row bands): for every pixel n, head h and query step t, a softmax in fp32
// over the S key steps of (q[n, t, h] . k[n, s, h]) * head_dim^-0.5, then the
// weighted sum of v[n, s, h], written once in the input type.
//
// Bound on the card: bytes. At the model's T = 12 and head_dim 16 the math
// is 4 * S * head_dim operations per (pixel, head, step), about 12 per byte
// that must move (q, k, v read once, out written once), far below what the
// tensor cores or even the fp32 units do per byte of HBM. But at the byte
// bound the card has only about 1,700 warp instructions of issue per pixel
// of the layer call, so the design reads every row from device memory once
// and keeps the instructions per pixel few:
//  - Tiles of whole pixels in shared memory. A block walks tiles of
//    `pixels` pixels (a persistent grid, as many blocks an SM as fit) and
//    copies each tile's q, k and v rows with 16-byte cp.async; for the layer
//    call the three views are thirds of one (N, T, 3C) projection, so a
//    tile is one contiguous range (`fused`). With two stages the next
//    tile's copy runs under this tile's math. The pooling query, broadcast
//    over the pixels (stride 0 along N), is copied once per block. Outputs
//    are staged in shared memory and leave as 16-byte stores of one
//    contiguous range.
//  - bf16, a layer call: one warp per (pixel, head) on the tensor cores
//    (mma.sync.m16n8k16, each operand one ldmatrix; the rows past T are
//    zeroed padding): S = Q K^T over chunks of 16 query and 16 key steps,
//    the softmax in base 2 in the fp32 accumulator fragment with quad
//    shuffles along a row, online over key chunks (T > 16), and P rounded to
//    bf16 and reused in registers as the A fragment of O += P V, as the TPU
//    kernel feeds bf16 weights to its MXU. Each logit is computed once.
//    head_dim that is not a multiple of 16 reads its fragments element by
//    element, the tail as zeros.
//  - bf16, the pooling call (one query row for every pixel, S <= 16, at
//    most 8 heads): one warp per pixel. The logits of all heads are one
//    product, K (16 key rows x C) times the block-diagonal query (C x 8,
//    its fragments built once per block); the softmax runs down each head's
//    column; O = P^T V comes from a 16 x 8 transpose of P in the warp's
//    scratch, each head keeping its own columns.
//  - fp32: one thread per (pixel, step, head) on the same shared-memory
//    tiles, an online softmax in one sweep over S, each logit computed once;
//    fp32 stays off the tensor cores (TF32 would not meet the fp32 gate).
// Inputs may be strided views as long as the channel axis is unit-stride;
// rows that are not 16-byte aligned are copied element by element.

#include "temporal_common.cuh"

namespace {

using namespace temporal;

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  Strides sq, sk, sv;
  long long N;
  int Tq, S, H, hd;
  float scale, scale2;  // head_dim^-0.5, and times log2(e)
  bool vec;
};

// out rows of one (pixel, head) on the tensor cores: base pointers at the
// head's first column of the staged q, k, v and out rows.
template <bool kFull, int MAXD>
__device__ __forceinline__ void attend_mma(const bf16* qb, int rsq,
                                           const bf16* kb, const bf16* vb,
                                           int rskv, bf16* ob, int rso,
                                           int Tq, int S, int hd,
                                           float scale2) {
  constexpr int KD = MAXD / 16, ND = MAXD / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  for (int q0 = 0; q0 < Tq; q0 += kChunk) {
    uint32_t qa[KD][4];
    load_a<kFull, KD>(qb + q0 * rsq, rsq, Tq - q0, hd, qa);
    float o[ND][4] = {};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < S; k0 += kChunk) {
      float s[2][4], mx[2], corr[2];
      dots16<kFull, KD>(qa, kb + k0 * rskv, rskv, S - k0, hd, s);
      mask_and_max(s, S - k0, scale2, mx);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - mn);
        m[r] = mn;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
          l[e >> 1] += s[nt][e];
        }
      }
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dn][e] *= corr[e >> 1];
      }
      uint32_t pa[4];
      c_to_a(s, pa);
      accumulate16<kFull, ND>(pa, vb + k0 * rskv, rskv, S - k0, hd, o);
    }
    const float inv[2] = {1.0f / quad_sum(l[0]), 1.0f / quad_sum(l[1])};
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + g + 8 * h;
        const int col = dn * 8 + 2 * c;
        if (row >= Tq) continue;
        const float x0 = o[dn][2 * h] * inv[h], x1 = o[dn][2 * h + 1] * inv[h];
        if constexpr (kFull) {
          *reinterpret_cast<uint32_t*>(ob + row * rso + col) =
              pack_bf16(x0, x1);
        } else {
          if (col < hd) ob[row * rso + col] = __float2bfloat16(x0);
          if (col + 1 < hd) ob[row * rso + col + 1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

// The pooling call on the tensor cores, one pixel per warp: the logits of
// every head at once as K (16 padded key rows x C) times the block-diagonal
// query (C x 8, column h = head h's query, fragments precomputed per block
// in qfrag), the softmax down each column, then O = P^T V through a 16 x 8
// scratch of the warp, of which each head keeps its own columns.
__device__ __forceinline__ void pool_mma(const uint2* qfrag, const bf16* kb,
                                         const bf16* vb, int rskv, bf16* ob,
                                         bf16* scr, int S, int H, int hd,
                                         int C, float scale2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  float L[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0, ks = 0; k0 < C; k0 += 16, ++ks) {
    uint32_t a[4];
    ldsm_a(a, kb + k0, rskv);
    const uint2 b = qfrag[ks * 32 + lane];
    mma_bf16(L, a, b.x, b.y);
  }
  // L[e]: key row g + 8 (e >> 1), head column 2c + (e & 1).
#pragma unroll
  for (int e = 0; e < 4; ++e)
    L[e] = g + 8 * (e >> 1) < S ? L[e] * scale2 : -INFINITY;
  float m[2], inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) m[j] = column_max(fmaxf(L[j], L[j + 2]));
#pragma unroll
  for (int e = 0; e < 4; ++e) L[e] = exp2f(L[e] - m[e & 1]);
#pragma unroll
  for (int j = 0; j < 2; ++j) inv[j] = 1.0f / column_sum(L[j] + L[j + 2]);
  *reinterpret_cast<uint32_t*>(scr + g * 8 + 2 * c) =
      pack_bf16(L[0] * inv[0], L[1] * inv[1]);
  *reinterpret_cast<uint32_t*>(scr + (g + 8) * 8 + 2 * c) =
      pack_bf16(L[2] * inv[0], L[3] * inv[1]);
  __syncwarp();
  uint32_t t[2];
  ldsm_x2_trans(t, scr + (lane & 15) * 8);
  __syncwarp();
  const uint32_t a[4] = {t[0], 0u, t[1], 0u};  // P^T: rows h, keys along k
  const int h0 = g * hd, h1 = g < H ? h0 + hd : h0;
  for (int d0 = 0; d0 < C; d0 += 16) {
    float o[2][4] = {};
    uint32_t b[4];
    ldsm_b(b, vb + d0, rskv);
    mma_bf16(o[0], a, b[0], b[1]);
    mma_bf16(o[1], a, b[2], b[3]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = d0 + nt * 8 + 2 * c + e;
        if (col >= h0 && col < h1) ob[col] = __float2bfloat16(o[nt][e]);
      }
    }
  }
}

// The out row of one (pixel, step, head) in one sweep over S.
template <typename T, int MAXD>
__device__ __forceinline__ void attend_simt(const T* qrow, const T* kb,
                                            const T* vb, int rskv, T* orow,
                                            int S, int hd, float scale) {
  float qs[MAXD], acc[MAXD];
  load_row<T, MAXD>(qrow, hd, scale, qs);
#pragma unroll
  for (int d = 0; d < MAXD; ++d) acc[d] = 0.f;
  float m = -INFINITY, den = 0.f;
  for (int s = 0; s < S; ++s) {
    const float l = dot_row<T, MAXD>(qs, kb + s * rskv, hd);
    if (l > m) {
      const float corr = expf(m - l);
      den *= corr;
#pragma unroll
      for (int d = 0; d < MAXD; ++d) acc[d] *= corr;
      m = l;
    }
    const float w = expf(l - m);
    den += w;
    const T* vr = vb + s * rskv;
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < hd) acc[d] = fmaf(w, to_float(vr[d]), acc[d]);
  }
  store_row<T, MAXD>(orow, hd, 1.0f / den, acc);
}

template <typename T, int MAXD, int kPath, bool kFull>
__global__ void __launch_bounds__(kThreads)
    temporal_fwd_kernel(const Args<T> a, const Plan pl) {
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
        continue;
      }
      if (!pl.q_bcast)
        zero_rows(st + pl.q_off, pl.pix_bytes, pl.pixels, pl.rs_q * kSize,
                  a.Tq, pl.tq_rows);
      zero_rows(st + pl.k_off, pl.pix_bytes, pl.pixels, pl.rs_kv * kSize,
                a.S, pl.s_rows);
      zero_rows(st + pl.v_off, pl.pix_bytes, pl.pixels, pl.rs_kv * kSize,
                a.S, pl.s_rows);
    }
    if (pl.q_bcast)
      zero_rows(smem, 0, 1, pl.rs_q * kSize, a.Tq, pl.tq_rows);
  }
  if constexpr (kPath == kPool) {
    // B fragments of the block-diagonal query, per 16-channel step and lane.
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
      return;
    }
    if (!pl.q_bcast)
      copy_in<T>(st + pl.q_off, pl.pix_bytes, pl.rs_q, a.q, a.sq, n0, np,
                 a.Tq, C, a.vec);
    copy_in<T>(st + pl.k_off, pl.pix_bytes, pl.rs_kv, a.k, a.sk, n0, np, a.S,
               C, a.vec);
    copy_in<T>(st + pl.v_off, pl.pix_bytes, pl.rs_kv, a.v, a.sv, n0, np, a.S,
               C, a.vec);
  };
  auto compute = [&](int tile, int stage) {
    long long n0;
    const int np = pixels_of(tile, n0);
    const unsigned char* st = stage_at(stage);
    auto q_of = [&](int p) {
      return reinterpret_cast<const T*>(
          pl.q_bcast ? smem : st + p * pl.pix_bytes + pl.q_off);
    };
    auto in_of = [&](int p, int off) {
      return reinterpret_cast<const T*>(st + p * pl.pix_bytes + off);
    };
    auto out_of = [&](int p) {
      return reinterpret_cast<T*>(smem + pl.out0 + p * pl.out_pix_bytes);
    };
    const int warp = threadIdx.x / 32;
    if constexpr (kPath == kPool) {
      bf16* scr = reinterpret_cast<bf16*>(smem + pl.scratch0 +
                                          warp * pl.scratch_warp);
      const uint2* qfrag = reinterpret_cast<const uint2*>(smem + pl.qfrag_off);
      for (int p = warp; p < np; p += kWarps)
        pool_mma(qfrag, in_of(p, pl.k_off), in_of(p, pl.v_off), pl.rs_kv,
                 out_of(p), scr, a.S, a.H, a.hd, C, a.scale2);
    } else if constexpr (kPath == kMma) {
      for (int item = warp; item < np * a.H; item += kWarps) {
        const int p = item / a.H, h = (item % a.H) * a.hd;
        attend_mma<kFull, MAXD>(q_of(p) + h, pl.rs_q, in_of(p, pl.k_off) + h,
                                in_of(p, pl.v_off) + h, pl.rs_kv,
                                out_of(p) + h, pl.rs_out, a.Tq, a.S, a.hd,
                                a.scale2);
      }
    } else {
      for (int item = threadIdx.x; item < np * a.Tq * a.H;
           item += blockDim.x) {
        const int h = (item % a.H) * a.hd;
        const int t = (item / a.H) % a.Tq;
        const int p = item / (a.H * a.Tq);
        attend_simt<T, MAXD>(q_of(p) + t * pl.rs_q + h,
                             in_of(p, pl.k_off) + h, in_of(p, pl.v_off) + h,
                             pl.rs_kv, out_of(p) + t * pl.rs_out + h, a.S,
                             a.hd, a.scale);
      }
    }
  };
  auto store = [&](int tile) {
    long long n0;
    const int np = pixels_of(tile, n0);
    copy_out<T, T>(a.out, smem + pl.out0, pl.out_pix_bytes, pl.rs_out, n0,
                   np, a.Tq, C, a.vec);
  };
  walk_tiles(pl, issue, compute, store);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const long long* strides, long long N, int Tq, int S, int H,
           int hd, bool vec, const int* plan, cudaStream_t stream) {
  const Plan pl = read_plan(plan);
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  if (!plan_fits(pl, N, Tq, S, kBf16)) return (int)cudaErrorInvalidValue;
  // head_dim^-0.5 rounded once from double, as the host frameworks round it.
  const float scale = (float)(1.0 / sqrt((double)hd));
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(out),
                  Strides{strides[0], strides[1]},
                  Strides{strides[2], strides[3]},
                  Strides{strides[4], strides[5]}, N, Tq, S, H, hd, scale,
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
    if (pl.pool) return run(temporal_fwd_kernel<T, 16, kPool, true>);
    if (!pl.mma) return (int)cudaErrorInvalidValue;
    return with_width<16, 32, 64, 128>(hd, [&](auto w) {
      constexpr int MAXD = decltype(w)::value;
      if (hd == MAXD) return run(temporal_fwd_kernel<T, MAXD, kMma, true>);
      return run(temporal_fwd_kernel<T, MAXD, kMma, false>);
    });
  } else {
    if (pl.mma || pl.pool) return (int)cudaErrorInvalidValue;
    return with_width<8, 16, 32, 64, 128>(hd, [&](auto w) {
      return run(temporal_fwd_kernel<T, decltype(w)::value, kSimt, false>);
    });
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is (N, Tq, H * hd), k and v
// (N, S, H * hd); strides: 6 element strides, (n, t) of q, then k, then v;
// the channel axis is unit-stride and out is contiguous (N, Tq, H * hd).
// vec != 0 promises 16-byte aligned rows (pointers, strides and H * hd
// multiples of 16 bytes). plan: the int fields of
// ops/temporal_cuda.py::TilePlan (temporal_common.cuh::Plan). head_dim <=
// 128. Returns a cudaError_t (0 = launched).
extern "C" int temporal_fwd(int dtype, const void* q, const void* k,
                            const void* v, void* out,
                            const long long* strides, long long N, int Tq,
                            int S, int H, int hd, int vec, const int* plan,
                            void* stream) {
  if (Tq < 1 || S < 1 || H < 1 || hd < 1 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, strides, N, Tq, S, H, hd, vec != 0,
                         plan, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, strides, N, Tq, S, H, hd, vec != 0,
                        plan, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* temporal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
