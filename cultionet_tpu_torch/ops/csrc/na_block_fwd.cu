// Fused LayerNorm -> QKV -> neighborhood attention -> projection ->
// LayerNorm block, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel cultionet_tpu/ops/natten_pallas.py::
// _na_block_kernel (called from _na_block_pallas_d1). It computes the same
// math (ops/na_block.py::na_block_plain is its plain version), not the TPU
// layout: no head-channel interleave, no 32-pixel padding, no pltpu.roll
// border selects, no one-program-per-image grid (so no size ceiling).
//   1. LN1 in fp32 (eps 1e-6, biased variance), rounded to bf16;
//   2. qkv = bf16(ln) . bf16(w_qkv), fp32 accumulate, + b_qkv; q scaled by
//      head_dim^-0.5; q, k, v kept in fp32;
//   3. logit = fp32 sum over the head's channels of bf16(q_d * k_d): the
//      TPU rounds each product to bf16 before its head-mask matmul, so this
//      kernel does too;
//   4. clamped NATTEN windows, dilated within each coset (exact for any
//      size; equal to the TPU's coset reshape where H, W % d == 0); softmax
//      in fp32 as exp(l - max) * (1 / sum); attn = sum of w * v in fp32;
//   5. proj = bf16(attn) . bf16(w_proj), fp32 accumulate, + b_proj;
//   6. LN2 in fp32, written in x's type.
//
// What bounds it. Operations: the two products, 2 N C 4C at the bf16
// tensor-core rate, with the attention's 4 N C k^2 at the fp32 rate,
// outweigh x read and out written (chip_smoke.py::na_block_bound_ms) at the
// model's C = 256. Three things keep a fused block far from that bound,
// and the design below avoids each: q, k and v in an fp32 device-memory
// scratch (12 C bytes a pixel written and read back), weights read from L2
// by every warp, and an attention over pixel strips whose windows reach
// other blocks' pixels.
//
// Design: one launch, nothing but x and out in device memory. A block of
// 16 warps owns a th x tw tile of positions of one (batch, dilation coset)
// (ops/na_block_cuda.py::_tile_plan picks it; 8 x 8 at C = 256). Its key
// rectangle, the tile plus the clamped (k - 1) halo shifted inward at the
// borders (na2d_common.cuh::key_halo), is the block's working set:
//  (a) x of the rectangle comes in with 16-byte cp.async; LN1 by a warp per
//      pixel writes a bf16 rectangle to shared memory;
//  (b) per pass (a group of heads, up to 64 padded channels): the
//      rectangle times the pass's w_qkv columns on the tensor cores
//      (mma.sync m16n8k16 bf16, fp32 accumulators, ldmatrix operands), the
//      weights streamed in 32-row chunks through a three-stage ring of bulk
//      copies (one thread issues each; mbarriers count the bytes in and the
//      warps done with a stage, so no block-wide barrier waits on a copy);
//      the epilogue adds the bias and keeps k and v for the rectangle and q
//      for the tile in fp32 in shared memory (the halo's k and v are
//      recomputed by each block that needs them: ~1.6x the k/v product at
//      8 x 8, far cheaper than a round trip through device memory);
//  (c) the attention: `lanes` lanes per (query, head), each holding 1, 2 or
//      4 16-byte chunks of the head; logits close with a butterfly over the
//      lanes; the weighted sum of v reads the fp32 rectangle; the result,
//      rounded to bf16, goes to the tile's attention rows;
//  (d) the attention rows times w_proj through the same ring, into an fp32
//      tile over the dead LN1 / k / v / q memory; + b_proj, LN2 by a warp
//      per pixel and 16-byte stores.
// The products' warp tiles are compile-time (2 x 8 warps, MT m16 blocks by
// NT n8 tiles each): no branch sits between the ldmatrix and mma
// instructions, so they issue back to back (a tile sized at run time makes
// the compiler fence each mma with a branch and a warp sync). Rows and
// columns past the valid ones read allocated shared memory and their
// results are dropped.
// Heads and channels are padded to multiples of 16 by the wrapper, which
// lays the weights out per pass (prepare_weights) with zero padding; the
// kernel zero-fills the padded channels of LN1's rows, so padding adds
// nothing to any kept sum.

#include <math.h>

#include "temporal_common.cuh"

namespace {

using na2d::coset_len;
using na2d::coset_start;
using na2d::cp_async16;
using na2d::dynamic_smem;
using na2d::from_float;
using na2d::group_sum;
using na2d::kWarp;
using na2d::load_chunk;
using na2d::store_chunk;
using na2d::to_float;
using temporal::cp_async_commit;
using temporal::cp_async_wait;
using temporal::ldsm_a;
using temporal::ldsm_b;
using temporal::ldsm_x2_trans;
using temporal::mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kWarpCols = 8;  // the products' warps: 2 rows x 8 columns
constexpr int kNTQkv = 3;     // n8 tiles a warp holds: a sweep of 192
constexpr int kNTProj = 4;    // and of 256 columns
constexpr int kWidthQkv = kWarpCols * kNTQkv * 8;
constexpr int kWidthProj = kWarpCols * kNTProj * 8;
constexpr int kRowsQkv = 32;   // weight rows a ring stage: w_qkv
constexpr int kRowsProj = 32;  // and w_proj
constexpr int kStages = 3;
constexpr int kStage = kRowsProj * (kWidthProj + 8);  // elements
static_assert(kRowsQkv * (kWidthQkv + 8) <= kStage, "a chunk fits a stage");
constexpr int kMaxChannels = 512;
constexpr int kMaxRows = 128;  // rows of the key rectangle the products cover
constexpr int kSmemLimit = 232448 - 1024;  // dynamic: past the static tables

struct Params {
  const float* ln1_scale;
  const float* ln1_bias;
  const bf16* w_qkv;   // (passes, sweeps, Cp, 200)
  const float* b_qkv;  // (passes, 3 p)
  const bf16* w_proj;  // (sweeps, heads * dp, 264)
  const float* b_proj;
  const float* ln2_scale;
  const float* ln2_bias;
};

struct Geometry {
  int H, W, C, Cp, heads, dil, vec;
  float scale, eps;
};

// As ops/na_block_cuda.py::TilePlan.args lays it out.
struct Plan {
  int th, tw, tiles_h, tiles_w, cap, rows_pad, tile_pad;
  int dp, group, passes, p, lanes;
  int ld_ln, ld_attn, ld_kv, ld_proj;
  int off_attn, off_ln, off_k, off_v, off_q, off_x, off_proj, smem;
};
static_assert(sizeof(Plan) == 24 * sizeof(int), "Plan is 24 ints");

// mbarrier and bulk-copy primitives (PTX ISA 8.0, sm_90).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   temporal::smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   temporal::smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(temporal::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from src to dst, counted on bar, which
// expects them.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  const uint32_t b = temporal::smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(temporal::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// The weight chunks of a block, in the order the products use them: per
// pass, per QKV sweep, the 32-row chunks of w_qkv; then per projection
// sweep the 32-row chunks of w_proj. prepare_weights laid each chunk out
// as one contiguous range of padded rows, so one thread moves it with one
// bulk copy. Chunk n goes to ring stage n % kStages; full[stage] counts its
// bytes in, empty[stage] the warps done with it. Thread 0 issues them,
// walking a cursor.
struct Stream {
  const bf16* w_qkv;  // (passes, sweeps_qkv, Cp, kWidthQkv + 8)
  const bf16* w_proj;  // (sweeps_proj, acols, kWidthProj + 8)
  int Cp, acols, passes, sweeps_qkv, sweeps_proj;
};

struct Ring {
  bf16* stages;
  uint64_t* full;
  uint64_t* empty;
};

struct Cursor {
  int pass, sweep, k0, count;  // pass == passes: the projection
};

__device__ __forceinline__ void issue_next(const Stream& s, Cursor& cur,
                                           const Ring& ring) {
  const int n = cur.count++;
  if (cur.pass > s.passes) return;
  const bool proj = cur.pass == s.passes;
  const int K = proj ? s.acols : s.Cp;
  const int krows = proj ? kRowsProj : kRowsQkv;
  const int ldr = proj ? kWidthProj + 8 : kWidthQkv + 8;
  const bf16* src =
      proj ? s.w_proj + ((long long)cur.sweep * s.acols + cur.k0) * ldr
           : s.w_qkv + (((long long)cur.pass * s.sweeps_qkv + cur.sweep) *
                            s.Cp +
                        cur.k0) *
                           ldr;
  const int bytes = min(krows, K - cur.k0) * ldr * 2;
  const int stage = n % kStages;
  if (n >= kStages) mbar_wait(&ring.empty[stage], (n / kStages - 1) & 1);
  bulk_copy(ring.stages + stage * kStage, src, bytes, &ring.full[stage]);
  cur.k0 += krows;
  if (cur.k0 >= K) {
    cur.k0 = 0;
    if (++cur.sweep == (proj ? s.sweeps_proj : s.sweeps_qkv)) {
      cur.sweep = 0;
      ++cur.pass;
    }
  }
}

// acc = MT m16 blocks of rows of A (bf16 in shared memory, row stride lda,
// K columns, K a multiple of 16; `a` at this warp row's first row) times
// the sweep's columns, over the next ceil(K / KC) chunks of the stream;
// warp column wc holds n8 tiles wc * NT + [0, NT). Two chunks are in
// flight while chunk idx is multiplied: a warp waits for its chunk's bytes,
// and releases the stage when done; no block-wide barrier.
template <int MT, int NT, int KC>
__device__ __forceinline__ void gemm_sweep(const Stream& s, Cursor& cur,
                                           const Ring& ring, int& idx,
                                           const bf16* a, int lda, int K,
                                           float (&acc)[MT][NT][4]) {
  constexpr int ldr = NT * kWarpCols * 8 + 8;
  const int lane = threadIdx.x % kWarp;
  const int wc = threadIdx.x / kWarp % kWarpCols;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC, ++idx) {
    const int stage = idx % kStages;
    mbar_wait(&ring.full[stage], (idx / kStages) & 1);
    if (threadIdx.x == 0) issue_next(s, cur, ring);
    __syncwarp();
    const bf16* w = ring.stages + stage * kStage + wc * NT * 8;
    const int rows = min(KC, K - k0);
    for (int ks = 0; ks < rows; ks += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldsm_a(af[mi], a + mi * 16 * lda + k0 + ks, lda);
#pragma unroll
      for (int ni = 0; ni < NT; ni += 2) {
        uint32_t b[4];
        if (ni + 1 < NT) {
          ldsm_b(b, w + ks * ldr + ni * 8, ldr);
        } else {
          ldsm_x2_trans(reinterpret_cast<uint32_t(&)[2]>(b),
                        w + (ks + (lane & 15)) * ldr + ni * 8);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16(acc[mi][ni], af[mi], b[0], b[1]);
          if (ni + 1 < NT) mma_bf16(acc[mi][ni + 1], af[mi], b[2], b[3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[stage]);
  }
}

// Column of value i of a lane's share of a row: chunks lane + 32 j of V
// elements on the vector path, elements lane + 32 i otherwise.
template <int V>
__device__ __forceinline__ int row_col(int i, bool vec) {
  const int lane = threadIdx.x % kWarp;
  return vec ? (lane + kWarp * (i / V)) * V + i % V : lane + kWarp * i;
}

// The values of a per-channel vector at this lane's columns, zero past C.
template <int V, int NV>
__device__ __forceinline__ void lane_vector(const float* p, int C, bool vec,
                                            float (&v)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = row_col<V>(i, vec);
    v[i] = c < C ? p[c] : 0.f;
  }
}

// This lane's share of a row of C elements of type S at p (shared memory),
// as fp32, zero past C: 16-byte chunks on the vector path.
template <typename S, int NV>
__device__ __forceinline__ void load_row(const S* p, int C, bool vec,
                                         float (&v)[NV]) {
  constexpr int V = 16 / sizeof(S);
  if (vec) {
#pragma unroll
    for (int i = 0; i < NV; i += V) {
      const int c = row_col<V>(i, true);
      float f[V];
      if (c < C) {
        load_chunk<S, V>(p + c, f);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) v[i + e] = f[e];
    }
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = row_col<V>(i, false);
      v[i] = c < C ? to_float(p[c]) : 0.f;
    }
  }
}

// This lane's share of an fp32 row at p (shared memory, 16-byte aligned)
// in the chunking of x's type (V elements a chunk), zero past C.
template <int V, int NV>
__device__ __forceinline__ void load_f32_row(const float* p, int C, bool vec,
                                             float (&v)[NV]) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < NV; i += V) {
      const int c = row_col<V>(i, true);
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 f = c < C ? *reinterpret_cast<const float4*>(p + c + e)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        v[i + e] = f.x;
        v[i + e + 1] = f.y;
        v[i + e + 2] = f.z;
        v[i + e + 3] = f.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = row_col<V>(i, false);
      v[i] = c < C ? p[c] : 0.f;
    }
  }
}

// V values (8 or 4) rounded to bf16 and stored as one 16- or 8-byte chunk.
template <int V>
__device__ __forceinline__ void store_bf16_chunk(bf16* p, const float* f) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        temporal::pack_bf16(f[0], f[1]), temporal::pack_bf16(f[2], f[3]),
        temporal::pack_bf16(f[4], f[5]), temporal::pack_bf16(f[6], f[7]));
  } else {
    static_assert(V == 4, "a chunk of x is 8 bf16 or 4 fp32 values");
    *reinterpret_cast<uint2*>(p) = make_uint2(
        temporal::pack_bf16(f[0], f[1]), temporal::pack_bf16(f[2], f[3]));
  }
}

// LayerNorm of R rows held by the warp (v zero past C), in place, as
// ops/na_block.py::layer_norm: mean, biased variance, eps, then
// ((x - mean) * rstd) * scale + bias, each step rounded to fp32. The rows'
// reductions interleave. scale and bias are this lane's values
// (lane_vector).
template <int V, int R, int NV>
__device__ __forceinline__ void layer_norm_rows(float (&v)[R][NV], int C,
                                                bool vec,
                                                const float (&scale)[NV],
                                                const float (&bias)[NV],
                                                float eps) {
  float s[R], mean[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) s[r] += v[r][i];
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mean[r] = s[r] / (float)C;
    s[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (row_col<V>(i, vec) < C) {
        const float d = v[r][i] - mean[r];
        s[r] = __fadd_rn(s[r], __fmul_rn(d, d));
      }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float rstd = rsqrtf(s[r] / (float)C + eps);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      v[r][i] = __fadd_rn(
          __fmul_rn(__fmul_rn(v[r][i] - mean[r], rstd), scale[i]), bias[i]);
  }
}

// bf16(a) and bf16(b) back in fp32 (to nearest even), one conversion.
__device__ __forceinline__ float2 round_pair(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

struct TileGeo {
  int clen_h, clen_w, p0h, p0w, nh, nw, h0, w0, cols;
};

// (c) the windows of the pass's (query, head) items: `lanes` lanes an item,
// lane l holding chunks l + i * lanes (i < CPL) of the head's dp channels.
// The weighted sum of v takes fused multiply-adds: against the plain
// version's separate roundings they differ by an fp32 ulp, far below the
// bf16 rounding that follows.
template <int KS, int CPL>
__device__ __forceinline__ void attend(const Plan& pl, const TileGeo& tg,
                                       const float* qt, const float* kt,
                                       const float* vt, bf16* attn,
                                       int pass) {
  constexpr int KK = KS * KS;
  const int items = pl.th * pl.tw * pl.group;
  const int total = (items * pl.lanes + kWarp - 1) / kWarp * kWarp;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int gl = i % pl.lanes;
    const int item = min(i / pl.lanes, items - 1);
    const bool in_range = i / pl.lanes < items;
    // Head-major: the items of a quarter warp are neighbouring queries.
    const int h = item / (pl.th * pl.tw), slot = item - h * pl.th * pl.tw;
    const int si = slot / pl.tw, sj = slot - si * pl.tw;
    const bool valid = in_range && si < tg.nh && sj < tg.nw;
    const int ti = min(si, tg.nh - 1), tj = min(sj, tg.nw - 1);
    const int base =
        (coset_start(tg.p0h + ti, tg.clen_h, KS) - tg.h0) * tg.cols +
        coset_start(tg.p0w + tj, tg.clen_w, KS) - tg.w0;
    const int hc = h * pl.dp + gl * 4;
    const int step = pl.lanes * 4;
    const float* qrow = qt + (ti * pl.tw + tj) * pl.ld_kv + hc;
    float4 q[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      q[c] = *reinterpret_cast<const float4*>(qrow + c * step);
    float logit[KK];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      const float* krow =
          kt + (base + (j / KS) * tg.cols + j % KS) * pl.ld_kv + hc;
      float s0 = 0.f, s1 = 0.f;  // two partial sums: a shorter chain
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float4 f = *reinterpret_cast<const float4*>(krow + c * step);
        const float2 lo = round_pair(q[c].x * f.x, q[c].y * f.y);
        const float2 hi = round_pair(q[c].z * f.z, q[c].w * f.w);
        s0 += lo.x;
        s1 += lo.y;
        s0 += hi.x;
        s1 += hi.y;
      }
      logit[j] = group_sum(s0 + s1, pl.lanes);
      m = fmaxf(m, logit[j]);
    }
    float denom = 0.f;
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      logit[j] = expf(logit[j] - m);
      denom += logit[j];
    }
    const float inv = 1.0f / denom;
    float4 o[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) o[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      const float w = logit[j] * inv;
      const float* vrow =
          vt + (base + (j / KS) * tg.cols + j % KS) * pl.ld_kv + hc;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float4 f = *reinterpret_cast<const float4*>(vrow + c * step);
        o[c].x = fmaf(w, f.x, o[c].x);
        o[c].y = fmaf(w, f.y, o[c].y);
        o[c].z = fmaf(w, f.z, o[c].z);
        o[c].w = fmaf(w, f.w, o[c].w);
      }
    }
    if (valid) {
      bf16* arow =
          attn + slot * pl.ld_attn + (pass * pl.group) * pl.dp + hc;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        uint2 packed;
        packed.x = temporal::pack_bf16(o[c].x, o[c].y);
        packed.y = temporal::pack_bf16(o[c].z, o[c].w);
        *reinterpret_cast<uint2*>(arow + c * step) = packed;
      }
    }
  }
}

// (b) one QKV sweep of MT m16 row blocks from row0 and its epilogue: +
// bias, q scaled into the tile's q rows (row_slot: a rectangle row's tile
// slot, or -1), k and v into the rectangle's rows.
template <int MT>
__device__ __forceinline__ void qkv_sweep(const Stream& st, Cursor& cur,
                                          const Plan& pl, const Geometry& geo,
                                          const Ring& ring, int& idx,
                                          const bf16* ln, const float* bias,
                                          int n_base, int row0, int npix,
                                          const int* row_slot, float* qt,
                                          float* kt, float* vt) {
  float acc[MT][kNTQkv][4];
  gemm_sweep<MT, kNTQkv, kRowsQkv>(st, cur, ring, idx, ln + row0 * pl.ld_ln,
                                   pl.ld_ln, geo.Cp, acc);
  __syncthreads();  // every warp is past the last reads of q, k, v (or x)
  const int lane = threadIdx.x % kWarp, g = lane >> 2, c = lane & 3;
  const int wc = threadIdx.x / kWarp % kWarpCols;
#pragma unroll
  for (int ni = 0; ni < kNTQkv; ++ni) {
    const int col0 = n_base + (wc * kNTQkv + ni) * 8;
    if (col0 >= 3 * pl.p) continue;
    const int part = col0 / pl.p;
    const int pc = col0 - part * pl.p + 2 * c;
    const float2 bb = *reinterpret_cast<const float2*>(bias + col0 + 2 * c);
    float* dst = part == 0 ? qt : part == 1 ? kt : vt;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + mi * 16 + g + 8 * hf;
        float2 val = make_float2(acc[mi][ni][2 * hf] + bb.x,
                                 acc[mi][ni][2 * hf + 1] + bb.y);
        int r = row;
        if (part == 0) {
          r = row_slot[row];
          val.x *= geo.scale;
          val.y *= geo.scale;
        } else if (row >= npix) {
          r = -1;
        }
        if (r >= 0)
          *reinterpret_cast<float2*>(dst + r * pl.ld_kv + pc) = val;
      }
  }
}

// (d) one projection sweep of MT m16 row blocks from row0 into the fp32
// rows.
template <int MT>
__device__ __forceinline__ void proj_sweep(const Stream& st, Cursor& cur,
                                           const Plan& pl,
                                           const Geometry& geo,
                                           const Ring& ring, int& idx,
                                           const bf16* attn,
                                           int n_base, int row0,
                                           float* proj) {
  float acc[MT][kNTProj][4];
  gemm_sweep<MT, kNTProj, kRowsProj>(st, cur, ring, idx,
                                     attn + row0 * pl.ld_attn, pl.ld_attn,
                                     geo.heads * pl.dp, acc);
  const int lane = threadIdx.x % kWarp, g = lane >> 2, c = lane & 3;
  const int wc = threadIdx.x / kWarp % kWarpCols;
#pragma unroll
  for (int ni = 0; ni < kNTProj; ++ni) {
    const int col = n_base + (wc * kNTProj + ni) * 8 + 2 * c;
    if (col >= geo.Cp) continue;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + mi * 16 + g + 8 * hf;
        *reinterpret_cast<float2*>(proj + row * pl.ld_proj + col) =
            make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
      }
  }
}

// T: x's type; KS: the window side; NV: a lane's share of a row of C
// channels in the LayerNorms, 8 values where C <= 256, else 16.
template <typename T, int KS, int NV>
__global__ void __launch_bounds__(kThreads, 1)
    na_block_kernel(const T* __restrict__ x, Params prm, T* __restrict__ out,
                    Geometry geo, Plan pl, Stream st) {
  constexpr int V = 16 / sizeof(T);
  unsigned char* smem = dynamic_smem();
  __shared__ uint64_t full_bar[kStages], empty_bar[kStages];
  const Ring ring{reinterpret_cast<bf16*>(smem), full_bar, empty_bar};
  bf16* attn = reinterpret_cast<bf16*>(smem + pl.off_attn);
  bf16* ln = reinterpret_cast<bf16*>(smem + pl.off_ln);
  float* kt = reinterpret_cast<float*>(smem + pl.off_k);
  float* vt = reinterpret_cast<float*>(smem + pl.off_v);
  float* qt = reinterpret_cast<float*>(smem + pl.off_q);
  T* xs = reinterpret_cast<T*>(smem + pl.off_x);
  float* proj = reinterpret_cast<float*>(smem + pl.off_proj);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const bool vec = geo.vec > 1;

  // This block's tile: positions [p0h, p0h + nh) x [p0w, p0w + nw) of
  // coset (ch, cw); its key rectangle rows [h0, h0 + rows), columns
  // [w0, w0 + cols).
  int bx = blockIdx.x;
  const int tile_w = bx % pl.tiles_w;
  bx /= pl.tiles_w;
  const int tile_h = bx % pl.tiles_h;
  bx /= pl.tiles_h;
  const int cw = bx % geo.dil;
  bx /= geo.dil;
  const int ch = bx % geo.dil;
  const long long b = bx / geo.dil;
  TileGeo tg;
  tg.clen_h = coset_len(geo.H, ch, geo.dil);
  tg.clen_w = coset_len(geo.W, cw, geo.dil);
  tg.p0h = tile_h * pl.th;
  tg.p0w = tile_w * pl.tw;
  if (tg.p0h >= tg.clen_h || tg.p0w >= tg.clen_w) return;
  tg.nh = min(pl.th, tg.clen_h - tg.p0h);
  tg.nw = min(pl.tw, tg.clen_w - tg.p0w);
  tg.h0 = coset_start(tg.p0h, tg.clen_h, KS);
  tg.w0 = coset_start(tg.p0w, tg.clen_w, KS);
  const int rows = coset_start(tg.p0h + tg.nh - 1, tg.clen_h, KS) + KS - tg.h0;
  tg.cols = coset_start(tg.p0w + tg.nw - 1, tg.clen_w, KS) + KS - tg.w0;
  const int npix = rows * tg.cols;
  const T* xb = x + b * geo.H * geo.W * geo.C;
  auto pixel_offset = [&](int ph, int pw) {  // coset position -> element
    return ((long long)(ch + geo.dil * ph) * geo.W + cw + geo.dil * pw) *
           geo.C;
  };

  // (a) x of the rectangle, and the first weight chunks, in flight.
  if (vec) {
    const int nch = geo.C / V;
    for (int i = threadIdx.x; i < npix * nch; i += kThreads) {
      const int r = i / nch, c = i - r * nch;
      const int rh = r / tg.cols, rw = r - rh * tg.cols;
      cp_async16(xs + r * geo.C + c * V,
                 xb + pixel_offset(tg.h0 + rh, tg.w0 + rw) + c * V);
    }
  } else {
    for (int i = threadIdx.x; i < npix * geo.C; i += kThreads) {
      const int r = i / geo.C, c = i - r * geo.C;
      const int rh = r / tg.cols, rw = r - rh * tg.cols;
      xs[i] = xb[pixel_offset(tg.h0 + rh, tg.w0 + rw) + c];
    }
  }
  // The ring's barriers, then its first chunks, in flight under x.
  Cursor cur{0, 0, 0, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full_bar[i], 1);
      mbar_init(&empty_bar[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kStages - 1; ++i) issue_next(st, cur, ring);
  }
  float scale1[NV], shift1[NV];
  lane_vector<V, NV>(prm.ln1_scale, geo.C, vec, scale1);
  lane_vector<V, NV>(prm.ln1_bias, geo.C, vec, shift1);
  // Each rectangle row's slot in the tile (q's row), or -1.
  __shared__ int row_slot[kMaxRows];
  for (int r = threadIdx.x; r < pl.rows_pad; r += kThreads) {
    const int rh = r / tg.cols, rw = r - rh * tg.cols;
    const int ti = tg.h0 + rh - tg.p0h, tj = tg.w0 + rw - tg.p0w;
    row_slot[r] = r < npix && ti >= 0 && ti < tg.nh && tj >= 0 && tj < tg.nw
                      ? ti * pl.tw + tj
                      : -1;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // LN1 of every rectangle pixel into bf16 rows, padded channels zero; a
  // warp takes two rows at a time.
  {
    for (int r0 = warp; r0 < npix; r0 += 2 * kWarps) {
      float v[2][NV];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = min(r0 + j * kWarps, npix - 1);
        load_row(xs + r * geo.C, geo.C, vec, v[j]);
      }
      layer_norm_rows<V, 2, NV>(v, geo.C, vec, scale1, shift1, geo.eps);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = r0 + j * kWarps;
        if (r >= npix) continue;
        bf16* row = ln + r * pl.ld_ln;
        if (vec) {
#pragma unroll
          for (int i = 0; i < NV; i += V) {
            const int c = row_col<V>(i, true);
            if (c < geo.C) store_bf16_chunk<V>(row + c, v[j] + i);
          }
        } else {
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int c = row_col<V>(i, false);
            if (c < geo.C) row[c] = __float2bfloat16(v[j][i]);
          }
        }
        for (int c = geo.C + lane; c < geo.Cp; c += kWarp)
          row[c] = __float2bfloat16(0.f);
      }
    }
  }

  __syncthreads();

  // The products' warp rows: QKV rows split 0 .. 16 mt0 and the rest.
  const int wr = warp / kWarpCols;
  const int mb = pl.rows_pad / 16, mt0 = (mb + 1) / 2;
  const int mt = wr == 0 ? mt0 : mb - mt0, row0 = wr == 0 ? 0 : mt0 * 16;
  int idx = 0;  // the stream's chunk in use
  for (int pass = 0; pass < pl.passes; ++pass) {
    // (b) q, k and v of this pass's heads.
    const float* bias = prm.b_qkv + pass * 3 * pl.p;
    for (int n_base = 0; n_base < 3 * pl.p; n_base += kWidthQkv) {
#define NA_BLOCK_QKV(M)                                                      \
  qkv_sweep<M>(st, cur, pl, geo, ring, idx, ln, bias, n_base, row0, npix,    \
               row_slot, qt, kt, vt)
      if (mt == 4) {
        NA_BLOCK_QKV(4);
      } else if (mt == 3) {
        NA_BLOCK_QKV(3);
      } else if (mt == 2) {
        NA_BLOCK_QKV(2);
      } else {
        NA_BLOCK_QKV(1);
      }
#undef NA_BLOCK_QKV
    }
    __syncthreads();
    // (c)
    const int cpl = pl.dp / 4 / pl.lanes;
    if (cpl == 1) {
      attend<KS, 1>(pl, tg, qt, kt, vt, attn, pass);
    } else if (cpl == 2) {
      attend<KS, 2>(pl, tg, qt, kt, vt, attn, pass);
    } else {
      attend<KS, 4>(pl, tg, qt, kt, vt, attn, pass);
    }
  }

  // (d) the projection into fp32 rows over the dead LN1 / k / v / q tiles;
  // LN2's vectors load under it.
  float bproj[NV], scale[NV], shift[NV];
  lane_vector<V, NV>(prm.b_proj, geo.C, vec, bproj);
  lane_vector<V, NV>(prm.ln2_scale, geo.C, vec, scale);
  lane_vector<V, NV>(prm.ln2_bias, geo.C, vec, shift);
  __syncthreads();
  for (int n_base = 0; n_base < geo.Cp; n_base += kWidthProj) {
    if (pl.tile_pad > 32) {
      proj_sweep<2>(st, cur, pl, geo, ring, idx, attn, n_base, wr * 32, proj);
    } else {
      proj_sweep<1>(st, cur, pl, geo, ring, idx, attn, n_base, wr * 16, proj);
    }
  }
  __syncthreads();

  // + b_proj, LN2 and the store; a warp takes two pixels of the tile.
  const int slots = pl.th * pl.tw;
  for (int s0 = warp; s0 < slots; s0 += 2 * kWarps) {
    float v[2][NV];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int slot = min(s0 + j * kWarps, slots - 1);
      load_f32_row<V, NV>(proj + slot * pl.ld_proj, geo.C, vec, v[j]);
#pragma unroll
      for (int i = 0; i < NV; ++i) v[j][i] += bproj[i];
    }
    layer_norm_rows<V, 2, NV>(v, geo.C, vec, scale, shift, geo.eps);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int slot = s0 + j * kWarps;
      const int ti = slot / pl.tw, tj = slot - ti * pl.tw;
      if (slot >= slots || ti >= tg.nh || tj >= tg.nw) continue;
      T* orow = out + b * geo.H * geo.W * geo.C +
                pixel_offset(tg.p0h + ti, tg.p0w + tj);
      if (vec) {
#pragma unroll
        for (int i = 0; i < NV; i += V) {
          const int c = row_col<V>(i, true);
          if (c < geo.C) {
            float f[V];
#pragma unroll
            for (int e = 0; e < V; ++e) f[e] = v[j][i + e];
            store_chunk<T, V>(orow + c, f);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = row_col<V>(i, false);
          if (c < geo.C) orow[c] = from_float<T>(v[j][i]);
        }
      }
    }
  }
}

// The host's checks of a plan against the call: what the kernel's fixed
// register arrays, warp tiles and shared-memory regions assume.
bool plan_fits(const Plan& pl, int C, int heads, int itemsize) {
  const int D = C / heads;
  const int cp = (C + 15) / 16 * 16;
  const int tile = pl.th * pl.tw;
  if (pl.th < 1 || pl.tw < 1 || pl.tiles_h < 1 || pl.tiles_w < 1) return false;
  if (pl.cap < tile || pl.cap > pl.rows_pad) return false;
  if (pl.rows_pad % 16 || pl.rows_pad < 32 || pl.rows_pad > kMaxRows)
    return false;
  if ((pl.tile_pad != 32 && pl.tile_pad != 64) || pl.tile_pad < tile)
    return false;
  if (pl.dp % 16 || pl.dp < D || pl.group < 1 || pl.passes * pl.group != heads)
    return false;
  if (pl.p != pl.group * pl.dp) return false;
  if (pl.lanes < 1 || pl.lanes > kWarp || (pl.lanes & (pl.lanes - 1)) ||
      pl.dp / 4 % pl.lanes)
    return false;
  const int cpl = pl.dp / 4 / pl.lanes;
  if (cpl != 1 && cpl != 2 && cpl != 4) return false;
  if (pl.ld_ln < cp || pl.ld_attn < heads * pl.dp || pl.ld_kv < pl.p ||
      pl.ld_proj < cp)
    return false;
  if (pl.ld_ln % 8 || pl.ld_attn % 8 || pl.ld_kv % 4 || pl.ld_proj % 4)
    return false;
  // The regions: ring, attention rows, LN1 rows, k, v, q in that order; x
  // staged past LN1; the projection past the attention rows.
  const int offs[] = {pl.off_attn, pl.off_ln, pl.off_k, pl.off_v,
                      pl.off_q,    pl.off_x,  pl.off_proj};
  for (int off : offs)
    if (off % 16) return false;
  if (pl.off_attn < kStages * kStage * 2 ||
      pl.off_ln < pl.off_attn + pl.tile_pad * pl.ld_attn * 2 ||
      pl.off_k < pl.off_ln + pl.rows_pad * pl.ld_ln * 2 ||
      pl.off_v < pl.off_k + pl.cap * pl.ld_kv * 4 ||
      pl.off_q < pl.off_v + pl.cap * pl.ld_kv * 4 ||
      pl.off_x < pl.off_ln + pl.rows_pad * pl.ld_ln * 2 ||
      pl.off_proj < pl.off_attn + pl.tile_pad * pl.ld_attn * 2)
    return false;
  if (pl.smem < pl.off_q + tile * pl.ld_kv * 4 ||
      pl.smem < pl.off_x + pl.cap * C * itemsize ||
      pl.smem < pl.off_proj + pl.tile_pad * pl.ld_proj * 4 ||
      pl.smem > kSmemLimit)
    return false;
  return true;
}

template <typename T, int KS, int NV>
int launch(const void* x, const Params& prm, void* out, long long B,
           const Geometry& geo, const Plan& pl, cudaStream_t stream) {
  auto kernel = na_block_kernel<T, KS, NV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return (int)err;
  const Stream st{prm.w_qkv, prm.w_proj, geo.Cp, geo.heads * pl.dp,
                  pl.passes, (3 * pl.p + kWidthQkv - 1) / kWidthQkv,
                  (geo.Cp + kWidthProj - 1) / kWidthProj};
  const long long blocks =
      B * geo.dil * geo.dil * (long long)pl.tiles_h * pl.tiles_w;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, pl.smem, stream>>>(
      static_cast<const T*>(x), prm, static_cast<T*>(out), geo, pl, st);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_ks(int ks, const void* x, const Params& prm, void* out,
                long long B, const Geometry& geo, const Plan& pl,
                cudaStream_t stream) {
  if (geo.C <= 256) {
    if (ks == 1) return launch<T, 1, 8>(x, prm, out, B, geo, pl, stream);
    return launch<T, 3, 8>(x, prm, out, B, geo, pl, stream);
  }
  if (ks == 1) return launch<T, 1, 16>(x, prm, out, B, geo, pl, stream);
  return launch<T, 3, 16>(x, prm, out, B, geo, pl, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out); vec: 16 / itemsize when x
// and out are 16-byte aligned and C * itemsize is a multiple of 16, else 1.
// x and out are contiguous (B, H, W, C). The weights come from
// ops/na_block_cuda.py::prepare_weights: w_qkv bf16 (passes, sweeps, Cp,
// 200), b_qkv fp32 (passes, 3 p), w_proj bf16 (sweeps, heads * dp, 264),
// 16-byte aligned; the LayerNorm
// vectors and b_proj fp32 (C). kernel_size is 1 or 3. plan: the 24 ints of
// TilePlan.args. Returns a cudaError_t (0 = launched).
extern "C" int na_block_fwd(int dtype, int vec, const void* x,
                            const float* ln1_scale, const float* ln1_bias,
                            const void* w_qkv, const float* b_qkv,
                            const void* w_proj, const float* b_proj,
                            const float* ln2_scale, const float* ln2_bias,
                            void* out, int B, int H, int W, int C, int heads,
                            int ks, int dil, const int* plan, float eps,
                            void* stream) {
  if (C < 1 || heads < 1 || C % heads || C > kMaxChannels ||
      (ks != 1 && ks != 3) || dil < 1 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  if ((H < W ? H : W) < ks * dil) return (int)cudaErrorInvalidValue;
  Plan pl;
  memcpy(&pl, plan, sizeof(Plan));
  const int itemsize = dtype == 0 ? 4 : 2;
  if (!plan_fits(pl, C, heads, itemsize)) return (int)cudaErrorInvalidValue;
  if (vec != 1 && (vec != 16 / itemsize || C % vec))
    return (int)cudaErrorInvalidValue;
  if (pl.tiles_h * pl.th < (H + dil - 1) / dil ||
      pl.tiles_w * pl.tw < (W + dil - 1) / dil)
    return (int)cudaErrorInvalidValue;
  const Params prm{ln1_scale, ln1_bias,
                   static_cast<const bf16*>(w_qkv), b_qkv,
                   static_cast<const bf16*>(w_proj), b_proj,
                   ln2_scale, ln2_bias};
  const int D = C / heads;
  // head_dim^-0.5 rounded once from double, as the host frameworks round it.
  const Geometry geo{H, W, C, (C + 15) / 16 * 16, heads, dil, vec,
                     (float)(1.0 / sqrt((double)D)), eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_ks<float>(ks, x, prm, out, B, geo, pl, s);
  if (dtype == 1) return dispatch_ks<bf16>(ks, x, prm, out, B, geo, pl, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* na_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
