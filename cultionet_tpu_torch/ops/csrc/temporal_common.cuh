// Shared pieces of the temporal-attention kernels (temporal_fwd.cu,
// temporal_bwd.cu): the tile plan the host chose
// (ops/temporal_cuda.py::_tile_plan); the copies of a tile of whole pixels
// into shared memory (16-byte cp.async, the (pixel, row, chunk) digits
// advanced without a division per chunk) and of the staged outputs back;
// the zeroed padding rows of the tensor-core tiles; the persistent walk over
// the tiles with its two copy stages; and the fragment code of the bf16
// tensor-core paths (mma.sync.m16n8k16 with ldmatrix operands): the logits
// and products of one 16 x 16 chunk, which the forward and the backward
// share. na_block_fwd.cu uses the ldmatrix, mma and cp.async helpers.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <initializer_list>
#include <type_traits>

#include "na2d_common.cuh"

namespace temporal {

using na2d::cp_async16;
using na2d::from_float;
using na2d::to_float;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;       // query or key steps per MMA chunk
constexpr int kScratchRow = 24;  // bf16 row stride of a warp's 16 x 16 scratch
constexpr int kSmemLimit = 232448;
// Kernel paths: SIMT (fp32), tensor cores with a warp per (pixel, head),
// tensor cores with a warp per pixel (the pooling call).
constexpr int kSimt = 0, kMma = 1, kPool = 2;

// Element strides of an (N, T, C) view along N and T; C is unit-stride.
struct Strides {
  long long n, t;
};

// As ops/temporal_cuda.py::TilePlan.args lays it out. Offsets are bytes of
// dynamic shared memory; row strides (rs_*) are elements.
//  - [0, stage0): the pooling query rows, broadcast over the pixels
//    (q_bcast), and for the pooling path its B fragments at qfrag_off;
//  - `stages` input stages of `pixels` pixels, pix_bytes each: q rows at
//    q_off (unless broadcast), k at k_off, v at v_off (fused: the three
//    thirds of one (T, 3C) row block), g at g_off (backward). On the
//    tensor-core paths q and g hold tq_rows rows and k and v s_rows rows,
//    T rounded up to 16, the rows past T zero;
//  - from out0, the staged outputs, out_pix_bytes a pixel: out (forward),
//    or the fp32 dq accumulator at 0, dk at dk_off, dv at dv_off and the
//    per-row softmax statistics at stats_off (backward);
//  - from scratch0, scratch_warp bytes of scratch for each warp.
struct Plan {
  int pixels, stages, grid, tiles, smem, mma, fused, q_bcast;
  int rs_q, rs_kv, rs_g, rs_out, rs_dq;
  int pix_bytes, stage0, stage_bytes, q_off, k_off, v_off, g_off;
  int out0, out_pix_bytes, dk_off, dv_off, stats_off, scratch0;
  int pool, tq_rows, s_rows, qfrag_off, scratch_warp;
};

inline Plan read_plan(const int* p) {
  Plan pl;
  memcpy(&pl, p, sizeof(Plan));
  return pl;
}

// The host's checks of a plan against the call: tiles cover N, the memory
// fits a block, the grid is at most one block per tile, the padded rows
// hold the steps.
inline bool plan_fits(const Plan& pl, long long N, int Tq, int S, bool bf16) {
  if (pl.pixels < 1 || pl.stages < 1 || pl.stages > 2) return false;
  if (pl.tiles != (N + pl.pixels - 1) / pl.pixels) return false;
  if (pl.grid < 1 || pl.grid > pl.tiles) return false;
  if (pl.smem < 0 || pl.smem > kSmemLimit) return false;
  if ((pl.mma || pl.pool) && !bf16) return false;
  if (pl.tq_rows < Tq || pl.s_rows < S) return false;
  if (pl.scratch0 + kWarps * pl.scratch_warp > pl.smem) return false;
  return true;
}

__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(16) unsigned char temporal_smem[];
  return temporal_smem;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The (pixel, row, chunk) digits of a flat chunk index of a tile, advanced
// by the block's stride without a division per chunk.
struct Cursor {
  int p, r, c, sp, sr, sc, rows, per_row;
  __device__ __forceinline__ Cursor(int i, int step, int rows_, int per_row_)
      : rows(rows_), per_row(per_row_) {
    const int per_pix = rows * per_row;
    p = i / per_pix;
    r = (i - p * per_pix) / per_row;
    c = i - p * per_pix - r * per_row;
    sp = step / per_pix;
    sr = (step - sp * per_pix) / per_row;
    sc = step - sp * per_pix - sr * per_row;
  }
  __device__ __forceinline__ void advance() {
    c += sc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
    r += sr;
    if (r >= rows) {
      r -= rows;
      ++p;
    }
    p += sp;
  }
};

// Rows [0, rows) of pixels n0 .. n0 + np - 1 of a strided (N, rows,
// row_elems) view into shared memory: pixel p at dst + p * pix_bytes, row r
// at r * rs elements. Consecutive threads take consecutive 16-byte chunks
// (cp.async; the caller commits and waits) or, on the scalar path,
// consecutive elements.
template <typename T>
__device__ __forceinline__ void copy_in(unsigned char* dst, int pix_bytes,
                                        int rs, const T* __restrict__ src,
                                        Strides st, long long n0, int np,
                                        int rows, int row_elems, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int width = vec ? V : 1;
  const int total = np * rows * (row_elems / width);
  Cursor at(threadIdx.x, blockDim.x, rows, row_elems / width);
  for (int i = threadIdx.x; i < total; i += blockDim.x, at.advance()) {
    const int col = at.c * width;
    const T* from = src + (n0 + at.p) * st.n + at.r * st.t + col;
    T* to = reinterpret_cast<T*>(dst + at.p * pix_bytes) + at.r * rs + col;
    if (vec) {
      cp_async16(to, from);
    } else {
      *to = *from;
    }
  }
}

// Staged rows (element type S: T, or fp32 for the dq accumulator) of np
// pixels to the contiguous (N, rows, C) output at pixel n0, rounded to T:
// 16-byte stores of consecutive chunks of the tile's one contiguous range
// (or elements on the scalar path).
template <typename T, typename S>
__device__ __forceinline__ void copy_out(T* __restrict__ dst,
                                         const unsigned char* src,
                                         int pix_bytes, int rs, long long n0,
                                         int np, int rows, int C, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int width = vec ? V : 1;
  const int total = np * rows * (C / width);
  T* out = dst + n0 * rows * C;
  Cursor at(threadIdx.x, blockDim.x, rows, C / width);
  for (int i = threadIdx.x; i < total; i += blockDim.x, at.advance()) {
    const S* from =
        reinterpret_cast<const S*>(src + at.p * pix_bytes) + at.r * rs +
        at.c * width;
    T* to = out + (long long)i * width;
    if (!vec) {
      *to = from_float<T>(to_float(*from));
    } else if constexpr (std::is_same<S, T>::value) {
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    } else {
      float f[V];
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = to_float(from[e]);
      na2d::store_chunk<T, V>(to, f);
    }
  }
}

// Zeroes rows [r0, r1) (row_bytes each, a multiple of 16) of np pixels at
// base + p * pix_bytes: the padding rows of the tensor-core tiles, which no
// copy writes.
__device__ __forceinline__ void zero_rows(unsigned char* base, int pix_bytes,
                                          int np, int row_bytes, int r0,
                                          int r1) {
  const int per_pix = (r1 - r0) * row_bytes / 16;
  for (int i = threadIdx.x; i < np * per_pix; i += blockDim.x) {
    const int p = i / per_pix;
    *reinterpret_cast<uint4*>(base + p * pix_bytes + r0 * row_bytes +
                              (i - p * per_pix) * 16) = make_uint4(0, 0, 0, 0);
  }
}

// The persistent walk: block b takes tiles b, b + grid, ...; `issue(tile,
// stage)` starts the copies of a tile's inputs into a stage, `compute(tile,
// stage)` runs on them and stages the outputs, `store(tile)` writes them
// out. With two stages the next tile's copy runs under this tile's compute.
template <typename Issue, typename Compute, typename Store>
__device__ __forceinline__ void walk_tiles(const Plan& pl, Issue&& issue,
                                           Compute&& compute, Store&& store) {
  int stage = 0;
  int tile = blockIdx.x;
  if (tile < pl.tiles) issue(tile, 0);
  cp_async_commit();
  for (; tile < pl.tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (pl.stages == 2) {
      if (next < pl.tiles) issue(next, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(tile, stage);
    __syncthreads();
    store(tile);
    __syncthreads();
    if (pl.stages == 2) {
      stage ^= 1;
    } else if (next < pl.tiles) {
      issue(next, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// SIMT pieces (fp32): head_dim values of a row in registers, a template
// width MAXD >= head_dim with a zero tail.

template <typename T, int MAXD>
__device__ __forceinline__ void load_row(const T* p, int hd, float scale,
                                         float (&r)[MAXD]) {
#pragma unroll
  for (int d = 0; d < MAXD; ++d) r[d] = d < hd ? to_float(p[d]) * scale : 0.f;
}

template <typename T, int MAXD>
__device__ __forceinline__ float dot_row(const float (&a)[MAXD], const T* p,
                                         int hd) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < MAXD; ++d)
    if (d < hd) acc[d % 4] = fmaf(a[d], to_float(p[d]), acc[d % 4]);
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <typename T, int MAXD>
__device__ __forceinline__ void store_row(T* p, int hd, float scale,
                                          const float (&r)[MAXD]) {
#pragma unroll
  for (int d = 0; d < MAXD; ++d)
    if (d < hd) p[d] = from_float<T>(r[d] * scale);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core pieces (mma.sync.m16n8k16); lane = 4 g + c. Fragments:
// A (16 x 16, row-major) a0 = (g, 2c..2c+1), a1 = (g + 8, 2c..), a2 = (g,
// 2c + 8..), a3 = (g + 8, 2c + 8..); B (16 x 8, k x n) b0 = (2c..2c+1, g),
// b1 = (2c + 8.., g); C (16 x 8) c0, c1 = (g, 2c..2c+1), c2, c3 = (g + 8,
// 2c..). Operands are staged rows (base = their first element, rs elements
// a row). With kFull (head_dim a multiple of 16) each fragment is one
// ldmatrix of 16-byte row segments and the zeroed padding rows stand in for
// the steps past T; otherwise each pair is read element by element, the
// rows past `rows` and the columns past head_dim as zeros, so no chunk reads
// another head's columns.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t bits(bf16 x) {
  return (uint32_t)__bfloat16_as_ushort(x);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register j holds matrix j.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// The A fragment of the 16 x 16 block at base.
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* base,
                                       int rs) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
  ldsm_x4(a, base + (r + 8 * (j & 1)) * rs + 8 * (j >> 1));
}

// The A fragment of the transpose of the 16 x 16 block at base.
__device__ __forceinline__ void ldsm_at(uint32_t (&a)[4], const bf16* base,
                                        int rs) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
  ldsm_x4_trans(a, base + (r + 8 * (j >> 1)) * rs + 8 * (j & 1));
}

// B fragments of X Y^T for the 16 rows of Y at base (16 columns of k): b[0],
// b[1] for Y's rows 0-7, b[2], b[3] for rows 8-15.
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[4], const bf16* base,
                                        int rs) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
  ldsm_x4(b, base + (r + 8 * (j >> 1)) * rs + 8 * (j & 1));
}

// B fragments of X Y for the 16 rows (k) of Y at base: b[0], b[1] for its
// columns 0-7, b[2], b[3] for columns 8-15.
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const bf16* base,
                                       int rs) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
  ldsm_x4_trans(b, base + (r + 8 * (j & 1)) * rs + 8 * (j >> 1));
}

// Elements (r, d) and (r, d + 1), zero past `rows` and past head_dim.
__device__ __forceinline__ uint32_t pair_along_row(const bf16* base, int rs,
                                                   int r, int rows, int d,
                                                   int hd) {
  if (r >= rows) return 0u;
  const bf16* p = base + r * rs + d;
  return (d < hd ? bits(p[0]) : 0u) | (d + 1 < hd ? bits(p[1]) << 16 : 0u);
}

// Elements (r, d) and (r + 1, d).
__device__ __forceinline__ uint32_t pair_along_col(const bf16* base, int rs,
                                                   int r, int rows, int d,
                                                   int hd) {
  if (d >= hd) return 0u;
  const uint32_t lo = r < rows ? bits(base[r * rs + d]) : 0u;
  const uint32_t hi = r + 1 < rows ? bits(base[(r + 1) * rs + d]) : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of 16 rows of X (row-major, head_dim columns) for each of the
// KD 16-column steps of head_dim.
template <bool kFull, int KD>
__device__ __forceinline__ void load_a(const bf16* base, int rs, int rows,
                                       int hd, uint32_t (&a)[KD][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    if constexpr (kFull) {
      ldsm_a(a[kd], base + kd * 16, rs);
    } else {
      const int d = kd * 16 + 2 * c;
      a[kd][0] = pair_along_row(base, rs, g, rows, d, hd);
      a[kd][1] = pair_along_row(base, rs, g + 8, rows, d, hd);
      a[kd][2] = pair_along_row(base, rs, g, rows, d + 8, hd);
      a[kd][3] = pair_along_row(base, rs, g + 8, rows, d + 8, hd);
    }
  }
}

// A fragment of a 16 x 16 product held in C fragments (two n-tiles of 8
// columns), rounded to bf16: the register reuse of P in O = P V.
__device__ __forceinline__ void c_to_a(const float (&x)[2][4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// s = A B^T for 16 rows of A (fragments a) and the 16 rows of B at base
// (rows past `rows` zero): the logits Q K^T of one chunk (or dO V^T).
template <bool kFull, int KD>
__device__ __forceinline__ void dots16(const uint32_t (&a)[KD][4],
                                       const bf16* base, int rs, int rows,
                                       int hd, float (&s)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  }
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    if constexpr (kFull) {
      uint32_t b[4];
      ldsm_bt(b, base + kd * 16, rs);
      mma_bf16(s[0], a[kd], b[0], b[1]);
      mma_bf16(s[1], a[kd], b[2], b[3]);
    } else {
      const int d = kd * 16 + 2 * c;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int r = nt * 8 + g;
        mma_bf16(s[nt], a[kd], pair_along_row(base, rs, r, rows, d, hd),
                 pair_along_row(base, rs, r, rows, d + 8, hd));
      }
    }
  }
}

// acc[dn] += A X for a 16-step A fragment and the 16 rows of X at base
// (rows past `rows` zero), over head_dim in n-tiles of 8: O += P V, and the
// gradients' products.
template <bool kFull, int ND>
__device__ __forceinline__ void accumulate16(const uint32_t (&a)[4],
                                             const bf16* base, int rs,
                                             int rows, int hd,
                                             float (&acc)[ND][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  if constexpr (kFull) {
#pragma unroll
    for (int dn = 0; dn < ND; dn += 2) {
      uint32_t b[4];
      ldsm_b(b, base + dn * 8, rs);
      mma_bf16(acc[dn], a, b[0], b[1]);
      mma_bf16(acc[dn + 1], a, b[2], b[3]);
    }
  } else {
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      const int d = dn * 8 + g;
      mma_bf16(acc[dn], a, pair_along_col(base, rs, 2 * c, rows, d, hd),
               pair_along_col(base, rs, 2 * c + 8, rows, d, hd));
    }
  }
}

// Scales the logits of one chunk (scale2 = head_dim^-0.5 log2(e): the
// tensor-core paths take their softmax in base 2) and sets the columns at
// or past `cols` to -inf; returns the maxima of this thread's two rows over
// the quad.
__device__ __forceinline__ void mask_and_max(float (&s)[2][4], int cols,
                                             float scale2, float (&mx)[2]) {
  const int c = threadIdx.x & 3;
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + 2 * c + (e & 1);
      s[nt][e] = col < cols ? s[nt][e] * scale2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Sum and max over the 8 lanes of one quad position (lanes c, c + 4, ...,
// c + 28): a column of a C fragment.
__device__ __forceinline__ float column_sum(float x) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float column_max(float x) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

constexpr float kLog2e = 1.4426950408889634f;

// Calls f(std::integral_constant<int, MAXD>()) with the register width for
// head_dim: the smallest of `widths` that holds it.
template <int... Widths, typename F>
int with_width(int hd, F&& f) {
  int code = (int)cudaErrorInvalidValue;
  bool done = false;
  (void)std::initializer_list<int>{
      (!done && hd >= 1 && hd <= Widths
           ? (done = true, code = f(std::integral_constant<int, Widths>()), 0)
           : 0)...};
  return code;
}

}  // namespace temporal
