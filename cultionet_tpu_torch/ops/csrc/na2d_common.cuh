// Shared pieces of the neighborhood-attention kernels.
//
// na2d_fwd.cu replaces cultionet_tpu/ops/natten_pallas.py::_na2d_fwd_kernel
// and _na2d_fwd_drop_kernel; na2d_bwd.cu replaces _na2d_bwd_kernel and
// _na2d_bwd_drop_kernel. Bytes bind all four on the card: at k = 3 they do
// 4.5 (forward) and 6.4 (backward) fp32 operations per byte they must move,
// against the H100's 20 per HBM byte. So both read their inputs through
// shared-memory tiles that neighbouring queries share, and neither uses a
// chain of warp shuffles per window slot; they reach 22-40% of the byte
// bound in bf16 at the model's largest sites (PERF.md). This header holds
// what they share:
//  - type conversions and 16-byte chunk loads and stores;
//  - the clamped window in coset coordinates and the tiles' halos;
//  - the tile geometry the host chose (ops/natten_cuda.py::_tile_plan);
//  - window_dots and softmax_stats, the one code that forms the logits and
//    the softmax for the forward and for pass 1 of the backward, so the
//    backward's weights are the forward's bit for bit;
//  - the attention-dropout keep bit.
// The temporal kernels use the conversions, the chunk loads and stores,
// cp_async16 and warp_sum; na_block_fwd.cu those and the coset helpers,
// group_sum and dynamic_smem.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace na2d {

constexpr int kWarp = 32;
// Channels of one head vector a lane holds in registers: the host gives a
// pixel ceil(D / 16) lanes, rounded up to a power of two.
constexpr int kLaneChannels = 16;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// First index of the clamped window along one axis; neighbour j sits at
// start + dilation * j (ops/natten.py::_axis_neighbor_indices).
__device__ __forceinline__ int window_start(int i, int length, int ks,
                                            int dil) {
  const int coset = i % dil;
  const int pos = i / dil;
  const int coset_len = (length - coset + dil - 1) / dil;
  const int start = min(max(pos - ks / 2, 0), coset_len - ks);
  return coset + dil * start;
}

// The same in coset coordinates: image index coset + dil * p is position p
// of its coset, which holds coset_len positions. Along a coset the start
// steps by 0 or 1, so the keys of a run of queries [p0, p1] are the
// positions [start(p0), start(p1) + ks - 1].
__device__ __forceinline__ int coset_len(int length, int coset, int dil) {
  return (length - coset + dil - 1) / dil;
}
__device__ __forceinline__ int coset_start(int p, int clen, int ks) {
  return min(max(p - ks / 2, 0), clen - ks);
}
// The queries whose window holds key position `key` form the interval
// [first_query, last_query] (the start is monotone), within ks - 1 of it.
__device__ __forceinline__ int first_query(int key, int clen, int ks) {
  int p = max(0, key - (ks - 1));
  while (coset_start(p, clen, ks) + ks - 1 < key) ++p;
  return p;
}
__device__ __forceinline__ int last_query(int key, int clen, int ks) {
  int p = min(clen - 1, key + ks - 1);
  while (coset_start(p, clen, ks) > key) --p;
  return p;
}

// Element strides of a (B, H, W, heads, head_dim) view; head_dim is unit
// stride.
struct Strides {
  long long b, h, w, n;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Attention dropout. The keep bit of window slot j of query-head
// `query` (the flat index ((b * H + h) * W + w) * heads + head) is a pure
// function of (seed, query, j), so the backward redraws the forward's mask
// at any launch geometry. ops/natten.py::dropout_keep_mask computes the
// same bits with torch integer ops; keep the two in step.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// Keep when the top 24 of the 32 hashed bits, as an integer u in
// [0, 2^24), reach `threshold` = ceil(p * 2^24): u / 2^24 >= p.
__device__ __forceinline__ bool keep_bit(uint32_t seed, long long query,
                                         int j, uint32_t threshold) {
  uint32_t x = mix32(seed ^ 0x9e3779b9u);
  x = mix32(x ^ (uint32_t)(query & 0xffffffffll));
  x = mix32(x ^ (uint32_t)(query >> 32));
  x = mix32(x ^ (uint32_t)j);
  return (x >> 8) >= threshold;
}

// Inverted-dropout parameters as the kernels take them: a device pointer to
// the int32 seed (read on the card, so drawing it never waits on the host),
// the integer keep threshold and 1 / (1 - p) in fp32.
struct Dropout {
  const int* seed;
  uint32_t threshold;
  float inv_keep;
};

// ---------------------------------------------------------------------------
// Tiles. A block owns one (b, head, coset) and a th x tw tile of positions
// of that coset. Each pixel of the tile (a query, or a key in the
// backward's second pass) goes to `group` adjacent lanes; lane l holds
// chunks l * lane_step + i * chunk_step, i < chunks_per_lane, of the pixel's
// head vector, a chunk being VEC elements (16 bytes, or one element on the
// scalar path). Halo pixels sit `pix` elements apart in shared memory, a
// stride the host picked so a quarter warp's 16-byte reads of neighbouring
// pixels do not collide in a bank.

struct Geometry {
  int H, W, N, D, ks, dil;
};

// As ops/natten_cuda.py::TilePlan.args lays it out.
struct Plan {
  int th, tw, group, lane_step, chunk_step, chunks_per_lane, pix, cap;
  int tiles_h, tiles_w, smem;
};

inline Plan read_plan(const int* p) {
  return Plan{p[0], p[1], p[2], p[3], p[4],  p[5],
              p[6], p[7], p[8], p[9], p[10]};
}

inline int align16(long long bytes) { return (int)((bytes + 15) / 16 * 16); }

inline int block_threads(const Plan& pl) {
  return (pl.th * pl.tw * pl.group + kWarp - 1) / kWarp * kWarp;
}

// The tile of this block, in coset positions: rows [p0h, p1h), columns
// [p0w, p1w) of coset (ch, cw), whose lengths are clen_h, clen_w. False
// when the tile lies past a shorter (ragged) coset's end.
struct Tile {
  long long b;
  int n, ch, cw, clen_h, clen_w, p0h, p1h, p0w, p1w;
};

__device__ __forceinline__ bool block_tile(const Plan& pl, const Geometry& g,
                                           Tile& t) {
  int bx = blockIdx.x;
  const int tile_w = bx % pl.tiles_w;
  bx /= pl.tiles_w;
  const int tile_h = bx % pl.tiles_h;
  bx /= pl.tiles_h;
  t.cw = bx % g.dil;
  t.ch = bx / g.dil;
  t.n = blockIdx.y;
  t.b = blockIdx.z;
  t.clen_h = coset_len(g.H, t.ch, g.dil);
  t.clen_w = coset_len(g.W, t.cw, g.dil);
  t.p0h = tile_h * pl.th;
  t.p0w = tile_w * pl.tw;
  if (t.p0h >= t.clen_h || t.p0w >= t.clen_w) return false;
  t.p1h = min(t.p0h + pl.th, t.clen_h);
  t.p1w = min(t.p0w + pl.tw, t.clen_w);
  return true;
}

// This thread's pixel of the tile and its lane. Threads past the tile (the
// block is rounded up to whole warps) and past a ragged edge take the
// nearest pixel of the tile, so they run every shuffle and barrier with
// the others, and store nothing.
struct Pixel {
  int slot, lane, ph, pw;
  bool valid;
};

__device__ __forceinline__ Pixel thread_pixel(const Plan& pl, const Tile& t) {
  Pixel p;
  p.slot = threadIdx.x / pl.group;
  p.lane = threadIdx.x % pl.group;
  const int ti = p.slot / pl.tw, tj = p.slot % pl.tw;
  p.valid = ti < pl.th && t.p0h + ti < t.p1h && t.p0w + tj < t.p1w;
  p.ph = min(t.p0h + ti, t.p1h - 1);
  p.pw = min(t.p0w + tj, t.p1w - 1);
  return p;
}

// A rectangle of coset positions held in shared memory, row-major.
struct Halo {
  int h0, w0, rows, cols;
};

// The keys of the tile's queries (forward, backward pass 1).
__device__ __forceinline__ Halo key_halo(const Tile& t, int ks) {
  Halo h;
  h.h0 = coset_start(t.p0h, t.clen_h, ks);
  h.w0 = coset_start(t.p0w, t.clen_w, ks);
  h.rows = coset_start(t.p1h - 1, t.clen_h, ks) + ks - h.h0;
  h.cols = coset_start(t.p1w - 1, t.clen_w, ks) + ks - h.w0;
  return h;
}

// The queries whose windows hold the tile's keys (backward pass 2).
__device__ __forceinline__ Halo query_halo(const Tile& t, int ks) {
  Halo h;
  h.h0 = first_query(t.p0h, t.clen_h, ks);
  h.w0 = first_query(t.p0w, t.clen_w, ks);
  h.rows = last_query(t.p1h - 1, t.clen_h, ks) + 1 - h.h0;
  h.cols = last_query(t.p1w - 1, t.clen_w, ks) + 1 - h.w0;
  return h;
}

__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char na2d_smem[];
  return na2d_smem;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// VEC elements at p (16 bytes when VEC > 1, aligned) as fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_float(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "a chunk is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    if constexpr (std::is_same<T, float>::value) {
      f[0] = __uint_as_float(raw.x);
      f[1] = __uint_as_float(raw.y);
      f[2] = __uint_as_float(raw.z);
      f[3] = __uint_as_float(raw.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(h[e]);
        f[2 * e] = x.x;
        f[2 * e + 1] = x.y;
      }
    }
  }
}

// fp32 values rounded to T (to nearest even) and stored as one chunk.
template <typename T, int VEC>
__device__ __forceinline__ void store_chunk(T* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_float<T>(f[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// Copies a halo rectangle of one head's vectors into shared memory: halo
// pixel (r, c) is image pixel (row0 + dil * r, col0 + dil * c) of `src`
// (already offset to the batch and head), and lands at dst + (r * cols + c)
// * pix. 16-byte cp.async on the vector path; the caller waits.
template <typename T, int VEC>
__device__ __forceinline__ void load_halo(T* dst, const T* src, long long sh,
                                          long long sw, int row0, int col0,
                                          int dil, const Halo& halo,
                                          int nchunks, int pix) {
  const int total = halo.rows * halo.cols * nchunks;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int c = idx % nchunks;
    const int px = idx / nchunks;
    const int r = px / halo.cols, cc = px % halo.cols;
    const T* from = src + (long long)(row0 + dil * r) * sh +
                    (long long)(col0 + dil * cc) * sw + c * VEC;
    T* to = dst + px * pix + c * VEC;
    if constexpr (VEC == 1) {
      *to = *from;
    } else {
      cp_async16(to, from);
    }
  }
}

// A head vector held in registers: the chunks of this lane, as fp32.
template <int VEC>
struct LaneVec {
  static constexpr int kChunks = kLaneChannels / VEC;
  float x[kChunks][VEC];
};

__device__ __forceinline__ int lane_chunk(const Plan& pl, int lane, int i) {
  return lane * pl.lane_step + i * pl.chunk_step;
}

// This lane's chunks of the vector at p, times `scale`; the rest zero.
template <typename T, int VEC>
__device__ __forceinline__ void load_lane(const Plan& pl, int lane,
                                          int nchunks, const T* p,
                                          float scale, LaneVec<VEC>& r) {
#pragma unroll
  for (int i = 0; i < LaneVec<VEC>::kChunks; ++i) {
    const int c = lane_chunk(pl, lane, i);
    if (i < pl.chunks_per_lane && c < nchunks) {
      load_chunk<T, VEC>(p + c * VEC, r.x[i]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) r.x[i][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) r.x[i][e] = 0.f;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_lane(const Plan& pl, int lane,
                                           int nchunks, T* p, float scale,
                                           const LaneVec<VEC>& r) {
#pragma unroll
  for (int i = 0; i < LaneVec<VEC>::kChunks; ++i) {
    const int c = lane_chunk(pl, lane, i);
    if (i < pl.chunks_per_lane && c < nchunks) {
      float f[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = r.x[i][e] * scale;
      store_chunk<T, VEC>(p + c * VEC, f);
    }
  }
}

// acc += w * (the vector at p, this lane's chunks).
template <typename T, int VEC>
__device__ __forceinline__ void axpy_lane(const Plan& pl, int lane,
                                          int nchunks, const T* p, float w,
                                          LaneVec<VEC>& acc) {
#pragma unroll
  for (int i = 0; i < LaneVec<VEC>::kChunks; ++i) {
    const int c = lane_chunk(pl, lane, i);
    if (i < pl.chunks_per_lane && c < nchunks) {
      float f[VEC];
      load_chunk<T, VEC>(p + c * VEC, f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc.x[i][e] += w * f[e];
    }
  }
}

// Sum over the `group` lanes of a pixel (a butterfly, log2(group) steps;
// every lane ends with the same bits).
__device__ __forceinline__ float group_sum(float x, int group) {
  for (int off = group >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The logits (q . k_j, q already scaled by D^-0.5) of the window of one
// query, and with kGv also g . v_j, into the query's shared-memory rows
// (slot j written by lane j % group). The halo pixel of slot (jh, jw) is
// base + jh * cols + jw. Each lane sums its chunks in order, then the
// group's butterfly: one fixed order, so the forward and the backward form
// the same bits. Slots are independent, so their loads, products and
// butterflies interleave; the caller's whole warp must call it.
template <bool kGv, int KS, typename T, int VEC>
__device__ __forceinline__ void window_dots(
    const Plan& pl, int lane, int nchunks, int ks, const LaneVec<VEC>& q,
    const LaneVec<VEC>& g, const T* kh, const T* vh, int base, int cols,
    float* logits, float* gvs) {
  if constexpr (KS > 0) ks = KS;  // constant: the loops unroll
#pragma unroll
  for (int jh = 0; jh < ks; ++jh) {
#pragma unroll
    for (int jw = 0; jw < ks; ++jw) {
      const int px = base + jh * cols + jw;
      const T* kp = kh + px * pl.pix;
      const T* vp = vh + px * pl.pix;
      float l = 0.f, gv = 0.f;
#pragma unroll
      for (int i = 0; i < LaneVec<VEC>::kChunks; ++i) {
        const int c = lane_chunk(pl, lane, i);
        if (i < pl.chunks_per_lane && c < nchunks) {
          float f[VEC];
          load_chunk<T, VEC>(kp + c * VEC, f);
#pragma unroll
          for (int e = 0; e < VEC; ++e) l += q.x[i][e] * f[e];
          if constexpr (kGv) {
            load_chunk<T, VEC>(vp + c * VEC, f);
#pragma unroll
            for (int e = 0; e < VEC; ++e) gv += g.x[i][e] * f[e];
          }
        }
      }
      l = group_sum(l, pl.group);
      if constexpr (kGv) gv = group_sum(gv, pl.group);
      const int j = jh * ks + jw;
      if (j % pl.group == lane) {
        logits[j] = l;
        if constexpr (kGv) gvs[j] = gv;
      }
    }
  }
  __syncwarp();
}

// Max-subtracted softmax statistics of one query's logits: the max and
// 1 / sum(exp(l - max)), exact division. Every lane reads the row and gets
// the same bits; the weight of slot j is expf(l_j - m) * inv.
__device__ __forceinline__ void softmax_stats(const float* logits, int kk,
                                              float& m, float& inv) {
  m = -INFINITY;
  for (int j = 0; j < kk; ++j) m = fmaxf(m, logits[j]);
  float denom = 0.f;
  for (int j = 0; j < kk; ++j) denom += expf(logits[j] - m);
  inv = 1.0f / denom;
}

}  // namespace na2d
