// The backward of LayerNorm over the contiguous last axis of narrow rows
// (layer_norm_fwd.cu's training form), for Hopper (sm_90a). With
// x_hat = (x - mean) * rstd, g = weight * dy and the means over a row's
// `width` elements,
//   dx = rstd * (g - mean(g) - x_hat * mean(g * x_hat)),
//   dweight = sum over rows of dy * x_hat,  dbias = sum over rows of dy,
// all in fp32 from the forward's fp32 mean and rstd, each output rounded
// once to its type, as torch.nn.functional.layer_norm's backward computes
// them.
//
// Replaces no TPU kernel: XLA differentiates and fuses LayerNorm on the
// TPU. It was added for training TSViT (models/tsvit.py), whose 19
// LayerNorms a step normalise 128-wide token rows (182,016 rows in each
// temporal one at batch 16), and the transformer front end's LayerNorms in
// training: PyTorch's two backward kernels (input gradient, then
// GammaBetaBackward) ran at about 15% of their byte bound there.
//
// Bound on the card: bytes. x and dy are read once and dx written once;
// the rest (8 bytes of statistics a row, the weight, the column sums) is
// small. The design:
//  - The forward's plan (layer_norm_common.cuh): a row held by a group of
//    lanes in chunks of the widest load, kRows rows a thread, the loads of
//    x and dy for all of them issued before any is reduced; at width 128 in
//    bf16, 16 lanes of 16 bytes, two rows a warp.
//  - mean(g) and mean(g * x_hat) are reduced across the row's lane group
//    with xor shuffles, and dx computed from the values in registers.
//  - dweight and dbias: each thread keeps fp32 sums of dy * x_hat and dy
//    for the columns it holds, over every row it takes. The persistent
//    grid (blocks_per_sm(cpl, true) a SM) walks the tiles; at the end each
//    block sums its lane groups (xor shuffles) and then its warps in a
//    fixed order in shared memory, and writes one (2, width) fp32 partial.
//    A second launch (layer_norm_rows_bwd_sum_kernel) sums the partials
//    over the blocks in a fixed order and writes dweight and dbias in the
//    weight's type. No atomics: two runs give the same bits.
// Inputs: x, dy and dx contiguous (rows, width) and weight (width,), of one
// type (fp32 or bf16) aligned to the chunk's bytes; mean and rstd fp32
// (rows,); dweight and dbias (width,) of the weight's type; a partial
// buffer of at least grid x 2 x width fp32 (layer_norm_rows_bwd_plan's
// grid). The wrapper (ops/layer_norm_cuda.py) checks all of it.

#include "layer_norm_common.cuh"

#include <initializer_list>

namespace {

// Threads of the partials' sum: 32 columns x kSumSlices slices of the
// blocks, each slice summing every kSumSlices-th block.
constexpr int kSumSlices = 32;
constexpr int kSumThreads = 32 * kSumSlices;

template <typename T, int kVec, int kLanes, int kCpl, int kRows>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kCpl, true))
    layer_norm_rows_bwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ dy,
                               const float* __restrict__ mean,
                               const float* __restrict__ rstd,
                               const T* __restrict__ weight,
                               T* __restrict__ dx,
                               float* __restrict__ partial, long long rows,
                               int width) {
  using C = Chunk<T, kVec>;
  using Raw = typename C::Raw;
  constexpr int kGroups = 32 / kLanes;
  constexpr int kWarpRows = kGroups * kRows;
  constexpr int kBlockRows = (kThreads / 32) * kWarpRows;
  constexpr int kCols = kCpl * kVec;  // the columns a thread holds
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane / kLanes;
  const int sub = lane % kLanes;
  const int chunks = width / kVec;
  const float inv_width = 1.0f / static_cast<float>(width);
  const Raw* xv = reinterpret_cast<const Raw*>(x);
  const Raw* gv = reinterpret_cast<const Raw*>(dy);
  const Raw* wv = reinterpret_cast<const Raw*>(weight);
  Raw* dxv = reinterpret_cast<Raw*>(dx);

  float dw[kCols], db[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) dw[i] = db[i] = 0.0f;

  const long long tiles = (rows + kBlockRows - 1) / kBlockRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kBlockRows + warp * kWarpRows + group;
    // A masked row or chunk reads zeros: its dy of 0 adds nothing to any
    // sum, and it is not written.
    Raw xr[kRows][kCpl], gr[kRows][kCpl];
    float mu[kRows], rs[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long row = row0 + r * kGroups;
      const bool valid_row = row < rows;
      mu[r] = valid_row ? __ldg(mean + row) : 0.0f;
      rs[r] = valid_row ? __ldg(rstd + row) : 0.0f;
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int c = sub + j * kLanes;
        const bool valid = valid_row && c < chunks;
        xr[r][j] = valid ? __ldg(xv + row * chunks + c) : Raw{};
        gr[r][j] = valid ? __ldg(gv + row * chunks + c) : Raw{};
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long row = row0 + r * kGroups;
      float sum_g = 0.0f, sum_gx = 0.0f;
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int c = sub + j * kLanes;
        float xf[kVec], gf[kVec], wf[kVec];
        C::load(xr[r][j], xf);
        C::load(gr[r][j], gf);
        C::load(c < chunks ? __ldg(wv + c) : Raw{}, wf);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xhat = (xf[e] - mu[r]) * rs[r];
          const float g = wf[e] * gf[e];
          sum_g += g;
          sum_gx += g * xhat;
          dw[j * kVec + e] += gf[e] * xhat;
          db[j * kVec + e] += gf[e];
        }
      }
      const float mean_g = group_sum<kLanes>(sum_g) * inv_width;
      const float mean_gx = group_sum<kLanes>(sum_gx) * inv_width;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int c = sub + j * kLanes;
        if (c >= chunks) continue;
        float xf[kVec], gf[kVec], wf[kVec];
        C::load(xr[r][j], xf);
        C::load(gr[r][j], gf);
        C::load(__ldg(wv + c), wf);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xhat = (xf[e] - mu[r]) * rs[r];
          xf[e] = rs[r] * (wf[e] * gf[e] - mean_g - xhat * mean_gx);
        }
        dxv[row * chunks + c] = C::store(xf);
      }
    }
  }

  // The lane groups of a warp hold the same columns: sum them.
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
#pragma unroll
    for (int offset = 16; offset >= kLanes; offset /= 2) {
      dw[i] += __shfl_xor_sync(0xffffffffu, dw[i], offset);
      db[i] += __shfl_xor_sync(0xffffffffu, db[i], offset);
    }
  }
  // Then the warps, in order, in shared memory; then the block's partial.
  __shared__ float acc[2][kLanes * kCols];
  for (int w = 0; w < kThreads / 32; ++w) {
    if (warp == w && group == 0) {
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int c = sub + j * kLanes;
        if (c >= chunks) continue;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int col = c * kVec + e;
          acc[0][col] = (w == 0 ? 0.0f : acc[0][col]) + dw[j * kVec + e];
          acc[1][col] = (w == 0 ? 0.0f : acc[1][col]) + db[j * kVec + e];
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * width;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    out[i] = acc[0][i];
    out[width + i] = acc[1][i];
  }
}

// dweight and dbias from the (blocks, 2, width) partials: column i of the
// 2 x width, summed over the blocks by kSumSlices slices (slice s takes
// blocks s, s + kSumSlices, ...), then the slices in order.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    layer_norm_rows_bwd_sum_kernel(const float* __restrict__ partial,
                                   int blocks, int width, T* __restrict__ dw,
                                   T* __restrict__ db) {
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int cols = 2 * width;
  float s = 0.0f;
  if (col < cols) {
#pragma unroll 4
    for (int b = slice; b < blocks; b += kSumSlices)
      s += partial[static_cast<long long>(b) * cols + col];
  }
  __shared__ float sums[kSumSlices][33];
  sums[slice][lane] = s;
  __syncthreads();
  if (slice != 0 || col >= cols) return;
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < kSumSlices; ++k) total += sums[k][lane];
  if (col < width)
    dw[col] = from_float<T>(total);
  else
    db[col - width] = from_float<T>(total);
}

// One launch of the row kernel for a plan (dispatch's L).
struct Backward {
  template <typename T, int kVec, int kLanes, int kCpl>
  static cudaError_t run(const void* x, const void* dy, const float* mean,
                         const float* rstd, const void* w, void* dx,
                         float* partial, long long rows, int width, int grid,
                         cudaStream_t stream) {
    layer_norm_rows_bwd_kernel<T, kVec, kLanes, kCpl, rows_per_thread(kCpl)>
        <<<grid, kThreads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(dy), mean, rstd,
            static_cast<const T*>(w), static_cast<T*>(dx), partial, rows,
            width);
    return cudaGetLastError();
  }
};

template <typename T>
cudaError_t backward(const Plan& p, const void* x, const void* dy,
                     const float* mean, const float* rstd, const void* w,
                     void* dx, void* dw, void* db, float* partial,
                     long long rows, int width, int grid, cudaStream_t s) {
  cudaError_t err = dispatch<T, Backward>(p, x, dy, mean, rstd, w, dx,
                                          partial, rows, width, grid, s);
  if (err != cudaSuccess) return err;
  const int sum_grid = (2 * width + 31) / 32;
  layer_norm_rows_bwd_sum_kernel<T><<<sum_grid, kSumThreads, 0, s>>>(
      partial, grid, width, static_cast<T*>(dw), static_cast<T*>(db));
  return cudaGetLastError();
}

}  // namespace

// The plan of the row kernel's launch over `rows` rows on the current
// device, as layer_norm_rows_plan gives the forward's; its grid is the
// number of partials.
extern "C" int layer_norm_rows_bwd_plan(int dtype, long long rows, int width,
                                        int* out) {
  return plan_of(dtype, rows, width, true, out);
}

// dtype 0 fp32, 1 bf16. `partial_blocks` is the partial buffer's rows of
// 2 x width; fewer than the plan's grid is refused.
extern "C" int layer_norm_rows_bwd(int dtype, const void* x, const void* dy,
                                   const float* mean, const float* rstd,
                                   const void* w, void* dx, void* dw, void* db,
                                   float* partial, long long partial_blocks,
                                   long long rows, int width, void* stream) {
  Plan p;
  const int itemsize = itemsize_of(dtype);
  if (!itemsize || rows < 0 || !make_plan(itemsize, width, &p))
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = static_cast<uintptr_t>(p.vec * itemsize);
  for (const void* ptr : {x, dy, w, static_cast<const void*>(dx)})
    if (reinterpret_cast<uintptr_t>(ptr) % align)
      return (int)cudaErrorMisalignedAddress;
  int sms;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int grid = grid_for(p, rows, sms, true);
  if (partial_blocks < grid) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)backward<float>(p, x, dy, mean, rstd, w, dx, dw, db, partial,
                                rows, width, grid, s);
  return (int)backward<__nv_bfloat16>(p, x, dy, mean, rstd, w, dx, dw, db,
                                      partial, rows, width, grid, s);
}

extern "C" const char* layer_norm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
