// LayerNorm over the contiguous last axis of narrow rows, forward, for
// Hopper (sm_90a): y = (x - mean) * rsqrt(var + eps) * weight + bias per
// row of `width` elements, mean and biased variance in fp32, the output
// rounded once to the input type, as torch.nn.functional.layer_norm does.
// Its training form (layer_norm_rows_fwd_train, the template flag kStats)
// also writes each row's mean and rstd in fp32, 8 bytes a row, which the
// backward (layer_norm_bwd.cu) reads.
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel for LayerNorm
// (XLA fuses it on the TPU). It was added for the transformer temporal front
// end's eval forward (models/temporal.py::TemporalTransformer), whose rows
// are one pixel's step of D = 64 channels: (B * H * W * T) rows of 128 bytes
// in bf16, 1.9 million of them in a predict batch. PyTorch's kernel gives
// each row a whole thread block, so nearly all of its threads idle, and it
// ran at 7.5% of its byte bound there. The training form serves the same
// rows in training, and TSViT's (models/tsvit.py) token rows of 128.
//
// Bound on the card: bytes. Each row is read once and written once; the
// math is a few operations per element. The design keeps the memory system
// busy and moves nothing twice:
//  - A row is read in chunks of the widest load that divides it and held
//    by a group of lanes (layer_norm_common.cuh). Neighbouring lanes read
//    neighbouring chunks, and the groups of a warp read neighbouring rows:
//    at D = 64 in bf16 (8 lanes of 16 bytes) one load instruction of the
//    warp covers 512 contiguous bytes.
//  - Each thread issues the loads of kRows rows before it reduces any of
//    them, so enough bytes are in flight to cover the memory's latency.
//  - The mean, then the centred sum of squares, are reduced across each
//    row's lane group with xor shuffles, in fp32, from the values held in
//    registers: two passes over registers, one over memory.
//  - weight and bias are loaded once per thread and stay in registers.
//  - The grid holds as many blocks as the SMs keep resident (the launch
//    bounds' blocks_per_sm); each block walks tiles of rows with a stride of
//    the grid, the rows past the end masked.
// The library chooses the launch plan (layer_norm_common.cuh's make_plan
// and grid_for) from the type and the width; ops/layer_norm_cuda.py::
// launch_plan mirrors it for the CPU tests, and the card tests hold the two
// equal through layer_norm_rows_plan.
// Inputs: x and y contiguous (rows, width), weight and bias (width,), all of
// one type (fp32 or bf16), aligned to the chunk's bytes; a width of at most
// 256 chunks; mean and rstd fp32 (rows,). The wrapper checks all of it.

#include "layer_norm_common.cuh"

#include <initializer_list>

namespace {

// kVec elements a chunk, kLanes lanes a row, kCpl chunks a lane, kRows
// rows a thread (layer_norm_common.cuh); with kStats each row's mean and
// rstd are written too.
template <typename T, int kVec, int kLanes, int kCpl, int kRows, bool kStats>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kCpl, false))
    layer_norm_rows_kernel(const T* __restrict__ x,
                           const T* __restrict__ weight,
                           const T* __restrict__ bias, T* __restrict__ y,
                           float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, long long rows,
                           int width, float eps) {
  using C = Chunk<T, kVec>;
  using Raw = typename C::Raw;
  constexpr int kGroups = 32 / kLanes;
  constexpr int kWarpRows = kGroups * kRows;
  constexpr int kBlockRows = (kThreads / 32) * kWarpRows;
  const int lane = threadIdx.x & 31;
  const int group = lane / kLanes;
  const int sub = lane % kLanes;
  const int chunks = width / kVec;
  const float inv_width = 1.0f / static_cast<float>(width);
  const Raw* xv = reinterpret_cast<const Raw*>(x);
  Raw* yv = reinterpret_cast<Raw*>(y);

  Raw w[kCpl], b[kCpl];
#pragma unroll
  for (int j = 0; j < kCpl; ++j) {
    const int c = sub + j * kLanes;
    const bool valid = c < chunks;
    w[j] = valid ? __ldg(reinterpret_cast<const Raw*>(weight) + c) : Raw{};
    b[j] = valid ? __ldg(reinterpret_cast<const Raw*>(bias) + c) : Raw{};
  }

  const long long tiles = (rows + kBlockRows - 1) / kBlockRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 =
        tile * kBlockRows + (threadIdx.x >> 5) * kWarpRows + group;
    Raw v[kRows][kCpl];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long row = row0 + r * kGroups;
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int c = sub + j * kLanes;
        v[r][j] = (row < rows && c < chunks) ? __ldg(xv + row * chunks + c)
                                             : Raw{};
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long row = row0 + r * kGroups;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        float f[kVec];
        C::load(v[r][j], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) sum += f[e];
      }
      const float mean = group_sum<kLanes>(sum) * inv_width;
      float squares = 0.0f;
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        if (sub + j * kLanes >= chunks) continue;
        float f[kVec];
        C::load(v[r][j], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float d = f[e] - mean;
          squares += d * d;
        }
      }
      const float rstd =
          rsqrtf(group_sum<kLanes>(squares) * inv_width + eps);
      if (row >= rows) continue;
      if constexpr (kStats) {
        if (sub == 0) {
          mean_out[row] = mean;
          rstd_out[row] = rstd;
        }
      }
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int c = sub + j * kLanes;
        if (c >= chunks) continue;
        float f[kVec], wf[kVec], bf[kVec];
        C::load(v[r][j], f);
        C::load(w[j], wf);
        C::load(b[j], bf);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          f[e] = wf[e] * ((f[e] - mean) * rstd) + bf[e];
        yv[row * chunks + c] = C::store(f);
      }
    }
  }
}

// One launch of the kernel for a plan (dispatch's L).
template <bool kStats>
struct Forward {
  template <typename T, int kVec, int kLanes, int kCpl>
  static cudaError_t run(const void* x, const void* w, const void* b, void* y,
                         float* mean, float* rstd, long long rows, int width,
                         float eps, int grid, cudaStream_t stream) {
    layer_norm_rows_kernel<T, kVec, kLanes, kCpl, rows_per_thread(kCpl),
                           kStats><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<T*>(y), mean, rstd, rows, width,
        eps);
    return cudaGetLastError();
  }
};

template <bool kStats>
int forward(int dtype, const void* x, const void* w, const void* b, void* y,
            float* mean, float* rstd, long long rows, int width, float eps,
            void* stream) {
  Plan p;
  const int itemsize = itemsize_of(dtype);
  if (!itemsize || rows < 0 || !make_plan(itemsize, width, &p))
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = static_cast<uintptr_t>(p.vec * itemsize);
  for (const void* ptr : {x, w, b, static_cast<const void*>(y)})
    if (reinterpret_cast<uintptr_t>(ptr) % align)
      return (int)cudaErrorMisalignedAddress;
  if (rows == 0) return 0;
  int sms;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int grid = grid_for(p, rows, sms, false);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, Forward<kStats>>(p, x, w, b, y, mean, rstd, rows,
                                            width, eps, grid, s);
  return dispatch<__nv_bfloat16, Forward<kStats>>(p, x, w, b, y, mean, rstd,
                                                  rows, width, eps, grid, s);
}

}  // namespace

// The plan of a launch over `rows` rows on the current device, as
// {elements a chunk, lanes a row, chunks a lane, rows a thread, rows a
// tile, grid}; what layer_norm_rows_fwd and layer_norm_rows_fwd_train
// launch.
extern "C" int layer_norm_rows_plan(int dtype, long long rows, int width,
                                    int* out) {
  return plan_of(dtype, rows, width, false, out);
}

// dtype 0 fp32, 1 bf16.
extern "C" int layer_norm_rows_fwd(int dtype, const void* x, const void* w,
                                   const void* b, void* y, long long rows,
                                   int width, float eps, void* stream) {
  return forward<false>(dtype, x, w, b, y, nullptr, nullptr, rows, width, eps,
                        stream);
}

// The same, also writing each row's mean and rstd (fp32, rows each).
extern "C" int layer_norm_rows_fwd_train(int dtype, const void* x,
                                         const void* w, const void* b, void* y,
                                         float* mean, float* rstd,
                                         long long rows, int width, float eps,
                                         void* stream) {
  return forward<true>(dtype, x, w, b, y, mean, rstd, rows, width, eps,
                       stream);
}

extern "C" const char* layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
