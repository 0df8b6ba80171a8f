// LayerNorm over the contiguous last axis of narrow rows, forward only, for
// Hopper (sm_90a): y = (x - mean) * rsqrt(var + eps) * weight + bias per
// row of `width` elements, mean and biased variance in fp32, the output
// rounded once to the input type, as torch.nn.functional.layer_norm does.
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel for LayerNorm
// (XLA fuses it on the TPU). It was added for the transformer temporal front
// end's eval forward (models/temporal.py::TemporalTransformer), whose rows
// are one pixel's step of D = 64 channels: (B * H * W * T) rows of 128 bytes
// in bf16, 1.9 million of them in a predict batch. PyTorch's kernel gives
// each row a whole thread block, so nearly all of its threads idle, and it
// ran at 7.5% of its byte bound there.
//
// Bound on the card: bytes. Each row is read once and written once; the
// math is a few operations per element. The design keeps the memory system
// busy and moves nothing twice:
//  - A row is read in chunks of kVec elements, the widest load (16, 8, 4 or
//    2 bytes) whose element count divides the width, and held by a group of
//    kLanes lanes (a power of two, at most 32), so one warp holds
//    32 / kLanes rows side by side. Neighbouring lanes read neighbouring
//    chunks, and the groups of a warp read neighbouring rows: at D = 64 in
//    bf16 (8 lanes of 16 bytes) one load instruction of the warp covers 512
//    contiguous bytes.
//  - Each thread issues the loads of kRows rows before it reduces any of
//    them, so enough bytes are in flight to cover the memory's latency.
//  - The mean, then the centred sum of squares, are reduced across each
//    row's lane group with xor shuffles, in fp32, from the values held in
//    registers: two passes over registers, one over memory.
//  - weight and bias are loaded once per thread and stay in registers.
//  - The grid holds as many blocks as the SMs keep resident (the launch
//    bounds' blocks_per_sm); each block walks tiles of rows with a stride of
//    the grid, the rows past the end masked.
// The launch plan (make_plan, grid_for) is chosen here, from the type and
// the width; ops/layer_norm_cuda.py::launch_plan mirrors it for the CPU
// tests, and the card tests hold the two equal through layer_norm_rows_plan.
// Inputs: x and y contiguous (rows, width), weight and bias (width,), all of
// one type (fp32 or bf16), aligned to the chunk's bytes; a width of at most
// 256 chunks. The wrapper checks all of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunksPerLane = 8;  // so at most 32 x 8 chunks a row
constexpr int kChunksInFlight = 4;    // a thread's rows x chunks a lane

// Blocks an SM keeps resident at `cpl` chunks a lane: what the launch
// bounds ask registers to fit, and so what the grid holds.
__host__ __device__ constexpr int blocks_per_sm(int cpl) {
  return cpl == 1 ? 4 : 2;
}

// Rows a thread at `cpl` chunks a lane: kChunksInFlight chunks in flight.
__host__ __device__ constexpr int rows_per_thread(int cpl) {
  return cpl < kChunksInFlight ? kChunksInFlight / cpl : 1;
}

template <int kBytes>
struct RawOf;
template <>
struct RawOf<16> {
  using type = uint4;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<4> {
  using type = unsigned int;
};
template <>
struct RawOf<2> {
  using type = unsigned short;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// kVec elements of T as one load (Raw), and as fp32 values.
template <typename T, int kVec>
struct Chunk {
  using Raw = typename RawOf<kVec * sizeof(T)>::type;
  static constexpr bool kPairs =
      std::is_same<T, __nv_bfloat16>::value && kVec % 2 == 0;

  __device__ __forceinline__ static void load(const Raw& raw, float* f) {
    if constexpr (kPairs) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec / 2; ++e) {
        const float2 p = __bfloat1622float2(h[e]);
        f[2 * e] = p.x;
        f[2 * e + 1] = p.y;
      }
    } else {
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = to_float(v[e]);
    }
  }
  __device__ __forceinline__ static Raw store(const float* f) {
    Raw raw;
    if constexpr (kPairs) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec / 2; ++e)
        h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    } else {
      T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = from_float<T>(f[e]);
    }
    return raw;
  }
};

// The sum of v over each aligned group of kLanes lanes, in every lane of it.
template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int offset = kLanes / 2; offset > 0; offset /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// kVec elements a chunk, kLanes lanes a row, kCpl chunks a lane (the row's
// chunk c lies in lane c % kLanes), kRows rows a thread. A block's tile is
// 8 warps x kRows x (32 / kLanes) rows; within a warp row r of group g is
// the tile's row warp * kRows * groups + r * groups + g.
template <typename T, int kVec, int kLanes, int kCpl, int kRows>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kCpl))
    layer_norm_rows_kernel(const T* __restrict__ x,
                           const T* __restrict__ weight,
                           const T* __restrict__ bias, T* __restrict__ y,
                           long long rows, int width, float eps) {
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

// One launch's plan: elements a chunk, lanes a row, chunks a lane, rows a
// thread, and the rows of a block's tile.
struct Plan {
  int vec, lanes, cpl, rows_per_thread, block_rows;
};

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// The plan for rows of `width` elements of `itemsize` bytes; false where
// the kernel does not take the width.
bool make_plan(int itemsize, int width, Plan* p) {
  if (width < 1) return false;
  int vec = 16 / itemsize;
  while (width % vec) vec /= 2;
  const int chunks = width / vec;
  const int lanes = chunks < 32 ? pow2_at_least(chunks) : 32;
  const int cpl = pow2_at_least((chunks + lanes - 1) / lanes);
  if (cpl > kMaxChunksPerLane) return false;
  p->vec = vec;
  p->lanes = lanes;
  p->cpl = cpl;
  p->rows_per_thread = rows_per_thread(cpl);
  p->block_rows = kThreads / 32 * (32 / lanes) * p->rows_per_thread;
  return true;
}

// Blocks of the launch: the tiles, at most what the SMs keep resident.
int grid_for(const Plan& p, long long rows, int sms) {
  const long long tiles = (rows + p.block_rows - 1) / p.block_rows;
  const long long resident =
      static_cast<long long>(sms) * blocks_per_sm(p.cpl);
  const long long grid = tiles < resident ? tiles : resident;
  return static_cast<int>(grid < 1 ? 1 : grid);
}

template <typename T, int kVec, int kLanes, int kCpl>
cudaError_t launch_one(const void* x, const void* w, const void* b, void* y,
                       long long rows, int width, float eps, int grid,
                       cudaStream_t stream) {
  layer_norm_rows_kernel<T, kVec, kLanes, kCpl, rows_per_thread(kCpl)>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const T*>(b), static_cast<T*>(y), rows, width, eps);
  return cudaGetLastError();
}

// Every plan make_plan gives for kVec elements a chunk: one chunk a lane up
// to 32 lanes, then 32 lanes with 2, 4 or 8 chunks a lane.
template <typename T, int kVec>
cudaError_t dispatch_lanes(const Plan& p, const void* x, const void* w,
                           const void* b, void* y, long long rows, int width,
                           float eps, int grid, cudaStream_t s) {
#define LN_CASE(L, P)                    \
  if (p.lanes == L && p.cpl == P)        \
    return launch_one<T, kVec, L, P>(x, w, b, y, rows, width, eps, grid, s);
  LN_CASE(1, 1)
  LN_CASE(2, 1)
  LN_CASE(4, 1)
  LN_CASE(8, 1)
  LN_CASE(16, 1)
  LN_CASE(32, 1)
  LN_CASE(32, 2)
  LN_CASE(32, 4)
  LN_CASE(32, 8)
#undef LN_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const Plan& p, const void* x, const void* w,
                     const void* b, void* y, long long rows, int width,
                     float eps, int grid, cudaStream_t s) {
  constexpr int kWidest = 16 / sizeof(T);
  switch (p.vec) {
    case kWidest:
      return dispatch_lanes<T, kWidest>(p, x, w, b, y, rows, width, eps,
                                        grid, s);
    case kWidest / 2:
      return dispatch_lanes<T, kWidest / 2>(p, x, w, b, y, rows, width, eps,
                                            grid, s);
    case kWidest / 4:
      return dispatch_lanes<T, kWidest / 4>(p, x, w, b, y, rows, width, eps,
                                            grid, s);
  }
  if constexpr (kWidest == 8) {
    if (p.vec == 1)
      return dispatch_lanes<T, 1>(p, x, w, b, y, rows, width, eps, grid, s);
  }
  return cudaErrorInvalidValue;
}

int itemsize_of(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

cudaError_t sm_count(int* sms) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

// The plan of a launch over `rows` rows on the current device, as
// {elements a chunk, lanes a row, chunks a lane, rows a thread, rows a
// tile, grid}; what layer_norm_rows_fwd launches.
extern "C" int layer_norm_rows_plan(int dtype, long long rows, int width,
                                    int* out) {
  Plan p;
  const int itemsize = itemsize_of(dtype);
  if (!itemsize || rows < 0 || !make_plan(itemsize, width, &p))
    return (int)cudaErrorInvalidValue;
  int sms;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int plan[6] = {p.vec,           p.lanes,      p.cpl,
                       p.rows_per_thread, p.block_rows, grid_for(p, rows, sms)};
  for (int i = 0; i < 6; ++i) out[i] = plan[i];
  return 0;
}

// dtype 0 fp32, 1 bf16.
extern "C" int layer_norm_rows_fwd(int dtype, const void* x, const void* w,
                                   const void* b, void* y, long long rows,
                                   int width, float eps, void* stream) {
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
  const int grid = grid_for(p, rows, sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(p, x, w, b, y, rows, width, eps, grid, s);
  return dispatch<__nv_bfloat16>(p, x, w, b, y, rows, width, eps, grid, s);
}

extern "C" const char* layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
