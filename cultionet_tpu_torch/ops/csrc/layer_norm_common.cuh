// What the LayerNorm kernels over narrow rows share (layer_norm_fwd.cu, the
// forward #8 and its training form with statistics; layer_norm_bwd.cu, its
// backward): the launch plan, which holds a row in chunks of the widest
// load across a group of lanes, and the chunk's loads and stores in fp32.
//
// A row of `width` elements is read in chunks of kVec elements, the widest
// load (16, 8, 4 or 2 bytes) whose element count divides the width, and
// held by a group of kLanes lanes (a power of two, at most 32), so one warp
// holds 32 / kLanes rows side by side; lane `sub` of a group holds the
// row's chunks sub, sub + kLanes, ... (kCpl of them, the ones past the row
// masked). Each thread takes kRows rows, so a block's tile is
// 8 warps x kRows x (32 / kLanes) rows; within a warp row r of group g is
// the tile's row warp * kRows * groups + r * groups + g. The block walks
// tiles with a stride of the grid. ops/layer_norm_cuda.py::launch_plan
// mirrors make_plan and grid_for for the CPU tests.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunksPerLane = 8;  // so at most 32 x 8 chunks a row
constexpr int kChunksInFlight = 4;    // a thread's rows x chunks a lane

// Blocks an SM keeps resident at `cpl` chunks a lane: what the launch
// bounds ask registers to fit, and so what the grid holds. The backward
// holds x, dy and its column sums, twice the forward's registers.
__host__ __device__ constexpr int blocks_per_sm(int cpl, bool backward) {
  return backward ? (cpl == 1 ? 2 : 1) : (cpl == 1 ? 4 : 2);
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
// the kernels do not take the width.
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
int grid_for(const Plan& p, long long rows, int sms, bool backward) {
  const long long tiles = (rows + p.block_rows - 1) / p.block_rows;
  const long long resident =
      static_cast<long long>(sms) * blocks_per_sm(p.cpl, backward);
  const long long grid = tiles < resident ? tiles : resident;
  return static_cast<int>(grid < 1 ? 1 : grid);
}

int itemsize_of(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

cudaError_t sm_count(int* sms) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// The plan of a launch over `rows` rows on the current device, as
// {elements a chunk, lanes a row, chunks a lane, rows a thread, rows a
// tile, grid}.
int plan_of(int dtype, long long rows, int width, bool backward, int* out) {
  Plan p;
  const int itemsize = itemsize_of(dtype);
  if (!itemsize || rows < 0 || !make_plan(itemsize, width, &p))
    return (int)cudaErrorInvalidValue;
  int sms;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int plan[6] = {p.vec,
                       p.lanes,
                       p.cpl,
                       p.rows_per_thread,
                       p.block_rows,
                       grid_for(p, rows, sms, backward)};
  for (int i = 0; i < 6; ++i) out[i] = plan[i];
  return 0;
}

// Calls L::run<T, kVec, kLanes, kCpl>(args...) for the plan's lanes and
// chunks a lane: every plan make_plan gives for kVec elements a chunk, one
// chunk a lane up to 32 lanes, then 32 lanes with 2, 4 or 8 chunks a lane.
template <typename T, typename L, int kVec, typename... Args>
cudaError_t dispatch_lanes(const Plan& p, Args... args) {
#define LN_CASE(LANES, CPL)            \
  if (p.lanes == LANES && p.cpl == CPL) \
    return L::template run<T, kVec, LANES, CPL>(args...);
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

// The same for the plan's elements a chunk: 16, 8 or 4 bytes, and for
// bf16 also 2.
template <typename T, typename L, typename... Args>
cudaError_t dispatch(const Plan& p, Args... args) {
  constexpr int kWidest = 16 / sizeof(T);
  switch (p.vec) {
    case kWidest:
      return dispatch_lanes<T, L, kWidest>(p, args...);
    case kWidest / 2:
      return dispatch_lanes<T, L, kWidest / 2>(p, args...);
    case kWidest / 4:
      return dispatch_lanes<T, L, kWidest / 4>(p, args...);
  }
  if constexpr (kWidest == 8) {
    if (p.vec == 1) return dispatch_lanes<T, L, 1>(p, args...);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
