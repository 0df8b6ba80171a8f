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
// Bound on the card: operations. The two products, 2 * N * C * 4C at the
// bf16 tensor-core rate, plus the attention's 4 * N * C * k^2 at the fp32
// rate, outweigh x read, out written and the bf16 weights at the model's
// C = 256 (chip_smoke.py::na_block_bound_ms). This first version does not
// reach that: it runs two launches and keeps q, k and v in an fp32 scratch
// buffer in device memory (12 C bytes per pixel written and read again),
// and its attention step is SIMT code, one thread per (pixel, head).
//
// Design (simple first version, both launches over tiles of 64 pixels, 8
// warps):
//  (a) ln_qkv_kernel: LN1 by warp reductions into a bf16 tile in shared
//      memory, then the tile times w_qkv on the tensor cores (WMMA bf16
//      16x16x16, fp32 accumulators; w_qkv read straight from device memory,
//      where L2 keeps it), 128 output columns per pass, staged in shared
//      memory to add the bias and the q scale and to write q, k, v
//      coalesced to the scratch buffer.
//  (b) attn_proj_ln_kernel: one thread per (pixel, head) of the tile: its
//      k*k logits, softmax and weighted sum of v from the scratch buffer
//      (16-byte loads where head_dim % 4 == 0, in the same order of
//      summation), attn rounded to bf16 in shared memory; then the tile
//      times w_proj on the tensor cores into an fp32 tile in shared memory;
//      then LN2 by warp reductions.
// Channels are padded to Cp, a multiple of 16 (the WMMA depth), by the
// wrapper (ops/na_block_cuda.py), which zero-fills the padded rows and
// columns of the weights and biases; the kernel zero-fills the padded
// columns of its bf16 tiles, so padding adds nothing to any sum.

#include <math.h>
#include <mma.h>

#include "na2d_common.cuh"

namespace {

using namespace na2d;
using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // pixels per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kChunk = 128;  // GEMM output columns per pass
constexpr int kMaxChannels = 512;

struct BlockParams {
  const float* ln1_scale;
  const float* ln1_bias;
  const bf16* w_qkv;  // (Cp, 3 Cp): q, k, v column groups of Cp each
  const float* b_qkv;  // (3 Cp)
  const bf16* w_proj;  // (Cp, Cp)
  const float* b_proj;
  const float* ln2_scale;
  const float* ln2_bias;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One pass of the tile product: rows 0..63 of the bf16 tile `a` (leading
// dimension lda) times columns [c0, c0 + 128) of the row-major bf16 matrix
// `w` (kdim x ncols), stored as fp32 into `out` at column (col - out0).
// Warp w owns row fragment w % 4 and four column fragments of half w / 4.
__device__ __forceinline__ void tile_gemm(const bf16* a, int lda,
                                          const bf16* w, int ncols, int kdim,
                                          int c0, float* out, int ldo,
                                          int out0, int warp) {
  const int rf = warp & 3;
  const int cb = c0 + (warp >> 2) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    wmma::load_matrix_sync(fa, a + rf * 16 * lda + k0, lda);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = cb + i * 16;
      if (col < ncols) {
        wmma::load_matrix_sync(fb, w + (long long)k0 * ncols + col, ncols);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = cb + i * 16;
    if (col < ncols)
      wmma::store_matrix_sync(out + rf * 16 * ldo + (col - out0), acc[i], ldo,
                              wmma::mem_row_major);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_qkv_kernel(const T* __restrict__ x, BlockParams p,
                  float* __restrict__ qkv, long long npix, int C, int Cp,
                  float scale, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = Cp + 8;
  const int lds = kChunk + 4;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  float* stage =
      reinterpret_cast<float*>(smem + (size_t)kTile * lda * sizeof(bf16));
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long tile0 = (long long)blockIdx.x * kTile;

  // LN1: one warp per pixel, two passes over its row (the second from L1).
  for (int r = warp; r < kTile; r += kWarps) {
    const long long g = tile0 + r;
    bf16* row = tile + r * lda;
    if (g >= npix) {
      for (int c = lane; c < lda; c += kWarp) row[c] = __float2bfloat16(0.f);
      continue;
    }
    const T* xr = x + g * C;
    float s = 0.f;
    for (int c = lane; c < C; c += kWarp) s += to_float(xr[c]);
    const float mean = warp_sum(s) / (float)C;
    float ss = 0.f;
    for (int c = lane; c < C; c += kWarp) {
      const float d = to_float(xr[c]) - mean;
      ss += d * d;
    }
    const float rstd = rsqrtf(warp_sum(ss) / (float)C + eps);
    for (int c = lane; c < lda; c += kWarp) {
      float y = 0.f;
      if (c < C)
        y = __fadd_rn(__fmul_rn(__fmul_rn(to_float(xr[c]) - mean, rstd),
                                p.ln1_scale[c]),
                      p.ln1_bias[c]);
      row[c] = __float2bfloat16(y);
    }
  }
  __syncthreads();

  const int ncols = 3 * Cp;
  for (int c0 = 0; c0 < ncols; c0 += kChunk) {
    tile_gemm(tile, lda, p.w_qkv, ncols, Cp, c0, stage, lds, c0, warp);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int col = c0 + i % kChunk;
      const long long g = tile0 + r;
      if (col < ncols && g < npix) {
        float val = stage[r * lds + i % kChunk] + p.b_qkv[col];
        if (col < Cp) val *= scale;
        qkv[g * ncols + col] = val;
      }
    }
    __syncthreads();
  }
}

template <typename T, int KS>
__global__ void __launch_bounds__(kThreads)
    attn_proj_ln_kernel(const float* __restrict__ qkv, BlockParams p,
                        T* __restrict__ out, long long npix, int H, int W,
                        int C, int Cp, int heads, int dil, float eps) {
  constexpr int KK = KS * KS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = Cp + 8;
  const int ldo = Cp + 4;
  bf16* attn = reinterpret_cast<bf16*>(smem);
  float* proj =
      reinterpret_cast<float*>(smem + (size_t)kTile * lda * sizeof(bf16));
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long tile0 = (long long)blockIdx.x * kTile;
  const int D = C / heads;
  const int ncols = 3 * Cp;
  // 16-byte loads where every head's row is 16-byte aligned: rows start at
  // multiples of 3 Cp floats (Cp % 16 == 0) and heads at multiples of D.
  const bool vec = D % 4 == 0;

  for (int i = threadIdx.x; i < kTile * lda; i += kThreads) {
    const int r = i / lda;
    if (i % lda >= C || tile0 + r >= npix) attn[i] = __float2bfloat16(0.f);
  }

  // Attention: one thread per (pixel, head) of the tile.
  for (int item = threadIdx.x; item < kTile * heads; item += kThreads) {
    const int r = item / heads;
    const int n = item % heads;
    const long long g = tile0 + r;
    if (g >= npix) continue;
    const int w = (int)(g % W);
    const long long t = g / W;
    const int h = (int)(t % H);
    const long long b = t / H;
    const int h0 = window_start(h, H, KS, dil);
    const int w0 = window_start(w, W, KS, dil);
    const float* qp = qkv + g * ncols + n * D;

    long long nbr[KK];
    float wts[KK];
    float m = -INFINITY;
#pragma unroll
    for (int jh = 0; jh < KS; ++jh) {
#pragma unroll
      for (int jw = 0; jw < KS; ++jw) {
        const int j = jh * KS + jw;
        nbr[j] = ((b * H + h0 + dil * jh) * W + w0 + dil * jw) * ncols +
                 n * D;
        const float* kp = qkv + nbr[j] + Cp;
        float dot = 0.f;
        if (vec) {
          for (int d = 0; d < D; d += 4) {
            const float4 a = *reinterpret_cast<const float4*>(qp + d);
            const float4 c = *reinterpret_cast<const float4*>(kp + d);
            dot += round_bf16(a.x * c.x);
            dot += round_bf16(a.y * c.y);
            dot += round_bf16(a.z * c.z);
            dot += round_bf16(a.w * c.w);
          }
        } else {
          for (int d = 0; d < D; ++d) dot += round_bf16(qp[d] * kp[d]);
        }
        wts[j] = dot;
        m = fmaxf(m, dot);
      }
    }
    float denom = 0.f;
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      wts[j] = expf(wts[j] - m);
      denom += wts[j];
    }
    const float inv = 1.0f / denom;
#pragma unroll
    for (int j = 0; j < KK; ++j) wts[j] *= inv;

    bf16* ar = attn + r * lda + n * D;
    if (vec) {
      for (int d = 0; d < D; d += 4) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < KK; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              qkv + nbr[j] + 2 * Cp + d);
          acc.x += wts[j] * v.x;
          acc.y += wts[j] * v.y;
          acc.z += wts[j] * v.z;
          acc.w += wts[j] * v.w;
        }
        ar[d] = __float2bfloat16(acc.x);
        ar[d + 1] = __float2bfloat16(acc.y);
        ar[d + 2] = __float2bfloat16(acc.z);
        ar[d + 3] = __float2bfloat16(acc.w);
      }
    } else {
      for (int d = 0; d < D; ++d) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < KK; ++j) acc += wts[j] * qkv[nbr[j] + 2 * Cp + d];
        ar[d] = __float2bfloat16(acc);
      }
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < Cp; c0 += kChunk)
    tile_gemm(attn, lda, p.w_proj, Cp, Cp, c0, proj, ldo, 0, warp);
  __syncthreads();

  // + b_proj, then LN2: one warp per pixel; each lane owns its channels.
  for (int r = warp; r < kTile; r += kWarps) {
    const long long g = tile0 + r;
    if (g >= npix) continue;
    float* row = proj + r * ldo;
    float s = 0.f;
    for (int c = lane; c < C; c += kWarp) {
      const float val = row[c] + p.b_proj[c];
      row[c] = val;
      s += val;
    }
    const float mean = warp_sum(s) / (float)C;
    float ss = 0.f;
    for (int c = lane; c < C; c += kWarp) {
      const float d = row[c] - mean;
      ss += d * d;
    }
    const float rstd = rsqrtf(warp_sum(ss) / (float)C + eps);
    T* orow = out + g * C;
    for (int c = lane; c < C; c += kWarp)
      orow[c] = from_float<T>(__fadd_rn(
          __fmul_rn(__fmul_rn(row[c] - mean, rstd), p.ln2_scale[c]),
          p.ln2_bias[c]));
  }
}

size_t tile_bytes(int Cp, int cols) {
  return (size_t)kTile * (Cp + 8) * sizeof(bf16) +
         (size_t)kTile * (cols + 4) * sizeof(float);
}

template <typename T, int KS>
int launch(const void* x, const BlockParams& p, float* qkv, void* out,
           long long npix, int H, int W, int C, int Cp, int heads, int dil,
           float eps, cudaStream_t stream) {
  const long long blocks = (npix + kTile - 1) / kTile;
  const size_t smem_a = tile_bytes(Cp, kChunk);
  const size_t smem_b = tile_bytes(Cp, Cp);
  cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_proj_ln_kernel<T, KS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  // head_dim^-0.5 rounded once from double, as the host frameworks round it.
  const float scale = (float)(1.0 / sqrt((double)(C / heads)));
  ln_qkv_kernel<T><<<(unsigned)blocks, kThreads, smem_a, stream>>>(
      static_cast<const T*>(x), p, qkv, npix, C, Cp, scale, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_proj_ln_kernel<T, KS><<<(unsigned)blocks, kThreads, smem_b, stream>>>(
      qkv, p, static_cast<T*>(out), npix, H, W, C, Cp, heads, dil, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_ks(int ks, const void* x, const BlockParams& p, float* qkv,
                void* out, long long npix, int H, int W, int C, int Cp,
                int heads, int dil, float eps, cudaStream_t stream) {
  if (ks == 1)
    return launch<T, 1>(x, p, qkv, out, npix, H, W, C, Cp, heads, dil, eps,
                        stream);
  return launch<T, 3>(x, p, qkv, out, npix, H, W, C, Cp, heads, dil, eps,
                      stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). x and out are contiguous
// (B, H, W, C). The weights are bf16 and padded to Cp channels (a multiple
// of 16, Cp >= C): w_qkv (Cp, 3 Cp) with q, k, v in column groups of Cp,
// w_proj (Cp, Cp); b_qkv (3 Cp) and the other vectors (C) are fp32. qkv is
// an fp32 scratch buffer of B * H * W * 3 Cp. kernel_size is 1 or 3.
// Returns a cudaError_t (0 = launched).
extern "C" int na_block_fwd(int dtype, const void* x, const float* ln1_scale,
                            const float* ln1_bias, const void* w_qkv,
                            const float* b_qkv, const void* w_proj,
                            const float* b_proj, const float* ln2_scale,
                            const float* ln2_bias, float* qkv, void* out,
                            int B, int H, int W, int C, int Cp, int heads,
                            int ks, int dil, float eps, void* stream) {
  if (C < 1 || heads < 1 || C % heads || Cp < C || Cp % 16 ||
      Cp > kMaxChannels || (ks != 1 && ks != 3) || dil < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  if ((H < W ? H : W) < ks * dil) return (int)cudaErrorInvalidValue;
  const BlockParams p{ln1_scale, ln1_bias,
                      static_cast<const bf16*>(w_qkv), b_qkv,
                      static_cast<const bf16*>(w_proj), b_proj,
                      ln2_scale, ln2_bias};
  const long long npix = (long long)B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_ks<float>(ks, x, p, qkv, out, npix, H, W, C, Cp, heads,
                              dil, eps, s);
  if (dtype == 1)
    return dispatch_ks<bf16>(ks, x, p, qkv, out, npix, H, W, C, Cp, heads,
                             dil, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* na_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
