// Fused SwiGLU FFN, forward: out = (silu(x Wg) * (x Wu)) Wd, for x (m, d),
// Wg and Wu (d, f), Wd (f, d). Every input is widened to float32, the three
// products and silu(g) * u are taken in float32, and the output is cast to
// x's dtype.
//
// Replaces the Pallas TPU kernel `swiglu_pallas` (src/repro/kernels/
// swiglu.py:48), whose grid runs (m blocks, f blocks) with the f axis
// sequential: each f block's h = silu(x Wg) * (x Wu) tile is formed in
// VMEM and multiplied into a (block_m, d) float32 accumulator that stays in
// VMEM scratch, so the (m, f) intermediate h never reaches HBM. On the card
// a (block_m, d) float32 accumulator does not fit a CTA (64 rows of d 4096
// are 1 MB), so this kernel takes the split-f design: CTA (m block of BM
// rows, split p) walks its share of the f axis in groups of FG columns;
// for each group it forms the (BM, FG) h tile in shared memory (K loop over
// d, float32 FMAs), then multiplies it into the (BM, d) partial output of
// split p, which lives in a float32 workspace in device memory (read,
// added, written back a group; the first group writes). A second pass adds
// the P splits' partial outputs in split order and casts to x's dtype. h
// stays on chip; what crosses device memory is the float32 partial output,
// P (m, d) tiles and their read-modify-writes, in place of the TPU's VMEM
// accumulator. Each output's sum over f runs in f order within a group,
// group after group, split after split: another order than cuBLAS's, so the
// tolerance against the plain version is stated per dtype.
//
// Bound: at the Jamba dense-FFN prefill shape (m 8192, d 4096, f 14336) the
// function is 3 products of 2 m d f = 2.886e12 FLOPs: 2.92 ms at the tensor
// cores' 989 TFLOP/s in bf16 (bf16 x bf16 products are exact in float32,
// so the gate and up products could run there with float32 accumulation;
// the down product's h is float32, and rounding it to bf16 would change
// the function), 43 ms at the CUDA cores' 67 TFLOP/s in float32. This
// kernel runs all three products as float32 FMAs on the CUDA cores, so 43
// ms is its own floor; the tensor cores (mma.sync or wgmma for the gate and
// up products, a three-piece bf16 split of h for the down product) are the
// first redesign. Bytes (x, the weights and out once, 0.49 GB in bf16,
// 0.145 ms) are far below either.
//
// Tiles: 256 threads, each a 4 x 4 micro-tile. Phase 1, per 64-column
// slice of the group: x (BM 64 x BK 16, stored transposed and padded) and
// Wg, Wu (16 x 64) through shared memory, 32 FMAs per k a thread (g and u).
// h = g * sigmoid(g) * u into the (FG 256 x BM 64) h tile. Phase 2, per
// 64-column chunk of d: Wd (64 x 64) tiles through shared memory over the
// group's 256 rows, 16 FMAs per k a thread, then the read-modify-write of
// the (64 x 64) partial output. Rows past m, columns past f and d are
// masked (loaded as zeros, never stored). x and the weights are float32 or
// bfloat16 of one dtype; the workspace is float32 (splits, m, d).
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 64;   // rows of x a CTA
constexpr int BF = 64;   // f columns of a phase-1 slice
constexpr int FG = 256;  // f columns of a group (rows of the h tile)
constexpr int BK = 16;   // the phase-1 K step over d
constexpr int BD = 64;   // d columns of a phase-2 chunk
constexpr int XPAD = BM + 4;  // the transposed x tile's row stride (banks)

constexpr int SMEM_FLOATS = BK * XPAD + 2 * BK * BF + FG * XPAD + BF * BD;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
swiglu_split_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                    const T* __restrict__ wu, const T* __restrict__ wd,
                    float* __restrict__ ws, int m, int d, int f, int groups_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [BK][XPAD]: x transposed
  float* gs = xs + BK * XPAD;        // [BK][BF]
  float* us = gs + BK * BF;          // [BK][BF]
  float* hs = us + BK * BF;          // [FG][XPAD]: h transposed (f, row)
  float* wds = hs + FG * XPAD;       // [BF][BD]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // micro-tile rows 4 ty.., columns 4 tx..
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int ngroups = (f + FG - 1) / FG;
  const int g_begin = split * groups_per_split;
  const int g_end = min(ngroups, g_begin + groups_per_split);
  float* wsp = ws + (long long)split * m * d;

  for (int grp = g_begin; grp < g_end; ++grp) {
    const int f_group = grp * FG;
    // -- phase 1: the (BM, FG) h tile, 64 f columns at a time -------------
    for (int sl = 0; sl < FG; sl += BF) {
      const int f0 = f_group + sl;
      float ag[4][4], au[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ag[i][j] = au[i][j] = 0.f;
      for (int k0 = 0; k0 < d; k0 += BK) {
        // x tile: thread e loads row e / 16, column e % 16 (4 rows apart)
#pragma unroll
        for (int q = 0; q < BM * BK / THREADS; ++q) {
          const int e = tid + q * THREADS;
          const int r = e / BK, kk = e % BK;
          const int row = m0 + r, col = k0 + kk;
          xs[kk * XPAD + r] =
              (row < m && col < d) ? to_float(x[(long long)row * d + col]) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < BK * BF / THREADS; ++q) {
          const int e = tid + q * THREADS;
          const int kk = e / BF, c = e % BF;
          const int k = k0 + kk, col = f0 + c;
          const bool in = k < d && col < f;
          gs[kk * BF + c] = in ? to_float(wg[(long long)k * f + col]) : 0.f;
          us[kk * BF + c] = in ? to_float(wu[(long long)k * f + col]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 av = *reinterpret_cast<const float4*>(xs + kk * XPAD + 4 * ty);
          const float4 gv = *reinterpret_cast<const float4*>(gs + kk * BF + 4 * tx);
          const float4 uv = *reinterpret_cast<const float4*>(us + kk * BF + 4 * tx);
          const float a4[4] = {av.x, av.y, av.z, av.w};
          const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
          const float u4[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              ag[i][j] += a4[i] * g4[j];
              au[i][j] += a4[i] * u4[j];
            }
        }
        __syncthreads();
      }
      // h = silu(g) * u = (g * sigmoid(g)) * u, stored transposed: hs[f][row]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float h4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float g = ag[i][j];
          h4[i] = (g * (1.f / (1.f + expf(-g)))) * au[i][j];
        }
        *reinterpret_cast<float4*>(hs + (sl + 4 * tx + j) * XPAD + 4 * ty) =
            make_float4(h4[0], h4[1], h4[2], h4[3]);
      }
    }
    __syncthreads();

    // -- phase 2: partial output (BM, d) += h (BM, FG) . Wd[group rows] ----
    for (int d0 = 0; d0 < d; d0 += BD) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int kb = 0; kb < FG; kb += BF) {
#pragma unroll
        for (int q = 0; q < BF * BD / THREADS; ++q) {
          const int e = tid + q * THREADS;
          const int kk = e / BD, c = e % BD;
          const int k = f_group + kb + kk, col = d0 + c;
          wds[kk * BD + c] = (k < f && col < d) ? to_float(wd[(long long)k * d + col]) : 0.f;
        }
        __syncthreads();
#pragma unroll 16
        for (int kk = 0; kk < BF; ++kk) {
          const float4 hv = *reinterpret_cast<const float4*>(hs + (kb + kk) * XPAD + 4 * ty);
          const float4 wv = *reinterpret_cast<const float4*>(wds + kk * BD + 4 * tx);
          const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
          const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += h4[i] * w4[j];
        }
        __syncthreads();
      }
      // the split's running sum over its groups, in group order
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + 4 * ty + i;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = d0 + 4 * tx + j;
          if (col >= d) continue;
          float* o = wsp + (long long)row * d + col;
          *o = grp == g_begin ? acc[i][j] : *o + acc[i][j];
        }
      }
    }
    __syncthreads();  // the next group overwrites the h tile
  }
}

// out = (T)(ws[0] + ws[1] + ... + ws[splits - 1]), in split order
template <typename T>
__global__ void swiglu_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out,
                                     long long count, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int p = 1; p < splits; ++p) s += ws[p * count + i];
    from_float(s, out + i);
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd, void* ws,
           void* out, int m, int d, int f, int splits, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(swiglu_split_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int ngroups = (f + FG - 1) / FG;
  const int per = (ngroups + splits - 1) / splits;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)splits);
  swiglu_split_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<const T*>(wd), static_cast<float*>(ws), m, d, f, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long count = (long long)m * d;
  const long long blocks = (count + 255) / 256;
  swiglu_reduce_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), count, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (m, d); wg, wu: (d, f); wd: (f, d), all float32 (bf16 = 0) or bfloat16
// (bf16 = 1), contiguous; ws: float32 (splits, m, d) workspace; out: (m, d)
// in x's dtype. Every split must own at least one group of FG f columns:
// splits <= ceil(f / FG), and the wrapper takes splits with
// ceil(ceil(f / FG) / splits) * (splits - 1) < ceil(f / FG).
extern "C" int swiglu_fwd(int bf16, const void* x, const void* wg, const void* wu,
                          const void* wd, void* ws, void* out, int m, int d, int f,
                          int splits, void* stream) {
  if (m <= 0 || d <= 0) return 0;
  const int ngroups = (f + FG - 1) / FG;
  if (f <= 0 || splits <= 0 || splits > ngroups) return (int)cudaErrorInvalidValue;
  const int per = (ngroups + splits - 1) / splits;
  if (per * (splits - 1) >= ngroups) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, wg, wu, wd, ws, out, m, d, f, splits, s)
              : launch<float>(x, wg, wu, wd, ws, out, m, d, f, splits, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
