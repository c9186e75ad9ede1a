// GQA flash attention, forward: online softmax over kv tiles, causal with an
// optional sliding window.
//
//   out[b, i, h, :] = sum_j p_ij v[b, j, h / G, :],
//   p_ij = softmax_j(q[b, i, h, :] . k[b, j, h / G, :] / sqrt(d)) over the
//   allowed j: j < Skv, and j <= i when causal, and i - j < window when a
//   window is given (query and key positions both start at 0).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:91), which runs a grid of
// (batch, head, q block, kv block) with the kv axis sequential, keeps the
// running max m, sum l and accumulator in VMEM scratch across kv steps, and
// skips whole kv blocks beyond the causal frontier or outside the window. The
// arithmetic is the same: scores in float32 divided by sqrt(d), masked
// entries set to the finite -1e30, p = exp(s - m_new) zeroed where masked,
// l and the accumulator rescaled by exp(m_prev - m_new), and at the end
// acc / max(l, 1e-30), so a row with nothing to attend to gives 0. The TPU
// wrapper shrinks its blocks to a divisor of S; here the tiles are fixed
// (64 query rows, 64 key rows) and the ragged edge is masked: key rows past
// Skv are zero in shared memory and masked, query rows past Sq are computed
// and not stored.
//
// Bound: at the prefill shapes of Llama-3.2-3B (B 4, S 2048, 24 query / 8 kv
// heads, d 128, causal) the work is 4 B H S^2 d / 2 = 103 GFLOP; at the
// card's 989 TFLOP/s bf16 tensor-core peak that is 0.10 ms, while the bytes
// (q, k, v read once, out written once: 0.13 GB in bf16) take 0.04 ms at
// 3.35 TB/s. So the bound is operations, and a kernel reaching it runs on
// the tensor cores (wgmma, TMA, pipelined tiles). This first version is the
// simple one: float32 fused multiply-adds on the CUDA cores, whose peak is
// 67 TFLOP/s, so it is at best ~15x above that bound. The tensor-core
// version is later work.
//
// Design: one CTA of 256 threads per (b * H + h, 64-row query block); the
// query blocks with the most causal work are scheduled first. The CTA keeps
// its query tile in shared memory as float32, transposed ([d][64]), and
// walks the live kv tiles in order: K transposed ([d][64]) and V ([64][d])
// are staged through shared memory as float32 (bf16 converted on load, 16
// bytes a thread a load). Thread (ty, tx) of a 16 x 16 grid computes a 4 x 4
// block of scores (query rows 4 ty .. 4 ty + 3, key columns 4 tx .. 4 tx +
// 3) from one float4 of each tile a step, reduces row maxima across its 16
// lanes with shuffles, and writes its probabilities transposed into the
// shared memory K used (PT, [64][68]); then it adds P V into its 4 x d/16
// outputs (columns tx + 16 j). Each thread keeps its own share of l, which
// is reduced across the 16 lanes once at the end. d is a template argument
// (64, 80, 128); operands are float32 or bfloat16, statistics and
// accumulator float32, the output in the operands' dtype (bf16 rounded to
// nearest even, as torch's cast is). Shared memory: 96 KB at d 128, two
// CTAs an SM.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows a CTA
constexpr int BK = 64;            // key rows a kv tile
constexpr int THREADS = 256;      // 16 x 16
constexpr int PT_STRIDE = BQ + 4; // floats a row of PT; keeps float4 rows aligned
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int VEC = 4;  // elements in 16 bytes
  static __device__ void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ float store(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ void load(const __nv_bfloat16* p, float* x) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};

template <int D>
__host__ __device__ constexpr int kt_floats() {
  return D * BK > BK * PT_STRIDE ? D * BK : BK * PT_STRIDE;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(D * BQ + kt_floats<D>() + BK * D);
}

__device__ __forceinline__ bool allowed(int qpos, int kpos, int skv, int causal,
                                        int window) {
  bool ok = kpos < skv;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

// Rows [start, start + ROWS) of one head of x (row stride `row` elements)
// into shared memory as float32, transposed: dst[col * ROWS + r]. Rows past
// `limit` are zero. Neighbouring threads take neighbouring rows, so the
// stores fall in distinct banks.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_transposed(const T* __restrict__ x, long long row,
                                                int start, int limit, float* dst) {
  constexpr int VEC = Io<T>::VEC;
  for (int idx = threadIdx.x; idx < ROWS * (D / VEC); idx += THREADS) {
    const int r = idx % ROWS, c = idx / ROWS;
    float v[VEC];
    if (start + r < limit) {
      Io<T>::load(x + (start + r) * row + c * VEC, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[(c * VEC + e) * ROWS + r] = v[e];
  }
}

// The same rows kept row-major: dst[r * D + col].
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, long long row, int start,
                                          int limit, float* dst) {
  constexpr int VEC = Io<T>::VEC;
  for (int idx = threadIdx.x; idx < BK * (D / VEC); idx += THREADS) {
    const int c = idx % (D / VEC), r = idx / (D / VEC);
    float v[VEC];
    if (start + r < limit) {
      Io<T>::load(x + (start + r) * row + c * VEC, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      *reinterpret_cast<float4*>(dst + r * D + c * VEC + e) =
          make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
                       int h, int kvh, int causal, int window) {
  constexpr int NJ = D / 16;  // output columns a thread
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][BQ]
  float* kT = qT + D * BQ;                      // [D][BK]; PT [BK][PT_STRIDE] after the scores
  float* vs = kT + kt_floats<D>();              // [BK][D]
  float* pT = kT;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h, kh = hh / (h / kvh);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const float sqrt_d = sqrtf((float)D);

  const long long q_row = (long long)h * D, kv_row = (long long)kvh * D;
  const T* q0 = q + ((long long)b * sq * h + hh) * D;
  const T* k0 = k + ((long long)b * skv * kvh + kh) * D;
  const T* v0 = v + ((long long)b * skv * kvh + kh) * D;

  load_transposed<T, D, BQ>(q0, q_row, q_start, sq, qT);

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  const int nk = (skv + BK - 1) / BK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k_start = kb * BK;
    // the TPU kernel's block skip test (flash_attention.py:50-54)
    bool live = true;
    if (causal) live = live && k_start <= q_start + BQ - 1;
    if (window > 0) live = live && k_start + BK - 1 >= q_start - window + 1;
    if (!live) continue;

    __syncthreads();  // the last tile's P V is done with PT and V
    load_transposed<T, D, BK>(k0, kv_row, k_start, skv, kT);
    load_rows<T, D>(v0, kv_row, k_start, skv, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 a = reinterpret_cast<const float4*>(qT + kk * BQ)[ty];
      const float4 c = reinterpret_cast<const float4*>(kT + kk * BK)[tx];
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + ty * 4 + i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = allowed(qpos, k_start + tx * 4 + j, skv, causal, window);
        s[i][j] = ok ? s[i][j] / sqrt_d : NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = allowed(qpos, k_start + tx * 4 + j, skv, causal, window);
        p[i][j] = ok ? expf(s[i][j] - m_new) : 0.0f;
        rsum += p[i][j];
      }
      l[i] = l[i] * corr + rsum;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading K before PT overwrites it
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * PT_STRIDE + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pp = reinterpret_cast<const float4*>(pT + c * PT_STRIDE)[ty];
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    li = fmaxf(li, 1e-30f);
    const int qpos = q_start + ty * 4 + i;
    if (qpos < sq) {
      T* o = out + (((long long)b * sq + qpos) * h + hh) * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[tx + 16 * j] = Io<T>::store(acc[i][j] / li);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv,
           int h, int kvh, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + BQ - 1) / BQ));
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, h, kvh, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* out, int b, int sq,
             int skv, int h, int kvh, int causal, int window, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, out, b, sq, skv, h, kvh, causal, window, stream);
    case 80:
      return launch<T, 80>(q, k, v, out, b, sq, skv, h, kvh, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, sq, skv, h, kvh, causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, sq, h, d), k and v: (b, skv, kvh, d), out: (b, sq, h, d), all
// contiguous and 16-byte aligned, float32 (bf16 = 0) or bfloat16 (bf16 = 1).
// window <= 0 means no window.
extern "C" int flash_attention_fwd(int bf16, const void* q, const void* k, const void* v,
                                   void* out, int b, int sq, int skv, int h, int kvh, int d,
                                   int causal, int window, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0) return (int)cudaErrorInvalidValue;
  if ((long long)(sq + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, out, b, sq, skv, h, kvh, causal, window, s)
              : dispatch<float>(d, q, k, v, out, b, sq, skv, h, kvh, causal, window, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
