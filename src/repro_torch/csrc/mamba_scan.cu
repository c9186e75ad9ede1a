// Mamba (S6) selective scan, forward, with its final state. Per batch row b,
// channel d and state n, with the state h (D x N) and every step t:
//
//   h[d][n] <- exp(dt_t[d] a[d][n]) h[d][n] + (dt_t[d] x_t[d]) B_t[n]
//   y_t[d]   = sum_n h[d][n] C_t[n]
//
// starting from h0 (or zeros); h_last is h after the last step.
//
// Replaces the Pallas TPU kernel `mamba_scan_pallas`
// (src/repro/kernels/mamba_scan.py:61), which runs a grid of (batch,
// channel block, time chunk) with the time axis sequential and keeps the
// (block_d, N) state in VMEM scratch across chunks. On the card blocks run
// in no order and nothing carries over between them, so one thread owns one
// (b, d) pair and walks every step itself, its N float32 states in
// registers: the sequential grid axis becomes the thread's loop over t.
// Inputs are converted to float32 and every product is taken there, as the
// Pallas kernel's are. nvcc contracts h*da + u*B into one fused
// multiply-add, so a product rounds where the plain version's separate ones
// do not, and y is summed over n in another order than the plain version's
// einsum; the tolerance against the plain version is 1e-5 of
// max(1, |plain|).
//
// Bound: at the Jamba prefill shape (B 4, S 2048, D 8192, N 16) the
// function reads dt and x (B, S, D) and writes y (B, S, D): with dt and y in
// float32 and x in bf16, 10 bytes a (b, t, d), 671 MB (B, C, A and the
// state add ~1 MB): 0.200 ms at 3.35 TB/s (x in float32: 805 MB, 0.240 ms).
// The least work is 1.07e9 (b, t, d, n) elements, each dt a (1 multiply),
// its exponential, h da + u B (2) and the y sum (2), 6 FP32 operations
// counting the exponential as one, plus u = dt x a (b, t, d): 6.5e9 in
// all, 0.097 ms at the CUDA cores' 67 TFLOP/s. So by the card's published
// rates the function is bound by bytes. The exponentials are the catch:
// the card's special-function unit (MUFU) issues 16 of them a clock an SM,
// 4.2e12/s at 1.98 GHz, so 1.07e9 exponentials take 0.257 ms there if each
// is one MUFU.EX2 (an IEEE-accurate expf, as built here without
// --use_fast_math, adds ~7 FP32 instructions of range reduction to it).
// Unless some exponentials move to polynomials on the FMA pipes, the SFU,
// and not the memory, sets the floor.
//
// Design: a CTA of 128 threads owns 128 neighbouring channels of one batch
// row (grid: channel blocks x batch). dt and x load coalesced across the
// channels, a chunk of TC steps ahead into registers of their own type (a
// bf16 x is widened only when it is used: widening right after the load
// makes the thread wait for it there). B_t and C_t, shared by every channel
// of a row, are staged through shared memory once a chunk (TC N floats
// each, contiguous in memory, float4 loads), double-buffered so that one
// __syncthreads() a chunk suffices: a buffer is written at the end of chunk
// c only after every thread has passed chunk c - 1's barrier, hence
// finished reading it. Every thread reads the same B_t and C_t float4s
// (broadcast). y_t is the thread's own sum over n in registers (two
// partial sums for the latency of the adds); no shuffle. A thread reads its
// own h0 row before it writes the same h_last row and no thread touches
// another's, so h_last may alias h0: a caller updates a state in place this
// way. Ragged S and D are masked (threads past D stage and wait, but load
// and store nothing of their own). N is a template argument (4, 8, 16, 32);
// x is float32 or bfloat16, everything else float32, every pointer 16-byte
// aligned.
//
// Occupancy is the weak point: at the prefill shape there are 32,768
// threads, 256 CTAs of 4 warps on 132 SMs (about 8 warps an SM); latency is
// hidden by the N independent state chains and the loads issued a chunk
// ahead, not by other warps.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // channels a CTA
constexpr int TC = 16;        // steps a chunk: staged, loaded ahead, one barrier

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// dt, x, b and c are read without __restrict__, so that their loads stay
// ahead of the barriers as written and the prefetch holds.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* dt, const T* x, const float* bm, const float* cm,
                  const float* __restrict__ a,
                  const float* h0,  // may alias h_last: not __restrict__
                  float* __restrict__ y, float* h_last, int seq, int dim) {
  constexpr int V = TC * N / 4;                               // float4s of B (or C) a chunk
  constexpr int PER = (2 * V + THREADS - 1) / THREADS;        // float4s a thread stages
  __shared__ __align__(16) float sbc[2][2][TC * N];           // [buffer][B, C][t * N + n]
  const int tid = threadIdx.x;
  const int d = blockIdx.x * THREADS + tid;
  const bool live = d < dim;
  const long long row = (long long)blockIdx.y * seq;          // (b, t = 0)
  const float* dtp = dt + row * dim + d;
  const T* xp = x + row * dim + d;
  float* yp = y + row * dim + d;
  const float* bp = bm + row * N;
  const float* cp = cm + row * N;

  float av[N], h[N];
#pragma unroll
  for (int n = 0; n < N; n += 4) {
    float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vh = va;
    if (live) {
      va = *reinterpret_cast<const float4*>(a + (long long)d * N + n);
      if (h0 != nullptr)
        vh = *reinterpret_cast<const float4*>(h0 + ((long long)blockIdx.y * dim + d) * N + n);
    }
    av[n] = va.x; av[n + 1] = va.y; av[n + 2] = va.z; av[n + 3] = va.w;
    h[n] = vh.x; h[n + 1] = vh.y; h[n + 2] = vh.z; h[n + 3] = vh.w;
  }

  float4 stage[PER];
  auto fetch_bc = [&](int t0) {
    const int have = (seq - t0 < TC ? seq - t0 : TC) * (N / 4);  // float4s that exist
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      if (e < 2 * V) {
        const int j = e % V;
        const float* src = (e < V ? bp : cp) + (long long)t0 * N;
        stage[i] = j < have ? reinterpret_cast<const float4*>(src)[j]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  auto store_bc = [&](int buf) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      if (e < 2 * V) reinterpret_cast<float4*>(sbc[buf][e / V])[e % V] = stage[i];
    }
  };
  float dtc[TC], dtn[TC];
  T xc[TC], xn[TC];
#pragma unroll
  for (int i = 0; i < TC; ++i) {
    dtn[i] = 0.f;
    xn[i] = T(0.f);
  }
  auto fetch_dx = [&](int t0) {  // the chunk from t0 into dtn, xn
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      if (live && t0 + i < seq) {
        dtn[i] = dtp[(long long)(t0 + i) * dim];
        xn[i] = xp[(long long)(t0 + i) * dim];
      }
    }
  };
  auto advance = [&]() {  // the fetched chunk becomes the current one
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      dtc[i] = dtn[i];
      xc[i] = xn[i];
    }
  };

  if (seq > 0) {
    fetch_bc(0);
    fetch_dx(0);
    store_bc(0);
    advance();
  }
  __syncthreads();
  int buf = 0;
  for (int t0 = 0; t0 < seq; t0 += TC) {
    const bool more = t0 + TC < seq;  // the same in every thread
    if (more) {
      fetch_bc(t0 + TC);
      fetch_dx(t0 + TC);
    }
    const float* sb = sbc[buf][0];
    const float* sc = sbc[buf][1];
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      if (t0 + i >= seq) break;  // the same t in every thread
      const float dtv = dtc[i];
      const float u = dtv * to_float(xc[i]);
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 bv = *reinterpret_cast<const float4*>(sb + i * N + n);
        const float4 cv = *reinterpret_cast<const float4*>(sc + i * N + n);
        h[n] = h[n] * expf(dtv * av[n]) + u * bv.x;
        h[n + 1] = h[n + 1] * expf(dtv * av[n + 1]) + u * bv.y;
        h[n + 2] = h[n + 2] * expf(dtv * av[n + 2]) + u * bv.z;
        h[n + 3] = h[n + 3] * expf(dtv * av[n + 3]) + u * bv.w;
        y0 += h[n] * cv.x;
        y1 += h[n + 1] * cv.y;
        y0 += h[n + 2] * cv.z;
        y1 += h[n + 3] * cv.w;
      }
      if (live) yp[(long long)(t0 + i) * dim] = y0 + y1;
    }
    if (more) {
      store_bc(buf ^ 1);
      advance();
    }
    __syncthreads();
    buf ^= 1;
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < N; n += 4)
      *reinterpret_cast<float4*>(h_last + ((long long)blockIdx.y * dim + d) * N + n) =
          make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
  }
}

template <typename T, int N>
int launch(const void* dt, const void* x, const void* b, const void* c, const void* a,
           const void* h0, void* y, void* h_last, int batch, int seq, int dim,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((dim + THREADS - 1) / THREADS), (unsigned)batch);
  mamba_scan_kernel<T, N><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(x), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(a),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(h_last),
      seq, dim);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int n, const void* dt, const void* x, const void* b, const void* c,
             const void* a, const void* h0, void* y, void* h_last, int batch, int seq,
             int dim, cudaStream_t stream) {
  switch (n) {
    case 4:
      return launch<T, 4>(dt, x, b, c, a, h0, y, h_last, batch, seq, dim, stream);
    case 8:
      return launch<T, 8>(dt, x, b, c, a, h0, y, h_last, batch, seq, dim, stream);
    case 16:
      return launch<T, 16>(dt, x, b, c, a, h0, y, h_last, batch, seq, dim, stream);
    case 32:
      return launch<T, 32>(dt, x, b, c, a, h0, y, h_last, batch, seq, dim, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dt: (batch, seq, dim) float32; x: (batch, seq, dim), float32 (x_bf16 = 0)
// or bfloat16 (x_bf16 = 1); b, c: (batch, seq, n) float32; a: (dim, n)
// float32; h0: (batch, dim, n) float32 or null (zeros); y: (batch, seq, dim)
// float32; h_last: (batch, dim, n) float32, may be h0. All contiguous and
// 16-byte aligned.
extern "C" int mamba_scan_fwd(int x_bf16, const void* dt, const void* x, const void* b,
                              const void* c, const void* a, const void* h0, void* y,
                              void* h_last, int batch, int seq, int dim, int n,
                              void* stream) {
  if (batch <= 0 || dim <= 0) return 0;
  if (seq < 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return x_bf16 ? dispatch<__nv_bfloat16>(n, dt, x, b, c, a, h0, y, h_last, batch, seq, dim, s)
                : dispatch<float>(n, dt, x, b, c, a, h0, y, h_last, batch, seq, dim, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
