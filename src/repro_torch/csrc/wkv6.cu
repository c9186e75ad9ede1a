// RWKV-6 WKV recurrence, forward, with its final state. Per (batch b, head h),
// with the state S (hd x hd) and every step t:
//
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// starting from s0 (or zeros); s_last is S after the last step.
//
// Replaces the Pallas TPU kernel `wkv6_pallas` (src/repro/kernels/wkv6.py:58),
// which runs a grid of (batch, head, time chunk) with the time axis
// sequential and keeps the (hd, hd) state in VMEM scratch across chunks,
// walking each chunk's steps as rank-1 updates. On the card nothing carries
// over between blocks, so one CTA owns one (b, h) and walks every step
// itself: the sequential grid axis becomes the CTA's loop over t.
//
// Inputs are converted to float32 and every product is taken there, as the
// Pallas kernel's are. The bonus term is split off the sum, which takes
// fewer operations than the Pallas kernel's form:
//
//   y_j = sum_i r_i S_ij + v_j c,  c = sum_i r_i u_i k_i,
//   S_ij = w_i S_ij + k_i v_j,
//
// so a (i, j) pair costs one multiply and two fused multiply-adds, and c
// is O(hd) a step. nvcc contracts the multiply-adds into fused ones, so
// products round where the plain version's separate ones do not, and y is
// summed in another order (below); the tolerance against the plain version
// is 1e-5 of max(1, |plain|) in float32.
//
// Bound: at the full-width RWKV-6 7B prefill (B 4, S 2048, H 64, hd 64)
// there are 33.55 M (b, t, h, j) elements; r, k, v in bf16, w and y in
// float32 are 14 bytes an element, ~474 MB with the state read and written
// once: 0.141 ms at 3.35 TB/s. The least work is the form above: 5
// float32 operations per (b, h, t, i, j) (r_i S_ij summed, w_i S_ij +
// k_i v_j) and 5 per (b, h, t, j) (c, then v_j c added), 1.09e10 in all:
// 0.163 ms at the CUDA cores' 67 TFLOP/s. So with bf16 inputs the kernel
// is bound by operations, on the CUDA cores (the recurrence has no matrix
// product for the tensor cores in this step-by-step form); float32 inputs
// move 20 bytes an element and are bound by bytes (0.200 ms). A decode
// launch (S = 1) reads and writes the 4.2 MB state: ~2.5 us.
//
// Design: one CTA of 2 hd threads per (b, h). The state is cut into tiles of
// hd / 8 rows by 4 columns: thread (cb, rg) owns columns 4 cb .. 4 cb + 3 and
// rows rg, rg + 8, rg + 16, ... as float32 registers, loaded from s0 once
// and stored to s_last once (float4 a row). A thread reads its own tile of
// s0 before it writes the same tile of s_last and no thread touches
// another's, so s_last may alias s0: decode updates the cache's state in
// place this way. A step stages (r_i, k_i, w_i, r_i u_i k_i) as one float4
// per i and v as float4s of four columns in shared memory, double-buffered
// so that one __syncthreads() a step suffices (a buffer is written at step
// t only after every thread has passed step t - 1's barrier, hence
// finished reading it at step t - 2). A thread then reads one float4 per
// row it owns and uses it for its four columns, and the 8 row groups'
// partial sums of y (each with its rows' part of c) are added across lanes
// (xor shuffles); y is summed over i in another order than the plain
// version's. The first hd threads load the inputs DEPTH steps ahead into
// registers of their own type (a bf16 value is widened only when it is
// staged, so the load is not waited for early). hd is a template argument
// (32, 64, 128); r, k, v are float32 or bfloat16, w, u, s0, y and s_last
// float32, every pointer 16-byte aligned.
//
// Why tiles: a thread that owns a whole column reads all hd float4s a step,
// 16 bytes of shared memory per (i, j) pair, and the shared memory's
// bandwidth then bounds the step; a 4-column tile reads 4 bytes per pair.
// Why typed registers: widening a bf16 value right after its load makes
// the thread wait for the load there, which undoes the prefetch.
//
// Occupancy is the known weak point: at the full-width prefill there are
// 256 CTAs of 4 warps on 132 SMs, and the 2048 steps are a dependent chain.
// Chunked forms on the tensor cores (wgmma) are later work.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int RG = 8;     // row groups: lanes that share a column block
constexpr int CJ = 4;     // columns a thread owns
constexpr int DEPTH = 8;  // steps loaded ahead

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int HD>
constexpr int threads() { return RG * HD / CJ; }

// r, k, v and w are read without __restrict__, so that their loads stay
// ahead of the barriers as written and the prefetch holds.
template <typename T, int HD>
__global__ void __launch_bounds__(threads<HD>())
wkv6_kernel(const T* r, const T* k, const T* v, const float* w,
            const float* __restrict__ u,
            const float* s0,  // may alias s_last: not __restrict__
            float* __restrict__ y, float* s_last, int seq, int h) {
  constexpr int R = HD / RG;  // rows a thread owns
  __shared__ float4 buf[2][HD];       // (r_i, k_i, w_i, r_i u_i k_i)
  __shared__ float4 vbuf[2][HD / 4];  // v_j, four columns a float4
  const int tid = threadIdx.x;
  const int rg = tid % RG;
  const int cb = tid / RG;
  const bool loader = tid < HD;  // thread e < hd loads and stages element e
  const int bh = blockIdx.x;     // b * h + head
  const int head = bh % h;
  const long long b = bh / h;
  const long long step = (long long)h * HD;                   // elements between steps
  const long long base = b * seq * step + (long long)head * HD;  // (b, 0, head, 0)
  const long long sbase = (long long)bh * HD * HD + cb * CJ;     // (bh, 0, 4 cb)

  float s[R][CJ];  // s[q][c] = S[q * RG + rg][cb * CJ + c]
  if (s0 != nullptr) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float4 x =
          *reinterpret_cast<const float4*>(s0 + sbase + (long long)(q * RG + rg) * HD);
      s[q][0] = x.x; s[q][1] = x.y; s[q][2] = x.z; s[q][3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int c = 0; c < CJ; ++c) s[q][c] = 0.f;
  }
  const float ue = loader ? u[head * HD + tid] : 0.f;

  T rn[DEPTH], kn[DEPTH], vn[DEPTH];
  float wn[DEPTH];
  auto load = [&](int d, int t) {
    const long long off = base + (long long)t * step + tid;
    rn[d] = r[off];
    kn[d] = k[off];
    wn[d] = w[off];
    vn[d] = v[off];
  };
  if (loader) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d)
      if (d < seq) load(d, d);
  }
  for (int t0 = 0; t0 < seq; t0 += DEPTH) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int t = t0 + d;
      if (t >= seq) break;  // the same t in every thread
      if (loader) {
        const float re = to_float(rn[d]), ke = to_float(kn[d]);
        buf[t & 1][tid] = make_float4(re, ke, wn[d], re * ue * ke);
        reinterpret_cast<float*>(vbuf[t & 1])[tid] = to_float(vn[d]);
        if (t + DEPTH < seq) load(d, t + DEPTH);
      }
      __syncthreads();
      const float4* cur = buf[t & 1];
      const float4 vq = vbuf[t & 1][cb];
      const float vj[CJ] = {vq.x, vq.y, vq.z, vq.w};
      float acc[CJ] = {0.f, 0.f, 0.f, 0.f};
      float c = 0.f;  // this thread's rows' part of sum_i r_i u_i k_i
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float4 e = cur[q * RG + rg];  // r_i, k_i, w_i, r_i u_i k_i
        c += e.w;
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj) {
          acc[jj] += e.x * s[q][jj];
          s[q][jj] = e.z * s[q][jj] + e.y * vj[jj];
        }
      }
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        acc[jj] += vj[jj] * c;
#pragma unroll
        for (int o = 1; o < RG; o *= 2) acc[jj] += __shfl_xor_sync(0xffffffffu, acc[jj], o);
      }
      if (rg == 0)
        *reinterpret_cast<float4*>(y + base + (long long)t * step + cb * CJ) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }

#pragma unroll
  for (int q = 0; q < R; ++q)
    *reinterpret_cast<float4*>(s_last + sbase + (long long)(q * RG + rg) * HD) =
        make_float4(s[q][0], s[q][1], s[q][2], s[q][3]);
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* y, void* s_last, int b, int seq, int h,
           cudaStream_t stream) {
  wkv6_kernel<T, HD><<<(unsigned)(b * h), threads<HD>(), 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(y), static_cast<float*>(s_last),
      seq, h);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* s_last, int b, int seq, int h,
             cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, y, s_last, b, seq, h, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, y, s_last, b, seq, h, stream);
    case 128:
      return launch<T, 128>(r, k, v, w, u, s0, y, s_last, b, seq, h, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v: (b, seq, h, hd), float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// w: (b, seq, h, hd) float32; u: (h, hd) float32; s0: (b, h, hd, hd)
// float32 or null (zeros); y: (b, seq, h, hd) float32; s_last: (b, h, hd, hd)
// float32, may be s0. All contiguous and 16-byte aligned.
extern "C" int wkv6_fwd(int bf16, const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0, void* y,
                        void* s_last, int b, int seq, int h, int hd, void* stream) {
  if (b <= 0 || h <= 0) return 0;
  if (seq < 0 || (long long)b * h > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(hd, r, k, v, w, u, s0, y, s_last, b, seq, h, s)
              : dispatch<float>(hd, r, k, v, w, u, s0, y, s_last, b, seq, h, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
