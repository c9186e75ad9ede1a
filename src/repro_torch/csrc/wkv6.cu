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
// over between blocks, so a CTA walks the time axis itself.
//
// Two kernels, one launch a call: wkv6_fwd takes the chunk kernel for
// S >= CHUNKED_MIN_SEQ and the step kernel below it (decode is S = 1, whose
// chunk form would be all tail). The threshold is where the chunk kernel's
// device time falls below the step kernel's in both dtypes at the RWKV-6 7B
// shape (tools/wkv6_threshold.py: from S = 48 on, on an H100).
//
// Bound: at the full-width RWKV-6 7B prefill (B 4, S 2048, H 64, hd 64)
// there are 33.55 M (b, t, h, j) elements; r, k, v in bf16, w and y in
// float32 are 14 bytes an element, ~474 MB with the state read and written
// once: 0.141 ms at 3.35 TB/s. The least work is the step form's: 5 float32
// operations per (b, h, t, i, j) (r_i S_ij summed, w_i S_ij + k_i v_j) and 5
// per (b, h, t, j), 1.09e10 in all: 0.163 ms at the CUDA cores' 67 TFLOP/s.
// So with bf16 inputs the function is bound by operations; float32 inputs
// move 20 bytes an element and are bound by bytes (0.200 ms). A decode
// launch (S = 1) reads and writes the 4.2 MB state: ~2.5 us.
//
// The step kernel (`step::wkv6_kernel`, the first version): one CTA of
// 2 hd threads per (b, h), each step a rank-1 update of the state held in
// registers, with one __syncthreads() a step; the 2048 steps of a prefill
// are a dependent chain (~430 ns a step on the card), 256 CTAs on 132 SMs.
// Details at the kernel.
//
// The chunk kernel (`chunk::chunk_kernel`, in wkv6_chunk.cuh, which the
// backward runs too): the chunked form of models/rwkv6.py's wkv_chunked, on
// the tensor cores. Under a gradient the forward also writes the state after
// each chunk but the last for the backward (its own instantiation: the
// serve's carries no code for it; y and s_last are the same bits either
// way). Chunks of CHUNK = 64
// rows, sub-chunks of SUB = 16, each in two halves of 8. Within a chunk,
// with a product of w's written P(a, b) = w_a ... w_(b-1) (1 when empty):
//
//   y_t = (r_t P(0, t)) S                                  cross term
//       + sum_{s<t} (sum_d r_t k_s P(s+1, t)) v_s          intra-chunk
//       + (sum_d r_t u k_t) v_t                            bonus
//   S'  = P(0, 64) S + sum_s (k_s P(s+1, 64)) v_s^T
//
//   * Decays as products, not exponents: every factor is a product of the
//     w's it spans, taken in float32 (a running product, as the step form's
//     repeated decay), so it lies in [0, 1]. A w of 0 (exp(-exp(raw))
//     underflows to 0 for raw >~ 4.5) makes each product across it exactly
//     0, which is the step form's answer (that channel's state is wiped),
//     with no log(0) = -inf and no -inf - -inf = NaN; a w within 1e-7 of 1
//     is a factor like any other. Each decay is a product over its own
//     span, never a quotient or a difference of two sums, so its rounding
//     stays ~n ulp for n factors. No exp is taken at all.
//   * Per chunk and channel, each half h (rows a .. e) is walked once each
//     way: forward r8_t = r_t P(a, t) and the half's total H_h, backward
//     k8_s = k_s P(s+1, e+1). A table holds, per channel, F8[h] = H_0 ...
//     H_(h-1), G8[h] = H_(h+1) ... H_7, H_h, the sub-chunk totals W_m =
//     H_2m H_2m+1 that lie between the blocks below, and D = P(0, 64).
//   * Blocks between sub-chunks i < j (16 x 16, six a chunk) on the tensor
//     cores, factored at the start b of t's sub-chunk: A[t][s] = r~_t . k~_s
//     with r~ = r8 (times H_2j on the second half) = r_t P(b, t) and k~ =
//     k8 W_(i+1) ... W_(j-1) (times H_2i+1 on the first half) =
//     k_s P(s+1, b). Both factors are at most 1, so neither overflows.
//   * Each diagonal sub-chunk block splits at its halves: the square (t in
//     the second half, s in the first) on the tensor cores, factored at the
//     halves' boundary (A = r8 k8^T); the two triangles (s < t in one half)
//     on the CUDA cores, a lane carrying z = k_s P(s+1, t) down the rows
//     t > s, one multiply a row, and adding r_t . z into A[t][s]; the bonus
//     is A[t][t].
//   * y = (r8 F8[half]) S + A V, and S' = D S + K~^T V with K~_s = k8_s
//     G8[half(s)] = k_s P(s+1, 64): three more products on the tensor cores.
//   * A ragged last chunk is staged with r = k = v = 0 and w = 1, which adds
//     nothing to y or S and decays nothing; its rows past S are not stored.
//
// Precision, 3xTF32: the decayed operands are float32 values that are not
// exact in bf16 or tf32, and one tf32 rounding (2^-11 relative) misses the
// 1e-5 gate against the step form. Each operand is split into tf32 pieces
// by rounding its bits to nearest (hi = tf32(x), lo = tf32(x - hi), as
// swiglu.cu), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi; a bf16 v is exact
// in tf32, so products with V drop b_lo. The tensor cores add a product's
// terms with less than round-to-nearest (measured on the card; swiglu.cu), so
// each k-step of 8 goes into a partial that starts from 0 (a chain of 24
// terms inside the tensor cores) and is added to the float32 accumulator
// with IEEE adds; chaining two k-steps a partial measured slower, not
// faster (longer dependent chains). tests/test_torch_wkv6_chunks.py
// emulates this arithmetic on the CPU: ~2e-7 of the scale at 3 pieces,
// ~5e-4 at 1.
//
// Why mma.sync (m16n8k8, tf32) and not wgmma: the blocks are 16 rows (8 in
// the squares), mma's M, while wgmma's M is 64; the A operands (the decayed
// r and k, A's rows) are formed in registers from shared memory in mma's
// fragment layout, with no swizzled staging; and a chunk's products are
// 64 x 64 x 64 a CTA, too small to amortize wgmma's asynchronous pipeline.
//
// Parallelism: a CTA owns (b, h, NJ = min(hd, 64) state columns) and walks
// the chunks in order: 256 CTAs of 8 warps at the 7B prefill, two an SM
// (111.6 KB of shared memory each, 128 registers a thread), so all of them
// are resident at once. Warp w owns sub-chunk m = w % 4's rows of y and
// state rows 16 m .. 16 m + 15, each for 32 columns (w / 4); the state
// stays in registers across the chunk walk, with its tf32 pieces in shared
// memory for the cross term. A chunk is five barrier-separated phases:
// staging (the four inputs' loads in flight together, widened to float32),
// the triangles, the decay walks, the tensor-core blocks with the cross
// term and the state update, then A V and y out. s_last may alias s0: each
// thread reads its own state elements once, at the start, and writes the
// same elements once, at the end.
//
// Executed work at the 7B prefill, bf16 (chip_smoke.py counts it from the
// design): per CTA and chunk 288 mma.sync for the blocks between
// sub-chunks, 96 for the squares, 768 for the cross term, 512 for the
// state update and 320 for A V (2048 FLOPs each; 3 products a k-step, 2
// where V is exact), 3.33e10 tensor FLOPs in all (0.067 ms at 495
// TFLOP/s); float32 adds a third product to A V and the state update
// (4.03e10). The triangles take 7 predicated row slots (4 FMAs and 4
// multiplies on a float4 of channels) a lane, channel group and half on
// the CUDA cores: 7.05e8 flops, 0.011 ms at 67 TFLOP/s.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "wkv6_chunk.cuh"

namespace {

// the shortest sequence the chunk kernel takes (kernels/wkv6.py's too)
constexpr int CHUNKED_MIN_SEQ = 48;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// The step kernel (decode, and sequences shorter than CHUNKED_MIN_SEQ)
// ---------------------------------------------------------------------------
namespace step {

// Design: one CTA of 2 hd threads per (b, h). Inputs are converted to
// float32 and every product is taken there. The bonus term is split off the
// sum:
//
//   y_j = sum_i r_i S_ij + v_j c,  c = sum_i r_i u_i k_i,
//   S_ij = w_i S_ij + k_i v_j,
//
// so a (i, j) pair costs one multiply and two fused multiply-adds. The state
// is cut into tiles of hd / 8 rows by 4 columns: thread (cb, rg) owns
// columns 4 cb .. 4 cb + 3 and rows rg, rg + 8, rg + 16, ... as float32
// registers, loaded from s0 once and stored to s_last once (float4 a row).
// A thread reads its own tile of s0 before it writes the same tile of
// s_last and no thread touches another's, so s_last may alias s0: decode
// updates the cache's state in place this way. A step stages (r_i, k_i,
// w_i, r_i u_i k_i) as one float4 per i and v as float4s of four columns in
// shared memory, double-buffered so that one __syncthreads() a step
// suffices (a buffer is written at step t only after every thread has
// passed step t - 1's barrier, hence finished reading it at step t - 2). A
// thread then reads one float4 per row it owns and uses it for its four
// columns, and the 8 row groups' partial sums of y (each with its rows'
// part of c) are added across lanes (xor shuffles). The first hd threads
// load the inputs DEPTH steps ahead into registers of their own type (a
// bf16 value is widened only when it is staged, so the load is not waited
// for early). Tiles: a thread that owns a whole column would read 16 bytes
// of shared memory per (i, j) pair; a 4-column tile reads 4.

constexpr int RG = 8;     // row groups: lanes that share a column block
constexpr int CJ = 4;     // columns a thread owns
constexpr int DEPTH = 8;  // steps loaded ahead

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

}  // namespace step

template <typename T, int HD>
int launch(int kernel, const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_last, void* states, int b, int seq,
           int h, cudaStream_t stream) {
  if (!kernel) return step::launch<T, HD>(r, k, v, w, u, s0, y, s_last, b, seq, h, stream);
  // the chunk states' output has an instantiation of its own: the serve's
  // forward carries none of its code
  return states != nullptr
             ? chunk::launch<T, T, float, HD, false, true, true>(r, k, v, w, u, s0, y, s_last,
                                                                 states, b, seq, h, stream)
             : chunk::launch<T, T, float, HD, false, true, false>(r, k, v, w, u, s0, y, s_last,
                                                                  nullptr, b, seq, h, stream);
}

template <typename T>
int dispatch(int kernel, int hd, const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* s_last, void* states, int b,
             int seq, int h, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(kernel, r, k, v, w, u, s0, y, s_last, states, b, seq, h, stream);
    case 64:
      return launch<T, 64>(kernel, r, k, v, w, u, s0, y, s_last, states, b, seq, h, stream);
    case 128:
      return launch<T, 128>(kernel, r, k, v, w, u, s0, y, s_last, states, b, seq, h, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch of the kernel `kernel` (0: step, 1: chunk) whatever S is: for
// measuring the two against each other. r, k, v: (b, seq, h, hd), float32
// (bf16 = 0) or bfloat16 (bf16 = 1); w: (b, seq, h, hd) float32; u: (h, hd)
// float32; s0: (b, h, hd, hd) float32 or null (zeros); y: (b, seq, h, hd)
// float32; s_last: (b, h, hd, hd) float32, may be s0. states: null, or (b,
// h, ceil(seq / 64) - 1, hd, hd) float32 that gets the state after each
// 64-step chunk but the last (the backward's chunk states; y and s_last
// are the same bits with or without it); only the chunk kernel writes it,
// and the step kernel refuses it where there is more than one chunk. All
// contiguous and 16-byte aligned.
extern "C" int wkv6_fwd_with(int kernel, int bf16, const void* r, const void* k,
                             const void* v, const void* w, const void* u, const void* s0,
                             void* y, void* s_last, void* states, int b, int seq, int h, int hd,
                             void* stream) {
  if (b <= 0 || h <= 0) return 0;
  if (seq < 0 || (long long)b * h * 4 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (!kernel && states != nullptr && seq > chunk::CHUNK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(kernel, hd, r, k, v, w, u, s0, y, s_last, states, b,
                                        seq, h, s)
              : dispatch<float>(kernel, hd, r, k, v, w, u, s0, y, s_last, states, b, seq, h, s);
}

// The WKV-6 forward, one launch: the chunk kernel for seq >= CHUNKED_MIN_SEQ,
// else the step kernel; *kernel (when not null) gets which (0 step, 1
// chunk). Other arguments as wkv6_fwd_with's.
extern "C" int wkv6_fwd(int bf16, const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_last, void* states,
                        int b, int seq, int h, int hd, void* stream, int* kernel) {
  const int which = seq >= CHUNKED_MIN_SEQ ? 1 : 0;
  if (kernel != nullptr) *kernel = which;
  return wkv6_fwd_with(which, bf16, r, k, v, w, u, s0, y, s_last, states, b, seq, h, hd,
                       stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
