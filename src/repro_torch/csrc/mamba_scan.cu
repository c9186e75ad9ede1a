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
// in no order and nothing carries over between them, so a lane owns some
// (b, d, n) states and walks every step itself, its states in registers:
// the sequential grid axis becomes the lane's loop over t. Every product is
// taken in float32, as the Pallas kernel's are.
//
// Bound. At the Jamba prefill shape (B 4, S 2048, D 8192, N 16) the
// function reads dt and x (B, S, D) and writes y (B, S, D): with dt and y in
// float32 and x in bf16, 10 bytes a (b, t, d), 671 MB (B, C, a and the
// state add ~1 MB): 0.200 ms at 3.35 TB/s (x in float32: 805 MB, 0.240 ms).
// The arithmetic, 6 FP32 operations per (b, t, d, n) counting the
// exponential as one, is 0.097 ms at the CUDA cores' 67 TFLOP/s. But the
// exponential is not one FMA-pipe operation: the special-function unit
// (SFU, MUFU) issues 16 a clock an SM, so the 1.07e9 exponentials take
// 0.257 ms there at 1.98 GHz if each is one bare MUFU.EX2. That, not the
// memory, is the floor of a kernel that sends every exponential there; an
// IEEE expf (this build has no --use_fast_math) wraps the same MUFU.EX2 in
// ~7 FP32 instructions of range reduction and scaling, which the first
// version of this kernel paid on every element (0.67 ms).
//
// Not a chunked tensor-core form. Mamba-1's decay depends on the channel
// and the state, so a chunk's kernel matrix M[t, s] = sum_n (C_t[n]
// e^{a Lam_t}) (B_s[n] e^{-a Lam_s}) (Lam the running sum of dt) exists per
// channel only, needs two exponentials per (t, d, n) where the scan needs
// one, and its factors e^{-a Lam_s} overflow float32 within a chunk once
// |a dLam| > 88: it doubles the resource that binds. One exponential an
// element is the floor; the design chooses where each is computed.
//
// Design, in three parts:
//  1. Exponentials on the SFU, bare. a2 = a log2(e) is formed once per
//     (d, n) at the start, in registers, and each decay is 2^(dt a2) by one
//     `ex2.approx.ftz.f32` (2 ulp; its result below 2^-126 is 0). This
//     kernel alone asks for it, by inline PTX: the build's flags stay IEEE,
//     so every other kernel keeps IEEE expf/logf.
//  2. No share on the FMA pipes. Taking a fixed share of the exponentials
//     by a polynomial on the FMA pipes (13 issue slots where the SFU takes
//     one) pays only while the loop's other instructions leave issue slots
//     free: the SFU takes 8 cycles of its sub-partition for a warp's 32
//     exponentials, so it binds while an element costs fewer than 8 issue
//     slots in all. The loop costs ~7.8 (4 FP32 operations, the
//     exponential, ~2.8 of loads, conversion, the y sum and addressing),
//     and shares of 1/8, 1/4 and 3/8 each measured slower than none
//     (PERF.md), so every exponential goes to the SFU.
//  3. More warps and fewer instructions an element. A channel's N states
//     are split over LANES neighbouring lanes (NL = N / LANES each); a CTA
//     of 128 threads owns 128 / LANES channels of one batch row (grid:
//     channel blocks x batch), 16 warps an SM at the prefill. Every input
//     of a chunk of TC steps (dt, x, B, C) is staged in shared memory by
//     16-byte cp.async (dt and x element by element when D is no multiple
//     of 8), STAGES - 1 chunks ahead of the chunk being computed, with one
//     __syncthreads() a chunk; a chunk's steps are straight-line code (a
//     step past S is staged as zeros and leaves h unchanged), so the
//     compiler interleaves the steps' loads, exponentials and FMAs. A lane
//     keeps its partial y of each step of the chunk and the LANES partials
//     are summed after the chunk by a transposed butterfly of
//     __shfl_xor_sync: at each stage a lane keeps half of its steps and
//     sends the other half, so that lane j ends with the full sums of the
//     steps i with i mod LANES == j, in an order fixed by the lane (the
//     bits repeat from call to call), and stores them.
// The time of every variant measured (FMA-pipe shares 0, 1/8, 1/4, 3/8; 1,
// 2 and 4 lanes a channel; 1 or 2 channels a lane; 16, 24 or 32 steps a
// chunk) is in PERF.md, from tools/mamba_variants.py; the constants below
// are the fastest.
//
// Numerics against the plain version (the step loop ref.mamba_scan_ref,
// IEEE exp): the decay's rounded a2 adds ~1 ulp to dt a and ex2.approx is
// within 2 ulp; h * da + u * B is one fused multiply-add; y is summed over
// n in another order. Each of these is emulated in
// tests/test_torch_mamba_exp.py, which holds the emulation to the step loop
// within 1e-5 of max(1, |plain|), the card tests' gate. Near a decay of 1
// an exponential's error has one sign step after step, so a large state
// that barely decays drifts: at decays within 1e-6 of 1 and a unit state
// over 2048 steps, both this kernel and the float32 step loop end more than
// 1e-5 of the scale from a float64 loop (the card tests and chip_smoke.py
// hold the kernel to a float64 loop there, with the limit they state).
//
// A lane reads its own h0 states before it writes the same h_last states
// and no lane touches another's, so h_last may alias h0: a caller updates a
// state in place this way. Ragged D is masked (lanes past D compute on
// zeros and store nothing). N is a template argument (4, 8, 16, 32); x is
// float32 or bfloat16, widened exactly; everything else float32, every
// pointer 16-byte aligned.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 128;      // a CTA
constexpr int TC = 32;            // steps a chunk: staged, loaded ahead, one barrier
constexpr int LANES = 2;          // lanes a channel (its states split over them)
constexpr float LOG2E = 1.44269504088896341f;

__device__ __forceinline__ float exp2_sfu(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// K neighbouring floats from p (aligned to K of them) into out
template <int K>
__device__ __forceinline__ void load_vec(float (&out)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      out[q] = v.x; out[q + 1] = v.y; out[q + 2] = v.z; out[q + 3] = v.w;
    }
  } else if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    static_assert(K == 1, "K is 1, 2 or a multiple of 4");
    out[0] = p[0];
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>  // wait until at most PENDING groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Steps t0 .. t0 + TC - 1 of channels d0 .. d0 + CH - 1 of one batch row's
// (seq, dim) slab g into s, zeros past seq and dim; E elements a copy: 16
// bytes by cp.async (D a multiple of 8), or one element by a load and a
// store (any D).
template <int E, int CH, typename T>
__device__ __forceinline__ void stage(T (&s)[TC][CH], const T* g, int t0, int d0, int seq,
                                      int dim, int tid) {
  static_assert(E == 1 || E * sizeof(T) == 16, "a copy is one element or 16 bytes");
#pragma unroll
  for (int i = 0; i < (TC * CH / E + THREADS - 1) / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / (CH / E), c = E * (e % (CH / E));
    const bool ok = t0 + r < seq && d0 + c < dim;
    const T* src = g + (long long)(t0 + r) * dim + d0 + c;
    if (e < TC * CH / E) {
      if constexpr (E == 1) s[r][c] = ok ? *src : T(0.f);
      else cp_async16(&s[r][c], ok ? src : g, ok);
    }
  }
}

// VEC: D is a multiple of 8, and dt and x are staged 16 bytes a copy
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* dt, const T* x, const float* __restrict__ bm,
                  const float* __restrict__ cm,
                  const float* __restrict__ a,
                  const float* h0,  // may alias h_last: not __restrict__
                  float* __restrict__ y, float* h_last, int seq, int dim) {
  constexpr int NL = N / LANES;                              // states a lane
  constexpr int CH = THREADS / LANES;                        // channels a CTA
  constexpr int V = TC * N / 4;                              // float4s of B (or C) a chunk
  constexpr int PBC = (2 * V + THREADS - 1) / THREADS;       // float4s a thread stages
  static_assert(N % LANES == 0 && TC % LANES == 0 && CH % 8 == 0, "geometry");
  // chunks in shared memory: three (two loads in flight while one is read)
  // where they fit in the 48 KB of static shared memory, else two
  constexpr int STAGE_BYTES = (2 * TC * N + TC * CH) * 4 + TC * CH * (int)sizeof(T);
  constexpr int STAGES = 3 * STAGE_BYTES <= 48 * 1024 ? 3 : 2;
  __shared__ __align__(16) float sbc[STAGES][2][TC * N];     // [buffer][B, C][t * N + n]
  __shared__ __align__(16) float sdt[STAGES][TC][CH];
  __shared__ __align__(16) T sx[STAGES][TC][CH];
  const int tid = threadIdx.x;
  const int j = tid % LANES;                                 // lane in the channel's group
  const int dl = tid / LANES;                                // channel, in the CTA
  const int d0 = blockIdx.x * CH;
  const int d = d0 + dl;
  const long long row = (long long)blockIdx.y * seq;         // (b, t = 0)
  const float* bp = bm + row * N;
  const float* cp = cm + row * N;
  const float* dtp = dt + row * dim;
  const T* xp = x + row * dim;

  float a2[NL], h[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) a2[k] = h[k] = 0.f;
  if (d < dim) {
    load_vec(a2, a + (long long)d * N + j * NL);
#pragma unroll
    for (int k = 0; k < NL; ++k) a2[k] = __fmul_rn(a2[k], LOG2E);
    if (h0 != nullptr) load_vec(h, h0 + ((long long)blockIdx.y * dim + d) * N + j * NL);
  }

  // Staging. A step past S is staged as dt = x = B = C = 0: its decays are
  // exactly 1 and it adds 0, so h passes it unchanged and no step needs a
  // branch. Chunk t0 goes into a buffer STAGES - 1 chunks ahead of the
  // chunk being computed.
  auto issue = [&](int t0, int buf) {
    const int have = (seq - t0 < TC ? seq - t0 : TC) * (N / 4);  // float4s that exist
#pragma unroll
    for (int i = 0; i < PBC; ++i) {
      const int e = tid + i * THREADS;
      if (e < 2 * V) {
        const int q = e % V;
        const float* src = (e < V ? bp : cp) + (long long)t0 * N + 4 * q;
        cp_async16(&sbc[buf][e / V][4 * q], q < have ? src : bp, q < have);
      }
    }
    stage<VEC ? 4 : 1>(sdt[buf], dtp, t0, d0, seq, dim, tid);
    stage<VEC ? 16 / (int)sizeof(T) : 1>(sx[buf], xp, t0, d0, seq, dim, tid);
  };

  // the first STAGES - 1 chunks; one commit group a chunk, empty past S
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c * TC < seq) issue(c * TC, c);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  int buf = 0;
  float* yp = y + (row + j) * dim + d;                       // step j of the chunk
  for (int t0 = 0; t0 < seq; t0 += TC, yp += (long long)TC * dim) {
    // chunk t0 + (STAGES - 1) TC into the buffer that chunk t0 - TC used:
    // every thread has passed the barrier after reading it
    const int ahead = t0 + (STAGES - 1) * TC;
    if (ahead < seq) issue(ahead, buf == 0 ? STAGES - 1 : buf - 1);
    cp_async_commit();
    float ys[TC];
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      float bv[NL], cv[NL];
      load_vec(bv, &sbc[buf][0][i * N + j * NL]);
      load_vec(cv, &sbc[buf][1][i * N + j * NL]);
      const float dv = sdt[buf][i][dl];
      const float u = __fmul_rn(dv, widen(sx[buf][i][dl]));
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        const float da = exp2_sfu(__fmul_rn(dv, a2[k]));
        h[k] = __fmaf_rn(h[k], da, __fmul_rn(u, bv[k]));
        if (k % 2 == 0) y0 = __fmaf_rn(h[k], cv[k], y0);
        else y1 = __fmaf_rn(h[k], cv[k], y1);
      }
      ys[i] = __fadd_rn(y0, y1);
    }
    // the transposed butterfly: before the stage of mask m, slot i (i mod m
    // == 0) holds this lane's partial of step i + (j mod m); after it, slot
    // i (i mod 2m == 0) holds step i + (j mod 2m)'s
#pragma unroll
    for (int m = 1; m < LANES; m *= 2) {
      const bool upper = (j & m) != 0;
#pragma unroll
      for (int i = 0; i < TC; i += 2 * m) {
        const float send = upper ? ys[i] : ys[i + m];
        const float keep = upper ? ys[i + m] : ys[i];
        ys[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, m));
      }
    }
    if (d < dim) {
#pragma unroll
      for (int i = 0; i < TC; i += LANES)
        if (t0 + i + j < seq) yp[(long long)i * dim] = ys[i];
    }
    cp_async_wait<STAGES - 2>();  // the next chunk has landed
    __syncthreads();
    buf = buf == STAGES - 1 ? 0 : buf + 1;
  }

  if (d < dim) {
    float* hp = h_last + ((long long)blockIdx.y * dim + d) * N + j * NL;
#pragma unroll
    for (int k = 0; k < NL; ++k) hp[k] = h[k];
  }
}

template <typename T, int N>
int launch(const void* dt, const void* x, const void* b, const void* c, const void* a,
           const void* h0, void* y, void* h_last, int batch, int seq, int dim,
           cudaStream_t stream) {
  constexpr int CH = THREADS / LANES;
  const dim3 grid((unsigned)((dim + CH - 1) / CH), (unsigned)batch);
  auto kernel = dim % 8 == 0 ? mamba_scan_kernel<T, N, true> : mamba_scan_kernel<T, N, false>;
  kernel<<<grid, THREADS, 0, stream>>>(
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
