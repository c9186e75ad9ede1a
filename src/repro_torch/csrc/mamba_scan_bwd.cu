// Mamba (S6) selective scan, backward. Per batch row b, channel d and state
// n, the forward (csrc/mamba_scan.cu) runs, with e_t = exp(dt_t[d] a[d][n]):
//
//   h_t[d][n] = e_t h_t-1[d][n] + dt_t[d] x_t[d] B_t[n],   y_t[d] = sum_n h_t C_t[n]
//
// Given dy (the gradient of y) and dh_last (of the final state, or zeros),
// with G = dL/dh_t (dh_last after the last step), walking t down:
//
//   G        += dy_t[d] C_t[n]
//   dC_t[n]   = sum_d h_t dy_t[d]
//   dB_t[n]   = sum_d G dt_t[d] x_t[d]
//   dx_t[d]   = dt_t[d] sum_n G B_t[n]
//   ddt_t[d]  = sum_n G (a e_t h_t-1 + x_t[d] B_t[n])
//   da[d][n] += G dt_t[d] e_t h_t-1                  (over b and t)
//   G        <- e_t G                                (dL/dh_t-1)
//
// and dh0 = G after step 0. The written-out plain version is
// ref.mamba_scan_bwd_ref; autograd of ref.mamba_scan_ref is the other.
//
// Replaces no TPU kernel: the reference trains Jamba through jax.grad of the
// lax.scan in src/repro/models/mamba.py:79-101 (use_pallas=False in train
// mode), and JAX cannot differentiate the Pallas kernel mamba_scan_pallas.
// Added so that the card trains the Mamba layers through the forward kernel
// (kernels/mamba_scan.py's MambaScan Function).
//
// Bound. At the Jamba training shape (B 4, S 2048, D 8192, N 16) the least
// work per (b, t, d, n) is about 20 FP32 operations: e_t = exp(dt_t a) and
// h_t = e_t h_t-1 + (dt_t x_t) B_t once each (5, the exponential counted as
// one: the reverse walk needs e_t and h_t-1, and the forward's states are
// not kept); G *= e_t+1 (1); G += dy_t C_t and the sums of dC, dB and dx's
// sum over n (2 each); q = G e_t h_t-1, da += dt_t q and ddt's sum of a q
// (6; ddt's x_t sum_n G B_t reuses dx's sum). With 4 per (b, t, d) that is
// 2.17e10 FLOPs, 0.325 ms at 67 TFLOP/s; the 1.07e9 exponentials are 0.257
// ms on the special-function unit (16 a clock an SM at 1.98 GHz) if each is
// one bare MUFU.EX2 (an IEEE expf adds ~7 FP32 instructions of range
// reduction to each, as this kernel pays). The least bytes: dt, dy, ddt in
// float32 and x, dx in their dtype, once each, 1.07 GB with bf16 x (0.321
// ms at 3.35 TB/s). So operations bound it, by a hair.
//
// Design, a first kernel on the CUDA cores in float32, shaped as the forward:
//  * A lane owns NL = N / 2 states of one channel (two lanes a channel, 64
//    channels a CTA of 128 threads, grid (channel blocks, batch)), its G and
//    da in registers.
//  * Decays by IEEE expf of the rounded product dt a, as the plain
//    version's torch.exp takes them, and not by the forward kernel's bare
//    ex2.approx: near a decay of 1 that approximation's error has one
//    sign step after step, and over the 2048 steps of a training sequence G
//    (a sum of products of up to 2048 decays) drifts by ~1e-4 of its scale,
//    the tolerance the gradients are held to. A decay that underflows is 0:
//    G stops there, and every gradient stays finite.
//  * States by checkpoints: the CTA first runs the forward recurrence (phase
//    A) and writes its states every TB steps into scratch that the wrapper
//    allocates, B ceil(S / TB) D N floats. Then (phase B) it walks the
//    sub-chunks from the last: stages the TB steps' dt, x, dy, B and C in
//    shared memory, recomputes the TB states from the checkpoint into
//    shared memory (each lane its own states, so no barrier between writing
//    and reading them: shared memory over registers keeps the register count
//    of N = 32 in bounds), and walks the TB steps down. An exponential is
//    taken three times an element: phase A, the recompute, the walk.
//  * dx and ddt sum the lane's states and its partner's (one xor shuffle).
//    dB and dC sum over all D channels, which lie in many CTAs: a CTA sums
//    its 64 channels (a transposed butterfly over the warp's 16 channels,
//    each lane keeping a share of the 2N sums, then the 4 warps in order
//    through shared memory) and writes (b, t, block, 2N) partials; a second
//    launch in the same C entry sums the blocks in order, and da's (b, d, n)
//    partials over b in order. No atomics: the bits repeat from call to call.
//  * A step past S is staged as dt = x = dy = B = C = 0: its decay is exactly
//    1 and it adds nothing, so the states and G pass it unchanged; its
//    outputs are not stored. Channels past D compute on zeros and store
//    nothing.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 128;      // a CTA
constexpr int LANES = 2;          // lanes a channel (its states split over them)
constexpr int CH = THREADS / LANES;  // channels a CTA
constexpr int WARPS = THREADS / 32;
constexpr int TB = 8;             // steps a sub-chunk, and between checkpoints
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// K neighbouring floats between registers and p (aligned to K of them)
template <int K>
__device__ __forceinline__ void load_vec(float (&out)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      out[q] = v.x; out[q + 1] = v.y; out[q + 2] = v.z; out[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) out[q] = p[q];
  }
}
template <int K>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4)
      *reinterpret_cast<float4*>(p + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) p[q] = v[q];
  }
}

template <int N>
struct Smem {
  static constexpr int NL = N / LANES;
  static constexpr int HBUF = TB * NL * THREADS;   // the sub-chunk's states, a lane's own
  static constexpr int STAGE = 3 * TB * CH + 2 * TB * N;  // dt, x, dy; B, C
  static constexpr int PART = WARPS * TB * 2 * N;  // a warp's dB and dC sums
  static constexpr int OUTS = 2 * TB * CH;         // dx, ddt
  static constexpr int FLOATS = HBUF + STAGE + PART + OUTS;
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
mamba_scan_bwd_kernel(const float* __restrict__ dt, const T* __restrict__ x,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ h0,
                      const float* __restrict__ dy, const float* __restrict__ dh_last,
                      float* __restrict__ ddt, T* __restrict__ dx,
                      float* __restrict__ part_bc, float* __restrict__ part_a,
                      float* __restrict__ dh0, float* __restrict__ ckpt, int seq, int dim) {
  using L = Smem<N>;
  constexpr int NL = L::NL;
  constexpr int V = 2 * NL;  // a lane's dB and dC terms of a step
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);  // [TB][NL][THREADS]
  float* s_dt = hbuf + L::HBUF;                   // [TB][CH]
  float* s_x = s_dt + TB * CH;
  float* s_dy = s_x + TB * CH;
  float* s_b = s_dy + TB * CH;                    // [TB][N]
  float* s_c = s_b + TB * N;
  float* s_part = s_c + TB * N;                   // [WARPS][TB][2N]: dB, then dC
  float* s_dx = s_part + L::PART;                 // [TB][CH]
  float* s_ddt = s_dx + TB * CH;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tid % LANES;   // lane in the channel's group
  const int dl = tid / LANES;  // channel, in the CTA
  const int d0 = blockIdx.x * CH;
  const int d = d0 + dl;
  const bool live = d < dim;
  const int bi = blockIdx.y;
  const long long row = (long long)bi * seq;  // (b, t = 0)
  const int nchunks = (seq + TB - 1) / TB;
  const int nblk = gridDim.x;

  const long long own = ((long long)bi * dim + d) * N + j * NL;  // this lane's (b, d, n) states
  float av[NL], h[NL];
#pragma unroll
  for (int q = 0; q < NL; ++q) av[q] = h[q] = 0.f;
  if (live) {
    load_vec(av, a + (long long)d * N + j * NL);
    if (h0 != nullptr) load_vec(h, h0 + own);
  }
  // this lane's states in the checkpoint of sub-chunk c
  auto ck = [&](int c) {
    return ckpt + (((long long)bi * nchunks + c) * dim + d) * N + j * NL;
  };
  // steps t0 .. t0 + TB - 1 into shared memory as float32, zeros past S and D
  auto stage = [&](int t0, bool all) {
    for (int e = tid; e < TB * CH; e += THREADS) {
      const int t = t0 + e / CH, dd = d0 + e % CH;
      const bool ok = t < seq && dd < dim;
      const long long off = (row + t) * dim + dd;
      s_dt[e] = ok ? dt[off] : 0.f;
      s_x[e] = ok ? widen(x[off]) : 0.f;
      if (all) s_dy[e] = ok ? dy[off] : 0.f;
    }
    for (int e = tid; e < TB * N; e += THREADS) {
      const int t = t0 + e / N;
      const bool ok = t < seq;
      const long long off = (row + t) * N + e % N;
      s_b[e] = ok ? bm[off] : 0.f;
      if (all) s_c[e] = ok ? cm[off] : 0.f;
    }
  };

  // -- phase A: the forward recurrence, a checkpoint every TB steps ----------
  for (int c = 0; c < nchunks; ++c) {
    if (live) store_vec(ck(c), h);
    if (c == nchunks - 1) break;  // the last sub-chunk's steps are not needed here
    __syncthreads();
    stage(c * TB, false);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const float dv = s_dt[i * CH + dl];
      const float u = __fmul_rn(dv, s_x[i * CH + dl]);
#pragma unroll
      for (int q = 0; q < NL; ++q) {
        const float e = expf(__fmul_rn(dv, av[q]));
        h[q] = __fmaf_rn(h[q], e, __fmul_rn(u, s_b[i * N + j * NL + q]));
      }
    }
  }

  // -- phase B: the sub-chunks from the last, each step down ----------------
  float g[NL], da[NL];
#pragma unroll
  for (int q = 0; q < NL; ++q) g[q] = da[q] = 0.f;
  if (live && dh_last != nullptr) load_vec(g, dh_last + own);
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * TB;
    const int n = seq - t0 < TB ? seq - t0 : TB;
    __syncthreads();  // every thread is done with the last sub-chunk's shared memory
    stage(t0, true);
    __syncthreads();
    if (live) load_vec(h, ck(c));
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const float dv = s_dt[i * CH + dl];
      const float u = __fmul_rn(dv, s_x[i * CH + dl]);
#pragma unroll
      for (int q = 0; q < NL; ++q) {
        hbuf[(i * NL + q) * THREADS + tid] = h[q];
        const float e = expf(__fmul_rn(dv, av[q]));
        h[q] = __fmaf_rn(h[q], e, __fmul_rn(u, s_b[i * N + j * NL + q]));
      }
    }
#pragma unroll
    for (int i = TB - 1; i >= 0; --i) {
      const float dv = s_dt[i * CH + dl], xv = s_x[i * CH + dl], dyv = s_dy[i * CH + dl];
      const float u = __fmul_rn(dv, xv);
      float terms[V];  // dB's terms, then dC's
      float dxp = 0.f, ddtp = 0.f;
#pragma unroll
      for (int q = 0; q < NL; ++q) {
        const float bq = s_b[i * N + j * NL + q], cq = s_c[i * N + j * NL + q];
        const float hp = hbuf[(i * NL + q) * THREADS + tid];
        const float e = expf(__fmul_rn(dv, av[q]));
        const float ht = __fmaf_rn(hp, e, __fmul_rn(u, bq));
        g[q] = __fmaf_rn(dyv, cq, g[q]);
        terms[q] = __fmul_rn(g[q], u);
        terms[NL + q] = __fmul_rn(ht, dyv);
        dxp = __fmaf_rn(g[q], bq, dxp);
        const float ehp = __fmul_rn(e, hp);
        ddtp = __fmaf_rn(g[q], __fmaf_rn(av[q], ehp, __fmul_rn(xv, bq)), ddtp);
        da[q] = __fmaf_rn(__fmul_rn(g[q], dv), ehp, da[q]);
        g[q] = __fmul_rn(e, g[q]);
      }
      // the channel's sums over its two lanes (both lanes get the same bits)
      dxp += __shfl_xor_sync(FULL, dxp, 1);
      ddtp += __shfl_xor_sync(FULL, ddtp, 1);
      if (j == 0) {
        s_dx[i * CH + dl] = __fmul_rn(dv, dxp);
        s_ddt[i * CH + dl] = ddtp;
      }
      // dB and dC over the warp's 16 channels (lanes of one j: masks 2 .. 16):
      // while a lane holds more than one term it keeps half and sends half;
      // past that, the partners hold the same sum and the lower one keeps it
      int base = 0;
      bool writer = true;
#pragma unroll
      for (int m = LANES, cnt = V; m < 32; m *= 2) {
        const bool upper = (lane & m) != 0;
        if (cnt > 1) {
          const int half = cnt / 2;
#pragma unroll
          for (int q = 0; q < half; ++q) {
            const float send = upper ? terms[q] : terms[q + half];
            const float keep = upper ? terms[q + half] : terms[q];
            terms[q] = keep + __shfl_xor_sync(FULL, send, m);
          }
          if (upper) base += half;
          cnt = half;
        } else {
          terms[0] += __shfl_xor_sync(FULL, terms[0], m);  // the same bits in both
          writer = writer && !upper;
        }
      }
      if (writer) {
        constexpr int KEEP = V / 16 > 0 ? V / 16 : 1;  // terms a lane holds now
#pragma unroll
        for (int o = 0; o < KEEP; ++o) {
          const int idx = base + o;  // into this lane's V terms
          const int slot = (idx < NL ? 0 : N) + j * NL + idx % NL;
          s_part[(warp * TB + i) * 2 * N + slot] = terms[o];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < n * CH; e += THREADS) {
      const int i = e / CH, dd = d0 + e % CH;
      if (dd < dim) {
        const long long off = (row + t0 + i) * dim + dd;
        dx[off] = narrow<T>(s_dx[e]);
        ddt[off] = s_ddt[e];
      }
    }
    for (int e = tid; e < n * 2 * N; e += THREADS) {
      const int i = e / (2 * N), slot = e % (2 * N);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) acc += s_part[(q * TB + i) * 2 * N + slot];
      part_bc[((row + t0 + i) * nblk + blockIdx.x) * 2 * N + slot] = acc;
    }
  }

  if (live) {
    store_vec(part_a + own, da);
    if (dh0 != nullptr) store_vec(dh0 + own, g);
  }
}

// db, dc (batch, seq, n): the blocks' partials summed in order; da (dim, n):
// the batch rows' partials summed in order
template <int N>
__global__ void mamba_bwd_sum_kernel(const float* __restrict__ part_bc,
                                     const float* __restrict__ part_a, float* __restrict__ db,
                                     float* __restrict__ dc, float* __restrict__ da,
                                     long long rows, int nblk, int batch, long long dn) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nbc = rows * 2 * N;
  if (e < nbc) {
    const long long r = e / (2 * N);
    const int slot = (int)(e % (2 * N));
    float acc = 0.f;
    for (int q = 0; q < nblk; ++q) acc += part_bc[(r * nblk + q) * 2 * N + slot];
    if (slot < N) db[r * N + slot] = acc;
    else dc[r * N + slot - N] = acc;
  } else if (e < nbc + dn) {
    const long long o = e - nbc;
    float acc = 0.f;
    for (int q = 0; q < batch; ++q) acc += part_a[q * dn + o];
    da[o] = acc;
  }
}

struct Scratch {
  long long ckpt, bc, a;  // floats of each part
};

Scratch scratch_floats(int batch, int seq, int dim, int n) {
  const long long nblk = (dim + CH - 1) / CH;
  return {(long long)batch * ((seq + TB - 1) / TB) * dim * n,
          (long long)batch * seq * nblk * 2 * n, (long long)batch * dim * n};
}

template <typename T, int N>
int launch(const void* dt, const void* x, const void* b, const void* c, const void* a,
           const void* h0, const void* dy, const void* dh_last, void* ddt, void* dx, void* db,
           void* dc, void* da, void* dh0, void* scratch, int batch, int seq, int dim,
           cudaStream_t stream) {
  using L = Smem<N>;
  const size_t bytes = sizeof(float) * L::FLOATS;
  cudaError_t err = cudaFuncSetAttribute(mamba_scan_bwd_kernel<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const Scratch sc = scratch_floats(batch, seq, dim, N);
  float* ckpt = static_cast<float*>(scratch);
  float* part_bc = ckpt + sc.ckpt;
  float* part_a = part_bc + sc.bc;
  const int nblk = (dim + CH - 1) / CH;
  const dim3 grid((unsigned)nblk, (unsigned)batch);
  mamba_scan_bwd_kernel<T, N><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(x), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(a),
      static_cast<const float*>(h0), static_cast<const float*>(dy),
      static_cast<const float*>(dh_last), static_cast<float*>(ddt), static_cast<T*>(dx),
      part_bc, part_a, static_cast<float*>(dh0), ckpt, seq, dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)batch * seq, dn = (long long)dim * N;
  const long long items = rows * 2 * N + dn;
  mamba_bwd_sum_kernel<N><<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
      part_bc, part_a, static_cast<float*>(db), static_cast<float*>(dc), static_cast<float*>(da),
      rows, nblk, batch, dn);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int n, const void* dt, const void* x, const void* b, const void* c, const void* a,
             const void* h0, const void* dy, const void* dh_last, void* ddt, void* dx, void* db,
             void* dc, void* da, void* dh0, void* scratch, int batch, int seq, int dim,
             cudaStream_t stream) {
  switch (n) {
    case 4:
      return launch<T, 4>(dt, x, b, c, a, h0, dy, dh_last, ddt, dx, db, dc, da, dh0, scratch,
                          batch, seq, dim, stream);
    case 8:
      return launch<T, 8>(dt, x, b, c, a, h0, dy, dh_last, ddt, dx, db, dc, da, dh0, scratch,
                          batch, seq, dim, stream);
    case 16:
      return launch<T, 16>(dt, x, b, c, a, h0, dy, dh_last, ddt, dx, db, dc, da, dh0, scratch,
                           batch, seq, dim, stream);
    case 32:
      return launch<T, 32>(dt, x, b, c, a, h0, dy, dh_last, ddt, dx, db, dc, da, dh0, scratch,
                           batch, seq, dim, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch the backward of (batch, seq, dim, n) needs: the
// checkpoints, the blocks' dB/dC partials and the rows' da partials.
extern "C" long long mamba_scan_bwd_scratch(int batch, int seq, int dim, int n) {
  const Scratch sc = scratch_floats(batch, seq, dim, n);
  return sc.ckpt + sc.bc + sc.a;
}

// The scan's backward: two launches (the reverse walk, then the sums over
// channel blocks and batch rows). dt, dy: (batch, seq, dim) float32; x:
// (batch, seq, dim) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1); b, c:
// (batch, seq, n) float32; a: (dim, n) float32; h0, dh_last: (batch, dim,
// n) float32 or null (zeros). Writes ddt (float32) and dx (x's dtype) of
// dt's shape, db, dc (batch, seq, n), da (dim, n) and, when dh0 is not null,
// dh0 (batch, dim, n), all float32. scratch: mamba_scan_bwd_scratch(...)
// floats. All contiguous and 16-byte aligned.
extern "C" int mamba_scan_bwd(int x_bf16, const void* dt, const void* x, const void* b,
                              const void* c, const void* a, const void* h0, const void* dy,
                              const void* dh_last, void* ddt, void* dx, void* db, void* dc,
                              void* da, void* dh0, void* scratch, int batch, int seq, int dim,
                              int n, void* stream) {
  if (batch <= 0 || dim <= 0) return 0;
  if (seq < 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return x_bf16 ? dispatch<__nv_bfloat16>(n, dt, x, b, c, a, h0, dy, dh_last, ddt, dx, db, dc,
                                          da, dh0, scratch, batch, seq, dim, s)
                : dispatch<float>(n, dt, x, b, c, a, h0, dy, dh_last, ddt, dx, db, dc, da, dh0,
                                  scratch, batch, seq, dim, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
