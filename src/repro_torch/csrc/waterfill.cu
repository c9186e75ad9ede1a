// Batched KKT water-filling residuals, one bisection step of the batched
// allocator (core/solver_batched.py). For every fleet b of a (B, K) batch:
//
//   time-only (waterfill_residual_*):
//     r_b = sum_k clip((T_b - c0_bk) / (c2_bk * tau_b + c1_bk), lo_bk, hi_bk)
//           - total_b
//   energy-budgeted (waterfill_energy_residual_*, arXiv 2012.00143):
//     r_b = sum_k clip(min((T_b - c0_bk) / (c2_bk * tau_b + c1_bk),
//                          (eb_bk - e0_bk) / (e2_bk * tau_b + e1_bk)),
//                      lo_bk, hi_bk) - total_b
//
// They replace the Pallas TPU kernels `waterfill_residual_pallas`
// (src/repro/kernels/waterfill.py:47) and `waterfill_energy_residual_pallas`
// (src/repro/kernels/waterfill.py:117), which stream (8, K) coefficient
// tiles through VMEM, K padded to 128 lanes, in float32 only. These take
// float64 as well: the allocator's default path is float64 (its decisions
// must follow the NumPy solver's), and on the card the solver runs here.
// The TPU wrappers' padding to (8, 128) is VMEM layout and is not carried
// over; padded learner slots that are in the data (lo = hi = 0) clip to 0
// and add nothing.
//
// Bound: memory. The time-only kernel reads five (B, K) rows and three (B,)
// columns once and writes (B,): at the fleet-scale solve of chip_smoke.py
// (B = 131,072, K = 8, float64) 46.1 MB, 13.8 us at 3.35 TB/s. The energy
// kernel reads nine (B, K) rows: 79.7 MB, 23.8 us in float64 (39.8 MB,
// 11.9 us in float32). Both do one or two divides and a few other
// operations per learner, far below the card's float64 rate.
//
// Design: each fleet's row is added in index order k = 0..K-1, as the
// plain versions (kernels/ref.py) and the reference's CPU program add it.
// Every product, sum and quotient is rounded on its own (__dmul_rn,
// __fmul_rn and friends: no fused multiply-add), so a kernel gives its
// plain version's bits. The time-only kernel runs one thread a fleet, which
// walks its row; neighbouring threads read neighbouring rows, so a warp's
// loads cover whole cache lines over its K steps. The energy kernel reads
// nine rows, and with one thread a fleet their lines did not stay in L1
// between a thread's K steps (float64: 0.186 ms a launch against the 0.024
// ms bound, chip_smoke.py on the H100); so it stages each block's rows
// through shared memory instead (see below) and reads them coalesced.
//
// NaN and infinity: the min of the energy kernel returns NaN when either
// side is NaN, as torch.minimum and jnp.minimum do (a plain `a < b ? a : b`
// would drop a NaN on one side, and fmin drops it on both); the clip keeps
// a NaN. With eb = +inf and zero energy coefficients the budget side is
// +inf / 0 = +inf, so min(d_time, +inf) is d_time bitwise and the energy
// kernel gives the time-only kernel's residual.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_runtime.h>

namespace {

template <typename F>
struct Rn;

template <>
struct Rn<float> {
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float div(float a, float b) { return __fdiv_rn(a, b); }
};

template <>
struct Rn<double> {
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

template <typename F>
__global__ void waterfill_residual_kernel(
    const F* __restrict__ tau, const F* __restrict__ c2,
    const F* __restrict__ c1, const F* __restrict__ c0,
    const F* __restrict__ t, const F* __restrict__ lo,
    const F* __restrict__ hi, const F* __restrict__ total,
    F* __restrict__ out, long long b, int k) {
  using R = Rn<F>;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += stride) {
    const F tau_i = tau[i];
    const F t_i = t[i];
    const long long row = i * k;
    F acc = F(0);
    for (int j = 0; j < k; ++j) {
      const long long e = row + j;
      F d = R::div(R::sub(t_i, c0[e]), R::add(R::mul(c2[e], tau_i), c1[e]));
      // clip as max-then-min; a NaN stays NaN, as in the plain version
      const F l = lo[e], h = hi[e];
      d = d < l ? l : d;
      d = d > h ? h : d;
      acc = j == 0 ? d : R::add(acc, d);
    }
    out[i] = R::sub(acc, total[i]);
  }
}

// min(a, b) that is NaN when either side is NaN
template <typename F>
__device__ F nan_min(F a, F b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// The energy kernel stages each block's rows: a block owns `fb` fleets;
// its threads walk the fb * K learners in index order (neighbouring threads
// on neighbouring addresses of all nine rows), compute each learner's
// clipped d, and leave it in shared memory at (fleet, j), the row padded to
// an odd length so the second phase reads it without bank conflicts; then
// one thread a fleet adds its row in index order.
template <typename F>
__global__ void waterfill_energy_residual_kernel(
    const F* __restrict__ tau, const F* __restrict__ c2,
    const F* __restrict__ c1, const F* __restrict__ c0,
    const F* __restrict__ t, const F* __restrict__ e2,
    const F* __restrict__ e1, const F* __restrict__ e0,
    const F* __restrict__ eb, const F* __restrict__ lo,
    const F* __restrict__ hi, const F* __restrict__ total,
    F* __restrict__ out, long long b, int k, int fb, int kp) {
  using R = Rn<F>;
  extern __shared__ unsigned char smem[];
  F* ds = reinterpret_cast<F*>(smem);  // fb rows of kp
  for (long long f0 = (long long)blockIdx.x * fb; f0 < b;
       f0 += (long long)gridDim.x * fb) {
    const int nf = (int)(b - f0 < fb ? b - f0 : fb);
    const int n = nf * k;
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      const int f = x / k, j = x - f * k;
      const long long e = f0 * k + x;
      const F tau_i = tau[f0 + f];
      const F dt = R::div(R::sub(t[f0 + f], c0[e]),
                          R::add(R::mul(c2[e], tau_i), c1[e]));
      const F de =
          R::div(R::sub(eb[e], e0[e]), R::add(R::mul(e2[e], tau_i), e1[e]));
      F d = nan_min(dt, de);
      const F l = lo[e], h = hi[e];
      d = d < l ? l : d;
      d = d > h ? h : d;
      ds[f * kp + j] = d;
    }
    __syncthreads();
    for (int f = threadIdx.x; f < nf; f += blockDim.x) {
      const F* row = ds + f * kp;
      F acc = row[0];
      for (int j = 1; j < k; ++j) acc = R::add(acc, row[j]);
      out[f0 + f] = R::sub(acc, total[f0 + f]);
    }
    __syncthreads();
  }
}

// blocks of 128 threads, one thread a fleet, at most 32 blocks an SM
inline unsigned grid_for(long long b) {
  const long long threads = 128;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  return (unsigned)blocks;
}

template <typename F>
int launch(const F* tau, const F* c2, const F* c1, const F* c0, const F* t,
           const F* lo, const F* hi, const F* total, F* out, long long b,
           int k, void* stream) {
  if (b <= 0) return 0;
  waterfill_residual_kernel<F><<<grid_for(b), 128, 0, (cudaStream_t)stream>>>(
      tau, c2, c1, c0, t, lo, hi, total, out, b, k);
  return (int)cudaGetLastError();
}

template <typename F>
int launch_energy(const F* tau, const F* c2, const F* c1, const F* c0,
                  const F* t, const F* e2, const F* e1, const F* e0,
                  const F* eb, const F* lo, const F* hi, const F* total,
                  F* out, long long b, int k, void* stream) {
  if (b <= 0) return 0;
  // at most 4096 staged values (32 KB in float64) and 128 fleets a block
  const int kp = k | 1;
  int fb = 4096 / kp;
  if (fb > 128) fb = 128;
  if (fb < 1) fb = 1;
  long long blocks = (b + fb - 1) / fb;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  const size_t smem = (size_t)fb * kp * sizeof(F);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        waterfill_energy_residual_kernel<F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  waterfill_energy_residual_kernel<F>
      <<<(unsigned)blocks, 256, smem, (cudaStream_t)stream>>>(
          tau, c2, c1, c0, t, e2, e1, e0, eb, lo, hi, total, out, b, k, fb,
          kp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int waterfill_residual_f64(const double* tau, const double* c2,
                                      const double* c1, const double* c0,
                                      const double* t, const double* lo,
                                      const double* hi, const double* total,
                                      double* out, long long b, int k,
                                      void* stream) {
  return launch<double>(tau, c2, c1, c0, t, lo, hi, total, out, b, k, stream);
}

extern "C" int waterfill_residual_f32(const float* tau, const float* c2,
                                      const float* c1, const float* c0,
                                      const float* t, const float* lo,
                                      const float* hi, const float* total,
                                      float* out, long long b, int k,
                                      void* stream) {
  return launch<float>(tau, c2, c1, c0, t, lo, hi, total, out, b, k, stream);
}

extern "C" int waterfill_energy_residual_f64(
    const double* tau, const double* c2, const double* c1, const double* c0,
    const double* t, const double* e2, const double* e1, const double* e0,
    const double* eb, const double* lo, const double* hi, const double* total,
    double* out, long long b, int k, void* stream) {
  return launch_energy<double>(tau, c2, c1, c0, t, e2, e1, e0, eb, lo, hi,
                               total, out, b, k, stream);
}

extern "C" int waterfill_energy_residual_f32(
    const float* tau, const float* c2, const float* c1, const float* c0,
    const float* t, const float* e2, const float* e1, const float* e0,
    const float* eb, const float* lo, const float* hi, const float* total,
    float* out, long long b, int k, void* stream) {
  return launch_energy<float>(tau, c2, c1, c0, t, e2, e1, e0, eb, lo, hi,
                              total, out, b, k, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
