// Batched KKT water-filling residual, one bisection step of the batched
// allocator (core/solver_batched.py): for every fleet b of a (B, K) batch
//
//   r_b = sum_k clip((T_b - c0_bk) / (c2_bk * tau_b + c1_bk), lo_bk, hi_bk)
//         - total_b
//
// Replaces the Pallas TPU kernel `waterfill_residual_pallas`
// (src/repro/kernels/waterfill.py:47), which streams (8, K) coefficient
// tiles through VMEM, K padded to 128 lanes, in float32 only. This kernel
// takes float64 as well: the allocator's default path is float64 (its
// decisions must follow the NumPy solver's), and on the card the solver
// runs here. The TPU wrapper's padding to (8, 128) is VMEM layout and is
// not carried over; padded learner slots that are in the data
// (lo = hi = 0) clip to 0 and add nothing.
//
// Bound: memory. A call reads the five (B, K) rows and three (B,) columns
// once and writes (B,): at the fleet-scale solve of chip_smoke.py
// (B = 131,072, K = 8, float64) that is 46.1 MB, 13.8 us at 3.35 TB/s; it
// does one divide and five other operations per learner, far below the
// card's float64 rate.
//
// Design: one thread per fleet, which walks its row k = 0..K-1 and adds in
// index order, as the plain version (kernels/ref.py) and the reference's
// CPU program do. Every product, sum and quotient is rounded on its own
// (__dmul_rn/__fmul_rn and friends: no fused multiply-add), so the kernel
// gives the plain version's bits. Neighbouring threads read neighbouring
// rows, so a warp's loads cover whole cache lines over its K steps.
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

template <typename F>
int launch(const F* tau, const F* c2, const F* c1, const F* c0, const F* t,
           const F* lo, const F* hi, const F* total, F* out, long long b,
           int k, void* stream) {
  if (b <= 0) return 0;
  const int threads = 128;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  waterfill_residual_kernel<F><<<(unsigned)blocks, threads, 0,
                                 (cudaStream_t)stream>>>(
      tau, c2, c1, c0, t, lo, hi, total, out, b, k);
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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
