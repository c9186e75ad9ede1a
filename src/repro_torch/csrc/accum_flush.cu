// The accumulate/flush epilogue of the async train+aggregate step, on one
// leaf of the model:
//   acc1      = 1 * acc + sum_k w[k] * locals[k]
//   server'   = keep * server + flush * acc1
//   acc'      = (1 - flush) * acc1
//
// Replaces the async form's epilogue of the Pallas TPU megakernel
// `train_agg_step_pallas` (src/repro/kernels/train_step.py:119), which folds
// the trained learners into the accumulator and applies the masked flush as
// `fed_agg` contractions inside its body. The trained locals come from the
// cycle kernels of train_step.cu; the Python wrapper launches this kernel
// once per leaf.
//
// Bound: memory. Per element the pass reads K locals, acc and server and
// writes server' and acc': (K + 4) floats, against 2K + 6 FLOPs. For the
// paper's model (280,934 parameters, K = 10) that is 15.7 MB, about 4.7 us
// at 3.35 TB/s.
//
// Design: one thread per element in a grid-stride loop, so each of the K
// locals' rows is read once, coalesced across the warp. The arithmetic is
// the plain version's, as in fed_agg.cu: the accumulate starts from 0, adds
// 1 * acc, then w[0] * locals[0] ... w[K-1] * locals[K-1] in that order; the
// flush is 0 + keep * server + flush * acc1. Every product is rounded before
// it is added (no fused multiply-add).
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_runtime.h>

namespace {

__global__ void accum_flush_kernel(const float* __restrict__ locals,
                                   const float* __restrict__ w,
                                   const float* __restrict__ acc,
                                   const float* __restrict__ server,
                                   float keep, float flush,
                                   float* __restrict__ server_out,
                                   float* __restrict__ acc_out, int k,
                                   long long n) {
  const float drain = __fsub_rn(1.0f, flush);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float a = __fadd_rn(0.0f, __fmul_rn(1.0f, acc[i]));
    for (int j = 0; j < k; ++j) {
      a = __fadd_rn(a, __fmul_rn(w[j], locals[(long long)j * n + i]));
    }
    server_out[i] =
        __fadd_rn(__fadd_rn(0.0f, __fmul_rn(keep, server[i])), __fmul_rn(flush, a));
    acc_out[i] = __fmul_rn(drain, a);
  }
}

}  // namespace

extern "C" int accum_flush_f32(const float* locals, const float* w,
                               const float* acc, const float* server,
                               float keep, float flush, float* server_out,
                               float* acc_out, int k, long long n,
                               void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  accum_flush_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      locals, w, acc, server, keep, flush, server_out, acc_out, k, n);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
