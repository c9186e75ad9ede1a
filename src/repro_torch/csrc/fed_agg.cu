// Staleness-weighted federated aggregation: out[i] = sum_k w[k] * x[k][i].
//
// Replaces the Pallas TPU kernel `fed_agg_pallas`
// (src/repro/kernels/fed_agg.py:30), which streams (K, block_n) tiles of
// the learner-stacked model through VMEM and writes their weighted sum.
//
// Bound: memory. The pass reads K * n floats and writes n; it does 2 FLOPs
// per element read, far below the card's ~20 FLOP/byte FP32 balance point.
// For the paper's model (280,934 parameters, K = 10) that is 12.4 MB, about
// 3.7 us at 3.35 TB/s, so at these sizes the launch costs more than the
// bytes.
//
// Design: one thread per output element in a grid-stride loop, so each of
// the K rows is read once, coalesced across the warp. The sum runs over k in
// order 0..K-1 in float32 with every product rounded before it is added
// (no fused multiply-add), which is the reference's arithmetic.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_runtime.h>

namespace {

__global__ void fed_agg_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               float* __restrict__ out, int k, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(w[j], x[(long long)j * n + i]));
    }
    out[i] = acc;
  }
}

}  // namespace

extern "C" int fed_agg_f32(const float* x, const float* w, float* out, int k,
                           long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  fed_agg_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, w, out, k, n);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
