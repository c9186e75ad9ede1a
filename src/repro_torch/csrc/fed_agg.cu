// Staleness-weighted federated aggregation: out[i] = sum_k w[k] * x[k][i],
// for every leaf of a model in one launch, and for G groups of K learners
// at once: out[g][i] = sum_k w[g K + k] * x[g K + k][i].
//
// Replaces the Pallas TPU kernel `fed_agg_pallas`
// (src/repro/kernels/fed_agg.py:30), which streams (K, block_n) tiles of
// the learner-stacked model through VMEM and writes their weighted sum.
//
// Bound: memory. The pass reads G K n floats and writes G n; it does 2
// FLOPs per element read, far below the card's ~20 FLOP/byte FP32 balance
// point. For the paper's model (280,934 parameters in 8 leaves, K = 10)
// that is 12.4 MB, about 3.7 us at 3.35 TB/s, so at these sizes the launch
// costs more than the bytes: one launch takes every leaf of an
// aggregation. A fleet of fleets (G = 1250 fleets of K = 8) reads 11.2 GB
// in its one launch.
//
// Design: the leaves' pointers and sizes travel in one by-value kernel
// parameter (at most MAX_LEAVES leaves). The threads walk the leaves'
// concatenated (group, index) space in one grid-stride pass, one thread
// per output element, so each of the K rows of a group's leaf is read
// once, coalesced across the warp. The sum runs over k in order 0..K-1 in
// float32 with every product rounded before it is added (no fused
// multiply-add), which is the reference's arithmetic; a leaf's result is
// therefore the same bits whether it is aggregated alone, with other
// leaves, or as one group of many.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 32;

struct Leaves {
  const float* x[MAX_LEAVES];  // (G K, n[l]) each
  float* out[MAX_LEAVES];      // (G, n[l]) each
  long long start[MAX_LEAVES]; // offset of leaf l in the concatenated index space
  long long n[MAX_LEAVES];
  int count;
};

__global__ void fed_agg_kernel(const __grid_constant__ Leaves lv, const float* __restrict__ w,
                               int k, int groups) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int l = 0; l < lv.count; ++l) {
    const float* __restrict__ x = lv.x[l];
    float* __restrict__ out = lv.out[l];
    const long long n = lv.n[l], size = (long long)groups * n;
    // this thread's first index in leaf l of the grid-stride walk over the
    // concatenated space: (start + e) = t (mod stride)
    long long e = (t - lv.start[l]) % stride;
    if (e < 0) e += stride;
    for (; e < size; e += stride) {
      const long long g = e / n, i = e - g * n;
      const float* __restrict__ xg = x + g * k * n + i;
      const float* __restrict__ wg = w + g * k;
      float acc = 0.0f;
      for (int j = 0; j < k; ++j) {
        acc = __fadd_rn(acc, __fmul_rn(wg[j], xg[(long long)j * n]));
      }
      out[e] = acc;
    }
  }
}

}  // namespace

// xs[l]: (groups k, ns[l]) float32, outs[l]: (groups, ns[l]) float32, w:
// (groups k) float32, all on the card; 1 <= count <= MAX_LEAVES (32,
// kernels/fed_agg.py's too).
extern "C" int fed_agg_leaves_f32(const float* const* xs, float* const* outs,
                                  const long long* ns, int count, const float* w, int k,
                                  int groups, void* stream) {
  if (count < 1 || count > MAX_LEAVES || k < 0 || groups < 1) return (int)cudaErrorInvalidValue;
  Leaves lv;
  long long total = 0;
  for (int l = 0; l < count; ++l) {
    lv.x[l] = xs[l];
    lv.out[l] = outs[l];
    lv.start[l] = total;
    lv.n[l] = ns[l];
    total += (long long)groups * ns[l];
  }
  lv.count = count;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  fed_agg_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(lv, w, k, groups);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
