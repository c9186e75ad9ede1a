// The accumulate/flush epilogue of the async train+aggregate step, for
// every leaf of the model in one launch:
//   acc1      = 1 * acc + sum_k w[k] * locals[k]
//   server'   = keep * server + flush * acc1
//   acc'      = (1 - flush) * acc1
//
// Replaces the async form's epilogue of the Pallas TPU megakernel
// `train_agg_step_pallas` (src/repro/kernels/train_step.py:119), which folds
// the trained learners into the accumulator and applies the masked flush as
// `fed_agg` contractions inside its body. The trained locals come from the
// training kernel of train_step.cu; the Python wrapper launches this kernel
// once a group step with every leaf.
//
// Bound: memory. Per element the pass reads K locals, acc and server and
// writes server' and acc': (K + 4) floats, against 2K + 6 FLOPs. For the
// paper's model (280,934 parameters in 8 leaves, K = 10) that is 15.7 MB,
// about 4.7 us at 3.35 TB/s, so at these sizes a launch costs more than the
// bytes: one launch takes every leaf, as in fed_agg.cu.
//
// Design: the leaves' pointers and sizes travel in one by-value kernel
// parameter (at most MAX_LEAVES leaves). A leaf whose pointers all lie on
// 16-byte boundaries and whose size is a multiple of 4 is walked in float4
// units, any other leaf in single floats. The threads walk the leaves'
// concatenated unit space in one grid-stride pass, one thread per unit, so
// each of the K rows of a leaf is read once, coalesced across the warp. The
// arithmetic is the plain version's, as in fed_agg.cu: the accumulate
// starts from 0, adds 1 * acc, then w[0] * locals[0] ... w[K-1] *
// locals[K-1] in that order; the flush is 0 + keep * server + flush * acc1.
// Every product is rounded before it is added (no fused multiply-add), so a
// leaf's result is the same bits whether it is taken alone or with others,
// and in float4 or single units.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 32;

// the host's table: per leaf locals, acc, server, server_out, acc_out, n
constexpr int FIELDS = 6;

struct Leaves {
  const float* locals[MAX_LEAVES];  // (K, n[l]) each
  const float* acc[MAX_LEAVES];     // (n[l]) each
  const float* server[MAX_LEAVES];
  float* server_out[MAX_LEAVES];
  float* acc_out[MAX_LEAVES];
  long long n[MAX_LEAVES];
  long long start[MAX_LEAVES];  // offset of leaf l in the concatenated unit space
  long long units[MAX_LEAVES];  // n / 4 for a float4 leaf, else n
  int vec[MAX_LEAVES];
  int count;
};

struct Flush {
  float keep, flush, drain;
};

__device__ __forceinline__ void one(float a, float srv, const Flush& f, float& s_out,
                                    float& a_out) {
  s_out = __fadd_rn(__fadd_rn(0.0f, __fmul_rn(f.keep, srv)), __fmul_rn(f.flush, a));
  a_out = __fmul_rn(f.drain, a);
}

__global__ void accum_flush_kernel(const __grid_constant__ Leaves lv,
                                   const float* __restrict__ w, float keep, float flush,
                                   int k) {
  const Flush f{keep, flush, __fsub_rn(1.0f, flush)};
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int l = 0; l < lv.count; ++l) {
    const long long n = lv.n[l];
    // this thread's first unit in leaf l of the grid-stride walk over the
    // concatenated space: (start + i) = t (mod stride)
    long long i = (t - lv.start[l]) % stride;
    if (i < 0) i += stride;
    if (lv.vec[l]) {
      const float4* __restrict__ loc = reinterpret_cast<const float4*>(lv.locals[l]);
      const float4* __restrict__ acc = reinterpret_cast<const float4*>(lv.acc[l]);
      const float4* __restrict__ srv = reinterpret_cast<const float4*>(lv.server[l]);
      float4* __restrict__ s_out = reinterpret_cast<float4*>(lv.server_out[l]);
      float4* __restrict__ a_out = reinterpret_cast<float4*>(lv.acc_out[l]);
      const long long row = n / 4;
      for (; i < lv.units[l]; i += stride) {
        const float4 a0 = acc[i];
        float4 a = make_float4(__fadd_rn(0.0f, __fmul_rn(1.0f, a0.x)),
                               __fadd_rn(0.0f, __fmul_rn(1.0f, a0.y)),
                               __fadd_rn(0.0f, __fmul_rn(1.0f, a0.z)),
                               __fadd_rn(0.0f, __fmul_rn(1.0f, a0.w)));
        for (int j = 0; j < k; ++j) {
          const float wj = w[j];
          const float4 x = loc[(long long)j * row + i];
          a.x = __fadd_rn(a.x, __fmul_rn(wj, x.x));
          a.y = __fadd_rn(a.y, __fmul_rn(wj, x.y));
          a.z = __fadd_rn(a.z, __fmul_rn(wj, x.z));
          a.w = __fadd_rn(a.w, __fmul_rn(wj, x.w));
        }
        const float4 s = srv[i];
        float4 so, ao;
        one(a.x, s.x, f, so.x, ao.x);
        one(a.y, s.y, f, so.y, ao.y);
        one(a.z, s.z, f, so.z, ao.z);
        one(a.w, s.w, f, so.w, ao.w);
        s_out[i] = so;
        a_out[i] = ao;
      }
    } else {
      const float* __restrict__ loc = lv.locals[l];
      for (; i < n; i += stride) {
        float a = __fadd_rn(0.0f, __fmul_rn(1.0f, lv.acc[l][i]));
        for (int j = 0; j < k; ++j) a = __fadd_rn(a, __fmul_rn(w[j], loc[(long long)j * n + i]));
        one(a, lv.server[l][i], f, lv.server_out[l][i], lv.acc_out[l][i]);
      }
    }
  }
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// table: count rows of FIELDS int64s, (locals, acc, server, server_out,
// acc_out, n) for each leaf; locals (k, n) float32, the others (n) float32,
// all on the card; w (k) float32 on the card; 1 <= count <= MAX_LEAVES (32,
// kernels/accum_flush.py's too).
extern "C" int accum_flush_leaves_f32(const long long* table, int count, const float* w,
                                      int k, float keep, float flush, void* stream) {
  if (count < 1 || count > MAX_LEAVES || k < 0) return (int)cudaErrorInvalidValue;
  Leaves lv;
  long long total = 0;
  for (int l = 0; l < count; ++l) {
    const long long* row = table + (long long)FIELDS * l;
    lv.locals[l] = reinterpret_cast<const float*>(row[0]);
    lv.acc[l] = reinterpret_cast<const float*>(row[1]);
    lv.server[l] = reinterpret_cast<const float*>(row[2]);
    lv.server_out[l] = reinterpret_cast<float*>(row[3]);
    lv.acc_out[l] = reinterpret_cast<float*>(row[4]);
    lv.n[l] = row[5];
    lv.vec[l] = lv.n[l] % 4 == 0 && aligned(lv.locals[l]) && aligned(lv.acc[l]) &&
                aligned(lv.server[l]) && aligned(lv.server_out[l]) && aligned(lv.acc_out[l]);
    lv.units[l] = lv.vec[l] ? lv.n[l] / 4 : lv.n[l];
    lv.start[l] = total;
    total += lv.units[l];
  }
  lv.count = count;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  accum_flush_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(lv, w, keep,
                                                                            flush, k);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
