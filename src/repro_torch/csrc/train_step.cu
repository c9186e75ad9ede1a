// One federated cycle of K learners on a ReLU MLP: each learner k runs
// tau_k steps of full-batch gradient descent on its own masked shard,
// starting from its own parameters (cycle form of the train+aggregate step).
// The weighted aggregation of the trained learners that ends the cycle is
// the fed_agg kernel (fed_agg.cu), which the Python wrapper launches per leaf.
//
// Replaces the Pallas TPU megakernel `train_agg_step_pallas`
// (src/repro/kernels/train_step.py:119, kernel body `_make_kernel`), which
// keeps all K learners' parameters in VMEM across an in-kernel loop over
// max(tau) and computes every matrix product of the forward and backward
// pass inside its body. Here every product is computed by the tiled SGEMM
// below; nothing goes to a library.
//
// Loss (the reference's mlp.loss): masked mean NLL of log_softmax(logits),
// denominator max(sum m, 1). Per step and learner, with H_0 = x:
//   forward   H_l = relu(H_{l-1} W_l + b_l)  (l < L),  Z = H_{L-1} W_L + b_L
//   loss grad G_L = (softmax(Z) - onehot(y)) * m / max(sum m, 1)
//   backward  G_{l-1} = (G_l W_l^T) * [H_{l-1} > 0]   (from the OLD W_l)
//             W_l -= lr * H_{l-1}^T G_l,   b_l -= lr * colsum(G_l)
// A learner whose step >= tau_k is skipped by every kernel, so its
// parameters stay bitwise untouched (the lax.cond of the reference).
//
// Bound: FP32 operations. A masked-in row costs 2 * (2 * sum fan_in*fan_out
// + sum_{l>=2} fan_in*fan_out) FLOPs a step: 1,212,240 for
// [784, 300, 124, 60, 10]. The paper's allocation (K = 10, sum_k tau_k d_k =
// 198,528) needs 2.4e11 FLOPs a cycle, 3.6 ms at 67 TFLOP/s of FP32; it
// moves about 43 MB (shards once, parameters in and out), 13 us at 3.35 TB/s.
// TF32 tensor cores would keep ~3 decimal digits, too few for the 1e-4
// parity the port holds, so the products run on the FP32 units.
//
// Design: one 128x64 output tile per block of 256 threads, 8x4 outputs per
// thread, at most 128 registers a thread so two blocks share an SM, 16-deep
// k stages in two shared-memory buffers (the next stage is read from device
// memory into registers while the current one is used),
// blockIdx.z = learner, template flags for transposed operands and fused
// epilogues (bias+ReLU, ReLU-mask, in-place SGD update). A layer with at
// most 65,536 weights takes its weight gradient, a reduction over up to
// d_cap rows into a small output, in 32x32 tiles with 64-deep stages
// instead: more blocks and fewer serial stages. Every output is one chain
// of fused multiply-adds in k order in either tiling. Rows past the
// learner's last masked-in row carry zero gradient, so a small kernel counts
// them once a cycle and every kernel stops there: the work follows d_k, not
// the padded d_cap.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int GEMM_THREADS = 256;
constexpr int MAX_LAYERS = 16;
constexpr int MAX_CLASSES = 64;
// a layer with at most this many weights takes its weight gradient in
// DeepTile blocks
constexpr long long SMALL_LAYER = 1 << 16;

// A block's output tile (BM x BN, TM x TN outputs a thread) and the depth of
// one shared-memory stage (BK).
template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static_assert((BM / TM) * (BN / TN) == GEMM_THREADS, "256 threads a block");
  static constexpr int A_LOADS = BM * BK / GEMM_THREADS;
  static constexpr int B_LOADS = BK * BN / GEMM_THREADS;
};
// most products
using WideTile = Tile<128, 64, 16, 8, 4>;
// small outputs over long reductions (a small layer's weight gradient sums
// up to d_cap rows): more blocks, and a quarter of the stages
using DeepTile = Tile<32, 32, 64, 2, 2>;

enum Epilogue { EPI_BIAS, EPI_BIAS_RELU, EPI_RELU_MASK, EPI_SGD };
enum RowBound { BOUND_NONE, BOUND_M, BOUND_K };

// C (M x N) = op(A) (M x Kd) * op(B) (Kd x N) per learner z = blockIdx.z,
// finished by the epilogue. Strides s* step from one learner to the next.
struct GemmArgs {
  int m, n, kd;
  const float* a; int lda; long long sa;
  const float* b; int ldb; long long sb;
  float* c; int ldc; long long sc;
  const float* bias; long long sbias;           // EPI_BIAS, EPI_BIAS_RELU
  const float* aux; int ldaux; long long saux;  // EPI_RELU_MASK: ReLU output
  const int* tau; int step;
  const int* rows; int bound;  // the learner's row count bounds M or Kd
  float lr;                    // EPI_SGD: c -= lr * (A B)
};

template <class T, bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 2) gemm_kernel(GemmArgs g) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, TM = T::TM, TN = T::TN;
  constexpr int A_LOADS = T::A_LOADS, B_LOADS = T::B_LOADS;
  const int z = blockIdx.z;
  if (g.step >= g.tau[z]) return;
  int m = g.m, kd = g.kd;
  if (g.bound == BOUND_M) m = min(m, g.rows[z]);
  if (g.bound == BOUND_K) kd = min(kd, g.rows[z]);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= m) return;

  const float* __restrict__ a = g.a + z * g.sa;
  const float* __restrict__ b = g.b + z * g.sb;
  const int lda = g.lda, ldb = g.ldb, n = g.n;
  // two stages: the next tile is read into registers while this one is used
  __shared__ __align__(16) float as[2][BK][BM + 4];
  __shared__ __align__(16) float bs[2][BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float na[A_LOADS], nb[B_LOADS];

  // neighbouring threads read neighbouring addresses of each operand
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int e = tid + i * GEMM_THREADS;
      const int mm = TA ? e % BM : e / BK;
      const int kk = TA ? e / BM : e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      na[i] = 0.0f;
      if (gm < m && gk < kd)
        na[i] = TA ? a[(long long)gk * lda + gm] : a[(long long)gm * lda + gk];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int e = tid + i * GEMM_THREADS;
      const int nn = TB ? e / BK : e % BN;
      const int kk = TB ? e % BK : e / BN;
      const int gk = k0 + kk, gn = n0 + nn;
      nb[i] = 0.0f;
      if (gk < kd && gn < n)
        nb[i] = TB ? b[(long long)gn * ldb + gk] : b[(long long)gk * ldb + gn];
    }
  };
  auto store = [&](int stage) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int e = tid + i * GEMM_THREADS;
      as[stage][TA ? e / BM : e % BK][TA ? e % BM : e / BK] = na[i];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int e = tid + i * GEMM_THREADS;
      bs[stage][TB ? e % BK : e / BN][TB ? e / BK : e % BN] = nb[i];
    }
  };

  load(0);
  store(0);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < kd; k0 += BK) {
    const bool more = k0 + BK < kd;
    if (more) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[TM], rb[TN];
      if constexpr (TM == 8 && TN == 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[s][kk][ty * TM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[s][kk][ty * TM + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[s][kk][tx * TN]);
        ra[0] = a0.x; ra[1] = a0.y; ra[2] = a0.z; ra[3] = a0.w;
        ra[4] = a1.x; ra[5] = a1.y; ra[6] = a1.z; ra[7] = a1.w;
        rb[0] = b0.x; rb[1] = b0.y; rb[2] = b0.z; rb[3] = b0.w;
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) ra[i] = as[s][kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) rb[j] = bs[s][kk][tx * TN + j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier
    if (more) store(s ^ 1);
    __syncthreads();
    s ^= 1;
  }

  float* __restrict__ c = g.c + z * g.sc;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= n) continue;
      const long long off = (long long)gm * g.ldc + gn;
      const float v = acc[i][j];
      if (EPI == EPI_BIAS) {
        c[off] = v + g.bias[z * g.sbias + gn];
      } else if (EPI == EPI_BIAS_RELU) {
        const float h = v + g.bias[z * g.sbias + gn];
        c[off] = h > 0.0f ? h : 0.0f;
      } else if (EPI == EPI_RELU_MASK) {
        c[off] = g.aux[z * g.saux + (long long)gm * g.ldaux + gn] > 0.0f ? v : 0.0f;
      } else {
        c[off] = __fsub_rn(c[off], __fmul_rn(g.lr, v));
      }
    }
  }
}

// Once a cycle: rows[z] = 1 + the last row with a nonzero mask (0 if none),
// inv_den[z] = 1 / max(sum of the mask, 1).
__global__ void mask_stats_kernel(const float* __restrict__ mask, int d_cap,
                                  int* __restrict__ rows,
                                  float* __restrict__ inv_den) {
  __shared__ float ssum[256];
  __shared__ int slast[256];
  const int z = blockIdx.x, tid = threadIdx.x;
  float s = 0.0f;
  int last = 0;
  for (int r = tid; r < d_cap; r += blockDim.x) {
    const float v = mask[(long long)z * d_cap + r];
    s += v;
    if (v != 0.0f) last = r + 1;
  }
  ssum[tid] = s;
  slast[tid] = last;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if (tid < half) {
      ssum[tid] += ssum[tid + half];
      slast[tid] = max(slast[tid], slast[tid + half]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    rows[z] = slast[0];
    inv_den[z] = 1.0f / fmaxf(ssum[0], 1.0f);
  }
}

// Gradient of the masked mean NLL with respect to the logits, one thread a
// row: (softmax(z) - onehot(y)) * m * inv_den, softmax taken as
// exp(log_softmax) as the reference differentiates it.
__global__ void xent_grad_kernel(const float* __restrict__ logits,
                                 const int* __restrict__ y,
                                 const float* __restrict__ mask,
                                 const float* __restrict__ inv_den,
                                 const int* __restrict__ rows,
                                 const int* __restrict__ tau, int step,
                                 int d_cap, int classes,
                                 float* __restrict__ grad) {
  const int z = blockIdx.y;
  if (step >= tau[z]) return;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows[z]) return;
  const long long row = (long long)z * d_cap + r;
  const float* zr = logits + row * classes;
  float mx = -INFINITY;
  for (int j = 0; j < classes; ++j) mx = fmaxf(mx, zr[j]);
  float s = 0.0f;
  for (int j = 0; j < classes; ++j) s += expf(zr[j] - mx);
  const float lse = logf(s);
  const float coef = inv_den[z] * mask[row];
  const int label = y[row];
  float* gr = grad + row * classes;
  for (int j = 0; j < classes; ++j) {
    const float p = expf((zr[j] - mx) - lse);
    gr[j] = (p - (j == label ? 1.0f : 0.0f)) * coef;
  }
}

// b -= lr * colsum(G) over the learner's rows; 32 columns x 8 row slices a
// block, the slices summed in a fixed order.
__global__ void bias_update_kernel(const float* __restrict__ grad, int n,
                                   long long sg, const int* __restrict__ rows,
                                   const int* __restrict__ tau, int step,
                                   float* __restrict__ bias, float lr) {
  __shared__ float part[8][33];
  const int z = blockIdx.y;
  if (step >= tau[z]) return;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * 32 + tx;
  const int r_end = rows[z];
  float s = 0.0f;
  if (col < n)
    for (int r = ty; r < r_end; r += 8) s += grad[z * sg + (long long)r * n + col];
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < n) {
    float t = 0.0f;
    for (int i = 0; i < 8; ++i) t += part[i][tx];
    float* bz = bias + (long long)z * n + col;
    *bz = __fsub_rn(*bz, __fmul_rn(lr, t));
  }
}

template <class T, bool TA, bool TB, int EPI>
int launch_gemm(const GemmArgs& g, int k, cudaStream_t stream) {
  dim3 grid((g.n + T::BN - 1) / T::BN, (g.m + T::BM - 1) / T::BM, k);
  gemm_kernel<T, TA, TB, EPI><<<grid, GEMM_THREADS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

#define CHECK(expr)          \
  do {                       \
    const int rc_ = (expr);  \
    if (rc_ != 0) return rc_; \
  } while (0)

}  // namespace

// x (K, d_cap, widths[0]) f32, y (K, d_cap) i32, mask (K, d_cap) f32,
// tau (K,) i32: device pointers. widths: host array of n_layers + 1 ints.
// w, b: host arrays of n_layers device pointers to the learners' leaves,
// (K, widths[l], widths[l+1]) and (K, widths[l+1]), updated in place.
// ws: device workspace of 2 * K * d_cap * sum(widths[1:]) floats;
// rows (K,) i32 and inv_den (K,) f32: device scratch.
extern "C" int train_cycle_f32(const float* x, const int* y, const float* mask,
                               const int* tau, int k, int d_cap, int n_layers,
                               const int* widths, float* const* w,
                               float* const* b, float* ws, int* rows,
                               float* inv_den, float lr, int max_tau,
                               void* stream_ptr) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  if (widths[n_layers] > MAX_CLASSES) return (int)cudaErrorInvalidValue;
  if (k <= 0 || d_cap <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;

  // h[l], g[l] for l = 1..L: activations and their gradients, (K, d_cap, widths[l])
  const float* h[MAX_LAYERS + 1];
  float* hw[MAX_LAYERS + 1];
  float* gr[MAX_LAYERS + 1];
  float* p = ws;
  for (int l = 1; l <= n_layers; ++l) {
    hw[l] = p;
    p += (long long)k * d_cap * widths[l];
    gr[l] = p;
    p += (long long)k * d_cap * widths[l];
  }
  h[0] = x;
  for (int l = 1; l <= n_layers; ++l) h[l] = hw[l];
  auto act_stride = [&](int l) { return (long long)d_cap * widths[l]; };

  mask_stats_kernel<<<k, 256, 0, stream>>>(mask, d_cap, rows, inv_den);
  CHECK((int)cudaGetLastError());

  for (int step = 0; step < max_tau; ++step) {
    for (int l = 1; l <= n_layers; ++l) {
      GemmArgs g{};
      g.m = d_cap; g.n = widths[l]; g.kd = widths[l - 1];
      g.a = h[l - 1]; g.lda = widths[l - 1]; g.sa = act_stride(l - 1);
      g.b = w[l - 1]; g.ldb = widths[l]; g.sb = (long long)widths[l - 1] * widths[l];
      g.c = hw[l]; g.ldc = widths[l]; g.sc = act_stride(l);
      g.bias = b[l - 1]; g.sbias = widths[l];
      g.tau = tau; g.step = step; g.rows = rows; g.bound = BOUND_M;
      if (l < n_layers) CHECK((launch_gemm<WideTile, false, false, EPI_BIAS_RELU>(g, k, stream)));
      else CHECK((launch_gemm<WideTile, false, false, EPI_BIAS>(g, k, stream)));
    }

    const int classes = widths[n_layers];
    dim3 xgrid((d_cap + 127) / 128, k);
    xent_grad_kernel<<<xgrid, 128, 0, stream>>>(h[n_layers], y, mask, inv_den,
                                                rows, tau, step, d_cap, classes,
                                                gr[n_layers]);
    CHECK((int)cudaGetLastError());

    for (int l = n_layers; l >= 1; --l) {
      if (l > 1) {  // G_{l-1} = (G_l W_l^T) * [H_{l-1} > 0], before W_l moves
        GemmArgs g{};
        g.m = d_cap; g.n = widths[l - 1]; g.kd = widths[l];
        g.a = gr[l]; g.lda = widths[l]; g.sa = act_stride(l);
        g.b = w[l - 1]; g.ldb = widths[l]; g.sb = (long long)widths[l - 1] * widths[l];
        g.c = gr[l - 1]; g.ldc = widths[l - 1]; g.sc = act_stride(l - 1);
        g.aux = h[l - 1]; g.ldaux = widths[l - 1]; g.saux = act_stride(l - 1);
        g.tau = tau; g.step = step; g.rows = rows; g.bound = BOUND_M;
        CHECK((launch_gemm<WideTile, false, true, EPI_RELU_MASK>(g, k, stream)));
      }
      {  // W_l -= lr * H_{l-1}^T G_l
        GemmArgs g{};
        g.m = widths[l - 1]; g.n = widths[l]; g.kd = d_cap;
        g.a = h[l - 1]; g.lda = widths[l - 1]; g.sa = act_stride(l - 1);
        g.b = gr[l]; g.ldb = widths[l]; g.sb = act_stride(l);
        g.c = w[l - 1]; g.ldc = widths[l]; g.sc = (long long)widths[l - 1] * widths[l];
        g.tau = tau; g.step = step; g.rows = rows; g.bound = BOUND_K; g.lr = lr;
        if ((long long)g.m * g.n <= SMALL_LAYER)
          CHECK((launch_gemm<DeepTile, true, false, EPI_SGD>(g, k, stream)));
        else
          CHECK((launch_gemm<WideTile, true, false, EPI_SGD>(g, k, stream)));
      }
      dim3 bgrid((widths[l] + 31) / 32, k);
      bias_update_kernel<<<bgrid, dim3(32, 8), 0, stream>>>(
          gr[l], widths[l], act_stride(l), rows, tau, step, b[l - 1], lr);
      CHECK((int)cudaGetLastError());
    }
  }
  return 0;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
