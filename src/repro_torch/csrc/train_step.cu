// One federated cycle of K learners on a ReLU MLP: each learner k runs
// tau_k steps of full-batch gradient descent on its own masked shard,
// starting from its own parameters (cycle form of the train+aggregate step).
// The weighted aggregation of the trained learners that ends the cycle is
// the fed_agg kernel (fed_agg.cu), or accum_flush (accum_flush.cu) in the
// async form; the Python wrapper launches it after this kernel.
//
// Replaces the Pallas TPU megakernel `train_agg_step_pallas`
// (src/repro/kernels/train_step.py:119, kernel body `_make_kernel`), which
// keeps all K learners' parameters in VMEM across an in-kernel loop over
// max(tau) and computes every matrix product of the forward and backward
// pass inside its body. Here too one launch runs every step of every
// learner: a persistent cooperative kernel whose phases are separated by
// grid-wide barriers. Every product is computed by the tiled SGEMM below;
// nothing goes to a library.
//
// Loss (the reference's mlp.loss): masked mean NLL of log_softmax(logits),
// denominator max(sum m, 1). Per step and learner, with H_0 = x:
//   forward   H_l = relu(H_{l-1} W_l + b_l)  (l < L),  Z = H_{L-1} W_L + b_L
//   loss grad G_L = (softmax(Z) - onehot(y)) * m / max(sum m, 1)
//   backward  G_{l-1} = (G_l W_l^T) * [H_{l-1} > 0]   (from the OLD W_l)
//             W_l -= lr * H_{l-1}^T G_l,   b_l -= lr * colsum(G_l)
// A learner whose step >= tau_k gets no work, so its parameters stay
// bitwise untouched (the lax.cond of the reference).
//
// Bound: FP32 operations. A masked-in row costs 2 * (2 * sum fan_in*fan_out
// + sum_{l>=2} fan_in*fan_out) FLOPs a step: 1,212,240 for
// [784, 300, 124, 60, 10]. The paper's allocation (K = 10, sum_k tau_k d_k =
// 198,528) needs 2.4e11 FLOPs a cycle, 3.6 ms at 67 TFLOP/s of FP32; it
// moves about 43 MB (shards once, parameters in and out), 13 us at 3.35 TB/s.
// TF32 tensor cores would keep ~3 decimal digits, too few for the 1e-4
// parity the port holds, so the products run on the FP32 units.
//
// Design. A launch per product would be 16 launches a step (~530 for the
// ~33 steps of an async group), each paying a launch gap, and a
// one-learner group's products fill a fraction of the card. So the kernel
// is launched once a call with cudaLaunchCooperativeKernel, one CTA of 256
// threads per co-resident slot (occupancy x SMs: two an SM), and walks a
// phase plan:
//   * phase 0: the mask statistics, one item a learner: rows[z] = 1 + the
//     last masked-in row (0 if none), inv_den[z] = 1 / max(sum m, 1);
//   * then per step the plan built in Python (train_step._phase_plan) and
//     passed as a __grid_constant__ table: L forward phases, the last with
//     the loss gradient in its epilogue (<= 64 classes fit one 64-column
//     tile, so a tile holds whole logit rows, kept in shared memory); L - 1
//     phases that carry the gradient down (G_{l-1} from the old W_l, and
//     b_l); one last phase that updates every W_l and b_1. A weight
//     gradient sums over the learner's rows, a chain as long as the shard
//     whatever the layer's width, so the layers' chains run side by side.
//     2L phases a step, each ended by cooperative_groups' grid sync.
// Each phase is a flat work list of (op, learner, output tile) items;
// learners with step >= tau_k and row tiles past rows[z] are left out of
// it. The CTAs take its items one at a time from an atomic counter, the
// ops with the longest items first, so that uneven items spread evenly.
// The tile shape of each op is chosen per phase as the least estimated
// (rounds of items over the CTAs) x (an item's time) over 128x64 (8x4
// outputs a thread, 32-deep k stages), 64x32 (4x2, 64-deep) and 32x32
// (2x2, 64-deep), where an item's time is its stages times the larger of
// a stage's FMAs and a stage's load latency: a one-learner group spreads
// over the SMs, and a ten-learner phase runs no second round for a few
// tiles. A tile loads its next k stage through cp.async while it computes
// this one (zero-filled past the operands' edges) and reads its fragments from
// shared memory 4 k steps at a time, along whichever axis the operand is
// contiguous in. Every output is one chain of fused multiply-adds in k
// order from 0 in every tile shape, and the bias column sums and the mask
// statistics run in a fixed order, so the bits do not depend on the tile
// shapes chosen (tools/compare_train_step.py holds them to a launch-per-
// product version of this file bitwise).
// Buffers written inside the launch (W, b, H, G, rows, inv_den) are read
// with plain loads, never through the non-coherent read-only path: after a
// grid sync that path could return another CTA's stale data.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LAYERS = 16;
constexpr int MAX_CLASSES = 64;
constexpr int MAX_OPS = MAX_LAYERS + 1;  // ops a phase: the last updates every layer
constexpr int MAX_PHASES = 2 * MAX_LAYERS;

// plan op codes (train_step._OPS)
enum Op { OP_NONE = 0, OP_FWD = 1, OP_FWD_XENT = 2, OP_GIN = 3, OP_WGRAD = 4, OP_BIAS = 5 };

// A CTA's output tile (BM x BN, TM x TN outputs a thread) and the depth of
// one shared-memory stage (BK).
template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static_assert((BM / TM) * (BN / TN) == THREADS, "256 threads a CTA");
  static constexpr int STAGES = 2;  // double buffering: stage k + 1 loads while stage k is used
  // an operand's tile as [X][BK + 4] or [BK][X + 4] (tile_gemm)
  static constexpr int A_FLOATS = BM * (BK + 4) > BK * (BM + 4) ? BM * (BK + 4) : BK * (BM + 4);
  static constexpr int B_FLOATS = BN * (BK + 4) > BK * (BN + 4) ? BN * (BK + 4) : BK * (BN + 4);
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM_FLOATS = STAGES * STAGE_FLOATS;
};
using Wide = Tile<128, 64, 32, 8, 4>;
using Mid = Tile<64, 32, 64, 4, 2>;
using Deep = Tile<32, 32, 64, 2, 2>;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// the largest ring (55 KB), which also holds a tile of logits (Wide, one
// padded row a thread)
constexpr int SMEM_FLOATS = cmax(cmax(Wide::SMEM_FLOATS, cmax(Mid::SMEM_FLOATS, Deep::SMEM_FLOATS)),
                                 Wide::BM * (Wide::BN + 1));

struct Plan {
  int n_phases;
  int8_t op[MAX_PHASES][MAX_OPS];
  int8_t layer[MAX_PHASES][MAX_OPS];
};

struct Net {
  int k, d_cap, n_layers, max_tau;
  float lr;
  int widths[MAX_LAYERS + 1];
  const float* x;  // read-only in the launch; h[0] aliases it
  const int* y;
  const float* mask;
  const int* tau;
  float* w[MAX_LAYERS + 1];  // w[l], b[l] for l = 1..L (learner-major, updated in place)
  float* b[MAX_LAYERS + 1];
  float* h[MAX_LAYERS + 1];  // h[0] = x; h[l] (K, d_cap, widths[l]) for l < L
  float* g[MAX_LAYERS + 1];  // g[l] (K, d_cap, widths[l])
  int* rows;
  float* inv_den;
  int* work;  // two item counters, used by alternate phases; work[0] starts at 0
};

// cp.async: `bytes` of 16 (or 4) from global to shared memory, the rest
// of the 16 (4) zero-filled; nothing is read when bytes is 0.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// N consecutive floats of shared memory into registers (N = 2, 4 or 8)
template <int N>
__device__ __forceinline__ void lds(float* r, const float* p) {
  if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x; r[i + 1] = v.y; r[i + 2] = v.z; r[i + 3] = v.w;
    }
  }
}

// One operand's tile of a stage in shared memory, as it lies in device
// memory: element (x, k) of the X x BK tile at src[x * xs + k * ks], one of
// xs, ks being 1. K-contiguous (ks == 1) tiles are stored [X][BK + 4],
// x-contiguous ones [BK][X + 4]; both keep 16-byte rows and spread a
// warp's 16-byte reads over the banks. Elements past (x_end, k_end) are 0.
template <int X, int BK, bool KC>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ld, int x0,
                                          int x_end, int k0, int k_end, bool vec) {
  constexpr int LEN = KC ? BK : X;  // contiguous run
  constexpr int RUNS = KC ? X : BK;
  constexpr int STRIDE = LEN + 4;
  const int r_end = KC ? x_end : k_end, c_end = KC ? k_end : x_end;
  const int r0 = KC ? x0 : k0, c0 = KC ? k0 : x0;
  if (vec) {  // 16-byte chunks: the row stride and the base are 16-byte aligned
    for (int c = threadIdx.x; c < RUNS * LEN / 4; c += THREADS) {
      const int r = c / (LEN / 4), q = 4 * (c % (LEN / 4));
      const int gr = r0 + r, gc = c0 + q;
      const int valid = gr < r_end ? min(max(c_end - gc, 0), 4) : 0;
      cp_async16(dst + r * STRIDE + q, valid ? src + gr * ld + gc : src, 4 * valid);
    }
  } else {
    for (int c = threadIdx.x; c < RUNS * LEN; c += THREADS) {
      const int r = c / LEN, q = c % LEN;
      const int gr = r0 + r, gc = c0 + q;
      const bool valid = gr < r_end && gc < c_end;
      cp_async4(dst + r * STRIDE + q, valid ? src + gr * ld + gc : src, valid ? 4 : 0);
    }
  }
}

// C (m x n) = op(A) (m x kd) * op(B) (kd x n) for one learner's tile at
// (m0, n0): one FMA chain per output in k order from 0. A is (m, kd)
// row-major with row stride lda, or with TA its transpose (kd, m); B is
// (kd, n) with row stride ldb, or with TB (n, kd). STAGES k stages live in
// shared memory, the next ones loading through cp.async while this one is
// used; every 4 k steps a thread reads its A and B fragments with 16-byte
// (8-byte) loads.
// A and B are plain pointers: they may have been written in this launch.
template <class T, bool TA, bool TB>
__device__ __forceinline__ void tile_gemm(float (&acc)[T::TM][T::TN], float* smem, const float* a,
                                          int lda, const float* b, int ldb, int m, int n, int kd,
                                          int m0, int n0) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, TM = T::TM, TN = T::TN;
  constexpr bool A_KC = !TA, B_KC = TB;  // operands whose k runs are contiguous
  constexpr int A_FLOATS = T::A_FLOATS, STAGE = T::STAGE_FLOATS;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  const bool a_vec = lda % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b_vec = ldb % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  auto issue = [&](int stage, int k0) {
    float* as = smem + stage * STAGE;
    float* bs = as + A_FLOATS;
    if (A_KC) load_tile<BM, BK, true>(as, a, lda, m0, m, k0, kd, a_vec);
    else load_tile<BM, BK, false>(as, a, lda, m0, m, k0, kd, a_vec);
    if (B_KC) load_tile<BN, BK, true>(bs, b, ldb, n0, n, k0, kd, b_vec);
    else load_tile<BN, BK, false>(bs, b, ldb, n0, n, k0, kd, b_vec);
  };

  const int nk = (kd + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nk) issue(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<T::STAGES - 2>();  // this thread's copies of stage kt have landed
    __syncthreads();                 // and everyone's; stage kt - 1 is read by all
    if (kt + T::STAGES - 1 < nk)
      issue((kt + T::STAGES - 1) % T::STAGES, (kt + T::STAGES - 1) * BK);
    cp_async_commit();
    const float* as = smem + (kt % T::STAGES) * STAGE;
    const float* bs = as + A_FLOATS;
    // unrolled twice, not BK / 4 times: ten tile variants share the
    // instruction cache of the SMs
#pragma unroll 2
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float ra[4][TM], rb[4][TN];
      if constexpr (A_KC) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float v[4];
          lds<4>(v, as + (ty * TM + i) * (BK + 4) + k4);
#pragma unroll
          for (int q = 0; q < 4; ++q) ra[q][i] = v[q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) lds<TM>(ra[q], as + (k4 + q) * (BM + 4) + ty * TM);
      }
      if constexpr (B_KC) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float v[4];
          lds<4>(v, bs + (tx * TN + j) * (BK + 4) + k4);
#pragma unroll
          for (int q = 0; q < 4; ++q) rb[q][j] = v[q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) lds<TN>(rb[q], bs + (k4 + q) * (BN + 4) + tx * TN);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[q][i], rb[q][j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // shared memory is free for the next item
}

// One item of a GEMM op: the tile product and its epilogue.
//   OP_FWD, OP_FWD_XENT: h[l] = (relu)(h[l-1] W_l + b_l), rows bound by rows[z];
//     OP_FWD_XENT then turns its logit rows into G_L
//   OP_GIN:   g[l-1] = (g[l] W_l^T) * [h[l-1] > 0], rows bound by rows[z]
//   OP_WGRAD: W_l -= lr * h[l-1]^T g[l], the reduction bound by rows[z]
// Not inlined: each tile shape and op gets its own register allocation, and
// the phase loop's state stays out of the GEMM's registers.
template <class T, int OP>
__device__ __noinline__ void gemm_item(const Net& net, int l, int z, int tile, float* smem) {
  const int* wd = net.widths;
  const int rows_z = net.rows[z];
  const long long act_in = (long long)z * net.d_cap * wd[l - 1];
  const long long act_out = (long long)z * net.d_cap * wd[l];
  const long long wz = (long long)z * wd[l - 1] * wd[l];
  int m, n, kd;
  if (OP == OP_FWD || OP == OP_FWD_XENT) {
    m = rows_z; n = wd[l]; kd = wd[l - 1];
  } else if (OP == OP_GIN) {
    m = rows_z; n = wd[l - 1]; kd = wd[l];
  } else {
    m = wd[l - 1]; n = wd[l]; kd = rows_z;
  }
  const int tiles_n = (n + T::BN - 1) / T::BN;
  const int m0 = (tile / tiles_n) * T::BM, n0 = (tile % tiles_n) * T::BN;
  float acc[T::TM][T::TN];
  if (OP == OP_FWD || OP == OP_FWD_XENT)
    tile_gemm<T, false, false>(acc, smem, net.h[l - 1] + act_in, wd[l - 1], net.w[l] + wz,
                               wd[l], m, n, kd, m0, n0);
  else if (OP == OP_GIN)
    tile_gemm<T, false, true>(acc, smem, net.g[l] + act_out, wd[l], net.w[l] + wz, wd[l], m,
                              n, kd, m0, n0);
  else
    tile_gemm<T, true, false>(acc, smem, net.h[l - 1] + act_in, wd[l - 1], net.g[l] + act_out,
                              wd[l], m, n, kd, m0, n0);

  const int tx = threadIdx.x % (T::BN / T::TN), ty = threadIdx.x / (T::BN / T::TN);
  float* c = OP == OP_GIN ? net.g[l - 1] + act_in : OP == OP_WGRAD ? net.w[l] + wz
                                                                    : net.h[l] + act_out;
  const float* bias = net.b[l] + (long long)z * wd[l];
  const float* aux = net.h[l - 1] + act_in;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int gm = m0 + ty * T::TM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int gn = n0 + tx * T::TN + j;
      if (gn >= n) continue;
      const long long off = (long long)gm * n + gn;
      const float v = acc[i][j];
      if (OP == OP_FWD) {
        const float hv = v + bias[gn];
        c[off] = hv > 0.0f ? hv : 0.0f;
      } else if (OP == OP_FWD_XENT) {  // the logits stay in shared memory
        smem[(gm - m0) * (T::BN + 1) + gn] = v + bias[gn];
      } else if (OP == OP_GIN) {
        c[off] = aux[off] > 0.0f ? v : 0.0f;
      } else {
        c[off] = __fsub_rn(c[off], __fmul_rn(net.lr, v));
      }
    }
  }

  if (OP == OP_FWD_XENT) {
    // the loss gradient of this tile's logit rows (n <= 64 = BN: whole
    // rows), one thread a row: (softmax(z) - onehot(y)) * m * inv_den,
    // softmax taken as exp(log_softmax) as the reference differentiates it
    __syncthreads();
    const int r = m0 + threadIdx.x;
    if (threadIdx.x < T::BM && r < m) {
      const long long row = (long long)z * net.d_cap + r;
      const float* zr = smem + threadIdx.x * (T::BN + 1);
      float mx = -INFINITY;
      for (int j = 0; j < n; ++j) mx = fmaxf(mx, zr[j]);
      float s = 0.0f;
      for (int j = 0; j < n; ++j) s += expf(zr[j] - mx);
      const float lse = logf(s);
      const float coef = net.inv_den[z] * net.mask[row];
      const int label = net.y[row];
      float* gr = net.g[l] + row * n;
      for (int j = 0; j < n; ++j) {
        const float p = expf((zr[j] - mx) - lse);
        gr[j] = (p - (j == label ? 1.0f : 0.0f)) * coef;
      }
    }
  }
}

// b_l -= lr * colsum(g[l]) over the learner's rows for 32 columns: 8 row
// slices of 32 threads, the slices summed in a fixed order.
__device__ void bias_item(const Net& net, int l, int z, int cb, float* smem) {
  float (*part)[33] = reinterpret_cast<float (*)[33]>(smem);
  const int n = net.widths[l];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int col = cb * 32 + tx;
  const int r_end = net.rows[z];
  const float* gz = net.g[l] + (long long)z * net.d_cap * n;
  float s = 0.0f;
  if (col < n)
    for (int r = ty; r < r_end; r += 8) s += gz[(long long)r * n + col];
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < n) {
    float t = 0.0f;
    for (int i = 0; i < 8; ++i) t += part[i][tx];
    float* bz = net.b[l] + (long long)z * n + col;
    *bz = __fsub_rn(*bz, __fmul_rn(net.lr, t));
  }
}

// rows[z] = 1 + the last row with a nonzero mask (0 if none),
// inv_den[z] = 1 / max(sum of the mask, 1)
__device__ void stats_item(const Net& net, int z, float* smem) {
  float* ssum = smem;
  int* slast = reinterpret_cast<int*>(smem + THREADS);
  const int tid = threadIdx.x;
  float s = 0.0f;
  int last = 0;
  for (int r = tid; r < net.d_cap; r += THREADS) {
    const float v = net.mask[(long long)z * net.d_cap + r];
    s += v;
    if (v != 0.0f) last = r + 1;
  }
  ssum[tid] = s;
  slast[tid] = last;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (tid < half) {
      ssum[tid] += ssum[tid + half];
      slast[tid] = max(slast[tid], slast[tid + half]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    net.rows[z] = slast[0];
    net.inv_den[z] = 1.0f / fmaxf(ssum[0], 1.0f);
  }
}

// An op's extent for one learner: (rows of output tiles' M, columns N),
// and whether the learner has work in this step.
struct Extent {
  int m, n;
};

__device__ __forceinline__ Extent extent(const Net& net, int op, int l, int z) {
  const int* wd = net.widths;
  const int r = net.rows[z];
  switch (op) {
    case OP_FWD:
    case OP_FWD_XENT: return {r, wd[l]};
    case OP_GIN: return {r, wd[l - 1]};
    case OP_WGRAD: return {wd[l - 1], wd[l]};
    default: return {1, wd[l]};  // OP_BIAS: 32-column blocks
  }
}

// tile shape s: 0 Wide, 1 Mid, 2 Deep
__device__ __forceinline__ int tile_bm(int s) { return s == 0 ? Wide::BM : s == 1 ? Mid::BM : Deep::BM; }
__device__ __forceinline__ int tile_bn(int s) { return s == 0 ? Wide::BN : s == 1 ? Mid::BN : Deep::BN; }
__device__ __forceinline__ int tile_bk(int s) { return s == 0 ? Wide::BK : s == 1 ? Mid::BK : Deep::BK; }
// relative time of one output a k step: the inverse share of FMAs among the
// inner loop's issued instructions (Wide 32 of 35, Mid 8 of 10, Deep 4 of 6)
__device__ __forceinline__ int tile_cost(int s) { return s == 0 ? 9 : s == 1 ? 10 : 12; }
// A k stage takes at least this long in the same units (bm * bn * bk *
// cost): its loads, barrier and wait, about a 32x32x64 stage's FMAs.
constexpr long long STAGE_LATENCY = 800000;

// Estimated time of one item of tile shape s over a reduction of kd.
__device__ __forceinline__ long long item_time(int s, int kd) {
  const long long work = (long long)tile_bm(s) * tile_bn(s) * tile_bk(s) * tile_cost(s);
  return (long long)((kd + tile_bk(s) - 1) / tile_bk(s)) * (work > STAGE_LATENCY ? work : STAGE_LATENCY);
}

__device__ __forceinline__ bool is_gemm(int op) {
  return op == OP_FWD || op == OP_GIN || op == OP_WGRAD;
}

// Items of `op` for learner z in tile shape `shape` (0 if the learner is done)
__device__ __forceinline__ int items_of(const Net& net, int op, int l, int z, int shape,
                                        int step) {
  if (step >= net.tau[z]) return 0;
  const Extent e = extent(net, op, l, z);
  if (op == OP_BIAS) return (e.n + 31) / 32;
  return ((e.m + tile_bm(shape) - 1) / tile_bm(shape)) *
         ((e.n + tile_bn(shape) - 1) / tile_bn(shape));
}

template <class T>
__device__ __forceinline__ void run_gemm(const Net& net, int op, int l, int z, int tile,
                                         float* smem) {
  switch (op) {
    case OP_FWD: gemm_item<T, OP_FWD>(net, l, z, tile, smem); break;
    case OP_GIN: gemm_item<T, OP_GIN>(net, l, z, tile, smem); break;
    default: gemm_item<T, OP_WGRAD>(net, l, z, tile, smem); break;
  }
}

__device__ void run_item(const Net& net, int op, int l, int shape, int z, int item,
                         float* smem) {
  if (op == OP_BIAS) {
    bias_item(net, l, z, item, smem);
  } else if (op == OP_FWD_XENT) {
    gemm_item<Wide, OP_FWD_XENT>(net, l, z, item, smem);
  } else if (shape == 0) {
    run_gemm<Wide>(net, op, l, z, item, smem);
  } else if (shape == 1) {
    run_gemm<Mid>(net, op, l, z, item, smem);
  } else {
    run_gemm<Deep>(net, op, l, z, item, smem);
  }
}

// What a CTA keeps beside the ring: its copies of the two tables (read
// often, cheaper from shared memory than from the parameter space) and the
// current phase's work list.
struct Book {
  Net net;
  Plan plan;
  int count[MAX_OPS][3];  // items of each op in each tile shape
  int shape[MAX_OPS];     // each op's tile shape
  int order[MAX_OPS];     // the ops, longest items first
  int prefix[MAX_OPS + 1];  // items before the k-th op of `order`
  int item;
  int warp_sum[THREADS / 32];  // locate()'s scan
  int found_z, found_i;
};
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS + sizeof(Book);

// The work list of phase p of this step (one CTA, every thread): items
// counted over the learners by all threads, then warp 0 picks each op's
// tile shape, orders the ops and sums their items.
__device__ void plan_phase(Book& bk, int p, int step, int ctas) {
  const Net& net = bk.net;
  if (threadIdx.x < MAX_OPS * 3) bk.count[threadIdx.x / 3][threadIdx.x % 3] = 0;
  __syncthreads();
  for (int z = threadIdx.x; z < net.k; z += THREADS) {
    if (step >= net.tau[z]) continue;
    for (int o = 0; o < MAX_OPS; ++o) {
      const int op = bk.plan.op[p][o], l = bk.plan.layer[p][o];
      if (op == OP_NONE) break;
      for (int sh = 0; sh < (is_gemm(op) ? 3 : 1); ++sh) {
        const int n = items_of(net, op, l, z, sh, step);
        if (n) atomicAdd(&bk.count[o][sh], n);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int o = threadIdx.x;
    const int op = o < MAX_OPS ? bk.plan.op[p][o] : OP_NONE;
    const int l = o < MAX_OPS ? bk.plan.layer[p][o] : 0;
    int shape = 0, count = op == OP_NONE ? 0 : bk.count[o][0];
    long long weight = op == OP_NONE ? -1 : 0;
    if (is_gemm(op)) {
      // the least (rounds of items over the CTAs) x (an item's time)
      const int kd = op == OP_FWD ? net.widths[l - 1] : op == OP_GIN ? net.widths[l] : net.d_cap;
      long long best = -1;
      for (int sh = 0; sh < 3; ++sh) {
        const long long est = (long long)((bk.count[o][sh] + ctas - 1) / ctas) * item_time(sh, kd);
        if (best < 0 || est < best) {
          best = est;
          shape = sh;
        }
      }
      count = bk.count[o][shape];
      weight = item_time(shape, kd);
    } else if (op == OP_FWD_XENT) {
      weight = item_time(0, net.widths[l - 1]);
    }
    // rank: the ops with longer items first, then in plan order
    int rank = 0;
    for (int q = 0; q < 32; ++q) {
      const long long wq = __shfl_sync(0xffffffffu, weight, q);
      if (wq > weight || (wq == weight && q < o)) ++rank;
    }
    if (o < MAX_OPS) {
      bk.shape[o] = shape;
      bk.order[rank] = o;
    }
    // prefix sums of the counts in that order (the unused ops come last)
    int in_order = 0;
    for (int q = 0; q < 32; ++q) {
      const int rq = __shfl_sync(0xffffffffu, rank, q);
      const int cq = __shfl_sync(0xffffffffu, count, q);
      if (rq < rank) in_order += cq;
    }
    if (rank <= MAX_OPS) bk.prefix[rank] = in_order;  // lane MAX_OPS ranks MAX_OPS: the total
  }
  __syncthreads();
}

// The learner z of item `rest` of op (op, l) in tile shape sh, and the
// item's index i within the learner's items: the CTA scans the learners'
// item counts THREADS at a time (a warp scan, then the warps' sums).
__device__ void locate(Book& bk, int op, int l, int sh, int step, int rest, int& z, int& i) {
  const Net& net = bk.net;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int z0 = 0, base = 0; z0 < net.k; z0 += THREADS) {
    const int zz = z0 + threadIdx.x;
    const int n = zz < net.k ? items_of(net, op, l, zz, sh, step) : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) bk.warp_sum[warp] = incl;
    __syncthreads();
    int start = base + incl - n, chunk = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      if (w < warp) start += bk.warp_sum[w];
      chunk += bk.warp_sum[w];
    }
    if (rest >= start && rest < start + n) {
      bk.found_z = zz;
      bk.found_i = rest - start;
    }
    __syncthreads();
    base += chunk;
    if (rest < base) break;
  }
  z = bk.found_z;
  i = bk.found_i;
}

__global__ void __launch_bounds__(THREADS, 2)
train_steps_kernel(const __grid_constant__ Net net_param, const __grid_constant__ Plan plan_param) {
  extern __shared__ __align__(16) float smem[];
  Book& bk = *reinterpret_cast<Book*>(smem + SMEM_FLOATS);
  cg::grid_group grid = cg::this_grid();
  const int ctas = gridDim.x;
  {
    const int* src = reinterpret_cast<const int*>(&net_param);
    int* dst = reinterpret_cast<int*>(&bk.net);
    for (int i = threadIdx.x; i < (int)(sizeof(Net) / 4); i += THREADS) dst[i] = src[i];
    src = reinterpret_cast<const int*>(&plan_param);
    dst = reinterpret_cast<int*>(&bk.plan);
    for (int i = threadIdx.x; i < (int)(sizeof(Plan) / 4); i += THREADS) dst[i] = src[i];
  }
  __syncthreads();
  const Net& net = bk.net;

  // phase 0: the mask statistics
  for (int z = blockIdx.x; z < net.k; z += ctas) {
    stats_item(net, z, smem);
    __syncthreads();
  }
  grid.sync();

  int pc = 0;  // phases run so far: phase pc takes its items from work[pc & 1]
  for (int step = 0; step < net.max_tau; ++step) {
    for (int p = 0; p < bk.plan.n_phases; ++p, ++pc) {
      plan_phase(bk, p, step, ctas);
      const int total = bk.prefix[MAX_OPS];
      // the CTAs take items one at a time from this phase's counter; the
      // other counter is set to 0 for the next phase (no CTA reads it now)
      int* counter = net.work + (pc & 1);
      if (blockIdx.x == 0 && threadIdx.x == 0) net.work[(pc + 1) & 1] = 0;
      for (;;) {
        if (threadIdx.x == 0) bk.item = atomicAdd(counter, 1);
        __syncthreads();
        const int it = bk.item;
        __syncthreads();
        if (it >= total) break;
        int k = 0;
        while (it >= bk.prefix[k + 1]) ++k;
        const int o = bk.order[k], sh = bk.shape[o];
        const int op = bk.plan.op[p][o], l = bk.plan.layer[p][o];
        int z, i;
        locate(bk, op, l, sh, step, it - bk.prefix[k], z, i);
        run_item(net, op, l, sh, z, i, smem);
        __syncthreads();  // the next item reuses shared memory
      }
      grid.sync();
    }
  }
}

}  // namespace

// x (K, d_cap, widths[0]) f32, y (K, d_cap) i32, mask (K, d_cap) f32,
// tau (K,) i32: device pointers. widths: host array of n_layers + 1 ints.
// w, b: host arrays of n_layers device pointers to the learners' leaves,
// (K, widths[l], widths[l+1]) and (K, widths[l+1]), updated in place.
// ws: device workspace of 2 * K * d_cap * sum(widths[1:]) floats;
// rows (K,) i32 and inv_den (K,) f32: device scratch; work: 2 i32 of device
// scratch, set to 0 before the call. plan: host array of
// n_phases * 3 (op, layer) pairs, the phases of one step
// (train_step._phase_plan). One cooperative launch runs every step.
extern "C" int train_cycle_f32(const float* x, const int* y, const float* mask,
                               const int* tau, int k, int d_cap, int n_layers,
                               const int* widths, float* const* w, float* const* b,
                               float* ws, int* rows, float* inv_den, int* work, float lr,
                               int max_tau, const int* plan, int n_phases, void* stream_ptr) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  if (widths[n_layers] > MAX_CLASSES) return (int)cudaErrorInvalidValue;
  if (n_phases < 1 || n_phases > MAX_PHASES) return (int)cudaErrorInvalidValue;
  if (k <= 0 || d_cap <= 0) return 0;

  Net net{};
  net.k = k;
  net.d_cap = d_cap;
  net.n_layers = n_layers;
  net.max_tau = max_tau;
  net.lr = lr;
  net.x = x;
  net.y = y;
  net.mask = mask;
  net.tau = tau;
  net.rows = rows;
  net.inv_den = inv_den;
  net.work = work;
  for (int l = 0; l <= n_layers; ++l) net.widths[l] = widths[l];
  net.h[0] = const_cast<float*>(x);
  float* p = ws;
  for (int l = 1; l <= n_layers; ++l) {
    net.w[l] = w[l - 1];
    net.b[l] = b[l - 1];
    net.h[l] = p;
    p += (long long)k * d_cap * widths[l];
    net.g[l] = p;
    p += (long long)k * d_cap * widths[l];
  }
  Plan pl{};
  pl.n_phases = n_phases;
  for (int i = 0; i < n_phases; ++i)
    for (int o = 0; o < MAX_OPS; ++o) {
      const int op = plan[2 * (i * MAX_OPS + o)], layer = plan[2 * (i * MAX_OPS + o) + 1];
      if (op < OP_NONE || op > OP_BIAS || (op != OP_NONE && (layer < 1 || layer > n_layers)))
        return (int)cudaErrorInvalidValue;
      pl.op[i][o] = (int8_t)op;
      pl.layer[i][o] = (int8_t)layer;
    }

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(train_steps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, train_steps_kernel, THREADS,
                                                        SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&net, &pl};
  err = cudaLaunchCooperativeKernel((const void*)train_steps_kernel, dim3(per_sm * sms),
                                    dim3(THREADS), args, SMEM_BYTES, (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
