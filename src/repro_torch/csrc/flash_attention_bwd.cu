// GQA flash attention, backward: the gradients dQ, dK, dV of the forward in
// flash_attention.cu,
//
//   out_i = sum_j p_ij v_j,   p_ij = exp(s_ij - lse_i) over the allowed j,
//   s_ij = q_i . k_j / sqrt(d),
//
// with the same masks (j < Skv; j <= i when causal; i - j < window when a
// window is given; query and key positions both start at 0) and G = H / KV
// query heads sharing each kv head. With dO the gradient of out:
//
//   D_i   = sum_c dO_ic out_ic                 (a row pass, float32)
//   dP_ij = dO_i . v_j
//   dS_ij = p_ij (dP_ij - D_i)
//   dV_j  = sum_{i, g} p_ij dO_i               (summed over the G heads too)
//   dK_j  = sum_{i, g} dS_ij q_i / sqrt(d)
//   dQ_i  = sum_j dS_ij k_j / sqrt(d)
//
// It replaces no TPU kernel: the reference trains through jax.grad of its
// plain jnp attention (src/repro/launch/train.py builds Model(cfg) without
// use_pallas), because JAX cannot differentiate its Pallas kernel. The port
// runs the forward kernel on the card in training too, so its gradient has
// to be a kernel of its own: a CUDA tensor never takes the plain version.
//
// The forward writes each row's log-sum-exp (float32 (B, H, Sq), -inf for a
// row that sees no key); p is rebuilt here from it, and is 0 wherever the
// mask or an lse of -inf says so, so a row with nothing to attend to gets
// gradients of 0, never NaN.
//
// Three launches on one stream, in both routes: the row pass D
// (delta_kernel, one warp a row), then dK/dV, then dQ. No atomics: each
// dK, dV and dQ row is summed by one CTA in a fixed order, so two runs give
// the same bits. A kernel that shared S and dP between dK/dV and dQ would
// have to add dQ across CTAs (atomics, or a float32 scratch of G x the
// output and a reduction pass); instead dQ is a pass of its own that
// computes S and dP again.
//
// Bound: at Llama-3.2-3B's training shape (B 4, S 2048, 24/8 heads, d 128,
// causal) the gradient is 2.5x the forward's 1.03e11 FLOPs (5 products of
// 2 d FLOPs an allowed pair: S, dP, dV, dK, dQ), 2.58e11, which is 0.26 ms
// at the card's 989 TFLOP/s bf16 tensor-core peak; its bytes (q, k, v, out,
// dO read, dq, dk, dv written, 0.27 GB) take 0.08 ms at 3.35 TB/s. So the
// bound is operations, on the tensor cores.
//
// bfloat16 operands: the tensor-core kernels (`tc::dkdv_kernel`,
// `tc::dq_kernel`), every product on wgmma, fed by TMA through mbarrier
// rings.
//   * dK/dV: a CTA owns 128 keys of one (b, kv head), 64 to each of two
//     warpgroups. K and V are loaded once by TMA; tiles of 64 query rows of
//     Q and dO pass through a 3-stage ring, walking the G query heads and,
//     for each, the query tiles that the causal and window masks let see
//     the CTA's keys. A warpgroup computes S^T = K Q^T and dP^T = V dO^T
//     (64 x 64, both operands in shared memory, K-major), then in registers
//     P^T = exp2(S^T log2(e) / sqrt(d) - lse log2(e)) (0 where masked, past
//     Sq or where lse is -inf) and dS^T = P^T (dP^T - D), then dV += P^T dO
//     and dK += dS^T Q with A from registers (the float32 layout of the
//     S^T accumulator is the A operand's after a pairwise convert, as the
//     forward uses it for P) and B from shared memory with the transpose
//     bit (as the forward reads V). dK and dV stay in registers across
//     every head and tile and are written once.
//   * dQ: a CTA owns 128 queries of one (b, head), 64 to each of two
//     warpgroups; Q and dO are loaded once, and tiles of 64 keys of K and
//     V pass through a 2-stage ring, only the live ones, skipped as the
//     forward skips them. S = Q K^T and dP = dO V^T from shared memory; dS
//     in registers (each thread's two rows keep their lse and D in
//     registers); dQ += dS K with K read with the transpose bit.
//   * Each warpgroup commits S and dP as two groups and computes P while
//     dP's products run; in dK/dV it then issues dV and splits dS while
//     dV's products run. A warpgroup whose 64 rows see none of a tile (the
//     diagonal's dead half, keys or queries past the end) skips its
//     products and only releases the stage.
//   * Who loads, and the registers. dQ has a producer warp (288 threads;
//     its consumers need ~160 registers, ptxas gives them 166 without a
//     spill). dK/dV's consumers hold dK and dV (2 x 32 NC floats), S^T and
//     dP^T (32 each) and the bf16 pieces of P^T and dS^T (4 x 16 words):
//     ~200 registers at d 128. A ninth warp puts three warps on one of the
//     SM's four sub-partitions, whose 16K-register file then caps every
//     thread at 168, and this toolkit's ptxas allocates the whole kernel at
//     that cap whatever `setmaxnreg` later asks for (232/40, 240/24 and a
//     warp-uniform branch gave the same 1080-1188-byte spill, and ptxas
//     serialized the wgmmas). So dK/dV runs two warpgroups alone (256
//     threads, 253 registers at d 128, no spill): warp 0 fills the ring two
//     tiles ahead of itself, lane 0 issuing the TMA loads and every lane
//     copying 2 of the tile's 64 lse and D values with cp.async, whose
//     completion the stage's mbarrier tracks, so no thread waits on a global
//     load.
//   * P and dS go into their products as two bf16 pieces, hi = bf16(x)
//     and lo = bf16(x - hi), each multiplied by the same tile, as the
//     forward multiplies P: hi + lo keeps x to ~2^-17 of its size, so the
//     products are float32-exact but for the order of their sums. One
//     piece would add a rounding of 2^-9 to every term of dV, dK and dQ on
//     top of the bf16 outputs' own and D's (taken from the forward's bf16
//     output), which already take the error to 0.26-0.35% of a gradient's
//     scale at chip_smoke.py phase 15a's shapes, under a 1% gate.
//   * Executed against useful work: 10 products of 64 x 64 x d a live
//     64 x 64 tile pair (dK/dV: S, dP, dV twice, dK twice; dQ: S, dP, dQ
//     twice) where the gradient needs 5 an allowed pair, so 2x the useful
//     FLOPs plus the diagonal tiles' masked halves: 5.3e11 at the training
//     shape, 0.54 ms at 989 TFLOP/s. d 80 reads its second TMA box of 64
//     columns zero-filled past d (S and dP run 5 k-steps of 16, the
//     products with a register operand 128 columns).
//   * Shared memory at d 80 and 128: dK/dV 163 KB (K, V 32 KB each, the
//     ring 3 x 32 KB, the row stats), dQ 129 KB (Q, dO 32 KB each, the
//     ring 2 x 32 KB); about half at d 64; one CTA an SM.
//   * TMA maps are the forward's ({d, heads, S, B}, 128-byte swizzle) with
//     boxes of 64 rows, so rows past S are zero-filled. The CTAs with the
//     most causal work are launched first (the first keys in dK/dV, the
//     last queries in dQ).
//
// float32 operands: the first, CUDA-core kernels (`cc::dkdv_kernel`,
// `cc::dq_kernel`), every product and sum in float32 fused multiply-adds at
// the CUDA cores' 67 TFLOP/s (TF32 keeps ~10 bits and cannot hold the 1e-4
// gate): a CTA of 256 threads per 64 keys (dK/dV) or 64 queries (dQ), each
// thread a 4 x 4 block of S and dP and a 4 x d/16 block of the
// accumulators, the operands staged transposed in shared memory ([d][64],
// rows padded to 68 floats) so that each k-step reads one float4 a side.
// 7 products of 64 x 64 x d a live tile pair.
//
// Nothing falls back from one route to the other: a bf16 call that the
// tensor-core kernels refuse returns its error.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ bool allowed(int qpos, int kpos, int skv, int causal,
                                        int window) {
  bool ok = kpos < skv;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// D_i = sum_c dO_ic out_ic for every row (b, i, head) of out's layout,
// written as delta[(b * h + head) * sq + i].
template <typename T>
__global__ void delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                             float* __restrict__ delta, long long rows, int sq, int h, int d) {
  const long long row = blockIdx.x * (long long)(blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: a warp takes one row
  const int lane = threadIdx.x % 32;
  const T* o = out + row * d;
  const T* g = dout + row * d;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) acc = fmaf(widen(o[c]), widen(g[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long b = row / ((long long)sq * h), rem = row % ((long long)sq * h);
    const long long i = rem / h, head = rem % h;
    delta[(b * h + head) * sq + i] = acc;
  }
}

template <typename T>
cudaError_t launch_delta(const void* out, const void* dout, float* delta, int b, int sq, int h,
                         int d, cudaStream_t stream) {
  const long long rows = (long long)b * sq * h;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows, sq, h, d);
  return cudaGetLastError();
}

// The route the last call launched: 1 the tensor-core kernels, 0 the
// CUDA-core ones, -1 none (an empty call's memsets, or an error).
int last_route = -1;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernels
// ---------------------------------------------------------------------------
namespace cc {

constexpr int BQ = 64;       // query rows a tile
constexpr int BK = 64;       // key rows a tile
constexpr int THREADS = 256; // 16 x 16
constexpr int LD = 68;       // floats a row of a transposed tile; keeps float4 rows aligned

// Rows [start, start + 64) of one head of x (row stride `row` floats) into
// shared memory transposed, dst[col * LD + r]; rows past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_t(const float* __restrict__ x, long long row, int start,
                                       int limit, float* dst) {
  for (int idx = threadIdx.x; idx < 64 * (D / 4); idx += THREADS) {
    const int r = idx % 64, c = idx / 64;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (start + r < limit) v = *reinterpret_cast<const float4*>(x + (start + r) * row + c * 4);
    dst[(c * 4 + 0) * LD + r] = v.x;
    dst[(c * 4 + 1) * LD + r] = v.y;
    dst[(c * 4 + 2) * LD + r] = v.z;
    dst[(c * 4 + 3) * LD + r] = v.w;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(4 * D * LD + 64 * LD + 2 * 64);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int sq,
            int skv, int h, int kvh, int causal, int window, float scale) {
  constexpr int NJ = D / 16;  // accumulator columns a thread: tx + 16 j
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);  // [D][LD], this CTA's keys
  float* vT = kT + D * LD;                      // [D][LD]
  float* qT = vT + D * LD;                      // [D][LD], the current query tile
  float* doT = qT + D * LD;                     // [D][LD]
  float* ps = doT + D * LD;                     // [BQ][LD]: P, then dS (query row, key)
  float* lse_s = ps + BQ * LD;                  // [BQ]
  float* dd_s = lse_s + BQ;                     // [BQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // queries tx*4.., keys ty*4..
  const int b = blockIdx.x / kvh, kh = blockIdx.x % kvh, groups = h / kvh;
  const int k_start = blockIdx.y * BK;
  const long long q_row = (long long)h * D, kv_row = (long long)kvh * D;

  load_t<D>(k + ((long long)b * skv * kvh + kh) * D, kv_row, k_start, skv, kT);
  load_t<D>(v + ((long long)b * skv * kvh + kh) * D, kv_row, k_start, skv, vT);

  // the query blocks that see a key of this block: causal, none before
  // k_start; with a window, none after the last key's last viewer
  const int nq = (sq + BQ - 1) / BQ;
  int qb_lo = 0, qb_hi = nq;
  if (causal) qb_lo = k_start / BQ;
  if (window > 0) {
    const long long last = (long long)k_start + BK - 1 + window - 1;
    if (last / BQ + 1 < qb_hi) qb_hi = (int)(last / BQ + 1);
  }

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[a][j] = dv_acc[a][j] = 0.0f;

  for (int g = 0; g < groups; ++g) {
    const int hh = kh * groups + g;
    const float* q0 = q + ((long long)b * sq * h + hh) * D;
    const float* do0 = dout + ((long long)b * sq * h + hh) * D;
    const float* lse0 = lse + ((long long)b * h + hh) * sq;
    const float* dd0 = delta + ((long long)b * h + hh) * sq;
    for (int qb = qb_lo; qb < qb_hi; ++qb) {
      const int q_start = qb * BQ;
      __syncthreads();  // the last tile is done with qT, doT, ps and the row stats
      load_t<D>(q0, q_row, q_start, sq, qT);
      load_t<D>(do0, q_row, q_start, sq, doT);
      if (threadIdx.x < BQ) {
        const int qpos = q_start + threadIdx.x;
        lse_s[threadIdx.x] = qpos < sq ? lse0[qpos] : -INFINITY;
        dd_s[threadIdx.x] = qpos < sq ? dd0[qpos] : 0.0f;
      }
      __syncthreads();

      // S^T and dP^T of this thread's 4 keys x 4 queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[a][e] = dp[a][e] = 0.0f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float4 kk = reinterpret_cast<const float4*>(kT + c * LD)[ty];
        const float4 vv = reinterpret_cast<const float4*>(vT + c * LD)[ty];
        const float4 qq = reinterpret_cast<const float4*>(qT + c * LD)[tx];
        const float4 gg = reinterpret_cast<const float4*>(doT + c * LD)[tx];
        const float kv4[4] = {kk.x, kk.y, kk.z, kk.w}, vv4[4] = {vv.x, vv.y, vv.z, vv.w};
        const float qq4[4] = {qq.x, qq.y, qq.z, qq.w}, gg4[4] = {gg.x, gg.y, gg.z, gg.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[a][e] = fmaf(kv4[a], qq4[e], s[a][e]);
            dp[a][e] = fmaf(vv4[a], gg4[e], dp[a][e]);
          }
      }

      // P, and dS = P (dP - D), in s and dp
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int kpos = k_start + ty * 4 + a;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = tx * 4 + e;
          const float l = lse_s[i];
          const bool ok = l != -INFINITY && allowed(q_start + i, kpos, skv, causal, window);
          const float p = ok ? expf(fmaf(s[a][e], scale, -l)) : 0.0f;
          s[a][e] = p;
          dp[a][e] = p * (dp[a][e] - dd_s[i]);
        }
      }

      // dV += P^T dO
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<float4*>(ps + (tx * 4 + e) * LD + ty * 4) =
            make_float4(s[0][e], s[1][e], s[2][e], s[3][e]);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float4 pp = reinterpret_cast<const float4*>(ps + i * LD)[ty];
        const float p4[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float o = doT[(tx + 16 * j) * LD + i];
#pragma unroll
          for (int a = 0; a < 4; ++a) dv_acc[a][j] = fmaf(p4[a], o, dv_acc[a][j]);
        }
      }
      __syncthreads();

      // dK += dS^T Q (scaled once, at the end)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<float4*>(ps + (tx * 4 + e) * LD + ty * 4) =
            make_float4(dp[0][e], dp[1][e], dp[2][e], dp[3][e]);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float4 dd = reinterpret_cast<const float4*>(ps + i * LD)[ty];
        const float d4[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float x = qT[(tx + 16 * j) * LD + i];
#pragma unroll
          for (int a = 0; a < 4; ++a) dk_acc[a][j] = fmaf(d4[a], x, dk_acc[a][j]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kpos = k_start + ty * 4 + a;
    if (kpos < skv) {
      const long long off = (((long long)b * skv + kpos) * kvh + kh) * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dk[off + tx + 16 * j] = dk_acc[a][j] * scale;
        dv[off + tx + 16 * j] = dv_acc[a][j];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, int sq, int skv, int h, int kvh,
          int causal, int window, float scale) {
  constexpr int NJ = D / 16;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][LD], this CTA's queries
  float* doT = qT + D * LD;                     // [D][LD]
  float* kT = doT + D * LD;                     // [D][LD], the current key tile
  float* vT = kT + D * LD;                      // [D][LD]
  float* dsT = vT + D * LD;                     // [BK][LD]: dS (key, query row)
  float* lse_s = dsT + BK * LD;                 // [BQ]
  float* dd_s = lse_s + BQ;                     // [BQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // keys tx*4.., queries ty*4..
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h, kh = hh / (h / kvh);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;  // most causal work first
  const long long q_row = (long long)h * D, kv_row = (long long)kvh * D;
  const float* k0 = k + ((long long)b * skv * kvh + kh) * D;
  const float* v0 = v + ((long long)b * skv * kvh + kh) * D;

  load_t<D>(q + ((long long)b * sq * h + hh) * D, q_row, q_start, sq, qT);
  load_t<D>(dout + ((long long)b * sq * h + hh) * D, q_row, q_start, sq, doT);
  if (threadIdx.x < BQ) {
    const int qpos = q_start + threadIdx.x;
    lse_s[threadIdx.x] = qpos < sq ? lse[(long long)bh * sq + qpos] : -INFINITY;
    dd_s[threadIdx.x] = qpos < sq ? delta[(long long)bh * sq + qpos] : 0.0f;
  }

  // the live key blocks, as the forward skips them
  const int nk = (skv + BK - 1) / BK;
  int kb_lo = 0, kb_hi = nk;
  if (causal) kb_hi = min(nk, (q_start + BQ - 1) / BK + 1);
  if (window > 0 && q_start - window + 1 > 0) kb_lo = (q_start - window + 1) / BK;

  float dq_acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[a][j] = 0.0f;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k_start = kb * BK;
    __syncthreads();  // the last tile is done with kT, vT and dsT
    load_t<D>(k0, kv_row, k_start, skv, kT);
    load_t<D>(v0, kv_row, k_start, skv, vT);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[a][e] = dp[a][e] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 qq = reinterpret_cast<const float4*>(qT + c * LD)[ty];
      const float4 gg = reinterpret_cast<const float4*>(doT + c * LD)[ty];
      const float4 kk = reinterpret_cast<const float4*>(kT + c * LD)[tx];
      const float4 vv = reinterpret_cast<const float4*>(vT + c * LD)[tx];
      const float qq4[4] = {qq.x, qq.y, qq.z, qq.w}, gg4[4] = {gg.x, gg.y, gg.z, gg.w};
      const float kk4[4] = {kk.x, kk.y, kk.z, kk.w}, vv4[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[a][e] = fmaf(qq4[a], kk4[e], s[a][e]);
          dp[a][e] = fmaf(gg4[a], vv4[e], dp[a][e]);
        }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty * 4 + a;
      const float l = lse_s[i];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok =
            l != -INFINITY && allowed(q_start + i, k_start + tx * 4 + e, skv, causal, window);
        const float p = ok ? expf(fmaf(s[a][e], scale, -l)) : 0.0f;
        dp[a][e] = p * (dp[a][e] - dd_s[i]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(dsT + (tx * 4 + e) * LD + ty * 4) =
          make_float4(dp[0][e], dp[1][e], dp[2][e], dp[3][e]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 dd = reinterpret_cast<const float4*>(dsT + j * LD)[ty];
      const float d4[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        const float x = kT[(tx + 16 * c) * LD + j];
#pragma unroll
        for (int a = 0; a < 4; ++a) dq_acc[a][c] = fmaf(d4[a], x, dq_acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qpos = q_start + ty * 4 + a;
    if (qpos < sq) {
      float* row = dq + (((long long)b * sq + qpos) * h + hh) * D;
#pragma unroll
      for (int c = 0; c < NJ; ++c) row[tx + 16 * c] = dq_acc[a][c] * scale;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int sq,
           int skv, int h, int kvh, int causal, int window, cudaStream_t stream) {
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(dkdv_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess) e = launch_delta<float>(out, dout, delta, b, sq, h, D, stream);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.0f / sqrtf((float)D);

  const dim3 grid_kv((unsigned)(b * kvh), (unsigned)((skv + BK - 1) / BK));
  dkdv_kernel<D><<<grid_kv, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), sq, skv,
      h, kvh, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_q((unsigned)(b * h), (unsigned)((sq + BQ - 1) / BQ));
  dq_kernel<D><<<grid_q, THREADS, smem, stream>>>(tq, tk, tv, tdo, lse, delta,
                                                  static_cast<float*>(dq), sq, skv, h, kvh,
                                                  causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;               // rows a TMA box, a consumer warpgroup and a ring tile
constexpr int BLOCK = 2 * ROWS;        // keys (dK/dV) or queries (dQ) a CTA
constexpr int CHUNK = 64;              // head-dim columns a box: one 128-byte swizzled row
constexpr int BOX = ROWS * CHUNK;      // elements a box
constexpr int BOX_BYTES = BOX * 2;
constexpr int CONSUMER_WARPS = 8;      // two warpgroups
constexpr int DKDV_STAGES = 3;         // the dK/dV ring, filled by warp 0
constexpr int DKDV_THREADS = 256;      // two warpgroups, no producer warp
constexpr int DQ_STAGES = 2;           // the dQ ring, filled by the producer warp
constexpr int DQ_THREADS = 288;        // warpgroups 0, 1 consume; warp 8 produces
constexpr int PRODUCER_WARP = 8;
constexpr float LOG2E = 1.4426950408889634f;

template <int NC>  // NC boxes of 64 columns a row
struct DkdvSmem {
  bf16 k[NC][2 * BOX];       // the CTA's 128 keys; warpgroup w's from row 64 w
  bf16 v[NC][2 * BOX];
  bf16 q[DKDV_STAGES][NC][BOX];   // the ring: 64 query rows of one head
  bf16 d_o[DKDV_STAGES][NC][BOX];
  float lse[DKDV_STAGES][ROWS];   // the tile's lse, 0 past Sq
  float dd[DKDV_STAGES][ROWS];    // the tile's D, 0 past Sq
  uint64_t kv_full, full[DKDV_STAGES], empty[DKDV_STAGES];
};

template <int NC>
struct DqSmem {
  bf16 q[NC][2 * BOX];       // the CTA's 128 queries; warpgroup w's from row 64 w
  bf16 d_o[NC][2 * BOX];
  bf16 k[DQ_STAGES][NC][BOX];   // the ring: 64 keys
  bf16 v[DQ_STAGES][NC][BOX];
  uint64_t q_full, full[DQ_STAGES], empty[DQ_STAGES];
};

// + room to align the base to the 1024-byte swizzle atom
template <typename S>
constexpr size_t smem_bytes() {
  return sizeof(S) + 1024;
}

template <typename S>
__device__ __forceinline__ S& aligned_smem(unsigned char* raw) {
  const uint32_t base = smem_u32(raw);
  return *reinterpret_cast<S*>(raw + (((base + 1023) & ~1023u) - base));
}

// A tile's descriptor, opaque to the compiler at this point: every k-step's
// descriptor is then this one plus a constant, computed where it is issued,
// so the loop does not hold a 64-bit register pair for each k-step's
// descriptor (dK/dV's consumers use 253 of their 255 registers).
__device__ __forceinline__ uint64_t base_desc(const void* p, uint32_t lbo) {
  uint64_t desc = sw128_desc(p, lbo, 1024);
  asm volatile("" : "+l"(desc));
  return desc;
}

// acc (64 x 64) = A B^T: A this warpgroup's 64 rows of a 128-row tile, B a
// 64-row tile, both K-major (d contiguous), 8-row groups 1024 bytes apart;
// a k-step of 16 columns is 32 bytes along the swizzled row, a box of the
// next 64 columns 2 BOX (A) or BOX (B) elements on. Descriptor addresses
// count 16-byte units.
template <int KSTEPS, int NC>
__device__ __forceinline__ void issue_abt(float (&acc)[32], const bf16 (&a)[NC][2 * BOX],
                                          const bf16 (&b)[NC][BOX], int wg) {
  const uint64_t da = base_desc(a[0] + wg * BOX, 16), db = base_desc(b[0], 16);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 2;
    const uint64_t ak = da + c * (2 * BOX * 2 / 16) + off, bk = db + c * (BOX * 2 / 16) + off;
    if (kk == 0)
      wgmma_m64n64k16_ss_first(acc, ak, bk);
    else
      wgmma_m64n64k16_ss(acc, ak, bk);
  }
}

// acc (64 x 64 NC) += (hi + lo) B: hi and lo the A operand's two bf16
// pieces (64 x 64, registers), B a 64-row tile read MN-major (the
// transpose bit), 8-row groups 1024 bytes apart; a k-step is 16 rows,
// 2048 bytes.
template <int NC>
__device__ __forceinline__ void issue_ab(float (&acc)[NC][32], const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4], const bf16 (&b)[NC][BOX]) {
  const uint64_t db = base_desc(b[0], 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t bk = db + c * (BOX * 2 / 16) + kk * (16 * CHUNK * 2 / 16);
      wgmma_m64n64k16_rs(acc[c], hi[kk], bk);
      wgmma_m64n64k16_rs(acc[c], lo[kk], bk);
    }
}

template <int NC>
__device__ __forceinline__ void fence_acc(float (&acc)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
}

template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* first, int first_count, uint64_t* full,
                                          int full_count, uint64_t* empty) {
  if (threadIdx.x == 0) {
    mbar_init(first, first_count);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// 4 bytes from global to shared memory, asynchronously; 0 when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// The mbarrier counts this thread's arrival once its earlier cp.asyncs have
// landed (an arrival of its expected count: the count was set for it).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// A consumer warp is done with a stage: every lane's reads have completed.
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// A (b, kv head, 128 keys) a CTA; the ring walks the G query heads and each
// one's live query tiles. KSTEPS: k-steps of 16 in S^T (d / 16).
template <int KSTEPS, int NC>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int skv, int h, int kvh, int d,
            int causal, int window, float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DkdvSmem<NC>& sm = aligned_smem<DkdvSmem<NC>>(smem_raw);

  const int b = blockIdx.x / kvh, kh = blockIdx.x % kvh, groups = h / kvh;
  const int k_start = blockIdx.y * BLOCK;  // the first keys, with the most causal work, first
  // the query tiles that see a key of this CTA: causal, none before
  // k_start; with a window, none after the last key's last viewer
  const int nq = (sq + ROWS - 1) / ROWS;
  int qb_lo = 0, qb_hi = nq;
  if (causal) qb_lo = min(nq, k_start / ROWS);
  if (window > 0) {
    const long long last = (long long)k_start + BLOCK - 1 + window - 1;
    if (last / ROWS + 1 < qb_hi) qb_hi = (int)(last / ROWS + 1);
  }
  const int per_head = max(0, qb_hi - qb_lo);
  const int n = groups * per_head;  // ring tiles: head i / per_head, tile qb_lo + i % per_head

  // a stage fills with lane 0's TMA bytes and warp 0's row-stat copies
  init_ring<DKDV_STAGES>(&sm.kv_full, 1, sm.full, 1 + 32, sm.empty);

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, cq = lane % 4;
  // Warp 0 fills the ring, DKDV_STAGES - 1 tiles ahead of itself: lane 0
  // issues the tile's TMA loads of Q and dO, every lane copies 2 of its 64
  // lse and D values with cp.async, whose completion the stage's mbarrier
  // tracks, so no thread waits on a load.
  auto fill = [&](int i) {
    const int s = i % DKDV_STAGES;
    const int hh = kh * groups + i / per_head, q0 = (qb_lo + i % per_head) * ROWS;
    const float* l0 = lse + ((long long)b * h + hh) * sq;
    const float* d0 = delta + ((long long)b * h + hh) * sq;
    if (lane == 0) mbar_wait(&sm.empty[s], ((i / DKDV_STAGES) & 1) ^ 1);
    __syncwarp();
#pragma unroll
    for (int r = lane; r < ROWS; r += 32) {  // rows past Sq read nothing and hold 0
      const bool in = q0 + r < sq;
      cp_async4(&sm.lse[s][r], l0 + (in ? q0 + r : 0), in);
      cp_async4(&sm.dd[s][r], d0 + (in ? q0 + r : 0), in);
    }
    cp_async_arrive(&sm.full[s]);
    if (lane == 0) {
      mbar_expect_tx(&sm.full[s], 2 * NC * BOX_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load(sm.q[s][c], &q_map, &sm.full[s], c * CHUNK, hh, q0, b);
        tma_load(sm.d_o[s][c], &do_map, &sm.full[s], c * CHUNK, hh, q0, b);
      }
    }
  };
  const bool filler = threadIdx.x < 32;
  if (filler && n > 0) {
    if (lane == 0) {
      mbar_expect_tx(&sm.kv_full, 4 * NC * BOX_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = k_start + half * ROWS;
          tma_load(sm.k[c] + half * BOX, &k_map, &sm.kv_full, c * CHUNK, kh, row, b);
          tma_load(sm.v[c] + half * BOX, &v_map, &sm.kv_full, c * CHUNK, kh, row, b);
        }
    }
    for (int i = 0; i < min(n, DKDV_STAGES - 1); ++i) fill(i);
  }

  const int kw = k_start + wg * ROWS;       // this warpgroup's first key
  const int key0 = kw + warp * 16 + g;      // this thread's keys: key0, key0 + 8
  float dk_acc[NC][32], dv_acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) dk_acc[c][x] = dv_acc[c][x] = 0.0f;

  if (n > 0) mbar_wait(&sm.kv_full, 0);
  for (int i = 0; i < n; ++i) {
    // tile i + DKDV_STAGES - 1 goes into the stage of tile i - 1, which
    // this warpgroup has released; the other may still hold it
    if (filler && i + DKDV_STAGES - 1 < n) fill(i + DKDV_STAGES - 1);
    const int s = i % DKDV_STAGES;
    const int q0 = (qb_lo + i % per_head) * ROWS;
    mbar_wait(&sm.full[s], (i / DKDV_STAGES) & 1);
    const bool dead = kw >= skv || (causal && q0 + ROWS - 1 < kw) ||
                      (window > 0 && q0 - (kw + ROWS - 1) >= window);
    if (dead) {  // no query of the tile sees this warpgroup's keys
      release(&sm.empty[s]);
      continue;
    }
    const bool need_mask = kw + ROWS > skv || (causal && q0 < kw + ROWS - 1) ||
                           (window > 0 && q0 + ROWS - 1 - kw >= window);

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns the tile's queries;
    // P^T is computed while dP^T's products run
    float st[32], dpt[32];
    wgmma_fence();
    issue_abt<KSTEPS, NC>(st, sm.k, sm.q[s], wg);
    wgmma_commit();
    issue_abt<KSTEPS, NC>(dpt, sm.v, sm.d_o[s], wg);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T in st; this thread holds queries 8 j + 2 cq + e of keys key0 and
    // key0 + 8 in x[4 j + 2 r + e]
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * j + 2 * cq + e;
        const float l = sm.lse[s][qc];
        const bool row_ok = q0 + qc < sq && l != -INFINITY;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * j + 2 * r + e;
          const bool ok =
              row_ok && (!need_mask || allowed(q0 + qc, key0 + 8 * r, skv, causal, window));
          st[x] = ok ? ex2(fmaf(st[x], scale_log2, -l * LOG2E)) : 0.0f;
        }
      }
    // dV += P^T dO, queued behind dP^T's products
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    split_bf16<4>(st, p_hi, p_lo);
    fence_acc<NC>(dv_acc);
    wgmma_fence();
    issue_ab<NC>(dv_acc, p_hi, p_lo, sm.d_o[s]);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(dpt);
    // dS^T = P^T (dP^T - D) in dpt, split while dV's products run
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dd = sm.dd[s][8 * j + 2 * cq + e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * j + 2 * r + e;
          dpt[x] = st[x] * (dpt[x] - dd);
        }
      }
    split_bf16<4>(dpt, ds_hi, ds_lo);

    // dK += dS^T Q
    fence_acc<NC>(dk_acc);
    wgmma_fence();
    issue_ab<NC>(dk_acc, ds_hi, ds_lo, sm.q[s]);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc<NC>(dv_acc);
    fence_acc<NC>(dk_acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    release(&sm.empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= skv) continue;
    const long long off = (((long long)b * skv + key) * kvh + kh) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * CHUNK + 8 * j + 2 * cq;
        if (col < d) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + col) = __floats2bfloat162_rn(
              dk_acc[c][4 * j + 2 * r] * scale, dk_acc[c][4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
              __floats2bfloat162_rn(dv_acc[c][4 * j + 2 * r], dv_acc[c][4 * j + 2 * r + 1]);
        }
      }
  }
}

// A (b, head, 128 queries) a CTA; the ring walks the live key tiles.
template <int KSTEPS, int NC>
__global__ void __launch_bounds__(DQ_THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
          const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
          int sq, int skv, int h, int kvh, int d, int causal, int window, float scale_log2,
          float scale) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem<NC>& sm = aligned_smem<DqSmem<NC>>(smem_raw);

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h, kh = hh / (h / kvh);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BLOCK;  // most causal work first
  // the live key tiles, as the forward skips them
  const int nk = (skv + ROWS - 1) / ROWS;
  int kb_lo = 0, kb_hi = nk;
  if (causal) kb_hi = min(nk, (q_start + BLOCK - 1) / ROWS + 1);
  if (window > 0 && q_start - window + 1 > 0) kb_lo = (q_start - window + 1) / ROWS;
  const int n = max(0, kb_hi - kb_lo);

  init_ring<DQ_STAGES>(&sm.q_full, 1, sm.full, 1, sm.empty);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    if (threadIdx.x == PRODUCER_WARP * 32 && n > 0) {
      mbar_expect_tx(&sm.q_full, 4 * NC * BOX_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = q_start + half * ROWS;
          tma_load(sm.q[c] + half * BOX, &q_map, &sm.q_full, c * CHUNK, hh, row, b);
          tma_load(sm.d_o[c] + half * BOX, &do_map, &sm.q_full, c * CHUNK, hh, row, b);
        }
      for (int i = 0; i < n; ++i) {
        const int s = i % DQ_STAGES, row = (kb_lo + i) * ROWS;
        mbar_wait(&sm.empty[s], ((i / DQ_STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * NC * BOX_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load(sm.k[s][c], &k_map, &sm.full[s], c * CHUNK, kh, row, b);
          tma_load(sm.v[s][c], &v_map, &sm.full[s], c * CHUNK, kh, row, b);
        }
      }
    }
  } else {
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, cq = lane % 4;
    const int qw = q_start + wg * ROWS;       // this warpgroup's first query
    const int row0 = qw + warp * 16 + g;      // this thread's rows: row0, row0 + 8
    float l2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      l2[r] = qpos < sq ? lse[(long long)bh * sq + qpos] * LOG2E : -INFINITY;
      dd[r] = qpos < sq ? delta[(long long)bh * sq + qpos] : 0.0f;
    }

    float dq_acc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int x = 0; x < 32; ++x) dq_acc[c][x] = 0.0f;

    if (n > 0) mbar_wait(&sm.q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % DQ_STAGES, k0 = (kb_lo + i) * ROWS;
      mbar_wait(&sm.full[s], (i / DQ_STAGES) & 1);
      const bool dead = qw >= sq || (causal && k0 > qw + ROWS - 1) ||
                        (window > 0 && qw - (k0 + ROWS - 1) >= window);
      if (dead) {  // no key of the tile is seen by this warpgroup's queries
        release(&sm.empty[s]);
        continue;
      }
      const bool need_mask = k0 + ROWS > skv || (causal && k0 + ROWS - 1 > qw) ||
                             (window > 0 && qw + ROWS - 1 - k0 >= window);

      // S = Q K^T and dP = dO V^T: rows this warpgroup's queries, columns
      // keys; P is computed while dP's products run
      float sc[32], dp[32];
      wgmma_fence();
      issue_abt<KSTEPS, NC>(sc, sm.q, sm.k[s], wg);
      wgmma_commit();
      issue_abt<KSTEPS, NC>(dp, sm.d_o, sm.v[s], wg);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P in sc; keys k0 + 8 j + 2 cq + e of rows row0 + 8 r
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * cq + e;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 4 * j + 2 * r + e;
            const bool ok = l2[r] != -INFINITY &&
                            (!need_mask || allowed(row0 + 8 * r, kpos, skv, causal, window));
            sc[x] = ok ? ex2(fmaf(sc[x], scale_log2, -l2[r])) : 0.0f;
          }
        }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P (dP - D) in dp
#pragma unroll
      for (int x = 0; x < 32; ++x) dp[x] = sc[x] * (dp[x] - dd[(x / 2) % 2]);
      uint32_t ds_hi[4][4], ds_lo[4][4];
      split_bf16<4>(dp, ds_hi, ds_lo);

      // dQ += dS K
      fence_acc<NC>(dq_acc);
      wgmma_fence();
      issue_ab<NC>(dq_acc, ds_hi, ds_lo, sm.k[s]);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc<NC>(dq_acc);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
      release(&sm.empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos >= sq) continue;
      bf16* out = dq + (((long long)b * sq + qpos) * h + hh) * d;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c * CHUNK + 8 * j + 2 * cq;
          if (col < d)
            *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
                dq_acc[c][4 * j + 2 * r] * scale, dq_acc[c][4 * j + 2 * r + 1] * scale);
        }
    }
  }
}

template <int KSTEPS, int NC>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int sq,
           int skv, int h, int kvh, int d, int causal, int window, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  int err = encode_bshd(&q_map, q, b, sq, h, d, ROWS);
  if (err == 0) err = encode_bshd(&k_map, k, b, skv, kvh, d, ROWS);
  if (err == 0) err = encode_bshd(&v_map, v, b, skv, kvh, d, ROWS);
  if (err == 0) err = encode_bshd(&do_map, dout, b, sq, h, d, ROWS);
  if (err != 0) return err;
  constexpr size_t kv_smem = smem_bytes<DkdvSmem<NC>>(), q_smem = smem_bytes<DqSmem<NC>>();
  cudaError_t e = cudaFuncSetAttribute(dkdv_kernel<KSTEPS, NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel<KSTEPS, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_smem);
  if (e == cudaSuccess) e = launch_delta<bf16>(out, dout, delta, b, sq, h, d, stream);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.0f / sqrtf((float)d), scale_log2 = LOG2E * scale;

  const dim3 grid_kv((unsigned)(b * kvh), (unsigned)((skv + BLOCK - 1) / BLOCK));
  dkdv_kernel<KSTEPS, NC><<<grid_kv, DKDV_THREADS, kv_smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      sq, skv, h, kvh, d, causal, window, scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_q((unsigned)(b * h), (unsigned)((sq + BLOCK - 1) / BLOCK));
  dq_kernel<KSTEPS, NC><<<grid_q, DQ_THREADS, q_smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<bf16*>(dq), sq, skv, h, kvh, d,
      causal, window, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

int dispatch_f32(int d, const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
                 int b, int sq, int skv, int h, int kvh, int causal, int window, cudaStream_t s) {
  switch (d) {
    case 64:
      return cc::launch<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kvh,
                            causal, window, s);
    case 80:
      return cc::launch<80>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kvh,
                            causal, window, s);
    case 128:
      return cc::launch<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kvh,
                             causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch_bf16(int d, const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
                  int b, int sq, int skv, int h, int kvh, int causal, int window,
                  cudaStream_t s) {
  switch (d) {
    case 64:
      return tc::launch<4, 1>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kvh,
                              d, causal, window, s);
    case 80:
      return tc::launch<5, 2>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kvh,
                              d, causal, window, s);
    case 128:
      return tc::launch<8, 2>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kvh,
                              d, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out, dout, dq: (b, sq, h, d); k, v, dk, dv: (b, skv, kvh, d); all
// contiguous, 16-byte aligned and of one dtype, float32 (bf16 = 0, the
// CUDA-core kernels) or bfloat16 (bf16 = 1, the tensor-core kernels). lse:
// the forward's float32 (b, h, sq); delta: float32 (b, h, sq) scratch.
// window <= 0 means no window.
extern "C" int flash_attention_bwd(int bf16, const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int b, int sq,
                                   int skv, int h, int kvh, int d, int causal, int window,
                                   void* stream) {
  last_route = -1;
  if (kvh <= 0 || h % kvh != 0) return (int)cudaErrorInvalidValue;
  if (b <= 0 || h <= 0) return 0;
  if ((long long)(sq + cc::BQ - 1) / cc::BQ > 65535 ||
      (long long)(skv + cc::BK - 1) / cc::BK > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t elem = bf16 ? 2 : 4;
  if (sq <= 0) {  // no query: dK and dV are 0
    const size_t bytes = (size_t)b * (skv > 0 ? skv : 0) * kvh * d * elem;
    cudaError_t e = cudaMemsetAsync(dk, 0, bytes, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, bytes, s);
    return (int)e;
  }
  if (skv <= 0)  // no key: every gradient is 0, and dK and dV are empty
    return (int)cudaMemsetAsync(dq, 0, (size_t)b * sq * h * d * elem, s);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int e = bf16 ? dispatch_bf16(d, q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, skv, h,
                                     kvh, causal, window, s)
                     : dispatch_f32(d, q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, skv, h,
                                    kvh, causal, window, s);
  if (e == 0) last_route = bf16 ? 1 : 0;
  return e;
}

// Which kernels the last call of flash_attention_bwd launched: 1 the
// tensor-core ones, 0 the CUDA-core ones, -1 none.
extern "C" int flash_attention_bwd_last_kernel() { return last_route; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
