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
// row that sees no key); p is rebuilt here as exp(s / sqrt(d) - lse), and is
// 0 wherever the mask or an lse of -inf says so, so a row with nothing to
// attend to gets gradients of 0, never NaN.
//
// Three launches on one stream:
//   1. delta_kernel: D, one warp a row.
//   2. dkdv_kernel: one CTA of 256 threads per (b, kv head, 64-key block).
//      K and V stay in shared memory; the CTA loops over the G query heads
//      of its group and over the 64-row query blocks that the causal and
//      window masks let see its keys, recomputes S and dP for each, and
//      accumulates dV += P^T dO and dK += dS^T Q in registers, in float32.
//      Each dK and dV row is written once, by one CTA: no atomics, so two
//      runs give the same bits.
//   3. dq_kernel: one CTA per (b, head, 64-row query block), looping over
//      the live key blocks as the forward does and summing dS K in
//      registers.
// dK/dV and dQ each recompute S and dP: 7 products of 64 x 64 x d a live
// tile pair where the forward has 2 (3.5x its work; a kernel that shares S
// between them needs atomics on dQ).
//
// Arithmetic: every product and sum in float32 on the CUDA cores (fused
// multiply-adds), from bf16 operands widened exactly; bf16 outputs are
// rounded to nearest even once, at the end. A thread of a 16 x 16 grid
// owns a 4 x 4 block of S and dP and a 4 x d/16 block of the accumulators;
// the operands are staged transposed in shared memory ([d][64], rows padded
// to 68 floats) so that each k-step reads one float4 of each side.
//
// Bound: at Llama-3.2-3B's training shape (B 4, S 2048, 24/8 heads, d 128,
// causal) the gradient is 2.5x the forward's 1.03e11 FLOPs, 2.6e11, which
// is 0.26 ms at the card's 989 TFLOP/s bf16 tensor-core peak. This kernel
// runs on the CUDA cores (67 TFLOP/s float32 peak) and executes 3.5x the
// forward's work, so it stays far from that bound; moving its products to
// wgmma is a later step.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows a tile
constexpr int BK = 64;       // key rows a tile
constexpr int THREADS = 256; // 16 x 16
constexpr int LD = 68;       // floats a row of a transposed tile; keeps float4 rows aligned

__device__ __forceinline__ bool allowed(int qpos, int kpos, int skv, int causal,
                                        int window) {
  bool ok = kpos < skv;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Rows [start, start + 64) of one head of x (row stride `row` elements) into
// shared memory transposed, dst[col * LD + r]; rows past `limit` are zero.
template <int D, typename T>
__device__ __forceinline__ void load_t(const T* __restrict__ x, long long row, int start,
                                       int limit, float* dst) {
  for (int idx = threadIdx.x; idx < 64 * (D / 4); idx += THREADS) {
    const int r = idx % 64, c = idx / 64;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (start + r < limit) v = load4(x + (start + r) * row + c * 4);
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

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int sq,
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
    const T* q0 = q + ((long long)b * sq * h + hh) * D;
    const T* do0 = dout + ((long long)b * sq * h + hh) * D;
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
        put(dk + off + tx + 16 * j, dk_acc[a][j] * scale);
        put(dv + off + tx + 16 * j, dv_acc[a][j]);
      }
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int sq, int skv, int h, int kvh,
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
  const T* k0 = k + ((long long)b * skv * kvh + kh) * D;
  const T* v0 = v + ((long long)b * skv * kvh + kh) * D;

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
      T* row = dq + (((long long)b * sq + qpos) * h + hh) * D;
#pragma unroll
      for (int c = 0; c < NJ; ++c) put(row + tx + 16 * c, dq_acc[a][c] * scale);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int sq,
           int skv, int h, int kvh, int causal, int window, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  if (skv <= 0)  // no key: every gradient is 0, and dK and dV are empty
    return (int)cudaMemsetAsync(dq, 0, (size_t)b * sq * h * D * sizeof(T), stream);
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(dkdv_kernel<D, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.0f / sqrtf((float)D);

  const long long rows = (long long)b * sq * h;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(out), tdo, delta, rows, sq, h, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_kv((unsigned)(b * kvh), (unsigned)((skv + BK - 1) / BK));
  dkdv_kernel<D, T><<<grid_kv, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, h, kvh,
      causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_q((unsigned)(b * h), (unsigned)((sq + BQ - 1) / BQ));
  dq_kernel<D, T><<<grid_q, THREADS, smem, stream>>>(tq, tk, tv, tdo, lse, delta,
                                                     static_cast<T*>(dq), sq, skv, h, kvh,
                                                     causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
             int b, int sq, int skv, int h, int kvh, int causal, int window, cudaStream_t s) {
  switch (d) {
    case 64:
      return launch<64, T>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kvh,
                           causal, window, s);
    case 80:
      return launch<80, T>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kvh,
                           causal, window, s);
    case 128:
      return launch<128, T>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kvh,
                            causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out, dout, dq: (b, sq, h, d); k, v, dk, dv: (b, skv, kvh, d); all
// contiguous, 16-byte aligned and of one dtype, float32 (bf16 = 0) or
// bfloat16 (bf16 = 1). lse: the forward's float32 (b, h, sq); delta: float32
// (b, h, sq) scratch. window <= 0 means no window.
extern "C" int flash_attention_bwd(int bf16, const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int b, int sq,
                                   int skv, int h, int kvh, int d, int causal, int window,
                                   void* stream) {
  if (kvh <= 0 || h % kvh != 0) return (int)cudaErrorInvalidValue;
  if (b <= 0 || h <= 0) return 0;
  if ((long long)(sq + BQ - 1) / BQ > 65535 || (long long)(skv + BK - 1) / BK > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (sq <= 0) {  // no query: dK and dV are 0
    const size_t bytes = (size_t)b * (skv > 0 ? skv : 0) * kvh * d * (bf16 ? 2 : 4);
    cudaError_t e = cudaMemsetAsync(dk, 0, bytes, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, bytes, s);
    return (int)e;
  }
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  return bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, skv,
                                        h, kvh, causal, window, s)
              : dispatch<float>(d, q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, skv, h, kvh,
                                causal, window, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
