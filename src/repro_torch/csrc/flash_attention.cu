// GQA flash attention, forward: online softmax over kv tiles, causal with an
// optional sliding window.
//
//   out[b, i, h, :] = sum_j p_ij v[b, j, h / G, :],
//   p_ij = softmax_j(q[b, i, h, :] . k[b, j, h / G, :] / sqrt(d)) over the
//   allowed j: j < Skv, and j <= i when causal, and i - j < window when a
//   window is given (query and key positions both start at 0).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:91), which runs a grid of
// (batch, head, q block, kv block) with the kv axis sequential, keeps the
// running max m, sum l and accumulator in VMEM scratch across kv steps, and
// skips whole kv blocks beyond the causal frontier or outside the window. The
// arithmetic is the same in both kernels here: scores in float32 divided by
// sqrt(d), masked entries set to the finite -1e30, p = exp(s - m_new) zeroed
// where masked, l and the accumulator rescaled by exp(m_prev - m_new), and at
// the end acc / max(l, 1e-30), so a row with nothing to attend to gives 0.
// The TPU wrapper shrinks its blocks to a divisor of S; here the tiles are
// fixed and the ragged edge is masked: key rows past Skv are zero in shared
// memory and masked, query rows past Sq are computed and not stored.
//
// Bound: at the prefill shapes of Llama-3.2-3B (B 4, S 2048, 24 query / 8 kv
// heads, d 128, causal) the work is 4 B H d x (allowed pairs) = 1.03e11
// FLOPs; at the card's 989 TFLOP/s bf16 tensor-core peak that is 0.10 ms,
// while the bytes (q, k, v read once, out written once: 0.13 GB in bf16) take
// 0.04 ms at 3.35 TB/s. So the bound is operations, on the tensor cores.
//
// bfloat16 operands: the tensor-core kernel (`tc::attention_kernel`).
//   * Both products run on the tensor cores with wgmma: S = Q K^T from
//     shared memory (bf16 x bf16 products are exact in float32, so S differs
//     from a float32 product only in the order of its sums), and O += P V
//     with P from registers (the float32 accumulator layout of S is the
//     register layout of the A operand after a pairwise convert) and V from
//     shared memory, row-major [BK][64] with the descriptor's transpose bit.
//   * P stays float32-exact: the TPU kernel multiplies float32 p by V, so
//     p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi) and both are
//     multiplied by the same V tile. The residual is below 2^-18 of p, so
//     PV is within ~4e-6 of its scale and the only rounding left is the
//     bf16 output's. The cost is 1.5x the tensor-core work of one-piece P
//     (executed 1.55e11 FLOPs at the Llama shape).
//   * The exponentials run in base 2 on scores pre-multiplied by
//     log2(e) / sqrt(d): the same function as exp(s / sqrt(d) - m), rounded
//     differently in the last float32 bits.
//   * CTA: 128 query rows of one (batch, head) and three warpgroups. Warps
//     0-7 are two consumer warpgroups of 64 rows each; warpgroup 2 is the
//     producer, of which one thread issues every load. `setmaxnreg` gives
//     the consumers 232 registers and the producer 40. Q is loaded once; K
//     and V tiles of 128 keys pass through 2-stage rings of their own in
//     shared memory, loaded by TMA (cp.async.bulk.tensor) with mbarrier
//     completion: the producer waits for a stage to be released by all
//     eight consumer warps, then loads the next live tile into it. Dead
//     tiles (beyond the causal frontier or outside the window) are skipped
//     before their loads are issued.
//   * Schedule: a consumer warpgroup's phase for tile i runs P(i-1) V(i-1),
//     then S(i) = Q K(i)^T, one after the other, so S and the P fragments
//     are never live together (O 64, S 64, P 64 registers at d 128); the
//     softmax of tile i follows. Named barriers alternate the two
//     warpgroups' phases, so one warpgroup's softmax runs while the
//     other's products hold the tensor cores.
//   * TMA maps are 4-D, {d, heads, S, B}, with a box of one head and 64
//     columns (128 bytes, the 128-byte swizzle that wgmma reads), so rows
//     past S are zero-filled instead of read from the next batch. d 128 is
//     two boxes a row; d 80 is a 64-column box plus a 64-column box of which
//     48 columns lie past d and are zero-filled: Q K^T then runs 5 k-steps of
//     16, not 8, but P V runs the 64 padded columns of the second box (d 80
//     does 87.5% of d 128's tensor-core work, not 62.5%).
//   * The maps are encoded on the host in the C entry, once a call, through
//     cuTensorMapEncodeTiled reached with cudaGetDriverEntryPoint (no
//     -lcuda), and passed as __grid_constant__ parameters.
//   * The query blocks with the most causal work are launched first.
//   * Shared memory: 160 KB at d 80 and 128 (Q 32 KB, K and V 2 x 32 KB
//     each), 80 KB at d 64; one CTA an SM. ptxas (CUDA 12.9) reports 168
//     registers a thread (384 threads at launch) and a 56-byte spill at
//     d 128, 32 bytes at d 80, none at d 64; chip_smoke.py prints both. A
//     phase that issued P V and Q K^T together, holding S, O and P at once,
//     made ptxas serialize the wgmmas.
//
// float32 operands: the first, CUDA-core kernel (`cc::attention_kernel`),
// float32 fused multiply-adds at the CUDA cores' 67 TFLOP/s peak (at best
// ~15x above the tensor-core bound). TF32 keeps ~10 bits of the mantissa and
// cannot hold a 1e-5 float32 tolerance, and no serve runs float32 attention
// at full width. One CTA of 256 threads per (b * H + h, 64-row query block):
// the query tile stays in shared memory transposed ([d][64]); K transposed
// ([d][64]) and V ([64][d]) are staged through shared memory a tile at a
// time; thread (ty, tx) of a 16 x 16 grid computes a 4 x 4 block of scores,
// reduces row maxima across its 16 lanes with shuffles, writes its
// probabilities transposed into the shared memory K used, and adds P V into
// its 4 x d/16 outputs. 96 KB of shared memory at d 128, two CTAs an SM.
//
// d is a template argument (64, 80, 128) in both kernels; statistics and
// accumulators are float32, the output in the operands' dtype (bf16 rounded
// to nearest even, as torch's cast is).
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool allowed(int qpos, int kpos, int skv, int causal,
                                        int window) {
  bool ok = kpos < skv;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

__global__ void fill_kernel(float* __restrict__ x, long long n, float value) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    x[i] = value;
}

// No key at all: every output row is 0 and every lse -inf.
int empty_keys(void* out, float* lse, size_t out_bytes, long long rows, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(out, 0, out_bytes, stream);
  if (e != cudaSuccess || lse == nullptr) return (int)e;
  const long long blocks = (rows + 255) / 256;
  fill_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(lse, rows,
                                                                             -INFINITY);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------
namespace cc {

constexpr int BQ = 64;            // query rows a CTA
constexpr int BK = 64;            // key rows a kv tile
constexpr int THREADS = 256;      // 16 x 16
constexpr int PT_STRIDE = BQ + 4; // floats a row of PT; keeps float4 rows aligned

template <int D>
__host__ __device__ constexpr int kt_floats() {
  return D * BK > BK * PT_STRIDE ? D * BK : BK * PT_STRIDE;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(D * BQ + kt_floats<D>() + BK * D);
}

// Rows [start, start + ROWS) of one head of x (row stride `row` floats)
// into shared memory transposed: dst[col * ROWS + r]. Rows past `limit` are
// zero. Neighbouring threads take neighbouring rows, so the stores fall in
// distinct banks.
template <int D, int ROWS>
__device__ __forceinline__ void load_transposed(const float* __restrict__ x, long long row,
                                                int start, int limit, float* dst) {
  for (int idx = threadIdx.x; idx < ROWS * (D / 4); idx += THREADS) {
    const int r = idx % ROWS, c = idx / ROWS;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (start + r < limit) v = *reinterpret_cast<const float4*>(x + (start + r) * row + c * 4);
    dst[(c * 4 + 0) * ROWS + r] = v.x;
    dst[(c * 4 + 1) * ROWS + r] = v.y;
    dst[(c * 4 + 2) * ROWS + r] = v.z;
    dst[(c * 4 + 3) * ROWS + r] = v.w;
  }
}

// The same rows kept row-major: dst[r * D + col].
template <int D>
__device__ __forceinline__ void load_rows(const float* __restrict__ x, long long row, int start,
                                          int limit, float* dst) {
  for (int idx = threadIdx.x; idx < BK * (D / 4); idx += THREADS) {
    const int c = idx % (D / 4), r = idx / (D / 4);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (start + r < limit) v = *reinterpret_cast<const float4*>(x + (start + r) * row + c * 4);
    *reinterpret_cast<float4*>(dst + r * D + c * 4) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int sq, int skv, int h, int kvh, int causal,
                 int window) {
  constexpr int NJ = D / 16;  // output columns a thread
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][BQ]
  float* kT = qT + D * BQ;                      // [D][BK]; PT [BK][PT_STRIDE] after the scores
  float* vs = kT + kt_floats<D>();              // [BK][D]
  float* pT = kT;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h, kh = hh / (h / kvh);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const float sqrt_d = sqrtf((float)D);

  const long long q_row = (long long)h * D, kv_row = (long long)kvh * D;
  const float* q0 = q + ((long long)b * sq * h + hh) * D;
  const float* k0 = k + ((long long)b * skv * kvh + kh) * D;
  const float* v0 = v + ((long long)b * skv * kvh + kh) * D;

  load_transposed<D, BQ>(q0, q_row, q_start, sq, qT);

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  const int nk = (skv + BK - 1) / BK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k_start = kb * BK;
    // the TPU kernel's block skip test (flash_attention.py:50-54)
    bool live = true;
    if (causal) live = live && k_start <= q_start + BQ - 1;
    if (window > 0) live = live && k_start + BK - 1 >= q_start - window + 1;
    if (!live) continue;

    __syncthreads();  // the last tile's P V is done with PT and V
    load_transposed<D, BK>(k0, kv_row, k_start, skv, kT);
    load_rows<D>(v0, kv_row, k_start, skv, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 a = reinterpret_cast<const float4*>(qT + kk * BQ)[ty];
      const float4 c = reinterpret_cast<const float4*>(kT + kk * BK)[tx];
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + ty * 4 + i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = allowed(qpos, k_start + tx * 4 + j, skv, causal, window);
        s[i][j] = ok ? s[i][j] / sqrt_d : NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = allowed(qpos, k_start + tx * 4 + j, skv, causal, window);
        p[i][j] = ok ? expf(s[i][j] - m_new) : 0.0f;
        rsum += p[i][j];
      }
      l[i] = l[i] * corr + rsum;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading K before PT overwrites it
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * PT_STRIDE + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pp = reinterpret_cast<const float4*>(pT + c * PT_STRIDE)[ty];
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int qpos = q_start + ty * 4 + i;
    if (lse != nullptr && tx == 0 && qpos < sq)
      lse[(long long)bh * sq + qpos] = li > 0.0f ? m[i] + logf(li) : -INFINITY;
    li = fmaxf(li, 1e-30f);
    if (qpos < sq) {
      float* o = out + (((long long)b * sq + qpos) * h + hh) * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[tx + 16 * j] = acc[i][j] / li;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b, int sq,
           int skv, int h, int kvh, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + BQ - 1) / BQ));
  attention_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, sq, skv, h, kvh, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int BQ = 128;            // query rows a CTA: two consumer warpgroups of 64
constexpr int BK = 128;            // key rows a kv tile
constexpr int STAGES = 2;          // the K/V ring
constexpr int CHUNK = 64;          // head-dim columns a TMA box: one 128-byte swizzled row
constexpr int THREADS = 384;       // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int CONSUMER_WARPS = 8;
constexpr int TILE_BYTES = BK * CHUNK * 2;  // one box of 128 rows; BQ == BK
static_assert(BQ == BK, "Q, K and V boxes share one shape");

template <int NC>  // NC boxes of 64 columns a row
struct Smem {
  __nv_bfloat16 q[NC][BQ * CHUNK];
  __nv_bfloat16 k[STAGES][NC][BK * CHUNK];
  __nv_bfloat16 v[STAGES][NC][BK * CHUNK];
  uint64_t q_full;
  uint64_t k_full[STAGES], k_empty[STAGES];  // K and V run in rings of their own: tile
  uint64_t v_full[STAGES], v_empty[STAGES];  // i's phase takes K(i) and V(i - 1)
};

template <int NC>
constexpr size_t smem_bytes() {
  return sizeof(Smem<NC>) + 1024;  // + room to align the base to the 1024-byte swizzle atom
}

// Named barriers 1 and 2 order the two consumer warpgroups' wgmma phases:
// warpgroup w issues between bar.sync on barrier 1 + w and bar.arrive on the
// other's, so one warpgroup's products run while the other does its softmax.
constexpr int TURN_BAR = 1;
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(TURN_BAR + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(TURN_BAR + (1 - wg)) : "memory");
}

// S = Q K^T for this warpgroup's 64 rows: K-major operands, 8-row groups
// 1024 bytes apart; a k-step of 16 columns is 32 bytes along the swizzled row.
template <int KSTEPS, int NC>
__device__ __forceinline__ void issue_qk(float (&sc)[64], const __nv_bfloat16 (&q)[NC][BQ * CHUNK],
                                         const __nv_bfloat16 (&k)[NC][BK * CHUNK], int wg) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 2;  // 16-byte units
    const uint64_t da = sw128_desc(q[c] + wg * 64 * CHUNK, 16, 1024) + off;
    const uint64_t db = sw128_desc(k[c], 16, 1024) + off;
    if (kk == 0)
      wgmma_m64n128k16_ss_first(sc, da, db);
    else
      wgmma_m64n128k16_ss(sc, da, db);
  }
}

// O += P_hi V + P_lo V: V is MN-major (64 columns contiguous a key row),
// 8-key groups 1024 bytes apart; a k-step is 16 key rows, 2048 bytes.
template <int NC>
__device__ __forceinline__ void issue_pv(float (&o)[NC][32], const uint32_t (&p_hi)[8][4],
                                         const uint32_t (&p_lo)[8][4],
                                         const __nv_bfloat16 (&v)[NC][BK * CHUNK]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t dv = sw128_desc(v[c] + kk * 16 * CHUNK, 1024, 1024);
      wgmma_m64n64k16_rs(o[c], p_hi[kk], dv);
      wgmma_m64n64k16_rs(o[c], p_lo[kk], dv);
    }
}

// The online softmax of one tile on this thread's rows row0 and row0 + 8:
// thread (g, cq) holds columns 8 j + 2 cq + {0, 1} of both rows (sc[4 j +
// 2 r + e], raw scores on entry). m is kept in the log2 domain; O and l
// are rescaled by exp(m_prev - m_new); on exit sc holds p, 0 where masked.
template <int NC>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&o)[NC][32], float (&m)[2],
                                             float (&l)[2], int row0, int k_start, int cq,
                                             bool need_mask, int skv, int causal, int window,
                                             float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        if (need_mask && !allowed(qpos, k_start + 8 * j + 2 * cq + e, skv, causal, window))
          x = NEG_INF;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale_log2);
    const float corr = ex2(m[r] - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        const bool ok = !need_mask || x != NEG_INF;
        x = ok ? ex2(fmaf(x, scale_log2, -m_new)) : 0.0f;
        sum += x;
      }
    l[r] = l[r] * corr + sum;  // this thread's share; the quad's shares add at the end
    m[r] = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j + 2 * r] *= corr;
        o[c][4 * j + 2 * r + 1] *= corr;
      }
  }
}

// KSTEPS: k-steps of 16 in Q K^T (d / 16); NC: 64-column boxes a row.
template <int KSTEPS, int NC>
__global__ void __launch_bounds__(THREADS, 1)
attention_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int sq, int skv, int h, int kvh, int d, int causal,
                 int window, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  Smem<NC>& sm = *reinterpret_cast<Smem<NC>*>(smem_raw + (((base + 1023) & ~1023u) - base));

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h, kh = hh / (h / kvh);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  // live kv tiles [kb_lo, kb_lo + n): the TPU kernel's block skip test
  // (flash_attention.py:50-54) as a range
  const int nk = (skv + BK - 1) / BK;
  int kb_lo = 0, kb_hi = nk;
  if (causal) kb_hi = min(nk, (q_start + BQ - 1) / BK + 1);
  if (window > 0 && q_start - window + 1 > 0) kb_lo = (q_start - window + 1) / BK;
  const int n = kb_hi - kb_lo;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], CONSUMER_WARPS);
      mbar_init(&sm.v_empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // -- producer: one thread issues every TMA load, in the order the
    // consumers take them: Q, K(0), then K(i + 1) and V(i) for each i
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256 && n > 0) {
      mbar_expect_tx(&sm.q_full, NC * TILE_BYTES);
      mbar_expect_tx(&sm.k_full[0], NC * TILE_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load(sm.q[c], &q_map, &sm.q_full, c * CHUNK, hh, q_start, b);
        tma_load(sm.k[0][c], &k_map, &sm.k_full[0], c * CHUNK, kh, kb_lo * BK, b);
      }
      for (int i = 0; i < n; ++i) {
        if (i + 1 < n) {
          const int s = (i + 1) % STAGES;
          mbar_wait(&sm.k_empty[s], (((i + 1) / STAGES) & 1) ^ 1);
          mbar_expect_tx(&sm.k_full[s], NC * TILE_BYTES);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load(sm.k[s][c], &k_map, &sm.k_full[s], c * CHUNK, kh, (kb_lo + i + 1) * BK, b);
        }
        const int s = i % STAGES;
        mbar_wait(&sm.v_empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.v_full[s], NC * TILE_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sm.v[s][c], &v_map, &sm.v_full[s], c * CHUNK, kh, (kb_lo + i) * BK, b);
      }
    }
  } else {
    // -- consumers: 64 query rows a warpgroup. Tile i's phase runs
    // P(i-1) V(i-1), then Q K(i)^T, one after the other (so the registers of
    // S and of P are never live together); its softmax then runs while the
    // other warpgroup's phase holds the tensor cores.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, cq = lane % 4;
    const int wg_first = q_start + wg * 64;
    const int row0 = wg_first + warp * 16 + g;  // this thread's rows: row0, row0 + 8

    float o[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

    if (n > 0) {
      float sc[64];
      uint32_t p_hi[8][4], p_lo[8][4];
      auto release = [&](uint64_t* bar) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      };
      // whether tile kb masks any entry of this warpgroup's rows
      auto need_mask = [&](int kb) {
        const int k_start = kb * BK;
        return k_start + BK > skv || (causal && k_start + BK - 1 > wg_first) ||
               (window > 0 && wg_first + 63 - k_start >= window);
      };

      mbar_wait(&sm.q_full, 0);
      if (wg == 1) turn_pass(wg);  // warpgroup 0 goes first
      mbar_wait(&sm.k_full[0], 0);
      turn_wait(wg);
      wgmma_fence();
      issue_qk<KSTEPS, NC>(sc, sm.q, sm.k[0], wg);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait_all();
      fence_regs(sc);
      release(&sm.k_empty[0]);
      softmax_tile<NC>(sc, o, m, l, row0, kb_lo * BK, cq, need_mask(kb_lo), skv, causal,
                       window, scale_log2);
      split_bf16<8>(sc, p_hi, p_lo);

      for (int i = 1; i < n; ++i) {
        const int sv = (i - 1) % STAGES, sk = i % STAGES;
        mbar_wait(&sm.v_full[sv], ((i - 1) / STAGES) & 1);
        mbar_wait(&sm.k_full[sk], (i / STAGES) & 1);
        turn_wait(wg);
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(o[c]);
        wgmma_fence();
        issue_pv<NC>(o, p_hi, p_lo, sm.v[sv]);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(o[c]);
        fence_regs(p_hi);
        fence_regs(p_lo);
        release(&sm.v_empty[sv]);
        wgmma_fence();
        issue_qk<KSTEPS, NC>(sc, sm.q, sm.k[sk], wg);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait_all();
        fence_regs(sc);
        release(&sm.k_empty[sk]);
        softmax_tile<NC>(sc, o, m, l, row0, (kb_lo + i) * BK, cq, need_mask(kb_lo + i), skv,
                         causal, window, scale_log2);
        split_bf16<8>(sc, p_hi, p_lo);
      }

      const int sv = (n - 1) % STAGES;
      mbar_wait(&sm.v_full[sv], ((n - 1) / STAGES) & 1);
      turn_wait(wg);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      wgmma_fence();
      issue_pv<NC>(o, p_hi, p_lo, sm.v[sv]);
      wgmma_commit();
      if (wg == 0) turn_pass(wg);  // warpgroup 1's last phase follows; no one follows it
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      fence_regs(p_hi);
      fence_regs(p_lo);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int qpos = row0 + 8 * r;
      // m is in the log2 domain of the scaled scores: lse = ln 2 (m + log2 l)
      if (lse != nullptr && cq == 0 && qpos < sq)
        lse[(long long)bh * sq + qpos] =
            lr > 0.0f ? (m[r] + log2f(lr)) * 0.6931471805599453f : -INFINITY;
      lr = fmaxf(lr, 1e-30f);
      if (qpos < sq) {
        __nv_bfloat16* orow = out + (((long long)b * sq + qpos) * h + hh) * d;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c * CHUNK + 8 * j + 2 * cq;
            if (col < d)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                  o[c][4 * j + 2 * r] / lr, o[c][4 * j + 2 * r + 1] / lr);
          }
      }
    }
  }
}

template <int KSTEPS, int NC>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b, int sq,
           int skv, int h, int kvh, int d, int causal, int window, cudaStream_t stream) {
  if (skv <= 0)  // nothing to attend to: every row is 0 (and its lse -inf)
    return empty_keys(out, lse, (size_t)b * sq * h * d * 2, (long long)b * h * sq, stream);
  CUtensorMap q_map, k_map, v_map;
  int err = encode_bshd(&q_map, q, b, sq, h, d, BQ);
  if (err == 0) err = encode_bshd(&k_map, k, b, skv, kvh, d, BK);
  if (err == 0) err = encode_bshd(&v_map, v, b, skv, kvh, d, BK);
  if (err != 0) return err;
  constexpr size_t smem = smem_bytes<NC>();
  cudaError_t e = cudaFuncSetAttribute(attention_kernel<KSTEPS, NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + BQ - 1) / BQ));
  attention_kernel<KSTEPS, NC><<<grid, THREADS, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, sq, skv, h, kvh, d, causal,
      window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace tc

int dispatch_f32(int d, const void* q, const void* k, const void* v, void* out, float* lse,
                 int b, int sq, int skv, int h, int kvh, int causal, int window,
                 cudaStream_t s) {
  if (skv <= 0) return empty_keys(out, lse, (size_t)b * sq * h * d * 4, (long long)b * h * sq, s);
  switch (d) {
    case 64: return cc::launch<64>(q, k, v, out, lse, b, sq, skv, h, kvh, causal, window, s);
    case 80: return cc::launch<80>(q, k, v, out, lse, b, sq, skv, h, kvh, causal, window, s);
    case 128: return cc::launch<128>(q, k, v, out, lse, b, sq, skv, h, kvh, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_bf16(int d, const void* q, const void* k, const void* v, void* out, float* lse,
                  int b, int sq, int skv, int h, int kvh, int causal, int window,
                  cudaStream_t s) {
  switch (d) {
    case 64: return tc::launch<4, 1>(q, k, v, out, lse, b, sq, skv, h, kvh, d, causal, window, s);
    case 80: return tc::launch<5, 2>(q, k, v, out, lse, b, sq, skv, h, kvh, d, causal, window, s);
    case 128: return tc::launch<8, 2>(q, k, v, out, lse, b, sq, skv, h, kvh, d, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, sq, h, d), k and v: (b, skv, kvh, d), out: (b, sq, h, d), all
// contiguous and 16-byte aligned, float32 (bf16 = 0) or bfloat16 (bf16 = 1).
// window <= 0 means no window. lse, when not null, receives each row's
// log-sum-exp of its scaled scores, float32 (b, h, sq), -inf for a row with
// no key to attend to: what the backward (flash_attention_bwd.cu) rebuilds
// the probabilities from. The serve passes null.
extern "C" int flash_attention_fwd(int bf16, const void* q, const void* k, const void* v,
                                   void* out, int b, int sq, int skv, int h, int kvh, int d,
                                   int causal, int window, void* lse, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0) return (int)cudaErrorInvalidValue;
  if ((long long)(sq + 63) / 64 > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  return bf16 ? dispatch_bf16(d, q, k, v, out, l, b, sq, skv, h, kvh, causal, window, s)
              : dispatch_f32(d, q, k, v, out, l, b, sq, skv, h, kvh, causal, window, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
