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
                 const float* __restrict__ v, float* __restrict__ out, int sq, int skv,
                 int h, int kvh, int causal, int window) {
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
    li = fmaxf(li, 1e-30f);
    const int qpos = q_start + ty * 4 + i;
    if (qpos < sq) {
      float* o = out + (((long long)b * sq + qpos) * h + hh) * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[tx + 16 * j] = acc[i][j] / li;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv,
           int h, int kvh, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + BQ - 1) / BQ));
  attention_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), sq, skv, h, kvh, causal, window);
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

// S (64 x 128, float32) += A (64 x 16, bf16, shared memory, K-major) x
// B (128 x 16, bf16, shared memory, K-major)^T.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The same product written over d: its first k-step. The outputs are
// write-only, so d's old values are dead before it.
__device__ __forceinline__ void wgmma_m64n128k16_ss_first(float (&d)[64], uint64_t desc_a,
                                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// O (64 x 64, float32) += A (64 x 16, bf16, registers) x B (16 x 64, bf16,
// shared memory, MN-major: the descriptor's transpose bit is set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x on the MUFU; 0 below 2^-126
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// p as the A operand of k-step kk (keys 16 kk .. 16 kk + 15): registers
// {row g, cols 2cq}, {row g + 8, cols 2cq}, {row g, cols 8 + 2cq},
// {row g + 8, cols 8 + 2cq}, each split into bf16 hi = bf16(p) and
// lo = bf16(p - hi).
__device__ __forceinline__ void split_p(const float (&sc)[64], uint32_t (&p_hi)[8][4],
                                        uint32_t (&p_lo)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int idx = 4 * (2 * kk + (a >> 1)) + 2 * (a & 1);
      const float x = sc[idx], y = sc[idx + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[kk][a] = bf16x2_bits(hi);
      p_lo[kk][a] = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
    }
}

// KSTEPS: k-steps of 16 in Q K^T (d / 16); NC: 64-column boxes a row.
template <int KSTEPS, int NC>
__global__ void __launch_bounds__(THREADS, 1)
attention_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                 int sq, int skv, int h, int kvh, int d, int causal, int window,
                 float scale_log2) {
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
      split_p(sc, p_hi, p_lo);

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
        split_p(sc, p_hi, p_lo);
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
      lr = fmaxf(lr, 1e-30f);
      const int qpos = row0 + 8 * r;
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

// A (b, s, heads, d) bf16 tensor as dims {d, heads, s, b} with a box of 64
// columns, one head and BK rows, 128-byte swizzled; out-of-bounds reads are 0.
int encode(CUtensorMap* map, const void* base, int b, int s, int heads, int d) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {CHUNK, 1, BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int KSTEPS, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv,
           int h, int kvh, int d, int causal, int window, cudaStream_t stream) {
  if (skv <= 0)  // nothing to attend to: every row is 0
    return (int)cudaMemsetAsync(out, 0, (size_t)b * sq * h * d * 2, stream);
  CUtensorMap q_map, k_map, v_map;
  int err = encode(&q_map, q, b, sq, h, d);
  if (err == 0) err = encode(&k_map, k, b, skv, kvh, d);
  if (err == 0) err = encode(&v_map, v, b, skv, kvh, d);
  if (err != 0) return err;
  constexpr size_t smem = smem_bytes<NC>();
  cudaError_t e = cudaFuncSetAttribute(attention_kernel<KSTEPS, NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + BQ - 1) / BQ));
  attention_kernel<KSTEPS, NC><<<grid, THREADS, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), sq, skv, h, kvh, d, causal, window,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace tc

int dispatch_f32(int d, const void* q, const void* k, const void* v, void* out, int b, int sq,
                 int skv, int h, int kvh, int causal, int window, cudaStream_t s) {
  switch (d) {
    case 64: return cc::launch<64>(q, k, v, out, b, sq, skv, h, kvh, causal, window, s);
    case 80: return cc::launch<80>(q, k, v, out, b, sq, skv, h, kvh, causal, window, s);
    case 128: return cc::launch<128>(q, k, v, out, b, sq, skv, h, kvh, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_bf16(int d, const void* q, const void* k, const void* v, void* out, int b, int sq,
                  int skv, int h, int kvh, int causal, int window, cudaStream_t s) {
  switch (d) {
    case 64: return tc::launch<4, 1>(q, k, v, out, b, sq, skv, h, kvh, d, causal, window, s);
    case 80: return tc::launch<5, 2>(q, k, v, out, b, sq, skv, h, kvh, d, causal, window, s);
    case 128: return tc::launch<8, 2>(q, k, v, out, b, sq, skv, h, kvh, d, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, sq, h, d), k and v: (b, skv, kvh, d), out: (b, sq, h, d), all
// contiguous and 16-byte aligned, float32 (bf16 = 0) or bfloat16 (bf16 = 1).
// window <= 0 means no window.
extern "C" int flash_attention_fwd(int bf16, const void* q, const void* k, const void* v,
                                   void* out, int b, int sq, int skv, int h, int kvh, int d,
                                   int causal, int window, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0) return (int)cudaErrorInvalidValue;
  if ((long long)(sq + 63) / 64 > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch_bf16(d, q, k, v, out, b, sq, skv, h, kvh, causal, window, s)
              : dispatch_f32(d, q, k, v, out, b, sq, skv, h, kvh, causal, window, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
