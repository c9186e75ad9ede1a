// Fused SwiGLU FFN, forward: out = (silu(x Wg) * (x Wu)) Wd, for x (m, d),
// Wg and Wu (d, f), Wd (f, d). Every input is widened to float32, the three
// products and h = silu(g) * u are taken in float32, and the output is cast
// to x's dtype.
//
// Replaces the Pallas TPU kernel `swiglu_pallas` (src/repro/kernels/
// swiglu.py:48), whose grid runs (m blocks, f blocks) with the f axis
// sequential: each f block's h tile is formed in VMEM and multiplied into a
// (block_m, d) float32 accumulator that stays in VMEM scratch, so h never
// reaches HBM. On the card a (block_m, d) float32 accumulator does not fit
// a CTA (64 rows of d 4096 are 1 MB), so h crosses device memory once,
// written by the first product's epilogue and read by the second.
//
// Bound: at the Jamba dense-FFN prefill shape (m 8192, d 4096, f 14336)
// the function is 3 products of 2 m d f = 2.886e12 FLOPs: 2.92 ms at the
// tensor cores' 989 TFLOP/s in bf16. This design executes 4 products' worth
// (the down product runs once per piece of h, below): 3.848e12 FLOPs, 3.89
// ms. h crosses device memory twice as two bf16 pieces (0.94 GB, 0.28 ms at
// 3.35 TB/s), x, the weights and out once (0.49 GB). In float32 the
// products run as 3xTF32 on the tensor cores: 3 x 2.886e12 FLOPs at 495
// TFLOP/s, 17.5 ms (43 ms at the CUDA cores' 67 TFLOP/s of FP32).
//
// Design: two warp-specialised wgmma GEMMs fed by TMA, run one after the
// other on the stream, each with a CTA of three warpgroups: warpgroup 2's
// first thread is the producer, issuing every TMA load of a ring of
// shared-memory stages (mbarriers: `full` completes on the loads' bytes,
// `empty` on the eight consumer warps' releases); warpgroups 0 and 1 each
// take 64 of the CTA's 128 rows and issue m64n128 wgmmas from shared memory,
// keeping one group in flight while the next stage's products are issued.
// `setmaxnreg` gives the consumers 232 registers and the producer 40. The
// CTAs are rasterized in groups of 8 row blocks, so the tiles in flight
// share their B columns in L2.
//   * GEMM 1, gate and up together: one x tile feeds the Wg and Wu tiles of
//     the same 128 f columns, two float32 accumulators in registers. The
//     epilogue forms h = (g * (1 / (1 + expf(-g)))) * u in float32 (IEEE
//     expf: the build has no fast math) and writes it to a scratch buffer
//     as pieces: in bf16 h_hi = bf16(h), h_lo = bf16(h - h_hi), whose sum
//     keeps h to ~2^-17 (one piece would keep 2^-9, which spends a large
//     share of the one-bf16-step gate before the output's own rounding;
//     tests/test_torch_swiglu_split.py holds both).
//   * GEMM 2, the down product over the pieces: out = sum_p h_p Wd, one
//     float32 accumulator, each k tile's Wd tile multiplied by every piece
//     of h; the epilogue casts to x's dtype. No split partials, no second
//     reduction pass.
//   * bf16 operands: bf16 x bf16 products are exact, summed in float32.
//     Wg, Wu and Wd are read as they lie (row-major: the f or d columns
//     contiguous) through the B descriptor's transpose bit.
//   * float32 operands: 3xTF32. a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi with
//     a_hi = tf32(a), a_lo = tf32(a - a_hi) (round to nearest on the bits),
//     residual ~2^-21 a product. A packing pass writes the pieces of x and
//     of the weights; tf32 wgmma reads only K-major operands, so the pass
//     also transposes the weights to (f, d) and (d, f). h's pieces come from
//     GEMM 1's epilogue the same way.
//   * Ragged shapes: TMA zero-fills rows and columns past the tensor's
//     extent, so the tiles need no masks but the epilogues' stores. TMA
//     needs row strides of a multiple of 16 bytes; a bf16 operand whose
//     row is not (d or f not a multiple of 8) is first copied by the
//     packing pass into a padded buffer.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;             // rows a CTA: two consumer warpgroups of 64
constexpr int THREADS = 384;        // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int CONSUMER_WARPS = 8;
constexpr int BOX_BYTES = 16384;    // an A piece of a stage: 128 rows x 128 bytes
constexpr int STAGE_SPACE = 196608; // shared memory for the ring
constexpr int GROUP_M = 8;          // row blocks a rasterization group
constexpr int H_PIECES = 2;         // h's pieces (swiglu.H_PIECES)
constexpr int FPAD = 64;            // h's row length: f rounded up to this

// One GEMM of the pipeline:
//   TF32: float32 operands as tf32 pieces (K-major, 32 a 128-byte row),
//         else bf16 (64 a row; B MN-major, read through the transpose bit);
//   GATE_UP: GEMM 1 (two B operands, two accumulators, the h epilogue),
//         else GEMM 2 (one B operand, the output epilogue).
//   BN: output columns a CTA, 128; 64 for the tf32 GATE_UP GEMM, whose
//         two accumulators and two partial sums (below) must fit the
//         registers.
template <bool TF32, bool GATE_UP>
struct Gemm {
  static constexpr int NA = GATE_UP ? (TF32 ? 2 : 1) : H_PIECES;  // A pieces
  static constexpr int NBP = TF32 ? 2 : 1;                          // pieces a B operand
  static constexpr int NOPS = GATE_UP ? 2 : 1;                      // B operands, accumulators
  static constexpr int NB = NOPS * NBP;
  static constexpr int BN = TF32 && GATE_UP ? 64 : 128;
  static constexpr int ACC = BN / 2;                                // accumulator floats a thread
  static constexpr int B_BYTES = BN * 128;                          // a B piece of a stage
  static constexpr int BK = TF32 ? 32 : 64;                         // k a stage
  static constexpr int KSTEPS = 4;                                  // wgmma k-steps a stage
  static constexpr int STAGE_BYTES = NA * BOX_BYTES + NB * B_BYTES;
  static constexpr int STAGES = STAGE_SPACE / STAGE_BYTES;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(STAGES >= 2, "a ring needs two stages");
};

__device__ __forceinline__ float tf32_rn(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xFFFFE000u);
}

// D (64 x 128, float32) += A (64 x 16, bf16, shared, K-major) x B (16 x 128,
// bf16, shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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

// D (64 x 128, float32) = A (64 x 8, tf32, shared, K-major) x B (8 x 128,
// tf32, shared, K-major) + (accumulate ? D : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The same at n 64: D (64 x 64) = A (64 x 8) x B (8 x 64) + (accumulate ? D : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The CTA's tile of one GEMM (see Gemm). m: rows; nk: k tiles; the A map
// is 3-D {k, rows, piece} with a {BK, 128, 1} box; each B map is, in bf16,
// {n, k, 1} with a {64, 64, 1} box (two boxes a stage), in tf32
// {k, n, piece} with a {32, BN, 1} box. GATE_UP: h (pieces, m, fp) gets
// this CTA's columns n < fp; else out (m, n_out) in x's dtype.
//
// The tensor cores add a wgmma's products into its accumulator with less
// than float32's round-to-nearest (measured on the card: 3xTF32 summed
// over 3 x 1024 terms in one accumulator missed 1e-5 of the output's
// scale). So in tf32 each stage's products go into a partial sum that
// starts from 0, and the partial is added into the accumulator with an
// IEEE float32 add once the stage's products are done; a chain inside
// the tensor cores is then 3 x 32 terms long. The bf16 path's gate (one
// bf16 step) leaves room for whole-k chains, and keeps one group in
// flight instead.
template <bool TF32, bool GATE_UP>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b0_map,
            const __grid_constant__ CUtensorMap b1_map, void* __restrict__ dst, int m, int n_out,
            int nk, int tiles_m, int tiles_n) {
  using G = Gemm<TF32, GATE_UP>;
  constexpr int BN = G::BN, ACC = G::ACC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((base + 1023) & ~1023u) - base);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::STAGES * G::STAGE_BYTES);
  uint64_t* empty = full + G::STAGES;
  auto a_box = [&](int s, int a) { return ring + s * G::STAGE_BYTES + a * BOX_BYTES; };
  auto b_box = [&](int s, int q) {
    return ring + s * G::STAGE_BYTES + G::NA * BOX_BYTES + q * G::B_BYTES;
  };

  // rasterization: GROUP_M row blocks walk the column blocks together
  const int pid = blockIdx.x, width = GROUP_M * tiles_n;
  const int first_m = (pid / width) * GROUP_M;
  const int gsz = min(tiles_m - first_m, GROUP_M);
  const int m0 = (first_m + (pid % width) % gsz) * BM;
  const int n0 = ((pid % width) / gsz) * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % G::STAGES;
        mbar_wait(&empty[s], ((kt / G::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], G::STAGE_BYTES);
        const int k0 = kt * G::BK;
#pragma unroll
        for (int a = 0; a < G::NA; ++a) tma_load_3d(a_box(s, a), &a_map, &full[s], k0, m0, a);
#pragma unroll
        for (int o = 0; o < G::NOPS; ++o) {
          const CUtensorMap* map = o == 0 ? &b0_map : &b1_map;
          if constexpr (TF32) {
#pragma unroll
            for (int p = 0; p < G::NBP; ++p)
              tma_load_3d(b_box(s, o * G::NBP + p), map, &full[s], k0, n0, p);
          } else {  // [64 k][64 n] boxes, the second 64 columns 8 KB on
            tma_load_3d(b_box(s, o), map, &full[s], n0, k0, 0);
            tma_load_3d(b_box(s, o) + 8192, map, &full[s], n0 + 64, k0, 0);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  float acc[G::NOPS][ACC];
#pragma unroll
  for (int o = 0; o < G::NOPS; ++o)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[o][i] = 0.0f;
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };

  if constexpr (TF32) {
    float part[G::NOPS][ACC];
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % G::STAGES;
      mbar_wait(&full[s], (kt / G::STAGES) & 1);
#pragma unroll
      for (int o = 0; o < G::NOPS; ++o) fence_regs(part[o]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G::KSTEPS; ++kk)
#pragma unroll
        for (int o = 0; o < G::NOPS; ++o)
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              if (a + p >= 2) continue;  // 3xTF32 drops lo x lo
              // A: this warpgroup's 64 rows (8 KB on); both K-major, 32
              // bytes a k-step; the stage's first product starts the partial
              const uint64_t da = sw128_desc(a_box(s, a) + wg * 8192, 16, 1024) + 2 * kk;
              const uint64_t db = sw128_desc(b_box(s, o * 2 + p), 16, 1024) + 2 * kk;
              wgmma_tf32(part[o], da, db, kk + a + p > 0);
            }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int o = 0; o < G::NOPS; ++o) fence_regs(part[o]);
      release(s);
#pragma unroll
      for (int o = 0; o < G::NOPS; ++o)
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[o][i] += part[o][i];
    }
  } else {
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % G::STAGES;
      mbar_wait(&full[s], (kt / G::STAGES) & 1);
#pragma unroll
      for (int o = 0; o < G::NOPS; ++o) fence_regs(acc[o]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G::KSTEPS; ++kk)
#pragma unroll
        for (int o = 0; o < G::NOPS; ++o)
#pragma unroll
          for (int a = 0; a < G::NA; ++a) {
            // A: this warpgroup's 64 rows (8 KB on), K-major, 32 bytes a
            // k-step; B MN-major: 16 k rows of 128 bytes a k-step, the
            // second 64 columns 8 KB on (leading offset), 8-row groups 1 KB
            // apart
            const uint64_t da = sw128_desc(a_box(s, a) + wg * 8192, 16, 1024) + 2 * kk;
            const uint64_t db = sw128_desc(b_box(s, o) + kk * 2048, 8192, 1024);
            wgmma_bf16(acc[o], da, db);
          }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
#pragma unroll
      for (int o = 0; o < G::NOPS; ++o) fence_regs(acc[o]);
      if (kt > 0) release((kt - 1) % G::STAGES);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int o = 0; o < G::NOPS; ++o) fence_regs(acc[o]);
  }

  // thread (warp, g, cq) holds rows 16 warp + g + 8 r and columns
  // 8 j + 2 cq + e of its warpgroup's 64 x BN tile in acc[.][4 j + 2 r + e]
  const int g = lane / 4, cq = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wg * 64 + warp * 16 + g + 8 * r;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * cq;
      const int i = 4 * j + 2 * r;
      if constexpr (GATE_UP) {  // h (pieces, m, fp), fp = n_out: a multiple of 64
        if (col >= n_out) continue;
        float h[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gv = acc[0][i + e];
          h[e] = (gv * (1.f / (1.f + expf(-gv)))) * acc[1][i + e];
        }
        const long long off = (long long)row * n_out + col;
        const long long piece = (long long)m * n_out;
        if constexpr (TF32) {
          float* hp = static_cast<float*>(dst);
          const float2 hi = make_float2(tf32_rn(h[0]), tf32_rn(h[1]));
          *reinterpret_cast<float2*>(hp + off) = hi;
          *reinterpret_cast<float2*>(hp + piece + off) =
              make_float2(tf32_rn(h[0] - hi.x), tf32_rn(h[1] - hi.y));
        } else {
          __nv_bfloat16* hp = static_cast<__nv_bfloat16*>(dst);
          float rest[2] = {h[0], h[1]};
#pragma unroll
          for (int p = 0; p < H_PIECES; ++p) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(rest[0], rest[1]);
            *reinterpret_cast<__nv_bfloat162*>(hp + p * piece + off) = v;
            const float2 vf = __bfloat1622float2(v);
            rest[0] -= vf.x;
            rest[1] -= vf.y;
          }
        }
      } else {  // out (m, n_out) in x's dtype
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= n_out) continue;
          const long long off = (long long)row * n_out + col + e;
          if constexpr (TF32)
            static_cast<float*>(dst)[off] = acc[0][i + e];
          else
            static_cast<__nv_bfloat16*>(dst)[off] = __float2bfloat16_rn(acc[0][i + e]);
        }
      }
    }
  }
}

// The packing pass: src (rows, cols) row-major into dst with row stride
// ld, transposed (dst (cols, rows)) when asked. PIECES 2: float32 into its
// tf32 pieces hi = tf32(v), lo = tf32(v - hi), piece p at dst + p * stride;
// PIECES 1: a plain copy (bf16 into a padded buffer). 32 x 32 tiles through
// shared memory, so both sides are read and written along their rows.
template <typename T, int PIECES>
__global__ void pack_kernel(const T* __restrict__ src, int rows, int cols, T* __restrict__ dst,
                            long long ld, long long stride, int transpose) {
  __shared__ T tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;  // 32 x 8
  const int c0 = blockIdx.x * 32;
  for (int r0 = blockIdx.y * 32; r0 < rows; r0 += gridDim.y * 32) {
#pragma unroll
    for (int i = 0; i < 32; i += 8) {
      const int r = r0 + ty + i, c = c0 + tx;
      if (r < rows && c < cols) tile[ty + i][tx] = src[(long long)r * cols + c];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 32; i += 8) {
      // transposed: dst row c0 + ty + i, column r0 + tx
      const int r = transpose ? c0 + ty + i : r0 + ty + i;
      const int c = transpose ? r0 + tx : c0 + tx;
      if (r < (transpose ? cols : rows) && c < (transpose ? rows : cols)) {
        const T v = transpose ? tile[tx][ty + i] : tile[ty + i][tx];
        const long long off = (long long)r * ld + c;
        if constexpr (PIECES == 2) {
          const float hi = tf32_rn(v);
          dst[off] = hi;
          dst[stride + off] = tf32_rn(v - hi);
        } else {
          dst[off] = v;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int PIECES>
int pack(const void* src, int rows, int cols, void* dst, long long ld, long long stride,
         bool transpose, cudaStream_t s) {
  const long long row_tiles = (rows + 31) / 32;
  const dim3 grid((unsigned)((cols + 31) / 32), (unsigned)(row_tiles < 65535 ? row_tiles : 65535));
  pack_kernel<T, PIECES><<<grid, dim3(32, 8), 0, s>>>(static_cast<const T*>(src), rows, cols,
                                                      static_cast<T*>(dst), ld, stride,
                                                      transpose ? 1 : 0);
  return (int)cudaGetLastError();
}

// A 3-D tensor map {d0, d1, d2} (d0 contiguous, rows of ld elements, d2
// planes of d1 rows), box {b0, b1, 1}, 128-byte swizzle; out of bounds is 0.
int encode3(CUtensorMap* map, bool bf16, const void* base, long long d0, long long d1,
            long long d2, long long ld, int b0, int b1) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const long long eb = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(ld * eb), (cuuint64_t)(d1 * ld * eb)};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r =
      fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
         const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool TF32, bool GATE_UP>
int run_gemm(const CUtensorMap& a, const CUtensorMap& b0, const CUtensorMap& b1, void* dst,
             int m, int n_cover, int n_out, int nk, cudaStream_t s) {
  using G = Gemm<TF32, GATE_UP>;
  const cudaError_t e = cudaFuncSetAttribute(gemm_kernel<TF32, GATE_UP>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)G::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles_m = (m + BM - 1) / BM, tiles_n = (n_cover + G::BN - 1) / G::BN;
  gemm_kernel<TF32, GATE_UP><<<(unsigned)((long long)tiles_m * tiles_n), THREADS, G::SMEM, s>>>(
      a, b0, b1, dst, m, n_out, nk, tiles_m, tiles_n);
  return (int)cudaGetLastError();
}

long long up(long long v, long long to) { return (v + to - 1) / to * to; }

// The workspace: each region 256-byte aligned, in this order.
struct Layout {
  long long fp;                        // h's row length
  long long h, x, wg, wu, wd, total;   // byte offsets (-1: not used)
};

Layout layout(bool bf16, long long m, long long d, long long f) {
  Layout l{};
  l.fp = up(f, FPAD);
  long long at = 0;
  auto take = [&](long long bytes) {
    const long long o = at;
    at += up(bytes, 256);
    return o;
  };
  if (bf16) {
    l.h = take(H_PIECES * m * l.fp * 2);
    const bool pad_d = d % 8 != 0, pad_f = f % 8 != 0;
    l.x = pad_d ? take(m * up(d, 8) * 2) : -1;
    l.wd = pad_d ? take(f * up(d, 8) * 2) : -1;
    l.wg = pad_f ? take(d * up(f, 8) * 2) : -1;
    l.wu = pad_f ? take(d * up(f, 8) * 2) : -1;
  } else {
    l.h = take(2 * m * l.fp * 4);
    l.x = take(2 * m * up(d, 4) * 4);
    l.wg = take(2 * f * up(d, 4) * 4);
    l.wu = take(2 * f * up(d, 4) * 4);
    l.wd = take(2 * d * up(f, 4) * 4);
  }
  l.total = at;
  return l;
}

#define CHECK(expr)           \
  do {                        \
    const int rc_ = (expr);   \
    if (rc_ != 0) return rc_; \
  } while (0)

int launch_bf16(const void* x, const void* wg, const void* wu, const void* wd, char* ws,
                void* out, int m, int d, int f, cudaStream_t s) {
  const Layout l = layout(true, m, d, f);
  long long ldd = d, ldf = f;
  if (l.x >= 0) {  // d not a multiple of 8: x and Wd into rows of up(d, 8)
    ldd = up(d, 8);
    CHECK((pack<__nv_bfloat16, 1>(x, m, d, ws + l.x, ldd, 0, false, s)));
    CHECK((pack<__nv_bfloat16, 1>(wd, f, d, ws + l.wd, ldd, 0, false, s)));
    x = ws + l.x;
    wd = ws + l.wd;
  }
  if (l.wg >= 0) {  // f not a multiple of 8: Wg and Wu into rows of up(f, 8)
    ldf = up(f, 8);
    CHECK((pack<__nv_bfloat16, 1>(wg, d, f, ws + l.wg, ldf, 0, false, s)));
    CHECK((pack<__nv_bfloat16, 1>(wu, d, f, ws + l.wu, ldf, 0, false, s)));
    wg = ws + l.wg;
    wu = ws + l.wu;
  }
  CUtensorMap a, b0, b1;
  CHECK(encode3(&a, true, x, d, m, 1, ldd, 64, BM));
  CHECK(encode3(&b0, true, wg, f, d, 1, ldf, 64, 64));
  CHECK(encode3(&b1, true, wu, f, d, 1, ldf, 64, 64));
  void* h = ws + l.h;
  CHECK((run_gemm<false, true>(a, b0, b1, h, m, (int)l.fp, (int)l.fp, (d + 63) / 64, s)));
  CHECK(encode3(&a, true, h, l.fp, m, H_PIECES, l.fp, 64, BM));
  CHECK(encode3(&b0, true, wd, d, f, 1, ldd, 64, 64));
  return run_gemm<false, false>(a, b0, b0, out, m, d, d, (int)(l.fp / 64), s);
}

int launch_tf32(const void* x, const void* wg, const void* wu, const void* wd, char* ws,
                void* out, int m, int d, int f, cudaStream_t s) {
  const Layout l = layout(false, m, d, f);
  const long long ldd = up(d, 4), ldf = up(f, 4);
  CHECK((pack<float, 2>(x, m, d, ws + l.x, ldd, (long long)m * ldd, false, s)));
  CHECK((pack<float, 2>(wg, d, f, ws + l.wg, ldd, (long long)f * ldd, true, s)));
  CHECK((pack<float, 2>(wu, d, f, ws + l.wu, ldd, (long long)f * ldd, true, s)));
  CHECK((pack<float, 2>(wd, f, d, ws + l.wd, ldf, (long long)d * ldf, true, s)));
  CUtensorMap a, b0, b1;
  CHECK(encode3(&a, false, ws + l.x, d, m, 2, ldd, 32, BM));
  CHECK(encode3(&b0, false, ws + l.wg, d, f, 2, ldd, 32, Gemm<true, true>::BN));
  CHECK(encode3(&b1, false, ws + l.wu, d, f, 2, ldd, 32, Gemm<true, true>::BN));
  void* h = ws + l.h;
  CHECK((run_gemm<true, true>(a, b0, b1, h, m, (int)l.fp, (int)l.fp, (d + 31) / 32, s)));
  CHECK(encode3(&a, false, h, l.fp, m, 2, l.fp, 32, BM));
  CHECK(encode3(&b0, false, ws + l.wd, f, d, 2, ldf, 32, Gemm<true, false>::BN));
  return run_gemm<true, false>(a, b0, b0, out, m, d, d, (int)(l.fp / 32), s);
}

}  // namespace

// Bytes of scratch a call at (m, d, f) needs (h's pieces, and the packed
// operands): the wrapper allocates them and passes them as ws.
extern "C" long long swiglu_workspace_bytes(int bf16, int m, int d, int f) {
  return layout(bf16 != 0, m, d, f).total;
}

// x: (m, d); wg, wu: (d, f); wd: (f, d), all float32 (bf16 = 0) or bfloat16
// (bf16 = 1), contiguous and 16-byte aligned; ws: swiglu_workspace_bytes of
// device scratch, 256-byte aligned; out: (m, d) in x's dtype.
extern "C" int swiglu_fwd(int bf16, const void* x, const void* wg, const void* wu,
                          const void* wd, void* ws, void* out, int m, int d, int f,
                          void* stream) {
  if (m <= 0 || d <= 0) return 0;
  if (f <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  char* w = static_cast<char*>(ws);
  return bf16 ? launch_bf16(x, wg, wu, wd, w, out, m, d, f, s)
              : launch_tf32(x, wg, wu, wd, w, out, m, d, f, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
