// RWKV-6 WKV recurrence, backward. Per (batch b, head h), the forward (csrc/
// wkv6.cu) runs, with S_t the (hd x hd) state before step t:
//
//   y_t[j]    = sum_i r_t[i] (S_t[i][j] + u[i] k_t[i] v_t[j])
//   S_t+1[i][j] = w_t[i] S_t[i][j] + k_t[i] v_t[j]
//
// Given dy (the gradient of y) and ds_last (of the final state, or zeros),
// with G_t = dL/dS_t+1 (G_S-1 = ds_last):
//
//   dr_t[i] = sum_j S_t[i][j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j]  + u[i] r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i][j] k_t[i]  + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   dw_t[i] = sum_j G_t[i][j] S_t[i][j]
//   du[i]   = sum over b and t of r_t[i] k_t[i] (v_t . dy_t)
//   G_t-1[i][j] = w_t[i] G_t[i][j] + r_t[i] dy_t[j]
//
// and ds0 = G_-1. The written-out plain version is ref.wkv6_bwd_ref;
// autograd of ref.wkv6_ref is the other.
//
// Replaces no TPU kernel: the reference trains RWKV-6 through jax.grad of
// its plain scan (src/repro/models/rwkv6.py:91, wkv_scan), and JAX cannot
// differentiate the Pallas kernel wkv6_pallas. Added so that the card trains
// RWKV-6 through the forward kernel (kernels/wkv6.py's WKV6 Function).
//
// Design: the time axis split at the forward's 64-step chunks.
//  * G's chain is the forward recurrence run backwards: with t' = S - 1 - t,
//    G_t-1 = diag(w_t) G_t + r_t dy_t^T is S'_t'+1 = diag(w'_t') S'_t' +
//    k'_t' v'_t'^T for k' = r, v' = dy, w' = w (each reversed), and dv_t is
//    y'_t' for r' = k and the same u. So dv, ds0 (its final state, from
//    s0' = ds_last) and G at every chunk boundary (its chunk states) are one
//    run of the forward's chunk kernel (wkv6_chunk.cuh) on reversed time:
//    every chunk product on the tensor cores (mma.sync m16n8k8 as 3xTF32,
//    dy split in two pieces as a float32 v is), with the forward's decay
//    tables. Reversed, the ragged chunk is the first one, its head padded
//    (r = k = v = 0, w = 1 pass the state unchanged), so its boundaries
//    fall where the forward's do.
//  * The chunk states S_c: the forward writes them under a gradient
//    (WKV6.forward), else a state-only run of the same chunk kernel here
//    (the same bits: the state update's arithmetic is the same code).
//  * Then every chunk is independent, and what is left is row-local: dr,
//    dk and dw sum over j only. rows_kernel: one CTA a (b, h, chunk, RB =
//    32 rows) walks its 64 steps on the CUDA cores. A lane owns two
//    neighbouring rows and CJ = 8 columns (two float4s, at 4 c and 4 c + 4
//    NG for lane c of the NG = hd / 8 lanes of a row pair, so a step's reads
//    of a row fall in distinct banks, and each v and dy it loads serves both
//    rows). From S_c it sweeps forward to the chunk's half and on, keeping
//    the state every 8 steps of the second half (each lane its own, in
//    shared memory); for each 4-step sub-chunk from the last it recomputes
//    its 4 states into registers (advancing 4 steps first from the kept
//    state for the upper sub-chunk of an 8-step block) and walks them down
//    from G at the chunk's end (ds_last, or the reversed run's boundary
//    state); before the first half it sweeps again from S_c for that half's
//    kept states. A sub-chunk's 4 steps x 6 row sums (dr, dk, dw of two
//    rows) go through one transposed xor butterfly over the NG lanes after
//    its walk: 28 shuffles a lane at NG 8, as a step at a time takes, but
//    one latency chain a sub-chunk instead of one a step.
//  * Loads overlapped: the chunk's inputs come by cp.async in two groups of
//    32 steps; the second is in flight while the first half is swept.
//  * du: each CTA's rows' sums over the chunk's steps go to (b, chunk, h,
//    hd) partials, which a last launch sums in order. No atomics anywhere:
//    every sum has one order, and the bits repeat from call to call.
//  * dw takes no quotient: the identity w dw = (reverse cumsum of r dr - k
//    dk) that GLA-style kernels use would divide by w, and w is exactly 0
//    where exp(-exp(x)) underflows; dw is the walk's own sum of G S.
//  * The decays are IEEE: no exponential is taken, every decay is a product
//    of the w's it spans in float32 multiplies (__fmul_rn, __fmaf_rn), so a
//    w of 0 gives 0, a w within 1e-7 of 1 is a factor like any other, and
//    nothing is approximated where the plain versions round exactly.
//
// Bound. At the RWKV-6 7B training shape (B 4, S 2048, H 64, hd 64) the
// least work is 6 FP32 FMAs per (b, h, t, i, j): the state's recompute, G's
// update, and the four sums (dr, dk, dv, dw); 2.58e10 FLOPs, 0.385 ms at the
// CUDA cores' 67 TFLOP/s. The least bytes: r, k, v in their dtype, w and dy
// in float32 read once, dr, dk, dv in their dtype and dw written once, ~0.47
// GB in bf16 (0.14 ms at 3.35 TB/s). So operations bound it. Executed: the
// reversed chunk run is the forward's work on tensor cores (3.33e10 tensor
// FLOPs at bf16, 0.067 ms at 495 TFLOP/s; 4.0e10 with float32 dy's third
// piece), and the row walk ~10 FP32 operations per (b, h, t, i, j) where
// the bound counts 12 FLOPs of 6 FMAs for all four sums: the sweeps
// (2 x 80/64: to the half and on, and the first half again), the
// recompute (2 x 80/64, with the upper sub-chunks' 4-step advance) and the
// walk (5: dr, dk, dw and G's update), plus 7 shuffles a lane and step for
// the row sums. Bytes: the chunk states (written by the forward) and G's
// boundary states (written by the reversed run) are 134 MB each at the
// training shape, each read once; the first version moved 1.07 GB of
// checkpoints each way.
//
// Budget (hd 64): rows_kernel 128 threads (16 row pairs of 8 lanes), ~160
// registers a thread (the sub-chunk's 4 x 16 states, G, the 32 row sums;
// no spill), shared memory 64 steps of v and dy as float32 (16 KB each),
// bf16 v as loaded (8 KB), r, k (in their dtype) and w of the 32 rows (8
// KB in float32), 5 states of every lane (40 KB: 3 kept in a half, the
// chunk's start and half) and v . dy a step: ~96 KB a CTA, two an SM. The
// reversed chunk run is the forward's (111.6 KB, 128 registers, two CTAs
// an SM).
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "wkv6_chunk.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>  // wait until at most PENDING groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

namespace rows {

constexpr int CHUNK = chunk::CHUNK;  // steps a chunk: the forward's
constexpr int CJ = 8;                // columns a lane
constexpr int RL = 2;                // rows a lane (neighbours)
constexpr int TB = 4;                // steps a sub-chunk, its states in registers
constexpr int KB = 8;                // steps between kept states
constexpr int NKB = CHUNK / KB;      // kept-state blocks a chunk
constexpr int GROUP = CHUNK / 2;     // steps a staging group, and a half of the walk
constexpr int KEEP = GROUP / KB - 1;  // states kept a half
constexpr int SLOTS = KEEP + 2;       // and the chunk's start and half states
constexpr int NV = 3 * RL;            // a lane's row sums a step: dr, dk, dw of each row
static_assert(NV <= 8, "a step's sums fit its 8 slots");

template <typename T, int HD>
struct Geo {
  static constexpr int RB = 32;                 // rows a CTA
  static constexpr int NG = HD / CJ;            // lanes a row pair
  static constexpr int THREADS = RB / RL * NG;
  static constexpr int NWARPS = THREADS / 32;
  static constexpr int NRB = HD / RB;           // CTAs a (b, h, chunk)
  static constexpr int TW = (int)sizeof(T) / 2;  // T's size in bf16s
  static constexpr int E = RL * CJ;             // a lane's state elements
  // shared memory, in floats; every part 16-byte aligned
  static constexpr int VF = 0;                           // [CHUNK][HD] v, float32
  static constexpr int DY = VF + CHUNK * HD;             // [CHUNK][HD] dy
  static constexpr int W = DY + CHUNK * HD;              // [CHUNK][RB] w of the rows
  static constexpr int R = W + CHUNK * RB;               // [CHUNK][RB] r as T
  static constexpr int K = R + CHUNK * RB * TW / 2;      // [CHUNK][RB] k as T
  static constexpr int VR = K + CHUNK * RB * TW / 2;     // [CHUNK][HD] bf16 v as loaded
  static constexpr int CK = VR + (TW == 1 ? CHUNK * HD / 2 : 0);  // [SLOTS][E/4][THREADS] float4
  static constexpr int VDY = CK + SLOTS * E * THREADS;            // [CHUNK] v . dy
  static constexpr int FLOATS = VDY + CHUNK;
  static_assert(HD % RB == 0 && NG >= 4 && THREADS % 32 == 0, "geometry");
};

// The transposed butterfly of NS values over lanes: at mask MSK a lane
// keeps the half of its CNT values its bit selects and adds its partner's
// sums of them; STAGES stages leave CNT >> STAGES values a lane.
template <int CNT, int MSK, int STAGES, int NS>
__device__ __forceinline__ void butterfly(float (&sv)[NS], int cg) {
  if constexpr (STAGES > 0) {
    const bool upper = (cg & MSK) != 0;
#pragma unroll
    for (int p = 0; p < CNT / 2; ++p) {
      const float send = upper ? sv[p] : sv[p + CNT / 2];
      const float keep = upper ? sv[p + CNT / 2] : sv[p];
      sv[p] = keep + __shfl_xor_sync(FULL, send, MSK);
    }
    butterfly<CNT / 2, MSK * 2, STAGES - 1, NS>(sv, cg);
  }
}

// a pair of neighbouring rows' values of a step, as float32
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The (b, h, chunk, row block) CTA: dr, dk, dw of its RB rows over the
// chunk's steps, and its rows' du partials. The state before the chunk is
// s0's (null: zeros) for the first chunk and the chunk states' (b, h,
// chunks - 1, hd, hd) otherwise; G at its end is ds_last's (null: zeros)
// for the last chunk and gstates' (the reversed run's boundary states,
// indexed alike) otherwise.
template <typename T, int HD>
__global__ void __launch_bounds__(Geo<T, HD>::THREADS, Geo<T, HD>::THREADS <= 128 ? 2 : 1)
rows_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ dy, const float* __restrict__ s0,
            const float* __restrict__ ds_last, const float* __restrict__ states,
            const float* __restrict__ gstates, T* __restrict__ dr, T* __restrict__ dk,
            float* __restrict__ dw, float* __restrict__ du_part, int seq, int h) {
  using G = Geo<T, HD>;
  constexpr int RB = G::RB, NG = G::NG, THREADS = G::THREADS, E = G::E;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const s_v = sm + G::VF;
  float* const s_dy = sm + G::DY;
  float* const s_w = sm + G::W;
  T* const s_r = reinterpret_cast<T*>(sm + G::R);
  T* const s_k = reinterpret_cast<T*>(sm + G::K);
  T* const s_vraw = reinterpret_cast<T*>(sm + G::VR);
  float4* const s_ck = reinterpret_cast<float4*>(sm + G::CK);
  float* const s_vdy = sm + G::VDY;

  const int nc = (seq + CHUNK - 1) / CHUNK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pr_ = tid / NG, cg = tid % NG;
  const int row = RL * pr_;  // this lane's first row in the CTA (and row + 1)
  const int rb = blockIdx.x % G::NRB;
  const long long task = blockIdx.x / G::NRB;  // (b h) nc + chunk
  const int c = (int)(task % nc);
  const long long bh = task / nc;
  const int head = (int)(bh % h);
  const long long b = bh / h;
  const int i0 = rb * RB, i = i0 + row;
  const int t0 = c * CHUNK, len = min(CHUNK, seq - t0);
  const long long step = (long long)h * HD;                              // elements between steps
  const long long base = (b * seq + t0) * step + (long long)head * HD;   // (b, t0, head, 0)
  // this lane's columns: q-th float4 at 4 cg + 4 NG q
  auto col = [&](int q) { return 4 * cg + 4 * NG * q; };

  // -- staging: steps [s_lo, s_hi) of the chunk, one commit group ----------
  constexpr bool BF = sizeof(T) == 2;
  constexpr int C_DY = HD / 4, C_W = RB / 4, C_RK = RB * (int)sizeof(T) / 16,
                C_V = HD * (int)sizeof(T) / 16;
  constexpr int PER_STEP = C_DY + C_W + 2 * C_RK + C_V;  // 16-byte copies a step
  auto stage = [&](int s_lo, int s_hi) {
    for (int e = tid; e < (s_hi - s_lo) * PER_STEP; e += THREADS) {
      const int t = s_lo + e / PER_STEP;
      int q = e % PER_STEP;
      const bool ok = t < len;
      const long long at = base + (long long)(ok ? t : 0) * step;
      if (q < C_DY) {
        cp_async16(s_dy + t * HD + 4 * q, dy + at + 4 * q, ok);
        continue;
      }
      q -= C_DY;
      if (q < C_W) {
        if (ok) cp_async16(s_w + t * RB + 4 * q, w + at + i0 + 4 * q, true);
        else *reinterpret_cast<float4*>(s_w + t * RB + 4 * q) = make_float4(1.f, 1.f, 1.f, 1.f);
        continue;
      }
      q -= C_W;
      constexpr int EC = 16 / (int)sizeof(T);  // elements a copy
      if (q < 2 * C_RK) {
        const bool is_k = q >= C_RK;
        q -= is_k ? C_RK : 0;
        cp_async16((is_k ? s_k : s_r) + t * RB + EC * q, (is_k ? k : r) + at + i0 + EC * q, ok);
        continue;
      }
      q -= 2 * C_RK;
      if constexpr (BF) cp_async16(s_vraw + t * HD + EC * q, v + at + EC * q, ok);
      else cp_async16(s_v + t * HD + EC * q, v + at + EC * q, ok);
    }
    cp_async_commit();
  };
  // bf16 v of steps [s_lo, s_hi) widened into s_v (zeros past len: the
  // copies filled them)
  auto widen_v = [&](int s_lo, int s_hi) {
    if constexpr (BF) {
      for (int e = tid; e < (s_hi - s_lo) * HD / 8; e += THREADS) {
        const int t = s_lo + e / (HD / 8), j = 8 * (e % (HD / 8));
        const uint4 q = *reinterpret_cast<const uint4*>(s_vraw + t * HD + j);
        const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
        float x[8];
#pragma unroll
        for (int p = 0; p < 4; ++p) {  // bf16 pairs, the first in the low half
          x[2 * p] = __uint_as_float(wd[p] << 16);
          x[2 * p + 1] = __uint_as_float(wd[p] & 0xFFFF0000u);
        }
        *reinterpret_cast<float4*>(s_v + t * HD + j) = make_float4(x[0], x[1], x[2], x[3]);
        *reinterpret_cast<float4*>(s_v + t * HD + j + 4) = make_float4(x[4], x[5], x[6], x[7]);
      }
    }
  };
  stage(0, GROUP);
  stage(GROUP, CHUNK);

  // this lane's part of its two rows of an (hd, hd) state p (null: zeros):
  // x[CJ a + e] is row i + a, column col(e / 4) + e % 4
  auto load_rows = [&](const float* p, float (&x)[E]) {
#pragma unroll
    for (int a = 0; a < RL; ++a)
#pragma unroll
      for (int q = 0; q < CJ / 4; ++q) {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p != nullptr)
          f = *reinterpret_cast<const float4*>(p + (long long)(i + a) * HD + col(q));
        x[CJ * a + 4 * q] = f.x; x[CJ * a + 4 * q + 1] = f.y;
        x[CJ * a + 4 * q + 2] = f.z; x[CJ * a + 4 * q + 3] = f.w;
      }
  };
  const long long hd2 = (long long)HD * HD;
  float cur[E], g[E];
  load_rows(c == 0 ? (s0 == nullptr ? nullptr : s0 + bh * hd2)
                   : states + (bh * (nc - 1) + c - 1) * hd2, cur);
  load_rows(c == nc - 1 ? (ds_last == nullptr ? nullptr : ds_last + bh * hd2)
                        : gstates + (bh * (nc - 1) + c) * hd2, g);
  const float2 uu = *reinterpret_cast<const float2*>(u + head * HD + i);
  // this lane's state part in slot `slot` of s_ck (each lane its own: no
  // barrier): 0 .. KEEP - 1 the kept states of a half, KEEP the chunk's
  // start, KEEP + 1 its half
  auto put_slot = [&](int slot) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      s_ck[(slot * (E / 4) + q) * THREADS + tid] =
          make_float4(cur[4 * q], cur[4 * q + 1], cur[4 * q + 2], cur[4 * q + 3]);
  };
  auto get_slot = [&](int slot) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 f = s_ck[(slot * (E / 4) + q) * THREADS + tid];
      cur[4 * q] = f.x; cur[4 * q + 1] = f.y; cur[4 * q + 2] = f.z; cur[4 * q + 3] = f.w;
    }
  };
  auto vrow = [&](const float* p, int t, float (&x)[CJ]) {  // this lane's columns of a step
#pragma unroll
    for (int q = 0; q < CJ / 4; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(p + t * HD + col(q));
      x[4 * q] = f.x; x[4 * q + 1] = f.y; x[4 * q + 2] = f.z; x[4 * q + 3] = f.w;
    }
  };
  // one forward step of this lane's state part: x <- w_t x + k_t v_t
  auto advance = [&](float (&x)[E], int t) {
    const float2 wt = pair(s_w + t * RB + row), kt = pair(s_k + t * RB + row);
    float vv[CJ];
    vrow(s_v, t, vv);
#pragma unroll
    for (int e = 0; e < CJ; ++e) {
      x[e] = __fmaf_rn(wt.x, x[e], __fmul_rn(kt.x, vv[e]));
      x[CJ + e] = __fmaf_rn(wt.y, x[CJ + e], __fmul_rn(kt.y, vv[e]));
    }
  };
  // cur through kept-state blocks [m_lo, m_hi); with keep, the state after
  // each into slots 0, 1, ...
  auto sweep = [&](int m_lo, int m_hi, bool keep) {
    for (int m = m_lo; m < m_hi; ++m) {
#pragma unroll
      for (int q = 0; q < KB; ++q) advance(cur, m * KB + q);
      if (keep) put_slot(m - m_lo);
    }
  };
  put_slot(KEEP);

  cp_async_wait<1>();  // the first group
  __syncthreads();
  widen_v(0, GROUP);
  if (BF) __syncthreads();
  sweep(0, NKB / 2, false);
  put_slot(KEEP + 1);
  cp_async_wait<0>();  // the second group
  __syncthreads();
  widen_v(GROUP, CHUNK);
  if (BF) __syncthreads();
  // v_t . dy_t, a warp a step
  for (int t = warp; t < CHUNK; t += G::NWARPS) {
    float a = 0.f;
    for (int j = lane; j < HD; j += 32) a = __fmaf_rn(s_v[t * HD + j], s_dy[t * HD + j], a);
#pragma unroll
    for (int o = 16; o >= 1; o /= 2) a += __shfl_xor_sync(FULL, a, o);
    if (lane == 0) s_vdy[t] = a;
  }
  sweep(NKB / 2, NKB - 1, true);
  __syncthreads();  // v . dy is written

  // The walk: kept-state blocks from the last, and in each its two
  // sub-chunks from the last: the upper one's states are recomputed after
  // advancing from the block's kept state through the lower one; the first
  // half's kept states are swept again from the chunk's start after the
  // second half (shared memory for 3 kept states a lane, not 7).
  float du_acc[RL] = {0.f, 0.f};
  const long long hhd = (long long)h * HD;
  // A sub-chunk's row sums, 8 a step (dr, dk, dw of each row, 2 unused),
  // go through one transposed butterfly after its TB steps; then a lane
  // holds sums idx0 .. idx0 + CNT - 1 of the TB x 8 (step, kind)
  constexpr int NS = 8 * TB;
  constexpr int STAGES_T = NG < 8 ? 2 : 3;  // NG >= 4
  constexpr int CNT = NS >> STAGES_T;
  const int idx0 = ((cg & 1) ? NS / 2 : 0) + ((cg & 2) ? NS / 4 : 0) +
                   (STAGES_T > 2 && (cg & 4) ? NS / 8 : 0);
  for (int m = NKB - 1; m >= 0; --m) {
    const int mh = m % (NKB / 2);  // the block in its half
    if (m == NKB / 2 - 1) {
      get_slot(KEEP);
      sweep(0, NKB / 2 - 1, true);
    }
    for (int sub = KB / TB - 1; sub >= 0; --sub) {
      get_slot(mh > 0 ? mh - 1 : (m == 0 ? KEEP : KEEP + 1));
      const int s0_ = m * KB + sub * TB;  // the sub-chunk's first step
      for (int t = m * KB; t < s0_; ++t) advance(cur, t);
      float st[TB][E];  // S_t of the sub-chunk's steps
#pragma unroll
      for (int q = 0; q < TB; ++q) {
#pragma unroll
        for (int e = 0; e < E; ++e) st[q][e] = cur[e];
        if (q + 1 < TB) advance(cur, s0_ + q);
      }
      float sv[NS];  // the sub-chunk's row sums: step q's at 8 q .. 8 q + 5
#pragma unroll
      for (int p = 0; p < NS; ++p) sv[p] = 0.f;
#pragma unroll
      for (int q = TB - 1; q >= 0; --q) {
        const int t = s0_ + q;
        const float2 wt = pair(s_w + t * RB + row), rt = pair(s_r + t * RB + row);
        float vv[CJ], dd[CJ];
        vrow(s_v, t, vv);
        vrow(s_dy, t, dd);
#pragma unroll
        for (int a = 0; a < RL; ++a) {
          const float wa = a ? wt.y : wt.x, ra = a ? rt.y : rt.x;
          float* s = sv + 8 * q + 3 * a;
#pragma unroll
          for (int e = 0; e < CJ; ++e) {
            float& ge = g[CJ * a + e];
            const float se = st[q][CJ * a + e];
            s[0] = __fmaf_rn(se, dd[e], s[0]);
            s[1] = __fmaf_rn(ge, vv[e], s[1]);
            s[2] = __fmaf_rn(ge, se, s[2]);
            ge = __fmaf_rn(wa, ge, __fmul_rn(ra, dd[e]));
          }
        }
      }
      // the rows' sums over the NG lanes, transposed: at each mask a lane
      // keeps half of its values and sends half, then the rest in full
      butterfly<NS, 1, STAGES_T, NS>(sv, cg);
#pragma unroll
      for (int msk = 8; msk < NG; msk *= 2)
#pragma unroll
        for (int p = 0; p < CNT; ++p) sv[p] += __shfl_xor_sync(FULL, sv[p], msk);
      if (cg < 8) {
#pragma unroll
        for (int p = 0; p < CNT; ++p) {
          const int idx = idx0 + p, q = idx / 8, a = idx % 8 / 3, kind = idx % 8 % 3;
          const int t = s0_ + q;
          if (idx % 8 < NV && t < len) {
            const long long off = base + (long long)t * step + i + a;
            const float vdy = s_vdy[t];
            const float ua = a ? uu.y : uu.x;
            const float ra = to_float(s_r[t * RB + row + a]), ka = to_float(s_k[t * RB + row + a]);
            if (kind == 0) put(dr + off, __fmaf_rn(ua * ka, vdy, sv[p]));
            else if (kind == 1) put(dk + off, __fmaf_rn(ua * ra, vdy, sv[p]));
            else dw[off] = sv[p];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < TB; ++q) {  // 0 past S (r = 0 there)
        const int t = s0_ + q;
        const float2 rt = pair(s_r + t * RB + row), kt = pair(s_k + t * RB + row);
        du_acc[0] = __fmaf_rn(rt.x * kt.x, s_vdy[t], du_acc[0]);
        du_acc[1] = __fmaf_rn(rt.y * kt.y, s_vdy[t], du_acc[1]);
      }
    }
  }
  if (cg == 0)
    *reinterpret_cast<float2*>(du_part + (b * nc + c) * hhd + (long long)head * HD + i) =
        make_float2(du_acc[0], du_acc[1]);
}

}  // namespace rows

// du[e] = sum over (b, chunk), in order, of du_part[b][chunk][e], e over (h, hd)
__global__ void du_sum_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                              long long parts, int hhd) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hhd) return;
  float acc = 0.f;
  for (long long q = 0; q < parts; ++q) acc += du_part[q * hhd + e];
  du[e] = acc;
}

struct Scratch {
  long long gstates, states, du;  // floats of each part
};

Scratch scratch_floats(int b, int seq, int h, int hd, bool states_given) {
  const long long nc = (seq + rows::CHUNK - 1) / rows::CHUNK;
  const long long bound = (long long)b * h * (nc > 0 ? nc - 1 : 0) * hd * hd;
  return {bound, states_given ? 0 : bound, (long long)b * nc * h * hd};
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, const void* dy, const void* ds_last, const void* states_in,
           void* dr, void* dk, void* dv, void* dw, void* du, void* ds0, void* scratch, int b,
           int seq, int h, cudaStream_t stream, int* launched) {
  using G = rows::Geo<T, HD>;
  const int nc = (seq + rows::CHUNK - 1) / rows::CHUNK;
  const Scratch sc = scratch_floats(b, seq, h, HD, states_in != nullptr);
  float* gstates = static_cast<float*>(scratch);
  float* states = states_in != nullptr ? const_cast<float*>(static_cast<const float*>(states_in))
                                       : gstates + sc.gstates;
  float* du_part = gstates + sc.gstates + sc.states;
  int err;
  // the chunk states, where the forward did not keep them
  if (states_in == nullptr && nc > 1) {
    err = chunk::launch<T, T, float, HD, false, false, true>(r, k, v, w, u, s0, nullptr,
                                                             nullptr, states, b, seq, h, stream);
    if (err) return err;
    ++*launched;
  }
  // dv, ds0 and G at the chunk boundaries: the forward's chunk kernel on
  // reversed time, r' = k, k' = r, v' = dy, s0' = ds_last
  err = chunk::launch<T, float, T, HD, true, true, true>(k, r, dy, w, u, ds_last, dv, ds0,
                                                         nc > 1 ? gstates : nullptr, b, seq, h,
                                                         stream);
  if (err) return err;
  ++*launched;
  if (nc > 0) {
    const size_t bytes = sizeof(float) * G::FLOATS;
    cudaError_t e = cudaFuncSetAttribute(rows::rows_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    rows::rows_kernel<T, HD><<<(unsigned)((long long)b * h * nc * G::NRB), G::THREADS, bytes,
                               stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<const float*>(dy), static_cast<const float*>(s0),
        static_cast<const float*>(ds_last), states, gstates, static_cast<T*>(dr),
        static_cast<T*>(dk), static_cast<float*>(dw), du_part, seq, h);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launched;
  }
  const int hhd = h * HD;
  du_sum_kernel<<<(hhd + 255) / 256, 256, 0, stream>>>(du_part, static_cast<float*>(du),
                                                       (long long)b * nc, hhd);
  ++*launched;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s0, const void* dy, const void* ds_last, const void* states,
             void* dr, void* dk, void* dv, void* dw, void* du, void* ds0, void* scratch, int b,
             int seq, int h, cudaStream_t stream, int* launched) {
  switch (hd) {
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, dy, ds_last, states, dr, dk, dv, dw, du, ds0,
                           scratch, b, seq, h, stream, launched);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, dy, ds_last, states, dr, dk, dv, dw, du, ds0,
                           scratch, b, seq, h, stream, launched);
    case 128:
      return launch<T, 128>(r, k, v, w, u, s0, dy, ds_last, states, dr, dk, dv, dw, du, ds0,
                            scratch, b, seq, h, stream, launched);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch the backward of (b, seq, h, hd) needs: G's boundary
// states, the chunk states unless the forward kept them (states_given = 0),
// and the (b, chunk, h, hd) du partials; -1 for a head dim it does not take.
extern "C" long long wkv6_bwd_scratch(int b, int seq, int h, int hd, int states_given) {
  if (hd != 32 && hd != 64 && hd != 128) return -1;
  const Scratch sc = scratch_floats(b, seq, h, hd, states_given != 0);
  return sc.gstates + sc.states + sc.du;
}

// The WKV-6 backward: three or four launches (the chunk states when
// `states` is null and there is more than one 64-step chunk, the reversed
// chunk run, the row walk, du's sum; two with no step), counted into
// *launched (when not null). r, k, v: (b, seq, h, hd), float32
// (bf16 = 0) or bfloat16 (bf16 = 1); w, dy: (b, seq, h, hd) float32; u: (h,
// hd) float32; s0, ds_last: (b, h, hd, hd) float32 or null (zeros); states:
// the forward's chunk states (b, h, ceil(seq / 64) - 1, hd, hd) float32
// (wkv6_fwd's `states`) or null. Writes dr, dk, dv (r's dtype), dw
// (float32) of r's shape, du (h, hd) float32 and, when ds0 is not null, ds0
// (b, h, hd, hd) float32. scratch: wkv6_bwd_scratch(b, seq, h, hd, states
// != null) floats. All contiguous and 16-byte aligned.
extern "C" int wkv6_bwd(int bf16, const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, const void* dy, const void* ds_last,
                        const void* states, void* dr, void* dk, void* dv, void* dw, void* du,
                        void* ds0, void* scratch, int b, int seq, int h, int hd, void* stream,
                        int* launched) {
  int count = 0;
  if (launched == nullptr) launched = &count;
  *launched = 0;
  if (b <= 0 || h <= 0) return 0;
  if (seq < 0 || (long long)b * h * 4 > 0x7fffffffLL ||
      (long long)b * h * ((seq + rows::CHUNK - 1) / rows::CHUNK) * 4 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(hd, r, k, v, w, u, s0, dy, ds_last, states, dr, dk, dv,
                                        dw, du, ds0, scratch, b, seq, h, s, launched)
              : dispatch<float>(hd, r, k, v, w, u, s0, dy, ds_last, states, dr, dk, dv, dw, du,
                                ds0, scratch, b, seq, h, s, launched);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
