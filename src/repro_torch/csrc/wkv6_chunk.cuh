// The WKV-6 chunk kernel, shared by csrc/wkv6.cu (the forward, whose
// header comment gives its design, bound and precision) and csrc/wkv6_bwd.cu
// (the backward runs it on reversed time for dv, ds0 and the state's
// gradient at every chunk boundary, and alone for the chunk states when the
// forward did not keep them).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The chunk kernel (prefill lengths): chunks of CHUNK rows on the tensor cores
// ---------------------------------------------------------------------------
namespace chunk {

constexpr int CHUNK = 64;     // rows a chunk
constexpr int SUB = 16;       // rows a sub-chunk: mma's M
constexpr int NSUB = CHUNK / SUB;
constexpr int HALF = 8;       // rows a half sub-chunk
constexpr int NHALF = CHUNK / HALF;
constexpr int NT = 4;         // n-tiles of 8 columns a warp: 32 state columns
// The decay table, HD floats a row: per channel, with H_h the product of
// half h's 8 w's, F8[h] = H_0 ... H_(h-1), G8[h] = H_(h+1) ... H_7, H_h,
// P = W_1, W_1 W_2, W_2 (W_m = H_2m H_2m+1: the sub-chunk totals that lie
// between the sub-chunks of a block (i, j) = (0, 2), (0, 3), (1, 3)), and
// D = F8[8], the chunk's whole decay.
constexpr int T_F8 = 0, T_G8 = NHALF, T_H = 2 * NHALF, T_P = 3 * NHALF, T_D = T_P + 3;
constexpr int NTAB = T_D + 1;

// A CTA owns (b, h, NJ state columns): NJ = min(hd, 64). Warp w works on
// sub-chunk m = w % NSUB and columns 32 (w / NSUB) .. + 31. Shared memory in
// floats: r~, k^ and w are [CHUNK][RS] (RS = 4 mod 32, so a fragment's 32
// reads of [row g][col c] fall in 32 banks); A, the chunk's (t, s) matrix,
// takes w's place once the decays are scanned; V and the state's tf32
// pieces are [rows][VS] (VS = 8 mod 32, for reads of [row c][col g]); then
// the decay table and u.
template <int HD>
struct Shape {
  static constexpr int NJ = HD < 64 ? HD : 64;
  static constexpr int CW = NJ / 32;            // warps a sub-chunk
  static constexpr int NWARPS = NSUB * CW;
  static constexpr int THREADS = 32 * NWARPS;
  static constexpr int NCB = HD / NJ;           // CTAs a head
  static constexpr int MQ = HD >= 64 ? HD / 64 : 1;  // state row tiles a warp
  static constexpr int RS = HD + 4;
  static constexpr int AS = CHUNK + 4;
  static constexpr int VS = NJ + 8;
  static constexpr int R = 0;
  static constexpr int K = R + CHUNK * RS;
  static constexpr int W = K + CHUNK * RS;
  static constexpr int V = W + CHUNK * (RS > AS ? RS : AS);
  static constexpr int SHI = V + CHUNK * VS;
  static constexpr int SLO = SHI + HD * VS;
  static constexpr int TAB = SLO + HD * VS;
  static constexpr int U = TAB + NTAB * HD;
  static constexpr int FLOATS = U + HD;
};

// Round float32 to tf32 on the bits (to nearest, ties away from 0), as
// swiglu.cu does; x = hi + lo to ~2^-22 of x.
__device__ __forceinline__ float tf32_rn(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_rn(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_rn(x - h));
}

struct Frag {  // an A fragment (16 x 8) as tf32 pieces
  uint32_t hi[4], lo[4];
};

// d += a b, one m16n8k8 tf32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, one m16n8k8 tf32 product into fresh registers (C = 0)
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d += a b over one k-step of 8 as 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi
// (b_lo skipped where b is exact in tf32), the small terms first, summed by
// the tensor cores into a partial that starts from 0 (a chain of 24 terms),
// the partial added to d with float32 adds.
template <bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  float p[4];
  mma0(p, a.lo, bh0, bh1);
  if constexpr (!B_EXACT) mma(p, a.hi, bl0, bl1);
  mma(p, a.hi, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += p[e];
}

// The B fragment of V at k row k0 (+ 4) and column n: as it lies when V is
// exact in tf32 (bf16 inputs), else split.
template <bool EXACT>
__device__ __forceinline__ void v_frag(const float* vs, int at0, int at1, uint32_t& h0,
                                       uint32_t& h1, uint32_t& l0, uint32_t& l1) {
  if constexpr (EXACT) {
    h0 = __float_as_uint(vs[at0]);
    h1 = __float_as_uint(vs[at1]);
    l0 = l1 = 0;
  } else {
    split(vs[at0], h0, l0);
    split(vs[at1], h1, l1);
  }
}

// 16 bytes of a row as float32: 4 floats, or 8 bf16 values widened
__device__ __forceinline__ void widen(const uint4& q, float (&x)[4]) {
  x[0] = __uint_as_float(q.x); x[1] = __uint_as_float(q.y);
  x[2] = __uint_as_float(q.z); x[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void widen(const uint4& q, float (&x)[8]) {
  const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 pairs, the first in the low half
    x[2 * i] = __uint_as_float(wd[i] << 16);
    x[2 * i + 1] = __uint_as_float(wd[i] & 0xFFFF0000u);
  }
}

// One array's share of a chunk's staging: (CHUNK, N) elements of type T,
// row `row` at element offset at + row * rstep of src (rstep < 0 walks the
// sequence backwards), 16 bytes a load; rows outside [lo, hi) are `fill`
// and are not read (rows below lo only where HEAD: the reversed walk's
// padded head). Loads first (all of them, in raw registers), stores later,
// so the four arrays' loads are in flight together.
template <typename T, int N, int THREADS>
struct Stage {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = N / VEC;
  static constexpr int ITERS = CHUNK * PER_ROW / THREADS;
  static_assert(CHUNK * PER_ROW % THREADS == 0, "a stage is whole loads a thread");
  uint4 raw[ITERS];

  template <bool HEAD>
  __device__ __forceinline__ void load(const T* __restrict__ src, long long at, long long rstep,
                                       int lo, int hi, int tid) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * THREADS;
      const int row = idx / PER_ROW;
      if ((!HEAD || row >= lo) && row < hi)
        raw[it] = *reinterpret_cast<const uint4*>(src + (at + (long long)row * rstep) +
                                                   idx % PER_ROW * VEC);
    }
  }

  template <bool HEAD>
  __device__ __forceinline__ void store(float* dst, int ld, int lo, int hi, float fill,
                                        int tid) const {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * THREADS;
      const int row = idx / PER_ROW;
      float x[VEC];
      widen(raw[it], x);
      if ((HEAD && row < lo) || row >= hi) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = fill;
      }
      float* p = dst + row * ld + idx % PER_ROW * VEC;
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(p + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }
};

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src),
                     __shfl_sync(0xffffffffu, v.z, src), __shfl_sync(0xffffffffu, v.w, src));
}

// One half's 8 steps of four channels d .. d + 3, from row `row0`:
// x_t <- x_t p_t with p the running product of w over the half's rows
// walked before t (forward from its first row, or backward from its last);
// returns the product of the half's 8 w's. The 8 rows are read into
// registers first, then walked.
template <bool FORWARD, int RS>
__device__ __forceinline__ float4 walk(float* x, const float* w, int row0, int d) {
  float4 xs[HALF], wv[HALF];
#pragma unroll
  for (int t = 0; t < HALF; ++t) {
    xs[t] = *reinterpret_cast<const float4*>(x + (row0 + t) * RS + d);
    wv[t] = *reinterpret_cast<const float4*>(w + (row0 + t) * RS + d);
  }
  float4 p = make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const int t = FORWARD ? i : HALF - 1 - i;
    xs[t] = mul4(xs[t], p);
    p = mul4(p, wv[t]);
  }
#pragma unroll
  for (int t = 0; t < HALF; ++t) *reinterpret_cast<float4*>(x + (row0 + t) * RS + d) = xs[t];
  return p;
}

// Hint the lines of rows [lo, hi) of an (rows, N) slice of T, laid out as
// Stage reads it, into L2.
template <typename T, int N, int THREADS>
__device__ __forceinline__ void prefetch_rows(const T* src, long long at, long long rstep, int lo,
                                              int hi, int tid) {
  constexpr int LINES = (N * (int)sizeof(T) + 127) / 128;  // 128-byte lines a row
  for (int idx = lo * LINES + tid; idx < hi * LINES; idx += THREADS) {
    const char* p = reinterpret_cast<const char*>(src + (at + (long long)(idx / LINES) * rstep)) +
                    idx % LINES * 128;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The chunk kernel. T: r and k; TV: v; TY: y (the forward: T = TV, TY =
// float). REV walks the sequence from its end (step t of the walk is step
// S - 1 - t of the arrays; a ragged chunk is then the first one, its head
// padded) for the backward's reversed run. WITH_Y = false runs the state
// update alone (staging, the decays and the state's product): the states it
// writes are the same bits as the full kernel's. With KEEP, and `states`
// not null, the state after each chunk but the last is written there, (b,
// h, chunks - 1, hd, hd), indexed by the chunk it follows in the arrays'
// order (in reverse the chunk it precedes, less one); without KEEP (the
// serve's forward) the kernel holds no code for it. s_last may be null.
template <typename T, typename TV, typename TY, int HD, bool REV, bool WITH_Y, bool KEEP>
__global__ void __launch_bounds__(Shape<HD>::THREADS, HD <= 64 ? 2 : 1)
chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const TV* __restrict__ v,
             const float* __restrict__ w, const float* __restrict__ u,
             const float* s0,  // may alias s_last: not __restrict__
             TY* __restrict__ y, float* s_last, float* __restrict__ states, int seq, int h) {
  using L = Shape<HD>;
  constexpr int RS = L::RS, AS = L::AS, VS = L::VS, NJ = L::NJ, MQ = L::MQ;
  constexpr int THREADS = L::THREADS, NWARPS = L::NWARPS;
  constexpr bool V_EXACT = sizeof(TV) == 2;  // a bf16 value is exact in tf32
  constexpr int KS = HD / 8;                // k-steps over a head's channels
  constexpr int HPW = NHALF / NWARPS;       // triangles (halves) a warp
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const rs = sm + L::R;  // r, then r8
  float* const ks = sm + L::K;  // k, then k8
  float* const ws = sm + L::W;  // w
  float* const as = sm + L::W;  // A, once w is spent
  float* const vs = sm + L::V;
  float* const shi = sm + L::SHI;
  float* const slo = sm + L::SLO;
  float* const tab = sm + L::TAB;
  float* const us = sm + L::U;
  auto T_ = [&](int row) { return tab + row * HD; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // mma fragment coordinates
  const int m = warp % NSUB;              // this warp's sub-chunk
  const int o = m * SUB;
  const int jc = 32 * (warp / NSUB);      // this warp's first column in the CTA's NJ
  const int cb = blockIdx.x % L::NCB;
  const int bh = blockIdx.x / L::NCB;
  const int head = bh % h;
  const long long b = bh / h;
  const int j0 = cb * NJ;
  const long long step = (long long)h * HD;                        // elements between steps
  const long long base = b * seq * step + (long long)head * HD;   // (b, 0, head, 0)
  const long long sbase = (long long)bh * HD * HD + j0 + jc;       // (bh, 0, j0 + jc)

  for (int d = tid; d < HD; d += THREADS) us[d] = u[head * HD + d];

  // The state: this warp's rows i0 = 16 (m + 4 q) .. i0 + 15 of its 32
  // columns, in the accumulator layout: st[q][nt][e] holds row
  // i0 + g + 8 (e / 2), column jc + 8 nt + 2 c + e % 2.
  float st[MQ][NT][4];
#pragma unroll
  for (int q = 0; q < MQ; ++q) {
    const int i0 = 16 * (m + 4 * q);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float2 x = make_float2(0.f, 0.f);
        if (s0 != nullptr && i0 < HD)
          x = *reinterpret_cast<const float2*>(s0 + sbase + (long long)(i0 + g + 8 * hf) * HD +
                                               8 * nt + 2 * c);
        st[q][nt][2 * hf] = x.x;
        st[q][nt][2 * hf + 1] = x.y;
      }
  }
  // the state's tf32 pieces, the B operand of the cross term
  auto put_state = [&]() {
#pragma unroll
    for (int q = 0; q < MQ; ++q) {
      const int i0 = 16 * (m + 4 * q);
      if (i0 >= HD) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t h0, l0, h1, l1;
          split(st[q][nt][2 * hf], h0, l0);
          split(st[q][nt][2 * hf + 1], h1, l1);
          const int at = (i0 + g + 8 * hf) * VS + jc + 8 * nt + 2 * c;
          *reinterpret_cast<float2*>(shi + at) =
              make_float2(__uint_as_float(h0), __uint_as_float(h1));
          *reinterpret_cast<float2*>(slo + at) =
              make_float2(__uint_as_float(l0), __uint_as_float(l1));
        }
    }
  };
  // this warp's part of the state into an (hd, hd) state at dst (the
  // CTA's first column already added)
  auto write_state = [&](float* dst) {
#pragma unroll
    for (int q = 0; q < MQ; ++q) {
      const int i0 = 16 * (m + 4 * q);
      if (i0 >= HD) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(dst + (long long)(i0 + g + 8 * hf) * HD + 8 * nt + 2 * c) =
              make_float2(st[q][nt][2 * hf], st[q][nt][2 * hf + 1]);
    }
  };
  if constexpr (WITH_Y) put_state();

  const int nc = (seq + CHUNK - 1) / CHUNK;
  const int pad = nc * CHUNK - seq;  // rows of the ragged chunk past S
  const long long rstep = REV ? -step : step;
  for (int ci = 0; ci < nc; ++ci) {
    // rows [lo, hi) of the chunk are steps of the sequence; row t is at
    // element offset at + t rstep
    const int lo = REV && ci == 0 ? pad : 0;
    const int hi = REV || ci + 1 < nc ? CHUNK : CHUNK - pad;
    const long long at =
        base + (REV ? (long long)nc * CHUNK - 1 - (long long)ci * CHUNK : (long long)ci * CHUNK) *
                   step;
    // 1. the chunk into shared memory as float32; rows outside [lo, hi)
    //    are r = k = v = 0 and w = 1, which add and decay nothing
    {
      Stage<T, HD, THREADS> sr, sk;
      Stage<float, HD, THREADS> sw;
      Stage<TV, NJ, THREADS> sv;
      sr.template load<REV>(r, at, rstep, lo, hi, tid);
      sk.template load<REV>(k, at, rstep, lo, hi, tid);
      sw.template load<REV>(w, at, rstep, lo, hi, tid);
      sv.template load<REV>(v, at + j0, rstep, lo, hi, tid);
      sr.template store<REV>(rs, RS, lo, hi, 0.f, tid);
      sk.template store<REV>(ks, RS, lo, hi, 0.f, tid);
      sw.template store<REV>(ws, RS, lo, hi, 1.f, tid);
      sv.template store<REV>(vs, VS, lo, hi, 0.f, tid);
    }
    __syncthreads();
    // bf16 inputs: the next chunk's rows into L2 while this one is
    // computed (measured on the card: it helps bf16 inputs a little and
    // slows float32 ones, whose rows are twice as long)
    if (sizeof(T) == 2 && ci + 1 < nc) {
      const long long nx = at + CHUNK * rstep;
      const int nhi = REV || ci + 2 < nc ? CHUNK : CHUNK - pad;
      prefetch_rows<T, HD, THREADS>(r, nx, rstep, 0, nhi, tid);
      prefetch_rows<T, HD, THREADS>(k, nx, rstep, 0, nhi, tid);
      prefetch_rows<float, HD, THREADS>(w, nx, rstep, 0, nhi, tid);
      prefetch_rows<TV, NJ, THREADS>(v, nx + j0, rstep, 0, nhi, tid);
    }

    // 2. the triangles of the diagonal blocks on the CUDA cores: s < t within
    //    one half of 8 rows. Lane (s, q) of a half's warp takes column s over
    //    a quarter of the channels (float4 groups 4 (4 dq + q)), carrying
    //    z = k_s w_(s+1) ... w_(t-1) down the rows t > s of the half; the
    //    bonus sum_d (r_s u) k_s sits on the diagonal.
    const int ts = lane >> 2, tq = lane & 3;
    float dg[HPW][HALF], bonus[HPW];
#pragma unroll
    for (int p = 0; p < (WITH_Y ? HPW : 0); ++p) {
      const int ho = HALF * (warp + NWARPS * p);  // the half's first row
      bonus[p] = 0.f;
#pragma unroll
      for (int t = 0; t < HALF; ++t) dg[p][t] = 0.f;
#pragma unroll 2
      for (int dq = 0; dq < HD / 16; ++dq) {
        const int d = 4 * (4 * dq + tq);
        const float4 kz = *reinterpret_cast<const float4*>(ks + (ho + ts) * RS + d);
        const float4 rr = *reinterpret_cast<const float4*>(rs + (ho + ts) * RS + d);
        const float4 uu = *reinterpret_cast<const float4*>(us + d);
        bonus[p] += rr.x * uu.x * kz.x + rr.y * uu.y * kz.y + rr.z * uu.z * kz.z +
                    rr.w * uu.w * kz.w;
        float4 z = kz;
#pragma unroll
        for (int t = 1; t < HALF; ++t) {
          if (t > ts) {
            const float4 rt = *reinterpret_cast<const float4*>(rs + (ho + t) * RS + d);
            const float4 wt = *reinterpret_cast<const float4*>(ws + (ho + t) * RS + d);
            dg[p][t] += rt.x * z.x + rt.y * z.y + rt.z * z.z + rt.w * z.w;
            z.x *= wt.x;
            z.y *= wt.y;
            z.z *= wt.z;
            z.w *= wt.w;
          }
        }
      }
#pragma unroll
      for (int x = 1; x < 4; x *= 2) {
#pragma unroll
        for (int t = 0; t < HALF; ++t) dg[p][t] += __shfl_xor_sync(0xffffffffu, dg[p][t], x);
        bonus[p] += __shfl_xor_sync(0xffffffffu, bonus[p], x);
      }
    }
    __syncthreads();  // the scan rewrites r and k

    // 3. the decays. A warp takes 16 channels in one direction; lane
    //    (hh, q) walks half hh of channels d .. d + 3 (d = 16 group + 4 q):
    //    forward, r8_t = r_t w_a ... w_(t-1) from the half's first row a,
    //    with the half's total H_hh; backward, k8_s = k_s w_(s+1) ... w_e to
    //    its last row e. The forward warps then write the decay table from
    //    the totals, exchanged across the halves' lanes (scans of products
    //    over hh by shuffles). Each decay is a product of w's, so at most 1,
    //    exactly 0 across a w of 0, and never a NaN.
    for (int task = warp; task < HD / 8; task += NWARPS) {
      const bool fwd = task < HD / 16;
      const int hh = lane >> 2;
      const int d = 16 * (fwd ? task : task - HD / 16) + 4 * (lane & 3);
      if (fwd) {
        const float4 hv = walk<true, RS>(rs, ws, HALF * hh, d);
        const float4 one = make_float4(1.f, 1.f, 1.f, 1.f);
        float4 pre = hv, suf = hv;  // inclusive products over the halves <= hh, >= hh
#pragma unroll
        for (int off = 1; off < NHALF; off *= 2) {
          const float4 a = shfl4(pre, lane - 4 * off), z = shfl4(suf, lane + 4 * off);
          if (hh >= off) pre = mul4(a, pre);
          if (hh + off < NHALF) suf = mul4(suf, z);
        }
        // every lane takes part in every shuffle; the ends pick 1 after it
        const float4 down = shfl4(pre, lane - 4), up = shfl4(suf, lane + 4);
        const float4 f8 = hh > 0 ? down : one;
        const float4 g8 = hh + 1 < NHALF ? up : one;
        const float4 nxt = shfl4(hv, lane + 4);                // H_(hh+1)
        const float4 wm = mul4(hv, nxt);                       // W_m at even hh = 2 m
        const float4 w2 = shfl4(wm, lane + 8);                 // W_(m+1)
        *reinterpret_cast<float4*>(T_(T_F8 + hh) + d) = f8;
        *reinterpret_cast<float4*>(T_(T_G8 + hh) + d) = g8;
        *reinterpret_cast<float4*>(T_(T_H + hh) + d) = hv;
        if (hh == NHALF - 1) *reinterpret_cast<float4*>(T_(T_D) + d) = pre;
        if (hh == 2) {  // W_1 (block (0, 2)) and W_1 W_2 (block (0, 3))
          *reinterpret_cast<float4*>(T_(T_P) + d) = wm;
          *reinterpret_cast<float4*>(T_(T_P + 1) + d) = mul4(wm, w2);
        }
        if (hh == 4) *reinterpret_cast<float4*>(T_(T_P + 2) + d) = wm;  // W_2 (block (1, 3))
      } else {
        walk<false, RS>(ks, ws, HALF * hh, d);
      }
    }
    __syncthreads();

    // 4a. A's triangles (w's space is free now): A[ho + t][ho + s], and 0
    //     above the diagonal of each half
#pragma unroll
    for (int p = 0; p < (WITH_Y ? HPW : 0); ++p) {
      const int ho = HALF * (warp + NWARPS * p);
#pragma unroll
      for (int t = 0; t < HALF; ++t)
        if ((t & 3) == tq) as[(ho + t) * AS + ho + ts] = t == ts ? bonus[p] : dg[p][t];
    }

    // 4b. A's blocks on the tensor cores, eight units over the warps: units
    //     0-5 are the blocks between sub-chunks i < j (16 x 16), factored at
    //     the start of t's sub-chunk: A = r~_j (k~_i)^T with
    //     r~ = r8 (H_2j on the second half), k~ = k8 P_ij (H_2i+1 on the
    //     first half); units 6-7 are the squares of two sub-chunks' diagonal
    //     blocks (t in the second half, s in the first), factored at the
    //     halves' boundary: A = r8 k8^T, with 0 written to their mirror.
    for (int unit = warp; unit < (WITH_Y ? 8 : 0); unit += NWARPS) {
      if (unit < 6) {
        const int j = unit < 1 ? 1 : (unit < 3 ? 2 : 3);
        const int i = unit - j * (j - 1) / 2;
        const float* pij = j - i >= 2 ? T_(T_P + (i + j - 2)) : nullptr;  // (0,2) (0,3) (1,3)
        const float* hj = T_(T_H + 2 * j);
        const float* hi1 = T_(T_H + 2 * i + 1);
        const int tr = j * SUB, sr = i * SUB;
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int d = 8 * kk + c;
          const float p0 = pij ? pij[d] : 1.f, p1 = pij ? pij[d + 4] : 1.f;
          Frag a;
          split(rs[(tr + g) * RS + d], a.hi[0], a.lo[0]);
          split(__fmul_rn(rs[(tr + g + 8) * RS + d], hj[d]), a.hi[1], a.lo[1]);
          split(rs[(tr + g) * RS + d + 4], a.hi[2], a.lo[2]);
          split(__fmul_rn(rs[(tr + g + 8) * RS + d + 4], hj[d + 4]), a.hi[3], a.lo[3]);
#pragma unroll
          for (int nh = 0; nh < 2; ++nh) {
            const float f0 = nh ? p0 : __fmul_rn(hi1[d], p0);
            const float f1 = nh ? p1 : __fmul_rn(hi1[d + 4], p1);
            const int row = (sr + 8 * nh + g) * RS + d;
            uint32_t bh0, bl0, bh1, bl1;
            split(__fmul_rn(ks[row], f0), bh0, bl0);
            split(__fmul_rn(ks[row + 4], f1), bh1, bl1);
            mma3<false>(acc[nh], a, bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
          const int col = sr + 8 * nh + 2 * c;
          *reinterpret_cast<float2*>(as + (tr + g) * AS + col) =
              make_float2(acc[nh][0], acc[nh][1]);
          *reinterpret_cast<float2*>(as + (tr + g + 8) * AS + col) =
              make_float2(acc[nh][2], acc[nh][3]);
        }
      } else {
#pragma unroll
        for (int sq = 0; sq < 2; ++sq) {
          const int so = (2 * (unit - 6) + sq) * SUB;  // the sub-chunk's first row
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const int d = 8 * kk + c;
            Frag a;  // rows g: t = so + 8 + g; rows g + 8: none
            split(rs[(so + HALF + g) * RS + d], a.hi[0], a.lo[0]);
            split(rs[(so + HALF + g) * RS + d + 4], a.hi[2], a.lo[2]);
            a.hi[1] = a.lo[1] = a.hi[3] = a.lo[3] = 0u;
            uint32_t bh0, bl0, bh1, bl1;
            split(ks[(so + g) * RS + d], bh0, bl0);
            split(ks[(so + g) * RS + d + 4], bh1, bl1);
            mma3<false>(acc, a, bh0, bh1, bl0, bl1);
          }
          *reinterpret_cast<float2*>(as + (so + HALF + g) * AS + so + 2 * c) =
              make_float2(acc[0], acc[1]);
          *reinterpret_cast<float2*>(as + (so + g) * AS + so + HALF + 2 * c) =
              make_float2(0.f, 0.f);
        }
      }
    }

    // 4c. the cross term of this warp's rows and columns: (r8 F8[half]) S
    float ya[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[nt][e] = 0.f;
    if constexpr (WITH_Y) {
      const float* f0 = T_(T_F8 + 2 * m);
      const float* f1 = T_(T_F8 + 2 * m + 1);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int d = 8 * kk + c;
        Frag a;
        split(__fmul_rn(rs[(o + g) * RS + d], f0[d]), a.hi[0], a.lo[0]);
        split(__fmul_rn(rs[(o + g + 8) * RS + d], f1[d]), a.hi[1], a.lo[1]);
        split(__fmul_rn(rs[(o + g) * RS + d + 4], f0[d + 4]), a.hi[2], a.lo[2]);
        split(__fmul_rn(rs[(o + g + 8) * RS + d + 4], f1[d + 4]), a.hi[3], a.lo[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int b0 = d * VS + jc + 8 * nt + g, b1 = b0 + 4 * VS;
          mma3<false>(ya[nt], a, __float_as_uint(shi[b0]), __float_as_uint(shi[b1]),
                      __float_as_uint(slo[b0]), __float_as_uint(slo[b1]));
        }
      }
    }

    // 4d. the state update of this warp's rows and columns:
    //     S' = D S + K~^T V with K~_s = k8_s G8[half(s)], as A operand
    //     (row i, column s); k-step kk is half kk
#pragma unroll
    for (int q = 0; q < MQ; ++q) {
      const int i0 = 16 * (m + 4 * q);
      if (i0 >= HD) continue;
      const float d0 = T_(T_D)[i0 + g], d1 = T_(T_D)[i0 + g + 8];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        st[q][nt][0] = __fmul_rn(st[q][nt][0], d0);
        st[q][nt][1] = __fmul_rn(st[q][nt][1], d0);
        st[q][nt][2] = __fmul_rn(st[q][nt][2], d1);
        st[q][nt][3] = __fmul_rn(st[q][nt][3], d1);
      }
#pragma unroll
      for (int kk = 0; kk < CHUNK / 8; ++kk) {
        const float* e = T_(T_G8 + kk);
        const float e0 = e[i0 + g], e1 = e[i0 + g + 8];
        const int sa = (8 * kk + c) * RS + i0 + g, sb = sa + 4 * RS;
        Frag a;
        split(__fmul_rn(ks[sa], e0), a.hi[0], a.lo[0]);
        split(__fmul_rn(ks[sa + 8], e1), a.hi[1], a.lo[1]);
        split(__fmul_rn(ks[sb], e0), a.hi[2], a.lo[2]);
        split(__fmul_rn(ks[sb + 8], e1), a.hi[3], a.lo[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int b0 = (8 * kk + c) * VS + jc + 8 * nt + g;
          uint32_t bh0, bh1, bl0, bl1;
          v_frag<V_EXACT>(vs, b0, b0 + 4 * VS, bh0, bh1, bl0, bl1);
          mma3<V_EXACT>(st[q][nt], a, bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();  // A is whole

    // 5. y of this warp's rows += A V over the columns s < 16 (m + 1), then
    //    y out; the new state's pieces for the next chunk's cross term
    for (int kk = 0; kk < (WITH_Y ? 2 * (m + 1) : 0); ++kk) {
      const int sa = (o + g) * AS + 8 * kk + c;
      Frag a;
      split(as[sa], a.hi[0], a.lo[0]);
      split(as[sa + 8 * AS], a.hi[1], a.lo[1]);
      split(as[sa + 4], a.hi[2], a.lo[2]);
      split(as[sa + 8 * AS + 4], a.hi[3], a.lo[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int b0 = (8 * kk + c) * VS + jc + 8 * nt + g;
        uint32_t bh0, bh1, bl0, bl1;
        v_frag<V_EXACT>(vs, b0, b0 + 4 * VS, bh0, bh1, bl0, bl1);
        mma3<V_EXACT>(ya[nt], a, bh0, bh1, bl0, bl1);
      }
    }
    if constexpr (WITH_Y) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = o + g + 8 * hf;
        if ((!REV || t >= lo) && t < hi) {
          TY* dst = y + (at + (long long)t * rstep) + j0 + jc + 2 * c;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) store2(dst + 8 * nt, ya[nt][2 * hf], ya[nt][2 * hf + 1]);
        }
      }
      put_state();
    }
    if constexpr (KEEP) {
      if (states != nullptr && ci + 1 < nc)
        write_state(states + ((long long)bh * (nc - 1) + (REV ? nc - 2 - ci : ci)) * HD * HD +
                    j0 + jc);
    }
    __syncthreads();
  }

  if (s_last != nullptr) write_state(s_last + (long long)bh * HD * HD + j0 + jc);
}

template <typename T, typename TV, typename TY, int HD, bool REV, bool WITH_Y, bool KEEP>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* y, void* s_last, void* states, int b, int seq, int h,
           cudaStream_t stream) {
  using L = Shape<HD>;
  const size_t bytes = sizeof(float) * L::FLOATS;
  auto kernel = chunk_kernel<T, TV, TY, HD, REV, WITH_Y, KEEP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(b * h * L::NCB), L::THREADS, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const TV*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<TY*>(y), static_cast<float*>(s_last),
      static_cast<float*>(states), seq, h);
  return (int)cudaGetLastError();
}

}  // namespace chunk

}  // namespace
