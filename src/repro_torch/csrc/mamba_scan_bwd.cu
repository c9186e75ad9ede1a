// Mamba (S6) selective scan, backward. Per batch row b, channel d and state
// n, the forward (csrc/mamba_scan.cu) runs, with e_t = exp(dt_t[d] a[d][n]):
//
//   h_t[d][n] = e_t h_t-1[d][n] + dt_t[d] x_t[d] B_t[n],   y_t[d] = sum_n h_t C_t[n]
//
// Given dy (the gradient of y) and dh_last (of the final state, or zeros),
// with G = dL/dh_t (dh_last after the last step), walking t down:
//
//   G        += dy_t[d] C_t[n]
//   dC_t[n]   = sum_d h_t dy_t[d]
//   dB_t[n]   = sum_d G dt_t[d] x_t[d]
//   dx_t[d]   = dt_t[d] sum_n G B_t[n]
//   ddt_t[d]  = sum_n G (a e_t h_t-1 + x_t[d] B_t[n])
//   da[d][n] += G dt_t[d] e_t h_t-1                  (over b and t)
//   G        <- e_t G                                (dL/dh_t-1)
//
// and dh0 = G after step 0. The written-out plain version is
// ref.mamba_scan_bwd_ref; autograd of ref.mamba_scan_ref is the other.
//
// Replaces no TPU kernel: the reference trains Jamba through jax.grad of the
// lax.scan in src/repro/models/mamba.py:79-101 (use_pallas=False in train
// mode), and JAX cannot differentiate the Pallas kernel mamba_scan_pallas.
// Added so that the card trains the Mamba layers through the forward kernel
// (kernels/mamba_scan.py's MambaScan Function).
//
// Bound. At the Jamba training shape (B 4, S 2048, D 8192, N 16) the least
// work per (b, t, d, n) is about 20 FP32 operations: e_t = exp(dt_t a) and
// h_t = e_t h_t-1 + (dt_t x_t) B_t once each (5, the exponential counted as
// one: the reverse walk needs e_t and h_t-1, and the forward's states are
// not kept); G *= e_t+1 (1); G += dy_t C_t and the sums of dC, dB and dx's
// sum over n (2 each); q = G e_t h_t-1, da += dt_t q and ddt's sum of a q
// (6; ddt's x_t sum_n G B_t reuses dx's sum). With 4 per (b, t, d) that is
// 2.17e10 FLOPs, 0.325 ms at 67 TFLOP/s; the 1.07e9 exponentials are 0.257
// ms on the special-function unit (16 a clock an SM at 1.98 GHz) if each is
// one bare MUFU.EX2 (an IEEE expf adds ~7 FP32 instructions of range
// reduction to each, as this kernel pays). The least bytes: dt, dy, ddt in
// float32 and x, dx in their dtype, once each, 1.07 GB with bf16 x (0.321
// ms at 3.35 TB/s). So operations bound it, by a hair. Executed: an IEEE
// expf an element in each of two passes (phase A and the recompute; none in
// the walk), ~10 other FP32 operations an element in the walk, ~3 in each
// pass, the dB/dC butterfly's shuffles, selects and adds and the staging's
// addressing: ~45 issue slots an element where the bound counts 20.
//
// Design, on the CUDA cores in float32, shaped as the forward:
//  * A lane owns NL = 4 states of one channel (N / 4 lanes a channel; N 4
//    takes 2 lanes of 2), its G and da in registers; a CTA of 256 threads
//    owns 64 channels of one batch row (grid: channel blocks x batch), two
//    CTAs an SM.
//  * Decays by IEEE expf of the rounded product dt a, as the plain
//    version's torch.exp takes them, and not by the forward kernel's bare
//    ex2.approx: near a decay of 1 that approximation's error has one
//    sign step after step, and over the 2048 steps of a training sequence G
//    (a sum of products of up to 2048 decays) drifts by ~1e-4 of its scale,
//    the tolerance the gradients are held to. A decay that underflows is 0:
//    G stops there, and every gradient stays finite.
//  * States by checkpoints. Phase A runs the forward recurrence and writes
//    the state at the start of every TB = 8-step sub-chunk into scratch the
//    wrapper allocates, B ceil(S / TB) D N floats (537 MB each way at the
//    training shape, as the first version); then each sub-chunk from the
//    last is recomputed from its checkpoint with its decays and states kept
//    in registers, e_t beside h_t-1, and walked down: the walk takes no
//    exponential. Checkpoints every 64 steps, with each 64-step segment's
//    sub-chunk states recomputed on chip, were measured and dropped: their
//    third exponential pass cost 0.6-0.7 ms more than the 470 MB a way
//    they save (PERF.md).
//  * dx and ddt sum the lane's states and its partners' (xor shuffles).
//    dB and dC sum over all D channels, which lie in many CTAs: a step's
//    2 NL terms a lane go through a transposed xor butterfly over the
//    warp's channels (while a lane holds more than one term it keeps half
//    and sends half; one shuffle a term-halving, 7 a lane and step at N 16,
//    where the first version took 15 over 2-lane channels); the warps'
//    sums go to (b, t, block, 2N) partials through shared memory, and a
//    second launch in the same C entry sums the blocks in order, and da's
//    (b, d, n) partials over b in order. No atomics: the bits repeat from
//    call to call.
//  * Loads overlapped: every sub-chunk's dt, x, B (and in the walk dy, C)
//    comes by 16-byte cp.async (element by element where D is no multiple
//    of 8) into a ring of STAGES buffers, STAGES - 1 sub-chunks ahead of
//    the one computed, in the order phase A, then the walks, a walked
//    sub-chunk's checkpoint with its inputs once phase A has written it;
//    one __syncthreads() a sub-chunk. A sub-chunk's next loads are issued
//    and the last walked sub-chunk's dx, ddt and dB/dC sums stored (from
//    double buffers) after its compute, while other warps still compute.
//  * A step past S is staged as dt = x = dy = B = C = 0: its decay is exactly
//    1 and it adds nothing, so the states and G pass it unchanged; its
//    outputs are not stored. Channels past D compute on zeros and store
//    nothing.
//
// Budget (N 16, bf16 x): registers at most 128 a thread (the sub-chunk's 32
// h_t-1 and 32 e_t, G, da, a); shared memory the ring (5 x 10 KB, a
// sub-chunk's checkpoint in each), the dB/dC sums and dx/ddt double buffers
// (24 KB): ~74 KB, two CTAs an SM.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;      // a CTA
constexpr int TB = 8;             // steps a sub-chunk, a checkpoint each
constexpr int STAGES = 5;         // the staging ring
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// K neighbouring floats between registers and p (aligned to K of them)
template <int K>
__device__ __forceinline__ void load_vec(float (&out)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      out[q] = v.x; out[q + 1] = v.y; out[q + 2] = v.z; out[q + 3] = v.w;
    }
  } else {
    static_assert(K == 2, "K is 2 or a multiple of 4");
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}
template <int K>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4)
      *reinterpret_cast<float4*>(p + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else {
    static_assert(K == 2, "K is 2 or a multiple of 4");
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// The transposed butterfly of a lane's CNT terms over the lanes of the same
// state group (xor masks MSK = LANES, 2 LANES, .. 16): while a lane holds
// more than one term it keeps the half its bit selects and adds its
// partner's share of it; with one, it adds its partner's in full.
template <int CNT, int MSK, int K>
__device__ __forceinline__ void terms_butterfly_(float (&v)[K], int lane) {
  if constexpr (MSK < 32) {
    if constexpr (CNT > 1) {
      const bool upper = (lane & MSK) != 0;
#pragma unroll
      for (int p = 0; p < CNT / 2; ++p) {
        const float send = upper ? v[p] : v[p + CNT / 2];
        const float keep = upper ? v[p + CNT / 2] : v[p];
        v[p] = keep + __shfl_xor_sync(FULL, send, MSK);
      }
      terms_butterfly_<CNT / 2, MSK * 2, K>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], MSK);
      terms_butterfly_<1, MSK * 2, K>(v, lane);
    }
  }
}
template <int K, int LANES>
__device__ __forceinline__ void terms_butterfly(float (&v)[K], int lane) {
  terms_butterfly_<K, LANES, K>(v, lane);
}
// the terms a lane holds after it
template <int K, int LANES>
__host__ __device__ constexpr int terms_keep() {
  int cnt = K;
  for (int m = LANES; m < 32 && cnt > 1; m *= 2) cnt /= 2;
  return cnt;
}

template <typename T, int N>
struct Geo {
  static constexpr int NL = N / 2 < 4 ? N / 2 : 4;  // states a lane
  static constexpr int LANES = N / NL;              // lanes a channel
  static constexpr int CH = THREADS / LANES;        // channels a CTA
  // one ring buffer, in floats: dt, dy [TB][CH]; x [TB][CH] as T; B, C [TB][N];
  // a sub-chunk's checkpoint [CH][N]
  static constexpr int XF = (TB * CH * (int)sizeof(T) + 3) / 4;
  static constexpr int CKB = 2 * TB * CH + XF + 2 * TB * N;
  static constexpr int BUF = CKB + CH * N;
  // shared memory, in floats; every part 16-byte aligned
  static constexpr int RING = 0;
  static constexpr int PART = RING + STAGES * BUF;             // [2][TB][WARPS][2N]
  static constexpr int OUTS = PART + 2 * TB * WARPS * 2 * N;   // [2][dx, ddt][TB][CH]
  static constexpr int FLOATS = OUTS + 2 * 2 * TB * CH;
  static_assert(BUF % 4 == 0 && XF % 4 == 0 && CH % 8 == 0, "alignment");
};

// VEC: D is a multiple of 8, and dt, x and dy are staged 16 bytes a copy
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
mamba_scan_bwd_kernel(const float* __restrict__ dt, const T* __restrict__ x,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ h0,
                      const float* __restrict__ dy, const float* __restrict__ dh_last,
                      float* __restrict__ ddt, T* __restrict__ dx,
                      float* __restrict__ part_bc, float* __restrict__ part_a,
                      float* __restrict__ dh0, float* __restrict__ ckpt, int seq, int dim) {
  using L = Geo<T, N>;
  constexpr int NL = L::NL, LANES = L::LANES, CH = L::CH;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const s_part = sm + L::PART;
  float* const s_outs = sm + L::OUTS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tid % LANES;   // lane in the channel's group
  const int dl = tid / LANES;  // channel, in the CTA
  const int d0 = blockIdx.x * CH;
  const int d = d0 + dl;
  const bool live = d < dim;
  const int bi = blockIdx.y;
  const long long row = (long long)bi * seq;  // (b, t = 0)
  const int nblk = gridDim.x;

  // The sub-chunk schedule, loaded and computed in one order: phase A's
  // sub-chunks 0 .. nsub - 2 (items 0 .. na - 1), then the walks of
  // sub-chunks nsub - 1 .. 0.
  const int nsub = (seq + TB - 1) / TB;
  const int na = nsub > 0 ? nsub - 1 : 0;
  const int items = na + nsub;
  auto sub_of = [&](int k) { return k < na ? k : items - 1 - k; };
  auto buf_of = [&](int k) { return sm + L::RING + (k % STAGES) * L::BUF; };
  // A walk, but the last sub-chunk's (phase A's state), takes its checkpoint
  // from the ring when phase A wrote it before the iteration that loads the
  // walk's inputs (a barrier between them), else from device memory when it
  // is computed.
  auto ring_ck = [&](int k) {
    const int sub = sub_of(k);
    return k >= na && sub < nsub - 1 && sub < k - (STAGES - 1);
  };
  // Item k's sub-chunk into its ring buffer (dy and C only for a walk); a
  // step past S, or a channel past D, as zeros. One commit group an item,
  // empty past the last.
  auto issue = [&](int k) {
    if (k < items) {
      const bool walk = k >= na;
      float* b = buf_of(k);
      float* s_dt = b;
      float* s_dy = b + TB * CH;
      T* s_x = reinterpret_cast<T*>(b + 2 * TB * CH);
      float* s_b = b + 2 * TB * CH + L::XF;
      float* s_c = s_b + TB * N;
      const int t0 = sub_of(k) * TB;
      // dt, x, dy: E elements a copy
      auto slab = [&](auto* s, const auto* g, auto e_tag) {
        constexpr int E = decltype(e_tag)::value;
        using V = std::remove_cv_t<std::remove_pointer_t<decltype(g)>>;
        for (int e = tid; e < TB * CH / E; e += THREADS) {
          const int r = e / (CH / E), c = E * (e % (CH / E));
          const bool ok = t0 + r < seq && d0 + c < dim;
          const V* src = g + (row + t0 + r) * dim + d0 + c;
          if constexpr (E == 1) s[r * CH + c] = ok ? *src : V(0.f);
          else cp_async16(&s[r * CH + c], ok ? src : g, ok);
        }
      };
      if constexpr (VEC) {
        slab(s_dt, dt, std::integral_constant<int, 4>());
        slab(s_x, x, std::integral_constant<int, 16 / (int)sizeof(T)>());
        if (walk) slab(s_dy, dy, std::integral_constant<int, 4>());
      } else {
        slab(s_dt, dt, std::integral_constant<int, 1>());
        slab(s_x, x, std::integral_constant<int, 1>());
        if (walk) slab(s_dy, dy, std::integral_constant<int, 1>());
      }
      // B and C: N floats a step, 16 bytes a copy
      const int have = (seq - t0 < TB ? seq - t0 : TB) * (N / 4);
      for (int e = tid; e < (walk ? 2 : 1) * TB * N / 4; e += THREADS) {
        const int which = e / (TB * N / 4), q = e % (TB * N / 4);
        const float* g = which ? cm : bm;
        const float* src = g + (row + t0) * N + 4 * q;
        cp_async16((which ? s_c : s_b) + 4 * q, q < have ? src : g, q < have);
      }
      // a walked sub-chunk's checkpoint: the CTA's CH channels' N states
      if (ring_ck(k)) {
        const float* src = ckpt + (((long long)bi * nsub + sub_of(k)) * dim + d0) * N;
        const int have_ck = (dim - d0 < CH ? dim - d0 : CH) * (N / 4);
        for (int q = tid; q < CH * N / 4; q += THREADS)
          cp_async16(b + L::CKB + 4 * q, q < have_ck ? src + 4 * q : ckpt, q < have_ck);
      }
    }
    cp_async_commit();
  };

  float av[NL], cur[NL];
#pragma unroll
  for (int q = 0; q < NL; ++q) av[q] = cur[q] = 0.f;
  const long long own = ((long long)bi * dim + d) * N + j * NL;  // this lane's (b, d, n) states
  if (live) {
    load_vec(av, a + (long long)d * N + j * NL);
    if (h0 != nullptr) load_vec(cur, h0 + own);
  }
  // this lane's states in sub-chunk c's checkpoint
  auto ck = [&](int c) { return ckpt + (((long long)bi * nsub + c) * dim + d) * N + j * NL; };
  // cur through a sub-chunk's TB steps (one exponential a state a step)
  auto advance = [&](const float* b) {
    const float* s_dt = b;
    const T* s_x = reinterpret_cast<const T*>(b + 2 * TB * CH);
    const float* s_b = b + 2 * TB * CH + L::XF;
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const float dv = s_dt[i * CH + dl];
      const float u = __fmul_rn(dv, widen(s_x[i * CH + dl]));
      float bq[NL];
      load_vec(bq, s_b + i * N + j * NL);
#pragma unroll
      for (int q = 0; q < NL; ++q) {
        const float e = expf(__fmul_rn(dv, av[q]));
        cur[q] = __fmaf_rn(cur[q], e, __fmul_rn(u, bq[q]));
      }
    }
  };

  float g[NL], da[NL];
#pragma unroll
  for (int q = 0; q < NL; ++q) g[q] = da[q] = 0.f;
  if (live && dh_last != nullptr) load_vec(g, dh_last + own);

  // after terms_butterfly a lane holds T_KEEP of its 2 NL terms, from
  // t_idx0, summed over the warp's channels; of lanes that hold the same
  // sums, the one whose full-add bits are 0 writes them
  constexpr int T_KEEP = terms_keep<2 * NL, LANES>();
  int t_idx0 = 0;
  bool t_writer = true;
#pragma unroll
  for (int m = LANES, cnt = 2 * NL; m < 32; m *= 2) {
    if (cnt > 1) {
      if (lane & m) t_idx0 += cnt / 2;
      cnt /= 2;
    } else if (lane & m) {
      t_writer = false;
    }
  }

  // a walked sub-chunk's outputs, stored after the next barrier
  int pending = -1, pending_buf = 0, walks = 0;
  auto flush = [&]() {
    if (pending < 0) return;
    const int t0 = pending * TB;
    const int n = seq - t0 < TB ? seq - t0 : TB;
    const float* o_dx = s_outs + pending_buf * 2 * TB * CH;
    const float* o_ddt = o_dx + TB * CH;
    for (int e = tid; e < n * CH; e += THREADS) {
      const int i = e / CH, dd = d0 + e % CH;
      if (dd < dim) {
        const long long off = (row + t0 + i) * dim + dd;
        dx[off] = narrow<T>(o_dx[e]);
        ddt[off] = o_ddt[e];
      }
    }
    const float* p = s_part + pending_buf * TB * WARPS * 2 * N;
    for (int e = tid; e < n * 2 * N; e += THREADS) {
      const int i = e / (2 * N), slot = e % (2 * N);
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) acc += p[(i * WARPS + w) * 2 * N + slot];
      part_bc[((row + t0 + i) * nblk + blockIdx.x) * 2 * N + slot] = acc;
    }
    pending = -1;
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);
  // item k: phase A's sub-chunk or a walk's (its outputs into the double
  // buffers); returns the sub-chunk walked, or -1
  auto compute = [&](int k) -> int {
    const int sub = sub_of(k);
    const float* b = buf_of(k);
    if (k < na) {  // phase A: the checkpoint at the sub-chunk's start, then on
      if (live) store_vec(ck(sub), cur);
      advance(b);
      return -1;
    }
    // the walk of one sub-chunk from its checkpoint (the last sub-chunk's is
    // phase A's state): its states and decays, then each step down
    if (ring_ck(k)) load_vec(cur, b + L::CKB + dl * N + j * NL);
    else if (sub < nsub - 1 && live) load_vec(cur, ck(sub));
    const float* s_dt = b;
    const float* s_dy = b + TB * CH;
    const T* s_x = reinterpret_cast<const T*>(b + 2 * TB * CH);
    const float* s_b = b + 2 * TB * CH + L::XF;
    const float* s_c = s_b + TB * N;
    float hp[TB][NL], ee[TB][NL];
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const float dv = s_dt[i * CH + dl];
      const float u = __fmul_rn(dv, widen(s_x[i * CH + dl]));
      float bq[NL];
      load_vec(bq, s_b + i * N + j * NL);
#pragma unroll
      for (int q = 0; q < NL; ++q) {
        hp[i][q] = cur[q];
        ee[i][q] = expf(__fmul_rn(dv, av[q]));
        cur[q] = __fmaf_rn(cur[q], ee[i][q], __fmul_rn(u, bq[q]));
      }
    }
    const int ob = walks & 1;
    float* o_dx = s_outs + ob * 2 * TB * CH;
    float* o_ddt = o_dx + TB * CH;
    float* o_part = s_part + ob * TB * WARPS * 2 * N;
#pragma unroll
    for (int i = TB - 1; i >= 0; --i) {
      const float dv = s_dt[i * CH + dl], xv = widen(s_x[i * CH + dl]);
      const float dyv = s_dy[i * CH + dl];
      const float u = __fmul_rn(dv, xv);
      float bq[NL], cq[NL], tv[2 * NL];  // dB's terms, then dC's
      load_vec(bq, s_b + i * N + j * NL);
      load_vec(cq, s_c + i * N + j * NL);
      float dxp = 0.f, ddtp = 0.f;
#pragma unroll
      for (int q = 0; q < NL; ++q) {
        g[q] = __fmaf_rn(dyv, cq[q], g[q]);
        tv[q] = __fmul_rn(g[q], u);
        const float ehp = __fmul_rn(ee[i][q], hp[i][q]);
        tv[NL + q] = __fmul_rn(__fmaf_rn(u, bq[q], ehp), dyv);  // h_t dy
        dxp = __fmaf_rn(g[q], bq[q], dxp);
        const float gq = __fmul_rn(g[q], ehp);
        da[q] = __fmaf_rn(dv, gq, da[q]);
        ddtp = __fmaf_rn(av[q], gq, ddtp);
        g[q] = __fmul_rn(ee[i][q], g[q]);
      }
      // the channel's sums over its lanes (every lane gets the same bits)
#pragma unroll
      for (int o = 1; o < LANES; o *= 2) {
        dxp += __shfl_xor_sync(FULL, dxp, o);
        ddtp += __shfl_xor_sync(FULL, ddtp, o);
      }
      if (j == 0) {
        o_dx[i * CH + dl] = __fmul_rn(dv, dxp);
        o_ddt[i * CH + dl] = __fmaf_rn(xv, dxp, ddtp);
      }
      // dB and dC over the warp's CW channels, a transposed butterfly of
      // the lane's 2 NL terms; then the lane's share into the step's sums
      terms_butterfly<2 * NL, LANES>(tv, lane);
#pragma unroll
      for (int p = 0; p < T_KEEP; ++p) {
        const int idx = t_idx0 + p;  // into the lane's 2 NL terms
        if (t_writer)
          o_part[(i * WARPS + warp) * 2 * N + (idx < NL ? 0 : N) + j * NL + idx % NL] = tv[p];
      }
    }
    return sub;
  };

  for (int k = 0; k < items; ++k) {
    cp_async_wait<STAGES - 2>();  // item k has landed
    __syncthreads();              // for every thread; and every thread is done with k - 1
    const int walked = compute(k);
    // after the item, while other warps still compute: the next loads into
    // the buffer item k - 1 used, and the last walk's stores
    issue(k + STAGES - 1);
    flush();
    if (walked >= 0) {
      pending = walked;
      pending_buf = walks & 1;
      ++walks;
    }
  }
  __syncthreads();
  flush();

  if (live) {
    store_vec(part_a + own, da);
    if (dh0 != nullptr) store_vec(dh0 + own, g);
  }
}

// db, dc (batch, seq, n): the blocks' partials summed in order; da (dim, n):
// the batch rows' partials summed in order
template <int N>
__global__ void mamba_bwd_sum_kernel(const float* __restrict__ part_bc,
                                     const float* __restrict__ part_a, float* __restrict__ db,
                                     float* __restrict__ dc, float* __restrict__ da,
                                     long long rows, int nblk, int batch, long long dn) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nbc = rows * 2 * N;
  if (e < nbc) {
    const long long r = e / (2 * N);
    const int slot = (int)(e % (2 * N));
    float acc = 0.f;
    for (int q = 0; q < nblk; ++q) acc += part_bc[(r * nblk + q) * 2 * N + slot];
    if (slot < N) db[r * N + slot] = acc;
    else dc[r * N + slot - N] = acc;
  } else if (e < nbc + dn) {
    const long long o = e - nbc;
    float acc = 0.f;
    for (int q = 0; q < batch; ++q) acc += part_a[q * dn + o];
    da[o] = acc;
  }
}

struct Scratch {
  long long ckpt, bc, a;  // floats of each part
};

template <int N>
Scratch scratch_floats(int batch, int seq, int dim) {
  constexpr int CH = Geo<float, N>::CH;
  const long long nblk = (dim + CH - 1) / CH;
  return {(long long)batch * ((seq + TB - 1) / TB) * dim * N,
          (long long)batch * seq * nblk * 2 * N, (long long)batch * dim * N};
}

template <typename T, int N>
int launch(const void* dt, const void* x, const void* b, const void* c, const void* a,
           const void* h0, const void* dy, const void* dh_last, void* ddt, void* dx, void* db,
           void* dc, void* da, void* dh0, void* scratch, int batch, int seq, int dim,
           cudaStream_t stream) {
  using L = Geo<T, N>;
  const size_t bytes = sizeof(float) * L::FLOATS;
  auto kernel = dim % 8 == 0 ? mamba_scan_bwd_kernel<T, N, true>
                             : mamba_scan_bwd_kernel<T, N, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const Scratch sc = scratch_floats<N>(batch, seq, dim);
  float* ckpt = static_cast<float*>(scratch);
  float* part_bc = ckpt + sc.ckpt;
  float* part_a = part_bc + sc.bc;
  const int nblk = (dim + L::CH - 1) / L::CH;
  const dim3 grid((unsigned)nblk, (unsigned)batch);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(x), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(a),
      static_cast<const float*>(h0), static_cast<const float*>(dy),
      static_cast<const float*>(dh_last), static_cast<float*>(ddt), static_cast<T*>(dx),
      part_bc, part_a, static_cast<float*>(dh0), ckpt, seq, dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)batch * seq, dn = (long long)dim * N;
  const long long items = rows * 2 * N + dn;
  mamba_bwd_sum_kernel<N><<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
      part_bc, part_a, static_cast<float*>(db), static_cast<float*>(dc), static_cast<float*>(da),
      rows, nblk, batch, dn);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int n, const void* dt, const void* x, const void* b, const void* c, const void* a,
             const void* h0, const void* dy, const void* dh_last, void* ddt, void* dx, void* db,
             void* dc, void* da, void* dh0, void* scratch, int batch, int seq, int dim,
             cudaStream_t stream) {
  switch (n) {
    case 4:
      return launch<T, 4>(dt, x, b, c, a, h0, dy, dh_last, ddt, dx, db, dc, da, dh0, scratch,
                          batch, seq, dim, stream);
    case 8:
      return launch<T, 8>(dt, x, b, c, a, h0, dy, dh_last, ddt, dx, db, dc, da, dh0, scratch,
                          batch, seq, dim, stream);
    case 16:
      return launch<T, 16>(dt, x, b, c, a, h0, dy, dh_last, ddt, dx, db, dc, da, dh0, scratch,
                           batch, seq, dim, stream);
    case 32:
      return launch<T, 32>(dt, x, b, c, a, h0, dy, dh_last, ddt, dx, db, dc, da, dh0, scratch,
                           batch, seq, dim, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch the backward of (batch, seq, dim, n) needs: the
// checkpoints, the blocks' dB/dC partials and the rows' da partials; -1 for
// a state dim it does not take.
extern "C" long long mamba_scan_bwd_scratch(int batch, int seq, int dim, int n) {
  Scratch sc;
  switch (n) {
    case 4: sc = scratch_floats<4>(batch, seq, dim); break;
    case 8: sc = scratch_floats<8>(batch, seq, dim); break;
    case 16: sc = scratch_floats<16>(batch, seq, dim); break;
    case 32: sc = scratch_floats<32>(batch, seq, dim); break;
    default: return -1;
  }
  return sc.ckpt + sc.bc + sc.a;
}

// The scan's backward: two launches (the reverse walk, then the sums over
// channel blocks and batch rows). dt, dy: (batch, seq, dim) float32; x:
// (batch, seq, dim) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1); b, c:
// (batch, seq, n) float32; a: (dim, n) float32; h0, dh_last: (batch, dim,
// n) float32 or null (zeros). Writes ddt (float32) and dx (x's dtype) of
// dt's shape, db, dc (batch, seq, n), da (dim, n) and, when dh0 is not null,
// dh0 (batch, dim, n), all float32. scratch: mamba_scan_bwd_scratch(...)
// floats. All contiguous and 16-byte aligned.
extern "C" int mamba_scan_bwd(int x_bf16, const void* dt, const void* x, const void* b,
                              const void* c, const void* a, const void* h0, const void* dy,
                              const void* dh_last, void* ddt, void* dx, void* db, void* dc,
                              void* da, void* dh0, void* scratch, int batch, int seq, int dim,
                              int n, void* stream) {
  if (batch <= 0 || dim <= 0) return 0;
  if (seq < 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return x_bf16 ? dispatch<__nv_bfloat16>(n, dt, x, b, c, a, h0, dy, dh_last, ddt, dx, db, dc,
                                          da, dh0, scratch, batch, seq, dim, s)
                : dispatch<float>(n, dt, x, b, c, a, h0, dy, dh_last, ddt, dx, db, dc, da, dh0,
                                  scratch, batch, seq, dim, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
