// RWKV-6 WKV recurrence, backward. Per (batch b, head h), the forward (csrc/
// wkv6.cu) runs, with S_t the (hd x hd) state before step t:
//
//   y_t[j]    = sum_i r_t[i] (S_t[i][j] + u[i] k_t[i] v_t[j])
//   S_t+1[i][j] = w_t[i] S_t[i][j] + k_t[i] v_t[j]
//
// Given dy (the gradient of y) and ds_last (of the final state, or zeros),
// with G = dL/dS_t+1 (ds_last after the last step), walking t down:
//
//   dr_t[i] = sum_j S_t[i][j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G[i][j] v_t[j]    + u[i] r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G[i][j] k_t[i]    + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   dw_t[i] = sum_j G[i][j] S_t[i][j]
//   du[i]  += r_t[i] k_t[i] (v_t . dy_t)              (over b and t)
//   G[i][j] <- w_t[i] G[i][j] + r_t[i] dy_t[j]         (dL/dS_t)
//
// and ds0 = G after step 0. The written-out plain version is
// ref.wkv6_bwd_ref; autograd of ref.wkv6_ref is the other.
//
// Replaces no TPU kernel: the reference trains RWKV-6 through jax.grad of
// its plain scan (src/repro/models/rwkv6.py:91, wkv_scan), and JAX cannot
// differentiate the Pallas kernel wkv6_pallas. Added so that the card trains
// RWKV-6 through the forward kernel (kernels/wkv6.py's WKV6 Function).
//
// Bound. At the RWKV-6 7B training shape (B 4, S 2048, H 64, hd 64) the
// least work is 6 FP32 FMAs per (b, h, t, i, j): the state's recompute, G's
// update, and the four sums (dr, dk, dv, dw); 2.58e10 FLOPs, 0.385 ms at the
// CUDA cores' 67 TFLOP/s. The least bytes: r, k, v in their dtype, w and dy
// in float32 read once, dr, dk, dv in their dtype and dw written once, ~0.47
// GB in bf16 (0.14 ms at 3.35 TB/s). So operations bound it.
//
// Design, a first kernel on the CUDA cores in float32:
//  * Every state element evolves alone (S[i][j] needs only w[i], k[i], v[j]);
//    only the outputs sum, dr, dk and dw over j, dv over i. One CTA owns one
//    (b, h) and its whole state: lane l of warp q owns row i = q RPW + l / NG
//    and columns CJ c .. CJ c + CJ - 1 (CJ = hd / NG, c = l % NG; NG = 8
//    lanes a row, RPW = 4 rows a warp, at hd 32 and 64), so a row's sums
//    (dr, dk, dw) are an xor butterfly over its NG lanes and dv's sum over i
//    is a transposed butterfly over the warp's RPW rows (each lane keeps
//    CJ / RPW columns) and then, after the sub-chunk, a sum over the warps in
//    order through shared memory. No atomics: every sum has one order, and the
//    bits repeat from call to call.
//  * States by checkpoints. The walk is backwards in time but the state runs
//    forwards, and S_t cannot be had from S_t+1 (w underflows to 0: dividing
//    is never done). So the CTA first runs the forward recurrence (phase A,
//    one FMA an element a step, no y) and writes its state every T steps into
//    scratch that the wrapper allocates: B H ceil(S / T) hd^2 floats, each
//    thread's own elements together (a thread reads back only what it
//    wrote). Then (phase B) it walks the sub-chunks from the last: stages
//    the T steps' r, k, w, v and dy in shared memory, recomputes the T states
//    from the checkpoint into shared memory (each thread its own elements),
//    and walks the T steps down. T = 32768 / hd^2 (8 at hd 64) keeps the
//    sub-chunk's states at 128 KB: one CTA an SM.
//  * A step past S (the ragged last sub-chunk) is staged as r = k = v =
//    dy = 0 and w = 1: its state and G pass it unchanged and its outputs are
//    not stored.
//  * du: each CTA writes its (b, h) row sums into scratch, and a second
//    launch in the same C entry sums them over b in order.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <int HD>
struct Geo {
  static constexpr int NG = HD <= 64 ? 8 : 4;    // lanes a row
  static constexpr int RPW = 32 / NG;            // rows a warp
  static constexpr int CJ = HD / NG;             // columns a lane
  static constexpr int WARPS = HD / RPW;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int T = 32768 / (HD * HD);    // steps a sub-chunk (and between checkpoints)
  static constexpr int Q = CJ / 4;               // float4s of a lane's columns
  static constexpr int OUT = CJ / RPW;           // dv columns a lane holds after the butterfly
  static constexpr int STATES = T * HD * HD;     // shared floats: the sub-chunk's states
  static constexpr int STAGE = 5 * T * HD;       // r, k, w, v, dy
  static constexpr int DVP = T * WARPS * HD;     // dv a warp
  static constexpr int OUTS = 3 * T * HD;        // dr, dk, dw
  static constexpr int FLOATS = STATES + STAGE + DVP + OUTS + HD + 2 * T;  // + u, v.dy, r.uk
  static_assert(CJ % 4 == 0 && CJ >= RPW && T >= 1, "geometry");
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(Geo<HD>::THREADS, 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ s0, const float* __restrict__ dy,
                const float* __restrict__ ds_last, T* __restrict__ dr, T* __restrict__ dk,
                T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, float4* __restrict__ ckpt, int seq, int h) {
  using G = Geo<HD>;
  constexpr int TS = G::T;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float4* states = smem4;                    // [TS][Q][THREADS]
  float* s_r = sm + G::STATES;               // [TS][HD] each
  float* s_k = s_r + TS * HD;
  float* s_w = s_k + TS * HD;
  float* s_v = s_w + TS * HD;
  float* s_dy = s_v + TS * HD;
  float* s_dvp = s_dy + TS * HD;             // [TS][WARPS][HD]
  float* s_out = s_dvp + G::DVP;             // [3][TS][HD]: dr, dk, dw
  float* s_u = s_out + G::OUTS;              // [HD]
  float* s_vdy = s_u + HD;                   // [TS]
  float* s_ruk = s_vdy + TS;                 // [TS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = warp * G::RPW + lane / G::NG;
  const int cg = lane % G::NG;
  const int col0 = cg * G::CJ;
  const int bh = blockIdx.x;
  const int head = bh % h;
  const long long b = bh / h;
  const long long step = (long long)h * HD;                      // elements between steps
  const long long base = b * seq * step + (long long)head * HD;  // (b, 0, head, 0)
  const long long sbase = (long long)bh * HD * HD + (long long)row * HD + col0;
  const int nchunks = (seq + TS - 1) / TS;
  float4* ck = ckpt + (long long)bh * nchunks * G::Q * G::THREADS + tid;

  for (int e = tid; e < HD; e += G::THREADS) s_u[e] = u[head * HD + e];
  __syncthreads();

  // stage steps t0 .. t0 + TS - 1 of the inputs named by `all` (r and dy too)
  // into shared memory as float32; a step past S as r = k = v = dy = 0, w = 1
  auto stage = [&](int t0, bool all) {
    for (int e = tid; e < TS * HD; e += G::THREADS) {
      const int t = t0 + e / HD, j = e % HD;
      const bool ok = t < seq;
      const long long off = base + (long long)t * step + j;
      s_k[e] = ok ? to_float(k[off]) : 0.f;
      s_w[e] = ok ? w[off] : 1.f;
      s_v[e] = ok ? to_float(v[off]) : 0.f;
      if (all) {
        s_r[e] = ok ? to_float(r[off]) : 0.f;
        s_dy[e] = ok ? dy[off] : 0.f;
      }
    }
  };
  auto vec = [&](const float* p, float (&out)[G::CJ]) {  // a lane's CJ columns of a row
#pragma unroll
    for (int q = 0; q < G::Q; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(p + 4 * q);
      out[4 * q] = x.x; out[4 * q + 1] = x.y; out[4 * q + 2] = x.z; out[4 * q + 3] = x.w;
    }
  };

  // -- phase A: the forward recurrence, a checkpoint every TS steps ----------
  float s[G::CJ];
  if (s0 != nullptr) vec(s0 + sbase, s);
  else {
#pragma unroll
    for (int c = 0; c < G::CJ; ++c) s[c] = 0.f;
  }
  for (int c = 0; c < nchunks; ++c) {
#pragma unroll
    for (int q = 0; q < G::Q; ++q)
      ck[(long long)(c * G::Q + q) * G::THREADS] =
          make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
    if (c == nchunks - 1) break;  // the last sub-chunk's steps are not needed here
    __syncthreads();              // every thread is done with the last staging
    stage(c * TS, false);
    __syncthreads();
    for (int i = 0; i < TS; ++i) {
      const float ki = s_k[i * HD + row], wi = s_w[i * HD + row];
      float vv[G::CJ];
      vec(s_v + i * HD + col0, vv);
#pragma unroll
      for (int cc = 0; cc < G::CJ; ++cc) s[cc] = __fmaf_rn(wi, s[cc], __fmul_rn(ki, vv[cc]));
    }
  }

  // -- phase B: the sub-chunks from the last, each step down ----------------
  float g[G::CJ];
  if (ds_last != nullptr) vec(ds_last + sbase, g);
  else {
#pragma unroll
    for (int c = 0; c < G::CJ; ++c) g[c] = 0.f;
  }
  float du_acc = 0.f;
  const float ui = s_u[row];
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * TS;
    const int n = seq - t0 < TS ? seq - t0 : TS;
    __syncthreads();  // every thread is done with the last sub-chunk's shared memory
    stage(t0, true);
    __syncthreads();
    // v_t . dy_t and r_t . u k_t, a warp a step
    for (int i = warp; i < TS; i += G::WARPS) {
      float a = 0.f, bsum = 0.f;
      for (int j = lane; j < HD; j += 32) {
        a = __fmaf_rn(s_v[i * HD + j], s_dy[i * HD + j], a);
        bsum = __fmaf_rn(s_r[i * HD + j] * s_u[j], s_k[i * HD + j], bsum);
      }
#pragma unroll
      for (int o = 16; o >= 1; o /= 2) {
        a += __shfl_xor_sync(FULL, a, o);
        bsum += __shfl_xor_sync(FULL, bsum, o);
      }
      if (lane == 0) {
        s_vdy[i] = a;
        s_ruk[i] = bsum;
      }
    }
    // the sub-chunk's states from its checkpoint, each thread its own elements
    float st[G::CJ];
#pragma unroll
    for (int q = 0; q < G::Q; ++q) {
      const float4 x = ck[(long long)(c * G::Q + q) * G::THREADS];
      st[4 * q] = x.x; st[4 * q + 1] = x.y; st[4 * q + 2] = x.z; st[4 * q + 3] = x.w;
    }
    for (int i = 0; i < TS; ++i) {
#pragma unroll
      for (int q = 0; q < G::Q; ++q)
        states[(i * G::Q + q) * G::THREADS + tid] =
            make_float4(st[4 * q], st[4 * q + 1], st[4 * q + 2], st[4 * q + 3]);
      const float ki = s_k[i * HD + row], wi = s_w[i * HD + row];
      float vv[G::CJ];
      vec(s_v + i * HD + col0, vv);
#pragma unroll
      for (int cc = 0; cc < G::CJ; ++cc) st[cc] = __fmaf_rn(wi, st[cc], __fmul_rn(ki, vv[cc]));
    }
    __syncthreads();  // s_vdy and s_ruk are written
    for (int i = TS - 1; i >= 0; --i) {
      const float ri = s_r[i * HD + row], ki = s_k[i * HD + row], wi = s_w[i * HD + row];
      float pr = 0.f, pk = 0.f, pw = 0.f;
      float dvp[G::CJ];
#pragma unroll
      for (int q = 0; q < G::Q; ++q) {  // a float4 of columns at a time
        const float4 s4 = states[(i * G::Q + q) * G::THREADS + tid];
        const float4 v4 = *reinterpret_cast<const float4*>(s_v + i * HD + col0 + 4 * q);
        const float4 d4 = *reinterpret_cast<const float4*>(s_dy + i * HD + col0 + 4 * q);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
        const float dyv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = 4 * q + e;
          pr = __fmaf_rn(sv[e], dyv[e], pr);
          pk = __fmaf_rn(g[cc], vv[e], pk);
          pw = __fmaf_rn(g[cc], sv[e], pw);
          dvp[cc] = __fmul_rn(g[cc], ki);
          g[cc] = __fmaf_rn(wi, g[cc], __fmul_rn(ri, dyv[e]));
        }
      }
      // the row's sums over its NG lanes
#pragma unroll
      for (int o = 1; o < G::NG; o *= 2) {
        pr += __shfl_xor_sync(FULL, pr, o);
        pk += __shfl_xor_sync(FULL, pk, o);
        pw += __shfl_xor_sync(FULL, pw, o);
      }
      // dv over the warp's RPW rows: at the stage of mask m a lane keeps half
      // of its columns and sends the other half to its partner
      int colbase = col0;
#pragma unroll
      for (int m = G::NG, half = G::CJ / 2; m < 32; m *= 2, half /= 2) {
        const bool upper = (lane & m) != 0;
#pragma unroll
        for (int q = 0; q < half; ++q) {
          const float send = upper ? dvp[q] : dvp[q + half];
          const float keep = upper ? dvp[q + half] : dvp[q];
          dvp[q] = keep + __shfl_xor_sync(FULL, send, m);
        }
        if (upper) colbase += half;
      }
#pragma unroll
      for (int o = 0; o < G::OUT; ++o) s_dvp[(i * G::WARPS + warp) * HD + colbase + o] = dvp[o];
      if (cg == 0) {
        const float vdy = s_vdy[i];
        s_out[i * HD + row] = __fmaf_rn(ui * ki, vdy, pr);
        s_out[(TS + i) * HD + row] = __fmaf_rn(ui * ri, vdy, pk);
        s_out[(2 * TS + i) * HD + row] = pw;
        du_acc = __fmaf_rn(ri * ki, vdy, du_acc);  // 0 past S (r = 0 there)
      }
    }
    __syncthreads();
    for (int e = tid; e < n * HD; e += G::THREADS) {
      const int i = e / HD, j = e % HD;
      const long long off = base + (long long)(t0 + i) * step + j;
      float dvs = 0.f;
      for (int q = 0; q < G::WARPS; ++q) dvs += s_dvp[(i * G::WARPS + q) * HD + j];
      dvs = __fmaf_rn(s_ruk[i], s_dy[i * HD + j], dvs);
      dv[off] = from_float<T>(dvs);
      dr[off] = from_float<T>(s_out[i * HD + j]);
      dk[off] = from_float<T>(s_out[(TS + i) * HD + j]);
      dw[off] = s_out[(2 * TS + i) * HD + j];
    }
  }

  if (cg == 0) du_part[(long long)bh * HD + row] = du_acc;
  if (ds0 != nullptr) {
#pragma unroll
    for (int q = 0; q < G::Q; ++q)
      *reinterpret_cast<float4*>(ds0 + sbase + 4 * q) =
          make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);
  }
}

// du[h][i] = sum over b, in order, of du_part[b][h][i]
__global__ void du_sum_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                              int b, int hhd) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hhd) return;
  float acc = 0.f;
  for (int q = 0; q < b; ++q) acc += du_part[(long long)q * hhd + e];
  du[e] = acc;
}

template <int HD>
long long ckpt_floats(int b, int seq, int h) {
  return (long long)b * h * ((seq + Geo<HD>::T - 1) / Geo<HD>::T) * HD * HD;
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, const void* dy, const void* ds_last, void* dr, void* dk, void* dv,
           void* dw, void* du, void* ds0, void* scratch, int b, int seq, int h,
           cudaStream_t stream) {
  using G = Geo<HD>;
  const size_t bytes = sizeof(float) * G::FLOATS;
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  float* ckpt = static_cast<float*>(scratch);
  float* du_part = ckpt + ckpt_floats<HD>(b, seq, h);
  wkv6_bwd_kernel<T, HD><<<(unsigned)(b * h), G::THREADS, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<const float*>(dy),
      static_cast<const float*>(ds_last), static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(dw), du_part, static_cast<float*>(ds0),
      reinterpret_cast<float4*>(ckpt), seq, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int hhd = h * HD;
  du_sum_kernel<<<(hhd + 255) / 256, 256, 0, stream>>>(du_part, static_cast<float*>(du), b, hhd);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s0, const void* dy, const void* ds_last, void* dr, void* dk, void* dv,
             void* dw, void* du, void* ds0, void* scratch, int b, int seq, int h,
             cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, dy, ds_last, dr, dk, dv, dw, du, ds0, scratch, b,
                           seq, h, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, dy, ds_last, dr, dk, dv, dw, du, ds0, scratch, b,
                           seq, h, stream);
    case 128:
      return launch<T, 128>(r, k, v, w, u, s0, dy, ds_last, dr, dk, dv, dw, du, ds0, scratch,
                            b, seq, h, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch the backward of (b, seq, h, hd) needs: the checkpoints
// and the (b, h, hd) du partials; -1 for a head dim it does not take.
extern "C" long long wkv6_bwd_scratch(int b, int seq, int h, int hd) {
  const long long part = (long long)b * h * hd;
  switch (hd) {
    case 32: return ckpt_floats<32>(b, seq, h) + part;
    case 64: return ckpt_floats<64>(b, seq, h) + part;
    case 128: return ckpt_floats<128>(b, seq, h) + part;
    default: return -1;
  }
}

// The WKV-6 backward: two launches (the reverse walk, then du's sum over b).
// r, k, v: (b, seq, h, hd), float32 (bf16 = 0) or bfloat16 (bf16 = 1); w, dy:
// (b, seq, h, hd) float32; u: (h, hd) float32; s0, ds_last: (b, h, hd, hd)
// float32 or null (zeros). Writes dr, dk, dv (r's dtype), dw (float32) of
// r's shape, du (h, hd) float32 and, when ds0 is not null, ds0 (b, h, hd, hd)
// float32. scratch: wkv6_bwd_scratch(b, seq, h, hd) floats. All contiguous
// and 16-byte aligned.
extern "C" int wkv6_bwd(int bf16, const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, const void* dy, const void* ds_last,
                        void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
                        void* scratch, int b, int seq, int h, int hd, void* stream) {
  if (b <= 0 || h <= 0) return 0;
  if (seq < 0 || (long long)b * h > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(hd, r, k, v, w, u, s0, dy, ds_last, dr, dk, dv, dw, du,
                                        ds0, scratch, b, seq, h, s)
              : dispatch<float>(hd, r, k, v, w, u, s0, dy, ds_last, dr, dk, dv, dw, du, ds0,
                                scratch, b, seq, h, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
