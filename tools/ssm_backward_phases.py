#!/usr/bin/env python3
"""Split the time of the WKV-6 and Mamba-scan backward kernels into their
phases, on one card.

    python3 tools/ssm_backward_phases.py CSRC [--new] [--iters N]

CSRC is a ``csrc/`` directory. Without ``--new`` its ``wkv6_bwd.cu`` and
``mamba_scan_bwd.cu`` must be the first versions (a reverse walk a CTA after
the forward rerun to checkpoints, then a second launch for the cross-CTA
sums), e.g. those of a ``git archive`` of an earlier commit; with ``--new``
the redesigned ones (this repository's ``src/repro_torch/csrc``). A copy of
each is built with a clock added: thread 0 of every CTA reads ``clock64()``
at the end of each phase and adds the cycles since its last reading to that
phase's count, and writes the counts once, at the end. The phases (summed
over a CTA's sub-chunks):

- the first WKV-6 version: phase A's staging (with the checkpoint store and
  its barriers), phase A's forward walk, phase B's staging, the v.dy and
  r.uk dots, the checkpoint read and the recompute into shared memory, the
  walk back (with its closing barrier), the output pass;
- the first scan version: phase A's staging, phase A's forward walk, phase
  B's staging, the checkpoint read and the recompute, the walk back (with
  its closing barrier), the output pass;
- the redesigned WKV-6 backward's row walk (``rows_kernel``, from the
  forward's chunk states): the wait for the first staging group, the sweep
  to the chunk's half, the second group with v.dy, the sweep of the second
  half, its walk, the first half's sweep again, its walk;
- the redesigned scan backward: the ring's wait and barrier; phase A; the
  sub-chunks' recompute; their walks; the next item's issue and the last
  walk's stores.

At the training shapes of ``chip_smoke.py`` 15d (bf16 and float32 inputs) it
prints each kernel's time (CUDA events, the mean of ``--iters`` calls), the
second launch's device time (``torch.profiler``), and each phase's share
of a CTA's cycles, mean over the CTAs, with that share of the main launch's
device time. The clock costs one ``clock64()`` and an add a phase for one
thread of each CTA; the clocked build's time is printed beside the plain
build's.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

MAX_CTAS, SLOTS = 16384, 8
CLOCK = rf"""
__device__ long long phase_cycles[{MAX_CTAS} * {SLOTS}];
#define PH(k) if (threadIdx.x == 0) {{ const long long n_ = clock64(); \
    clk_[k] += n_ - last_; last_ = n_; }}
extern "C" int phase_cycles_read(long long* out, int n) {{
  return (int)cudaMemcpyFromSymbol(out, phase_cycles, sizeof(long long) * {SLOTS} * n);
}}
"""
START = "  long long clk_[{slots}] = {{0}};\n  long long last_ = clock64();\n".format(slots=SLOTS)


def _write(cta: str) -> str:
    return (f"  if (threadIdx.x == 0 && {cta} < {MAX_CTAS})\n"
            f"    for (int q_ = 0; q_ < {SLOTS}; ++q_) phase_cycles[{cta} * {SLOTS} + q_] = "
            "clk_[q_];\n")


# (phase names, [(anchor, replacement)]) of each first version; a
# replacement holds the anchor's text with PH(k) put where phase k ends
WKV_PHASES = ("A staging", "A walk", "B staging", "B dots", "B recompute", "B walk",
              "B output")
WKV_EDITS = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n" + CLOCK),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  const int row = warp * G::RPW + lane / G::NG;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  const int row = warp * G::RPW + lane / G::NG;\n" + START),
    ("    stage(c * TS, false);\n    __syncthreads();\n",
     "    stage(c * TS, false);\n    __syncthreads();\n    PH(0);\n"),
    ("s[cc] = __fmaf_rn(wi, s[cc], __fmul_rn(ki, vv[cc]));\n    }\n",
     "s[cc] = __fmaf_rn(wi, s[cc], __fmul_rn(ki, vv[cc]));\n    }\n    PH(1);\n"),
    ("    stage(t0, true);\n    __syncthreads();\n",
     "    stage(t0, true);\n    __syncthreads();\n    PH(2);\n"),
    ("    // the sub-chunk's states from its checkpoint",
     "    PH(3);\n    // the sub-chunk's states from its checkpoint"),
    ("    __syncthreads();  // s_vdy and s_ruk are written\n",
     "    PH(4);\n    __syncthreads();  // s_vdy and s_ruk are written\n"),
    ("    __syncthreads();\n    for (int e = tid; e < n * HD; e += G::THREADS) {",
     "    __syncthreads();\n    PH(5);\n    for (int e = tid; e < n * HD; e += G::THREADS) {"),
    ("      dw[off] = s_out[(2 * TS + i) * HD + j];\n    }\n",
     "      dw[off] = s_out[(2 * TS + i) * HD + j];\n    }\n    PH(6);\n"),
    ("  if (cg == 0) du_part[(long long)bh * HD + row] = du_acc;",
     _write("bh") + "  if (cg == 0) du_part[(long long)bh * HD + row] = du_acc;"),
]
MAMBA_PHASES = ("A staging", "A walk", "B staging", "B recompute", "B walk", "B output")
MAMBA_EDITS = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n" + CLOCK),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  const int j = tid % LANES;",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n" + START
     + "  const int j = tid % LANES;"),
    ("    stage(c * TB, false);\n    __syncthreads();\n",
     "    stage(c * TB, false);\n    __syncthreads();\n    PH(0);\n"),
    ("h[q] = __fmaf_rn(h[q], e, __fmul_rn(u, s_b[i * N + j * NL + q]));\n      }\n    }\n  }\n",
     "h[q] = __fmaf_rn(h[q], e, __fmul_rn(u, s_b[i * N + j * NL + q]));\n      }\n    }\n"
     "    PH(1);\n  }\n"),
    ("    stage(t0, true);\n    __syncthreads();\n",
     "    stage(t0, true);\n    __syncthreads();\n    PH(2);\n"),
    ("      }\n    }\n#pragma unroll\n    for (int i = TB - 1; i >= 0; --i) {",
     "      }\n    }\n    PH(3);\n#pragma unroll\n    for (int i = TB - 1; i >= 0; --i) {"),
    ("    __syncthreads();\n    for (int e = tid; e < n * CH; e += THREADS) {",
     "    __syncthreads();\n    PH(4);\n    for (int e = tid; e < n * CH; e += THREADS) {"),
    ("      part_bc[((row + t0 + i) * nblk + blockIdx.x) * 2 * N + slot] = acc;\n    }\n",
     "      part_bc[((row + t0 + i) * nblk + blockIdx.x) * 2 * N + slot] = acc;\n    }\n"
     "    PH(5);\n"),
    ("  if (live) {\n    store_vec(part_a + own, da);",
     _write("(blockIdx.y * gridDim.x + blockIdx.x)")
     + "  if (live) {\n    store_vec(part_a + own, da);"),
]


# the redesigned kernels (--new)
NEW_WKV_PHASES = ("staging wait", "sweep to half", "group 2, v.dy", "sweep, half 2",
                  "walk, half 2", "sweep, half 1", "walk, half 1")
NEW_WKV_EDITS = [
    ('#include "wkv6_chunk.cuh"\n', '#include "wkv6_chunk.cuh"\n' + CLOCK),
    ("  const int row = RL * pr_;  // this lane's first row in the CTA (and row + 1)\n",
     "  const int row = RL * pr_;  // this lane's first row in the CTA (and row + 1)\n" + START),
    ("  cp_async_wait<1>();  // the first group\n  __syncthreads();\n",
     "  cp_async_wait<1>();  // the first group\n  __syncthreads();\n  PH(0);\n"),
    ("  sweep(0, NKB / 2, false);\n", "  sweep(0, NKB / 2, false);\n  PH(1);\n"),
    ("  sweep(NKB / 2, NKB - 1, true);\n",
     "  PH(2);\n  sweep(NKB / 2, NKB - 1, true);\n  PH(3);\n"),
    ("      get_slot(KEEP);\n      sweep(0, NKB / 2 - 1, true);\n",
     "      PH(4);\n      get_slot(KEEP);\n      sweep(0, NKB / 2 - 1, true);\n      PH(5);\n"),
    ("  if (cg == 0)\n    *reinterpret_cast<float2*>(du_part",
     "  PH(6);\n" + _write("blockIdx.x")
     + "  if (cg == 0)\n    *reinterpret_cast<float2*>(du_part"),
]
NEW_MAMBA_PHASES = ("ring wait", "phase A", "recompute", "walk", "issue, stores")
NEW_MAMBA_EDITS = [
    ("#include <type_traits>\n", "#include <type_traits>\n" + CLOCK),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n" + START),
    ("    const int walked = compute(k);\n", "    PH(0);\n    const int walked = compute(k);\n"),
    ("      advance(b);\n      return -1;\n", "      advance(b);\n      PH(1);\n      return -1;\n"),
    ("    const int ob = walks & 1;", "    PH(2);\n    const int ob = walks & 1;"),
    ("    return sub;\n  };\n", "    PH(3);\n    return sub;\n  };\n"),
    ("    flush();\n    if (walked >= 0) {", "    flush();\n    PH(4);\n    if (walked >= 0) {"),
    ("  if (live) {\n    store_vec(part_a + own, da);",
     _write("(blockIdx.y * gridDim.x + blockIdx.x)")
     + "  if (live) {\n    store_vec(part_a + own, da);"),
]


def instrument(text: str, edits, src: str) -> str:
    """``text`` with each anchor replaced once; every anchor must be there."""
    for anchor, repl in edits:
        if text.count(anchor) != 1:
            raise SystemExit(f"{src}: {text.count(anchor)} copies of the anchor "
                             f"{anchor.strip()[:60]!r}; is --new right for this source?")
        text = text.replace(anchor, repl, 1)
    return text


def build(src: str, tag: str, edits=None, new=False) -> ctypes.CDLL:
    """``src`` (clocked by ``edits`` when given) built into
    build/repro_torch/phases/<tag>.so with the first versions' ctypes
    signatures set (the scan's C entry has kept
    them), or with ``new`` the redesigned WKV-6 entry's."""
    from repro_torch.kernels import _build

    out = _build.BUILD / "phases" / f"{tag}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    text = open(src).read()
    out.write_text(instrument(text, edits, src) if edits else text)
    lib_path = out.with_suffix(".so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           os.path.dirname(os.path.abspath(src)), "-o", str(lib_path), str(out)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {out}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("wkv6_bwd", "mamba_scan_bwd"):
        if hasattr(lib, name):
            more = int(new and name == "wkv6_bwd")  # the chunk states, the launches' count
            getattr(lib, name).restype = i32
            getattr(lib, name).argtypes = ([i32] + [ptr] * (15 + more) + [i32] * 4 + [ptr]
                                           + [ptr] * more)
            getattr(lib, f"{name}_scratch").restype = ctypes.c_longlong
            getattr(lib, f"{name}_scratch").argtypes = [i32] * (4 + more)
    if edits:
        lib.phase_cycles_read.restype = i32
        lib.phase_cycles_read.argtypes = [ptr, i32]
    lib.kernel_error_string.restype = ptr
    lib.kernel_error_string.argtypes = [i32]
    return lib


def wkv_inputs(dev, b, s, h, hd, dtype, seed=0):
    """r, k, v (dtype), w, u, dy as 15d makes them (no state, no ds_last)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    r, k, v = (randn(b, s, h, hd).mul_(0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, s, h, hd) - 1.0))
    return r, k, v, w, randn(h, hd).mul_(0.1), randn(b, s, h, hd)


def mamba_inputs(dev, b, s, d, n, dtype, seed=0):
    """dt, x (dtype), B, C, a, dy as 15d makes them (no state, no dh_last)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    dt = torch.nn.functional.softplus(randn(b, s, d).mul_(2.0).sub_(4.6))
    a = -torch.exp(torch.log(torch.arange(1, n + 1, device=dev, dtype=torch.float32))
                   + randn(d, n).mul_(0.1))
    return dt, randn(b, s, d).to(dtype), randn(b, s, n), randn(b, s, n), a, randn(b, s, d)


def old_wkv_bwd(lib, r, k, v, w, u, dy, s0=None, ds_last=None):
    """The first version's C entry, as its wrapper called it."""
    import torch

    from repro_torch.kernels import _build

    b, s, h, hd = r.shape
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    du = torch.zeros((h, hd), dtype=torch.float32, device=r.device)
    ds0 = None if s0 is None else torch.empty_like(s0)
    scratch = torch.empty(lib.wkv6_bwd_scratch(b, s, h, hd), dtype=torch.float32,
                          device=r.device)
    p = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    code = lib.wkv6_bwd(int(r.dtype == torch.bfloat16), p(r), p(k), p(v), p(w), p(u), p(s0),
                        p(dy), p(ds_last), p(dr), p(dk), p(dv), p(dw), p(du), p(ds0),
                        p(scratch), b, s, h, hd, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "wkv6_bwd (first version)")
    return dr, dk, dv, dw, du, ds0


def new_wkv_bwd(lib, r, k, v, w, u, dy, states):
    """The redesigned C entry from the forward's chunk states, as the
    training step's backward calls it (no s0, no ds_last)."""
    import torch

    from repro_torch.kernels import _build

    b, s, h, hd = r.shape
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    du = torch.zeros((h, hd), dtype=torch.float32, device=r.device)
    scratch = torch.empty(lib.wkv6_bwd_scratch(b, s, h, hd, 1), dtype=torch.float32,
                          device=r.device)
    p = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    code = lib.wkv6_bwd(int(r.dtype == torch.bfloat16), p(r), p(k), p(v), p(w), p(u), 0, p(dy),
                        0, p(states), p(dr), p(dk), p(dv), p(dw), p(du), 0, p(scratch), b, s, h,
                        hd, torch.cuda.current_stream().cuda_stream, None)
    _build.check(lib, code, "wkv6_bwd")
    return dr, dk, dv, dw, du


def old_mamba_bwd(lib, dt, x, bm, cm, a, dy, h0=None, dh_last=None):
    """The first version's C entry, as its wrapper called it."""
    import torch

    from repro_torch.kernels import _build

    bsz, s, d = dt.shape
    n = bm.shape[-1]
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc, da = torch.zeros_like(bm), torch.zeros_like(cm), torch.zeros_like(a)
    dh0 = None if h0 is None else torch.zeros_like(h0)
    scratch = torch.empty(lib.mamba_scan_bwd_scratch(bsz, s, d, n), dtype=torch.float32,
                          device=dt.device)
    p = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    code = lib.mamba_scan_bwd(int(x.dtype == torch.bfloat16), p(dt), p(x), p(bm), p(cm), p(a),
                              p(h0), p(dy), p(dh_last), p(ddt), p(dx), p(db), p(dc), p(da),
                              p(dh0), p(scratch), bsz, s, d, n,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "mamba_scan_bwd (first version)")
    return ddt, dx, db, dc, da, dh0


def split(lib, n_ctas: int, names) -> list[float]:
    """Each phase's share of a CTA's counted cycles, mean over the CTAs."""
    import numpy as np

    buf = (ctypes.c_longlong * (SLOTS * n_ctas))()
    code = lib.phase_cycles_read(ctypes.addressof(buf), n_ctas)
    if code:
        raise RuntimeError(f"phase_cycles_read: CUDA error {code}")
    cyc = np.frombuffer(buf, dtype=np.int64).reshape(n_ctas, SLOTS)[:, :len(names)]
    tot = cyc.sum(axis=1, keepdims=True).astype(np.float64)
    return list((cyc / tot).mean(axis=0)), float(tot.mean())


def main() -> int:
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc")
    ap.add_argument("--new", action="store_true", help="the redesigned kernels' phases")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssm_backward_phases: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda")
    wsrc = os.path.join(args.csrc, "wkv6_bwd.cu")
    msrc = os.path.join(args.csrc, "mamba_scan_bwd.cu")
    new = args.new
    libs = {"wkv": build(wsrc, "wkv6_bwd_plain", new=new),
            "wkv_clock": build(wsrc, "wkv6_bwd_clocked", NEW_WKV_EDITS if new else WKV_EDITS,
                               new=new),
            "mamba": build(msrc, "mamba_scan_bwd_plain"),
            "mamba_clock": build(msrc, "mamba_scan_bwd_clocked",
                                 NEW_MAMBA_EDITS if new else MAMBA_EDITS)}
    b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    version = "redesigned" if new else "first version"
    keeping = ", with the forward keeping its chunk states"
    if new:  # the clock is in the row walk; the forward's chunk states as the step keeps them
        from repro_torch.kernels import wkv6

        def wkv_call(lib, r, k, v, w, u, dy):
            states = torch.empty(wkv6.chunk_states_shape(r), device=r.device)
            wkv6.wkv6_cuda(r, k, v, w, u, chunk_states=states)
            return new_wkv_bwd(lib, r, k, v, w, u, dy, states)
        wkv_main, wkv_ctas = "rows_kernel", b * 64 * (s // 64) * 2
    else:
        wkv_call, wkv_main, wkv_ctas = old_wkv_bwd, "wkv6_bwd_kernel", b * 64
    for kind, call, make, shape, names, main_name, ctas in (
            ("wkv", wkv_call, wkv_inputs, (64, 64), NEW_WKV_PHASES if new else WKV_PHASES,
             wkv_main, wkv_ctas),
            ("mamba", old_mamba_bwd, mamba_inputs, (8192, 16),
             NEW_MAMBA_PHASES if new else MAMBA_PHASES, "mamba_scan_bwd_kernel",
             b * 8192 // 64)):
        for dtype in (torch.bfloat16, torch.float32):
            inputs = make(dev, b, s, *shape, dtype)
            plain_ms = cs.cuda_ms(lambda: call(libs[kind], *inputs), args.iters)
            clock_ms = cs.cuda_ms(lambda: call(libs[f"{kind}_clock"], *inputs), args.iters)
            torch.cuda.synchronize()
            shares, cycles = split(libs[f"{kind}_clock"], ctas, names)
            rows = cs.device_time_by_kernel(lambda: call(libs[kind], *inputs), expect=main_name)
            main_ms = sum(ms for key, ms, _ in rows if main_name in key)
            others = "; ".join(f"{key[:60]} {ms:.4f} ms" for key, ms, _ in rows
                               if main_name not in key)
            print(f"{kind} backward ({version}), B {b}, S {s}, {shape}, "
                  f"{str(dtype)[6:]}: {plain_ms:.4f} ms a call (CUDA events"
                  f"{keeping if new and kind == 'wkv' else ''}"
                  f"; clocked build {clock_ms:.4f}); device (torch.profiler): {main_name} "
                  f"{main_ms:.4f} ms; the other launches: {others}; a CTA's counted cycles "
                  f"{cycles:.4g} (mean of {ctas} CTAs)")
            for name, share in zip(names, shares):
                print(f"  {name:18s} {100 * share:5.1f}% of a CTA's cycles, "
                      f"{share * main_ms:.4f} ms of {main_name}")
            del inputs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
