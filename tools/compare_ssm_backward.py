#!/usr/bin/env python3
"""Hold the WKV-6 and Mamba-scan backward kernels (``src/repro_torch/csrc/
wkv6_bwd.cu`` and ``mamba_scan_bwd.cu``) and the WKV-6 forward to earlier
versions of the same files, on one card.

    python3 tools/compare_ssm_backward.py OLD_CSRC [--iters N] [--only wkv6|mamba_scan]

OLD_CSRC is an earlier ``csrc/`` directory whose two backward sources are
the first versions (one CTA a (b, h) or a channel block walking the whole
sequence from checkpoints, ``tools/ssm_backward_phases.py``'s interface)
and whose ``wkv6.cu`` is a self-contained forward, e.g. that of a ``git
archive`` of an earlier commit. The old sources are built with the port's
nvcc flags; the new ones are the package's own build.

- The WKV-6 forward, old against new, bf16 and float32 at the training
  shape and a ragged one: y and s_last must be bitwise equal, with and
  without the new forward's chunk-state output.
- Each backward at ``chip_smoke.py`` 15d's shapes: both versions' gradients
  held to the written-out plain backward (``ref.wkv6_bwd_ref`` /
  ``ref.mamba_scan_bwd_ref``) within 15d's ``SSM_BWD_TOL`` of a gradient's
  scale (at least 1e-3 max |dy|), then timed in turns, old, new, new, old
  (CUDA events, the mean of ``--iters`` calls after a warm-up). The new
  WKV-6 backward is timed as the training step runs it (from the forward's
  chunk states) with the forward's cost of writing them added (the forward
  with and without the output, timed in the same turns), and alone (its own
  chunk-state run); its launches are split by ``torch.profiler``.

Prints the card, one line a case, and exits non-zero if any check fails.
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
sys.path.insert(0, os.path.join(ROOT, "tools"))

# name, B, S, heads, hd (WKV) or d_inner, d_state (scan)
WKV_SHAPES = [("rwkv6-7b train", 4, 2048, 64, 64), ("ragged 1001", 4, 1001, 64, 64)]
MAMBA_SHAPES = [("jamba train", 4, 2048, 8192, 16), ("ragged 1001", 4, 1001, 8192, 16)]


def old_forward_lib(src: str):
    """The old ``wkv6.cu`` built with its own signature (no chunk states)."""
    from repro_torch.kernels import _build

    out = _build.BUILD / "compare" / "wkv6_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    import chip_smoke as cs

    for kname, line in cs.ptxas_entries(proc.stdout + proc.stderr):
        if "chunk" in kname:
            print(f"  old wkv6.cu {kname}: {line}")
    lib = ctypes.CDLL(str(out))
    lib.wkv6_fwd.restype = ctypes.c_int
    lib.wkv6_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def old_forward(lib, r, k, v, w, u, s0=None):
    import torch

    from repro_torch.kernels import _build

    b, s, h, hd = r.shape
    y = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    s_last = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    code = lib.wkv6_fwd(int(r.dtype == torch.bfloat16), r.data_ptr(), k.data_ptr(),
                        v.data_ptr(), w.data_ptr(), u.data_ptr(),
                        0 if s0 is None else s0.data_ptr(), y.data_ptr(), s_last.data_ptr(),
                        b, s, h, hd, torch.cuda.current_stream().cuda_stream, None)
    _build.check(lib, code, "wkv6_fwd (old)")
    return y, s_last


def held(got, want, floor, tol_of) -> float:
    """The largest error of a gradient against its plain one as a share of
    its tolerance times its scale (<= 1 passes)."""
    worst = 0.0
    for g, p in zip(got, want):
        if p is None:
            continue
        scale = max(p.float().abs().max().item(), floor)
        err = (g.float() - p.float()).abs().max().item()
        worst = max(worst, err / (tol_of(g.dtype) * scale))
    return worst


def main() -> int:
    import torch

    import chip_smoke as cs
    import ssm_backward_phases as ph
    from repro_torch.kernels import _build, mamba_scan, ref, wkv6

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_csrc")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--only", choices=("wkv6", "mamba_scan"), help="one kernel's cases alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_ssm_backward: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda")
    _build.build_all()
    old = {"wkv": ph.build(os.path.join(args.old_csrc, "wkv6_bwd.cu"), "wkv6_bwd_old"),
           "mamba": ph.build(os.path.join(args.old_csrc, "mamba_scan_bwd.cu"),
                             "mamba_scan_bwd_old"),
           "fwd": old_forward_lib(os.path.join(args.old_csrc, "wkv6.cu"))}
    tol_of = lambda dtype: cs.SSM_BWD_TOL[str(dtype).removeprefix("torch.")]  # noqa: E731
    failed = []

    for name, b, s, h, hd in WKV_SHAPES if args.only != "mamba_scan" else ():
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"wkv6 {name} {str(dtype)[6:]}"
            r, k, v, w, u, dy = ph.wkv_inputs(dev, b, s, h, hd, dtype, seed=s + hd)
            states = torch.empty(wkv6.chunk_states_shape(r), device=dev)
            fwd_old = old_forward(old["fwd"], r, k, v, w, u)
            fwd_new = wkv6.wkv6_cuda(r, k, v, w, u)
            fwd_kept = wkv6.wkv6_cuda(r, k, v, w, u, chunk_states=states)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) and torch.equal(a, e)
                       for a, c, e in zip(fwd_old, fwd_new, fwd_kept))
            if not same:
                failed.append(f"{tag}: the forward's y or s_last differ from the old kernel's")
            del fwd_old, fwd_new, fwd_kept
            plain = ref.wkv6_bwd_ref(r, k, v, w, u, dy)
            floor = 1e-3 * dy.abs().max().item()
            errs = {"old": held(ph.old_wkv_bwd(old["wkv"], r, k, v, w, u, dy), plain, floor,
                                tol_of),
                    "new": held(wkv6.wkv6_bwd_cuda(r, k, v, w, u, dy, chunk_states=states),
                                plain, floor, tol_of)}
            del plain
            for key, e in errs.items():
                if not e <= 1.0:
                    failed.append(f"{tag}: the {key} backward at {e:.3g} of its tolerance")
            calls = {
                "old": lambda: ph.old_wkv_bwd(old["wkv"], r, k, v, w, u, dy),
                "new": lambda: wkv6.wkv6_bwd_cuda(r, k, v, w, u, dy, chunk_states=states),
                "alone": lambda: wkv6.wkv6_bwd_cuda(r, k, v, w, u, dy),
                "fwd": lambda: wkv6.wkv6_cuda(r, k, v, w, u),
                "fwd_kept": lambda: wkv6.wkv6_cuda(r, k, v, w, u, chunk_states=states),
                "fwd_old": lambda: old_forward(old["fwd"], r, k, v, w, u),
            }
            ms = {key: [] for key in calls}
            for turn in ("old", "new", "new", "old"):
                keys = (("old", "fwd_old") if turn == "old"
                        else ("new", "alone", "fwd", "fwd_kept"))
                for key in keys:
                    ms[key].append(cs.cuda_ms(calls[key], args.iters))
            extra = [kept - plain_f for kept, plain_f in zip(ms["fwd_kept"], ms["fwd"])]
            total = [n + e for n, e in zip(ms["new"], extra)]
            print(f"{tag}: B {b}, S {s}, {h} heads of {hd}: forward bitwise old/new/with states "
                  f"{same}; error share of SSM_BWD_TOL old {errs['old']:.3g}, new "
                  f"{errs['new']:.3g}; ms (turns old, new, new, old): old "
                  f"{ms['old'][0]:.4f} {ms['old'][1]:.4f}; new from the forward's states "
                  f"{ms['new'][0]:.4f} {ms['new'][1]:.4f}, + the forward's state output "
                  f"{extra[0]:.4f} {extra[1]:.4f} = {total[0]:.4f} {total[1]:.4f}; new alone "
                  f"{ms['alone'][0]:.4f} {ms['alone'][1]:.4f}; forward old "
                  f"{ms['fwd_old'][0]:.4f} {ms['fwd_old'][1]:.4f}, new {ms['fwd'][0]:.4f} "
                  f"{ms['fwd'][1]:.4f}, with states {ms['fwd_kept'][0]:.4f} "
                  f"{ms['fwd_kept'][1]:.4f}")
            if name == WKV_SHAPES[0][0]:
                for key in ("new", "alone"):
                    rows = cs.device_time_by_kernel(calls[key], expect="rows_kernel")
                    for kname, kms, n in rows:
                        print(f"  {key} launches: {kms:8.4f} ms {n:3d} x {kname[:110]}")
            del r, k, v, w, u, dy, states
            torch.cuda.empty_cache()

    for name, b, s, d, n in MAMBA_SHAPES if args.only != "wkv6" else ():
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"mamba_scan {name} {str(dtype)[6:]}"
            dt, x, bm, cm, a, dy = ph.mamba_inputs(dev, b, s, d, n, dtype, seed=s + n)
            plain = ref.mamba_scan_bwd_ref(dt, x, bm, cm, a, dy)
            floor = 1e-3 * dy.abs().max().item()
            calls = {"old": lambda: ph.old_mamba_bwd(old["mamba"], dt, x, bm, cm, a, dy),
                     "new": lambda: mamba_scan.mamba_scan_bwd_cuda(dt, x, bm, cm, a, dy)}
            errs = {key: held(call(), plain, floor, tol_of) for key, call in calls.items()}
            del plain
            for key, e in errs.items():
                if not e <= 1.0:
                    failed.append(f"{tag}: the {key} backward at {e:.3g} of its tolerance")
            ms = {key: [] for key in calls}
            for turn in ("old", "new", "new", "old"):
                ms[turn].append(cs.cuda_ms(calls[turn], args.iters))
            print(f"{tag}: B {b}, S {s}, D {d}, N {n}: error share of SSM_BWD_TOL "
                  + ", ".join(f"{key} {e:.3g}" for key, e in errs.items())
                  + "; ms (turns old, new, new, old): "
                  + ", ".join(f"{key} {v[0]:.4f} {v[1]:.4f}" for key, v in ms.items()))
            if name == MAMBA_SHAPES[0][0]:
                rows = cs.device_time_by_kernel(calls["new"], expect="mamba")
                for kname, kms, cnt in rows:
                    print(f"  new launches: {kms:8.4f} ms {cnt:3d} x {kname[:110]}")
            del dt, x, bm, cm, a, dy
            torch.cuda.empty_cache()

    for f in failed:
        print(f"FAILED: {f}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
