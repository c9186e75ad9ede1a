#!/usr/bin/env python3
"""Hold attention's kernels (``src/repro_torch/csrc/flash_attention.cu`` and
``flash_attention_bwd.cu``) to earlier versions of the same files, on one
card.

    python3 tools/compare_flash_attention.py OLD_CSRC [--iters N]

OLD_CSRC is an earlier ``csrc/`` directory (the two sources and the
headers they include), e.g. that of a ``git archive`` of an earlier commit.
Both versions are built with the port's nvcc flags (their ptxas lines are
printed) and run on the same inputs:

- the forward at the shapes below, bf16 and float32: the outputs and the
  log-sum-exps of the two versions must be equal bitwise;
- the backward at ``chip_smoke.py`` phase 15a's shapes: each version's
  gradients are held to the dense plain backward as phase 15a holds them
  (``BWD_TOL`` of a gradient's scale), and both are timed in turns, old,
  new, new, old (CUDA events, the mean of ``--iters`` calls after a
  warm-up); the new version's passes (row pass, dK/dV, dQ) are timed apart
  with ``torch.profiler`` at the first shape.

Prints one line a case and exits non-zero if any check fails.
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

# name, B, Sq, heads, kv heads, d, causal, window, Skv
FWD_CASES = [
    ("llama3.2-3b prefill", 4, 2048, 24, 8, 128, True, None, 2048),
    ("d80, window 40", 1, 2048, 32, 8, 80, True, 40, 2048),
    ("whisper-small encoder", 8, 1500, 12, 12, 64, False, None, 1500),
    ("whisper-small cross", 8, 64, 12, 12, 64, False, None, 1500),
    ("ragged causal", 2, 1000, 6, 2, 128, True, None, 1000),
]


def build(src: str, tag: str) -> ctypes.CDLL:
    """``src`` built into build/repro_torch/compare/<tag>.so with its
    ctypes signatures set; prints ptxas's register and spill lines."""
    from repro_torch.kernels import _build

    out = _build.BUILD / "compare" / f"{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    entry = None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            print(f"  {tag} {entry}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "flash_attention_fwd"):
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_fwd.argtypes = [i32] + [ptr] * 4 + [i32] * 8 + [ptr] * 2
    if hasattr(lib, "flash_attention_bwd"):
        lib.flash_attention_bwd.restype = i32
        lib.flash_attention_bwd.argtypes = [i32] + [ptr] * 10 + [i32] * 8 + [ptr]
    lib.kernel_error_string.restype = ptr
    lib.kernel_error_string.argtypes = [i32]
    return lib


def forward(lib, q, k, v, causal, window):
    import torch

    from repro_torch.kernels import _build

    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    code = lib.flash_attention_fwd(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                                   v.data_ptr(), out.data_ptr(), b, sq, k.shape[1], h,
                                   k.shape[2], d, int(causal), int(window or 0), lse.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "flash_attention_fwd")
    return out, lse


def backward(lib, q, k, v, out, lse, do, causal, window):
    import torch

    from repro_torch.kernels import _build

    b, sq, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    code = lib.flash_attention_bwd(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                                   v.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                   delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), b, sq, k.shape[1], h, k.shape[2], d,
                                   int(causal), int(window or 0),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "flash_attention_bwd")
    return dq, dk, dv


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ref

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_csrc")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_flash_attention: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    libs = {tag: build(os.path.join(d, f"{name}.cu"), tag)
            for tag, d, name in (("old_fwd", args.old_csrc, "flash_attention"),
                                 ("new_fwd", str(_build.CSRC), "flash_attention"),
                                 ("old_bwd", args.old_csrc, "flash_attention_bwd"),
                                 ("new_bwd", str(_build.CSRC), "flash_attention_bwd"))}
    failed = []

    for name, b, s, h, kvh, d, causal, window, skv in FWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(s + d)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, s, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))
            old = forward(libs["old_fwd"], q, k, v, causal, window)
            new = forward(libs["new_fwd"], q, k, v, causal, window)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(old, new))
            print(f"forward {name} {str(dtype)[6:]}: out and lse "
                  f"{'bitwise equal' if same else 'DIFFER'}")
            if not same:
                failed.append(f"forward {name} {dtype}")

    for i, (name, b, s, h, kvh, d, dtype, causal, window, skv, _) in enumerate(cs.BWD_CASES):
        dtype = getattr(torch, dtype)
        skv = s if skv is None else skv
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7 * s + d)
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, s, h, d), (b, skv, kvh, d), (b, skv, kvh, d),
                                     (b, s, h, d)))
        out, lse = forward(libs["new_fwd"], q, k, v, causal, window)
        kw = dict(causal=causal, window=window)
        want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), do.float(), **kw)
        floor = 1e-3 * do.float().abs().max().item() * v.float().abs().max().item()
        tol = cs.BWD_TOL[str(dtype)[6:]]
        errs = {}
        for tag in ("old_bwd", "new_bwd"):
            got = backward(libs[tag], q, k, v, out, lse, do, causal, window)
            torch.cuda.synchronize()
            errs[tag] = max((g.float() - w).abs().max().item() / max(w.abs().max().item(), floor)
                            for g, w in zip(got, want))
            if not errs[tag] <= tol:
                failed.append(f"backward {name} {dtype} {tag}: {errs[tag]:g} > {tol}")
        del want
        ms = {"old_bwd": [], "new_bwd": []}
        for tag in ("old_bwd", "new_bwd", "new_bwd", "old_bwd"):
            ms[tag].append(cs.cuda_ms(lambda: backward(libs[tag], q, k, v, out, lse, do,
                                                       causal, window), args.iters))
        print(f"backward {name}: B {b}, S {s}{'' if skv == s else f' against Skv {skv}'}, "
              f"{h}/{kvh} heads, d {d}, {str(dtype)[6:]}, causal {causal}, window {window}: "
              f"error of scale old {errs['old_bwd']:.3g}, new {errs['new_bwd']:.3g} "
              f"(<= {tol}); ms old {ms['old_bwd'][0]:.4f} {ms['old_bwd'][1]:.4f}, new "
              f"{ms['new_bwd'][0]:.4f} {ms['new_bwd'][1]:.4f} (turns old, new, new, old)")
        if i == 0:
            rows = cs.device_time_by_kernel(
                lambda: backward(libs["new_bwd"], q, k, v, out, lse, do, causal, window),
                expect="dkdv_kernel")
            for kname, kms, calls in rows:
                print(f"  new passes: {kms:8.4f} ms {calls:3d} x {kname[:100]}")
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()

    for f in failed:
        print(f"FAILED: {f}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
