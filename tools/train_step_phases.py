#!/usr/bin/env python3
"""Time each phase of the training kernel's persistent launch, in two
versions of ``src/repro_torch/csrc/train_step.cu``, on one card.

    python3 tools/train_step_phases.py OLD.cu

OLD.cu is an earlier ``train_step.cu`` with the persistent launch (the
"plan" or "prefix" interface of ``tools/compare_train_step.py``). A copy of
it and of the repository's file is built with a clock added: CTA 0 reads
``%globaltimer`` at the launch's start, after every grid sync and after each
phase's work list is built (with the phase's item count). On the cases of
``tools/compare_train_step.py`` (5 calls a version, in turns old, new, new,
old) it prints per case the launch's preamble (the mask statistics, and in
the prefix interface the step prefix sums), and for each phase of the step
plan the summed time of its work-list builds and of its items up to the
next grid sync, old against new, with its items summed over the steps. The clock
costs one global store a phase; times are means over the calls.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

CLOCK = r"""
__device__ unsigned long long phase_clock[2 * 16384];
__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(v) if (blockIdx.x == 0 && threadIdx.x == 0 && tick_ < 16384) { \
    phase_clock[2 * tick_] = clock_ns(); phase_clock[2 * tick_ + 1] = (long long)(v); ++tick_; }
extern "C" int phase_clock_read(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, phase_clock, sizeof(unsigned long long) * 2 * n);
}
"""
START, SYNC = -2, -1   # stamp kinds; a stamp >= 0 is a built work list's items


def instrument(src: str) -> str:
    """The text of ``src`` with the clock added (see the module docstring)."""
    text = open(src).read()
    anchors = ("#include <stdint.h>\n", "cg::grid_group grid = cg::this_grid();\n",
               "grid.sync();", "plan_phase(bk, p, step, ctas);")
    for a in anchors:
        if a not in text:
            raise SystemExit(f"{src}: no {a.strip()!r} to instrument")
    text = text.replace(anchors[0], anchors[0] + CLOCK, 1)
    text = text.replace(anchors[1], anchors[1] + f"  int tick_ = 0;\n  STAMP({START});\n", 1)
    text = text.replace(anchors[2], anchors[2] + f" STAMP({SYNC});")
    return text.replace(anchors[3], anchors[3] + " STAMP(bk.prefix[MAX_OPS]);")


def build(src: str, name: str) -> ctypes.CDLL:
    from compare_train_step import interface

    from repro_torch.kernels import _build

    out = _build.BUILD / "phases" / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(instrument(src))
    lib_path = out.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(out)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    kind = interface(src)
    lib.train_cycle_f32.restype = i32
    lib.train_cycle_f32.argtypes = (
        [ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        + ([ptr] if kind == "prefix" else []) + [ctypes.c_float, i32, ptr, i32, ptr])
    lib.phase_clock_read.restype = i32
    lib.phase_clock_read.argtypes = [ptr, i32]
    lib.kind = kind
    return lib


def phases(lib, n_phases: int) -> tuple[float, list[list[float]]]:
    """(preamble ns, per phase slot [build ns, items ns, items]) of the last
    launch of ``lib``."""
    import torch

    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (2 * 16384))()
    code = lib.phase_clock_read(buf, 16384)
    if code:
        raise SystemExit(f"phase_clock_read failed: {code}")
    stamps = []
    for i in range(16384):
        t, v = buf[2 * i], ctypes.c_longlong(buf[2 * i + 1]).value
        if t == 0 or (i and (v == START or t < stamps[-1][0])):
            break   # the end of this launch's stamps (an earlier launch's may follow)
        stamps.append((t, v))
    first = next(i for i, (_, v) in enumerate(stamps) if v >= 0)
    pre = stamps[first - 1][0] - stamps[0][0]
    slots = [[0.0, 0.0, 0.0] for _ in range(n_phases)]
    at = 0
    for i in range(first, len(stamps)):
        t, v = stamps[i]
        if v >= 0:
            slot = slots[at % n_phases]
            slot[0] += t - stamps[i - 1][0]
            slot[1] += stamps[i + 1][0] - t
            slot[2] += v
            at += 1
    return pre, slots


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("train_step_phases: no CUDA device", file=sys.stderr)
        return 1
    from compare_train_step import cases, train

    from repro_torch.kernels import train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    libs = {"old": build(sys.argv[1], "old"),
            "new": build(os.path.join(ROOT, "src/repro_torch/csrc/train_step.cu"), "new")}
    dev = torch.device("cuda")
    for name, disp, x, y, m, tau, max_tau, lr in cases(dev):
        n_phases = len(train_step._phase_plan(len(disp)))
        runs = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            lib = libs[which]
            train(lib, lib.kind, disp, x, y, m, tau, lr, max_tau)   # warm
            for _ in range(5 if x.shape[0] <= 2000 else 1):
                train(lib, lib.kind, disp, x, y, m, tau, lr, max_tau)
                runs[which].append(phases(lib, n_phases))
        print(f"{name}: K {x.shape[0]}, max_tau {max_tau}, {n_phases} phases a step")
        mean = {w: (sum(p for p, _ in r) / len(r),
                    [[sum(s[j][c] for _, s in r) / len(r) for c in range(3)]
                     for j in range(n_phases)]) for w, r in runs.items()}
        print(f"  preamble us: old {mean['old'][0] / 1e3:.2f}, new {mean['new'][0] / 1e3:.2f}")
        for j in range(n_phases):
            o, n = mean["old"][1][j], mean["new"][1][j]
            print(f"  phase {j}: work-list builds us old {o[0] / 1e3:.2f} new {n[0] / 1e3:.2f}; "
                  f"items to the sync us old {o[1] / 1e3:.2f} new {n[1] / 1e3:.2f} "
                  f"({(n[1] - o[1]) / 1e3:+.2f}); items {o[2]:.0f} / {n[2]:.0f}")
        tot = {w: mean[w][0] + sum(s[0] + s[1] for s in mean[w][1]) for w in mean}
        print(f"  launch us (clock): old {tot['old'] / 1e3:.1f}, new {tot['new'] / 1e3:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
