#!/usr/bin/env python3
"""Time the variants of the Mamba scan kernel, ``src/repro_torch/csrc/mamba_scan.cu``,
at the Jamba prefill shape on one card, each held to the step loop.

    python3 tools/mamba_variants.py [--variants l2t32,l4t16n64,...]
        [--source NAME=OLD.cu ...] [--near-one] [--sass NAME]

A variant is the source with its constants ``LANES`` (lanes a channel),
``TC`` (steps a chunk) and, optionally, ``THREADS`` (a CTA) set to other
values, named ``l<lanes>t<steps>[n<threads>]``; by default 1, 2 and 4
lanes at the source's chunk, and the source's lanes at 16 steps. Each is
written beside the build (``build/repro_torch/variants/``) and all are
compiled at once with the port's nvcc flags; ``--source`` adds another
file with the same C interface (an earlier ``mamba_scan.cu`` from ``git
show``, e.g. the first version, or one with a share of the exponentials on
the FMA pipes).

At the Jamba prefill shape (B 4, S 2048, d_inner 8192, 16 states; dt =
softplus(-4.6 + 2 z), a near the S4D init, as ``chip_smoke.py`` phase 10a
makes them) each variant runs with bf16 and float32 x and must hold y and
h_last within 1e-5 of max(1, max |plain|) of the step loop
``ref.mamba_scan_ref``. Times are CUDA events, the mean of
10 calls, taken twice, in one order and then in the reverse order, and the
lesser kept. Prints the card's name and power limit, the SFU floor (every
exponential one MUFU.EX2 at 16 a clock an SM at the card's highest SM
clock), one line a variant with its registers and spills from ptxas, and
exits non-zero if any misses the gate. ``--near-one`` also prints each
variant's distance from a float64 step loop at decays within 1e-6 of 1 with
a unit state over 2048 steps, beside the float32 step loop's, on the
inputs of the card test ``test_mamba_scan_kernel_near_one_holds_the_float64_loop``
(B 1, D 256; seeds ``NEAR_ONE_SEEDS``) and at the prefill width with a
state (B 4, D 8192, seed 0);
``--sass NAME`` prints the opcode counts of the loop over chunks of that
variant's bf16 N = 16 kernel for D a multiple of 8 (``cuobjdump -sass``).
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

GATE = 1e-5
ITERS = 10
SHAPE = (4, 2048, 8192, 16)                 # the Jamba prefill: B, S, d_inner, states
NEAR_ONE_SEEDS = (9, 10, 11, 12, 13)


def parse(name: str) -> dict[str, int]:
    m = re.fullmatch(r"l(\d+)t(\d+)(?:n(\d+))?", name)
    if not m:
        raise ValueError(f"not a variant name: {name}")
    consts = {"LANES": int(m[1]), "TC": int(m[2])}
    if m[3]:
        consts["THREADS"] = int(m[3])
    return consts


def variant_source(src: str, consts: dict[str, int]) -> str:
    for name, value in consts.items():
        src, hits = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                            src)
        if hits != 1:
            raise ValueError(f"mamba_scan.cu has no single constant {name}")
    return src


def build(sources: dict[str, str]) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile every named source at once; returns each library that built
    and the registers and spills ptxas reports for its N = 16 kernels."""
    from repro_torch.kernels import _build

    out = _build.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        src = out / f"mamba_scan-{name}.cu"
        src.write_text(text)
        lib = out / f"mamba_scan-{name}.so"
        jobs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                        str(src)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, path) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            errors = [line for line in log.splitlines() if "error" in line]
            print(f"{name}: does not build: {errors[:2]}", flush=True)
            continue
        lib = ctypes.CDLL(str(path))
        lib.mamba_scan_fwd.restype = ctypes.c_int
        lib.mamba_scan_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.kernel_error_string.restype = ctypes.c_void_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        libs[name] = (lib, ptxas_summary(log))
    return libs


def ptxas_summary(log: str) -> str:
    """'regs bf16/f32, spill bytes' of the kernels at N = 16 with D a
    multiple of 8 (the prefill's)."""
    found, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            current = (("bf16" if "bfloat16" in name else "f32")
                       if "mamba_scan_kernel" in name and "Li16E" in name and "Lb1E" in name
                       else None)
        elif current and "Used" in line:
            found[current] = re.search(r"Used (\d+) registers", line).group(1)
        elif current and "spill" in line:
            spills = re.findall(r"(\d+) bytes spill", line)
            if any(int(s) for s in spills):
                found[current + " spill"] = "+".join(spills)
    return ", ".join(f"{k} {v}" for k, v in sorted(found.items())) or "no ptxas report"


def sass_counts(name: str) -> str:
    """Opcode counts of the loop over chunks (the longest backward branch's
    span) of the variant's bf16 N = 16 kernel for D a multiple of 8, most
    frequent first, with the instructions there a MUFU.EX2."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    lib = _build.BUILD / "variants" / f"mamba_scan-{name}.so"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    code, inside = [], False                  # (address, opcode, branch target or None)
    for line in out.splitlines():
        if "Function :" in line:
            inside = all(k in line for k in ("mamba_scan_kernel", "bfloat16", "Li16E", "Lb1E"))
        elif inside:
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                            r"(?:\s+(0x[0-9a-f]+))?", line)
            if ins:
                code.append((int(ins[1], 16), ins[2], int(ins[3], 16) if ins[3] else None))
    back = [(at - target, target, at) for at, op, target in code
            if op == "BRA" and target is not None and target < at]
    if not back:
        return "no loop found"
    _, start, end = max(back)
    counts = {}
    for at, op, _ in code:
        if start <= at <= end:
            counts[op] = counts.get(op, 0) + 1
    total, mufu = sum(counts.values()), counts.get("MUFU.EX2", 0)
    ops = ", ".join(f"{k} {v}" for k, v in sorted(counts.items(), key=lambda kv: -kv[1]))
    return f"loop {total} instructions, {total / max(1, mufu):.2f} a MUFU.EX2: {ops}"


def call(lib, dt, x, b, c, a, y, h_last, h0=None):
    import torch

    from repro_torch.kernels import _build

    stream = torch.cuda.current_stream().cuda_stream
    code = lib.mamba_scan_fwd(int(x.dtype == torch.bfloat16), dt.data_ptr(), x.data_ptr(),
                              b.data_ptr(), c.data_ptr(), a.data_ptr(),
                              0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                              h_last.data_ptr(), dt.shape[0], dt.shape[1], dt.shape[2],
                              b.shape[-1], stream)
    _build.check(lib, code, "mamba_scan variant")


def inputs(b, s, d, n, dev, seed=0):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(randn(b, s, d).mul_(2.0).sub_(4.6))
    x = randn(b, s, d)
    bm, cm = randn(b, s, n), randn(b, s, n)
    a = -torch.exp(torch.log(torch.arange(1, n + 1, device=dev, dtype=torch.float32))
                   + randn(d, n).mul_(0.1))
    return dt, x, bm, cm, a


def near_one_inputs(b, s, d, n, seed, dev):
    """Decays within 1e-6 of 1 and a unit state, made as the card tests'
    ``_mamba_args(..., decays="near1")`` makes them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    rng.standard_normal((b, s, d))                         # the ordinary dt's draw
    dt = t(rng.uniform(1e-5, 1e-4, (b, s, d)))
    x = t(rng.standard_normal((b, s, d)))
    bm, cm = (t(rng.standard_normal((b, s, n))) for _ in range(2))
    rng.standard_normal((d, n))                            # the ordinary a's draw
    a = t(-rng.uniform(1e-3, 1e-2, (d, n)))
    h0 = t(rng.standard_normal((b, d, n)))
    return dt, x, bm, cm, a, h0


def near_one(libs, dev) -> None:
    """Each variant's distance from a float64 step loop at decays within
    1e-6 of 1 and a unit state over 2048 steps, beside the float32 loop's."""
    import torch

    from repro_torch.kernels import ref

    cases = [(1, 2048, 256, 16, seed) for seed in NEAR_ONE_SEEDS] + [(4, 2048, 8192, 16, 0)]
    print("near 1 with a state, S 2048, N 16: distance from a float64 step loop as a share "
          "of max(1, scale)", flush=True)
    for b, s, d, n, seed in cases:
        args = near_one_inputs(b, s, d, n, seed, dev)
        dt, x, bm, cm, a, h = (v.double() for v in args)
        want_y = torch.empty_like(dt)
        for t in range(s):
            h = (h * torch.exp(dt[:, t, :, None] * a)
                 + (dt[:, t] * x[:, t])[:, :, None] * bm[:, t, None, :])
            want_y[:, t] = torch.einsum("bdn,bn->bd", h, cm[:, t])

        def dist(got_y, got_h):
            return max((g.double() - w).abs().max().item() / max(1.0, w.abs().max().item())
                       for g, w in ((got_y, want_y), (got_h, h)))

        line = f"  B {b}, D {d}, seed {seed}: float32 step loop {dist(*ref.mamba_scan_ref(*args)):.3g}"
        y, h_last = torch.empty(b, s, d, device=dev), torch.empty(b, d, n, device=dev)
        for name, (lib, _) in libs.items():
            call(lib, *args[:5], y, h_last, args[5])
            torch.cuda.synchronize()
            line += f", {name} {dist(y, h_last):.3g}"
        print(line, flush=True)
        del want_y, h
        torch.cuda.empty_cache()


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0] if out else "not read"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", help="comma-separated variant names")
    parser.add_argument("--source", action="append", default=[],
                        help="NAME=PATH of another mamba_scan.cu to time beside them")
    parser.add_argument("--near-one", action="store_true")
    parser.add_argument("--sass", action="append", default=[])
    opts = parser.parse_args()
    b, s, d, n = SHAPE

    import torch

    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("mamba_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    text = open(os.path.join(ROOT, "src", "repro_torch", "csrc", "mamba_scan.cu")).read()
    own = {k: int(v) for k, v in re.findall(r"constexpr int (TC|LANES) = (\d+);", text)}
    names = (opts.variants.split(",") if opts.variants
             else [f"l{lanes}t{own['TC']}" for lanes in (1, 2, 4)] + [f"l{own['LANES']}t16"])
    sources = {}
    for spec in opts.source:
        name, path = spec.split("=", 1)
        sources[name] = open(path).read()
    sources.update({name: variant_source(text, parse(name)) for name in names})
    print(smi("name,power.limit"))
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    elements = b * s * d * n
    sfu_ms = 1e3 * elements / (16 * sms * clock_mhz * 1e6)
    nbytes = {dtype: (8 + torch.empty((), dtype=dtype).element_size()) * b * s * d
              + 8 * b * s * n + 4 * d * n + 4 * b * d * n
              for dtype in (torch.bfloat16, torch.float32)}
    print(f"shape B {b}, S {s}, D {d}, N {n}: {elements:.4g} exponentials; SFU floor "
          f"{sfu_ms:.4f} ms (16 MUFU.EX2 a clock an SM, {sms} SMs at {clock_mhz:.0f} MHz); "
          f"bytes bound {1e3 * nbytes[torch.bfloat16] / 3.35e12:.4f} ms bf16 x, "
          f"{1e3 * nbytes[torch.float32] / 3.35e12:.4f} f32 x (3.35 TB/s)", flush=True)
    libs = build(sources)
    dt, x32, bm, cm, a = inputs(b, s, d, n, dev)
    failed = False
    times = {name: {} for name in libs}
    errs = {name: {} for name in libs}
    for dtype in (torch.bfloat16, torch.float32):
        x = x32.to(dtype)
        want_y, want_h = ref.mamba_scan_ref(dt, x, bm, cm, a)
        y = torch.empty_like(want_y)
        h_last = torch.empty_like(want_h)
        for name, (lib, _) in libs.items():
            y.fill_(math.nan)
            call(lib, dt, x, bm, cm, a, y, h_last)
            torch.cuda.synchronize()
            errs[name][dtype] = max(
                (got - want).abs().max().item() / max(1.0, want.abs().max().item())
                for got, want in ((y, want_y), (h_last, want_h)))
            failed |= not errs[name][dtype] <= GATE
        del want_y, want_h
        order = list(libs)
        for turn in (order, order[::-1]):
            for name in turn:
                ms = cuda_ms(lambda: call(libs[name][0], dt, x, bm, cm, a, y, h_last), ITERS)
                times[name][dtype] = min(ms, times[name].get(dtype, math.inf))
        torch.cuda.empty_cache()
    for name, (_, regs) in libs.items():
        tb, tf = times[name][torch.bfloat16], times[name][torch.float32]
        print(f"{name:9s} bf16 x {tb:.4f} ms, f32 x {tf:.4f} ms; {sfu_ms / tb:.3f} of the SFU "
              f"floor (bf16); err {errs[name][torch.bfloat16]:.2g} / "
              f"{errs[name][torch.float32]:.2g} (<= {GATE}); registers {regs}", flush=True)
    if opts.near_one:
        near_one(libs, dev)
    for name in opts.sass:
        print(f"{name} SASS (bf16, N 16): {sass_counts(name)}", flush=True)
    best = min((k for k in libs if k in names), key=lambda k: times[k][torch.bfloat16])
    print(f"fastest bf16: {best} {times[best][torch.bfloat16]:.4f} ms; "
          f"{smi('name,power.limit,clocks.sm,power.draw,temperature.gpu')}")
    if failed:
        print("mamba_variants: FAILED: a variant missed the 1e-5 gate", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
