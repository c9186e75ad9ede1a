#!/usr/bin/env python3
"""Time the WKV-6 step kernel against the chunk kernel of
``src/repro_torch/csrc/wkv6.cu`` over sequence lengths, on one card, to
place ``wkv6_fwd``'s threshold (``CHUNKED_MIN_SEQ``).

    python3 tools/wkv6_threshold.py [--lengths 1,8,16,32,48,64,96,128,256] [--batches 4]

At the RWKV-6 7B shape (B 4, 64 heads of 64, a state given, as the serve's
decode and a prefill given a cache call it; ``--batches`` takes other B,
e.g. 1 to see one CTA's time alone on an SM) each length runs both kernels
in bf16 and float32, forced through ``wkv6_cuda(kernel=...)``, and holds
each to the step loop ``ref.wkv6_ref`` at 1e-5 of max(1, max |plain|)
(the card tests' gate). Each kernel's time is its device time by
``torch.profiler`` over 20 calls, taken in turns (step, chunk, chunk,
step) and averaged; beside it the CUDA-event time a call over 50 calls,
which at short lengths is the host's time to issue the call (the same for
both). Prints the card's name and power limit, one line a length and
dtype, and the shortest length from which the chunk kernel's device time
is the lower in both dtypes. Exits non-zero if a kernel misses the gate.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

B, H, HD = 4, 64, 64
GATE = 1e-5
ITERS = 50


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


def device_ms(fn, name: str, calls: int = 20) -> float:
    """Device time a launch of the kernel whose name holds ``name``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [(e.self_device_time_total, e.count) for e in prof.key_averages() if name in e.key]
    return sum(us for us, _ in hits) / 1e3 / max(1, sum(n for _, n in hits))


def inputs(b: int, s: int, dtype, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(s)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    r, k, v = (t(rng.standard_normal((b, s, H, HD)) * 0.5).to(dtype) for _ in range(3))
    w = t(np.exp(-np.exp(rng.standard_normal((b, s, H, HD)) - 1.0)))
    u = t(rng.standard_normal((H, HD)) * 0.1)
    s0 = t(rng.standard_normal((b, H, HD, HD)) * 0.1)
    return r, k, v, w, u, s0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lengths", default="1,8,16,32,48,64,96,128,256")
    parser.add_argument("--batches", default=str(B))
    args_ = parser.parse_args()
    lengths = [int(x) for x in args_.lengths.split(",")]
    batches = [int(x) for x in args_.batches.split(",")]

    import torch

    from repro_torch.kernels import ref, wkv6

    if not torch.cuda.is_available():
        print("wkv6_threshold: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0))
    failed, faster = False, {}
    for b, s in ((b, s) for b in batches for s in lengths):
        for dtype in (torch.bfloat16, torch.float32):
            args = inputs(b, s, dtype, dev)
            want = ref.wkv6_ref(*args)
            errs = {}
            for kernel in ("step", "chunked"):
                got = wkv6.wkv6_cuda(*args, kernel=kernel)
                errs[kernel] = max((g - p).abs().max().item() / max(1.0, p.abs().max().item())
                                   for g, p in zip(got, want))
                failed |= errs[kernel] > GATE
            dev_ms = {"step": [], "chunked": []}
            ev_ms = {"step": [], "chunked": []}
            names = {"step": "wkv6_kernel", "chunked": "chunk_kernel"}
            for kernel in ("step", "chunked", "chunked", "step"):
                call = lambda: wkv6.wkv6_cuda(*args, kernel=kernel)
                dev_ms[kernel].append(device_ms(call, names[kernel]))
                ev_ms[kernel].append(cuda_ms(call, ITERS))
            step_ms, chunk_ms = (sum(dev_ms[k_]) / 2 for k_ in ("step", "chunked"))
            step_ev, chunk_ev = (sum(ev_ms[k_]) / 2 for k_ in ("step", "chunked"))
            if b == batches[0]:
                faster.setdefault(s, []).append(chunk_ms < step_ms)
            print(f"B {b} S {s:5d} {str(dtype).removeprefix('torch.'):8s} device: step "
                  f"{step_ms:.4f} ms, chunk {chunk_ms:.4f} ms; CUDA events a call: step "
                  f"{step_ev:.4f} ms, chunk {chunk_ev:.4f} ms; err step {errs['step']:.2g}, "
                  f"chunk {errs['chunked']:.2g}", flush=True)
    wins = [s for s in lengths if all(faster[x] == [True, True] for x in lengths if x >= s)]
    print(f"chunk kernel's device time lower in both dtypes from S = "
          f"{wins[0] if wins else 'none'} at B {batches[0]} "
          f"(CHUNKED_MIN_SEQ = {wkv6.CHUNKED_MIN_SEQ})")
    if failed:
        print("wkv6_threshold: FAILED: a kernel missed the 1e-5 gate", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
