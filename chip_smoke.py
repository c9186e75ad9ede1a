#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel);
  2. ``fed_agg`` kernel vs its plain version at the paper model's leaf
     shapes (K = 10), with kernel, plain and ``torch.tensordot`` times;
  3. ``train_agg_step`` kernel vs its plain version (autograd) for one
     cycle at full width: the [784, 300, 124, 60, 10] MLP, K = 10 learners
     with the allocation ``solve_kkt_sai`` gives the paper's fleet;
  4. the main path, ``run_experiment(k=10, T=15, cycles=3)``, fused (through
     the kernels, launch counts checked) and eager (plain torch), compared.

It then prints one JSON line describing each kernel and, last, a JSON line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints neither.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): FP32 outside the tensor
# cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

FED_AGG_TOL = 1e-5      # max |kernel - plain| / max(1, max |plain|)
TRAIN_STEP_TOL = 1e-4   # per leaf: max |kernel - plain| / max |plain|
ACC_TOL = 0.005         # |fused - eager| accuracy on 2000 test samples (10 samples)
K, T_CYCLE, TOTAL, SEED, LR = 10, 15.0, 6000, 0, 0.1
CYCLES = 3


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up,
    from CUDA events on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_by_kernel(fn) -> list[tuple[str, float, int]]:
    """(kernel, device ms, launches) for one call of ``fn``, most time
    first, from ``torch.profiler``; empty if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, us / 1e3, ev.count))
    return sorted(rows, key=lambda r: -r[1])


def leaf_errors(got, want) -> tuple[float, float]:
    """(max abs error, max over leaves of max abs error / max |plain|)."""
    abs_err, rel_err = 0.0, 0.0
    for g_layer, w_layer in zip(got, want):
        for name in w_layer:
            g, w = g_layer[name].double(), w_layer[name].double()
            e = (g - w).abs().max().item()
            abs_err = max(abs_err, e)
            rel_err = max(rel_err, e / max(w.abs().max().item(), 1e-30))
    return abs_err, rel_err


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1

    import numpy as np

    from repro_torch.core import solve_kkt_sai, staleness_weights
    from repro_torch.data.pipeline import FederatedPartitioner, synthetic_mnist
    from repro_torch.fed.orchestrator import _broadcast, _stage_shards
    from repro_torch.fed.simulation import build_problem, run_experiment
    from repro_torch.kernels import _build, fed_agg, ref, train_step
    from repro_torch.models import mlp

    # the plain versions' matrix products stay in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. card and build ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s for {', '.join(_build.SOURCES)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- 2. fed_agg at the paper model's leaf shapes ----------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    widths = mlp.PAPER_LAYERS
    shapes = []
    for fi, fo in zip(widths[:-1], widths[1:]):
        shapes += [(K, fi, fo), (K, fo)]
    leaves = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    wts = torch.softmax(torch.randn(K, generator=gen, device=dev), 0)
    fa_err = 0.0
    for leaf in leaves:
        got = fed_agg.fed_agg_cuda(leaf, wts)
        want = ref.fed_agg_ref(leaf, wts)
        err = (got - want).abs().max().item()
        require(err <= FED_AGG_TOL * max(1.0, want.abs().max().item()),
                f"fed_agg kernel differs from its plain version by {err:g}")
        fa_err = max(fa_err, err)
    fa_ms = cuda_ms(lambda: [fed_agg.fed_agg_cuda(x, wts) for x in leaves], 200)
    fa_plain_ms = cuda_ms(lambda: [ref.fed_agg_ref(x, wts) for x in leaves], 200)
    fa_lib_ms = cuda_ms(lambda: [torch.tensordot(wts, x, dims=1) for x in leaves], 200)
    n_params = sum(math.prod(s[1:]) for s in shapes)
    fa_bytes = 4 * (K * n_params + n_params + K * len(shapes))
    fa_flops = 2 * K * n_params
    fa_bound_ms = 1e3 * max(fa_bytes / PEAK_BYTES_PER_S, fa_flops / PEAK_FP32_FLOPS)
    print(f"fed_agg: {len(shapes)} leaves, {n_params} params, max_abs_err "
          f"{fa_err:.3g}; kernel {fa_ms:.4f} ms, plain {fa_plain_ms:.4f} ms, "
          f"tensordot {fa_lib_ms:.4f} ms, bound {fa_bound_ms:.4f} ms (bytes)")

    # -- 3. train_agg_step for one cycle at full width --------------------------
    prob = build_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    alloc = solve_kkt_sai(prob)
    tau, d = np.asarray(alloc.tau), np.asarray(alloc.d)
    train, test = synthetic_mnist(max(2 * TOTAL, 12_000), seed=SEED)
    shards = FederatedPartitioner(train, seed=SEED).draw(d)
    x, y, m = (torch.from_numpy(a).to(dev)
               for a in _stage_shards(shards, int(d.max()), train.x.shape[1]))
    tau_t = torch.as_tensor(tau, dtype=torch.int32, device=dev)
    w_t = torch.as_tensor(staleness_weights(tau, d), dtype=torch.float32, device=dev)
    disp = _broadcast(mlp.init(SEED, device=dev), K)
    max_tau = int(tau.max())
    print(f"train_agg_step: x {tuple(x.shape)}, tau {tau.tolist()}, d {d.tolist()}")
    got = train_step.train_agg_step_cuda(disp, x, y, m, tau_t, w_t, LR, max_tau=max_tau)
    want = ref.train_agg_step_ref(disp, x, y, m, tau_t, w_t, LR, max_tau=max_tau)
    torch.cuda.synchronize()
    ts_abs, ts_rel = leaf_errors(got, want)
    require(all(torch.isfinite(t).all().item() for layer in got for t in layer.values()),
            "train_agg_step kernel gave non-finite params")
    require(ts_rel <= TRAIN_STEP_TOL,
            f"train_agg_step kernel differs from its plain version: {ts_rel:g} relative")
    # float32's own spread: both float32 versions against the plain version
    # in float64, after one step and after the whole cycle
    disp64 = [{n: leaf.double() for n, leaf in layer.items()} for layer in disp]
    for steps in (1, max_tau):
        tau_s = torch.clamp(tau_t, max=steps)
        k32 = train_step.train_agg_step_cuda(disp, x, y, m, tau_s, w_t, LR, max_tau=steps)
        p32 = ref.train_agg_step_ref(disp, x, y, m, tau_s, w_t, LR, max_tau=steps)
        p64 = ref.train_agg_step_ref(disp64, x.double(), y, m.double(), tau_s,
                                     w_t.double(), LR, max_tau=steps)
        print(f"train_agg_step after {steps} step(s), max relative (per leaf) to "
              f"float64: kernel {leaf_errors(k32, p64)[1]:.3g}, plain float32 "
              f"{leaf_errors(p32, p64)[1]:.3g}")
    ts_ms = cuda_ms(lambda: train_step.train_agg_step_cuda(
        disp, x, y, m, tau_t, w_t, LR, max_tau=max_tau), 5)
    ts_plain_ms = cuda_ms(lambda: ref.train_agg_step_ref(
        disp, x, y, m, tau_t, w_t, LR, max_tau=max_tau), 3)
    breakdown = device_time_by_kernel(lambda: train_step.train_agg_step_cuda(
        disp, x, y, m, tau_t, w_t, LR, max_tau=max_tau))
    busy = sum(ms for _, ms, _ in breakdown)
    print(f"train_agg_step device time by kernel (torch.profiler, one cycle): "
          f"{busy:.3f} ms busy of {ts_ms:.3f} ms" if breakdown else
          "train_agg_step device time by kernel: not measured (no device events)")
    for name, ms, calls in breakdown[:10]:
        print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")
    mats = list(zip(widths[:-1], widths[1:]))
    row_flops = 2 * (2 * sum(a * b for a, b in mats) + sum(a * b for a, b in mats[1:]))
    ts_flops = int((tau * d).sum()) * row_flops
    # inputs read once (x, y, m, tau, w, the K dispatched models), output written once
    ts_bytes = 4 * (x.numel() + y.numel() + m.numel() + 2 * K + K * n_params + n_params)
    ts_bound_ms = 1e3 * max(ts_flops / PEAK_FP32_FLOPS, ts_bytes / PEAK_BYTES_PER_S)
    print(f"train_agg_step: max_abs_err {ts_abs:.3g}, max relative (per leaf) "
          f"{ts_rel:.3g} <= {TRAIN_STEP_TOL}; kernel {ts_ms:.3f} ms, plain "
          f"{ts_plain_ms:.3f} ms, bound {ts_bound_ms:.3f} ms ({ts_flops:.4g} FP32 FLOPs)")

    # -- 4. the main path: run_experiment fused (kernels) and eager (plain) ----
    runs = {}
    for mode in ("fused", "eager"):
        if mode == "fused":
            fed_agg.launches = 0
            train_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[mode] = run_experiment(k=K, T=T_CYCLE, cycles=CYCLES, total_samples=TOTAL,
                                    seed=SEED, train=train, test=test,
                                    fused=(mode == "fused"))
        torch.cuda.synchronize()
        runs[mode]["ms_per_cycle"] = 1e3 * (time.perf_counter() - t0) / CYCLES
        if mode == "fused":
            launches = {"train_agg_step": train_step.launches, "fed_agg": fed_agg.launches}
    require(launches == {"train_agg_step": CYCLES, "fed_agg": CYCLES * 2 * len(mats)},
            f"the fused run's kernel launches were {launches}")
    fused_h, eager_h = runs["fused"]["history"], runs["eager"]["history"]
    acc_f = [h["accuracy"] for h in fused_h]
    acc_e = [h["accuracy"] for h in eager_h]
    for hf, he in zip(fused_h, eager_h):
        require(np.array_equal(hf["tau"], he["tau"]) and np.array_equal(hf["d"], he["d"]),
                "fused and eager runs allocated differently")
        require(np.array_equal(hf["tau"], tau) and np.array_equal(hf["d"], d),
                "run_experiment allocated differently from solve_kkt_sai")
    require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in acc_f + acc_e),
            f"accuracies out of range: {acc_f}, {acc_e}")
    require(max(abs(a - b) for a, b in zip(acc_f, acc_e)) <= ACC_TOL,
            f"fused {acc_f} and eager {acc_e} accuracies differ by more than {ACC_TOL}")
    require(acc_f[-1] > acc_f[0], f"accuracy did not rise: {acc_f}")
    print(f"run_experiment k={K} T={T_CYCLE} cycles={CYCLES}: fused accuracy {acc_f}, "
          f"eager {acc_e}; launches {launches}")
    print(f"run_experiment ms per cycle (staging and eval included): fused "
          f"{runs['fused']['ms_per_cycle']:.1f}, eager {runs['eager']['ms_per_cycle']:.1f}")

    kernels = [
        {"name": "train_agg_step", "route": "cuda",
         "source": "src/repro_torch/csrc/train_step.cu",
         "replaces": "src/repro/kernels/train_step.py:119",
         "launches": launches["train_agg_step"], "max_abs_err": ts_abs,
         "ms": ts_ms, "plain_ms": ts_plain_ms, "bound_ms": ts_bound_ms,
         "bound_by": "operations", "library_ms": None},
        {"name": "fed_agg", "route": "cuda",
         "source": "src/repro_torch/csrc/fed_agg.cu",
         "replaces": "src/repro/kernels/fed_agg.py:30",
         "launches": launches["fed_agg"], "max_abs_err": fa_err,
         "ms": fa_ms, "plain_ms": fa_plain_ms, "bound_ms": fa_bound_ms,
         "bound_by": "bytes", "library_ms": fa_lib_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
