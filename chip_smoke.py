#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel);
  2. ``fed_agg`` kernel vs its plain version at the paper model's leaf
     shapes (K = 10): all 8 leaves in one launch, each bitwise the
     single-leaf launch's, timed against one launch a leaf, the plain
     version and the 8 ``torch.tensordot`` calls;
  3. ``train_agg_step`` kernel vs its plain version (autograd) for one
     cycle at full width: the [784, 300, 124, 60, 10] MLP, K = 10 learners
     with the allocation ``solve_kkt_sai`` gives the paper's fleet; the
     cycle's device kernels by ``torch.profiler``, with exactly one launch of
     the persistent training kernel;
  4. the main path, ``run_experiment(k=10, T=15, cycles=3)``, fused (through
     the kernels, launch counts checked) and eager (plain torch), compared,
     and the fused run again, warm;
  5. the reallocation path:
     a. ``waterfill_residual`` kernel vs its plain version on a fleet-scale
        batch (the paper's 8-learner fleet under ``CapacityDrift(seed=0)``
        over 131,072 cycles, one problem a cycle), at tau* = 0, the solved
        tau* and 2 tau*, in float64 and float32, with kernel, plain and
        bound times;
     b. ``solve_kkt_batched`` of that batch on the card against the CPU,
        with the card's time split into bisection, integerize and SAI;
     c. ``run_experiment(k=10, T=15, cycles=3, reallocate=True)`` under
        ``CapacityDrift(seed=0)`` and ``QueueDrift(base=CapacityDrift(seed=0))``,
        fused and eager, with its rows held to the CPU solver's;
  6. the async path:
     a. ``accum_flush`` kernel vs its plain version at the paper model's
        leaf shapes (K = 10), in the three flush cases (accumulate only, a
        buffered flush, a fedasync mix), with kernel, plain, bound and
        ``torch.tensordot`` (the accumulate's contraction) times;
     b. one async group step (training + ``accum_flush``) at full width vs
        its plain version: the buffered run's widest flush group (one
        training-kernel launch a call, by ``torch.profiler``), and the
        fedasync shape (one learner trains, nine sit at tau = 0) dense
        against the same step over one slot;
     c. ``run_async_experiment(k=10, T=15, cycles=3, CapacityDrift(seed=0),
        reallocate=True)`` in fedasync and buffered (M = 5), grouped
        (``bucketed=True``, through the kernels) and eager (plain torch), with
        rows held to each other and to the CPU schedule's, every launch
        count held exactly, and ms per aggregation; fedasync again with
        ``seg_batch=1``;
  7. the energy and churn paths:
     a. ``waterfill_energy_residual`` kernel vs its plain version on phase
        5's fleet-scale batch with the energy rows of
        ``build_energy_problem(8, 15.0, seed=0)`` and a budget of 0.75 x
        the median spend of the blind ``kkt_sai`` allocation, at tau* = 0,
        the solved tau* and 2 tau*, in float64 and float32, with kernel,
        plain and bound times; at eb = +inf it must give the time-only
        kernel's output bitwise, and NaN fleets (e2 = e1 = 0, eb = e0)
        must sit where the plain version's do;
     b. ``solve_energy_batched`` of that batch on the card against the CPU,
        with zero budget violations and the card's split;
     c. ``run_async_experiment(k=10, T=15, cycles=3, scheme="kkt_energy",
        reallocate=True)`` on ``build_energy_problem`` with that budget
        under ``BatteryDrift(base=CapacityDrift(seed=0))``, fedasync and
        buffered (M = 5), grouped and eager, with rows and the energy
        ledger held to a CPU-built schedule, zero violations and every
        launch count exact;
     d. churn: the buffered run under ``MarkovAvailability(p_drop=0.2,
        base=CapacityDrift(seed=0))`` with ``churn_sweep``'s fault mix,
        grouped, its masks, rows and counters held to the CPU's;
     e. budgeted ``pgd`` on the card: ``solve_policy_row("pgd", ...)`` on
        three drifted rows of phase 7c's budgeted fleet (one energy
        water-filling a re-solve, counted) and the per-problem
        ``solve_pgd_jax`` that a run with ``scheme="pgd"`` starts from,
        each held to its budget and compared with the CPU's;
  8. the dense serving path (Llama-3.2-3B at full width):
     a. ``flash_attention`` kernel vs its plain version at the prefill
        shapes of Llama-3.2-3B (B 4, S 2048, 24/8 heads, d 128, causal, bf16
        and float32), a ragged S = 1000, and H2O-Danube-1.8B (B 1, S 8192,
        32/8 heads, d 80, window 4096, bf16), with kernel, plain, bound and
        ``scaled_dot_product_attention`` times and TFLOP/s; each bf16 case
        also against the float32 kernel on the widened inputs (within one
        bf16 step of the output's scale);
     b. the serve: ``Model(get_config("llama3.2-3b"))`` with weights drawn
        from the seed, ``serve.prefill`` of 4 x 2048 tokens and
        ``serve.decode`` of 31 greedy steps, through the kernel (28 launches
        in the prefill, none in decode, every other kernel none), init,
        prefill and decode times and peak memory; the prefill's
        last-position logits held to the same prefill with
        ``ops.flash_attention`` bound to the plain chunked scan (in this
        script only, ``plain_attention``), greedy agreement printed;
     c. the same width in float32 at 2 layers, kernel vs plain: logits
        within 1e-4 of their scale, 16 greedy decode steps equal;
  9. the RWKV-6 serving path (RWKV-6 "Finch" 7B at full width):
     a. ``wkv6`` kernel vs its plain version, the step loop
        ``ref.wkv6_ref``, at the prefill shape (B 4, S 2048, 64 heads of 64,
        bf16 and float32 r/k/v, no starting state), a ragged S = 1000 with a
        starting state, and the decode shape (S = 1) writing the state over a
        copy of its own s0, with kernel, plain and bound times (no single
        PyTorch call computes this function);
     b. the serve: ``Model(get_config("rwkv6-7b"))`` with weights drawn from
        the seed (32 layers, d 4096, 7,576,621,056 parameters, bf16),
        ``serve.prefill`` of 4 x 2048 tokens and ``serve.decode`` of 31
        greedy steps, through the kernel (32 launches in the prefill, 32 a
        decode step, every other kernel none), init, prefill and decode
        times, idle shares and peak memory; the prefill's last-position
        logits held to the same prefill with ``ops.wkv6`` bound to the step
        loop (in this script only, ``plain_wkv``), greedy agreement printed;
     c. the same width in float32 at 2 layers, kernel vs plain: logits
        within 1e-4 of their scale, 16 greedy decode steps equal;
 10. the hybrid serving path (Jamba v0.1 at full width, one period):
     a. ``mamba_scan`` kernel vs its plain version, the step loop
        ``ref.mamba_scan_ref``, at the prefill shape (B 4, S 2048, d_inner
        8192, 16 states, bf16 and float32 x, no starting state), a ragged
        S = 1000 with a starting state, and S = 1000 writing the state over
        a copy of its own h0, with kernel, plain and bound times (no single
        PyTorch call computes this function);
     b. the serve: ``Model`` of ``jamba-v0.1-52b`` cut to one 8-layer period
        (7 Mamba layers, attention at layer 4, MoE every other layer, all
        at full width, 13,295,235,072 parameters, bf16; the published 32
        layers need 103 GB), ``serve.prefill`` of 4 x 2048 tokens and
        ``serve.decode`` of 31 greedy steps, through the kernels (7
        ``mamba_scan`` and 1 ``flash_attention`` launches in the prefill,
        none in decode, every other kernel none), init, prefill and decode
        times, idle shares and peak memory; the prefill's last-position
        logits held to the same prefill with ``ops.mamba_scan`` bound to the
        step loop (in this script only, ``plain_mamba``);
     c. a Mamba+MoE and a Mamba+dense layer at full width in float32,
        kernel vs plain: logits within 1e-4 of their scale, 16 greedy
        decode steps equal;
 11. ``swiglu_fused``, the entry point of the fused SwiGLU kernel (no model
     path calls it): the kernel vs ``ref.swiglu_ref`` on the inputs
     widened to float32 at the Jamba dense-FFN prefill shape (m 8192, d
     4096, f 14336) in bf16 and float32 and at a ragged m and f, with
     kernel, plain, bound and library (``layers.swiglu``'s three cuBLAS
     products) times and TFLOP/s, and the bound of the work the design
     executes on the tensor cores (two bf16 pieces of h, or 3xTF32); then
     ``ops.swiglu_fused`` once at that shape.

Phases 4, 5c, 6c, 7c-e, 8b, 9b, 10b and 11 each set the kernels' launch
counters to 0 just before the run they check and read them just after.

It then prints one JSON line describing each kernel and, last, a JSON line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints neither.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): FP32 and FP64 outside
# the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
PEAK_BYTES_PER_S = 3.35e12

FED_AGG_TOL = 1e-5      # max |kernel - plain| / max(1, max |plain|)
TRAIN_STEP_TOL = 1e-4   # per leaf: max |kernel - plain| / max |plain|
ACC_TOL = 0.005         # |fused - eager| accuracy on 2000 test samples (10 samples)
K, T_CYCLE, TOTAL, SEED, LR = 10, 15.0, 6000, 0, 0.1
CYCLES = 3
# phase 5: the fleet-scale batch, and the waterfill kernel's tolerance
# (absolute, times max(1, |total|)): the kernel rounds every operation and
# sums in the plain version's order, so it should agree to the last bits
FLEET_K, FLEET_B = 8, 131_072
WATERFILL_TOL = {"float64": 1e-12, "float32": 1e-5}
TIE_SHARE = 1e-3        # fleets allowed to differ card vs CPU by a remainder tie
# phase 6: the accum_flush kernel rounds as its plain version does and sums
# in the same order, so it is held like fed_agg; the async runs' accuracy
# after 30 sequential float32 mixes, grouped vs eager
ACCUM_FLUSH_TOL = 1e-5  # max |kernel - plain| / max(1, max |plain|)
ASYNC_ACC_TOL = 0.01    # |grouped - eager| accuracy on 2000 test samples (20 samples)
# a full group step at paper width is held to one GD step's parity
# (TRAIN_STEP_TOL) and, over all its steps, to float32's own spread: the
# kernel may sit at most this factor further from float64 than the plain
# float32 version does
FLOAT32_SPREAD = 1.5
ASYNC_MODES = {"fedasync": {}, "buffered": {"buffer_size": 5}}
# phase 7: the budget is this share of the blind kkt_sai allocation's median
# per-learner spend (energy_sweep's anchor); the churn run's Markov chain
BUDGET_FRAC = 0.75
CHURN_P_DROP = 0.2
PGD_RESOLVES = 3
# phase 8: the serve's shapes and the attention kernel's tolerances. The
# kernel and its plain versions all compute in float32 and add in other
# orders, so float32 is held to 1e-5 of max(1, max |plain|); in bf16 the
# only rounding that differs is the output's, one bf16 step (2^-8), so 1e-2.
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "llama3.2-3b", 4, 2048, 32
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the bf16 serve, kernel vs plain: last-position logits, of max |plain|.
# Each layer's attention output may round to the neighbouring bf16 value
# in one and not the other (2^-8 relative), and 28 layers of bf16 compute
# carry that into the logits
SERVE_BF16_TOL = 5e-2
# the float32 gate (2 layers): the attention outputs agree to ~1e-6, and
# the float32 layers around them carry that into the logits
E2E_LAYERS, E2E_STEPS, E2E_TOL = 2, 16, 1e-4
# the dense oracle's (B, Sq, KV, G, Skv) float32 scores up to this size;
# beyond it the plain version is the chunked scan
DENSE_REF_BYTES = 4e9
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
# phase 8a: name, B, S, heads, kv heads, d, dtype, causal, window, timed
# calls; the first is the serve's prefill and gives the kernels line its row
FLASH_CASES = [
    ("llama3.2-3b prefill", SERVE_BATCH, SERVE_PROMPT, 24, 8, 128, "bfloat16", True, None, 10),
    ("llama3.2-3b prefill", SERVE_BATCH, SERVE_PROMPT, 24, 8, 128, "float32", True, None, 5),
    ("ragged", SERVE_BATCH, 1000, 24, 8, 128, "bfloat16", True, None, 10),
    ("h2o-danube-1.8b prefill", 1, 8192, 32, 8, 80, "bfloat16", True, 4096, 5),
]
# phase 9: the RWKV-6 serve at the dense serve's batch and lengths. The WKV
# kernel and the step loop take every product in float32 from the same
# inputs and sum over i in other orders; the output is float32 for bf16
# inputs too, so both are held to 1e-5 of max(1, max |plain|)
RWKV_ARCH = "rwkv6-7b"
WKV_TOL = 1e-5
# phase 9a: name, B, S, heads, head dim, r/k/v dtype, with s0, state written
# over s0, timed calls; the first is the serve's prefill and gives the
# kernels line its row
WKV_CASES = [
    ("rwkv6-7b prefill", SERVE_BATCH, SERVE_PROMPT, 64, 64, "bfloat16", False, False, 10),
    ("rwkv6-7b prefill", SERVE_BATCH, SERVE_PROMPT, 64, 64, "float32", False, False, 10),
    ("ragged", SERVE_BATCH, 1000, 64, 64, "bfloat16", True, False, 10),
    ("rwkv6-7b decode step", SERVE_BATCH, 1, 64, 64, "bfloat16", True, True, 200),
]
# phase 10: the Jamba serve, one 8-layer period of jamba-v0.1-52b at full
# width (the published 32 layers need 103 GB in bf16, more than the card's
# 80), at the dense serve's batch and lengths. The scan kernel and the step
# loop take every product in float32 from the same inputs and sum over n in
# other orders, so both are held to 1e-5 of max(1, max |plain|)
JAMBA_ARCH, JAMBA_LAYERS = "jamba-v0.1-52b", 8
MAMBA_TOL = 1e-5
# phase 10a: name, B, S, d_inner, d_state, x dtype, with h0, state written
# over h0, timed calls; the first is the serve's prefill and gives the
# kernels line its row
MAMBA_CASES = [
    ("jamba prefill", SERVE_BATCH, SERVE_PROMPT, 8192, 16, "bfloat16", False, False, 10),
    ("jamba prefill", SERVE_BATCH, SERVE_PROMPT, 8192, 16, "float32", False, False, 10),
    ("ragged", SERVE_BATCH, 1000, 8192, 16, "bfloat16", True, False, 10),
    ("ragged, state in place", SERVE_BATCH, 1000, 8192, 16, "float32", True, True, 10),
]
# phase 11: the fused SwiGLU at Jamba's dense-FFN prefill shape (m = 4 x
# 2048 tokens, d 4096, f 14336). The kernel takes its products in float32
# from the widened inputs and returns x's dtype; it is held to
# ref.swiglu_ref on the widened inputs: float32 to 1e-5 of max(1, max
# |plain|) (sums over 4096 and 14336 terms in another order), a bf16 output
# to one bf16 step (2^-8) of it. Name, m, d, f, dtype, timed calls
SWIGLU_TOL = {"float32": 1e-5, "bfloat16": 2.0**-8}
SWIGLU_CASES = [
    ("jamba dense ffn prefill", SERVE_BATCH * SERVE_PROMPT, 4096, 14336, "bfloat16", 3),
    ("jamba dense ffn prefill", SERVE_BATCH * SERVE_PROMPT, 4096, 14336, "float32", 2),
    ("ragged", 1000, 4096, 14000, "bfloat16", 3),
]


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


def kernel_device_ms(fn, name: str, calls: int) -> float:
    """Device time a launch of the kernel whose name contains ``name``,
    from ``torch.profiler`` over ``calls`` calls of ``fn``; fails when the
    profiler sees no such kernel."""
    rows = device_time_by_kernel(lambda: [fn() for _ in range(calls)])
    hits = [(ms, n) for key, ms, n in rows if name in key]
    require(bool(hits), f"torch.profiler saw no {name} launches")
    return sum(ms for ms, _ in hits) / sum(n for _, n in hits)


def training_launches(breakdown) -> int:
    """Launches of the persistent training kernel in a ``device_time_by_kernel``
    breakdown."""
    return sum(calls for name, _, calls in breakdown if "train_steps_kernel" in name)


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


class CallCounter:
    """Counts the calls of ``ops.<name>`` while it is entered: on the CPU
    these are the plain version's calls, one for each launch the card's
    run of the same schedule makes."""

    def __init__(self, name: str):
        from repro_torch.kernels import ops

        self.ops, self.name, self.calls = ops, name, 0

    def __enter__(self):
        self.fn = getattr(self.ops, self.name)

        def counted(*args):
            self.calls += 1
            return self.fn(*args)

        setattr(self.ops, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.fn)


def reset_launches() -> None:
    from repro_torch.kernels import (accum_flush, fed_agg, flash_attention, mamba_scan,
                                     swiglu, train_step, waterfill, wkv6)

    waterfill.launches = waterfill.energy_launches = 0
    train_step.launches = fed_agg.launches = accum_flush.launches = 0
    flash_attention.launches = wkv6.launches = 0
    mamba_scan.launches = swiglu.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import (accum_flush, fed_agg, flash_attention, mamba_scan,
                                     swiglu, train_step, waterfill, wkv6)

    return {"train_agg_step": train_step.launches, "accum_flush": accum_flush.launches,
            "fed_agg": fed_agg.launches, "waterfill_residual": waterfill.launches,
            "waterfill_energy_residual": waterfill.energy_launches,
            "flash_attention": flash_attention.launches, "wkv6": wkv6.launches,
            "mamba_scan": mamba_scan.launches, "swiglu": swiglu.launches}


def cpu_schedule(train, horizon: float, prob, cfg, drift, counted: str) -> dict:
    """The async engine's schedule built on the CPU with the engine's rng
    discipline: flush rows, groups, counters, ledger, block masks, and the
    calls of ``ops.<counted>`` its re-solves made."""
    from repro_torch.data.pipeline import FederatedPartitioner
    from repro_torch.fed import async_engine as ae
    from repro_torch.models import mlp

    eng = ae.AsyncFedEngine(cfg, prob, mlp.loss, mlp.init(SEED, device="cpu"), seed=SEED,
                            drift=drift)
    part = FederatedPartitioner(train, seed=int(eng.rng.integers(2**31)))
    with CallCounter(counted) as count:
        sched = eng._build_schedule(part, horizon, 100_000)
    rows, group = [], []
    for a in sched.arrivals:
        if a.flush_id >= 0:
            group.append(a)
            if a.flush:
                rows.append(ae._flush_row(a, group, cfg.mode))
                group = []
    return {"rows": rows, "groups": ae._event_segments(sched.arrivals), "sched": sched,
            "solves": count.calls, "masks": eng._block_masks,
            "blocks": sorted(eng._alloc_cache)}


def check_rows(hist, want_rows, what: str) -> None:
    import numpy as np

    require(len(hist) == len(want_rows), f"{what}: {len(hist)} aggregations, the CPU "
            f"schedule has {len(want_rows)}")
    for i, (r, w) in enumerate(zip(hist, want_rows)):
        for name in w:
            require(np.array_equal(np.asarray(r[name]), np.asarray(w[name])),
                    f"{what}: row {i} column {name} differs from the CPU schedule's")


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
    # every leaf in one launch: each leaf bitwise the single-leaf launch's,
    # and within FED_AGG_TOL of the plain version
    fa_err = 0.0
    for leaf, got in zip(leaves, fed_agg.fed_agg_leaves_cuda(leaves, wts)):
        require(torch.equal(got, fed_agg.fed_agg_cuda(leaf, wts)),
                "the all-leaf fed_agg launch differs from the single-leaf launch")
        want = ref.fed_agg_ref(leaf, wts)
        err = (got - want).abs().max().item()
        require(err <= FED_AGG_TOL * max(1.0, want.abs().max().item()),
                f"fed_agg kernel differs from its plain version by {err:g}")
        fa_err = max(fa_err, err)
    fa_ms = cuda_ms(lambda: fed_agg.fed_agg_leaves_cuda(leaves, wts), 200)
    fa_dev_ms = kernel_device_ms(lambda: fed_agg.fed_agg_leaves_cuda(leaves, wts),
                                 "fed_agg_kernel", 20)
    fa_leaf_ms = cuda_ms(lambda: [fed_agg.fed_agg_cuda(x, wts) for x in leaves], 200)
    fa_plain_ms = cuda_ms(lambda: [ref.fed_agg_ref(x, wts) for x in leaves], 200)
    fa_lib_ms = cuda_ms(lambda: [torch.tensordot(wts, x, dims=1) for x in leaves], 200)
    n_params = sum(math.prod(s[1:]) for s in shapes)
    fa_bytes = 4 * (K * n_params + n_params + K * len(shapes))
    fa_flops = 2 * K * n_params
    fa_bound_ms = 1e3 * max(fa_bytes / PEAK_BYTES_PER_S, fa_flops / PEAK_FP32_FLOPS)
    print(f"fed_agg: {len(shapes)} leaves, {n_params} params, max_abs_err "
          f"{fa_err:.3g}; one launch for all leaves {fa_ms:.4f} ms ({fa_dev_ms:.4f} ms of "
          f"device time, torch.profiler), one launch a leaf {fa_leaf_ms:.4f} ms, plain "
          f"{fa_plain_ms:.4f} ms, {len(shapes)} tensordot {fa_lib_ms:.4f} ms, bound "
          f"{fa_bound_ms:.4f} ms (bytes); all-leaf launch "
          f"{'below' if fa_ms < fa_lib_ms else 'NOT below'} the tensordots")

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
    got, _ = train_step.train_agg_step_cuda(disp, x, y, m, tau_t, w_t, LR, max_tau=max_tau)
    want, _ = ref.train_agg_step_ref(disp, x, y, m, tau_t, w_t, LR, max_tau=max_tau)
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
        k32, _ = train_step.train_agg_step_cuda(disp, x, y, m, tau_s, w_t, LR,
                                                max_tau=steps)
        p32, _ = ref.train_agg_step_ref(disp, x, y, m, tau_s, w_t, LR, max_tau=steps)
        p64, _ = ref.train_agg_step_ref(disp64, x.double(), y, m.double(), tau_s,
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
    ts_launches = training_launches(breakdown)
    print(f"train_agg_step: {ts_launches} training-kernel launch(es) a cycle (torch.profiler)")
    require(ts_launches == 1, f"a cycle made {ts_launches} training-kernel launches, not 1")
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
    require(launches == {"train_agg_step": CYCLES, "fed_agg": CYCLES},
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
    # the first fused run also loads torch's kernels for the staging; a
    # second one gives the warm cycle
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_experiment(k=K, T=T_CYCLE, cycles=CYCLES, total_samples=TOTAL, seed=SEED,
                   train=train, test=test, fused=True)
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t0) / CYCLES
    print(f"run_experiment ms per cycle (staging and eval included): fused "
          f"{runs['fused']['ms_per_cycle']:.1f} (first run), {warm_ms:.1f} (warm), eager "
          f"{runs['eager']['ms_per_cycle']:.1f}")

    wf = realloc_phase(dev, train, test)
    async_rows = async_phase(dev, train, test, leaves=2 * len(mats), row_flops=row_flops)
    energy_row = energy_phase(dev, train, test, leaves=2 * len(mats))
    attention_row = serve_phase(dev)
    wkv_row = rwkv_phase(dev)
    mamba_row = jamba_phase(dev)
    swiglu_row = swiglu_phase(dev)

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
        wf,
        *async_rows,
        energy_row,
        attention_row,
        wkv_row,
        mamba_row,
        swiglu_row,
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def realloc_phase(dev, train, test) -> dict:
    """Phase 5; returns the waterfill kernel's entry of the kernels line."""
    import numpy as np
    import torch

    from repro_torch.core import CapacityDrift, QueueDrift, solver_batched as sb
    from repro_torch.fed.orchestrator import (
        coefficient_rows,
        solve_policy_row,
        solve_rows_state_coupled,
    )
    from repro_torch.fed.simulation import build_problem, run_experiment
    from repro_torch.kernels import fed_agg, ref, train_step, waterfill

    # -- 5a. the kernel against its plain version at fleet scale --------------
    prob = build_problem(FLEET_K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    c2, c1, c0 = CapacityDrift(seed=SEED).coefficient_path(prob.time_model, FLEET_B)
    b, k = c2.shape
    bp = sb.BatchedProblems(
        c2, c1, c0, np.full(b, prob.T), np.full(b, prob.total_samples, np.int64),
        np.full((b, k), float(prob.d_lower)), np.full((b, k), float(prob.d_upper)),
        np.ones((b, k), bool))
    print(f"fleet batch: B = {b} drifted problems of K = {k} ({b * k} learners), "
          f"d in [{prob.d_lower}, {prob.d_upper}], total {prob.total_samples}")
    waterfill.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = sb.solve_kkt_batched(bp, device=dev)
    solve_wall_ms = 1e3 * (time.perf_counter() - t0)
    solve_launches = waterfill.launches
    require(bool(card.feasible.all()), "the drifted fleet batch has infeasible rows")

    wf_err = {}
    for dtype in (torch.float64, torch.float32):
        t = sb._to_device(bp, dtype == torch.float64, dev)
        args = [t["c2"], t["c1"], t["c0"], t["T"], t["d_lo"], t["d_hi"],
                t["total_i"].to(dtype)]
        tau_star = torch.as_tensor(card.tau_star, dtype=dtype, device=dev)
        bound = WATERFILL_TOL[str(dtype)[6:]] * torch.clamp_min(args[-1].abs(), 1.0)
        err = 0.0
        for name, tau in (("0", torch.zeros_like(tau_star)), ("tau*", tau_star),
                          ("2 tau*", 2.0 * tau_star)):
            got = waterfill.waterfill_residual_cuda(tau, *args)
            want = ref.waterfill_residual_ref(tau, *args)
            diff = (got - want).abs()
            require(bool(torch.isfinite(got).all()), f"waterfill kernel gave non-finite "
                    f"residuals at tau = {name}, {dtype}")
            require(bool((diff <= bound).all()), f"waterfill kernel differs from its "
                    f"plain version by {diff.max().item():g} at tau = {name}, {dtype}")
            err = max(err, diff.max().item())
        wf_err[dtype] = err
        if dtype == torch.float64:
            wf_args = [tau_star, *args]
    f32_args = [a.float() for a in wf_args]
    # back-to-back calls are paced by the host (the wrapper's checks and the
    # ctypes call), so the kernel's own time is its device time a launch
    # from torch.profiler; CUDA events over the loop give the paced time
    wf_ms, wf32_ms = (kernel_device_ms(lambda a=a: waterfill.waterfill_residual_cuda(*a),
                                       "waterfill_residual_kernel", 50)
                      for a in (wf_args, f32_args))
    wf_paced_ms = cuda_ms(lambda: waterfill.waterfill_residual_cuda(*wf_args), 200)
    wf_plain_ms = cuda_ms(lambda: ref.waterfill_residual_ref(*wf_args), 50)
    wf_bytes = 8 * (5 * b * k + 3 * b + b)
    wf_bound_ms = 1e3 * wf_bytes / PEAK_BYTES_PER_S
    print(f"waterfill_residual: max_abs_err float64 {wf_err[torch.float64]:.3g}, float32 "
          f"{wf_err[torch.float32]:.3g} (at tau* = 0, tau*, 2 tau*); kernel device time "
          f"{wf_ms:.4f} ms a launch (float32 {wf32_ms:.4f}; host-paced loop {wf_paced_ms:.4f}), "
          f"plain {wf_plain_ms:.4f} ms, bound {wf_bound_ms:.4f} ms ({wf_bytes / 1e6:.1f} MB, "
          f"bytes; float32 half)")

    # -- 5b. the batched solve, card against CPU, and the card's split --------
    t = sb._to_device(bp, True, dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    events[0].record()
    feas, tau_star, _, d_r, relax_rounds = sb._relaxed_batched(
        t["c2"], t["c1"], t["c0"], t["T"], t["total_i"].double(), t["d_lo"], t["d_hi"],
        tol=1e-10, max_iter=200)
    events[1].record()
    d_r, total_safe, lo_i, hi_i = sb._integer_inputs(d_r, feas, t["total_i"], t["d_lo"],
                                                     t["d_hi"])
    d_int, _, int_rounds = sb._integerize(d_r, total_safe, lo_i, hi_i)
    events[2].record()
    tau_c, d_c, sai_rounds = sb._sai(d_int, t["c2"], t["c1"], t["c0"], t["T"], lo_i,
                                     hi_i, t["valid"], max_rounds=10_000)
    events[3].record()
    torch.cuda.synchronize()
    stage_ms = [events[i].elapsed_time(events[i + 1]) for i in range(3)]
    require(np.array_equal(tau_c.cpu().numpy(), card.tau)
            and np.array_equal(d_c.cpu().numpy(), card.d),
            "the staged solve differs from solve_kkt_batched")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sb.solve_kkt_batched(bp, device=dev)
    warm_ms = 1e3 * (time.perf_counter() - t0)
    breakdown = device_time_by_kernel(lambda: sb.solve_kkt_batched(bp, device=dev))
    t0 = time.perf_counter()
    cpu = sb.solve_kkt_batched(bp, device="cpu")
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    require(np.array_equal(card.feasible, cpu.feasible), "card and CPU feasibility differ")
    ties = 0
    for i in np.flatnonzero(~((card.tau == cpu.tau).all(1) & (card.d == cpu.d).all(1))):
        ties += 1
        require(np.ptp(card.tau[i]) == np.ptp(cpu.tau[i])
                and np.abs(card.d[i] - cpu.d[i]).max() <= 2,
                f"fleet {i}: card and CPU allocations differ beyond a remainder tie")
    require(ties <= TIE_SHARE * b, f"{ties} remainder ties between card and CPU")
    stale = sb.batched_max_staleness(card.tau, card.valid)
    print(f"solve_kkt_batched B={b}: card {solve_wall_ms:.1f} ms first call, {warm_ms:.1f} "
          f"ms warm (host clock, copies in), CPU {cpu_ms:.1f} ms; waterfill launches per "
          f"solve {solve_launches}; card split "
          f"(CUDA events): bisection {stage_ms[0]:.2f} ms ({relax_rounds['grow']} grow + "
          f"{relax_rounds['bisection']} bisection steps), integerize {stage_ms[1]:.2f} ms "
          f"({int_rounds} rounds), SAI {stage_ms[2]:.2f} ms ({sai_rounds} rounds); fleets "
          f"differing card vs CPU: {ties} (remainder ties); max staleness mean "
          f"{stale.mean():.3f}, worst {stale.max()}")
    busy = sum(ms for _, ms, _ in breakdown)
    print(f"solve_kkt_batched device time by kernel (torch.profiler, one warm solve): "
          f"{busy:.2f} ms busy in {sum(n for *_, n in breakdown)} launches" if breakdown else
          "solve_kkt_batched device time by kernel: not measured (no device events)")
    for name, ms, calls in breakdown[:12]:
        print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")

    # -- 5c. the main path with reallocation: run_experiment, fused and eager --
    drifts = {"CapacityDrift": lambda: CapacityDrift(seed=SEED),
              "QueueDrift": lambda: QueueDrift(base=CapacityDrift(seed=SEED))}
    prob = build_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    rows = coefficient_rows(prob, CapacityDrift(seed=SEED), CYCLES)
    solve_policy_row("kkt_sai", *(r[0] for r in rows), prob, label="warm-up", device=dev)
    waterfill.launches = 0
    t0 = time.perf_counter()
    for rep in range(5):
        for c in range(CYCLES):
            solve_policy_row("kkt_sai", *(r[c] for r in rows), prob, label=f"cycle {c}",
                             device=dev)
    row_ms = 1e3 * (time.perf_counter() - t0) / (5 * CYCLES)
    print(f"one-fleet re-solve on the card (solve_policy_row, K = {K}): {row_ms:.2f} ms "
          f"(host clock), {waterfill.launches / (5 * CYCLES):.1f} waterfill launches")
    def cpu_row_solves(rows):
        """The CPU solver on each cycle's capacity row alone, as a run
        re-solves it (one fleet, ``solve_policy_row``'s tolerances)."""
        one = lambda v, dt=np.float64: np.full((1, K), v, dt)
        return [sb.solve_kkt_batched(sb.BatchedProblems(
            *(r[c][None] for r in rows), np.full(1, prob.T), np.full(1, TOTAL, np.int64),
            one(float(prob.d_lower)), one(float(prob.d_upper)), one(True, bool)),
            device="cpu") for c in range(CYCLES)]

    realloc_launches = None
    for name, make in drifts.items():
        # the CPU solver's rows for the same capacity rows
        drift = make()
        if name == "QueueDrift":
            rows, _ = solve_rows_state_coupled("kkt_sai", drift, prob, CYCLES,
                                               label="cycle {}", device="cpu")
        else:
            rows = coefficient_rows(prob, drift, CYCLES)
        solves = cpu_row_solves(rows)
        taus, ds = [s.tau[0] for s in solves], [s.d[0] for s in solves]
        # a re-solve launches the kernel at tau = 0 (feasibility) and at the
        # first bracket tau = 1, then once a grow and once a bisection step
        n_wf = sum(2 + s.rounds["grow"] + s.rounds["bisection"] for s in solves)
        want = {"fused": {"train_agg_step": CYCLES, "fed_agg": CYCLES,
                          "waterfill_residual": n_wf},
                "eager": {"train_agg_step": 0, "fed_agg": 0, "waterfill_residual": n_wf}}
        runs = {}
        for mode in ("fused", "eager"):
            waterfill.launches = train_step.launches = fed_agg.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[mode] = run_experiment(k=K, T=T_CYCLE, cycles=CYCLES, total_samples=TOTAL,
                                        seed=SEED, train=train, test=test,
                                        fused=(mode == "fused"), reallocate=True,
                                        drift=make())
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / CYCLES
            counts = {"train_agg_step": train_step.launches, "fed_agg": fed_agg.launches,
                      "waterfill_residual": waterfill.launches}
            require(counts == want[mode], f"{name}: the {mode} reallocating run's kernel "
                    f"launches were {counts}, not {want[mode]}")
            if mode == "fused" and realloc_launches is None:
                realloc_launches = counts["waterfill_residual"]
            runs[mode]["ms"], runs[mode]["counts"] = ms, counts
        hist_f, hist_e = runs["fused"]["history"], runs["eager"]["history"]
        for c, (hf, he) in enumerate(zip(hist_f, hist_e)):
            require(np.array_equal(hf["tau"], he["tau"]) and np.array_equal(hf["d"], he["d"]),
                    f"{name}: fused and eager runs allocated cycle {c} differently")
            require(np.array_equal(hf["tau"], taus[c]) and np.array_equal(hf["d"], ds[c]),
                    f"{name}: cycle {c} differs from the CPU solver's allocation")
        acc_f = [h["accuracy"] for h in hist_f]
        acc_e = [h["accuracy"] for h in hist_e]
        require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in acc_f + acc_e),
                f"{name}: accuracies out of range: {acc_f}, {acc_e}")
        require(max(abs(a - e) for a, e in zip(acc_f, acc_e)) <= ACC_TOL,
                f"{name}: fused {acc_f} and eager {acc_e} accuracies differ by more "
                f"than {ACC_TOL}")
        require(acc_f[-1] > acc_f[0], f"{name}: accuracy did not rise: {acc_f}")
        print(f"run_experiment reallocate=True drift={name}: d by cycle "
              f"{[h['d'].tolist() for h in hist_f]}, tau {[h['tau'].tolist() for h in hist_f]}; "
              f"fused accuracy {acc_f}, eager {acc_e}; ms per cycle fused "
              f"{runs['fused']['ms']:.1f}, eager {runs['eager']['ms']:.1f}; launches fused "
              f"{runs['fused']['counts']}, eager {runs['eager']['counts']}")

    return {"name": "waterfill_residual", "route": "cuda",
            "source": "src/repro_torch/csrc/waterfill.cu",
            "replaces": "src/repro/kernels/waterfill.py:47",
            "launches": realloc_launches, "max_abs_err": wf_err[torch.float64],
            "ms": wf_ms, "plain_ms": wf_plain_ms, "bound_ms": wf_bound_ms,
            "bound_by": "bytes", "library_ms": None}


def async_phase(dev, train, test, *, leaves: int, row_flops: int) -> list[dict]:
    """Phase 6; returns the async train step's and ``accum_flush``'s entries
    of the kernels line."""
    import numpy as np
    import torch

    from repro_torch.core import CapacityDrift
    from repro_torch.fed import async_engine as ae
    from repro_torch.fed.simulation import build_problem, run_async_experiment
    from repro_torch.kernels import accum_flush, ref, train_step
    from repro_torch.models import mlp

    widths = mlp.PAPER_LAYERS
    horizon = CYCLES * T_CYCLE

    # -- 6a. accum_flush at the paper model's leaf shapes --------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    shapes = []
    for fi, fo in zip(widths[:-1], widths[1:]):
        shapes += [(fi, fo), (fo,)]
    locs = [torch.randn((K, *s), generator=gen, device=dev) for s in shapes]
    accs = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    servers = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    wts = torch.softmax(torch.randn(K, generator=gen, device=dev), 0) * 0.6
    cases = {"accumulate": (1.0, 0.0), "buffered flush": (0.0, 1.0),
             "fedasync mix": (0.4, 1.0)}
    af_err = 0.0
    for case, (keep, flush) in cases.items():
        for loc, acc, srv in zip(locs, accs, servers):
            got = accum_flush.accum_flush_cuda(loc, wts, acc, srv, keep, flush)
            want = ref.accum_flush_ref(loc, wts, acc, srv, keep, flush)
            for g, w in zip(got, want):
                require(bool(torch.isfinite(g).all()), f"accum_flush gave non-finite "
                        f"values ({case})")
                err = (g - w).abs().max().item()
                require(err <= ACCUM_FLUSH_TOL * max(1.0, w.abs().max().item()),
                        f"accum_flush differs from its plain version by {err:g} ({case})")
                af_err = max(af_err, err)
    all_leaves = list(zip(locs, accs, servers))
    af_ms = cuda_ms(lambda: [accum_flush.accum_flush_cuda(l, wts, a, s, 0.4, 1.0)
                             for l, a, s in all_leaves], 200)
    af_launch_ms = kernel_device_ms(
        lambda: [accum_flush.accum_flush_cuda(l, wts, a, s, 0.4, 1.0)
                 for l, a, s in all_leaves], "accum_flush_kernel", 20) * len(shapes)
    af_plain_ms = cuda_ms(lambda: [ref.accum_flush_ref(l, wts, a, s, 0.4, 1.0)
                                   for l, a, s in all_leaves], 200)
    af_lib_ms = cuda_ms(lambda: [torch.tensordot(wts, l, dims=1) for l, _, _ in all_leaves],
                        200)
    n_params = sum(math.prod(s) for s in shapes)
    af_bytes = 4 * ((K + 4) * n_params + K)
    af_flops = (2 * K + 6) * n_params
    af_bound_ms = 1e3 * max(af_bytes / PEAK_BYTES_PER_S, af_flops / PEAK_FP32_FLOPS)
    print(f"accum_flush: {len(shapes)} leaves, {n_params} params, K = {K}, max_abs_err "
          f"{af_err:.3g} over {', '.join(cases)}; kernel {af_ms:.4f} ms ({len(shapes)} launches, "
          f"CUDA events; device time {af_launch_ms:.4f} ms by torch.profiler), plain "
          f"{af_plain_ms:.4f} ms, tensordot of the accumulate {af_lib_ms:.4f} ms, bound "
          f"{af_bound_ms:.4f} ms ({af_bytes / 1e6:.1f} MB, bytes)")

    # the CPU schedule of each mode, with the engine's rng discipline: the
    # rows the card's runs must give, the groups, the blocks re-solved and
    # the water-fillings their re-solves make
    prob = build_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    cpu = {mode: cpu_schedule(train, horizon, prob,
                              ae.AsyncConfig(mode=mode, reallocate=True, **extra),
                              CapacityDrift(seed=SEED), "waterfill_residual")
           for mode, extra in ASYNC_MODES.items()}

    # -- 6b. one async group step at full width ---------------------------------
    tx = torch.from_numpy(train.x).to(dev)
    ty = torch.from_numpy(train.y).to(dev)
    init = mlp.init(SEED, device=dev)

    def group_inputs(mode, groups, slots=None):
        st = ae._stage_groups(groups, mode=mode, k_fleet=K, d_cap=cpu[mode]["sched"].d_cap,
                              slots=slots)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        rows_ = K if slots is None else slots
        disp = [{n: leaf.expand((rows_,) + leaf.shape) for n, leaf in layer.items()}
                for layer in init]
        acc0 = [{n: 0.01 * torch.ones_like(leaf) for n, leaf in layer.items()}
                for layer in init]
        args = (disp, tx[t(st.idx[0])], ty[t(st.idx[0])], t(st.m[0]), t(st.tau[0]),
                t(st.w[0]), LR)
        kw = dict(max_tau=max(int(st.tau[0].max()), 1), server=init, acc=acc0,
                  keep=float(st.keep[0]), flush=float(st.flush[0]))
        return args, kw

    def tree_errors(got, want) -> tuple[float, float]:
        """``leaf_errors`` over both returned models (server', acc')."""
        errs = [leaf_errors(g, w) for g, w in zip(got, want)]
        return max(e[0] for e in errs), max(e[1] for e in errs)

    buf_groups = cpu["buffered"]["groups"]
    widest = max((g for g in buf_groups if g[-1].flush), key=len)
    args, kw = group_inputs("buffered", [widest])
    # the parity gate at full width: one GD step a learner (see phase 3)
    args1 = (*args[:4], torch.clamp(args[4], max=1), *args[5:])
    kw1 = {**kw, "max_tau": 1}
    gs1_rel = tree_errors(train_step.train_agg_step_cuda(*args1, **kw1),
                          ref.train_agg_step_ref(*args1, **kw1))[1]
    require(gs1_rel <= TRAIN_STEP_TOL, f"the async group step (one GD step a learner) "
            f"differs from its plain version: {gs1_rel:g} relative")
    # the whole group step: the kernel against the plain version, and both
    # float32 versions against the plain version in float64
    got = train_step.train_agg_step_cuda(*args, **kw)
    want = ref.train_agg_step_ref(*args, **kw)
    f64 = lambda tree: [{n: v.double() for n, v in layer.items()} for layer in tree]
    args64 = (f64(args[0]), args[1].double(), args[2], args[3].double(), args[4],
              args[5].double(), LR)
    want64 = ref.train_agg_step_ref(*args64, **{**kw, "server": f64(kw["server"]),
                                                "acc": f64(kw["acc"])})
    torch.cuda.synchronize()
    require(all(torch.isfinite(t).all().item() for tree in got for layer in tree
                for t in layer.values()), "the async group step gave non-finite params")
    gs_abs, gs_rel = tree_errors(got, want)
    k64, p64 = tree_errors(got, want64)[1], tree_errors(want, want64)[1]
    require(k64 <= FLOAT32_SPREAD * p64, f"the async group step sits {k64:g} (relative) "
            f"from float64, the plain float32 version {p64:g}")
    print(f"async group step, max relative (per leaf): one GD step {gs1_rel:.3g} <= "
          f"{TRAIN_STEP_TOL}; all {max(a.tau for a in widest)} steps: kernel vs plain "
          f"{gs_rel:.3g}, to float64: kernel {k64:.3g}, plain float32 {p64:.3g}")
    gs_ms = cuda_ms(lambda: train_step.train_agg_step_cuda(*args, **kw), 5)
    gs_plain_ms = cuda_ms(lambda: ref.train_agg_step_ref(*args, **kw), 3)
    td = int(sum(a.tau * a.d for a in widest))
    gs_flops = td * row_flops
    d_cap = cpu["buffered"]["sched"].d_cap
    # inputs read once (x, y, m, tau, w, K dispatched models, server, acc),
    # outputs (server', acc') written once
    gs_bytes = 4 * (K * d_cap * (widths[0] + 2) + 2 * K + (K + 4) * n_params)
    gs_bound_ms = 1e3 * max(gs_flops / PEAK_FP32_FLOPS, gs_bytes / PEAK_BYTES_PER_S)
    breakdown = device_time_by_kernel(lambda: train_step.train_agg_step_cuda(*args, **kw))
    busy = sum(ms for _, ms, _ in breakdown)
    print(f"async group step (buffered flush of {len(widest)}: learners "
          f"{[a.learner for a in widest]}, tau {[a.tau for a in widest]}, d "
          f"{[a.d for a in widest]}): max_abs_err {gs_abs:.3g}; kernel {gs_ms:.3f} ms, plain "
          f"{gs_plain_ms:.3f} ms, bound {gs_bound_ms:.3f} ms ({gs_flops:.4g} FP32 FLOPs); "
          + (f"{busy:.3f} ms busy by torch.profiler" if breakdown else
             "device time by kernel not measured (no device events)"))
    for name, ms, calls in breakdown[:8]:
        print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")
    gs_launches = training_launches(breakdown)
    print(f"async group step: {gs_launches} training-kernel launch(es) a call (torch.profiler)")
    require(gs_launches == 1, f"an async group step made {gs_launches} training-kernel "
            f"launches, not 1")
    # fedasync: one learner trains, nine sit at tau = 0 with an all-zero
    # mask; every kernel should stop at once for them
    fa_groups = cpu["fedasync"]["groups"]
    big = max(fa_groups, key=lambda g: g[0].tau * g[0].d)
    dense = group_inputs("fedasync", [big])
    slot = group_inputs("fedasync", [big], slots=1)
    fa_dense_ms = cuda_ms(lambda: train_step.train_agg_step_cuda(*dense[0], **dense[1]), 5)
    fa_slot_ms = cuda_ms(lambda: train_step.train_agg_step_cuda(*slot[0], **slot[1]), 5)
    d_out = train_step.train_agg_step_cuda(*dense[0], **dense[1])
    s_out = train_step.train_agg_step_cuda(*slot[0], **slot[1])
    ds_rel = max(leaf_errors(g, w)[1] for g, w in zip(d_out, s_out))
    require(ds_rel <= TRAIN_STEP_TOL, f"the fedasync step dense and over one slot "
            f"differ: {ds_rel:g} relative")
    busy = [sum(ms for _, ms, _ in device_time_by_kernel(
        lambda a=a: train_step.train_agg_step_cuda(*a[0], **a[1]))) for a in (dense, slot)]
    print(f"fedasync group step (learner {big[0].learner}, tau {big[0].tau}, d "
          f"{big[0].d}): dense over K = {K} {fa_dense_ms:.3f} ms ({busy[0]:.3f} ms busy "
          f"by torch.profiler), one slot {fa_slot_ms:.3f} ms ({busy[1]:.3f} busy); max "
          f"relative difference {ds_rel:.3g}")

    # -- 6c. the async main path: run_async_experiment, grouped and eager ------
    # the eager runs go first: a process's first run also loads torch's kernels
    out = {}
    total_launches = 0
    for mode, extra in ASYNC_MODES.items():
        want_rows = cpu[mode]["rows"]
        n_groups = len(cpu[mode]["groups"])
        n_wf = cpu[mode]["solves"]
        fixed = {"fed_agg": 0, "waterfill_residual": n_wf, "waterfill_energy_residual": 0,
                 "flash_attention": 0, "wkv6": 0, "mamba_scan": 0, "swiglu": 0}
        want = {"eager": {"train_agg_step": 0, "accum_flush": 0, **fixed},
                "grouped": {"train_agg_step": n_groups, "accum_flush": n_groups * leaves,
                            **fixed}}
        runs = {}
        for path in ("eager", "grouped", "grouped warm"):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_async_experiment(
                k=K, T=T_CYCLE, cycles=CYCLES, total_samples=TOTAL, seed=SEED,
                mode=mode, drift=CapacityDrift(seed=SEED), reallocate=True,
                bucketed=path != "eager", train=train, test=test,
                buffer_size=extra.get("buffer_size", 0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches()
            key = path.split()[0]
            require(counts == want[key], f"{mode}: the {path} run's kernel launches were "
                    f"{counts}, not {want[key]}")
            hist = res["history"]
            check_rows(hist, want_rows, f"{mode} {path}")
            accs = [r["accuracy"] for r in hist]
            require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
                    f"{mode} {path}: accuracies out of range")
            require(accs[-1] > accs[0], f"{mode} {path}: accuracy did not rise: {accs}")
            runs[path] = {"ms": 1e3 * wall / len(hist), "accs": accs, "counts": counts}
            if path == "grouped":
                total_launches += counts["train_agg_step"]
        # where a warm grouped run's time goes: the device's busy time by
        # kernel (torch.profiler, whose tracing slows the host several-fold)
        # against the unprofiled warm run's host clock
        rows_ = device_time_by_kernel(lambda: run_async_experiment(
            k=K, T=T_CYCLE, cycles=CYCLES, total_samples=TOTAL, seed=SEED, mode=mode,
            drift=CapacityDrift(seed=SEED), reallocate=True, bucketed=True, train=train,
            test=test, buffer_size=extra.get("buffer_size", 0)))
        wall_ms = runs["grouped warm"]["ms"] * len(want_rows)
        busy = sum(ms for _, ms, _ in rows_)
        print(f"{mode} grouped run: device busy {busy:.1f} ms (torch.profiler) of "
              f"{wall_ms:.1f} ms warm wall ({100 * (1 - busy / wall_ms):.0f}% idle), in "
              f"{sum(n for *_, n in rows_)} launches" if rows_ else
              f"{mode} grouped run: device time not measured (no device events)")
        for name, ms, calls in rows_[:8]:
            print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")
        acc_e, acc_g = runs["eager"]["accs"], runs["grouped"]["accs"]
        gap = max(abs(a - b) for a, b in zip(acc_e, acc_g))
        require(gap <= ASYNC_ACC_TOL, f"{mode}: grouped and eager accuracies differ by "
                f"{gap:g} > {ASYNC_ACC_TOL}")
        sched = cpu[mode]["sched"]
        print(f"run_async_experiment mode={mode} k={K} cycles={CYCLES} CapacityDrift "
              f"reallocate: {len(want_rows)} aggregations in {n_groups} groups, tau up to "
              f"{sched.max_tau}, d up to {sched.d_cap}, blocks re-solved "
              f"{cpu[mode]['blocks']}; final accuracy grouped {acc_g[-1]:.4f}, eager "
              f"{acc_e[-1]:.4f} (max gap {gap:.4f}); ms per aggregation grouped "
              f"{runs['grouped']['ms']:.2f} (first), {runs['grouped warm']['ms']:.2f} "
              f"(warm), eager {runs['eager']['ms']:.2f}; launches grouped "
              f"{runs['grouped']['counts']}")
        out[mode] = runs

    # fedasync over arrival slots (seg_batch=1): the same rows, one slot a step
    eng = ae.AsyncFedEngine(ae.AsyncConfig(mode="fedasync", reallocate=True), prob,
                            mlp.loss, mlp.init(SEED, device=dev), seed=SEED,
                            drift=CapacityDrift(seed=SEED))
    train_step.launches = accum_flush.launches = 0
    ex, ey = (torch.from_numpy(a[:2000]).to(dev) for a in (test.x, test.y))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = eng.run_events(train, horizon, eval_fn=mlp.accuracy, eval_batch=(ex, ey),
                          seg_batch=1)
    torch.cuda.synchronize()
    sb_ms = 1e3 * (time.perf_counter() - t0) / max(len(hist), 1)
    want_rows = cpu["fedasync"]["rows"]
    require(len(hist) == len(want_rows) and all(
        np.array_equal(np.asarray(r[n]), np.asarray(w[n]))
        for r, w in zip(hist, want_rows) for n in w), "seg_batch=1 changed the rows")
    require(train_step.launches == len(want_rows), "seg_batch=1 launch count")
    print(f"fedasync run_events seg_batch=1: {sb_ms:.2f} ms per aggregation (dense warm "
          f"{out['fedasync']['grouped warm']['ms']:.2f}); final accuracy "
          f"{hist[-1]['accuracy']:.4f}")

    return [
        {"name": "train_agg_step_async", "route": "cuda",
         "source": "src/repro_torch/csrc/train_step.cu",
         "replaces": "src/repro/kernels/train_step.py:119",
         "launches": total_launches, "max_abs_err": gs_abs,
         "ms": gs_ms, "plain_ms": gs_plain_ms, "bound_ms": gs_bound_ms,
         "bound_by": "operations" if gs_flops / PEAK_FP32_FLOPS > gs_bytes / PEAK_BYTES_PER_S
         else "bytes", "library_ms": None},
        {"name": "accum_flush", "route": "cuda",
         "source": "src/repro_torch/csrc/accum_flush.cu",
         "replaces": "src/repro/kernels/train_step.py:119",
         "launches": total_launches * leaves, "max_abs_err": af_err,
         "ms": af_ms, "plain_ms": af_plain_ms, "bound_ms": af_bound_ms,
         "bound_by": "bytes", "library_ms": af_lib_ms},
    ]


def energy_phase(dev, train, test, *, leaves: int) -> dict:
    """Phase 7; returns the budgeted water-filling kernel's entry of the
    kernels line."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import (
        BatteryDrift,
        CapacityDrift,
        MarkovAvailability,
        solve_kkt_sai,
        solver_batched as sb,
    )
    from repro_torch.fed import async_engine as ae
    from repro_torch.fed.orchestrator import solve_rows_availability
    from repro_torch.fed.simulation import (
        build_energy_problem,
        build_problem,
        run_async_experiment,
    )
    from repro_torch.kernels import ref, waterfill

    # -- 7a. the kernel against its plain version at fleet scale --------------
    free = build_energy_problem(FLEET_K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    blind = solve_kkt_sai(free)
    eb = BUDGET_FRAC * float(np.median(free.energy.cycle_energy(blind.tau, blind.d)))
    c2, c1, c0 = CapacityDrift(seed=SEED).coefficient_path(free.time_model, FLEET_B)
    b, k = c2.shape
    e2, e1, e0, ebr = (np.broadcast_to(r, (b, k)).copy() for r in free.energy.rows(eb))
    bp = sb.BatchedProblems(
        c2, c1, c0, np.full(b, free.T), np.full(b, free.total_samples, np.int64),
        np.full((b, k), float(free.d_lower)), np.full((b, k), float(free.d_upper)),
        np.ones((b, k), bool), e2, e1, e0, ebr)
    print(f"energy fleet batch: B = {b} drifted problems of K = {k}, budget {eb:.4f} J "
          f"({BUDGET_FRAC} x the median blind kkt_sai spend; the blind spend by learner "
          f"{np.round(free.energy.cycle_energy(blind.tau, blind.d), 3).tolist()})")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = sb.solve_energy_batched(bp, device=dev)
    solve_wall_ms = 1e3 * (time.perf_counter() - t0)
    solve_launches = read_launches()
    require(bool(card.feasible.all()), "the energy fleet batch has infeasible rows")
    require(solve_launches["waterfill_energy_residual"]
            == 2 + card.rounds["grow"] + card.rounds["bisection"]
            and solve_launches["waterfill_residual"] == 0,
            f"solve_energy_batched launched {solve_launches}")

    ew_err, times = {}, {}
    for dtype in (torch.float64, torch.float32):
        x64 = dtype == torch.float64
        t = sb._to_device(bp, x64, dev)
        en = sb._energy_to_device(bp, x64, dev)
        # the residual as the solve calls it: on the affordability-masked box
        total_m, lo_m, hi_m, _ = sb.apply_energy_mask(t["total_i"], t["d_lo"], t["d_hi"],
                                                      t["valid"], en)
        args = [t["c2"], t["c1"], t["c0"], t["T"], *en, lo_m, hi_m, total_m.to(dtype)]
        tau_star = torch.as_tensor(card.tau_star, dtype=dtype, device=dev)
        bound = WATERFILL_TOL[str(dtype)[6:]] * torch.clamp_min(args[-1].abs(), 1.0)
        err = 0.0
        for name, tau in (("0", torch.zeros_like(tau_star)), ("tau*", tau_star),
                          ("2 tau*", 2.0 * tau_star)):
            got = waterfill.waterfill_energy_residual_cuda(tau, *args)
            want = ref.waterfill_energy_residual_ref(tau, *args)
            diff = (got - want).abs()
            require(bool(torch.isfinite(got).all()), f"energy waterfill kernel gave "
                    f"non-finite residuals at tau = {name}, {dtype}")
            require(bool((diff <= bound).all()), f"energy waterfill kernel differs from "
                    f"its plain version by {diff.max().item():g} at tau = {name}, {dtype}")
            err = max(err, diff.max().item())
        # eb = +inf with zero energy coefficients: the time-only kernel's bits
        inf_args = [*args[:4], *(torch.zeros_like(e) for e in en[:3]),
                    torch.full_like(en[3], torch.inf), *args[8:]]
        require(torch.equal(waterfill.waterfill_energy_residual_cuda(tau_star, *inf_args),
                            waterfill.waterfill_residual_cuda(tau_star, *args[:4],
                                                              *args[8:])),
                f"at eb = +inf the energy kernel differs from the time-only kernel, {dtype}")
        # e2 = e1 = 0 with eb = e0 in every 4096th fleet's first learner: 0 / 0
        nan_args = [a.clone() for a in args]
        rows = torch.arange(b, device=dev) % 4096 == 0
        nan_args[4][rows, 0] = 0.0
        nan_args[5][rows, 0] = 0.0
        nan_args[7][rows, 0] = nan_args[6][rows, 0]
        got = waterfill.waterfill_energy_residual_cuda(tau_star, *nan_args)
        want = ref.waterfill_energy_residual_ref(tau_star, *nan_args)
        require(torch.equal(torch.isnan(got), torch.isnan(want))
                and int(torch.isnan(got).sum()) == int(rows.sum()),
                f"the energy kernel's NaNs sit elsewhere than the plain version's, {dtype}")
        ew_err[dtype] = err
        kernel_args = [tau_star, *args]
        # back-to-back launches are host-paced, so the kernel's own time is
        # its device time a launch by torch.profiler
        times[dtype] = {
            "ms": kernel_device_ms(lambda a=kernel_args:
                                   waterfill.waterfill_energy_residual_cuda(*a),
                                   "waterfill_energy_residual_kernel", 50),
            "paced_ms": cuda_ms(lambda a=kernel_args:
                                waterfill.waterfill_energy_residual_cuda(*a), 200),
            "plain_ms": cuda_ms(lambda a=kernel_args:
                                ref.waterfill_energy_residual_ref(*a), 50),
        }
        size = torch.finfo(dtype).bits // 8
        ew_bytes = size * (9 * b * k + 3 * b + b)
        # per learner: 4 + 4 for the two hyperbolae, a min, a two-sided
        # clip and an add; one subtract per fleet
        ew_ops = 12 * b * k + b
        peak = PEAK_FP64_FLOPS if x64 else PEAK_FP32_FLOPS
        times[dtype]["bytes_ms"] = 1e3 * ew_bytes / PEAK_BYTES_PER_S
        times[dtype]["ops_ms"] = 1e3 * ew_ops / peak
        times[dtype]["mb"] = ew_bytes / 1e6
    f64, f32 = times[torch.float64], times[torch.float32]
    bound_ms = max(f64["bytes_ms"], f64["ops_ms"])
    print(f"waterfill_energy_residual: max_abs_err float64 {ew_err[torch.float64]:.3g}, "
          f"float32 {ew_err[torch.float32]:.3g} (at tau* = 0, tau*, 2 tau*); eb = +inf equal "
          f"to the time-only kernel; NaN fleets where the plain version's are; kernel "
          f"device time {f64['ms']:.4f} ms a launch float64 (float32 {f32['ms']:.4f}; "
          f"host-paced loop {f64['paced_ms']:.4f} / {f32['paced_ms']:.4f}), plain "
          f"{f64['plain_ms']:.4f} / {f32['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms float64 "
          f"({f64['mb']:.1f} MB; operations {f64['ops_ms']:.5f} ms), "
          f"{max(f32['bytes_ms'], f32['ops_ms']):.4f} ms float32 ({f32['mb']:.1f} MB)")

    # -- 7b. the budgeted batched solve, card against CPU --------------------
    t = sb._to_device(bp, True, dev)
    en = sb._energy_to_device(bp, True, dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    events[0].record()
    total_m, lo_m, hi_m, valid_m = sb.apply_energy_mask(t["total_i"], t["d_lo"], t["d_hi"],
                                                        t["valid"], en)
    feas, _, _, d_r, relax_rounds = sb._relaxed_batched(
        t["c2"], t["c1"], t["c0"], t["T"], total_m.double(), lo_m, hi_m, tol=1e-10,
        max_iter=200, energy=en)
    events[1].record()
    d_r, total_safe, lo_i, hi_i = sb._integer_inputs(d_r, feas, total_m, lo_m, hi_m)
    d_int, _, int_rounds = sb._integerize(d_r, total_safe, lo_i, hi_i)
    events[2].record()
    tau_c, d_c, sai_rounds = sb._sai(d_int, t["c2"], t["c1"], t["c0"], t["T"], lo_i, hi_i,
                                     valid_m, max_rounds=10_000, energy=en)
    events[3].record()
    torch.cuda.synchronize()
    stage_ms = [events[i].elapsed_time(events[i + 1]) for i in range(3)]
    require(np.array_equal(tau_c.cpu().numpy(), card.tau)
            and np.array_equal(d_c.cpu().numpy(), card.d),
            "the staged energy solve differs from solve_energy_batched")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sb.solve_energy_batched(bp, device=dev)
    warm_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    cpu = sb.solve_energy_batched(bp, device="cpu")
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    require(np.array_equal(card.feasible, cpu.feasible),
            "card and CPU feasibility differ (energy)")
    ties = 0
    for i in np.flatnonzero(~((card.tau == cpu.tau).all(1) & (card.d == cpu.d).all(1))):
        ties += 1
        require(np.ptp(card.tau[i]) == np.ptp(cpu.tau[i])
                and np.abs(card.d[i] - cpu.d[i]).max() <= 2,
                f"fleet {i}: card and CPU energy allocations differ beyond a remainder tie")
    require(ties <= TIE_SHARE * b, f"{ties} remainder ties between card and CPU (energy)")
    spent = np.where(card.d > 0, e2 * card.tau * card.d + e1 * card.d + e0, 0.0)
    violations = int((spent > ebr * (1 + 1e-9)).sum())
    require(violations == 0, f"{violations} learners over budget in the card's energy solve")
    # learners whose tau the budget caps below what the deadline allows
    with np.errstate(divide="ignore", invalid="ignore"):
        tau_time = np.floor((free.T - c0 - c1 * card.d) / (c2 * card.d))
        tau_energy = np.floor((ebr - e0 - e1 * card.d) / (e2 * card.d))
    binding = float(((card.d > 0) & (tau_energy < tau_time)).mean())
    stale = sb.batched_max_staleness(card.tau, card.valid)
    print(f"solve_energy_batched B={b}: card {solve_wall_ms:.1f} ms first call, "
          f"{warm_ms:.1f} ms warm (host clock, copies in), CPU {cpu_ms:.1f} ms; energy "
          f"water-fillings per solve {solve_launches['waterfill_energy_residual']}; card "
          f"split (CUDA events): mask + bisection {stage_ms[0]:.2f} ms "
          f"({relax_rounds['grow']} grow + {relax_rounds['bisection']} bisection steps), "
          f"integerize {stage_ms[1]:.2f} ms ({int_rounds} rounds), SAI {stage_ms[2]:.2f} ms "
          f"({sai_rounds} rounds); fleets differing card vs CPU: {ties}; budget violations "
          f"0; learners whose tau the budget caps {100 * binding:.1f}%; max staleness mean "
          f"{stale.mean():.3f}, worst {stale.max()}")

    # -- 7c. the energy main path: run_async_experiment under BatteryDrift ------
    horizon = CYCLES * T_CYCLE
    free = build_energy_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    blind = solve_kkt_sai(free)
    eb = BUDGET_FRAC * float(np.median(free.energy.cycle_energy(blind.tau, blind.d)))
    prob = dataclasses.replace(free, e_budget=eb)

    def battery():
        return BatteryDrift(energy=prob.energy, capacity_j=2 * eb, recharge_j=0.25 * eb,
                            p_plugged=0.5, seed=SEED, base=CapacityDrift(seed=SEED))

    energy_launches = 0
    for mode, extra in ASYNC_MODES.items():
        cfg = ae.AsyncConfig(mode=mode, scheme="kkt_energy", reallocate=True, **extra)
        cpu_s = cpu_schedule(train, horizon, prob, cfg, battery(), "waterfill_energy_residual")
        n_groups = len(cpu_s["groups"])
        sched = cpu_s["sched"]
        require(sched.energy_violations == 0, f"{mode}: the CPU schedule overspends")
        want = {"eager": {"train_agg_step": 0, "accum_flush": 0},
                "grouped": {"train_agg_step": n_groups, "accum_flush": n_groups * leaves}}
        runs = {}
        for path in ("eager", "grouped", "grouped warm"):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_async_experiment(
                problem=prob, cycles=CYCLES, seed=SEED, mode=mode, scheme="kkt_energy",
                drift=battery(), reallocate=True, bucketed=path != "eager", train=train,
                test=test, buffer_size=extra.get("buffer_size", 0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches()
            key = path.split()[0]
            require(counts == {**want[key], "fed_agg": 0, "waterfill_residual": 0,
                               "waterfill_energy_residual": cpu_s["solves"],
                               "flash_attention": 0, "wkv6": 0, "mamba_scan": 0,
                               "swiglu": 0},
                    f"{mode} energy {path}: kernel launches {counts}, CPU solves "
                    f"{cpu_s['solves']}")
            hist = res["history"]
            check_rows(hist, cpu_s["rows"], f"{mode} energy {path}")
            led = res["summary"]["energy"]
            require(led["violations"] == 0, f"{mode} energy {path}: {led['violations']} "
                    "budget violations")
            require(np.array_equal(np.asarray(led["per_learner"]), sched.energy_spent),
                    f"{mode} energy {path}: the ledger differs from the CPU schedule's")
            require(res["summary"]["faults"] == sched.counters,
                    f"{mode} energy {path}: counters differ from the CPU schedule's")
            accs = [r["accuracy"] for r in hist]
            require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
                    f"{mode} energy {path}: accuracies out of range")
            runs[path] = {"ms": 1e3 * wall / len(hist), "accs": accs, "counts": counts}
        energy_launches += runs["grouped"]["counts"]["waterfill_energy_residual"]
        rows_ = device_time_by_kernel(lambda: run_async_experiment(
            problem=prob, cycles=CYCLES, seed=SEED, mode=mode, scheme="kkt_energy",
            drift=battery(), reallocate=True, bucketed=True, train=train, test=test,
            buffer_size=extra.get("buffer_size", 0)))
        wall_ms = runs["grouped warm"]["ms"] * len(cpu_s["rows"])
        busy = sum(ms for _, ms, _ in rows_)
        gap = max(abs(a - e) for a, e in zip(runs["grouped"]["accs"], runs["eager"]["accs"]))
        require(gap <= ASYNC_ACC_TOL, f"{mode} energy: grouped and eager accuracies differ "
                f"by {gap:g} > {ASYNC_ACC_TOL}")
        print(f"run_async_experiment mode={mode} kkt_energy BatteryDrift k={K} "
              f"cycles={CYCLES}: {len(cpu_s['rows'])} aggregations in {n_groups} groups, "
              f"tau up to {sched.max_tau}, d up to {sched.d_cap}; joules by learner "
              f"{np.round(sched.energy_spent, 2).tolist()} (budget {eb:.4f} J a dispatch), "
              f"0 violations; final accuracy grouped {runs['grouped']['accs'][-1]:.4f}, "
              f"eager {runs['eager']['accs'][-1]:.4f} (max gap {gap:.4f}); ms per "
              f"aggregation grouped {runs['grouped']['ms']:.2f} (first), "
              f"{runs['grouped warm']['ms']:.2f} (warm), eager {runs['eager']['ms']:.2f}; "
              f"launches grouped {runs['grouped']['counts']}")
        print(f"  device busy {busy:.1f} ms (torch.profiler) of {wall_ms:.1f} ms warm wall "
              f"({100 * (1 - busy / wall_ms):.0f}% idle) in {sum(n for *_, n in rows_)} "
              f"launches" if rows_ else "  device time not measured (no device events)")
        for name, ms, calls in rows_[:6]:
            print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")
    require(energy_launches > 0, "the energy main path launched no energy water-filling")

    budgeted = prob

    # -- 7d. churn: the buffered run under a Markov availability chain --------
    prob = build_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    faults = dict(drop_rate=CHURN_P_DROP / 2, straggler_rate=0.2, straggler_factor=3.0,
                  delay_rate=0.2, delay_mean=0.5 * T_CYCLE, deadline=2.5 * T_CYCLE,
                  retry_backoff=0.25 * T_CYCLE, retry_backoff_cap=T_CYCLE, quorum=2,
                  flush_timeout=1.5 * T_CYCLE)

    def churn():
        return MarkovAvailability(p_drop=CHURN_P_DROP, p_join=0.5, seed=SEED,
                                  base=CapacityDrift(seed=SEED))

    cfg = ae.AsyncConfig(mode="buffered", buffer_size=5, reallocate=True, **faults)
    cpu_s = cpu_schedule(train, horizon, prob, cfg, churn(), "waterfill_residual")
    counters = cpu_s["sched"].counters
    require(counters["offline_deferrals"] >= 1, "the churn schedule deferred no dispatch")
    nblocks = len(cpu_s["masks"])
    rows_c, alloc_c, masks_c = solve_rows_availability("kkt_sai", churn(), prob, nblocks,
                                                       label="block {}", device=dev)
    require(np.array_equal(masks_c, cpu_s["masks"]), "the card's churn masks differ")
    rows_h, alloc_h, _ = solve_rows_availability("kkt_sai", churn(), prob, nblocks,
                                                 label="block {}", device="cpu")
    require(all(np.array_equal(a, h) for a, h in zip((*rows_c, *alloc_c),
                                                     (*rows_h, *alloc_h))),
            "the card's masked re-solves differ from the CPU's")
    n_groups = len(cpu_s["groups"])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_async_experiment(problem=prob, cycles=CYCLES, seed=SEED, mode="buffered",
                               drift=churn(), reallocate=True, bucketed=True, train=train,
                               test=test, buffer_size=5, faults=faults)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    require(counts == {"train_agg_step": n_groups, "accum_flush": n_groups * leaves,
                       "fed_agg": 0, "waterfill_residual": cpu_s["solves"],
                       "waterfill_energy_residual": 0, "flash_attention": 0, "wkv6": 0,
                       "mamba_scan": 0, "swiglu": 0},
            f"churn run: kernel launches {counts}, CPU solves {cpu_s['solves']}")
    check_rows(res["history"], cpu_s["rows"], "churn run")
    require(res["summary"]["faults"] == counters, "churn run: counters differ from the CPU's")
    accs = [r["accuracy"] for r in res["history"]]
    require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
            "churn run: accuracies out of range")
    print(f"run_async_experiment buffered churn MarkovAvailability(p_drop={CHURN_P_DROP}) "
          f"k={K} cycles={CYCLES}: online by block {cpu_s['masks'].sum(1).tolist()}, "
          f"{len(accs)} aggregations in {n_groups} groups, counters "
          f"{ {n: v for n, v in counters.items() if v} }; final accuracy {accs[-1]:.4f}; "
          f"{1e3 * wall / len(accs):.2f} ms per aggregation; launches {counts}")

    # -- 7e. budgeted pgd on the card ------------------------------------------
    energy_launches += pgd_step(dev, budgeted)

    return {"name": "waterfill_energy_residual", "route": "cuda",
            "source": "src/repro_torch/csrc/waterfill.cu",
            "replaces": "src/repro/kernels/waterfill.py:117",
            "launches": energy_launches, "max_abs_err": ew_err[torch.float64],
            "ms": f64["ms"], "plain_ms": f64["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "bytes" if f64["bytes_ms"] >= f64["ops_ms"] else "operations",
            "library_ms": None}


def pgd_step(dev, prob) -> int:
    """Phase 7e: budgeted ``pgd`` re-solves (``solve_policy_row``, float64)
    and the per-problem ``solve_pgd_jax`` (float32) on the card against the
    CPU. The 600-step gradient stage is chaotic (a start one ulp away moves
    the budgeted allocation tens of samples; ``tests/test_torch_solver_numeric.py``),
    so card and CPU are held to the same feasibility, sample sum and budget,
    and their distance is reported. Returns the re-solves' energy
    water-filling launches."""
    import numpy as np
    import torch

    from repro_torch.core import CapacityDrift
    from repro_torch.core.staleness import max_staleness
    from repro_torch.fed.orchestrator import _solver, solve_policy_row

    c2s, c1s, c0s = CapacityDrift(seed=SEED).coefficient_path(prob.time_model, PGD_RESOLVES)
    eb = prob.energy_rows()[3]

    def resolves(device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = [solve_policy_row("pgd", c2s[c], c1s[c], c0s[c], prob, label=f"pgd row {c}",
                                 device=device) for c in range(PGD_RESOLVES)]
        torch.cuda.synchronize()
        return rows, 1e3 * (time.perf_counter() - t0) / PGD_RESOLVES

    reset_launches()
    card, card_ms = resolves(dev)
    counts = read_launches()
    require(counts == {"train_agg_step": 0, "accum_flush": 0, "fed_agg": 0,
                       "waterfill_residual": 0, "waterfill_energy_residual": PGD_RESOLVES,
                       "flash_attention": 0, "wkv6": 0, "mamba_scan": 0, "swiglu": 0},
            f"budgeted pgd re-solves: kernel launches {counts}, want one energy "
            f"water-filling each of {PGD_RESOLVES}")
    cpu, cpu_ms = resolves("cpu")
    same, dmax, sgap = 0, 0, 0
    for c, ((tau, d), (tau_h, d_h)) in enumerate(zip(card, cpu)):
        require(int(d.sum()) == int(d_h.sum()) == prob.total_samples,
                f"pgd row {c}: sample sums card {d.sum()}, CPU {d_h.sum()}")
        for name, (t_, d_) in (("card", (tau, d)), ("CPU", (tau_h, d_h))):
            require(bool((prob.energy.cycle_energy(t_, d_) <= eb * (1 + 1e-9)).all()),
                    f"pgd row {c}: the {name}'s allocation overspends its budget")
        same += int(np.array_equal(tau, tau_h) and np.array_equal(d, d_h))
        dmax = max(dmax, int(np.abs(d - d_h).max()))
        sgap = max(sgap, abs(max_staleness(tau) - max_staleness(tau_h)))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = _solver("pgd", dev)(prob)
    torch.cuda.synchronize()
    one_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    one_h = _solver("pgd", "cpu")(prob)
    one_cpu_ms = 1e3 * (time.perf_counter() - t0)
    require(one.method == one_h.method == "pgd_energy_sai"
            and int(one.d.sum()) == int(one_h.d.sum()),
            f"solve_pgd_jax card {one.method}/{one.d.sum()} vs CPU {one_h.method}/"
            f"{one_h.d.sum()}")
    require(bool((prob.energy.cycle_energy(one.tau, one.d) <= eb * (1 + 1e-9)).all()),
            "solve_pgd_jax on the card overspends its budget")
    print(f"budgeted pgd k={prob.num_learners}: {PGD_RESOLVES} solve_policy_row re-solves "
          f"(float64) {card_ms:.1f} ms each on the card, {cpu_ms:.1f} ms on the CPU (host "
          f"clock); launches {counts}; equal to the CPU on {same} of {PGD_RESOLVES} rows, "
          f"max |d card - d CPU| {dmax}, max staleness gap {sgap}; solve_pgd_jax (float32) "
          f"{one_ms:.1f} ms on the card, {one_cpu_ms:.1f} ms on the CPU, max |d card - d "
          f"CPU| {int(np.abs(one.d - one_h.d).max())}, max staleness "
          f"{max_staleness(one.tau)} / {max_staleness(one_h.tau)}; 0 budget violations")
    return counts["waterfill_energy_residual"]


def serve_breakdown(arch, model, params, cache, tokens, tok, t0, t1, t2, gen) -> None:
    """Device time by kernel (``torch.profiler``) over one more prefill and
    one more decode step (at the cache's last position), beside the wall
    time of the timed prefill (t0 to t1) and decode step (t1 to t2, over
    ``gen - 1`` steps): the device's idle share of each."""
    from repro_torch.launch import serve

    s = tokens.shape[1]
    for what, fn, wall_ms in (
            ("prefill", lambda: serve.prefill(model, params, tokens, s + gen),
             1e3 * (t1 - t0)),
            ("decode step", lambda: serve.decode(model, params, cache, tok, s + gen - 1, 1),
             1e3 * (t2 - t1) / (gen - 1))):
        rows = device_time_by_kernel(fn)
        busy = sum(ms for _, ms, _ in rows)
        print(f"serve {arch} {what}: device busy {busy:.2f} ms (torch.profiler) of "
              f"{wall_ms:.2f} ms wall ({100 * (1 - busy / wall_ms):.0f}% idle) in "
              f"{sum(n for *_, n in rows)} launches" if rows else
              f"serve {arch} {what}: device time not measured (no device events)")
        # the most time first, and the repository's own kernels wherever they rank
        for name, ms, calls in rows[:10] + [row for row in rows[10:]
                                           if "(anonymous namespace)::" in row[0]]:
            print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")


@contextlib.contextmanager
def plain_attention():
    """``ops.flash_attention`` bound to its plain version, the chunked scan
    ``models.layers.flash_attention`` (what the CPU runs), for the duration;
    restored on leaving. This script's comparison only: the package has no
    such switch, and on the card it always launches the kernel."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    kernel = ops.flash_attention
    ops.flash_attention = layers.flash_attention
    try:
        yield
    finally:
        ops.flash_attention = kernel


def attention_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through: the work of these inputs."""
    import numpy as np

    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_case(dev, name, b, s, h, kvh, d, dtype, causal, window, iters) -> dict:
    """Phase 8a, one case: the kernel against its plain version (in bf16
    also against the float32 kernel), timed with its plain version, its
    bound and ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref
    from repro_torch.models import layers

    dtype = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + s + d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    kw = dict(causal=causal, window=window)
    score_bytes = 4 * b * s * h * s
    if score_bytes <= DENSE_REF_BYTES:
        plain_name, plain = "dense ref.flash_attention_ref", ref.flash_attention_ref
    else:
        plain_name, plain = "chunked layers.flash_attention", layers.flash_attention
    got = flash_attention.flash_attention_cuda(q, k, v, **kw)
    want = plain(q, k, v, **kw)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{name}: the kernel gave non-finite values")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    tol = FLASH_TOL[str(dtype).removeprefix("torch.")]
    require(err <= tol * scale, f"{name}: the kernel differs from its plain version "
            f"({plain_name}) by {err:g} > {tol} x {scale:g}")
    f32_step_err = None
    if dtype == torch.bfloat16:
        # the tensor-core kernel against the float32 (CUDA-core) kernel on the
        # same inputs widened: within one bf16 step of the output's scale
        f32 = flash_attention.flash_attention_cuda(q.float(), k.float(), v.float(), **kw)
        f32 = f32.to(torch.bfloat16).float()
        f32_step_err = (got.float() - f32).abs().max().item()
        step = 2.0 ** (math.floor(math.log2(f32.abs().max().item())) - 7)
        del f32
        require(f32_step_err <= step, f"{name}: the bf16 kernel differs from the float32 "
                f"kernel by {f32_step_err:g}, more than one bf16 step ({step:g})")
    ms = cuda_ms(lambda: flash_attention.flash_attention_cuda(q, k, v, **kw), iters)
    plain_ms = cuda_ms(lambda: plain(q, k, v, **kw), max(2, iters // 4))
    # the library call, in its (B, H, S, d) layout; a window goes in as a
    # boolean mask, with the kv heads repeated (the masked kernels take no
    # grouped heads)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window is None:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)
    else:
        pos = torch.arange(s, device=dev)
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
        kt, vt = (t.repeat_interleave(h // kvh, dim=1) for t in (kt, vt))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    lib_err = (library().transpose(1, 2).float() - want.float()).abs().max().item()
    library_ms = cuda_ms(library, iters)
    pairs = attention_pairs(s, s, causal, window)
    flops = 4 * b * h * d * pairs
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES_PER_S
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err}
    print(f"flash_attention {name}: B {b}, S {s}, {h}/{kvh} heads, d {d}, "
          f"{str(dtype).removeprefix('torch.')}, causal {causal}, window {window}: "
          f"max_abs_err {err:.3g} vs {plain_name} (<= {tol} x {scale:.3g}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (max_abs_err "
          f"{lib_err:.3g}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{flops:.4g} FLOPs at {peak / 1e12:g} TFLOP/s, {nbytes:.4g} bytes); kernel at "
          f"{flops / (ms * 1e9):.1f} TFLOP/s, sdpa at {flops / (library_ms * 1e9):.1f}"
          + ("" if f32_step_err is None else
             f"; vs the float32 kernel {f32_step_err:.3g} (<= one bf16 step)"))
    return row


def serve_phase(dev) -> dict:
    """Phase 8; returns the attention kernel's entry of the kernels line."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    # -- 8a. the kernel against its plain version at the path's shapes -------
    rows = [flash_case(dev, *case) for case in FLASH_CASES]
    main_case = rows[0]
    torch.cuda.empty_cache()

    # -- 8b. the serve at full width -------------------------------------------
    cfg = get_config(SERVE_ARCH)
    b, s, gen = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = serve.prompt_tokens(cfg, b, s, SEED, dev)
    with torch.inference_mode():
        serve.prefill(model, params, tokens, s + gen)       # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        logits, cache, tok = serve.prefill(model, params, tokens, s + gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_prefill = read_launches()
        rest, _ = serve.decode(model, params, cache, tok, s, gen - 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after_decode = read_launches()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        tokens_out = torch.cat([tok, rest], dim=1)
        nothing = {name: 0 for name in after_decode}
        require(after_prefill == {**nothing, "flash_attention": cfg.num_layers},
                f"the prefill's kernel launches were {after_prefill}, want "
                f"{cfg.num_layers} flash_attention and no other")
        require(after_decode == after_prefill,
                f"decode launched kernels: {after_prefill} after the prefill, "
                f"{after_decode} after decode")
        require(tuple(logits.shape) == (b, 1, cfg.vocab_size)
                and bool(torch.isfinite(logits).all()), "the prefill's logits are not "
                f"finite of shape ({b}, 1, {cfg.vocab_size})")
        require(tuple(tokens_out.shape) == (b, gen) and int(tokens_out.min()) >= 0
                and int(tokens_out.max()) < cfg.vocab_size, "generated tokens out of range")
        require(all(bool(torch.isfinite(t).all()) for blk in cache["blocks"]
                    for t in blk["mixer"].values()), "the KV cache is not finite")
        # where the time goes: device time by kernel over one prefill and
        # one decode step (the cache's last free slot), beside their wall time
        serve_breakdown(SERVE_ARCH, model, params, cache, tokens, tok, t0, t1, t2, gen)
        with plain_attention():
            p_logits, p_cache, p_tok = serve.prefill(model, params, tokens, s + gen)
            p_rest, _ = serve.decode(model, params, p_cache, p_tok, s, gen - 1)
        del p_cache
        p_tokens = torch.cat([p_tok, p_rest], dim=1)
        err = (logits.float() - p_logits.float()).abs().max().item()
        scale = p_logits.float().abs().max().item()
        require(err <= SERVE_BF16_TOL * scale, f"the bf16 serve's logits differ from the "
                f"plain attention's by {err:g} > {SERVE_BF16_TOL} x {scale:g}")
    del cache
    prefill_ms, decode_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (gen - 1)
    agree = float((tokens_out == p_tokens).float().mean().item())
    first = float((tokens_out[:, 0] == p_tokens[:, 0]).float().mean().item())
    print(f"serve {SERVE_ARCH} ({model.param_count()} params, {cfg.param_dtype}): init "
          f"{init_s:.1f} s (drawn on the host, copied to the card); prefill {b}x{s} "
          f"{prefill_ms:.1f} ms; decode {gen - 1} steps {decode_ms:.2f} ms a step "
          f"({b * 1e3 / decode_ms:.1f} tok/s); peak memory {peak_gb:.2f} GB; launches "
          f"prefill {after_prefill['flash_attention']}, decode "
          f"{after_decode['flash_attention'] - after_prefill['flash_attention']}; "
          f"last-position logits vs plain attention max_abs_err {err:.3g}, "
          f"{err / scale:.3g} of their scale {scale:.3g} (<= {SERVE_BF16_TOL}); greedy agreement with plain: first token "
          f"{first:.2f}, all {gen} tokens {agree:.3f}; sample {tokens_out[0, :8].tolist()}")

    # -- 8c. float32 at 2 layers: kernel vs plain, tight -----------------------
    cfg32 = dataclasses.replace(cfg, num_layers=E2E_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    m32 = Model(cfg32, device=dev)
    p32 = {name: (leaf.float() if torch.is_tensor(leaf) else leaf)
           for name, leaf in params.items() if name != "blocks"}
    p32["blocks"] = [{name: {n: t[:E2E_LAYERS].float() for n, t in sub.items()}
                      if isinstance(sub, dict) else sub[:E2E_LAYERS].float()
                      for name, sub in blk.items()} for blk in params["blocks"]]
    del params
    torch.cuda.empty_cache()
    runs = {}
    with torch.inference_mode():
        for name, ctx in (("kernel", contextlib.nullcontext()), ("plain", plain_attention())):
            with ctx:
                lg, c32, t = serve.prefill(m32, p32, tokens, s + E2E_STEPS + 1)
                steps, logits_seq = [t], [lg]
                for i in range(E2E_STEPS):
                    lg, c32 = m32.decode(p32, c32, t, s + i)
                    t = torch.argmax(lg[:, -1:], dim=-1)
                    steps.append(t)
                    logits_seq.append(lg)
                runs[name] = (torch.cat(steps, dim=1), logits_seq)
                del c32
    e2e_err = max((a - w).abs().max().item() / w.abs().max().item()
                  for a, w in zip(runs["kernel"][1], runs["plain"][1]))
    require(e2e_err <= E2E_TOL, f"float32 {E2E_LAYERS}-layer serve: logits differ from "
            f"plain attention by {e2e_err:g} of their scale > {E2E_TOL}")
    require(torch.equal(runs["kernel"][0], runs["plain"][0]),
            f"float32 {E2E_LAYERS}-layer serve: greedy tokens differ from plain attention")
    print(f"float32 {E2E_LAYERS}-layer {SERVE_ARCH} serve {b}x{s}, kernel vs plain "
          f"attention: logits max relative error {e2e_err:.3g} (<= {E2E_TOL}) over the "
          f"prefill and {E2E_STEPS} decode steps; greedy tokens equal "
          f"({runs['kernel'][0].numel()})")
    del p32
    torch.cuda.empty_cache()

    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:91",
            "launches": after_decode["flash_attention"], **main_case}


@contextlib.contextmanager
def plain_wkv():
    """``ops.wkv6`` bound to its plain version, the step loop
    ``ref.wkv6_ref`` (what the CPU runs), for the duration; restored on
    leaving. This script's comparison only: the package has no such
    switch, and on the card it always launches the kernel."""
    from repro_torch.kernels import ops, ref

    kernel = ops.wkv6

    def plain(r, k, v, w, u, s0=None, *, out_state=None, **_):
        y, s_last = ref.wkv6_ref(r, k, v, w, u, s0)
        return y, (s_last if out_state is None else out_state.copy_(s_last))

    ops.wkv6 = plain
    try:
        yield
    finally:
        ops.wkv6 = kernel


def wkv_case(dev, name, b, s, h, hd, dtype, with_state, in_place, iters) -> dict:
    """Phase 9a, one case: the kernel against the step loop, timed with it
    and beside its bound. ``in_place``: the kernel writes the state over a
    copy of s0, as decode writes the cache."""
    import torch

    from repro_torch.kernels import ref, wkv6

    dtype = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + s + hd)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = (randn(b, s, h, hd).mul_(0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, s, h, hd) - 1.0))
    u = randn(h, hd).mul_(0.1)
    s0 = randn(b, h, hd, hd).mul_(0.1) if with_state else None
    state = s0.clone() if in_place else None
    got_y, got_s = wkv6.wkv6_cuda(r, k, v, w, u, state if in_place else s0, out_state=state)
    want_y, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    require(not in_place or got_s.data_ptr() == state.data_ptr(),
            f"wkv6 {name}: the state was not written over s0")
    err = 0.0
    for what, got, want in (("y", got_y, want_y), ("s_last", got_s, want_s)):
        require(bool(torch.isfinite(got).all()), f"wkv6 {name}: non-finite {what}")
        e = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        require(e <= WKV_TOL * scale, f"wkv6 {name}: the kernel's {what} differs from the "
                f"step loop's by {e:g} > {WKV_TOL} x {scale:g}")
        err = max(err, e)

    def kernel():
        return wkv6.wkv6_cuda(r, k, v, w, u, state if in_place else s0, out_state=state)

    # the least of three timings: CUDA events also count the gaps when the
    # host stalls between launches (the serve's profile in 9b gives the
    # device time a launch)
    ms = min(cuda_ms(kernel, iters) for _ in range(3))
    plain_ms = cuda_ms(lambda: ref.wkv6_ref(r, k, v, w, u, s0), max(2, iters // 5))
    # r, k, v read once in their dtype, w read and y written in float32, u
    # and s0 read once, s_last written once; the least work: y_j = sum_i
    # r_i S_ij + v_j sum_i r_i u_i k_i and S_ij <- w_i S_ij + k_i v_j, 5
    # float32 operations per (b, h, t, i, j) and 5 per (b, h, t, j)
    n = b * s * h * hd
    nbytes = (3 * r.element_size() * n + 4 * 2 * n + 4 * h * hd
              + 4 * b * h * hd * hd * (2 if with_state else 1))
    flops = 5 * b * h * s * (hd * hd + hd)
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err}
    print(f"wkv6 {name}: B {b}, S {s}, {h} heads of {hd}, {str(dtype).removeprefix('torch.')} "
          f"r/k/v, s0 {'given' if with_state else 'none'}{', state in place' if in_place else ''}: "
          f"max_abs_err {err:.3g} (<= {WKV_TOL} x max(1, scale)); kernel {ms:.4f} ms "
          f"(CUDA events, the least of 3 timings), plain {plain_ms:.3f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops:.4g} FP32 FLOPs at "
          f"{PEAK_FP32_FLOPS / 1e12:g} TFLOP/s, {nbytes:.4g} bytes); kernel at "
          f"{flops / (ms * 1e9):.1f} TFLOP/s, "
          f"{row['bound_ms'] / ms:.3f} of the bound")
    return row


def rwkv_phase(dev) -> dict:
    """Phase 9; returns the WKV kernel's entry of the kernels line."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    # -- 9a. the kernel against the step loop at the path's shapes -----------
    rows = [wkv_case(dev, *case) for case in WKV_CASES]
    main_case = rows[0]
    torch.cuda.empty_cache()

    # -- 9b. the serve at full width -------------------------------------------
    cfg = get_config(RWKV_ARCH)
    b, s, gen = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = serve.prompt_tokens(cfg, b, s, SEED, dev)
    with torch.inference_mode():
        serve.prefill(model, params, tokens, s + gen)       # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        logits, cache, tok = serve.prefill(model, params, tokens, s + gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_prefill = read_launches()
        rest, _ = serve.decode(model, params, cache, tok, s, gen - 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after_decode = read_launches()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        tokens_out = torch.cat([tok, rest], dim=1)
        nothing = {name: 0 for name in after_decode}
        layers = cfg.num_layers
        require(after_prefill == {**nothing, "wkv6": layers},
                f"the prefill's kernel launches were {after_prefill}, want {layers} wkv6 "
                "and no other")
        require(after_decode == {**nothing, "wkv6": layers * gen},
                f"the serve's kernel launches were {after_decode} after {gen - 1} decode "
                f"steps, want {layers} wkv6 a step and no other")
        require(tuple(logits.shape) == (b, 1, cfg.vocab_size)
                and bool(torch.isfinite(logits).all()), "the prefill's logits are not "
                f"finite of shape ({b}, 1, {cfg.vocab_size})")
        require(tuple(tokens_out.shape) == (b, gen) and int(tokens_out.min()) >= 0
                and int(tokens_out.max()) < cfg.vocab_size, "generated tokens out of range")
        require(all(bool(torch.isfinite(t).all()) for blk in cache["blocks"]
                    for part in blk.values() for t in part.values()),
                "the RWKV state cache is not finite")
        serve_breakdown(RWKV_ARCH, model, params, cache, tokens, tok, t0, t1, t2, gen)
        with plain_wkv():
            p_logits, p_cache, p_tok = serve.prefill(model, params, tokens, s + gen)
            p_rest, _ = serve.decode(model, params, p_cache, p_tok, s, gen - 1)
        del p_cache
        p_tokens = torch.cat([p_tok, p_rest], dim=1)
        err = (logits.float() - p_logits.float()).abs().max().item()
        scale = p_logits.float().abs().max().item()
        require(err <= SERVE_BF16_TOL * scale, f"the bf16 RWKV-6 serve's logits differ from "
                f"the step loop's by {err:g} > {SERVE_BF16_TOL} x {scale:g}")
    del cache
    prefill_ms, decode_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (gen - 1)
    agree = float((tokens_out == p_tokens).float().mean().item())
    first = float((tokens_out[:, 0] == p_tokens[:, 0]).float().mean().item())
    print(f"serve {RWKV_ARCH} ({model.param_count()} params, {cfg.param_dtype}): init "
          f"{init_s:.1f} s (drawn on the host, copied to the card); prefill {b}x{s} "
          f"{prefill_ms:.1f} ms; decode {gen - 1} steps {decode_ms:.2f} ms a step "
          f"({b * 1e3 / decode_ms:.1f} tok/s); peak memory {peak_gb:.2f} GB; wkv6 launches "
          f"prefill {after_prefill['wkv6']}, decode "
          f"{after_decode['wkv6'] - after_prefill['wkv6']}; last-position logits vs the "
          f"step loop max_abs_err {err:.3g}, {err / scale:.3g} of their scale {scale:.3g} "
          f"(<= {SERVE_BF16_TOL}); greedy agreement with the step loop: first token "
          f"{first:.2f}, all {gen} tokens {agree:.3f}; sample {tokens_out[0, :8].tolist()}")

    # -- 9c. float32 at 2 layers: kernel vs plain, tight -----------------------
    cfg32 = dataclasses.replace(cfg, num_layers=E2E_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    m32 = Model(cfg32, device=dev)
    p32 = {name: (leaf.float() if torch.is_tensor(leaf) else leaf)
           for name, leaf in params.items() if name != "blocks"}
    p32["blocks"] = [{name: {n: t[:E2E_LAYERS].float() for n, t in sub.items()}
                      if isinstance(sub, dict) else sub[:E2E_LAYERS].float()
                      for name, sub in blk.items()} for blk in params["blocks"]]
    del params
    torch.cuda.empty_cache()
    runs = {}
    with torch.inference_mode():
        for name, ctx in (("kernel", contextlib.nullcontext()), ("plain", plain_wkv())):
            with ctx:
                lg, c32, t = serve.prefill(m32, p32, tokens, s + E2E_STEPS + 1)
                steps, logits_seq = [t], [lg]
                for i in range(E2E_STEPS):
                    lg, c32 = m32.decode(p32, c32, t, s + i)
                    t = torch.argmax(lg[:, -1:], dim=-1)
                    steps.append(t)
                    logits_seq.append(lg)
                runs[name] = (torch.cat(steps, dim=1), logits_seq)
                del c32
    e2e_err = max((a - w).abs().max().item() / w.abs().max().item()
                  for a, w in zip(runs["kernel"][1], runs["plain"][1]))
    require(e2e_err <= E2E_TOL, f"float32 {E2E_LAYERS}-layer RWKV-6 serve: logits differ "
            f"from the step loop by {e2e_err:g} of their scale > {E2E_TOL}")
    require(torch.equal(runs["kernel"][0], runs["plain"][0]),
            f"float32 {E2E_LAYERS}-layer RWKV-6 serve: greedy tokens differ from the step loop")
    print(f"float32 {E2E_LAYERS}-layer {RWKV_ARCH} serve {b}x{s}, kernel vs the step loop: "
          f"logits max relative error {e2e_err:.3g} (<= {E2E_TOL}) over the prefill and "
          f"{E2E_STEPS} decode steps; greedy tokens equal ({runs['kernel'][0].numel()})")
    del p32
    torch.cuda.empty_cache()

    return {"name": "wkv6", "route": "cuda", "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:58",
            "launches": after_decode["wkv6"], **main_case}



@contextlib.contextmanager
def plain_mamba():
    """``ops.mamba_scan`` bound to its plain version, the step loop
    ``ref.mamba_scan_ref`` (what the CPU runs), for the duration; restored
    on leaving. This script's comparison only: the package has no such
    switch, and on the card it always launches the kernel."""
    from repro_torch.kernels import ops, ref

    kernel = ops.mamba_scan

    def plain(dt, x, b, c, a, h0=None, *, out_state=None):
        y, h_last = ref.mamba_scan_ref(dt, x, b, c, a, h0)
        return y, (h_last if out_state is None else out_state.copy_(h_last))

    ops.mamba_scan = plain
    try:
        yield
    finally:
        ops.mamba_scan = kernel


def mamba_case(dev, name, b, s, d, n, dtype, with_state, in_place, iters) -> dict:
    """Phase 10a, one case: the kernel against the step loop, timed with it
    and beside its bound. ``in_place``: the kernel writes the state over a
    copy of h0, as a caller updating its state would."""
    import torch

    from repro_torch.kernels import mamba_scan, ref

    dtype = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + s + d)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # dt around softplus(-4.6), a near the S4D init -(n + 1), as the layer makes them
    dt = torch.nn.functional.softplus(randn(b, s, d).mul_(2.0).sub_(4.6))
    x = randn(b, s, d).to(dtype)
    bm, cm = randn(b, s, n), randn(b, s, n)
    a = -torch.exp(torch.log(torch.arange(1, n + 1, device=dev, dtype=torch.float32))
                   + randn(d, n).mul_(0.1))
    h0 = randn(b, d, n) if with_state else None
    state = h0.clone() if in_place else None
    got_y, got_h = mamba_scan.mamba_scan_cuda(dt, x, bm, cm, a, state if in_place else h0,
                                              out_state=state)
    want_y, want_h = ref.mamba_scan_ref(dt, x, bm, cm, a, h0)
    torch.cuda.synchronize()
    require(not in_place or got_h.data_ptr() == state.data_ptr(),
            f"mamba_scan {name}: the state was not written over h0")
    err = 0.0
    for what, got, want in (("y", got_y, want_y), ("h_last", got_h, want_h)):
        require(bool(torch.isfinite(got).all()), f"mamba_scan {name}: non-finite {what}")
        e = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        require(e <= MAMBA_TOL * scale, f"mamba_scan {name}: the kernel's {what} differs "
                f"from the step loop's by {e:g} > {MAMBA_TOL} x {scale:g}")
        err = max(err, e)

    def kernel():
        return mamba_scan.mamba_scan_cuda(dt, x, bm, cm, a, state if in_place else h0,
                                          out_state=state)

    # the least of three timings, as phase 9a takes them
    ms = min(cuda_ms(kernel, iters) for _ in range(3))
    plain_ms = cuda_ms(lambda: ref.mamba_scan_ref(dt, x, bm, cm, a, h0), 2)
    # dt read and y written in float32, x read once in its dtype, b, c and a
    # read once, h0 read and h_last written once; the least work: dt a, its
    # exponential, h da + (dt x) B and the y sum, 6 float32 operations per
    # (b, t, d, n) counting the exponential as one, and dt x per (b, t, d)
    nbytes = ((8 + x.element_size()) * b * s * d + 4 * 2 * b * s * n + 4 * d * n
              + 4 * b * d * n * (2 if with_state else 1))
    flops = 6 * b * s * d * n + b * s * d
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err}
    print(f"mamba_scan {name}: B {b}, S {s}, D {d}, N {n}, "
          f"{str(dtype).removeprefix('torch.')} x, h0 {'given' if with_state else 'none'}"
          f"{', state in place' if in_place else ''}: max_abs_err {err:.3g} (<= {MAMBA_TOL} "
          f"x max(1, scale)); kernel {ms:.4f} ms (CUDA events, the least of 3 timings), "
          f"plain {plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{nbytes:.4g} bytes, {flops:.4g} FP32 operations at {PEAK_FP32_FLOPS / 1e12:g} "
          f"TFLOP/s); {row['bound_ms'] / ms:.3f} of the bound, "
          f"{b * s * d * n / (ms * 1e9):.1f} G state updates/s")
    return row


def _widened(tree, layers: int):
    """A float32 copy of a params tree, its stacked blocks cut to their
    first ``layers`` period positions."""
    def widen(t):
        if isinstance(t, dict):
            return {k: widen(v) for k, v in t.items()}
        if isinstance(t, list):
            return [widen(v) for v in t]
        return None if t is None else t.float()

    out = {k: widen(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = widen(tree["blocks"][:layers])
    return out


def jamba_phase(dev) -> dict:
    """Phase 10; returns the scan kernel's entry of the kernels line."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    # -- 10a. the kernel against the step loop at the path's shapes ----------
    rows = [mamba_case(dev, *case) for case in MAMBA_CASES]
    main_case = rows[0]
    torch.cuda.empty_cache()

    # -- 10b. the serve at full width, one period ------------------------------
    cfg = dataclasses.replace(get_config(JAMBA_ARCH), num_layers=JAMBA_LAYERS)
    kinds = cfg.layer_kinds()
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
    b, s, gen = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = serve.prompt_tokens(cfg, b, s, SEED, dev)
    with torch.inference_mode():
        serve.prefill(model, params, tokens, s + gen)       # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        logits, cache, tok = serve.prefill(model, params, tokens, s + gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_prefill = read_launches()
        rest, _ = serve.decode(model, params, cache, tok, s, gen - 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after_decode = read_launches()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        tokens_out = torch.cat([tok, rest], dim=1)
        nothing = {name: 0 for name in after_decode}
        want = {**nothing, "mamba_scan": n_mamba, "flash_attention": n_attn}
        require((n_mamba, n_attn) == (7, 1) and after_prefill == want,
                f"the prefill's kernel launches were {after_prefill}, want {want}")
        require(after_decode == after_prefill,
                f"decode launched kernels: {after_prefill} after the prefill, "
                f"{after_decode} after decode")
        require(tuple(logits.shape) == (b, 1, cfg.vocab_size)
                and bool(torch.isfinite(logits).all()), "the prefill's logits are not "
                f"finite of shape ({b}, 1, {cfg.vocab_size})")
        require(tuple(tokens_out.shape) == (b, gen) and int(tokens_out.min()) >= 0
                and int(tokens_out.max()) < cfg.vocab_size, "generated tokens out of range")
        require(all(bool(torch.isfinite(t).all()) for blk in cache["blocks"]
                    for t in blk["mixer"].values()), "the Jamba cache is not finite")
        serve_breakdown(JAMBA_ARCH, model, params, cache, tokens, tok, t0, t1, t2, gen)
        with plain_mamba():
            p_logits, p_cache, p_tok = serve.prefill(model, params, tokens, s + gen)
            p_rest, _ = serve.decode(model, params, p_cache, p_tok, s, gen - 1)
        del p_cache
        p_tokens = torch.cat([p_tok, p_rest], dim=1)
        err = (logits.float() - p_logits.float()).abs().max().item()
        scale = p_logits.float().abs().max().item()
        require(err <= SERVE_BF16_TOL * scale, f"the bf16 Jamba serve's logits differ from "
                f"the step loop's by {err:g} > {SERVE_BF16_TOL} x {scale:g}")
    del cache
    prefill_ms, decode_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (gen - 1)
    agree = float((tokens_out == p_tokens).float().mean().item())
    first = float((tokens_out[:, 0] == p_tokens[:, 0]).float().mean().item())
    print(f"serve {JAMBA_ARCH}, {JAMBA_LAYERS} of its 32 layers ({model.param_count()} "
          f"params, {cfg.param_dtype}): init {init_s:.1f} s (drawn on the host, copied to "
          f"the card); prefill {b}x{s} {prefill_ms:.1f} ms; decode {gen - 1} steps "
          f"{decode_ms:.2f} ms a step ({b * 1e3 / decode_ms:.1f} tok/s); peak memory "
          f"{peak_gb:.2f} GB; launches prefill mamba_scan {after_prefill['mamba_scan']}, "
          f"flash_attention {after_prefill['flash_attention']}, decode none; last-position "
          f"logits vs the step loop max_abs_err {err:.3g}, {err / scale:.3g} of their scale "
          f"{scale:.3g} (<= {SERVE_BF16_TOL}); greedy agreement with the step loop: first "
          f"token {first:.2f}, all {gen} tokens {agree:.3f}; sample "
          f"{tokens_out[0, :8].tolist()}")

    # -- 10c. float32 at 2 layers (Mamba+MoE, Mamba+dense): kernel vs plain ------
    cfg32 = dataclasses.replace(cfg, num_layers=E2E_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    m32 = Model(cfg32, device=dev)
    require([(k, moe) for k, moe in zip(cfg32.layer_kinds(), cfg32.layer_is_moe())]
            == [("mamba", True), ("mamba", False)], "the float32 gate's layers are not "
            "a Mamba+MoE and a Mamba+dense layer")
    p32 = _widened(params, E2E_LAYERS)
    del params
    torch.cuda.empty_cache()
    runs = {}
    with torch.inference_mode():
        for name, ctx in (("kernel", contextlib.nullcontext()), ("plain", plain_mamba())):
            with ctx:
                reset_launches()
                lg, c32, t = serve.prefill(m32, p32, tokens, s + E2E_STEPS + 1)
                launched = read_launches()["mamba_scan"]
                steps, logits_seq = [t], [lg]
                for i in range(E2E_STEPS):
                    lg, c32 = m32.decode(p32, c32, t, s + i)
                    t = torch.argmax(lg[:, -1:], dim=-1)
                    steps.append(t)
                    logits_seq.append(lg)
                runs[name] = (torch.cat(steps, dim=1), logits_seq, launched)
                del c32
    require((runs["kernel"][2], runs["plain"][2]) == (E2E_LAYERS, 0),
            f"float32 gate: scan launches {runs['kernel'][2]} (kernel) and "
            f"{runs['plain'][2]} (plain), want {E2E_LAYERS} and 0")
    e2e_err = max((a - w).abs().max().item() / w.abs().max().item()
                  for a, w in zip(runs["kernel"][1], runs["plain"][1]))
    require(e2e_err <= E2E_TOL, f"float32 {E2E_LAYERS}-layer Jamba serve: logits differ "
            f"from the step loop by {e2e_err:g} of their scale > {E2E_TOL}")
    require(torch.equal(runs["kernel"][0], runs["plain"][0]),
            f"float32 {E2E_LAYERS}-layer Jamba serve: greedy tokens differ from the step loop")
    print(f"float32 {E2E_LAYERS}-layer {JAMBA_ARCH} serve (Mamba+MoE, Mamba+dense) {b}x{s}, "
          f"kernel vs the step loop: logits max relative error {e2e_err:.3g} (<= {E2E_TOL}) "
          f"over the prefill and {E2E_STEPS} decode steps; greedy tokens equal "
          f"({runs['kernel'][0].numel()})")
    del p32
    torch.cuda.empty_cache()

    return {"name": "mamba_scan", "route": "cuda", "source": "src/repro_torch/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan.py:61",
            "launches": after_decode["mamba_scan"], **main_case}


def swiglu_case(dev, name, m, d, f, dtype, iters) -> dict:
    """Phase 11, one case: the kernel against its plain version on the
    widened inputs, timed with it, its bound and the library call (the
    three cuBLAS products of ``layers.swiglu`` in the inputs' dtype)."""
    import torch

    from repro_torch.kernels import ref, swiglu
    from repro_torch.models import layers

    name_dtype = dtype
    dtype = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + m + f)
    x = torch.randn((m, d), generator=gen, device=dev).to(dtype)
    wg, wu = (torch.randn((d, f), generator=gen, device=dev).div_(math.sqrt(d)).to(dtype)
              for _ in range(2))
    wd = torch.randn((f, d), generator=gen, device=dev).div_(math.sqrt(f)).to(dtype)
    wide = [t.float() for t in (x, wg, wu, wd)]
    got = swiglu.swiglu_cuda(x, wg, wu, wd)
    want = ref.swiglu_ref(*wide)
    torch.cuda.synchronize()
    require(got.dtype == dtype and bool(torch.isfinite(got).all()),
            f"swiglu {name}: the kernel gave non-finite values or the wrong dtype")
    err = (got.float() - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    tol = SWIGLU_TOL[name_dtype]
    require(err <= tol * scale, f"swiglu {name}: the kernel differs from its plain version "
            f"by {err:g} > {tol} x {scale:g}")
    ms = min(cuda_ms(lambda: swiglu.swiglu_cuda(x, wg, wu, wd), iters) for _ in range(3))
    plain_ms = cuda_ms(lambda: ref.swiglu_ref(*wide), iters)
    library_ms = cuda_ms(lambda: layers.swiglu(x, wg, wu, wd), iters)
    lib_err = (layers.swiglu(x, wg, wu, wd).float() - want).abs().max().item()
    del wide
    flops = 6 * m * d * f
    nbytes = x.element_size() * (2 * m * d + 3 * d * f)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES_PER_S
    # the work the design executes on the tensor cores: in bf16 the gate and
    # up products and the down product once a piece of h; in float32 every
    # product three times (3xTF32)
    if dtype == torch.bfloat16:
        done, done_peak = (4 + 2 * swiglu.H_PIECES) * m * d * f, PEAK_BF16_FLOPS
        how = f"{swiglu.H_PIECES} bf16 pieces of h"
    else:
        done, done_peak = 3 * flops, PEAK_TF32_FLOPS
        how = "3xTF32"
    done_ms = 1e3 * done / done_peak
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err}
    print(f"swiglu {name}: m {m}, d {d}, f {f}, {name_dtype}: max_abs_err {err:.3g} vs the "
          f"float32 plain version (<= {tol:.3g} x {scale:.3g}); kernel {ms:.3f} ms (CUDA "
          f"events, the least of 3 timings), plain (float32 cuBLAS) {plain_ms:.3f} ms, "
          f"library (layers.swiglu in {name_dtype}, cuBLAS) {library_ms:.3f} ms (max_abs_err "
          f"{lib_err:.3g}), bound {row['bound_ms']:.3f} ms ({row['bound_by']}: {flops:.4g} "
          f"FLOPs at {peak / 1e12:g} TFLOP/s, {nbytes:.4g} bytes); kernel at "
          f"{flops / (ms * 1e9):.1f} TFLOP/s of the function's work, library at "
          f"{flops / (library_ms * 1e9):.1f}; the design's tensor-core work ({how}) "
          f"{done:.4g} FLOPs, bound {done_ms:.3f} ms at {done_peak / 1e12:g} TFLOP/s, "
          f"executed at {done / (ms * 1e9):.1f} TFLOP/s")
    return row


def swiglu_phase(dev) -> dict:
    """Phase 11; returns the SwiGLU kernel's entry of the kernels line. No
    model path calls the kernel (the reference's dense FFN calls the plain
    ``layers.swiglu``), so its launches are this phase's own: the entry
    point ``ops.swiglu_fused`` once at the Jamba dense-FFN shape, with the
    counters set to 0 just before."""
    import torch

    from repro_torch.kernels import ops

    rows = [swiglu_case(dev, *case) for case in SWIGLU_CASES]
    torch.cuda.empty_cache()
    _, m, d, f, dtype, _ = SWIGLU_CASES[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((SERVE_BATCH, m // SERVE_BATCH, d), generator=gen, device=dev)
    w = [torch.randn(shape, generator=gen, device=dev).div_(math.sqrt(shape[0]))
         for shape in ((d, f), (d, f), (f, d))]
    x, *w = (t.to(getattr(torch, dtype)) for t in (x, *w))
    reset_launches()
    out = ops.swiglu_fused(x, *w)
    torch.cuda.synchronize()
    counts = read_launches()
    require(counts == {**{k: 0 for k in counts}, "swiglu": 1},
            f"ops.swiglu_fused on the card: kernel launches {counts}, want one swiglu")
    require(out.shape == x.shape and bool(torch.isfinite(out).all()),
            "ops.swiglu_fused gave non-finite values or the wrong shape")
    del x, w, out
    torch.cuda.empty_cache()
    return {"name": "swiglu", "route": "cuda", "source": "src/repro_torch/csrc/swiglu.cu",
            "replaces": "src/repro/kernels/swiglu.py:48", "launches": counts["swiglu"],
            **rows[0]}


if __name__ == "__main__":
    sys.exit(main())
