#!/usr/bin/env python3
"""Hold the training kernel of ``src/repro_torch/csrc/train_step.cu`` to an
earlier version of the same file, bit for bit and in time, on one card.

    python3 tools/compare_train_step.py OLD.cu

OLD.cu is an earlier ``train_step.cu`` whose ``train_cycle_f32`` takes no
phase plan (the version of one launch a product). Both are built with the
port's nvcc flags and run on the same inputs: the paper cycle of
``chip_smoke.py`` phase 3 (K = 10, the ``solve_kkt_sai`` allocation), the
buffered run's widest flush group and the largest fedasync group of phase
6b (their CPU-built schedules), and small ragged cases with a finished
learner and an all-masked shard. Each learner's trained parameters must be
equal bitwise; the times (CUDA events, the least of three means over 5
calls) are taken in turns, old, new, new, old. Prints one line a case and
exits non-zero if any differs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def build_old(src: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = _build.BUILD / "compare" / "train_step_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.train_cycle_f32.restype = i32
    lib.train_cycle_f32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr,
                                    ptr, ptr, ctypes.c_float, i32, ptr]
    return lib


def train(lib, new: bool, disp, x, y, m, tau, lr, max_tau):
    """Each learner's parameters after ``max_tau`` steps (no aggregation)."""
    import torch

    from repro_torch.kernels import _build, train_step

    k, d_cap, feat = x.shape
    widths = [feat] + [int(layer["w"].shape[2]) for layer in disp]
    work = [{n: leaf.clone(memory_format=torch.contiguous_format) for n, leaf in layer.items()}
            for layer in disp]
    ws = torch.empty(2 * k * d_cap * sum(widths[1:]), dtype=torch.float32, device=x.device)
    rows = torch.empty(k, dtype=torch.int32, device=x.device)
    inv_den = torch.empty(k, dtype=torch.float32, device=x.device)
    n = len(work)
    counters = torch.zeros(2, dtype=torch.int32, device=x.device)
    args = [x.data_ptr(), y.data_ptr(), m.data_ptr(), tau.data_ptr(), k, d_cap, n,
            (ctypes.c_int * (n + 1))(*widths),
            (ctypes.c_void_p * n)(*[layer["w"].data_ptr() for layer in work]),
            (ctypes.c_void_p * n)(*[layer["b"].data_ptr() for layer in work]),
            ws.data_ptr(), rows.data_ptr(), inv_den.data_ptr()]
    args += [counters.data_ptr()] if new else []
    args += [float(lr), int(max_tau)]
    if new:
        plan = train_step._phase_plan(n)
        args += [train_step._plan_table(plan), len(plan)]
    code = lib.train_cycle_f32(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "train_cycle_f32")
    return work


def cases(dev):
    """(name, disp, x, y, m, tau, max_tau) at the shapes chip_smoke.py times."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import CapacityDrift, solve_kkt_sai
    from repro_torch.data.pipeline import FederatedPartitioner, synthetic_mnist
    from repro_torch.fed import async_engine as ae
    from repro_torch.fed.orchestrator import _broadcast, _stage_shards
    from repro_torch.fed.simulation import build_problem
    from repro_torch.models import mlp

    prob = build_problem(cs.K, cs.T_CYCLE, total_samples=cs.TOTAL, seed=cs.SEED)
    alloc = solve_kkt_sai(prob)
    tau, d = np.asarray(alloc.tau), np.asarray(alloc.d)
    train_set, _ = synthetic_mnist(max(2 * cs.TOTAL, 12_000), seed=cs.SEED)
    shards = FederatedPartitioner(train_set, seed=cs.SEED).draw(d)
    x, y, m = (torch.from_numpy(a).to(dev)
               for a in _stage_shards(shards, int(d.max()), train_set.x.shape[1]))
    init = mlp.init(cs.SEED, device=dev)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=dev)
    yield "paper cycle (phase 3)", _broadcast(init, cs.K), x, y, m, t(tau), int(tau.max())

    tx, ty = torch.from_numpy(train_set.x).to(dev), torch.from_numpy(train_set.y).to(dev)
    for mode, extra in cs.ASYNC_MODES.items():
        sched = cs.cpu_schedule(train_set, cs.CYCLES * cs.T_CYCLE, prob,
                                ae.AsyncConfig(mode=mode, reallocate=True, **extra),
                                CapacityDrift(seed=cs.SEED), "waterfill_residual")
        groups = sched["groups"]
        if mode == "buffered":
            group = max((g for g in groups if g[-1].flush), key=len)
            name = f"buffered flush group of {len(group)} (phase 6b)"
        else:
            group = max(groups, key=lambda g: g[0].tau * g[0].d)
            name = "fedasync group, one learner (phase 6b)"
        st = ae._stage_groups([group], mode=mode, k_fleet=cs.K, d_cap=sched["sched"].d_cap,
                              slots=None)
        idx = torch.from_numpy(np.ascontiguousarray(st.idx[0])).to(dev)
        yield (name, _broadcast(init, cs.K), tx[idx], ty[idx],
               torch.from_numpy(np.ascontiguousarray(st.m[0])).to(dev), t(st.tau[0]),
               max(int(st.tau[0].max()), 1))

    rng = np.random.default_rng(0)
    for layers, k, d_cap, taus in (([100, 70, 33, 10], 3, 70, [4, 0, 2]),
                                   ([16, 12, 10], 300, 20, [i % 4 for i in range(300)])):
        models = [mlp.init(i, layers, device=dev) for i in range(k)]
        disp = [{n: torch.stack([mm[l][n] for mm in models]) for n in models[0][l]}
                for l in range(len(layers) - 1)]
        x = torch.tensor(rng.standard_normal((k, d_cap, layers[0])), dtype=torch.float32,
                         device=dev)
        y = torch.tensor(rng.integers(0, layers[-1], (k, d_cap)), dtype=torch.int32, device=dev)
        m = torch.tensor(rng.random((k, d_cap)) < 0.8, dtype=torch.float32, device=dev)
        m[1] = 0.0
        yield f"ragged K = {k}", disp, x, y, m, t(taus), max(taus)


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_train_step: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import train_step

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    old, new = build_old(sys.argv[1]), train_step._lib()
    ok = True
    for name, disp, x, y, m, tau, max_tau in cases(dev):
        a = train(old, False, disp, x, y, m, tau, cs.LR, max_tau)
        b = train(new, True, disp, x, y, m, tau, cs.LR, max_tau)
        torch.cuda.synchronize()
        same = all(torch.equal(la[n], lb[n]) for la, lb in zip(a, b) for n in la)
        diff = max((la[n] - lb[n]).abs().max().item() for la, lb in zip(a, b) for n in la)
        ok &= same
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            lib = old if which == "old" else new
            times[which].append(min(cs.cuda_ms(lambda: train(
                lib, which == "new", disp, x, y, m, tau, cs.LR, max_tau), 5)
                for _ in range(3)))
        print(f"{name}: K {x.shape[0]}, d_cap {x.shape[1]}, max_tau {max_tau}: "
              f"{'bitwise equal' if same else f'DIFFERENT (max abs {diff:g})'}; ms a call "
              f"old {times['old']}, new {times['new']}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
