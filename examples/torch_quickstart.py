"""Quickstart on the PyTorch port (twin of ``quickstart.py``): the paper's
core in ~40 lines.

Builds a heterogeneous edge fleet, derives the per-learner time model from
the paper's exact MNIST-DNN constants, solves the staleness-minimizing
task allocation (KKT water-filling + suggest-and-improve), and compares it
against the ETA and synchronous baselines. The allocation is host math;
``--device`` (default: the card, raising without one) names the device
the port would train on.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (
    AllocationProblem,
    TimeModel,
    indoor_80211_profile,
    mnist_dnn_cost,
    solve_eta,
    solve_kkt_sai,
    solve_synchronous,
)

K, T, D = 10, 15.0, 6000


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cost = mnist_dnn_cost()
    print(f"paper model: S_m = {cost.model_bits:.0f} bits, "
          f"C_m = {cost.flops_per_sample:.0f} FLOPs/sample")

    profiles = indoor_80211_profile(K, seed=0)
    tm = TimeModel.build(
        profiles,
        model_complexity_flops=cost.flops_per_sample,
        model_size_bits=cost.model_bits,
    )
    prob = AllocationProblem(time_model=tm, T=T, total_samples=D,
                             d_lower=D // (4 * K), d_upper=3 * D // K)

    out = {}
    for name, solver in [("optimized (KKT+SAI)", solve_kkt_sai),
                         ("ETA  [10]", solve_eta),
                         ("sync [9]", solve_synchronous)]:
        alloc = solver(prob)
        s = alloc.summary(prob)
        t = tm.cycle_time(alloc.tau, alloc.d)
        print(f"\n{name}")
        print(f"  tau = {alloc.tau.tolist()}")
        print(f"  d   = {alloc.d.tolist()}")
        print(f"  max staleness = {s['max_staleness']}, avg = {s['avg_staleness']:.2f}, "
              f"total updates = {s['total_updates']}, mean utilization = {s['utilization']:.2%}")
        if not np.all(t <= T * 1.000001):
            raise RuntimeError(f"{name}: deadline violated")
        out[name] = {"tau": alloc.tau.tolist(), "d": alloc.d.tolist(), "summary": s}
    return out


if __name__ == "__main__":
    main()
