"""Adaptive vs static task allocation under time-varying edge dynamics, on
the PyTorch port (twin of ``realloc_drift.py``).

The paper's core claim is that *adaptive* allocation — re-solving the
staleness-minimizing program as node capacities evolve — beats schemes
that freeze the allocation. This example makes the capacities actually
move: a ``CapacityDrift`` model re-draws per-cycle channel fading and
compute jitter, and we compare

  * static   — solve once on the base capacities, freeze (tau, d); each
               cycle's realized tau_k is whatever the TRUE capacities
               admit with the frozen d_k, so staleness accumulates;
  * adaptive — re-solve every cycle on that cycle's capacities, through
               the batched solver (its water-filling kernel on the card).

``--train`` adds a small reallocating run through the kernel path
(``run_experiment(fused=True, reallocate=True)``). ``--device`` defaults
to the card and raises without one.

  PYTHONPATH=src python examples/torch_realloc_drift.py [--device cpu]
  PYTHONPATH=src python examples/torch_realloc_drift.py --train   # + tiny MEL run
"""

import argparse

import numpy as np

from repro_torch.core import CapacityDrift
from repro_torch.fed.simulation import drift_staleness_sweep, run_experiment


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, nargs="+", default=[5, 10, 15])
    ap.add_argument("--t", type=float, default=7.5, help="cycle budget (s)")
    ap.add_argument("--cycles", type=int, default=12)
    ap.add_argument("--clock-jitter", type=float, default=0.15)
    ap.add_argument("--fading-db", type=float, default=2.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="also run a small reallocating MEL run through the kernels")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    drift = CapacityDrift(
        clock_jitter=args.clock_jitter, fading_sigma_db=args.fading_db,
        seed=args.seed,
    )
    rows = drift_staleness_sweep(
        args.k, args.t, cycles=args.cycles, drift=drift,
        schemes=("kkt_sai", "eta"), seed=args.seed, device=args.device,
    )

    print(f"# {args.cycles} cycles, clock jitter ±{args.clock_jitter:.0%}, "
          f"fading sigma {args.fading_db} dB")
    print(f"{'K':>4} {'scheme':>8} {'mode':>9} {'max_stale(mean)':>16} "
          f"{'max_stale(worst)':>17} {'avg_stale(mean)':>16}")
    for r in rows:
        if "error" in r:
            print(f"{r['K']:>4} {r['scheme']:>8}  {r['error']}")
            continue
        print(f"{r['K']:>4} {r['scheme']:>8} {r['mode']:>9} "
              f"{r['max_staleness_mean']:>16.2f} {r['max_staleness_worst']:>17d} "
              f"{r['avg_staleness_mean']:>16.2f}")

    by = {(r["K"], r["scheme"], r.get("mode")): r for r in rows}
    gains = {}
    for k in args.k:
        a = by.get((k, "kkt_sai", "adaptive"))
        s = by.get((k, "kkt_sai", "static"))
        if a and s and s["max_staleness_mean"] > 0:
            gains[k] = s["max_staleness_mean"] - a["max_staleness_mean"]
            print(f"# K={k}: adaptive KKT removes {gains[k]:.2f} mean max-staleness "
                  f"vs the frozen allocation")
    out = {"rows": rows, "gains": gains}

    if args.train:
        print("\n# reallocating run through the kernel path (per-cycle KKT re-solve on "
              "the drifted capacities)")
        res = run_experiment(
            k=min(args.k), T=15.0, cycles=6, total_samples=1200,
            seed=args.seed, reallocate=True, drift=drift, fused=True, device=args.device,
        )
        for h in res["history"]:
            print(f"cycle {h['cycle']}: tau={np.asarray(h['tau'])} "
                  f"max_staleness={h['max_staleness']} acc={h['accuracy']:.3f}")
        out["train"] = res["history"]
    return out


if __name__ == "__main__":
    main()
