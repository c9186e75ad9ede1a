"""Event-driven asynchronous federation over a drifting edge fleet, on the
PyTorch port (twin of ``async_fleet.py``).

The paper gates every learner to the same cycle budget T; this example
drops the gate and lets the server react per upload (FedAsync) or per
buffer flush (FedBuff/FedAST style), all on the paper's own per-learner
wall-clock cost model and allocation solvers. Three servers train the same
model for the same amount of *virtual* time under the same capacity drift:

  cycle     the paper's scheme (engine barrier regime: buffered, M = K)
  fedasync  mix on every arrival with version-staleness discounting
  buffered  flush a size-M buffer, staleness-weighted, version bump per flush

``--bucketed`` also runs fedasync through the grouped kernel path (one
``train_agg_step`` launch a group of arrivals on the card). ``--device``
defaults to the card and raises without one.

  PYTHONPATH=src python examples/torch_async_fleet.py [--device cpu]
  PYTHONPATH=src python examples/torch_async_fleet.py --trace fedasync  # per-event log
  PYTHONPATH=src python examples/torch_async_fleet.py --bucketed        # kernel path
"""

import argparse

import numpy as np

from repro_torch.core import CapacityDrift
from repro_torch.fed.simulation import async_mode_sweep, run_async_experiment


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--t", type=float, default=5.0, help="cycle/block budget (s)")
    ap.add_argument("--cycles", type=int, default=4,
                    help="virtual-time horizon in multiples of T")
    ap.add_argument("--total", type=int, default=900)
    ap.add_argument("--alpha", type=float, default=0.6)
    ap.add_argument("--staleness-fn", default="poly",
                    choices=("constant", "hinge", "poly"))
    ap.add_argument("--clock-jitter", type=float, default=0.15)
    ap.add_argument("--fading-db", type=float, default=2.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--static", action="store_true",
                    help="freeze allocations at the base capacities")
    ap.add_argument("--trace", default=None,
                    metavar="MODE", help="print the per-event log of one mode")
    ap.add_argument("--bucketed", action="store_true",
                    help="also run fedasync through the grouped kernel path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    drift = CapacityDrift(
        clock_jitter=args.clock_jitter, fading_sigma_db=args.fading_db,
        seed=args.seed,
    )
    kw = dict(
        T=args.t, cycles=args.cycles, total_samples=args.total,
        drift=drift, seed=args.seed, reallocate=not args.static,
        alpha=args.alpha, staleness_fn=args.staleness_fn, device=args.device,
    )
    rows = async_mode_sweep([args.k], **kw)

    print(f"# K={args.k}, horizon={args.cycles}xT={args.cycles * args.t:.0f}s, "
          f"clock jitter ±{args.clock_jitter:.0%}, fading {args.fading_db} dB, "
          f"{'static' if args.static else 'adaptive'} allocation")
    print(f"{'mode':>9} {'final_acc':>9} {'aggs':>5} {'uploads':>7} "
          f"{'stal_mean':>9} {'stal_max':>8}")
    for r in rows:
        if "error" in r:
            print(f"{r['mode']:>9}  {r['error']}")
            continue
        print(f"{r['mode']:>9} {r['final_accuracy']:>9.3f} "
              f"{r['aggregations']:>5d} {r['uploads']:>7d} "
              f"{r['staleness_mean']:>9.2f} {r['staleness_max']:>8d}")
    out = {"rows": rows}

    if args.trace:
        res = run_async_experiment(k=args.k, mode=args.trace, **kw)
        print(f"\n# per-aggregation log ({args.trace})")
        for r in res["history"][:25]:
            acc = f" acc={r['accuracy']:.3f}" if "accuracy" in r else ""
            print(f"t={r['t']:7.2f}s v{r['server_version']:<3d} "
                  f"learners={r['learners']} stal={r['staleness_list']} "
                  f"w={np.round(r['weights'], 3)}{acc}")
        out["trace"] = res["history"]

    if args.bucketed:
        # num_buckets=0 takes the event-indexed (jagged) path: exact on
        # every schedule, no grid/strict tuning
        res = run_async_experiment(
            k=args.k, mode="fedasync", bucketed=True, **kw,
        )
        print(f"\n# grouped kernel path: {res['summary']['aggregations']} aggregations, "
              f"final acc {res['final_accuracy']:.3f}")
        out["bucketed"] = {"aggregations": res["summary"]["aggregations"],
                           "final_accuracy": res["final_accuracy"],
                           "history": res["history"]}
    return out


if __name__ == "__main__":
    main()
