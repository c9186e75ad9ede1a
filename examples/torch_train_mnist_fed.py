"""End-to-end run on the PyTorch port (twin of ``train_mnist_fed.py``,
the paper's experiment): asynchronous federated training of the
[784,300,124,60,10] DNN over a heterogeneous 802.11 edge fleet.

Each cycle runs through the port's kernel path (``run_experiment(...,
fused=True)``: one ``train_agg_step`` launch a cycle on the card, its
plain version on the CPU), the same history as the eager path to float32
tolerance. ``--device`` defaults to the card and raises without one.

  PYTHONPATH=src python examples/torch_train_mnist_fed.py [--cycles 10] [--k 10] [--device cpu]
"""

import argparse

from repro_torch.data.pipeline import synthetic_mnist
from repro_torch.fed.simulation import run_experiment

SCHEMES = [("kkt_sai", "staleness"), ("sync", "fedavg"), ("eta", "staleness"),
           ("eta", "fedavg")]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--t", type=float, default=15.0)
    ap.add_argument("--cycles", type=int, default=10)
    ap.add_argument("--samples", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    train, test = synthetic_mnist(max(args.samples * 2, 12_000), seed=args.seed)
    print(f"K={args.k} T={args.t}s d={args.samples} cycles={args.cycles}")
    print(f"{'scheme':24s} {'per-cycle accuracy'}")
    out = {}
    for scheme, agg in SCHEMES:
        res = run_experiment(
            k=args.k, T=args.t, cycles=args.cycles, scheme=scheme, aggregation=agg,
            total_samples=args.samples, seed=args.seed, train=train, test=test,
            fused=True, device=args.device,
        )
        accs = [h["accuracy"] for h in res["history"]]
        tag = f"{scheme}/{agg}"
        print(f"{tag:24s} {' '.join(f'{a:.3f}' for a in accs)}   "
              f"(max staleness {res['allocation']['max_staleness']})")
        out[tag] = {"accuracy": accs, "allocation": res["allocation"],
                    "tau": [list(map(int, h["tau"])) for h in res["history"]],
                    "d": [list(map(int, h["d"])) for h in res["history"]]}
    return out


if __name__ == "__main__":
    main()
