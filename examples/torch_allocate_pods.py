"""Use of the paper's allocator on the PyTorch port (twin of
``allocate_pods.py``): schedule local-SGD quotas across heterogeneous
accelerator slices (DiLoCo-style multi-slice training).

Each "learner" is a slice with an effective throughput (chips x peak x
MFU) and a datacenter link to the orchestrator; the allocator decides how
many sequences (d_k) and local steps (tau_k) each slice runs per
synchronization wall-clock window T so no slice idles and gradient
staleness across slices is minimized. The peak is the H100's bf16 rate
(``roofline.analysis.HW``: 989 TFLOP/s, NVIDIA's data sheet for the H100
80GB HBM3 at 700 W), where ``pod_slice_profile``'s default (197e12) is a
TPU v5e number kept there as a simulation input. ``--device`` (default:
the card, raising without one) names the device; on the card its name and
power limit are printed beside the peak.

  PYTHONPATH=src python examples/torch_allocate_pods.py --arch llama3-8b [--device cpu]
"""

import argparse
import subprocess

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import (
    AllocationProblem,
    TimeModel,
    pod_slice_profile,
    solve_eta,
    solve_kkt_sai,
    transformer_cost,
)
from repro_torch.roofline.analysis import HW

PEAK_SOURCE = "H100 80GB HBM3, 700 W (NVIDIA data sheet, bf16 dense)"


def card_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    data sheet's part off the card."""
    if device.type != "cuda":
        return f"{PEAK_SOURCE}; no card used"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return f"{PEAK_SOURCE}; this card: {smi.stdout.strip().splitlines()[0]}"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--slices", type=int, default=6)
    ap.add_argument("--t", type=float, default=300.0, help="sync window (s)")
    ap.add_argument("--seqs", type=int, default=8192, help="sequences per window")
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    total, active = cfg.param_counts()
    cost = transformer_cost(
        params_total=total, params_active=active, seq_len=args.seq_len,
        precision_bits=16,
    )
    print(f"{args.arch}: {total/1e9:.1f}B params ({active/1e9:.1f}B active), "
          f"{cost.flops_per_sample:.2e} FLOPs/seq, model {cost.model_bits/8e9:.1f} GB")
    print(f"peak {HW.peak_flops:.3g} FLOP/s a chip: {card_label(device)}")

    profiles = pod_slice_profile(args.slices, seed=1, peak_flops=HW.peak_flops)
    tm = TimeModel.build(
        profiles,
        model_complexity_flops=cost.flops_per_sample,
        model_size_bits=cost.model_bits,
        task_parallelization=False,   # each slice streams its own data shard
    )
    prob = AllocationProblem(
        time_model=tm, T=args.t, total_samples=args.seqs,
        d_lower=args.seqs // (4 * args.slices), d_upper=args.seqs,
    )
    out = {}
    for name, solver in [("optimized", solve_kkt_sai), ("equal-split", solve_eta)]:
        a = solver(prob)
        s = a.summary(prob)
        print(f"\n{name}: local-steps quotas tau={a.tau.tolist()}")
        print(f"  seqs/slice d={a.d.tolist()}")
        print(f"  max staleness {s['max_staleness']}, utilization {s['utilization']:.1%}, "
              f"updates {s['total_updates']}")
        out[name] = {"tau": a.tau.tolist(), "d": a.d.tolist(), "summary": s}
    return out


if __name__ == "__main__":
    main()
