"""The end-to-end MEL experiment (the paper's Figs. 2-3), in torch.

Builds the 802.11 indoor environment, derives the time-model coefficients
from the paper's MNIST-DNN constants (S_m = 8,974,080 bits,
C_m = 1,123,736 FLOPs/sample), allocates with the requested scheme, and
runs federated training on synthetic MNIST-class data — the port of
``build_problem`` and ``run_experiment`` in ``repro/fed/simulation.py``.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import (
    AllocationProblem,
    TimeModel,
    indoor_80211_profile,
    mnist_dnn_cost,
)
from repro_torch.data.pipeline import Dataset, synthetic_mnist
from repro_torch.fed.orchestrator import MELConfig, Orchestrator
from repro_torch.models import mlp

__all__ = ["build_problem", "run_experiment"]


def build_problem(
    k: int,
    T: float,
    *,
    total_samples: int = 6000,
    d_lower_frac: float = 0.25,
    d_upper_frac: float = 3.0,
    seed: int = 0,
) -> AllocationProblem:
    cost = mnist_dnn_cost()
    profiles = indoor_80211_profile(k, seed=seed)
    tm = TimeModel.build(
        profiles,
        model_complexity_flops=cost.flops_per_sample,
        model_size_bits=cost.model_bits,
    )
    d_l = max(1, int(d_lower_frac * total_samples / k))
    d_u = min(total_samples, int(d_upper_frac * total_samples / k))
    return AllocationProblem(
        time_model=tm, T=T, total_samples=total_samples, d_lower=d_l, d_upper=d_u
    )


def run_experiment(
    *,
    k: int = 10,
    T: float = 15.0,
    cycles: int = 12,
    scheme: str = "kkt_sai",
    aggregation: str = "staleness",
    total_samples: int = 6000,
    lr: float = 0.1,
    seed: int = 0,
    train: Dataset | None = None,
    test: Dataset | None = None,
    fused: bool = False,
    reallocate: bool = False,
    drift=None,
    device=None,
) -> dict:
    """One full MEL run; returns history with accuracy per global cycle.

    ``fused=True`` runs each cycle through the train+aggregate kernels
    (``Orchestrator.run_fused``) and gives the eager history for the same
    seed, to float32 tolerance. ``device=None`` means the card.
    ``reallocate`` and ``drift`` come with a later slice of the port.
    """
    device = resolve_device(device)
    if train is None or test is None:
        train, test = synthetic_mnist(max(total_samples * 2, 12_000), seed=seed)
    prob = build_problem(k, T, total_samples=total_samples, seed=seed)
    mel = MELConfig(
        T=T, total_samples=total_samples, lr=lr, scheme=scheme, aggregation=aggregation
    )
    params = mlp.init(seed, device=device)
    orch = Orchestrator(mel, prob, mlp.loss, params, seed=seed, drift=drift)
    ex = torch.from_numpy(test.x[:2000]).to(device)
    ey = torch.from_numpy(test.y[:2000]).to(device)

    if fused:
        history = orch.run(
            train, cycles, fused=True, eval_fn=mlp.accuracy,
            eval_batch=(ex, ey), reallocate=reallocate,
        )
    else:
        history = orch.run(train, cycles, eval_fn=lambda p: mlp.accuracy(p, ex, ey),
                           reallocate=reallocate)
    return {
        "scheme": scheme,
        "K": k,
        "T": T,
        "history": history,
        "final_accuracy": history[-1]["accuracy"],
        "allocation": orch.allocation.summary(prob),
    }
