"""Model aggregation rules for asynchronous MEL (paper Sec. II + ref [10]).

* ``fedavg_weights``    — data-weighted averaging (alpha_k = d_k / d); NumPy,
  copied from ``repro/core/aggregation.py``.
* ``staleness_weights`` — staleness-aware async SGD (ref [10]): alpha_k is
  proportional to d_k / (1 + gamma * (tau_max - tau_k)), renormalized;
  NumPy, copied.
* ``aggregate``         — the weighted sum of stacked learner models in plain
  torch, with the reference's arithmetic: the weights are cast to the
  leaf's dtype and the products summed over the learner axis.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fedavg_weights", "staleness_weights", "aggregate", "aggregate_stacked"]


def fedavg_weights(d: np.ndarray) -> np.ndarray:
    d = np.asarray(d, dtype=float)
    return d / d.sum()


def staleness_weights(tau: np.ndarray, d: np.ndarray, *, gamma: float = 1.0) -> np.ndarray:
    """alpha_k ∝ d_k / (1 + gamma * (tau_max - tau_k)); renormalized."""
    tau = np.asarray(tau, dtype=float)
    d = np.asarray(d, dtype=float)
    s = tau.max() - tau
    w = d / (1.0 + gamma * s)
    return w / w.sum()


def aggregate(models: list[dict], weights: torch.Tensor) -> list[dict]:
    """Weighted sum over the leading learner axis K of every leaf of a
    stacked model (a list of ``{"w", "b"}`` dicts); ``weights`` is (K,)."""

    def wsum(leaf):
        w = weights.to(leaf.dtype).reshape((-1,) + (1,) * (leaf.dim() - 1))
        return (leaf * w).sum(dim=0)

    return [{name: wsum(leaf) for name, leaf in layer.items()} for layer in models]


# alias that documents the stacked-leading-axis contract
aggregate_stacked = aggregate
