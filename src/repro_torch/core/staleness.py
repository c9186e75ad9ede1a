"""The paper's update staleness (Eqs. 6 and 13); a NumPy copy of the
``max_staleness``/``avg_staleness`` pair of ``repro/core/staleness.py``."""

from __future__ import annotations

import numpy as np

__all__ = ["max_staleness", "avg_staleness"]


def max_staleness(tau: np.ndarray) -> int:
    """s = max_{k<l} |tau_k - tau_l|  (Eq. 6, max over all pairs)."""
    tau = np.asarray(tau)
    if tau.size < 2:
        return 0
    return int(np.max(tau) - np.min(tau))


def avg_staleness(tau: np.ndarray) -> float:
    """s_avg = (1/N) sum_n |tau_{c_n,1} - tau_{c_n,2}|  (Eq. 13)."""
    tau = np.asarray(tau, dtype=float)
    if tau.size < 2:
        return 0.0
    diff = np.abs(tau[:, None] - tau[None, :])
    n = tau.size
    return float(diff[np.triu_indices(n, k=1)].mean())
