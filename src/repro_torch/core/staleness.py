"""Staleness metrics (paper Eqs. 6 and 13) and model-version staleness; a
NumPy copy of ``repro/core/staleness.py``.

Two notions of staleness coexist:

* **update staleness** (the paper's): within one global cycle, the gap
  |tau_k - tau_l| in local updates between learners — ``max_staleness`` /
  ``avg_staleness`` below.
* **version staleness** (FedAsync, Xie et al. arXiv:1903.03934): in an
  event-driven server, each upload was computed against the global model
  version it was dispatched with; its staleness is
  ``server_version - dispatch_version``. ``version_staleness``,
  ``staleness_factor`` (the constant / hinge / polynomial discounts of the
  FedAsync paper) and ``version_staleness_profile`` cover this regime; the
  event engine in ``repro_torch.fed.async_engine`` consumes them.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "pair_matrix",
    "max_staleness",
    "avg_staleness",
    "staleness_profile",
    "version_staleness",
    "staleness_factor",
    "version_staleness_profile",
    "STALENESS_FNS",
]


def pair_matrix(k: int) -> np.ndarray:
    """The paper's matrix c in R^{N x 2}, N = C(K,2) (Eq. 10): all (k, l)
    index pairs with l > k, 0-based."""
    pairs = [(a, b) for a in range(k) for b in range(a + 1, k)]
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


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


def staleness_profile(tau: np.ndarray) -> dict:
    return {
        "max": max_staleness(tau),
        "avg": avg_staleness(tau),
        "tau_min": int(np.min(tau)) if np.asarray(tau).size else 0,
        "tau_max": int(np.max(tau)) if np.asarray(tau).size else 0,
    }


# ---------------------------------------------------------------------------
# model-version staleness (event-driven asynchronous federation)
# ---------------------------------------------------------------------------

def version_staleness(server_version, dispatch_version):
    """s = server_version - dispatch_version: how many aggregations the
    server performed while this upload was in flight. Elementwise over
    arrays; never negative (an upload cannot be fresher than the server)."""
    s = np.asarray(server_version) - np.asarray(dispatch_version)
    return np.maximum(s, 0)


#: staleness discount functions s -> (0, 1] of FedAsync (arXiv:1903.03934
#: Sec. 5.2); ``a``/``b`` are the paper's hyper-parameters.
STALENESS_FNS = ("constant", "hinge", "poly")


def staleness_factor(s, *, kind: str = "poly", a: float = 0.5, b: float = 4.0):
    """FedAsync's s(t - tau): the server's trust in an upload of version
    staleness ``s``.

      constant   1                         (plain async SGD)
      hinge      1 if s <= b else 1 / (a (s - b) + 1)
      poly       (1 + s)^(-a)

    All three are 1.0 exactly at s = 0 (a fresh upload is mixed at the full
    server rate alpha) and non-increasing in s. Elementwise over arrays."""
    s = np.maximum(np.asarray(s, dtype=float), 0.0)
    if kind == "constant":
        return np.ones_like(s) if s.shape else 1.0
    if kind == "hinge":
        # denominator only ever used where s > b (there it is > 1); the
        # where-guard keeps the masked branch from dividing by zero at
        # s == b - 1/a
        den = np.where(s > b, a * (s - b) + 1.0, 1.0)
        out = np.where(s <= b, 1.0, 1.0 / den)
        return out if s.shape else float(out)
    if kind == "poly":
        out = (1.0 + s) ** (-a)
        return out if s.shape else float(out)
    raise ValueError(f"unknown staleness fn {kind!r}; choose from {STALENESS_FNS}")


def version_staleness_profile(staleness: np.ndarray) -> dict:
    """Summary of the per-aggregation version-staleness sequence an async
    run produced (one entry per aggregated upload)."""
    s = np.asarray(staleness, dtype=float)
    if s.size == 0:
        return {"mean": 0.0, "max": 0, "p50": 0.0, "p90": 0.0, "p99": 0.0,
                "frac_stale": 0.0, "count": 0}
    return {
        "mean": float(s.mean()),
        "max": int(s.max()),
        "p50": float(np.percentile(s, 50)),
        "p90": float(np.percentile(s, 90)),
        "p99": float(np.percentile(s, 99)),
        "frac_stale": float((s > 0).mean()),
        "count": int(s.size),
    }
