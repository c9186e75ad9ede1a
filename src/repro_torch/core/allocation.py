"""The task-allocation problem container (paper Sec. III, Eq. 7/8).

    min_{tau, d}  max_{k<l} |tau_k - tau_l|
    s.t.          C2_k tau_k d_k + C1_k d_k + C0_k = T     (all k)
                  sum_k d_k = d
                  d_l <= d_k <= d_u,   tau_k, d_k integer >= 0

plus, when an ``EnergyModel`` (``core/energy.py``) is attached, the
per-learner energy budget of the authors' sequel (arXiv 2012.00143):

                  e2_k tau_k d_k + e1_k d_k + e0_k <= e_budget_k

``AllocationProblem`` holds the data; solvers return an ``Allocation``.
A NumPy copy of ``repro/core/allocation.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.staleness import avg_staleness, max_staleness
from repro_torch.core.time_model import TimeModel

__all__ = ["AllocationProblem", "Allocation"]


@dataclasses.dataclass(frozen=True)
class AllocationProblem:
    time_model: TimeModel
    T: float                      # global cycle clock (s)
    total_samples: int            # d
    d_lower: int                  # d_l
    d_upper: int                  # d_u
    energy: "object | None" = None       # optional EnergyModel (e2, e1, e0)
    e_budget: "float | np.ndarray | None" = None  # per-learner joule budget

    def __post_init__(self):
        k = self.time_model.num_learners
        if self.d_lower * k > self.total_samples:
            raise ValueError(
                f"infeasible: K*d_l = {k * self.d_lower} > d = {self.total_samples}"
            )
        if self.d_upper * k < self.total_samples:
            raise ValueError(
                f"infeasible: K*d_u = {k * self.d_upper} < d = {self.total_samples}"
            )
        if self.energy is not None and self.energy.num_learners != k:
            raise ValueError(
                f"energy model covers {self.energy.num_learners} learners, "
                f"time model has {k}"
            )
        if self.e_budget is not None:
            if self.energy is None:
                raise ValueError("e_budget needs an energy model")
            eb = np.broadcast_to(np.asarray(self.e_budget, float), (k,))
            if np.any(eb <= 0):
                raise ValueError("e_budget must be positive (joules)")

    @property
    def num_learners(self) -> int:
        return self.time_model.num_learners

    def energy_rows(self) -> "tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None":
        """(e2, e1, e0, eb) float64 rows when an energy model is attached
        (budget defaulting to +inf — the unconstrained regime), else None."""
        if self.energy is None:
            return None
        return self.energy.rows(self.e_budget)


@dataclasses.dataclass(frozen=True)
class Allocation:
    """A solution: integer tau, d per learner plus bookkeeping."""

    tau: np.ndarray               # (K,) int
    d: np.ndarray                 # (K,) int
    method: str = ""
    relaxed_tau: np.ndarray | None = None   # pre-floor continuous solution
    relaxed_d: np.ndarray | None = None
    solver_iters: int = 0

    def validate(self, prob: AllocationProblem, *, require_full_time: bool = False) -> None:
        """Raise ``ValueError`` when the allocation violates the problem's
        constraints (plain raises, not ``assert``, so the contract holds
        under ``python -O`` too)."""
        tau, d = self.tau, self.d
        k = prob.num_learners
        if tau.shape != (k,) or d.shape != (k,):
            raise ValueError(
                f"shape mismatch: tau {tau.shape}, d {d.shape}, expected ({k},)"
            )
        if not (np.all(tau >= 0) and np.all(d >= 0)):
            raise ValueError("tau and d must be non-negative")
        if int(d.sum()) != prob.total_samples:
            raise ValueError(
                f"sample budget violated: {(int(d.sum()), prob.total_samples)}"
            )
        if not (np.all(d >= prob.d_lower) and np.all(d <= prob.d_upper)):
            raise ValueError(
                f"d outside [{prob.d_lower}, {prob.d_upper}]: {d}"
            )
        t = prob.time_model.cycle_time(tau, d)
        if not np.all(t <= prob.T * (1 + 1e-9)):
            raise ValueError(f"deadline violated: {t} > {prob.T}")
        if require_full_time and not np.allclose(t, prob.T, rtol=1e-6):
            raise ValueError(f"cycle time does not fill the budget: {t} != {prob.T}")
        rows = prob.energy_rows()
        if rows is not None:
            e2, e1, e0, eb = rows
            e = np.where(d > 0, e2 * tau * d + e1 * d + e0, 0.0)
            if not np.all(e <= eb * (1 + 1e-9)):
                raise ValueError(f"energy budget violated: {e} > {eb}")

    def summary(self, prob: AllocationProblem) -> dict:
        t = prob.time_model.cycle_time(self.tau, self.d)
        return {
            "method": self.method,
            "max_staleness": max_staleness(self.tau),
            "avg_staleness": avg_staleness(self.tau),
            "total_updates": int((self.tau * self.d).sum()),
            "min_tau": int(self.tau.min()),
            "max_tau": int(self.tau.max()),
            "utilization": float((t / prob.T).mean()),
            "solver_iters": self.solver_iters,
        }
