"""Baseline allocation schemes the paper compares against.

* ``solve_synchronous`` — the synchronous optimized scheme of ref [9]:
  every learner performs the *same* number of updates tau, tau maximized
  subject to every learner finishing within T. Some learners idle.
* ``solve_eta`` — equal task allocation (staleness-aware async-SGD setting
  of ref [10]): d_k = d / K for all learners; each learner then performs as
  many updates as fit in T (so staleness is whatever heterogeneity causes).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.allocation import Allocation, AllocationProblem

__all__ = ["solve_synchronous", "solve_eta"]


def _integer_sum_fix(d: np.ndarray, prob: AllocationProblem) -> np.ndarray:
    d = np.clip(np.floor(d).astype(np.int64), prob.d_lower, prob.d_upper)
    gap = prob.total_samples - int(d.sum())
    i = 0
    order = np.argsort(-d, kind="stable")  # deterministic tie-break (solver_batched mirrors it)
    while gap != 0:
        k = order[i % len(order)]
        if gap > 0 and d[k] < prob.d_upper:
            d[k] += 1
            gap -= 1
        elif gap < 0 and d[k] > prob.d_lower:
            d[k] -= 1
            gap += 1
        i += 1
        if i > 100 * len(order) + prob.total_samples:
            raise RuntimeError("could not fix integer sum")
    return d


def solve_synchronous(prob: AllocationProblem) -> Allocation:
    """Ref [9]: common tau for all learners, maximized; d_k optimized so
    everyone meets the deadline. For a common tau the most data the system
    absorbs is sum_k clip(d_k(tau), d_l, d_u); pick the largest integer tau
    that still absorbs all d samples, then distribute d by the same
    water-filling and let every learner run exactly tau updates."""
    tm = prob.time_model

    def capacity(tau: float) -> float:
        d = (prob.T - tm.c0) / (tm.c2 * tau + tm.c1)
        return float(np.clip(d, prob.d_lower, prob.d_upper).sum())

    if capacity(0.0) < prob.total_samples:
        raise ValueError("infeasible even at tau=0")
    tau = 0
    while capacity(float(tau + 1)) >= prob.total_samples:
        tau += 1
        if tau > 10**7:
            raise RuntimeError("tau diverged")
    d_real = np.clip(
        (prob.T - tm.c0) / (tm.c2 * float(tau) + tm.c1), prob.d_lower, prob.d_upper
    )
    # distribute exactly d samples (respecting that adding samples must keep
    # t_k <= T at the common tau -> only add below the unclipped capacity)
    d = _integer_sum_fix(d_real, prob)
    # adding the rounding residue may push t_k over T at tau; back off tau if so
    while tau > 0 and np.any(tm.cycle_time(np.full_like(d, tau), d) > prob.T * (1 + 1e-12)):
        tau -= 1
    alloc = Allocation(
        tau=np.full(prob.num_learners, tau, dtype=np.int64),
        d=d,
        method="synchronous",
        relaxed_d=d_real,
    )
    alloc.validate(prob)
    return alloc


def solve_eta(prob: AllocationProblem) -> Allocation:
    """Ref [10] adapted: equal task allocation d_k = d/K; each learner runs
    the maximum number of updates that fits in T (asynchronous in updates)."""
    k = prob.num_learners
    d = np.full(k, prob.total_samples // k, dtype=np.int64)
    d[: prob.total_samples - int(d.sum())] += 1
    d = np.clip(d, prob.d_lower, prob.d_upper)
    # clip can break the sum if d/K is outside the box; repair
    if int(d.sum()) != prob.total_samples:
        d = _integer_sum_fix(d.astype(float), prob)
    tau = prob.time_model.max_tau(d, prob.T)
    alloc = Allocation(tau=tau, d=d, method="eta")
    alloc.validate(prob)
    return alloc
