"""Analytic solver: KKT/Lagrangian structure + suggest-and-improve (SAI).

A NumPy copy of the time-budget half of ``repro/core/solver_kkt.py``
(``solve_relaxed``, ``suggest_and_improve``, ``solve``); the energy
pipeline comes with the energy slice of the port.

Paper Sec. IV: eliminating tau_k via the active time constraint t_k = T,
all learners with d_k strictly inside [d_l, d_u] share one tau* (Eq. 11),
so the optimum is a water-filling in tau*:

    d_k(tau*) = clip( (T - C0_k) / (C2_k tau* + C1_k), d_l, d_u )

and tau* is the unique root of  sum_k d_k(tau*) = d, which
``solve_relaxed`` bisects. ``suggest_and_improve`` floors to integers and
greedily repairs / improves, as the paper's SAI step does.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.allocation import Allocation, AllocationProblem
from repro_torch.core.staleness import max_staleness

__all__ = ["solve_relaxed", "suggest_and_improve", "solve"]


def _d_of_tau_clipped(prob: AllocationProblem, tau_star: float) -> np.ndarray:
    tm = prob.time_model
    with np.errstate(over="ignore", invalid="ignore"):
        d = (prob.T - tm.c0) / (tm.c2 * tau_star + tm.c1)
    return np.clip(d, prob.d_lower, prob.d_upper)


def solve_relaxed(
    prob: AllocationProblem, *, tol: float = 1e-10, max_iter: int = 200
) -> tuple[np.ndarray, np.ndarray, float, int]:
    """Water-filling/KKT solution of the relaxed problem (Eq. 8).

    Returns (tau, d, tau_star, iters); tau/d are continuous.
    """
    tm = prob.time_model
    total = float(prob.total_samples)

    # Feasibility at tau* = 0: the most data the system can absorb.
    if _d_of_tau_clipped(prob, 0.0).sum() < total - 1e-9:
        raise ValueError(
            "infeasible: even with tau=0 the deadline T cannot absorb d samples"
        )

    lo, hi = 0.0, 1.0
    # grow hi until sum d(hi) <= d
    it = 0
    while _d_of_tau_clipped(prob, hi).sum() > total and it < 200:
        hi *= 2.0
        it += 1
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        s = _d_of_tau_clipped(prob, mid).sum()
        if s > total:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol * max(1.0, hi):
            break
        it += 1

    tau_star = 0.5 * (lo + hi)
    d = _d_of_tau_clipped(prob, tau_star)
    # Redistribute the residual of the sum constraint among unclamped learners
    # (bisection leaves a tiny gap; spread it proportionally).
    free = (d > prob.d_lower + 1e-9) & (d < prob.d_upper - 1e-9)
    gap = total - d.sum()
    if np.any(free):
        d[free] += gap * (d[free] / d[free].sum())
    d = np.clip(d, prob.d_lower, prob.d_upper)
    tau = np.maximum(tm.tau_of_d(d, prob.T), 0.0)
    return tau, d, tau_star, it


def _integerize_d(prob: AllocationProblem, d_real: np.ndarray) -> np.ndarray:
    """Largest-remainder rounding of d_real to integers with exact sum and
    bounds respected."""
    base = np.floor(d_real).astype(np.int64)
    base = np.clip(base, prob.d_lower, prob.d_upper)
    deficit = prob.total_samples - int(base.sum())
    if deficit > 0:
        # hand out one sample at a time to the learners with largest remainder
        # that still have headroom
        # stable sorts keep tie-breaks deterministic and index-ordered so the
        # batched engine (solver_batched) reproduces this exactly
        rema = d_real - np.floor(d_real)
        order = np.argsort(-rema, kind="stable")
        i = 0
        while deficit > 0:
            k = order[i % len(order)]
            if base[k] < prob.d_upper:
                base[k] += 1
                deficit -= 1
            i += 1
            if i > 10 * len(order) + prob.total_samples:
                raise RuntimeError("integerize: could not place all samples")
    elif deficit < 0:
        order = np.argsort(d_real - np.floor(d_real), kind="stable")
        i = 0
        while deficit < 0:
            k = order[i % len(order)]
            if base[k] > prob.d_lower:
                base[k] -= 1
                deficit += 1
            i += 1
            if i > 10 * len(order) + prob.total_samples:
                raise RuntimeError("integerize: could not remove surplus")
    return base


def suggest_and_improve(
    prob: AllocationProblem,
    d_suggest: np.ndarray,
    *,
    max_rounds: int = 10_000,
) -> tuple[np.ndarray, np.ndarray, int]:
    """SAI (paper Sec. IV): start from the suggested (rounded) d, set each
    tau_k to its maximum feasible integer, then greedily move samples from
    low-tau learners to high-tau learners while the staleness objective
    improves. Every iterate is feasible."""
    tm = prob.time_model
    d = _integerize_d(prob, np.asarray(d_suggest, dtype=float))
    tau = tm.max_tau(d, prob.T)
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        s = max_staleness(tau)
        if s == 0:
            break
        hi = int(np.argmax(tau))   # too many updates -> give it MORE data
        lo_candidates = np.where(tau == tau.min())[0]
        # pick the min-tau learner that frees the most tau per sample removed
        lo = int(lo_candidates[np.argmax(tm.c2[lo_candidates])])
        # move m samples lo -> hi
        room = min(prob.d_upper - int(d[hi]), int(d[lo]) - prob.d_lower)
        if room <= 0:
            # try the next-highest tau learner with room
            order = np.argsort(-tau, kind="stable")
            moved = False
            for cand in order:
                if tau[cand] == tau.min():
                    break
                room = min(prob.d_upper - int(d[cand]), int(d[lo]) - prob.d_lower)
                if room > 0:
                    hi = int(cand)
                    moved = True
                    break
            if not moved:
                break
        m = max(1, room // 8)
        d2 = d.copy()
        d2[hi] += m
        d2[lo] -= m
        tau2 = tm.max_tau(d2, prob.T)
        if max_staleness(tau2) < s or (
            max_staleness(tau2) == s and tau2.sum() > tau.sum()
        ):
            d, tau = d2, tau2
            continue
        if m > 1:
            # retry with the minimal step before giving up on this pair
            d2 = d.copy()
            d2[hi] += 1
            d2[lo] -= 1
            tau2 = tm.max_tau(d2, prob.T)
            if max_staleness(tau2) < s or (
                max_staleness(tau2) == s and tau2.sum() > tau.sum()
            ):
                d, tau = d2, tau2
                continue
        break
    return tau, d, rounds


def solve(prob: AllocationProblem) -> Allocation:
    """Full paper pipeline: relaxed KKT water-filling -> floor -> SAI."""
    tau_r, d_r, _tau_star, it_relax = solve_relaxed(prob)
    tau, d, it_sai = suggest_and_improve(prob, d_r)
    alloc = Allocation(
        tau=tau,
        d=d,
        method="kkt_sai",
        relaxed_tau=tau_r,
        relaxed_d=d_r,
        solver_iters=it_relax + it_sai,
    )
    alloc.validate(prob)
    return alloc
