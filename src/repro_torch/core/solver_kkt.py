"""KKT-based solver for the relaxed allocation program (paper Sec. IV-B),
the suggest-and-improve (SAI) integer repair, and the energy-budgeted
pipeline of the authors' sequel (arXiv 2012.00143).

A NumPy copy of ``repro/core/solver_kkt.py``.

Paper Sec. IV: eliminating tau_k via the active time constraint t_k = T,
all learners with d_k strictly inside [d_l, d_u] share one tau* (Eq. 11),
so the optimum is a water-filling in tau*:

    d_k(tau*) = clip( (T - C0_k) / (C2_k tau* + C1_k), d_l, d_u )

and tau* is the unique root of  sum_k d_k(tau*) = d, which
``solve_relaxed`` bisects. ``suggest_and_improve`` floors to integers and
greedily repairs / improves, as the paper's SAI step does. ``solve_energy``
folds a per-learner joule budget into every stage; ``kkt_multipliers`` and
``stationarity_residual`` certify Eq. 15 at a relaxed solution.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.allocation import Allocation, AllocationProblem
from repro_torch.core.staleness import max_staleness

__all__ = [
    "solve_relaxed",
    "suggest_and_improve",
    "solve",
    "solve_energy",
    "variable_upper_bounds",
    "kkt_multipliers",
    "stationarity_residual",
]


def variable_upper_bounds(prob: AllocationProblem) -> tuple[np.ndarray, np.ndarray]:
    """Upper bounds on the optimal variables (paper Sec. IV-B): tau_k is
    maximized when d_k is at its lower bound; d_k is bounded by d_u and by
    the time budget at tau = 0."""
    tm = prob.time_model
    tau_ub = np.maximum(tm.tau_of_d(np.full(prob.num_learners, prob.d_lower), prob.T), 0.0)
    d_time_cap = (prob.T - tm.c0) / tm.c1  # d with tau = 0
    d_ub = np.minimum(np.full(prob.num_learners, float(prob.d_upper)), d_time_cap)
    return tau_ub, d_ub


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


# ---------------------------------------------------------------------------
# Energy-budgeted pipeline (arXiv 2012.00143) — the NumPy reference that
# ``solver_batched``'s kkt_energy policy mirrors decision for decision
# ---------------------------------------------------------------------------

_TAU_BIG = 2**30   # finite "unbounded tau" sentinel (see solver_batched)


def _max_tau_energy_np(d, e2, e1, e0, eb):
    """Largest integer tau with E_k <= eb at integer d; ``_TAU_BIG`` where
    the budget never binds (e2 = 0 or eb = inf)."""
    df = np.asarray(d, dtype=float)
    num = eb - e0 - e1 * df
    den = e2 * df
    with np.errstate(divide="ignore", invalid="ignore"):
        raw = np.where(
            den > 0, num / np.where(den > 0, den, 1.0),
            np.where(num >= 0, np.inf, -1.0),
        )
    t = np.floor(raw)
    t = np.where(np.isfinite(t), t, float(_TAU_BIG))
    t = np.where(df > 0, t, 0.0)
    return np.maximum(t, 0.0).astype(np.int64)


def _energy_rows_or_free(prob: AllocationProblem):
    """The problem's (e2, e1, e0, eb) rows; zero-cost/infinite-budget rows
    when no energy model is attached (kkt_sai-equivalent regime)."""
    rows = prob.energy_rows()
    if rows is not None:
        return rows
    k = prob.num_learners
    z = np.zeros(k)
    return z, z.copy(), z.copy(), np.full(k, np.inf)


def _affordable_box(prob: AllocationProblem, energy):
    """Step 1 of the budgeted pipelines (``solve_energy``, the budgeted
    PGD): the tau = 0 budget cap ``(eb - e0) / e1`` tightens each d_hi, a
    learner whose cap cannot cover d_lower gets a zero box, and the sample
    budget clips into the surviving fleet's box. Returns ``(lo, hi,
    affordable, total, degraded)``."""
    k = prob.num_learners
    e2, e1, e0, eb = energy
    lo = np.full(k, float(prob.d_lower))
    hi = np.full(k, float(prob.d_upper))
    room = eb - e0
    with np.errstate(divide="ignore", invalid="ignore"):
        capf = np.where(
            e1 > 0, room / np.where(e1 > 0, e1, 1.0),
            np.where(room >= 0, np.inf, -1.0),
        )
    hi_e = np.clip(np.minimum(np.floor(capf), hi), 0.0, hi)
    affordable = hi_e >= lo
    lo = np.where(affordable, lo, 0.0)
    hi = np.where(affordable, hi_e, 0.0)
    total = int(np.clip(prob.total_samples, lo.sum(), hi.sum()))
    degraded = (not affordable.all()) or total != prob.total_samples
    return lo, hi, affordable, total, degraded


def _integerize_d_vec(d_real, total, lo_i, hi_i):
    """``_integerize_d`` with per-learner integer bounds (the energy mask
    tightens d_hi per learner, so scalar problem bounds no longer apply)."""
    base = np.floor(d_real).astype(np.int64)
    base = np.clip(base, lo_i, hi_i)
    deficit = int(total) - int(base.sum())
    rema = d_real - np.floor(d_real)
    if deficit > 0:
        order = np.argsort(-rema, kind="stable")
        i = 0
        while deficit > 0:
            k = order[i % len(order)]
            if base[k] < hi_i[k]:
                base[k] += 1
                deficit -= 1
            i += 1
            if i > 10 * len(order) + int(total):
                raise RuntimeError("integerize: could not place all samples")
    elif deficit < 0:
        order = np.argsort(rema, kind="stable")
        i = 0
        while deficit < 0:
            k = order[i % len(order)]
            if base[k] > lo_i[k]:
                base[k] -= 1
                deficit += 1
            i += 1
            if i > 10 * len(order) + int(total):
                raise RuntimeError("integerize: could not remove surplus")
    return base


def _sai_energy_np(d, c2, c1, c0, T, lo_i, hi_i, valid, energy, max_rounds):
    """Greedy SAI with energy-capped taus over the affordable sub-fleet —
    the NumPy twin of ``solver_batched._sai_one`` with energy rows (same
    move selection, same tie-breaks, same exit conditions)."""
    sentinel = 2**31 - 1

    def tau_of(dd):
        df = dd.astype(float)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.floor((T - c0 - c1 * df) / (c2 * df))
        t = np.where(dd > 0, t, 0.0)
        t = np.maximum(t, 0.0).astype(np.int64)
        return np.minimum(t, _max_tau_energy_np(dd, *energy))

    def stats(tau):
        return (int(np.max(np.where(valid, tau, -1))),
                int(np.min(np.where(valid, tau, sentinel))))

    tau = tau_of(d)
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        tmax, tmin = stats(tau)
        s = tmax - tmin
        if s <= 0:
            break
        hi0 = int(np.argmax(np.where(valid, tau, -1)))
        lo = int(np.argmax(np.where(valid & (tau == tmin), c2, -np.inf)))
        give = d[lo] - lo_i[lo]
        room_k = np.minimum(hi_i - d, give)
        room0 = room_k[hi0]
        if room0 <= 0:
            elig = valid & (tau > tmin) & (room_k > 0)
            if not elig.any():
                break
            hi_idx = int(np.argmax(np.where(elig, tau, -1)))
            room = int(room_k[hi_idx])
        else:
            hi_idx, room = hi0, int(room0)
        tau_sum = int(np.where(valid, tau, 0).sum())

        def try_move(m):
            d2 = d.copy()
            d2[hi_idx] += m
            d2[lo] -= m
            tau2 = tau_of(d2)
            tmax2, tmin2 = stats(tau2)
            s2 = tmax2 - tmin2
            better = s2 < s or (
                s2 == s and int(np.where(valid, tau2, 0).sum()) > tau_sum
            )
            return d2, tau2, better

        m_big = max(1, room // 8)
        d2, tau2, better = try_move(m_big)
        if better:
            d, tau = d2, tau2
            continue
        if m_big > 1:
            d2, tau2, better = try_move(1)
            if better:
                d, tau = d2, tau2
                continue
        break
    return tau, d, rounds


def solve_energy(
    prob: AllocationProblem,
    *,
    tol: float = 1e-10,
    max_iter: int = 200,
    max_rounds: int = 10_000,
) -> Allocation:
    """Energy-budgeted KKT water-filling + SAI (arXiv 2012.00143).

    The pipeline of ``solve`` with the budget folded in at every stage:

      1. **affordability mask** — the tau = 0 budget cap
         ``(eb_k - e0_k) / e1_k`` tightens each d_hi; a learner whose cap
         cannot cover d_lower is removed (padded-slot semantics) and the
         sample budget clips into the surviving fleet's box
         (feasible-or-degraded, exactly like churn masking);
      2. **relaxed water-filling** on
         ``d_k(tau*) = clip(min(d_time, d_energy), d_lo, d_hi)`` where
         ``d_energy = (eb - e0)/(e2 tau* + e1)`` is the budget hyperbola
         — at any water level each learner absorbs what BOTH constraints
         allow;
      3. **integerize + SAI** with per-learner bounds and taus capped by
         ``_max_tau_energy_np``, so every iterate spends within budget.

    Without an energy model (or with eb = inf) every energy term is
    inert and the decisions coincide with ``solve``. The result is only
    validated against the problem when nothing was degraded (a degraded
    fleet intentionally breaks the d_lower/sum contract, like an offline
    fleet under churn).
    """
    tm = prob.time_model
    energy = _energy_rows_or_free(prob)
    e2, e1, e0, eb = energy
    lo, hi, affordable, total, degraded = _affordable_box(prob, energy)

    def d_of(tau_star):
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            dt = (prob.T - tm.c0) / (tm.c2 * tau_star + tm.c1)
            de = (eb - e0) / (e2 * tau_star + e1)
        return np.clip(np.minimum(dt, de), lo, hi)

    if d_of(0.0).sum() < total - 1e-9:
        raise ValueError(
            "infeasible: even with tau=0 the deadline T cannot absorb d samples"
        )

    lo_b, hi_b = 0.0, 1.0
    it = 0
    while d_of(hi_b).sum() > total and it < 200:
        hi_b *= 2.0
        it += 1
    for _ in range(max_iter):
        mid = 0.5 * (lo_b + hi_b)
        if d_of(mid).sum() > total:
            lo_b = mid
        else:
            hi_b = mid
        if hi_b - lo_b < tol * max(1.0, hi_b):
            break
        it += 1
    tau_star = 0.5 * (lo_b + hi_b)

    d_r = d_of(tau_star)
    free = (d_r > lo + 1e-9) & (d_r < hi - 1e-9)
    gap = total - d_r.sum()
    if np.any(free):
        d_r[free] += gap * (d_r[free] / d_r[free].sum())
    d_r = np.clip(d_r, lo, hi)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        tau_t = (prob.T - tm.c0 - tm.c1 * d_r) / (tm.c2 * d_r)
        tau_e = (eb - e0 - e1 * d_r) / (e2 * d_r)
    tau_r = np.where(d_r > 0, np.maximum(np.minimum(tau_t, tau_e), 0.0), 0.0)

    lo_i = np.round(lo).astype(np.int64)
    hi_i = np.round(hi).astype(np.int64)
    d_int = _integerize_d_vec(d_r, total, lo_i, hi_i)
    tau, d, it_sai = _sai_energy_np(
        d_int, tm.c2, tm.c1, tm.c0, prob.T, lo_i, hi_i, affordable, energy,
        max_rounds,
    )
    alloc = Allocation(
        tau=tau,
        d=d,
        method="kkt_energy",
        relaxed_tau=tau_r,
        relaxed_d=d_r,
        solver_iters=it + it_sai,
    )
    if not degraded:
        alloc.validate(prob)
    return alloc


# ---------------------------------------------------------------------------
# KKT diagnostics (used by tests to certify Theorem 1 holds at our optimum)
# ---------------------------------------------------------------------------

def kkt_multipliers(prob: AllocationProblem, d: np.ndarray) -> dict:
    """Recover (lambda_k, omega) for the relaxed solution with interior d_k.

    For interior learners Eq. 15 gives lambda_k (C2 tau* + C1_k) = -omega.
    The objective gradient fixes the mu-scale; we normalize omega = 1 and
    report the stationarity residual of Eq. 15 per learner.
    """
    tm = prob.time_model
    tau = tm.tau_of_d(np.asarray(d, dtype=float), prob.T)
    interior = (d > prob.d_lower + 1e-6) & (d < prob.d_upper - 1e-6)
    omega = 1.0
    lam = np.where(interior, -omega / (tm.c2 * tau + tm.c1), np.nan)
    return {"lambda": lam, "omega": omega, "interior": interior, "tau": tau}


def stationarity_residual(prob: AllocationProblem, d: np.ndarray) -> float:
    """Max |lambda_k C2 tau_k + lambda_k C1_k + omega| over interior
    learners — ~0 certifies the water-filling point satisfies Eq. 15."""
    info = kkt_multipliers(prob, d)
    tm = prob.time_model
    lam, tau, interior = info["lambda"], info["tau"], info["interior"]
    res = lam * (tm.c2 * tau + tm.c1) + info["omega"]
    if not np.any(interior):
        return 0.0
    return float(np.nanmax(np.abs(res[interior])))
