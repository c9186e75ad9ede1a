"""Batched allocation engine: KKT water-filling bisection + integer SAI
repair for B allocation problems at once, in torch on one device.

The port of ``repro/core/solver_batched.py`` without its
``apply_sampling_mask`` (ROADMAP Queue 1 item 11):

  * ``BatchedProblems`` — the (B, K) problem layout: coefficients
    ``c2/c1/c0`` and per-learner bounds ``d_lo/d_hi`` of shape (B, K),
    per-fleet ``T``/``total`` of shape (B,), a ``valid`` mask so fleets of
    different sizes batch together (padded slots carry ``d_lo = d_hi = 0``
    and never receive work), and optional energy rows ``e2/e1/e0`` with
    per-learner joule budgets ``e_budget`` (arXiv 2012.00143).
  * ``solve_kkt_batched`` — lockstep bisection on the water level tau* of
    all B fleets, one ``kernels.ops.waterfill_residual`` call a step (the
    CUDA kernel on the card), then largest-remainder integerization and the
    SAI greedy repair.
  * ``solve_energy_batched`` — the budgeted pipeline (``kkt_energy``): the
    affordability mask (``apply_energy_mask``), the bisection on
    ``kernels.ops.waterfill_energy_residual`` (its CUDA kernel on the
    card), and the integer tail with every tau capped by the budget.
  * ``solve_eta_batched`` — the equal-task baseline in the same layout.
  * ``batched_policy`` — the per-cycle re-solve hook of the orchestrator
    (``kkt_sai``, ``eta``, ``kkt_energy``, ``pgd``).
  * the cross-model layer of the multi-tenant scheduler
    (``fed.multimodel``): ``cross_model_weights`` / ``cross_model_split``
    split each learner's deadline (and joule budget) across S tenant
    models by their progress deficits (``SPLIT_POLICIES``), and
    ``multimodel_policy`` solves the (S, K) problem with one
    ``batched_policy`` call on the split.
  * ``batched_max_staleness`` / ``batched_avg_staleness`` /
    ``batched_summary`` — (B,) fleet metrics (host NumPy).

The reference runs its ``while_loop``s vmapped over B; here each is a
masked loop over the whole batch in lockstep, and the host asks the device
once a round whether any fleet is still active. A fleet's row of the batch
sees exactly the steps its own loop would: a finished fleet is frozen.

Numerical contract: with ``x64=True`` (the default) every branch, the
stable-sort tie-breaks and the greedy moves follow ``solver_kkt.solve``
(and ``solve_energy``) decision for decision. Every sum over the learner
axis is taken in index order, as the reference's CPU program takes it for
fleets this size, so the card and the CPU give the same bits.
``x64=False`` computes in float32/int32. Entry points take
``device=None``, which means the card.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.allocation import Allocation, AllocationProblem
from repro_torch.core.energy import EnergyModel
from repro_torch.core.time_model import TimeModel
from repro_torch.kernels import ops
from repro_torch.kernels.ref import sum_in_order

__all__ = [
    "BatchedAllocation",
    "BatchedProblems",
    "POLICIES",
    "SPLIT_POLICIES",
    "apply_active_mask",
    "apply_energy_mask",
    "apply_sampling_mask",
    "batched_avg_staleness",
    "batched_max_staleness",
    "batched_policy",
    "batched_summary",
    "cross_model_split",
    "cross_model_weights",
    "multimodel_policy",
    "solve_energy_batched",
    "solve_eta_batched",
    "solve_kkt_batched",
]

_INT_SENTINEL = 2**31 - 1

#: "unbounded tau" sentinel of the energy cap: finite (``floor(inf)`` has
#: no integer) and exact in float32, far above any deadline-feasible tau,
#: so ``min(time_cap, _TAU_BIG)`` is the time cap where the budget never binds
_TAU_BIG = 2**30

#: schemes with a batched policy in the port (see ``batched_policy``); the
#: reference names this tuple ``TRACED_POLICIES``
POLICIES = ("kkt_sai", "eta", "pgd", "kkt_energy")


# ---------------------------------------------------------------------------
# problem / solution containers (host NumPy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchedProblems:
    """B allocation problems in one (B, K) layout (K = widest fleet).

    Padded slots (``valid[b, k] == False``) carry ``d_lo = d_hi = 0``, so
    every bound clip pins them to zero work; their coefficients are ignored
    (``from_problems`` writes c2 = c1 = 1, c0 = 0 so divides stay finite);
    solver outputs carry ``tau = d = 0`` there, and they enter neither the
    staleness metrics nor the sum constraint.

    The optional energy rows ``e2/e1/e0`` and per-learner budgets
    ``e_budget`` default to None; ``energy_rows()`` then gives the
    zero-coefficient, infinite-budget rows under which ``kkt_energy``
    decides as ``kkt_sai`` does.
    """

    c2: np.ndarray        # (B, K)
    c1: np.ndarray        # (B, K)
    c0: np.ndarray        # (B, K)
    T: np.ndarray         # (B,)
    total: np.ndarray     # (B,) int
    d_lo: np.ndarray      # (B, K)
    d_hi: np.ndarray      # (B, K)
    valid: np.ndarray     # (B, K) bool
    e2: np.ndarray | None = None        # (B, K) optional energy rows
    e1: np.ndarray | None = None        # (B, K)
    e0: np.ndarray | None = None        # (B, K)
    e_budget: np.ndarray | None = None  # (B, K) joules, +inf = unconstrained

    @property
    def num_problems(self) -> int:
        return int(self.c2.shape[0])

    @property
    def max_learners(self) -> int:
        return int(self.c2.shape[1])

    @property
    def has_energy(self) -> bool:
        return self.e2 is not None

    def energy_rows(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(e2, e1, e0, e_budget) float64 rows; zero coefficients and +inf
        budgets when the struct carries no energy model."""
        b, k = self.c2.shape
        if self.e2 is None:
            z = np.zeros((b, k))
            return z, z.copy(), z.copy(), np.full((b, k), np.inf)
        eb = (np.full((b, k), np.inf) if self.e_budget is None
              else np.asarray(self.e_budget, np.float64))
        return (np.asarray(self.e2, np.float64), np.asarray(self.e1, np.float64),
                np.asarray(self.e0, np.float64), eb)

    @staticmethod
    def from_problems(problems: "list[AllocationProblem]") -> "BatchedProblems":
        b = len(problems)
        k = max(p.num_learners for p in problems)
        c2 = np.ones((b, k)); c1 = np.ones((b, k)); c0 = np.zeros((b, k))
        d_lo = np.zeros((b, k)); d_hi = np.zeros((b, k))
        valid = np.zeros((b, k), bool)
        T = np.zeros(b); total = np.zeros(b, np.int64)
        any_energy = any(p.energy is not None for p in problems)
        if any_energy:
            # padded slots: zero cost, infinite budget (never binding)
            e2 = np.zeros((b, k)); e1 = np.zeros((b, k)); e0 = np.zeros((b, k))
            eb = np.full((b, k), np.inf)
        for i, p in enumerate(problems):
            n = p.num_learners
            tm = p.time_model
            c2[i, :n], c1[i, :n], c0[i, :n] = tm.c2, tm.c1, tm.c0
            d_lo[i, :n] = p.d_lower
            d_hi[i, :n] = p.d_upper
            valid[i, :n] = True
            T[i] = p.T
            total[i] = p.total_samples
            if any_energy and p.energy is not None:
                e2[i, :n], e1[i, :n], e0[i, :n], eb[i, :n] = p.energy_rows()
        if not any_energy:
            return BatchedProblems(c2, c1, c0, T, total, d_lo, d_hi, valid)
        return BatchedProblems(c2, c1, c0, T, total, d_lo, d_hi, valid, e2, e1, e0, eb)

    def problem(self, i: int) -> AllocationProblem:
        """The i-th (unpadded) AllocationProblem."""
        v = self.valid[i]
        energy = e_budget = None
        if self.has_energy:
            energy = EnergyModel(e2=self.e2[i, v], e1=self.e1[i, v], e0=self.e0[i, v])
            if self.e_budget is not None:
                e_budget = self.e_budget[i, v]
        return AllocationProblem(
            time_model=TimeModel(c2=self.c2[i, v], c1=self.c1[i, v], c0=self.c0[i, v]),
            T=float(self.T[i]),
            total_samples=int(self.total[i]),
            d_lower=int(round(float(self.d_lo[i, v].min()))),
            d_upper=int(round(float(self.d_hi[i, v].max()))),
            energy=energy,
            e_budget=e_budget,
        )


@dataclasses.dataclass(frozen=True)
class BatchedAllocation:
    """Batched solver output; padded slots hold tau = d = 0. ``rounds``
    counts the host loop's rounds of each stage (``grow``, ``bisection``,
    ``integerize``, ``sai``)."""

    tau: np.ndarray           # (B, K) int
    d: np.ndarray             # (B, K) int
    feasible: np.ndarray      # (B,) bool
    valid: np.ndarray         # (B, K) bool
    method: str = ""
    relaxed_tau: np.ndarray | None = None   # (B, K)
    relaxed_d: np.ndarray | None = None     # (B, K)
    tau_star: np.ndarray | None = None      # (B,)
    rounds: dict | None = None

    @property
    def num_problems(self) -> int:
        return int(self.tau.shape[0])

    def allocation(self, i: int) -> Allocation:
        """Per-problem Allocation (strips padding); raises on infeasible."""
        if not self.feasible[i]:
            raise ValueError(f"problem {i} infeasible: deadline cannot absorb d")
        v = self.valid[i]
        return Allocation(
            tau=self.tau[i, v].astype(np.int64),
            d=self.d[i, v].astype(np.int64),
            method=self.method,
            relaxed_tau=None if self.relaxed_tau is None else self.relaxed_tau[i, v],
            relaxed_d=None if self.relaxed_d is None else self.relaxed_d[i, v],
        )

    def summary(self, bp: BatchedProblems) -> dict:
        return batched_summary(bp, self.tau, self.d)


# ---------------------------------------------------------------------------
# batched metrics (host NumPy, copied)
# ---------------------------------------------------------------------------

def batched_max_staleness(tau: np.ndarray, valid: np.ndarray | None = None) -> np.ndarray:
    """(B,) max-pair staleness  max_k tau - min_k tau  over valid learners."""
    tau = np.asarray(tau)
    if valid is None:
        valid = np.ones(tau.shape, bool)
    tmax = np.where(valid, tau, -1).max(axis=1)
    tmin = np.where(valid, tau, _INT_SENTINEL).min(axis=1)
    n = valid.sum(axis=1)
    return np.where(n >= 2, tmax - tmin, 0).astype(np.int64)


def batched_avg_staleness(tau: np.ndarray, valid: np.ndarray | None = None) -> np.ndarray:
    """(B,) mean |tau_k - tau_l| over valid pairs k < l (paper Eq. 13)."""
    tau = np.asarray(tau, dtype=float)
    if valid is None:
        valid = np.ones(tau.shape, bool)
    k = tau.shape[1]
    diff = np.abs(tau[:, :, None] - tau[:, None, :])
    pair = (valid[:, :, None] & valid[:, None, :]) & np.triu(np.ones((k, k), bool), 1)
    n = valid.sum(axis=1)
    denom = n * (n - 1) / 2.0
    return np.where(denom > 0, (diff * pair).sum(axis=(1, 2)) / np.maximum(denom, 1.0), 0.0)


def batched_summary(bp: BatchedProblems, tau: np.ndarray, d: np.ndarray) -> dict:
    """Vectorized twin of ``Allocation.summary``: dict of (B,) arrays."""
    tau = np.asarray(tau); d = np.asarray(d)
    v = bp.valid
    t = bp.c2 * tau * d + bp.c1 * d + bp.c0
    n = np.maximum(v.sum(axis=1), 1)
    return {
        "max_staleness": batched_max_staleness(tau, v),
        "avg_staleness": batched_avg_staleness(tau, v),
        "total_updates": np.where(v, tau * d, 0).sum(axis=1).astype(np.int64),
        "min_tau": np.where(v, tau, _INT_SENTINEL).min(axis=1).astype(np.int64),
        "max_tau": np.where(v, tau, -1).max(axis=1).astype(np.int64),
        "utilization": np.where(v, t / bp.T[:, None], 0.0).sum(axis=1) / n,
    }


# ---------------------------------------------------------------------------
# device building blocks: (B, K) tensors, (B,) per-fleet scalars
# ---------------------------------------------------------------------------

def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for every row b."""
    return x.gather(1, idx[:, None])[:, 0]


def _max_tau_of_d(d, c2, c1, c0, T):
    """Largest integer tau with t_k <= T at integer d (TimeModel.max_tau);
    ``T`` is (B, 1)."""
    df = d.to(c2.dtype)
    t = torch.floor((T - c0 - c1 * df) / (c2 * df))
    t = torch.where(d > 0, t, 0.0)
    return torch.clamp_min(t, 0.0).to(d.dtype)


def _max_tau_energy(d, e2, e1, e0, eb):
    """Largest integer tau with E_k <= eb at integer d, the energy twin of
    ``_max_tau_of_d``: ``_TAU_BIG`` where compute is free (e2 = 0) or the
    budget infinite; 0 where even tau = 0 busts the budget."""
    df = d.to(e2.dtype)
    num = eb - e0 - e1 * df
    den = e2 * df
    pos = den > 0
    raw = torch.where(pos, num / torch.where(pos, den, 1.0),
                      torch.where(num >= 0, torch.inf, -1.0))
    t = torch.floor(raw)
    t = torch.where(torch.isfinite(t), t, float(_TAU_BIG))
    t = torch.where(d > 0, t, 0.0)
    return torch.clamp_min(t, 0.0).to(d.dtype)


def _relaxed_batched(c2, c1, c0, T, total_f, d_lo, d_hi, *, tol, max_iter, energy=None):
    """Lockstep water-filling bisection over the (B,) batch, branch for
    branch ``solver_kkt.solve_relaxed`` per fleet. With ``energy = (e2, e1,
    e0, eb)`` rows it is the budgeted bisection of ``solve_energy``: each
    learner absorbs ``min(d_time, d_energy)`` at the water level, every step
    is one ``ops.waterfill_energy_residual`` call, and the relaxed tau is
    the tighter of the two caps at the final d. Returns ``(feasible,
    tau_star, tau, d, rounds)``."""

    if energy is None:
        def resid(tau_star):
            return ops.waterfill_residual(tau_star, c2, c1, c0, T, d_lo, d_hi, total_f)
    else:
        e2, e1, e0, eb = energy

        def resid(tau_star):
            return ops.waterfill_energy_residual(tau_star, c2, c1, c0, T, e2, e1, e0, eb,
                                                 d_lo, d_hi, total_f)

    zero = torch.zeros_like(T)
    feasible = resid(zero) >= -1e-9

    # grow hi per fleet until the absorbed data drops below total
    hi = torch.ones_like(T)
    r = resid(hi)
    grow = 0
    while grow < 200 and bool((r > 0).any()):
        hi = torch.where(r > 0, hi * 2.0, hi)
        grow += 1
        r = resid(hi)

    # bisection; each fleet's convergence latches via `done`
    lo = torch.zeros_like(T)
    done = torch.zeros_like(T, dtype=torch.bool)
    steps = 0
    while steps < max_iter and not bool(done.all()):
        mid = 0.5 * (lo + hi)
        r = resid(mid)
        upd = ~done
        lo = torch.where(upd & (r > 0), mid, lo)
        hi = torch.where(upd & (r <= 0), mid, hi)
        done = done | (hi - lo < tol * torch.clamp_min(hi, 1.0))
        steps += 1
    tau_star = 0.5 * (lo + hi)

    Tc = T[:, None]
    d = (Tc - c0) / (c2 * tau_star[:, None] + c1)
    if energy is not None:
        d = torch.minimum(d, (eb - e0) / (e2 * tau_star[:, None] + e1))
    d = torch.clamp(d, d_lo, d_hi)
    # spread the bisection's residual gap over unclamped learners
    free = (d > d_lo + 1e-9) & (d < d_hi - 1e-9)
    gap = total_f - sum_in_order(d)
    fsum = sum_in_order(torch.where(free, d, 0.0))
    add = torch.where(
        free & (fsum > 0)[:, None],
        gap[:, None] * d / torch.where(fsum > 0, fsum, 1.0)[:, None],
        0.0,
    )
    d = torch.clamp(d + add, d_lo, d_hi)
    tau = (Tc - c0 - c1 * d) / (c2 * d)
    if energy is not None:
        tau = torch.minimum(tau, (eb - e0 - e1 * d) / (e2 * d))
    tau = torch.where(d > 0, torch.clamp_min(tau, 0.0), 0.0)
    return feasible, tau_star, tau, d, {"grow": grow, "bisection": steps}


def _integerize(d_real, total_i, lo_i, hi_i):
    """Largest-remainder rounding to the exact sum within bounds
    (``solver_kkt._integerize_d``): the ``i % k`` walk over the stable
    remainder order, one learner a round in every fleet. Returns
    ``(base, leftover, rounds)``."""
    k = d_real.shape[1]
    fl = torch.floor(d_real)
    base = torch.clamp(fl, lo_i.to(d_real.dtype), hi_i.to(d_real.dtype)).to(total_i.dtype)
    rema = d_real - fl
    deficit = total_i - base.sum(dim=1).to(total_i.dtype)
    pos = deficit > 0
    order = torch.where(pos[:, None], torch.argsort(-rema, dim=1, stable=True),
                        torch.argsort(rema, dim=1, stable=True))
    step = torch.where(pos, 1, -1).to(base.dtype)
    limit = 10 * k + total_i.abs() + 1
    i = 0
    active = (deficit != 0) & (i < limit)
    while bool(active.any()):
        kk = order[:, i % k]
        cur = _pick(base, kk)
        ok = torch.where(pos, cur < _pick(hi_i, kk), cur > _pick(lo_i, kk))
        delta = torch.where(ok & active, step, 0)
        base = base.scatter_add(1, kk[:, None], delta[:, None])
        deficit = deficit - delta
        i += 1
        active = (deficit != 0) & (i < limit)
    return base, deficit, i


def _sai(d0, c2, c1, c0, T, lo_i, hi_i, valid, *, max_rounds, energy=None):
    """Greedy suggest-and-improve repair (``solver_kkt.suggest_and_improve``)
    in lockstep: move samples from a min-tau learner to the highest-tau
    learner with headroom while staleness improves. With ``energy = (e2,
    e1, e0, eb)`` rows every tau is also capped by the budget
    (``_max_tau_energy``), as ``solver_kkt._sai_energy_np`` caps it.
    Returns ``(tau, d, rounds)``."""
    Tc = T[:, None]
    neg_inf = torch.tensor(-torch.inf, dtype=c2.dtype, device=c2.device)

    def tau_of(d):
        t = _max_tau_of_d(d, c2, c1, c0, Tc)
        if energy is None:
            return t
        return torch.minimum(t, _max_tau_energy(d, *energy))

    def stats(tau):
        tmax = torch.where(valid, tau, -1).amax(dim=1)
        tmin = torch.where(valid, tau, _INT_SENTINEL).amin(dim=1)
        return tmax, tmin

    def valid_sum(tau):
        return torch.where(valid, tau, 0).sum(dim=1)

    d, tau = d0, tau_of(d0)
    stopped = torch.zeros_like(valid[:, 0])
    one = torch.ones_like(d0[:, 0])
    n = 0
    while n < max_rounds and not bool(stopped.all()):
        act = ~stopped
        tmax, tmin = stats(tau)
        s = tmax - tmin
        hi0 = torch.where(valid, tau, -1).argmax(dim=1)
        # min-tau learner freeing the most tau per sample removed (max c2)
        lo = torch.where(valid & (tau == tmin[:, None]), c2, neg_inf).argmax(dim=1)
        give = _pick(d, lo) - _pick(lo_i, lo)
        room_k = torch.minimum(hi_i - d, give[:, None])
        room0 = _pick(room_k, hi0)
        # fallback: next-highest-tau learner (above the min) with room
        elig = valid & (tau > tmin[:, None]) & (room_k > 0)
        hi1 = torch.where(elig, tau, -1).argmax(dim=1)
        fallback = room0 <= 0
        hi = torch.where(fallback, hi1, hi0)
        room = torch.where(fallback, _pick(room_k, hi1), room0)
        has_target = torch.where(fallback, elig.any(dim=1), True)
        tau_sum = valid_sum(tau)

        def try_move(m):
            d2 = d.scatter_add(1, hi[:, None], m[:, None]).scatter_add(1, lo[:, None], -m[:, None])
            tau2 = tau_of(d2)
            tmax2, tmin2 = stats(tau2)
            s2 = tmax2 - tmin2
            better = (s2 < s) | ((s2 == s) & (valid_sum(tau2) > tau_sum))
            return d2, tau2, better

        m_big = torch.clamp_min(torch.div(room, 8, rounding_mode="floor"), 1)
        d2a, tau2a, acc_a = try_move(m_big)
        d2b, tau2b, acc_b = try_move(one)
        retry = ~acc_a & (m_big > 1) & acc_b
        do_move = (s > 0) & has_target & (acc_a | retry)
        move = (act & do_move)[:, None]
        take_a = acc_a[:, None]
        d = torch.where(move, torch.where(take_a, d2a, d2b), d)
        tau = torch.where(move, torch.where(take_a, tau2a, tau2b), tau)
        stopped = stopped | ~do_move
        n += 1
    return tau, d, n


def _integer_inputs(d_r, feasible, total_i, d_lo, d_hi):
    """The integer stages' inputs: ``(d_r, total, lo_i, hi_i)`` with the
    infeasible rows neutralized (their lower bounds and budget), so the
    integer loops end at once for them."""
    lo_i = torch.round(d_lo).to(total_i.dtype)
    hi_i = torch.round(d_hi).to(total_i.dtype)
    total_safe = torch.where(feasible, total_i, lo_i.sum(dim=1).to(total_i.dtype))
    d_r_safe = torch.where(feasible[:, None], d_r, d_lo)
    return d_r_safe, total_safe, lo_i, hi_i


def _integerize_and_repair(d_r, feasible, c2, c1, c0, T, total_i, d_lo, d_hi,
                           valid, *, max_rounds, energy=None):
    """The integer tail of every batched policy: largest-remainder rounding
    to the exact sum, then the SAI repair (with every tau capped by the
    ``energy`` rows, if given). Returns ``(tau, d, feasible, rounds)``."""
    d_r_safe, total_safe, lo_i, hi_i = _integer_inputs(d_r, feasible, total_i, d_lo, d_hi)
    d_int, leftover, int_rounds = _integerize(d_r_safe, total_safe, lo_i, hi_i)
    # a walk that exhausted its bound without reaching the sum (hand-built
    # boxes only) must not pass for a solution
    feasible = feasible & (leftover == 0)
    tau, d, n = _sai(d_int, c2, c1, c0, T, lo_i, hi_i, valid, max_rounds=max_rounds,
                     energy=energy)
    return tau, d, feasible, {"integerize": int_rounds, "sai": n}


def _kkt_batched_core(c2, c1, c0, T, total_i, d_lo, d_hi, valid, *,
                      tol, max_iter, max_rounds):
    """KKT water-filling + SAI on device tensors."""
    feasible, tau_star, tau_r, d_r, rounds = _relaxed_batched(
        c2, c1, c0, T, total_i.to(c2.dtype), d_lo, d_hi, tol=tol, max_iter=max_iter,
    )
    tau, d, feasible, int_rounds = _integerize_and_repair(
        d_r, feasible, c2, c1, c0, T, total_i, d_lo, d_hi, valid, max_rounds=max_rounds,
    )
    return dict(tau=tau, d=d, feasible=feasible, relaxed_tau=tau_r, relaxed_d=d_r,
                tau_star=tau_star, rounds={**rounds, **int_rounds})


def apply_energy_mask(total_i, d_lo, d_hi, valid, energy):
    """Project a (B, K) policy problem onto its affordable sub-fleet.

    The budget at tau = 0 caps each learner's data at ``(eb - e0) / e1``
    samples; the upper bound is tightened to that cap, and a learner whose
    cap cannot cover its ``d_lo`` is masked out through
    ``apply_active_mask`` (the padded-slot semantics, as for an offline
    learner). An infinite budget changes nothing: the cap is +inf.
    ``energy`` is the ``(e2, e1, e0, eb)`` tuple of (B, K) tensors. Returns
    ``(total, d_lo, d_hi, valid)``."""
    e2, e1, e0, eb = energy
    room = eb - e0
    pos = e1 > 0
    capf = torch.where(pos, room / torch.where(pos, e1, 1.0),
                       torch.where(room >= 0, torch.inf, -1.0))
    hi_e = torch.minimum(torch.clamp_min(torch.minimum(torch.floor(capf), d_hi), 0.0), d_hi)
    return apply_active_mask(total_i, d_lo, hi_e, valid, hi_e >= d_lo)


def _kkt_energy_core(c2, c1, c0, T, total_i, d_lo, d_hi, valid, energy, *,
                     tol, max_iter, max_rounds):
    """The energy-budgeted pipeline (``kkt_energy``): affordability mask,
    budgeted water-filling, integerize, SAI with energy-capped taus. Every
    stage keeps ``E_k(tau, d) <= eb_k``, so its solutions spend within
    budget."""
    total_i, d_lo, d_hi, valid = apply_energy_mask(total_i, d_lo, d_hi, valid, energy)
    feasible, tau_star, tau_r, d_r, rounds = _relaxed_batched(
        c2, c1, c0, T, total_i.to(c2.dtype), d_lo, d_hi, tol=tol, max_iter=max_iter,
        energy=energy,
    )
    tau, d, feasible, int_rounds = _integerize_and_repair(
        d_r, feasible, c2, c1, c0, T, total_i, d_lo, d_hi, valid, max_rounds=max_rounds,
        energy=energy,
    )
    return dict(tau=tau, d=d, feasible=feasible, relaxed_tau=tau_r, relaxed_d=d_r,
                tau_star=tau_star, rounds={**rounds, **int_rounds})


def _eta(total_i, lo_i, hi_i, valid, c2, c1, c0, T):
    """Equal-task allocation (``baselines.solve_eta``) of every fleet:
    d/K spread by index, clipped, then repaired to the exact sum by a walk
    over the stable descending-d order."""
    k = lo_i.shape[1]
    idt = total_i.dtype
    n_valid = torch.clamp_min(valid.sum(dim=1), 1).to(idt)
    base = torch.div(total_i, n_valid, rounding_mode="floor")
    rem = total_i - base * n_valid
    rank = torch.cumsum(valid.to(idt), dim=1).to(idt) - 1
    d = torch.where(valid, base[:, None] + (rank < rem[:, None]).to(idt), 0)
    d = torch.clamp(d, lo_i, hi_i)
    order = torch.argsort(-d, dim=1, stable=True)
    gap = total_i - d.sum(dim=1).to(idt)
    limit = 100 * k + total_i.abs() + 1
    i = 0
    active = (gap != 0) & (i < limit)
    while bool(active.any()):
        kk = order[:, i % k]
        cur = _pick(d, kk)
        delta = torch.where((gap > 0) & (cur < _pick(hi_i, kk)), 1,
                            torch.where((gap < 0) & (cur > _pick(lo_i, kk)), -1, 0))
        delta = torch.where(active, delta, 0).to(idt)
        d = d.scatter_add(1, kk[:, None], delta[:, None])
        gap = gap - delta
        i += 1
        active = (gap != 0) & (i < limit)
    return _max_tau_of_d(d, c2, c1, c0, T[:, None]), d, gap == 0


def _eta_policy(c2, c1, c0, T, total_i, d_lo, d_hi, valid):
    lo_i = torch.round(d_lo).to(total_i.dtype)
    hi_i = torch.round(d_hi).to(total_i.dtype)
    return _eta(total_i, lo_i, hi_i, valid, c2, c1, c0, T)


# ---------------------------------------------------------------------------
# host entry points
# ---------------------------------------------------------------------------

def _as_batched(problems) -> BatchedProblems:
    if isinstance(problems, BatchedProblems):
        return problems
    return BatchedProblems.from_problems(list(problems))


def _to_device(bp: BatchedProblems, x64: bool, device) -> dict:
    dev = resolve_device(device)
    fdt = torch.float64 if x64 else torch.float32
    idt = torch.int64 if x64 else torch.int32
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=fdt, device=dev)
    return dict(
        c2=f(bp.c2), c1=f(bp.c1), c0=f(bp.c0), T=f(bp.T),
        total_i=torch.as_tensor(np.asarray(bp.total), dtype=idt, device=dev),
        d_lo=f(bp.d_lo), d_hi=f(bp.d_hi),
        valid=torch.as_tensor(np.asarray(bp.valid, bool), device=dev),
    )


def solve_kkt_batched(
    problems,
    *,
    x64: bool = True,
    tol: float = 1e-10,
    max_iter: int = 200,
    max_rounds: int = 10_000,
    device=None,
) -> BatchedAllocation:
    """Solve B problems (list[AllocationProblem] or BatchedProblems) with
    the paper's KKT water-filling + SAI pipeline on ``device`` (``None``:
    the card). ``x64=True`` reproduces ``solve_kkt_sai`` per problem
    (modulo the documented remainder-tie tolerance of the reference);
    ``x64=False`` runs float32/int32."""
    bp = _as_batched(problems)
    out = _kkt_batched_core(**_to_device(bp, x64, device), tol=tol,
                            max_iter=max_iter, max_rounds=max_rounds)
    host = {k: v.cpu().numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}
    return BatchedAllocation(
        tau=host["tau"].astype(np.int64),
        d=host["d"].astype(np.int64),
        feasible=host["feasible"],
        valid=np.asarray(bp.valid, bool),
        method="kkt_sai_batched",
        relaxed_tau=host["relaxed_tau"],
        relaxed_d=host["relaxed_d"],
        tau_star=host["tau_star"],
        rounds=out["rounds"],
    )


def _energy_to_device(bp: BatchedProblems, x64: bool, device) -> tuple:
    """``bp.energy_rows()`` as the (e2, e1, e0, eb) tuple of device tensors."""
    fdt = torch.float64 if x64 else torch.float32
    return tuple(torch.as_tensor(r, dtype=fdt, device=resolve_device(device))
                 for r in bp.energy_rows())


def solve_energy_batched(
    problems,
    *,
    x64: bool = True,
    tol: float = 1e-10,
    max_iter: int = 200,
    max_rounds: int = 10_000,
    device=None,
) -> BatchedAllocation:
    """Solve B energy-budgeted problems (arXiv 2012.00143) with the
    ``kkt_energy`` pipeline on ``device`` (``None``: the card); every
    bisection step is one ``ops.waterfill_energy_residual`` call. Problems
    without an energy model get zero-coefficient rows and infinite budgets,
    under which the decisions are ``solve_kkt_batched``'s; with budgets,
    every allocation satisfies ``E_k(tau, d) <= e_budget_k`` (learners
    whose budget cannot cover ``d_lower`` get the padded-slot semantics,
    as offline learners do). ``x64=True`` reproduces ``solve_energy`` per
    problem; ``x64=False`` runs float32/int32."""
    bp = _as_batched(problems)
    out = _kkt_energy_core(**_to_device(bp, x64, device),
                           energy=_energy_to_device(bp, x64, device), tol=tol,
                           max_iter=max_iter, max_rounds=max_rounds)
    host = {k: v.cpu().numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}
    return BatchedAllocation(
        tau=host["tau"].astype(np.int64),
        d=host["d"].astype(np.int64),
        feasible=host["feasible"],
        valid=np.asarray(bp.valid, bool),
        method="kkt_energy_batched",
        relaxed_tau=host["relaxed_tau"],
        relaxed_d=host["relaxed_d"],
        tau_star=host["tau_star"],
        rounds=out["rounds"],
    )


def solve_eta_batched(problems, *, x64: bool = True, device=None) -> BatchedAllocation:
    """Equal-task-allocation baseline (``baselines.solve_eta``) over a
    batch: d_k = d/K spread by index, bound-clipped, integer-sum repaired,
    then tau_k maximal per learner."""
    bp = _as_batched(problems)
    tau, d, ok = _eta_policy(**_to_device(bp, x64, device))
    return BatchedAllocation(
        tau=tau.cpu().numpy().astype(np.int64), d=d.cpu().numpy().astype(np.int64),
        feasible=ok.cpu().numpy(), valid=np.asarray(bp.valid, bool),
        method="eta_batched",
    )


def batched_policy(name: str, *, tol: float = 1e-10, max_iter: int = 200,
                   max_rounds: int = 10_000, pgd_steps: int = 600):
    """The per-cycle re-solve hook of the orchestrator: a callable
    ``fn(c2, c1, c0, T, total_i, d_lo, d_hi, valid) -> (tau, d, feasible)``
    on device tensors (``c2/c1/c0/d_lo/d_hi``: (B, K) float; ``T``: (B,)
    float; ``total_i``: (B,) int; ``valid``: (B, K) bool, padded slots with
    ``d_lo = d_hi = 0``). ``tau, d`` come back (B, K) int (0 in padded
    slots), ``feasible`` (B,) bool, False where even tau = 0 cannot absorb
    the budget (such rows hold neutralized values).

    ``name`` is one of ``POLICIES``: ``"kkt_sai"`` (water-filling + SAI),
    ``"eta"`` (equal-task), ``"kkt_energy"`` (the budgeted pipeline; it
    takes a 9th argument, the ``(e2, e1, e0, eb)`` tuple of (B, K) energy
    rows, and with ``eb = +inf`` decides as ``kkt_sai``) or ``"pgd"``
    (relaxed projected gradient, ``pgd_steps`` steps, then the same integer
    tail; an optional 9th argument as ``kkt_energy``'s). float64 inputs
    reproduce the NumPy solvers decision for decision; float32 inputs give
    the float32 path."""
    if name == "kkt_sai":
        def kkt_policy(c2, c1, c0, T, total_i, d_lo, d_hi, valid):
            out = _kkt_batched_core(c2, c1, c0, T, total_i, d_lo, d_hi, valid,
                                    tol=tol, max_iter=max_iter, max_rounds=max_rounds)
            return out["tau"], out["d"], out["feasible"]
        return kkt_policy
    if name == "kkt_energy":
        def kkt_energy_policy(c2, c1, c0, T, total_i, d_lo, d_hi, valid, energy):
            out = _kkt_energy_core(c2, c1, c0, T, total_i, d_lo, d_hi, valid, energy,
                                   tol=tol, max_iter=max_iter, max_rounds=max_rounds)
            return out["tau"], out["d"], out["feasible"]
        return kkt_energy_policy
    if name == "eta":
        return _eta_policy
    if name == "pgd":
        from repro_torch.core.solver_numeric import pgd_policy

        def pgd(c2, c1, c0, T, total_i, d_lo, d_hi, valid, energy=None):
            return pgd_policy(c2, c1, c0, T, total_i, d_lo, d_hi, valid, energy,
                              steps=pgd_steps, max_rounds=max_rounds)
        return pgd
    raise ValueError(f"no batched policy for scheme {name!r}; choose from "
                     f"{' | '.join(POLICIES)}")


def apply_active_mask(total_i, d_lo, d_hi, valid, active):
    """Project a (B, K) policy problem onto its online sub-fleet: offline
    slots get the padded-slot semantics (``d_lo = d_hi = 0``,
    ``valid=False``) and each fleet's budget is clipped into its live box
    ``[sum d_lo, sum d_hi]``. Torch tensors in, ``(total, d_lo, d_hi,
    valid)`` of the same shapes and dtypes out."""
    act = torch.as_tensor(active, dtype=torch.bool, device=d_lo.device)
    lo = torch.where(act, d_lo, 0.0)
    hi = torch.where(act, d_hi, 0.0)
    v = valid & act
    tot = torch.clamp(total_i.to(lo.dtype), lo.sum(dim=-1), hi.sum(dim=-1))
    return tot.to(total_i.dtype), lo, hi, v


def apply_sampling_mask(total_i, d_lo, d_hi, valid, sampled):
    """Project a fleet-axis policy problem onto the round's sampled fleets:
    ``apply_active_mask`` with the per-fleet (B,) bool mask ``sampled``
    broadcast over the learner axis. A sampled-out fleet is then exactly an
    all-offline fleet, which is exactly a row of ``BatchedProblems`` padded
    slots (zero boxes, ``valid=False``, budget 0), so the policies solve it
    to tau = d = 0 without going infeasible."""
    act = torch.as_tensor(sampled, dtype=torch.bool, device=d_lo.device)[..., None] & valid
    return apply_active_mask(total_i, d_lo, d_hi, valid, act)


# ---------------------------------------------------------------------------
# cross-model allocation layer (FedAST-style multi-tenant split)
# ---------------------------------------------------------------------------

#: cross-model budget-split policies (see ``cross_model_weights``)
SPLIT_POLICIES = ("deficit", "equal")

#: split weights are floored onto this binary grid so their exact sum is a
#: representable float <= 1.0 — the budget-conservation guarantee cannot be
#: eaten by rounding in the normalization divides.
_SPLIT_GRID = float(2**20)


def _fma(a: float, b: float, c: float) -> float:
    """``a * b + c`` rounded once to float64 (exact rationals, then one
    correctly rounded conversion)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def cross_model_weights(deficits, *, policy: str = "deficit",
                        share_floor: float = 0.0, fused: bool = True) -> torch.Tensor:
    """Per-model budget-split weights ``w`` of shape (S,) from a (S,)
    progress-deficit signal (how far each tenant model trails the
    front-runner, in server versions: model-value-free, so the schedule
    stays bit-reproducible).

    ``policy="deficit"`` splits proportionally to ``max(deficits, 0)``
    (equal split when all deficits are zero); ``policy="equal"`` is the
    uniform 1/S baseline. ``share_floor`` mixes a uniform floor in
    (``w = (1 - S*floor) p + floor``) so no tenant is fully starved; it
    requires ``share_floor * S <= 1``.

    The weights are floored onto a 2^-20 grid, so ``w.sum()`` is an exactly
    representable float <= 1.0; S = 1 returns exactly 1.0, with no grid and
    no arithmetic. S is small, so the weights are computed on the host in
    float64 and returned as a float64 tensor on the deficits' device (the
    CPU for a non-tensor).

    ``fused=False`` rounds the floor's multiply and add apart, as the
    reference's eager callers do (``FleetEngine.solve_multimodel``)."""
    if policy not in SPLIT_POLICIES:
        raise ValueError(
            f"no cross-model split policy {policy!r}; "
            f"choose from {' | '.join(SPLIT_POLICIES)}"
        )
    dev = None
    if isinstance(deficits, torch.Tensor):
        dev, deficits = deficits.device, deficits.cpu().numpy()
    d = np.asarray(deficits, np.float64).reshape(-1)
    s = int(d.shape[0])
    if s == 1:
        return torch.ones(1, dtype=torch.float64, device=dev)
    if share_floor < 0 or share_floor * s > 1.0:
        raise ValueError(f"share_floor={share_floor} must satisfy "
                         f"0 <= share_floor * S <= 1 (S={s})")
    if policy == "equal":
        p = [1.0 / s] * s
    else:
        c = [max(x, 0.0) for x in d.tolist()]
        tot = sum(c)   # in index order
        p = [x / tot for x in c] if tot > 0 else [1.0 / s] * s
    if share_floor > 0.0:
        # the reference computes this line inside a jit, where XLA fuses the
        # multiply and the add into one FMA on the CPU; rounding twice moves
        # some weights by one grid step, so it is one rounding here too
        a = 1.0 - s * share_floor
        p = [_fma(a, x, share_floor) if fused else a * x + share_floor for x in p]
    w = np.floor(np.asarray(p, np.float64) * _SPLIT_GRID) / _SPLIT_GRID
    return torch.as_tensor(w, device=dev)


def _as_float_tensor(x) -> torch.Tensor:
    """A tensor as it is; anything else through NumPy (a Python float is
    float64, as under the reference's ``enable_x64``)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def cross_model_split(deficits, T, e_budget=None, *, policy: str = "deficit",
                      share_floor: float = 0.0):
    """Split shared budgets across S tenant models: ``(w, T_split,
    eb_split)`` with ``T_split = w * T`` ((S,) per-model deadlines from a
    scalar or (S,) shared deadline) and ``eb_split = w[:, None] *
    e_budget`` ((S, K) per-model per-learner joule budgets; infinite
    budgets stay infinite rather than going 0 * inf = nan). With ``w.sum()
    <= 1.0`` exact (``cross_model_weights``), each learner's summed
    time and energy commitment across tenants stays within its
    single-tenant budget."""
    w = cross_model_weights(deficits, policy=policy, share_floor=share_floor)
    T = _as_float_tensor(T)
    w = w.to(device=T.device, dtype=T.dtype)
    T_split = w * T
    eb_split = None
    if e_budget is not None:
        eb = _as_float_tensor(e_budget)
        eb_split = torch.where(torch.isinf(eb), eb, w.to(eb.device)[:, None] * eb)
    return w, T_split, eb_split


def _covers_floor(T_s, c0, c1, d_lo) -> torch.Tensor:
    """(S, K) bool ``T_s[:, None] >= c0 + c1 * d_lo``: whether a model's
    deadline share covers a learner's cost at tau = 0 and its lower bound.
    The reference evaluates ``c0 + c1 * d_lo`` inside a jit, where XLA
    fuses it into one FMA on the CPU, so it is rounded once here too (on
    the host: S x K values)."""
    host = [t.detach().cpu().to(torch.float64).reshape(-1).tolist() for t in (c0, c1, d_lo)]
    need = torch.tensor([_fma(b, c, a) for a, b, c in zip(*host)], dtype=torch.float64)
    need = need.reshape(c0.shape).to(device=c0.device, dtype=c0.dtype)
    return T_s[:, None] >= need


def multimodel_policy(name: str, *, split: str = "deficit", share_floor: float = 0.0,
                      **policy_kwargs):
    """The cross-model allocation layer: a policy over the (S, K)
    multi-tenant problem (S models sharing one K-learner pool), on device
    tensors.

    It splits each learner's deadline ``T`` (and the per-learner joule
    budgets, for the energy-aware policies) across the models with
    ``cross_model_split`` on the progress deficits, scales each model's
    sample budget by its share, degrades (model, learner) cells whose share
    cannot cover ``c0 + c1 * d_lo`` to the padded-slot semantics
    (``apply_active_mask``, as offline learners under churn), and solves
    all S rows with one ``batched_policy(name, **policy_kwargs)`` call.

    Returns ``fn(deficits, c2, c1, c0, T, total_i, d_lo, d_hi, valid[,
    energy]) -> (tau, d, feasible, w)`` with ``deficits`` (S,),
    ``c2/c1/c0/d_lo/d_hi/valid`` (S, K), ``T`` (S,) full per-model
    deadlines, ``total_i`` (S,) sample budgets and ``energy`` the optional
    ``(e2, e1, e0, eb)`` rows of shape (S, K). S = 1 is a pass-through:
    ``w = [1.0]`` and the base policy sees its inputs untouched."""
    base = batched_policy(name, **policy_kwargs)

    def fn(deficits, c2, c1, c0, T, total_i, d_lo, d_hi, valid, energy=None):
        s = int(c2.shape[0])
        if s == 1:
            w = torch.ones(1, dtype=T.dtype, device=T.device)
            if energy is None:
                tau, d, ok = base(c2, c1, c0, T, total_i, d_lo, d_hi, valid)
            else:
                tau, d, ok = base(c2, c1, c0, T, total_i, d_lo, d_hi, valid, energy)
            return tau, d, ok, w
        eb = energy[3] if energy is not None else None
        w, T_s, eb_s = cross_model_split(deficits, T, eb, policy=split,
                                         share_floor=share_floor)
        total_s = torch.round(w * total_i.to(c2.dtype)).to(total_i.dtype)
        active = valid & _covers_floor(T_s, c0, c1, d_lo)
        total_s, lo, hi, v = apply_active_mask(total_s, d_lo, d_hi, valid, active)
        if energy is None:
            tau, d, ok = base(c2, c1, c0, T_s, total_s, lo, hi, v)
        else:
            e2, e1, e0, _ = energy
            tau, d, ok = base(c2, c1, c0, T_s, total_s, lo, hi, v, (e2, e1, e0, eb_s))
        return tau, d, ok, w

    return fn
