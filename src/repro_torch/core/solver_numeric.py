"""Numerical solvers for the relaxed allocation program (paper Sec. IV
compares the analytic SAI solution against off-the-shelf NLP solvers).

The port of ``repro/core/solver_numeric.py``:

1. ``solve_slsqp`` — scipy SLSQP on the full relaxed program (Eq. 8):
   variables x = [tau_1..tau_K, d_1..d_K, z], objective z, the time
   equalities, the sum constraint and pairwise staleness inequalities
   (a NumPy copy).

2. ``solve_pgd_jax`` and the batched ``pgd_relaxed_batch`` /
   ``solve_pgd_batched`` — projected gradient descent in d-space: the time
   equalities are eliminated through tau_k(d_k), the smoothed max-min
   staleness is the loss (its gradient from ``torch.autograd``), and every
   step is projected onto {sum d = total} intersect the box. A (B, K) batch
   runs in lockstep on the tensors' device. ``pgd_policy`` is the ``pgd``
   batched policy of ``solver_batched.batched_policy``.

All of them return continuous solutions that the SAI repair integerizes.

Precision follows the reference's: its single-problem and batched-struct
entry points run float32 (jax without 64-bit mode), its policy runs in the
dtype of its inputs (float64 from the orchestrator). The smoothed
objective goes through a log-sum-exp whose float rounding differs from
XLA's (which fuses multiply-adds), so a relaxed ``d`` may differ from the
reference's in its last bits; the parity tests hold the integer
allocations after SAI.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.allocation import Allocation, AllocationProblem
from repro_torch.core.solver_batched import (
    BatchedProblems,
    _integerize_and_repair,
    apply_energy_mask,
)
from repro_torch.core.solver_kkt import (
    _affordable_box,
    _energy_rows_or_free,
    _integerize_d_vec,
    _sai_energy_np,
    suggest_and_improve,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import sum_in_order

__all__ = ["solve_slsqp", "solve_pgd_jax", "pgd_relaxed_batch", "solve_pgd_batched"]


# ---------------------------------------------------------------------------
# scipy SLSQP on the full relaxed program
# ---------------------------------------------------------------------------

def solve_slsqp(prob: AllocationProblem, *, max_iter: int = 300) -> Allocation:
    from scipy.optimize import minimize

    tm = prob.time_model
    k = prob.num_learners
    # init from equal allocation
    d0 = np.full(k, prob.total_samples / k)
    d0 = np.clip(d0, prob.d_lower, prob.d_upper)
    tau0 = np.maximum(tm.tau_of_d(d0, prob.T), 0.0)
    z0 = float(tau0.max() - tau0.min())
    x0 = np.concatenate([tau0, d0, [z0]])

    def split(x):
        return x[:k], x[k : 2 * k], x[-1]

    def objective(x):
        return x[-1]

    def obj_grad(x):
        g = np.zeros_like(x)
        g[-1] = 1.0
        return g

    cons = []

    def time_con(x):
        tau, d, _ = split(x)
        return tm.c2 * tau * d + tm.c1 * d + tm.c0 - prob.T

    cons.append({"type": "eq", "fun": time_con})
    cons.append({"type": "eq", "fun": lambda x: x[k : 2 * k].sum() - prob.total_samples})

    def staleness_con(x):
        tau, _, z = split(x)
        diff = tau[:, None] - tau[None, :]
        iu = np.triu_indices(k, 1)
        pair = diff[iu]
        return np.concatenate([z - pair, z + pair])

    cons.append({"type": "ineq", "fun": staleness_con})

    bounds = (
        [(0.0, None)] * k
        + [(float(prob.d_lower), float(prob.d_upper))] * k
        + [(0.0, None)]
    )
    res = minimize(
        objective,
        x0,
        jac=obj_grad,
        bounds=bounds,
        constraints=cons,
        method="SLSQP",
        options={"maxiter": max_iter, "ftol": 1e-10},
    )
    tau_r, d_r, _ = split(res.x)
    tau, d, it_sai = suggest_and_improve(prob, d_r)
    alloc = Allocation(
        tau=tau,
        d=d,
        method="slsqp_sai",
        relaxed_tau=tau_r,
        relaxed_d=d_r,
        solver_iters=int(res.nit) + it_sai,
    )
    alloc.validate(prob)
    return alloc


# ---------------------------------------------------------------------------
# projected-gradient / penalty solver, (B, K) in lockstep
# ---------------------------------------------------------------------------

def _project_sum_box(d, d_lo, d_hi, total, iters: int = 16):
    """Alternating projection of every row of ``d`` (B, K) onto {sum d =
    total} intersect [d_lo, d_hi]^K; ``total`` is (B,). Padded slots (d_lo
    == d_hi == 0) are pinned at zero and never receive mass."""
    tot = total[:, None]
    for _ in range(iters):
        gap = tot - sum_in_order(d)[:, None]
        free = torch.where(gap > 0, d < d_hi - 1e-9, d > d_lo + 1e-9).to(d.dtype)
        w = free / torch.clamp_min(free.sum(dim=-1, keepdim=True), 1.0)
        d = torch.clamp(d + gap * w, d_lo, d_hi)
    return d


def _tau_of_d_masked(d, c2, c1, c0, T, valid):
    """tau_k(d_k) with padded / zero-d slots pinned at 0 (NaN-safe grads);
    ``T`` is (B, 1)."""
    live = valid & (d > 0)
    d_safe = torch.where(live, d, 1.0)
    tau = torch.maximum((T - c0 - c1 * d) / (c2 * d_safe), torch.zeros_like(d))
    return torch.where(live, tau, 0.0)


def _logsumexp(a):
    """log(sum(exp(a - m))) + m over the last axis with m the row max held
    constant, as ``jax.nn.logsumexp`` computes it; rows of -inf give -inf."""
    m = a.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0).detach()
    return torch.log(sum_in_order(torch.exp(a - m))) + m[..., 0]


def _staleness_loss(d, c2, c1, c0, T, smooth, valid):
    """(B,) smoothed max minus smoothed min of the valid taus."""
    tau = _tau_of_d_masked(d, c2, c1, c0, T, valid)
    smax = smooth * _logsumexp(torch.where(valid, tau, -torch.inf) / smooth)
    smin = -smooth * _logsumexp(torch.where(valid, -tau, -torch.inf) / smooth)
    return smax - smin


def _pgd_run(d0, c2, c1, c0, T, d_lo, d_hi, total, steps: int, valid):
    """Projected gradient descent in d-space with annealed smoothing over a
    (B, K) batch: ``T``/``total`` (B,), the rest (B, K). Returns the
    relaxed ``(tau, d)``."""
    Tc = T[:, None]
    d = d0
    for i in range(steps):
        frac = torch.tensor(i, dtype=d.dtype, device=d.device) / steps
        smooth = 10.0 ** (0.0 - 2.0 * frac)             # 1.0 -> 0.01
        x = d.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = _staleness_loss(x, c2, c1, c0, Tc, smooth, valid)
            (g,) = torch.autograd.grad(loss.sum(), x)
        gnorm = torch.sqrt(sum_in_order(g * g))[:, None] + 1e-12
        lr = 0.05 * (d_hi - d_lo) * (1.0 - 0.9 * frac)
        d = d - lr * g / gnorm
        d = _project_sum_box(d, d_lo, d_hi, total)
    d = _project_sum_box(d, d_lo, d_hi, total, iters=64)
    return _tau_of_d_masked(d, c2, c1, c0, Tc, valid), d


def _energy_cap_tau(tau, d, energy):
    """Cap a relaxed tau by the budget hyperbola at the final d,
    ``tau <= (eb - e0 - e1 d) / (e2 d)``; inert where the budget never
    binds (e2 = 0 or eb = inf), and 0 on zero-d slots."""
    e2, e1, e0, eb = energy
    den = e2 * d
    pos = den > 0
    tau_e = torch.where(pos, (eb - e0 - e1 * d) / torch.where(pos, den, 1.0), torch.inf)
    return torch.where(d > 0, torch.clamp_min(torch.minimum(tau, tau_e), 0.0), 0.0)


def pgd_relaxed_batch(d0, c2, c1, c0, T, d_lo, d_hi, total, *, steps: int = 600,
                      valid=None, energy=None):
    """Batched relaxed PGD on tensors with a leading problem axis B (``T``
    and ``total`` (B,), the rest (B, K)). ``valid`` is an optional (B, K)
    bool mask for padded mixed-K batches (default all valid).

    ``energy``, optional ``(e2, e1, e0, eb)`` rows of shape (B, K), adds
    the projection onto the energy-budget box: the box is tightened by the
    tau = 0 affordability cap (``apply_energy_mask``), the iterations run
    on it, and the returned tau is capped by the budget hyperbola at the
    final d. With ``eb = +inf`` all of it changes nothing."""
    if valid is None:
        valid = torch.ones(d0.shape, dtype=torch.bool, device=d0.device)
    if energy is not None:
        total, d_lo, d_hi, valid = apply_energy_mask(total, d_lo, d_hi, valid, energy)
        d0 = torch.clamp(d0, d_lo, d_hi)
    tau, d = _pgd_run(d0, c2, c1, c0, T, d_lo, d_hi, total, steps, valid)
    if energy is not None:
        tau = _energy_cap_tau(tau, d, energy)
    return tau, d


def solve_pgd_batched(bp: BatchedProblems, *, steps: int = 600, device=None):
    """Relaxed PGD over a ``BatchedProblems`` (mixed-K padding included:
    padded slots stay at zero work, outside the objective) in float32, as
    the reference runs it, on ``device`` (``None``: the card). Structs with
    energy rows solve on the affordability-tightened box with
    budget-capped taus. Returns continuous ``(tau, d)`` tensors of shape
    (B, K); padded entries are 0."""
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                                    device=dev)
    n_valid = np.maximum(bp.valid.sum(axis=1, keepdims=True), 1)
    d0 = np.where(bp.valid, bp.total[:, None] / n_valid, 0.0)
    d0 = np.clip(d0, bp.d_lo, bp.d_hi).astype(np.float32)
    energy = tuple(f32(r) for r in bp.energy_rows()) if bp.has_energy else None
    return pgd_relaxed_batch(
        f32(d0), f32(bp.c2), f32(bp.c1), f32(bp.c0), f32(bp.T), f32(bp.d_lo),
        f32(bp.d_hi), f32(bp.total), steps=steps,
        valid=torch.as_tensor(np.asarray(bp.valid, bool), device=dev), energy=energy,
    )


def pgd_policy(c2, c1, c0, T, total_i, d_lo, d_hi, valid, energy=None, *, steps: int,
               max_rounds: int):
    """The ``pgd`` batched policy: relaxed PGD from the equal split, then
    the integer tail of ``solver_batched``. The optional ``energy = (e2, e1,
    e0, eb)`` rows project the problem onto the energy-budget box first,
    check feasibility with ``ops.waterfill_energy_residual`` (the CUDA
    kernel on the card) and cap every SAI tau by the budget; with
    ``eb = +inf`` the energy-blind decisions are reproduced."""
    if energy is not None:
        total_i, d_lo, d_hi, valid = apply_energy_mask(total_i, d_lo, d_hi, valid, energy)
    total_f = total_i.to(c2.dtype)
    zero = torch.zeros_like(T)
    if energy is None:
        r0 = ops.waterfill_residual(zero, c2, c1, c0, T, d_lo, d_hi, total_f)
    else:
        r0 = ops.waterfill_energy_residual(zero, c2, c1, c0, T, *energy, d_lo, d_hi,
                                           total_f)
    feasible = r0 >= -1e-9
    n_valid = torch.clamp_min(valid.sum(dim=-1, keepdim=True), 1)
    d0 = torch.clamp(torch.where(valid, total_f[:, None] / n_valid, 0.0), d_lo, d_hi)
    _, d_r = _pgd_run(d0, c2, c1, c0, T, d_lo, d_hi, total_f, steps, valid)
    tau, d, feasible, _ = _integerize_and_repair(
        d_r, feasible, c2, c1, c0, T, total_i, d_lo, d_hi, valid, max_rounds=max_rounds,
        energy=energy,
    )
    return tau, d, feasible


def _solve_pgd_energy(prob: AllocationProblem, *, steps: int, device) -> Allocation:
    """Energy-budgeted PGD: ``solve_energy``'s affordability prelude and
    energy-capped integer tail around the relaxed PGD stage (float32, as
    the reference runs it), so every (tau, d) satisfies
    ``E_k <= e_budget_k``."""
    tm = prob.time_model
    energy = _energy_rows_or_free(prob)
    lo, hi, affordable, total, degraded = _affordable_box(prob, energy)
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)[None]
    n_afford = max(int(affordable.sum()), 1)
    d0 = np.clip(np.where(affordable, total / n_afford, 0.0), lo, hi).astype(np.float32)
    tau_r, d_r = _pgd_run(
        f32(d0), f32(tm.c2), f32(tm.c1), f32(tm.c0), f32([prob.T])[0], f32(lo), f32(hi),
        f32([total])[0], steps, torch.as_tensor(affordable, device=dev)[None],
    )
    tau_r = _energy_cap_tau(tau_r, d_r, tuple(f32(r) for r in energy))
    tau_r = tau_r[0].cpu().numpy().astype(float)
    d_r = d_r[0].cpu().numpy().astype(float)

    lo_i = np.round(lo).astype(np.int64)
    hi_i = np.round(hi).astype(np.int64)
    d_int = _integerize_d_vec(d_r, total, lo_i, hi_i)
    tau, d, it_sai = _sai_energy_np(
        d_int, tm.c2, tm.c1, tm.c0, prob.T, lo_i, hi_i, affordable, energy, 10_000,
    )
    alloc = Allocation(
        tau=tau,
        d=d,
        method="pgd_energy_sai",
        relaxed_tau=tau_r,
        relaxed_d=d_r,
        solver_iters=steps + it_sai,
    )
    if not degraded:
        alloc.validate(prob)
    return alloc


def solve_pgd_jax(prob: AllocationProblem, *, steps: int = 600,
                  device=None) -> Allocation:
    """Relaxed PGD (float32, as the reference runs it) on ``device``
    (``None``: the card), then SAI on the host, on one problem; with an
    energy model attached, the budgeted form. The reference's name is
    kept. The orchestrator's ``_solver`` binds the device of the run."""
    if prob.energy is not None:
        return _solve_pgd_energy(prob, steps=steps, device=device)
    tm = prob.time_model
    k = prob.num_learners
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                                    device=dev)
    d0 = torch.clamp(torch.full((1, k), prob.total_samples / k, dtype=torch.float32,
                                device=dev), float(prob.d_lower), float(prob.d_upper))
    row = lambda v: torch.full((1, k), float(v), dtype=torch.float32, device=dev)
    tau_r, d_r = _pgd_run(
        d0, f32(tm.c2)[None], f32(tm.c1)[None], f32(tm.c0)[None], f32([prob.T]),
        row(prob.d_lower), row(prob.d_upper), f32([prob.total_samples]), steps,
        torch.ones((1, k), dtype=torch.bool, device=dev),
    )
    tau_r = tau_r[0].cpu().numpy().astype(float)
    d_r = d_r[0].cpu().numpy().astype(float)
    tau, d, it_sai = suggest_and_improve(prob, d_r)
    alloc = Allocation(
        tau=tau,
        d=d,
        method="pgd_jax_sai",
        relaxed_tau=tau_r,
        relaxed_d=d_r,
        solver_iters=steps + it_sai,
    )
    alloc.validate(prob)
    return alloc
