"""Asynchronous MEL orchestrator (paper Sec. II + V), in torch.

One global cycle of wall-clock budget ``T``:
  1. allocate (tau_k, d_k) with the chosen scheme,
  2. dispatch the global model + per-learner batches,
  3. every learner runs tau_k local GD updates on its masked shard,
  4. staleness-aware aggregation (ref [10]) of the returned models.

Two paths, as in ``repro/fed/orchestrator.py``:

  * ``run`` / ``run_cycle`` — eager: shards staged each cycle, local
    training by autograd (``local_train``), aggregation by ``aggregate``;
    plain torch on whichever device holds the parameters.
  * ``run_fused`` — one flat draw of the per-cycle total a cycle, all
    staged up front on the device; each cycle splits its draw by that
    cycle's d there and is one ``kernels.ops.train_agg_step`` call: the
    CUDA train+aggregate kernels on the card, their plain version on the
    CPU.

Both draw the same shards and allocation for the same seed.

Per-cycle reallocation (``reallocate=True``, both paths): each cycle's
allocation is re-solved on that cycle's capacities through
``core.solver_batched.batched_policy`` (``solve_policy_row``) on the
parameters' device, so on the card every bisection step launches the
water-filling kernel. With a ``CapacityDrift`` the capacity rows are the
drift's ``coefficient_path``; with a state-coupled ``QueueDrift`` rows and
allocations roll out together (``solve_rows_state_coupled``). An
infeasible cycle raises ``ValueError`` naming it, after the cycles before
it trained (``self.params`` holds them). The energy-aware schemes
(``ENERGY_SCHEMES``) solve with the problem's energy rows
(``policy_energy_args``), so on the card their bisections launch the
budgeted water-filling kernel.

Availability processes and ``BatteryDrift`` (client churn, battery drain)
have no offline semantics in the cycle-gated ``Orchestrator``, which
rejects them as the reference does; the async engine runs them through
``solve_rows_availability``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (
    Allocation,
    AllocationProblem,
    CapacityDrift,
    QueueDrift,
    aggregate,
    apply_active_mask,
    batched_policy,
    fedavg_weights,
    has_availability,
    is_state_coupled,
    solve_eta,
    solve_kkt_energy,
    solve_kkt_sai,
    solve_pgd_jax,
    solve_slsqp,
    solve_synchronous,
    staleness_weights,
)
from repro_torch.core.solver_batched import POLICIES
from repro_torch.core.staleness import avg_staleness, max_staleness
from repro_torch.data.pipeline import Dataset, FederatedPartitioner
from repro_torch.kernels import ops
from repro_torch.models import mlp

__all__ = [
    "ENERGY_SCHEMES",
    "MELConfig",
    "Orchestrator",
    "SCHEMES",
    "coefficient_rows",
    "local_train",
    "local_train_stacked",
    "policy_energy_args",
    "policy_problem_args",
    "require_standalone_rows",
    "solve_policy_row",
    "solve_rows_availability",
    "solve_rows_state_coupled",
]

SCHEMES: dict[str, Callable[[AllocationProblem], Allocation]] = {
    "kkt_sai": solve_kkt_sai,
    "kkt_energy": solve_kkt_energy,
    "slsqp": solve_slsqp,
    "pgd": solve_pgd_jax,
    "eta": solve_eta,
    "sync": solve_synchronous,
}

# schemes whose batched policy takes the (e2, e1, e0, e_budget) energy rows
# (with e_budget = +inf the rows change no decision)
ENERGY_SCHEMES = frozenset({"kkt_energy", "pgd"})


def _solver(scheme: str, device=None) -> Callable[[AllocationProblem], Allocation]:
    """The scheme's per-problem solver. ``pgd`` runs its gradient stage on
    ``device`` (``None``: the card), the device of the run that asks; the
    other schemes are host NumPy."""
    if scheme not in SCHEMES:
        raise KeyError(f"unknown scheme {scheme!r}; choose from {' | '.join(SCHEMES)}")
    if scheme == "pgd":
        return functools.partial(solve_pgd_jax, device=device)
    return SCHEMES[scheme]


def _check_drift(drift) -> None:
    """The drifts the port runs: None, ``CapacityDrift``, ``QueueDrift``, an
    availability process or ``BatteryDrift`` (both have ``online_at``)."""
    if (drift is not None and not isinstance(drift, (CapacityDrift, QueueDrift))
            and not has_availability(drift)):
        raise TypeError(
            f"{type(drift).__name__} is not a drift the port runs (it runs "
            "CapacityDrift, QueueDrift, the availability processes of "
            "core.availability and BatteryDrift)"
        )


def policy_problem_args(prob: AllocationProblem):
    """Static (1,)/(1, K) float64 problem arrays for a single-fleet call
    into a ``batched_policy``: ``(T, total, d_lo, d_hi, valid)``."""
    k = prob.num_learners
    return (
        np.asarray([prob.T], np.float64),
        np.asarray([prob.total_samples], np.int64),
        np.full((1, k), float(prob.d_lower), np.float64),
        np.full((1, k), float(prob.d_upper), np.float64),
        np.ones((1, k), bool),
    )


def policy_energy_args(prob: AllocationProblem):
    """Static (1, K) float64 energy rows ``(e2, e1, e0, e_budget)`` for a
    single-fleet call into an energy-aware policy: the problem's
    ``EnergyModel`` and budget, or zero coefficients and infinite budgets
    (under which ``kkt_energy`` decides as ``kkt_sai``) when it has none."""
    rows = prob.energy_rows()
    if rows is None:
        k = prob.num_learners
        z = np.zeros((1, k), np.float64)
        return z, z.copy(), z.copy(), np.full((1, k), np.inf)
    return tuple(np.asarray(r, np.float64)[None] for r in rows)


def require_standalone_rows(drift, *, remedy: str) -> None:
    """The guard of paths that need capacity rows fixed up front: a
    state-coupled drift (``QueueDrift``) or an availability process has
    none, since its rows depend on the run state (past allocations, who was
    online), so it is rejected with ``TypeError``; ``remedy`` says what to
    do instead."""
    if drift is None:
        return
    _check_drift(drift)
    avail = has_availability(drift)
    if not avail and not is_state_coupled(drift):
        return
    kind = "an availability process" if avail else "a state-coupled drift"
    raise TypeError(
        f"{type(drift).__name__} is {kind} and has no standalone coefficient "
        f"path (its rows depend on the run state); {remedy}"
    )


def coefficient_rows(prob: AllocationProblem, drift: CapacityDrift | None,
                     cycles: int):
    """(C, K) float64 capacity rows per global cycle: drifted under a
    ``CapacityDrift``, else the base coefficients tiled."""
    tm = prob.time_model
    require_standalone_rows(
        drift,
        remedy="roll rows and allocations out together via drift.rollout(...), "
        "solve_rows_state_coupled(...) or solve_rows_availability(...)",
    )
    if drift is None:
        tile = lambda a: np.broadcast_to(a, (cycles, tm.num_learners)).astype(np.float64)
        return tile(tm.c2), tile(tm.c1), tile(tm.c0)
    return drift.coefficient_path(tm, cycles)


def solve_policy_row(scheme: str, c2r, c1r, c0r, prob: AllocationProblem, *,
                     label: str, active=None, e_budget=None, device=None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """One fleet's (tau, d) on a single (K,) capacity row through
    ``batched_policy(scheme)`` in float64 on ``device`` (``None``: the
    card); the one row solve every reallocating path shares. Raises
    ``ValueError`` naming ``label`` when the row is infeasible.

    ``active`` (optional (K,) bool) masks offline learners out: their slots
    get the padded-slot semantics and the budget is clipped into the live
    fleet's box (``apply_active_mask``); an all-offline row gives zeros
    without a solve.

    ``e_budget`` (optional (K,) joules, energy-aware schemes only) tightens
    the problem's static per-learner budget to the smaller of the two, so a
    ``BatteryDrift`` charge caps what each dispatch may spend."""
    policy = batched_policy(scheme)
    T1, total1, lo1, hi1, valid1 = policy_problem_args(prob)
    k = prob.num_learners
    energy1 = None
    if scheme in ENERGY_SCHEMES:
        e2r, e1r, e0r, ebr = policy_energy_args(prob)
        if e_budget is not None:
            ebr = np.minimum(ebr, np.asarray(e_budget, np.float64).reshape(1, k))
        energy1 = (e2r, e1r, e0r, ebr)
    elif e_budget is not None:
        raise ValueError(
            f"e_budget needs an energy-aware scheme ({' | '.join(sorted(ENERGY_SCHEMES))}); "
            f"scheme {scheme!r} cannot honor it"
        )
    if active is not None:
        act = np.asarray(active, bool).reshape(1, k)
        if not act.any():
            z = np.zeros(k, np.int64)
            return z, z.copy()
    dev = resolve_device(device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    total_t = torch.as_tensor(total1, device=dev)
    lo_t, hi_t = f64(lo1), f64(hi1)
    valid_t = torch.as_tensor(valid1, device=dev)
    if active is not None:
        total_t, lo_t, hi_t, valid_t = apply_active_mask(
            total_t, lo_t, hi_t, valid_t, torch.as_tensor(act, device=dev))
    args = (f64(c2r[None]), f64(c1r[None]), f64(c0r[None]), f64(T1), total_t, lo_t,
            hi_t, valid_t)
    if energy1 is not None:
        args += (tuple(f64(e) for e in energy1),)
    tau, d, ok = policy(*args)
    if not bool(ok[0]):
        sub = (f"; {int(np.asarray(active, bool).sum())}/{k} learners online"
               if active is not None else "")
        raise ValueError(
            "infeasible: even with tau=0 the deadline T cannot absorb "
            f"d samples ({label}{sub})"
        )
    return tau[0].cpu().numpy().astype(np.int64), d[0].cpu().numpy().astype(np.int64)


def solve_rows_state_coupled(scheme: str, drift, prob: AllocationProblem,
                             cycles: int, *, label: str, lazy: bool = False,
                             device=None):
    """Rows and allocations of a state-coupled drift (``QueueDrift``)
    rolled out together: cycle by cycle, the row from the drift's state,
    its ``solve_policy_row`` solve, the state advanced. ``label`` is a
    format string given the cycle index for infeasibility errors.

    Returns ``((c2s, c1s, c0s), (taus, ds))``, or with ``lazy=True`` the
    per-cycle iterator (``QueueDrift.rollout_iter``), so a caller can train
    each cycle before the next one is solved."""

    def _solve(c, c2r, c1r, c0r):
        return solve_policy_row(scheme, c2r, c1r, c0r, prob, label=label.format(c),
                                device=device)

    if lazy:
        return drift.rollout_iter(prob.time_model, cycles, _solve)
    return drift.rollout(prob.time_model, cycles, _solve)


def solve_rows_availability(scheme: str, drift, prob: AllocationProblem, cycles: int,
                            *, label: str, device=None):
    """Rows, allocations and online masks of an availability process rolled
    out together: per cycle, the online mask from the availability state,
    the (base-drifted or backlog-coupled) capacity row, the masked solve
    (``solve_policy_row(active=...)``) and the joint state advanced with the
    solved allocation. Offline learners get tau = d = 0 and the budget
    shrinks to the live fleet's box; all-offline cycles solve to zeros.
    ``label`` is a format string given the cycle index.

    Returns ``((c2s, c1s, c0s), (taus, ds), masks)``, each (C, K) (masks
    bool). When the drift has ``budget_at`` (a ``BatteryDrift``) and the
    scheme is energy-aware, each solve is also capped by the current
    per-learner charge."""
    tm = prob.time_model
    k = tm.num_learners
    budgeted = scheme in ENERGY_SCHEMES and hasattr(drift, "budget_at")
    c2s, c1s, c0s = (np.empty((cycles, k)) for _ in range(3))
    taus = np.zeros((cycles, k), np.int64)
    ds = np.zeros((cycles, k), np.int64)
    masks = np.zeros((cycles, k), bool)
    state = drift.state_init(k)
    for c in range(cycles):
        mask = np.asarray(drift.online_at(c, k, state))
        clock, rate = drift.factors_at(c, k, state)
        c2r = tm.c2 / np.asarray(clock, np.float64)
        c1r = tm.c1 / np.asarray(rate, np.float64)
        c0r = tm.c0 / np.asarray(rate, np.float64)
        e_budget = drift.budget_at(c, k, state) if budgeted else None
        tau, d = solve_policy_row(scheme, c2r, c1r, c0r, prob, label=label.format(c),
                                  active=mask, e_budget=e_budget, device=device)
        state = drift.state_update(c, state, tau, d)
        masks[c] = mask
        c2s[c], c1s[c], c0s[c] = c2r, c1r, c0r
        taus[c], ds[c] = tau, d
    return (c2s, c1s, c0s), (taus, ds), masks


_DRIFT_IGNORED = (
    "a CapacityDrift is attached but reallocate=False: the run simulates the "
    "BASE capacities and the drift is ignored (static-under-drift staleness "
    "analysis lives in fed.simulation.drift_staleness_sweep)"
)


@dataclasses.dataclass(frozen=True)
class MELConfig:
    T: float = 15.0
    total_samples: int = 6000          # d dispatched per cycle
    d_lower_frac: float = 0.25         # d_l = frac * d/K
    d_upper_frac: float = 3.0          # d_u = frac * d/K
    lr: float = 0.1
    scheme: str = "kkt_sai"
    aggregation: str = "staleness"     # staleness | fedavg
    staleness_gamma: float = 1.0


def local_train_stacked(stacked, x, y, mask, tau, lr, *, max_tau: int, loss_fn):
    """Run tau_k local GD updates on each of K learners, each from its OWN
    params (leading K axis on every leaf), with gradients from autograd.

    x: (K, d_max, F); y, mask: (K, d_max); tau: (K,) int.
    Steps at ``i >= tau_k`` leave learner k untouched (the reference's
    per-learner ``lax.cond``). Returns stacked per-learner params.
    """
    grad = torch.func.vmap(torch.func.grad(
        lambda p, xk, yk, mk: loss_fn(p, {"x": xk, "y": yk, "mask": mk})
    ))
    p = stacked
    for i in range(max_tau):
        g = grad(p, x, y, mask)
        live = i < tau
        p = [
            {name: torch.where(live.reshape((-1,) + (1,) * (leaf.dim() - 1)),
                               leaf - lr * g[l][name], leaf)
             for name, leaf in layer.items()}
            for l, layer in enumerate(p)
        ]
    return p


def _broadcast(params, k: int):
    """Every leaf viewed with a leading K learner axis (no copy)."""
    return [{name: leaf.expand((k,) + leaf.shape) for name, leaf in layer.items()}
            for layer in params]


def local_train(global_params, x, y, mask, tau, lr, *, max_tau: int, loss_fn):
    """``local_train_stacked`` with every learner starting from the same
    global model (the paper's cycle-gated dispatch)."""
    return local_train_stacked(
        _broadcast(global_params, x.shape[0]), x, y, mask, tau, lr,
        max_tau=max_tau, loss_fn=loss_fn,
    )


def _stage_shards(shards: "list[Dataset]", d_max: int, feat: int):
    """Zero-pad per-learner shards into (K, d_max, ...) host arrays with a
    validity mask — shared by the eager per-cycle path and the fused
    pre-staging so their padding semantics cannot diverge."""
    k = len(shards)
    x = np.zeros((k, d_max, feat), np.float32)
    y = np.zeros((k, d_max), np.int32)
    m = np.zeros((k, d_max), np.float32)
    for i, sh in enumerate(shards):
        n = sh.size
        x[i, :n], y[i, :n], m[i, :n] = sh.x, sh.y, 1.0
    return x, y, m


class Orchestrator:
    """Runs the global cycles on the device that holds ``init_params``."""

    def __init__(
        self,
        mel: MELConfig,
        problem: AllocationProblem,
        loss_fn,
        init_params,
        *,
        seed: int = 0,
        drift=None,
    ):
        _check_drift(drift)
        if has_availability(drift):
            # every learner takes part in every barrier round by construction
            raise TypeError(
                f"{type(drift).__name__} models client availability; the "
                "cycle-gated Orchestrator has no offline semantics — run churn "
                "scenarios through fed.async_engine.AsyncFedEngine"
            )
        self.drift = drift
        self.mel = mel
        self.problem = problem
        self.loss_fn = loss_fn
        self.params = init_params
        self.device = init_params[0]["w"].device
        self.rng = np.random.default_rng(seed)
        self.allocation = _solver(mel.scheme, self.device)(problem)

    def _weights(self, tau, d) -> torch.Tensor:
        if self.mel.aggregation == "staleness":
            w = staleness_weights(tau, d, gamma=self.mel.staleness_gamma)
        else:
            w = fedavg_weights(d)
        return torch.as_tensor(w, dtype=torch.float32, device=self.device)

    def _warn_drift_ignored(self) -> None:
        if self.drift is not None:
            # a state-coupled drift cannot even be simulated statically
            require_standalone_rows(
                self.drift,
                remedy="run with reallocate=True so rows and allocations roll out together",
            )
            warnings.warn(_DRIFT_IGNORED, stacklevel=3)

    def _reallocations(self, cycles: int):
        """Per-cycle allocations re-solved on each cycle's capacities,
        lazily, so an infeasible cycle raises only when it is reached."""
        scheme = self.mel.scheme
        label = "drifted capacities at cycle {}"
        method = f"{scheme}_drift"
        if is_state_coupled(self.drift):
            for *_, tau, d in solve_rows_state_coupled(
                    scheme, self.drift, self.problem, cycles, label=label, lazy=True,
                    device=self.device):
                yield Allocation(tau=tau, d=d, method=method)
            return
        c2s, c1s, c0s = coefficient_rows(self.problem, self.drift, cycles)
        for c in range(cycles):
            tau, d = solve_policy_row(scheme, c2s[c], c1s[c], c0s[c], self.problem,
                                      label=label.format(c), device=self.device)
            yield Allocation(tau=tau, d=d, method=method)

    def _record(self, tau, d) -> dict:
        return {
            "max_staleness": max_staleness(tau),
            "avg_staleness": avg_staleness(tau),
            "tau": tau.copy(),
            "d": d.copy(),
            "wall_clock_s": self.mel.T,
        }

    # -- one global cycle ---------------------------------------------------
    def run_cycle(self, shards: list[Dataset]) -> dict:
        alloc = self.allocation
        tau = np.asarray(alloc.tau)
        d = np.asarray(alloc.d)
        x, y, m = _stage_shards(shards, int(d.max()), shards[0].x.shape[1])
        dev = self.device
        locals_ = local_train(
            self.params, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
            torch.from_numpy(m).to(dev), torch.as_tensor(tau, device=dev),
            self.mel.lr, max_tau=max(int(tau.max()), 1), loss_fn=self.loss_fn,
        )
        self.params = aggregate(locals_, self._weights(tau, d))
        return self._record(tau, d)

    # -- full run -------------------------------------------------------------
    def run(
        self,
        train: Dataset,
        cycles: int,
        *,
        eval_fn=None,
        reallocate: bool = False,
        fused: bool = False,
        eval_batch=None,
    ) -> list[dict]:
        """Eager run (``fused=True`` routes to ``run_fused``). ``eval_fn``
        maps the params to a scalar, read after every cycle.

        ``reallocate=True`` re-solves every cycle: through the batched
        policy on that cycle's (drifted) capacities for the schemes that
        have one (``POLICIES``), else (``slsqp``, ``sync``) by the scheme's
        own solver on the static problem."""
        if fused:
            return self.run_fused(train, cycles, eval_fn=eval_fn,
                                  eval_batch=eval_batch, reallocate=reallocate)
        if not reallocate:
            self._warn_drift_ignored()
        part = FederatedPartitioner(train, seed=int(self.rng.integers(2**31)))
        if (reallocate and is_state_coupled(self.drift)
                and self.mel.scheme not in POLICIES):
            raise ValueError(
                f"state-coupled drift needs a batched policy scheme "
                f"({' | '.join(POLICIES)}); scheme {self.mel.scheme!r} has none"
            )
        allocs = (self._reallocations(cycles)
                  if reallocate and self.mel.scheme in POLICIES else None)
        history = []
        for c in range(cycles):
            if allocs is not None:
                self.allocation = next(allocs)
            elif reallocate and c:
                self.allocation = _solver(self.mel.scheme, self.device)(self.problem)
            rec = self.run_cycle(part.draw(self.allocation.d))
            rec["cycle"] = c
            rec["elapsed_s"] = (c + 1) * self.mel.T
            if eval_fn is not None:
                rec["accuracy"] = float(eval_fn(self.params))
            history.append(rec)
        return history

    # -- fused path -----------------------------------------------------------
    def run_fused(
        self,
        train: Dataset,
        cycles: int,
        *,
        eval_fn=None,
        eval_batch=None,
        reallocate: bool = False,
    ) -> list[dict]:
        """Twin of ``run`` through ``ops.train_agg_step``: the same shard
        draws and allocation, every cycle's flat draw staged on the device
        up front and split by that cycle's d there, one train+aggregate
        call a cycle.

        eval_fn : optional ``(params, x, y) -> scalar`` (e.g.
            ``mlp.accuracy``), evaluated each cycle on ``eval_batch``.
        eval_batch : ``(x, y)`` arrays or tensors; required with ``eval_fn``.

        reallocate : re-solve every cycle on that cycle's capacities
            (``solve_policy_row``) before its train+aggregate call; see the
            module docstring for the infeasibility contract.

        Returns one history dict per cycle, the rows ``run`` produces.
        """
        if self.loss_fn is not mlp.loss:
            raise ValueError("the fused path trains mlp.loss only; use run() "
                             "for another loss function")
        if eval_fn is not None and eval_batch is None:
            raise ValueError("run_fused needs eval_batch=(x, y) with eval_fn")
        if reallocate:
            batched_policy(self.mel.scheme)   # raises for a scheme without one
            allocs = self._reallocations(cycles)
            # d_k <= d_upper bounds the width of a learner's shard
            d_cap = int(self.problem.d_upper)
        else:
            self._warn_drift_ignored()
            allocs = itertools.repeat(self.allocation)
            d_cap = int(np.max(self.allocation.d))
        # every ported scheme's d sums to the per-cycle total
        total = self.problem.total_samples
        k = self.problem.num_learners
        dev = self.device

        # the eager path's rng consumption: one flat draw of the per-cycle
        # total a cycle, split by that cycle's d below
        part = FederatedPartitioner(train, seed=int(self.rng.integers(2**31)))
        idx = np.stack([part.draw_indices(total) for _ in range(cycles)])
        xs = torch.from_numpy(train.x[idx]).to(dev)     # (C, total, F)
        ys = torch.from_numpy(train.y[idx]).to(dev)     # (C, total)
        if eval_fn is not None:
            ex, ey = (torch.as_tensor(a, device=dev) for a in eval_batch)
        j = torch.arange(d_cap, device=dev)

        history = []
        for c in range(cycles):
            alloc = next(allocs)
            tau, d = np.asarray(alloc.tau), np.asarray(alloc.d)
            d_t = torch.as_tensor(d, device=dev)
            # the eager path's contiguous slicing of the draw, as a gather;
            # masked rows add exactly 0 to every gradient
            gidx = torch.clamp((torch.cumsum(d_t, 0) - d_t)[:, None] + j[None, :], 0, total - 1)
            m = (j[None, :] < d_t[:, None]).to(torch.float32)
            self.params, _ = ops.train_agg_step(
                _broadcast(self.params, k), xs[c][gidx], ys[c][gidx], m,
                torch.as_tensor(tau, dtype=torch.int32, device=dev),
                self._weights(tau, d), self.mel.lr, max_tau=max(int(tau.max()), 1),
            )
            self.allocation = alloc
            rec = self._record(tau, d)
            rec["cycle"] = c
            rec["elapsed_s"] = (c + 1) * self.mel.T
            if eval_fn is not None:
                rec["accuracy"] = float(eval_fn(self.params, ex, ey))
            history.append(rec)
        return history
