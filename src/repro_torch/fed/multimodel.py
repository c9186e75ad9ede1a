"""Multi-tenant asynchronous federation: S models time-sharing one fleet,
in torch; the port of ``repro/fed/multimodel.py``.

FedAST (arXiv 2406.00302) trains several federated models at once on one
shared client population, steering more client time toward the model that
is furthest behind. A :class:`MultiModelEngine` runs S independent models
(each with its own parameters, dataset shards, staleness discount and
FedAsync/FedBuff server) on ONE shared pool of K learners; every
(re)dispatch first runs the cross-model allocation layer, then the paper's
per-model (tau, d) solve:

  1. the progress deficits are read off the per-model server versions
     (``deficit_s = max_v - v_s``): round counts, never losses or
     parameters, so the event schedule stays bit-reproducible;
  2. ``core.solver_batched.cross_model_weights`` turns them into shares
     ``w_s`` on a 2^-20 grid (sum <= 1), splitting each learner's deadline
     ``T`` (and its joule budget under an energy-aware scheme) across the
     models;
  3. ``multimodel_policy`` solves the (S, K) problem with one
     ``batched_policy`` call on the engine's device: on the card every
     bisection step launches the water-filling kernel
     (``waterfill_residual``, or ``waterfill_energy_residual`` under
     ``kkt_energy``). Cells whose share cannot cover ``c0 + c1 * d_lo``
     degrade to padded slots instead of going infeasible.

The S event chains share one virtual clock, one fault process and one
availability process: one heap carries every model's arrivals, deadlines
and quorum timers, one fault rng decides drops, delays and stragglers in
dispatch order, and an offline learner defers all of its models'
dispatches. Each model keeps its own version counter, buffer and discount.

Anchors: at S = 1 the split is static (``w = 1.0``, no mask, no scaling),
every solve is the single-model engine's ``solve_policy_row`` call and the
rng draws are ``AsyncFedEngine``'s, so the records are ``AsyncFedEngine``'s;
the barrier regime (M = K) at S = 1 is ``Orchestrator.run``'s.

Execution reuses the single-model executors: after ONE host schedule build,
each model replays its own schedule through ``async_engine
._replay_eager_schedule`` (``run``: plain torch) or ``async_engine
._run_group_program`` (``run_events``: one ``ops.train_agg_step`` call a
group, which on the card launches the training and ``accum_flush``
kernels), with its own parameters, which may differ in architecture.
The engine runs on the device that holds model 0's parameters.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (
    AllocationProblem,
    CapacityDrift,
    aggregate,
    apply_active_mask,
    availability_masks,
    capacity_state_coupled,
    fedavg_weights,
    has_availability,
    is_state_coupled,
    staleness_weights,
)
from repro_torch.core.solver_batched import SPLIT_POLICIES, multimodel_policy
from repro_torch.core.staleness import avg_staleness, max_staleness, staleness_factor
from repro_torch.data.pipeline import FederatedPartitioner
from repro_torch.fed.async_engine import (
    _EV_ARRIVE,
    _EV_DEADLINE,
    _EV_QUORUM,
    _Arrival,
    _device_of,
    _event_segments,
    _replay_eager_schedule,
    _run_group_program,
    _Schedule,
    _zero_fault_counters,
)
from repro_torch.fed.orchestrator import (
    ENERGY_SCHEMES,
    _check_drift,
    _solver,
    _stage_shards,
    coefficient_rows,
    local_train,
    policy_energy_args,
    policy_problem_args,
    solve_policy_row,
    solve_rows_state_coupled,
)

__all__ = ["MultiModelEngine", "solve_multimodel_rows"]

# a zero-share model's dispatch is deferred to the next block by a typed
# heap event (not by recursion: its deficit is re-read at the boundary,
# after the other models' aggregations in between)
_EV_REDISPATCH = 3

# scheduler-level AsyncConfig fields that must agree across the S models:
# one virtual clock, one allocation scheme, one fault/availability process
_SHARED_CFG_FIELDS = (
    "scheme", "reallocate", "barrier", "drop_rate", "delay_rate",
    "delay_mean", "straggler_rate", "straggler_factor", "deadline",
    "retry_backoff", "retry_backoff_cap", "quorum", "flush_timeout",
)


def solve_multimodel_rows(scheme: str, c2r, c1r, c0r, problems, deficits, *,
                          split: str = "deficit", share_floor: float = 0.0, label: str,
                          active=None, e_budget=None, device=None):
    """(tau, d, w) for S models sharing one (K,) capacity row, the
    multi-model twin of ``orchestrator.solve_policy_row``, in float64 on
    ``device`` (``None``: the card).

    The S problems are stacked into an (S, K) batch with the same row
    builders as ``solve_policy_row`` (``policy_problem_args``,
    ``policy_energy_args``) and solved by one ``multimodel_policy`` call.

    ``active`` (optional (K,) bool) masks offline learners out of every
    model's row (one physical fleet: a churned learner serves nobody); an
    all-offline row gives zeros and equal weights without a solve.
    ``e_budget`` (optional (K,) joules, energy-aware schemes only) tightens
    each model's static budget. Returns ``(tau, d, w)``: tau and d (S, K)
    int64, ``w`` the (S,) float64 split weights applied. Raises
    ``ValueError`` naming ``label`` and the model when a row is infeasible."""
    problems = list(problems)
    s = len(problems)
    k = problems[0].num_learners
    stacked = [policy_problem_args(p) for p in problems]
    T1, total1, lo1, hi1, valid1 = (np.concatenate([a[i] for a in stacked])
                                    for i in range(5))
    energy1 = None
    if scheme in ENERGY_SCHEMES:
        rows = [policy_energy_args(p) for p in problems]
        e2r, e1r, e0r, ebr = (np.concatenate([r[i] for r in rows]) for i in range(4))
        if e_budget is not None:
            ebr = np.minimum(ebr, np.asarray(e_budget, np.float64).reshape(1, k))
        energy1 = (e2r, e1r, e0r, ebr)
    elif e_budget is not None:
        raise ValueError(
            f"e_budget needs an energy-aware scheme ({' | '.join(sorted(ENERGY_SCHEMES))}); "
            f"scheme {scheme!r} cannot honor it"
        )
    if active is not None:
        act = np.broadcast_to(np.asarray(active, bool).reshape(1, k), (s, k)).copy()
        if not act.any():
            z = np.zeros((s, k), np.int64)
            return z, z.copy(), np.full(s, 1.0 / s)
    policy = multimodel_policy(scheme, split=split, share_floor=float(share_floor))
    dev = resolve_device(device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    row = lambda r: f64(np.tile(np.asarray(r, np.float64), (s, 1)))
    total_t = torch.as_tensor(total1, device=dev)
    lo_t, hi_t = f64(lo1), f64(hi1)
    valid_t = torch.as_tensor(valid1, device=dev)
    if active is not None:
        total_t, lo_t, hi_t, valid_t = apply_active_mask(
            total_t, lo_t, hi_t, valid_t, torch.as_tensor(act, device=dev))
    args = (row(c2r), row(c1r), row(c0r), f64(T1), total_t, lo_t, hi_t, valid_t)
    if energy1 is not None:
        args += (tuple(f64(e) for e in energy1),)
    tau, d, ok, w = policy(f64(deficits), *args)
    ok = ok.cpu().numpy().astype(bool)
    if not ok.all():
        raise ValueError(
            "infeasible: even with tau=0 the deadline T cannot absorb "
            f"d samples (model {int(np.argmin(ok))} at {label})"
        )
    return (tau.cpu().numpy().astype(np.int64), d.cpu().numpy().astype(np.int64),
            w.cpu().numpy().astype(np.float64))


def _broadcast(value, s: int, name: str) -> list:
    """Per-model sequence from a shared value or an S-sequence."""
    if isinstance(value, (list, tuple)):
        if len(value) != s:
            raise ValueError(f"{name} needs 1 or {s} entries, got {len(value)}")
        return list(value)
    return [value] * s


class MultiModelEngine:
    """S models time-sharing one K-learner fleet under deficit-driven
    cross-model allocation (see the module docstring), on the device that
    holds model 0's parameters.

    Parameters
    ----------
    cfgs : one ``AsyncConfig`` (shared) or a sequence of S. Per-model server
        knobs (mode, alpha, staleness discount, aggregation, buffer size,
        lr) may differ; scheduler-level knobs (scheme, reallocate, barrier,
        every fault knob) must agree: there is one clock and one fault
        process.
    problems : sequence of S ``AllocationProblem`` sharing one ``TimeModel``
        and one deadline ``T``; totals, d-boxes and energy budgets are per
        model.
    loss_fns : one callable (shared) or a sequence of S.
    init_params : ONE parameter list shared by every model, or a *tuple* of
        S per-model lists (the tuple marks the container), all on one device.
    split : cross-model split policy (``SPLIT_POLICIES``): ``"deficit"`` or
        ``"equal"``.
    share_floor : minimum share per model under the split.
    seed, drift : as in ``AsyncFedEngine``; ONE drift or availability
        process gates all S models.
    """

    def __init__(
        self,
        cfgs,
        problems,
        loss_fns,
        init_params,
        *,
        seed: int = 0,
        drift: CapacityDrift | None = None,
        split: str = "deficit",
        share_floor: float = 0.0,
    ):
        _check_drift(drift)
        if isinstance(problems, AllocationProblem):
            problems = [problems]
        self.problems = list(problems)
        s = len(self.problems)
        if s < 1:
            raise ValueError("need at least one model")
        self.num_models = s
        self.cfgs = _broadcast(cfgs, s, "cfgs")
        self.loss_fns = _broadcast(loss_fns, s, "loss_fns")
        # a parameter list is itself a list, so the per-model container is
        # marked by TYPE: a tuple holds S per-model lists; any other value
        # is ONE parameter list shared by every model
        if isinstance(init_params, tuple):
            if len(init_params) != s:
                raise ValueError(
                    f"init_params tuple needs {s} per-model pytrees, got "
                    f"{len(init_params)}; pass a non-tuple to share one"
                )
            self.params = list(init_params)
        else:
            self.params = [init_params] * s
        self.device = _device_of(self.params[0])
        for i, p in enumerate(self.params[1:], start=1):
            if _device_of(p) != self.device:
                raise ValueError(
                    f"model {i}'s parameters are on {_device_of(p)}, model 0's on "
                    f"{self.device}: the engine runs every model on one device"
                )
        if split not in SPLIT_POLICIES:
            raise ValueError(f"unknown split {split!r}: {' | '.join(SPLIT_POLICIES)}")
        self.split = split
        self.share_floor = float(share_floor)
        cfg0 = self.cfgs[0]
        for field in _SHARED_CFG_FIELDS:
            vals = {getattr(c, field) for c in self.cfgs}
            if len(vals) > 1:
                raise ValueError(
                    f"AsyncConfig.{field} is scheduler-level (one clock, "
                    f"one fault process): all models must agree, got {vals}"
                )
        self.cfg = cfg0                       # the shared scheduler view
        p0 = self.problems[0]
        k = p0.num_learners
        tm0 = p0.time_model
        for i, p in enumerate(self.problems[1:], start=1):
            if p.num_learners != k or p.T != p0.T:
                raise ValueError(
                    "all models share one physical fleet and one budget: "
                    f"model {i} has (K={p.num_learners}, T={p.T}), model 0 "
                    f"(K={k}, T={p0.T})"
                )
            tm = p.time_model
            if not all(np.array_equal(getattr(tm, f), getattr(tm0, f))
                       for f in ("c2", "c1", "c0")):
                raise ValueError(
                    f"model {i}'s TimeModel differs from model 0's — the "
                    "capacities describe the shared fleet hardware"
                )
        self.rng = np.random.default_rng(seed)
        self.drift = drift
        self.buffer_sizes = []
        for i, c in enumerate(self.cfgs):
            m = c.buffer_size or k
            if not (1 <= m <= k):
                raise ValueError(f"model {i}: buffer_size must be in [1, K={k}]")
            if c.barrier and m != k:
                raise ValueError(
                    "the cycle barrier gates on the whole fleet: it requires "
                    f"buffer_size == K (= {k}); M < K is the event-driven "
                    "buffered regime"
                )
            if c.quorum > m:
                raise ValueError(
                    f"model {i}: quorum (= {c.quorum}) must be <= "
                    f"buffer_size (= {m}): a full buffer flushes on its own"
                )
            self.buffer_sizes.append(m)
        if has_availability(drift):
            if cfg0.barrier:
                raise ValueError(
                    "availability churn has no barrier regime (one offline "
                    "learner would gate every round forever); use the "
                    "event-driven modes"
                )
            coupled = capacity_state_coupled(drift)
        else:
            coupled = is_state_coupled(drift)
        if coupled and not cfg0.reallocate:
            raise ValueError(
                "state-coupled drift ties capacities to the dispatched "
                "allocations; the engine supports it only with "
                "reallocate=True (per-block re-solves drive the state)"
            )
        if coupled and s > 1:
            raise ValueError(
                "state-coupled drift has no multi-model rollout: its "
                "capacity rows depend on the dispatched allocations, which "
                "here depend on deficits known only at dispatch time; run "
                "S = 1 or use an exogenous/availability drift"
            )
        # up-front feasibility of every unsplit problem (and the allocations
        # the S = 1 barrier path replays, as Orchestrator.run's)
        solver = _solver(cfg0.scheme, self.device)
        self.allocations = [solver(p) for p in self.problems]
        # (block, deficits) -> ((S, K) tau, (S, K) d): keyed on the deficit
        # vector too, since the split changes with the models' progress
        self._alloc_cache: dict = {}
        self._block_masks: np.ndarray | None = None
        self._avail_ebud: list | None = None
        self.fault_counters: dict = _zero_fault_counters()
        self.energy_ledger: dict = {"per_learner": np.zeros(k), "violations": 0}
        self.energy_ledgers: list[dict] = [
            {"per_learner": np.zeros(k), "violations": 0} for _ in range(s)
        ]
        self.split_weight_log: list[np.ndarray] = []

    # -- allocation ----------------------------------------------------------
    def _deficit_key(self, versions) -> tuple:
        """The dispatch-time deficit vector: how many aggregations each
        model trails the front-runner by (server versions only)."""
        v = np.asarray(versions, np.float64)
        return tuple((v.max() - v).tolist())

    def _solve_row_multi(self, c2r, c1r, c0r, deficits, *, label, active=None,
                         e_budget=None):
        """(S, K) allocation on one capacity row. S = 1 is the single-model
        engine's ``solve_policy_row`` call; S > 1 the one-call multi-model
        solve. Both on the engine's device."""
        if self.num_models == 1:
            tau, d = solve_policy_row(
                self.cfg.scheme, c2r, c1r, c0r, self.problems[0], label=label,
                active=active, e_budget=e_budget, device=self.device,
            )
            return tau[None], d[None], np.ones(1)
        return solve_multimodel_rows(
            self.cfg.scheme, c2r, c1r, c0r, self.problems, deficits,
            split=self.split, share_floor=self.share_floor, label=label,
            active=active, e_budget=e_budget, device=self.device,
        )

    def _rollout_availability(self, nblocks: int):
        """Rows, online masks and per-block uniform-deficit allocations of
        an availability process rolled out together, the multi-model twin
        of ``orchestrator.solve_rows_availability`` (at S = 1 it is that
        loop). The state advances with the fleet's aggregate work: per
        learner the largest tau and the summed d across models. Dispatches
        with nonzero deficits re-solve against the stored masks and
        budgets."""
        drift = self.drift
        tm = self.problems[0].time_model
        k = tm.num_learners
        budgeted = self.cfg.scheme in ENERGY_SCHEMES and hasattr(drift, "budget_at")
        c2s, c1s, c0s = (np.empty((nblocks, k)) for _ in range(3))
        masks = np.zeros((nblocks, k), bool)
        self._avail_ebud = [None] * nblocks
        uniform = (0.0,) * self.num_models
        state = drift.state_init(k)
        for c in range(nblocks):
            mask = np.asarray(drift.online_at(c, k, state))
            clock, rate = drift.factors_at(c, k, state)
            c2r = tm.c2 / np.asarray(clock, np.float64)
            c1r = tm.c1 / np.asarray(rate, np.float64)
            c0r = tm.c0 / np.asarray(rate, np.float64)
            e_b = drift.budget_at(c, k, state) if budgeted else None
            tau, d, _ = self._solve_row_multi(
                c2r, c1r, c0r, uniform, label=f"capacities at drift block {c}",
                active=mask, e_budget=e_b,
            )
            state = drift.state_update(c, state, tau.max(axis=0), d.sum(axis=0))
            masks[c] = mask
            c2s[c], c1s[c], c0s[c] = c2r, c1r, c0r
            self._avail_ebud[c] = e_b
            self._alloc_cache[(c, uniform)] = (tau, d)
        return (c2s, c1s, c0s), masks

    def _block_rows(self, nblocks: int):
        """(C, K) capacity rows per drift block, in the single-model
        engine's regimes (frozen or adaptive; exogenous, availability or
        state-coupled)."""
        drift = self.drift
        self._block_masks = None
        self._avail_ebud = None
        uniform = (0.0,) * self.num_models
        if has_availability(drift):
            if self.cfg.reallocate:
                rows, masks = self._rollout_availability(nblocks)
                self._block_masks = masks
                return rows
            tau0, d0, _ = self._alloc_static(uniform)
            self._block_masks = availability_masks(
                drift, self.problems[0].num_learners, nblocks,
                tau=tau0.max(axis=0), d=d0.sum(axis=0),
            )
            return coefficient_rows(self.problems[0], drift.base, nblocks)
        if is_state_coupled(drift):
            # S = 1 only (refused in __init__ otherwise): the single-model
            # engine's joint rollout prefills the cache
            rows, (taus, ds) = solve_rows_state_coupled(
                self.cfg.scheme, drift, self.problems[0], nblocks,
                label="capacities at drift block {}", device=self.device,
            )
            for b in range(nblocks):
                self._alloc_cache[(b, uniform)] = (taus[b][None], ds[b][None])
            return rows
        return coefficient_rows(self.problems[0], drift, nblocks)

    def _alloc_static(self, deficits: tuple):
        """Static (base-capacity) allocation for one deficit vector."""
        key = ("static", deficits)
        hit = self._alloc_cache.get(key)
        if hit is None:
            tm = self.problems[0].time_model
            tau, d, w = self._solve_row_multi(
                tm.c2.astype(np.float64), tm.c1.astype(np.float64),
                tm.c0.astype(np.float64), deficits, label="base capacities",
            )
            hit = (tau, d)
            self._alloc_cache[key] = hit
            self.split_weight_log.append(np.asarray(w))
        return hit[0], hit[1], None

    def _alloc_for_block(self, block: int, deficits: tuple, rows, realloc):
        """(S, K) allocation for one (drift block, deficit vector) pair,
        cached; at S = 1 the key is one entry a block, the single-model
        engine's granularity."""
        if not realloc:
            tau, d, _ = self._alloc_static(deficits)
            return tau, d
        key = (block, deficits)
        hit = self._alloc_cache.get(key)
        if hit is None:
            c2s, c1s, c0s = rows
            mask = self._block_masks[block] if self._block_masks is not None else None
            e_b = self._avail_ebud[block] if self._avail_ebud is not None else None
            tau, d, w = self._solve_row_multi(
                c2s[block], c1s[block], c0s[block], deficits,
                label=f"capacities at drift block {block}", active=mask, e_budget=e_b,
            )
            hit = (tau, d)
            self._alloc_cache[key] = hit
            self.split_weight_log.append(np.asarray(w))
        return hit

    # -- schedule ------------------------------------------------------------
    def _build_schedules(self, parts, horizon: float, max_events: int):
        """ONE host simulation of the S interleaved event systems: a shared
        heap, a shared fault rng, shared availability masks, and per-model
        versions, buffers and flushes. Returns one ``_Schedule`` per model
        (each replays at its own d_cap and max_tau) and the shared fault
        counters.

        Every decision mirrors ``AsyncFedEngine._build_schedule``; at S = 1
        the loop is that loop: the same event order, the same rng draws
        (the caller drew the partitioner seeds; the fault seed is drawn
        here, only under ``cfg.has_faults``), the same allocation calls."""
        cfg, probs = self.cfg, self.problems
        s = self.num_models
        p0 = probs[0]
        k_fleet, T = p0.num_learners, p0.T
        nblocks = max(int(np.ceil(horizon / T)) + 1, 1)
        rows = self._block_rows(nblocks)
        masks = self._block_masks
        realloc = cfg.reallocate and self.drift is not None
        frng = (np.random.default_rng(int(self.rng.integers(2**31)))
                if cfg.has_faults else None)
        counters = _zero_fault_counters()
        e_rows = [p.energy_rows() for p in probs]
        energy_spent = np.zeros((s, k_fleet))
        energy_violations = np.zeros(s, np.int64)
        heap: list = []
        seq = 0
        versions = np.zeros(s, np.int64)
        arrivals: list[list[_Arrival]] = [[] for _ in range(s)]
        groups: list[list[_Arrival]] = [[] for _ in range(s)]
        flush_ids = np.zeros(s, np.int64)
        next_did = 0
        dstate: dict[int, str] = {}
        open_gids = np.full(s, -1, np.int64)
        gid_counter = 0
        n_arrivals = 0

        def push(t: float, kind: int, payload) -> None:
            nonlocal seq
            heapq.heappush(heap, (t, kind, seq, payload))
            seq += 1

        def dispatch(si: int, k: int, t: float, attempt: int = 0) -> None:
            nonlocal next_did
            block = min(int(t // T), nblocks - 1)
            if masks is not None:
                b = block
                while b < nblocks and not masks[b][k]:
                    b += 1
                if b >= nblocks or b * T > horizon:
                    counters["offline_churned"] += 1
                    return
                if b != block:
                    counters["offline_deferrals"] += 1
                    block, t = b, b * T
            deficits = self._deficit_key(versions)
            tau_a, d_a = self._alloc_for_block(block, deficits, rows, realloc)
            tau_k, d_k = int(tau_a[si][k]), int(d_a[si][k])
            if masks is not None and d_k == 0:
                # the masked solve gave this online learner nothing (the
                # budget fit in the rest of the fleet): try the next block
                if (block + 1) * T <= horizon and block + 1 < nblocks:
                    dispatch(si, k, (block + 1) * T, attempt)
                else:
                    counters["offline_churned"] += 1
                return
            if d_k == 0:
                # S > 1: this model's share on learner k rounded to nothing:
                # park the chain at the next block boundary, where the
                # deficit is read again after the aggregations in between
                if (block + 1) * T <= horizon and block + 1 < nblocks:
                    push((block + 1) * T, _EV_REDISPATCH, (si, k, attempt))
                else:
                    counters["offline_churned"] += 1
                return
            idx = parts[si].draw_indices(d_k)
            c2, c1, c0 = (r[block, k] for r in rows)
            cost = float(c2 * tau_k * d_k + c1 * d_k + c0)
            counters["dispatches"] += 1
            energy_j = 0.0
            if e_rows[si] is not None:
                e2k, e1k, e0k, ebk = (row[k] for row in e_rows[si])
                energy_j = float(e2k * tau_k * d_k + e1k * d_k + e0k)
                energy_spent[si][k] += energy_j
                if energy_j > ebk * (1 + 1e-9):
                    energy_violations[si] += 1
            dropped = False
            if frng is not None:
                # fixed per-dispatch draw order: straggle -> delay -> drop
                if cfg.straggler_rate > 0 and frng.random() < cfg.straggler_rate:
                    counters["stragglers"] += 1
                    cost *= cfg.straggler_factor
                if cfg.delay_rate > 0 and frng.random() < cfg.delay_rate:
                    counters["delays"] += 1
                    cost += float(frng.exponential(cfg.delay_mean))
                dropped = cfg.drop_rate > 0 and frng.random() < cfg.drop_rate
            did = next_did
            next_did += 1
            dstate[did] = "pending"
            if dropped:
                counters["drops"] += 1
            else:
                push(t + cost, _EV_ARRIVE,
                     (si, did, k, t, int(versions[si]), tau_k, d_k, idx, attempt, energy_j))
            if cfg.deadline > 0:
                push(t + cfg.deadline, _EV_DEADLINE, (si, did, k, attempt))

        def close_group(si: int, t_flush: float, timer: bool) -> None:
            """Flush model si's open buffered group (at M_si arrivals, or on
            a quorum timer), with that model's staleness knobs."""
            nonlocal gid_counter
            c = self.cfgs[si]
            group = groups[si]
            taus = np.array([g.tau for g in group], float)
            ds = np.array([g.d for g in group], float)
            phi = staleness_factor(
                np.array([g.staleness for g in group], float),
                kind=c.staleness_fn, a=c.staleness_a, b=c.staleness_b,
            )
            base = (fedavg_weights(ds) if c.aggregation == "fedavg" else
                    staleness_weights(taus, ds, gamma=c.staleness_gamma))
            w = base * phi
            w = w / w.sum()
            for g, wg in zip(group, w):
                g.weight = float(wg)
                g.flush_id = int(flush_ids[si])
            closer = group[-1]
            closer.flush = True
            closer.timer_flush = timer
            closer.flush_t = t_flush
            closer.keep = 0.0
            closer.group_weights = np.asarray(w, np.float64)
            versions[si] += 1
            closer.version_after = int(versions[si])
            flush_ids[si] += 1
            groups[si] = []
            open_gids[si] = -1

        for k in range(k_fleet):
            for si in range(s):
                dispatch(si, k, 0.0)

        while heap and n_arrivals < max_events:
            t_e, kind, _, payload = heapq.heappop(heap)
            if t_e > horizon:
                break
            if kind == _EV_REDISPATCH:
                si, k, attempt = payload
                dispatch(si, k, t_e, attempt)
                continue
            if kind == _EV_DEADLINE:
                si, did, k, attempt = payload
                if dstate.get(did) != "pending":
                    continue
                dstate[did] = "cancelled"
                counters["deadline_misses"] += 1
                counters["retries"] += 1
                backoff = min(cfg.retry_backoff * (2.0 ** attempt), cfg.retry_backoff_cap)
                dispatch(si, k, t_e + backoff, attempt + 1)
                continue
            if kind == _EV_QUORUM:
                si, gid, extended = payload
                if gid != open_gids[si] or not groups[si]:
                    continue
                if len(groups[si]) >= cfg.quorum:
                    counters["quorum_flushes"] += 1
                    close_group(si, t_e, timer=True)
                elif not extended:
                    counters["quorum_extensions"] += 1
                    push(t_e + cfg.flush_timeout, _EV_QUORUM, (si, gid, True))
                else:
                    counters["quorum_degradations"] += 1
                    close_group(si, t_e, timer=True)
                continue
            si, did, k, t_disp, v_disp, tau_k, d_k, idx, attempt, e_j = payload
            if dstate.get(did) == "cancelled":
                counters["late_discards"] += 1
                continue
            dstate[did] = "arrived"
            c = self.cfgs[si]
            a = _Arrival(
                seq=len(arrivals[si]), learner=k, t=t_e, tau=tau_k, d=d_k,
                idx=idx, dispatch_t=t_disp, dispatch_version=v_disp,
                staleness=int(versions[si]) - v_disp, energy=e_j,
            )
            groups[si].append(a)
            arrivals[si].append(a)
            n_arrivals += 1
            if c.mode == "fedasync":
                phi = staleness_factor(
                    np.array([a.staleness], float),
                    kind=c.staleness_fn, a=c.staleness_a, b=c.staleness_b,
                )
                w = np.array([c.alpha]) * phi
                a.weight = float(w[0])
                a.flush_id = int(flush_ids[si])
                a.flush = True
                a.flush_t = t_e
                a.keep = 1.0 - float(w[0])
                a.group_weights = np.asarray(w, np.float64)
                versions[si] += 1
                a.version_after = int(versions[si])
                flush_ids[si] += 1
                groups[si] = []
            elif len(groups[si]) == self.buffer_sizes[si]:
                close_group(si, t_e, timer=False)
            else:
                if cfg.quorum > 0 and len(groups[si]) == 1:
                    gid_counter += 1
                    open_gids[si] = gid_counter
                    push(t_e + cfg.flush_timeout, _EV_QUORUM, (si, gid_counter, False))
                a.version_after = int(versions[si])
            dispatch(si, k, t_e)   # immediate redispatch, current server

        self.server_versions = versions.copy()
        scheds = [
            _Schedule(
                arrivals=arrivals[si], n_flushes=int(flush_ids[si]),
                d_cap=max([a.d for a in arrivals[si]], default=1),
                max_tau=max([a.tau for a in arrivals[si]] + [1]),
                counters=counters,
                energy_spent=energy_spent[si],
                energy_violations=int(energy_violations[si]),
            )
            for si in range(s)
        ]
        return scheds, counters

    # -- run prep ------------------------------------------------------------
    def _prep_run(self, trains, eval_fns, eval_batches):
        s = self.num_models
        trains = _broadcast(trains, s, "trains")
        eval_fns = _broadcast(eval_fns, s, "eval_fns")
        eval_batches = _broadcast(eval_batches, s, "eval_batches")
        for i, (fn, b) in enumerate(zip(eval_fns, eval_batches)):
            if fn is not None and b is None:
                raise ValueError(f"model {i}: eval_fn needs eval_batch=(x, y)")
        # per-model partitioner seeds drawn in model order from the engine
        # rng (one draw at S = 1: the single-model engine's stream)
        parts = [FederatedPartitioner(tr, seed=int(self.rng.integers(2**31)))
                 for tr in trains]
        return trains, eval_fns, eval_batches, parts

    def _set_ledgers(self, scheds) -> None:
        self.energy_ledgers = [
            {"per_learner": sc.energy_spent, "violations": sc.energy_violations}
            for sc in scheds
        ]
        self.energy_ledger = {
            "per_learner": sum(sc.energy_spent for sc in scheds),
            "violations": int(sum(sc.energy_violations for sc in scheds)),
        }

    def _schedules(self, trains, eval_fns, eval_batches, horizon, max_events):
        """This run's shared schedule build, recording its counters and
        ledgers (reset first, so a build that raises leaves no stale
        tallies)."""
        self.fault_counters = _zero_fault_counters()
        trains, eval_fns, eval_batches, parts = self._prep_run(trains, eval_fns,
                                                               eval_batches)
        scheds, counters = self._build_schedules(parts, horizon, max_events)
        self.fault_counters = counters
        self._set_ledgers(scheds)
        return trains, eval_fns, eval_batches, scheds

    # -- eager event loop ----------------------------------------------------
    def run(
        self,
        trains,
        horizon: float | None = None,
        *,
        cycles: int | None = None,
        eval_fns=None,
        eval_batches=None,
        max_events: int = 100_000,
    ) -> list[list[dict]]:
        """Simulate to virtual time ``horizon``; returns one history list
        per model (each row as in ``AsyncFedEngine.run``, plus a ``"model"``
        index). ``eval_fns`` map ``(params, x, y)`` to a scalar, evaluated
        on ``eval_batches`` after every aggregation. With
        ``cfg.barrier=True`` the run is round-gated instead (pass
        ``cycles``) and at S = 1 reproduces ``Orchestrator.run``."""
        if self.cfg.barrier:
            return self._run_barrier(trains, horizon=horizon, cycles=cycles,
                                     eval_fns=eval_fns, eval_batches=eval_batches)
        if horizon is None:
            raise ValueError("event mode needs a virtual-time horizon")
        trains, eval_fns, eval_batches, scheds = self._schedules(
            trains, eval_fns, eval_batches, horizon, max_events)
        histories: list[list[dict]] = []
        for si in range(self.num_models):
            eval_fn, ex, ey = self._eval_triplet(eval_fns[si], eval_batches[si])
            self.params[si], hist = _replay_eager_schedule(
                self.params[si], scheds[si], trains[si],
                mode=self.cfgs[si].mode, lr=self.cfgs[si].lr,
                num_learners=self.problems[0].num_learners,
                loss_fn=self.loss_fns[si], eval_fn=eval_fn, ex=ex, ey=ey,
            )
            for rec in hist:
                rec["model"] = si
            histories.append(hist)
        return histories

    # -- event-indexed grouped path ------------------------------------------
    def run_events(
        self,
        trains,
        horizon: float,
        *,
        eval_fns=None,
        eval_batches=None,
        max_events: int = 100_000,
    ) -> list[list[dict]]:
        """``run`` through the grouped executor: ONE shared schedule build,
        then each model's event segments replay through
        ``async_engine._run_group_program`` with that model's own
        parameters (one ``ops.train_agg_step`` call a group: on the card
        the training and ``accum_flush`` kernels). History rows equal
        ``run``'s (one schedule); parameters agree to float tolerance."""
        if self.cfg.barrier:
            raise ValueError(
                "the barrier (cycle-gated) regime is the eager paper "
                "scheme; run_events is the event-driven fast path"
            )
        trains, eval_fns, eval_batches, scheds = self._schedules(
            trains, eval_fns, eval_batches, horizon, max_events)
        histories: list[list[dict]] = []
        for si in range(self.num_models):
            segments = _event_segments(scheds[si].arrivals)
            if not segments:
                histories.append([])
                continue
            self.params[si], hist = _run_group_program(
                self.params[si], segments, scheds[si], trains[si],
                mode=self.cfgs[si].mode, lr=self.cfgs[si].lr,
                num_learners=self.problems[0].num_learners,
                loss_fn=self.loss_fns[si], eval_fn=eval_fns[si],
                eval_batch=eval_batches[si],
            )
            for rec in hist:
                rec["model"] = si
            histories.append(hist)
        return histories

    # -- barrier (paper-scheme) rounds ---------------------------------------
    def _run_barrier(self, trains, *, horizon, cycles, eval_fns, eval_batches):
        """Cycle-gated rounds for all S models: a cycle's ONE cross-model
        solve fixes every model's (tau, d) (all versions advance together,
        so the deficits stay uniform), then each model trains and
        aggregates its own fleet-wide round, eagerly. At S = 1 the static
        allocation is the per-problem ``SCHEMES`` solve: ``Orchestrator.run``
        bitwise."""
        cfg, probs = self.cfg, self.problems
        s = self.num_models
        p0 = probs[0]
        if cycles is None:
            if horizon is None:
                raise ValueError("barrier mode needs cycles or horizon")
            cycles = int(np.floor(horizon / p0.T + 1e-9))
        trains, eval_fns, eval_batches, parts = self._prep_run(trains, eval_fns,
                                                               eval_batches)
        self.fault_counters = _zero_fault_counters()
        e_rows = [p.energy_rows() for p in probs]
        k = p0.num_learners
        dev = self.device
        energy_spent = np.zeros((s, k))
        energy_violations = np.zeros(s, np.int64)
        evals = [self._eval_triplet(fn, b) for fn, b in zip(eval_fns, eval_batches)]
        rows = (self._block_rows(cycles)
                if cfg.reallocate and self.drift is not None else None)
        uniform = (0.0,) * s
        histories: list[list[dict]] = [[] for _ in range(s)]
        for c in range(cycles):
            if rows is not None:
                tau_all, d_all = self._alloc_for_block(c, uniform, rows, True)
            elif s == 1:
                tau_all = np.asarray(self.allocations[0].tau)[None]
                d_all = np.asarray(self.allocations[0].d)[None]
            else:
                tau_all, d_all, _ = self._alloc_static(uniform)
            for si in range(s):
                tau = np.asarray(tau_all[si])
                d = np.asarray(d_all[si])
                ci = self.cfgs[si]
                x, y, msk = _stage_shards(parts[si].draw(d), int(d.max()),
                                          trains[si].x.shape[1])
                locals_ = local_train(
                    self.params[si], torch.from_numpy(x).to(dev),
                    torch.from_numpy(y).to(dev), torch.from_numpy(msk).to(dev),
                    torch.as_tensor(tau, device=dev), ci.lr,
                    max_tau=max(int(tau.max()), 1), loss_fn=self.loss_fns[si],
                )
                if ci.aggregation == "staleness":
                    w = staleness_weights(tau, d, gamma=ci.staleness_gamma)
                else:
                    w = fedavg_weights(d)
                self.params[si] = aggregate(
                    locals_, torch.as_tensor(w, dtype=torch.float32, device=dev))
                if e_rows[si] is not None:
                    e2r, e1r, e0r, ebr = e_rows[si]
                    e_c = np.where(d > 0, e2r * tau * d + e1r * d + e0r, 0.0)
                    energy_spent[si] += e_c
                    energy_violations[si] += int(np.sum(e_c > ebr * (1 + 1e-9)))
                else:
                    e_c = np.zeros(k)
                rec = {
                    "event": c,
                    "t": (c + 1) * p0.T,
                    "mode": "cycle",
                    "server_version": c + 1,
                    "learners": list(range(k)),
                    "tau": tau.copy(),
                    "d": d.copy(),
                    "staleness_list": [0] * k,
                    "version_staleness_max": 0,
                    "version_staleness_mean": 0.0,
                    "weights": np.asarray(w, np.float64),
                    "keep": 0.0,
                    "energy": e_c,
                    "max_staleness": max_staleness(tau),
                    "avg_staleness": avg_staleness(tau),
                    "cycle": c,
                    "elapsed_s": (c + 1) * p0.T,
                    "wall_clock_s": p0.T,
                    "model": si,
                }
                eval_fn, ex, ey = evals[si]
                if eval_fn is not None:
                    rec["accuracy"] = float(eval_fn(self.params[si], ex, ey))
                histories[si].append(rec)
        self.energy_ledgers = [
            {"per_learner": energy_spent[si], "violations": int(energy_violations[si])}
            for si in range(s)
        ]
        self.energy_ledger = {
            "per_learner": energy_spent.sum(axis=0),
            "violations": int(energy_violations.sum()),
        }
        return histories

    # -- shared pieces -------------------------------------------------------
    def _eval_triplet(self, eval_fn, eval_batch):
        """``(eval_fn, x, y)`` with the batch on the engine's device."""
        if eval_fn is None:
            return None, None, None
        if eval_batch is None:
            raise ValueError("eval_fn needs eval_batch=(x, y)")
        ex, ey = (torch.as_tensor(a, device=self.device) for a in eval_batch)
        return eval_fn, ex, ey
