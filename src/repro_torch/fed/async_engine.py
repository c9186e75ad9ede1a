"""Event-driven asynchronous federation engine (FedAsync / FedBuff style),
in torch; the port of ``repro/fed/async_engine.py``.

The paper's scheme is asynchronous only within a global cycle: every
learner's work is gated to the same wall-clock budget ``T`` and the server
aggregates once per cycle. This engine drops the cycle gate: a virtual-clock
event queue lets every learner upload the moment it finishes, and the server
reacts per upload:

  * each learner's task completion time follows the paper's wall-clock
    model (Eq. 5: ``C2 tau_k d_k + C1 d_k + C0`` under the capacities of
    the drift block it was dispatched in);
  * ``mode="fedasync"`` — on every arrival the server mixes at once,
    ``w <- (1 - alpha s(v)) w + alpha s(v) w_k``, with version staleness
    ``v`` and the FedAsync discount ``s`` (``core.staleness``);
  * ``mode="buffered"`` — arrivals fill a size-``M`` buffer; a full buffer
    is flushed as one staleness-weighted aggregation and bumps the server
    version once. With ``M = K`` and ``barrier=True`` the engine is the
    paper's cycle-gated scheme and reproduces ``Orchestrator.run``;
  * at every (re)dispatch the learner's ``(tau_k, d_k)`` comes from the
    fleet allocation re-solved through ``core.solver_batched.batched_policy``
    on the capacities of the current drift block (``solve_policy_row`` on
    the engine's device: on the card every bisection step launches the
    water-filling kernel).

The event timeline does not depend on parameter values, so the host
simulates the whole event system once (``_build_schedule``: completion
times, versions, staleness, shard draws, aggregation coefficients and
every fault event) with the reference's rng discipline, and the executors
replay it:

  * ``run`` — eager: one ``local_train`` and one ``aggregate`` per event,
    plain torch on whichever device holds the parameters;
  * ``run_events`` — the event-indexed (jagged) path: arrivals grouped by
    flush structure (``_event_segments``), one ``kernels.ops.train_agg_step``
    call (async form) per group: on the card the CUDA training kernels and
    the ``accum_flush`` kernel, on the CPU their plain version. The training
    set goes to the device once; the schedule stages only index rows,
    masks and coefficients, and each group gathers its shards there.
    ``seg_batch`` stages over arrival slots instead of all K learners;
  * ``run_bucketed`` — the fixed-grid twin (time buckets instead of event
    groups), kept for grid-vs-jagged comparisons.

Capacity drift composes through the schedule: ``CapacityDrift`` rows per
block, and a state-coupled ``QueueDrift`` rolled out block by block with
its re-solves (``reallocate=True`` required). Client churn too: under an
availability process (``core.availability``) or a ``BatteryDrift`` each
block's online mask gates dispatching, an offline learner's dispatch is
deferred to its next online block or churned out of the run, and adaptive
runs solve each block masked (``solve_rows_availability``; a battery's
charge also caps an energy-aware scheme's budget). With an
``EnergyModel`` on the problem every dispatch is charged its joules
(``E_k(tau_k, d_k)``) in its arrival's ``energy`` column and in
``energy_ledger``, which counts the dispatches over the problem's budget.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq

import numpy as np
import torch

from repro_torch.core import (
    AllocationProblem,
    CapacityDrift,
    aggregate,
    availability_masks,
    capacity_state_coupled,
    fedavg_weights,
    has_availability,
    is_state_coupled,
    staleness_weights,
)
from repro_torch.core.staleness import (
    STALENESS_FNS,
    avg_staleness,
    max_staleness,
    staleness_factor,
    version_staleness_profile,
)
from repro_torch.data.pipeline import Dataset, FederatedPartitioner
from repro_torch.fed.orchestrator import (
    _check_drift,
    _solver,
    _stage_shards,
    coefficient_rows,
    local_train,
    solve_policy_row,
    solve_rows_availability,
    solve_rows_state_coupled,
)
from repro_torch.kernels import ops
from repro_torch.models import mlp

__all__ = [
    "AsyncConfig",
    "AsyncFedEngine",
    "FAULT_COUNTERS",
    "clear_staging_cache",
    "staging_cache_stats",
    "summarize_async_history",
]


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Server behaviour of the event-driven engine.

    ``buffer_size = 0`` means "fleet size K" (resolved at engine init).
    ``barrier=True`` (buffered only, requires M = K) gates every round on
    the slowest learner and redispatches the whole fleet at the cycle
    boundary — the paper's scheme as a point in this family.

    Fault injection (all off by default; event modes; virtual-clock
    seconds): ``drop_rate`` loses uploads in transit,
    ``delay_rate``/``delay_mean`` adds exponential transit delay,
    ``straggler_rate``/``straggler_factor`` slows a dispatch's whole
    computation, ``deadline`` bounds each dispatch server-side with
    ``retry_backoff``-capped-exponential redispatch on a miss, and
    ``quorum``/``flush_timeout`` lets a buffered server flush an
    incomplete group (>= quorum arrivals at the timeout; below quorum it
    extends once, then flushes whatever arrived). ``barrier=True`` rejects
    every fault knob.
    """

    mode: str = "fedasync"             # fedasync | buffered
    alpha: float = 0.6                 # FedAsync server mixing rate
    staleness_fn: str = "poly"         # constant | hinge | poly
    staleness_a: float = 0.5           # discount exponent / slope
    staleness_b: float = 4.0           # hinge knee
    buffer_size: int = 0               # M (buffered); 0 -> K
    barrier: bool = False              # cycle barrier (paper scheme at M=K)
    aggregation: str = "staleness"     # intra-buffer weighting: staleness|fedavg
    staleness_gamma: float = 1.0
    lr: float = 0.1
    scheme: str = "kkt_sai"            # allocation policy at (re)dispatch
    reallocate: bool = False           # re-solve per drift block
    # -- fault injection (virtual-clock seconds) ------------------------------
    drop_rate: float = 0.0             # P(an upload is lost in transit)
    delay_rate: float = 0.0            # P(an upload is delayed in transit)
    delay_mean: float = 1.0            # mean exponential transit delay (s)
    straggler_rate: float = 0.0        # P(a dispatch straggles)
    straggler_factor: float = 4.0      # straggler slowdown (>= 1)
    deadline: float = 0.0              # per-dispatch deadline (s); 0 = off
    retry_backoff: float = 1.0         # first redispatch backoff (s)
    retry_backoff_cap: float = 8.0     # exponential backoff ceiling (s)
    quorum: int = 0                    # buffered: min arrivals at timeout
    flush_timeout: float = 0.0         # buffered: group deadline (s)

    @property
    def has_faults(self) -> bool:
        """Whether any fault knob is active (the fault rng is drawn only
        then, so fault-free schedules consume the plain rng stream)."""
        return (self.drop_rate > 0 or self.delay_rate > 0
                or self.straggler_rate > 0 or self.deadline > 0
                or self.quorum > 0)

    def __post_init__(self):
        if self.mode not in ("fedasync", "buffered"):
            raise ValueError(f"unknown mode {self.mode!r}: fedasync | buffered")
        if self.staleness_fn not in STALENESS_FNS:
            raise ValueError(
                f"unknown staleness fn {self.staleness_fn!r}: "
                + " | ".join(STALENESS_FNS)
            )
        if self.aggregation not in ("staleness", "fedavg"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}")
        if not (0.0 < self.alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        if self.barrier and self.mode != "buffered":
            raise ValueError("barrier=True is the buffered (M=K) regime; "
                             "fedasync has no cycle gate")
        for name in ("drop_rate", "delay_rate", "straggler_rate"):
            if not (0.0 <= getattr(self, name) <= 1.0):
                raise ValueError(f"{name} must be a probability in [0, 1]")
        if self.straggler_factor < 1.0:
            raise ValueError("straggler_factor must be >= 1 (a straggler "
                             "is slower, never faster)")
        if self.delay_rate > 0 and self.delay_mean <= 0:
            raise ValueError("delay_rate > 0 needs delay_mean > 0")
        if self.deadline < 0:
            raise ValueError("deadline must be >= 0 (0 disables it)")
        if self.deadline > 0 and self.retry_backoff <= 0:
            raise ValueError("deadline retries need retry_backoff > 0")
        if self.retry_backoff_cap < self.retry_backoff:
            raise ValueError("retry_backoff_cap must be >= retry_backoff")
        if self.quorum < 0:
            raise ValueError("quorum must be >= 0 (0 disables timer flushes)")
        if self.quorum > 0:
            if self.mode != "buffered":
                raise ValueError("quorum applies to buffered flushes only; "
                                 "fedasync flushes every arrival already")
            if self.flush_timeout <= 0:
                raise ValueError("quorum > 0 needs flush_timeout > 0 (the "
                                 "group deadline that triggers the quorum "
                                 "check)")
        elif self.flush_timeout > 0:
            raise ValueError("flush_timeout without quorum has no effect; "
                             "set quorum >= 1")
        if self.barrier and self.has_faults:
            raise ValueError(
                "barrier=True is the fault-free paper regime (every round "
                "gates on the full fleet); fault injection needs the "
                "event-driven modes"
            )


# ---------------------------------------------------------------------------
# host-side schedule (model-independent event timeline)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Arrival:
    """One upload event. Aggregation coefficients are filled when the
    event's flush group closes (the schedule is simulated in full before
    any training runs)."""

    seq: int                 # chronological arrival index
    learner: int
    t: float                 # completion (= arrival) time
    tau: int
    d: int
    idx: np.ndarray          # shard sample indices drawn at dispatch
    dispatch_t: float
    dispatch_version: int
    staleness: int           # server_version - dispatch_version at arrival
    energy: float = 0.0      # joules the dispatch cost (0 without a model)
    version_after: int = 0
    flush: bool = False      # this arrival closes a flush
    timer_flush: bool = False  # the flush fired on a quorum timer, AFTER
    #                          this arrival redispatched (pre-flush server)
    flush_t: float = 0.0     # virtual time the flush applied
    keep: float = 1.0        # server self-weight at the flush
    weight: float = 0.0      # this local model's coefficient in its flush
    flush_id: int = -1
    group_weights: np.ndarray | None = None   # on flush arrivals only


@dataclasses.dataclass
class _Schedule:
    arrivals: list
    n_flushes: int
    d_cap: int               # max d over arrivals (>= 1)
    max_tau: int             # max tau over arrivals (>= 1)
    counters: dict = dataclasses.field(default_factory=dict)
    # per-learner joules charged at dispatch (dropped, in-flight and
    # deadline-cancelled uploads included: the device spent them)
    energy_spent: np.ndarray | None = None
    energy_violations: int = 0   # dispatches costing more than e_budget


FAULT_COUNTERS = (
    "dispatches", "drops", "delays", "stragglers", "deadline_misses",
    "retries", "late_discards", "quorum_flushes", "quorum_extensions",
    "quorum_degradations", "offline_deferrals", "offline_churned",
)


def _zero_fault_counters() -> dict:
    return {key: 0 for key in FAULT_COUNTERS}


_EV_ARRIVE, _EV_DEADLINE, _EV_QUORUM = 0, 1, 2   # heap tie-break priority


def _event_segments(arrivals: "list[_Arrival]") -> "list[list[_Arrival]]":
    """Partition the flush-ordered arrival sequence into event-indexed
    (jagged) segments, the steps of ``run_events``:

      * at most one arrival per learner per segment (one carried dispatch
        model per learner);
      * at most one flush per segment, always its last arrival (so every
        mid-segment redispatch sees the unchanged server, as in the eager
        loop);
      * fedasync arrivals each close their own flush, so their segments
        hold one arrival each;
      * never-flushed trailing arrivals (``flush_id < 0``) are dropped:
        their local models are unobservable.

    Buffered flush groups are split greedily at learner repeats; the
    prefixes become accumulate-only segments (no flush, server untouched).
    """
    segments: list[list[_Arrival]] = []
    cur: list[_Arrival] = []
    seen: set[int] = set()
    for a in arrivals:
        if a.flush_id < 0:
            continue
        if a.learner in seen:
            segments.append(cur)
            cur, seen = [], set()
        cur.append(a)
        seen.add(a.learner)
        if a.flush:
            segments.append(cur)
            cur, seen = [], set()
    # every kept arrival belongs to a flush group that closes within the
    # horizon, so the walk always ends on a flush boundary
    assert not cur
    return segments


def _flush_row(ev: _Arrival, group: "list[_Arrival]", mode: str) -> dict:
    """One history record per server aggregation, shared by every replay."""
    ss = [g.staleness for g in group]
    return {
        "event": ev.flush_id,
        "t": ev.flush_t,
        "mode": mode,
        "server_version": ev.version_after,
        "learners": [g.learner for g in group],
        "tau": np.array([g.tau for g in group], np.int64),
        "d": np.array([g.d for g in group], np.int64),
        "staleness_list": list(map(int, ss)),
        "version_staleness_max": int(max(ss)),
        "version_staleness_mean": float(np.mean(ss)),
        "weights": np.asarray(ev.group_weights, np.float64),
        "keep": ev.keep,
        "energy": np.array([g.energy for g in group], np.float64),
    }


def _device_of(params) -> torch.device:
    return params[0]["w"].device


def _replay_eager_schedule(params, sched: _Schedule, train: Dataset, *,
                           mode: str, lr: float, num_learners: int, loss_fn,
                           eval_fn, ex, ey):
    """The eager event walk over one schedule: train each arrival's
    dispatched model (``local_train``, padded to the schedule's ``d_cap``
    as the grouped path pads), mix/flush per event (``aggregate``). Plain
    torch on the parameters' device. Returns ``(params, history)``."""
    feat = train.x.shape[1]
    dev = _device_of(params)
    dispatch_params = [params] * num_learners
    pending: list = []          # trained locals of the open buffer group
    group: list[_Arrival] = []
    history: list[dict] = []

    for ev in sched.arrivals:
        if ev.flush_id < 0:
            # a trailing arrival whose group never flushes within the
            # horizon: its local model is unobservable, so it is not trained
            dispatch_params[ev.learner] = params
            continue
        x = np.zeros((1, sched.d_cap, feat), np.float32)
        y = np.zeros((1, sched.d_cap), np.int32)
        msk = np.zeros((1, sched.d_cap), np.float32)
        x[0, : ev.d] = train.x[ev.idx]
        y[0, : ev.d] = train.y[ev.idx]
        msk[0, : ev.d] = 1.0
        # steps at i >= tau leave the learner bitwise untouched, so bounding
        # the loop by this event's tau gives what the schedule-wide bound gives
        out = local_train(
            dispatch_params[ev.learner], torch.from_numpy(x).to(dev),
            torch.from_numpy(y).to(dev), torch.from_numpy(msk).to(dev),
            torch.tensor([ev.tau], device=dev), lr,
            max_tau=max(ev.tau, 1), loss_fn=loss_fn,
        )
        pending.append([{n: leaf[0] for n, leaf in layer.items()} for layer in out])
        group.append(ev)
        if ev.flush:
            if ev.timer_flush:
                # a quorum timer closed this group AFTER its last arrival
                # redispatched: that dispatch took the PRE-flush server
                dispatch_params[ev.learner] = params
            models = [params] + pending
            stacked = [{n: torch.stack([m[l][n] for m in models]) for n in layer}
                       for l, layer in enumerate(params)]
            wvec = np.concatenate([[ev.keep], ev.group_weights])
            params = aggregate(stacked, torch.as_tensor(wvec, dtype=torch.float32,
                                                        device=dev))
            rec = _flush_row(ev, group, mode)
            if eval_fn is not None:
                rec["accuracy"] = float(eval_fn(params, ex, ey))
            history.append(rec)
            pending, group = [], []
            if not ev.timer_flush:
                dispatch_params[ev.learner] = params
        else:
            dispatch_params[ev.learner] = params
    return params, history


class AsyncFedEngine:
    """Virtual-clock asynchronous federation over one fleet, on the device
    that holds ``init_params``.

    Parameters mirror ``Orchestrator``: the ``AllocationProblem`` supplies
    the per-learner wall-clock model (and, with an ``EnergyModel``, the
    per-dispatch joules), ``drift`` (optional: a ``CapacityDrift``, a
    ``QueueDrift``, an availability process or a ``BatteryDrift``) the
    per-block capacity and availability evolution (block length =
    ``problem.T``; a task's cost is evaluated under the block of its
    dispatch time).
    """

    def __init__(
        self,
        cfg: AsyncConfig,
        problem: AllocationProblem,
        loss_fn,
        init_params,
        *,
        seed: int = 0,
        drift: CapacityDrift | None = None,
    ):
        _check_drift(drift)
        self.cfg = cfg
        self.problem = problem
        self.loss_fn = loss_fn
        self.params = init_params
        self.device = _device_of(init_params)
        self.rng = np.random.default_rng(seed)
        self.drift = drift
        k = problem.num_learners
        self.buffer_size = cfg.buffer_size or k
        if not (1 <= self.buffer_size <= k):
            raise ValueError(f"buffer_size must be in [1, K={k}]")
        if cfg.barrier and self.buffer_size != k:
            raise ValueError(
                "the cycle barrier gates on the whole fleet: it requires "
                f"buffer_size == K (= {k}); M < K is the event-driven "
                "buffered regime"
            )
        if cfg.quorum > self.buffer_size:
            raise ValueError(
                f"quorum (= {cfg.quorum}) must be <= buffer_size "
                f"(= {self.buffer_size}): a full buffer flushes on its own"
            )
        if has_availability(drift):
            if cfg.barrier:
                raise ValueError(
                    "availability churn has no barrier regime (one offline "
                    "learner would gate every round forever); use the "
                    "event-driven modes, or the Orchestrator for the "
                    "fault-free paper scheme"
                )
            coupled = capacity_state_coupled(drift)
        else:
            coupled = is_state_coupled(drift)
        if coupled and not cfg.reallocate:
            raise ValueError(
                "state-coupled drift ties capacities to the dispatched "
                "allocations; the async engine supports it only with "
                "reallocate=True (per-block re-solves drive the state)"
            )
        # the paper-scheme allocation on the base capacities (the barrier
        # path's, so it matches Orchestrator.run); event-mode dispatches
        # solve through the batched policy instead
        self.allocation = _solver(cfg.scheme, self.device)(problem)
        self._alloc_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._static_alloc: tuple[np.ndarray, np.ndarray] | None = None
        self._block_masks: np.ndarray | None = None
        # fault/churn tallies of the LAST schedule built by a run method
        self.fault_counters: dict = _zero_fault_counters()
        # per-learner joule ledger of the last run (zeros without an
        # EnergyModel): joules spent per learner and the count of dispatches
        # over their e_budget, zero by construction under kkt_energy
        self.energy_ledger: dict = {"per_learner": np.zeros(k), "violations": 0}

    # -- capacities & allocation --------------------------------------------
    def _block_rows(self, nblocks: int):
        """(C, K) float64 capacity rows per drift block, the orchestrator's
        row source. A state-coupled drift has no standalone rows, so rows
        and per-block solves roll out together and prefill the cache. An
        availability process also gives the per-block online masks
        (``self._block_masks``) that gate dispatching: adaptive runs solve
        each block masked (``solve_rows_availability``); frozen runs
        dispatch the static base allocation whenever a learner is online,
        with the masks rolled out under that frozen allocation."""
        drift = self.drift
        self._block_masks = None
        if has_availability(drift):
            if self.cfg.reallocate:
                rows, (taus, ds), masks = solve_rows_availability(
                    self.cfg.scheme, drift, self.problem, nblocks,
                    label="capacities at drift block {}", device=self.device,
                )
                for b in range(nblocks):
                    self._alloc_cache[b] = (taus[b], ds[b])
                self._block_masks = masks
                return rows
            tau0, d0 = self._alloc_base()
            self._block_masks = availability_masks(
                drift, self.problem.num_learners, nblocks, tau=tau0, d=d0)
            return coefficient_rows(self.problem, drift.base, nblocks)
        if is_state_coupled(drift):
            rows, (taus, ds) = solve_rows_state_coupled(
                self.cfg.scheme, drift, self.problem, nblocks,
                label="capacities at drift block {}", device=self.device,
            )
            for b in range(nblocks):
                self._alloc_cache[b] = (taus[b], ds[b])
            return rows
        return coefficient_rows(self.problem, drift, nblocks)

    def _solve_row(self, c2r, c1r, c0r, *, label) -> tuple[np.ndarray, np.ndarray]:
        """Fleet allocation (tau, d) on one (K,) capacity row, through the
        orchestrator's re-solve on the engine's device."""
        return solve_policy_row(self.cfg.scheme, c2r, c1r, c0r, self.problem,
                                label=label, device=self.device)

    def _alloc_for_block(self, block: int, rows) -> tuple[np.ndarray, np.ndarray]:
        """Per-block adaptive allocation (cached per drift block)."""
        hit = self._alloc_cache.get(block)
        if hit is None:
            c2s, c1s, c0s = rows
            hit = self._solve_row(
                c2s[block], c1s[block], c0s[block],
                label=f"capacities at drift block {block}",
            )
            self._alloc_cache[block] = hit
        return hit

    def _alloc_base(self) -> tuple[np.ndarray, np.ndarray]:
        """Static allocation, solved once on the base capacities."""
        if self._static_alloc is None:
            tm = self.problem.time_model
            self._static_alloc = self._solve_row(
                tm.c2.astype(np.float64), tm.c1.astype(np.float64),
                tm.c0.astype(np.float64), label="base capacities",
            )
        return self._static_alloc

    # -- schedule ------------------------------------------------------------
    def _build_schedule(
        self, part: FederatedPartitioner, horizon: float, max_events: int
    ) -> _Schedule:
        """Simulate the full event system without touching model values:
        completion times, versions, per-dispatch shard draws, aggregation
        coefficients and every fault event (drops, transit delays,
        stragglers, deadline retries, quorum timer flushes). Every executor
        replays this verbatim.

        The heap carries ``(t, kind, seq, payload)`` with kind priority
        arrival < deadline < quorum, so an upload landing exactly at its
        deadline counts as arrived and one landing exactly at a quorum
        timeout joins the group before the check. Fault randomness comes
        from a generator seeded off the engine rng only when
        ``cfg.has_faults``."""
        cfg, prob = self.cfg, self.problem
        k_fleet, T = prob.num_learners, prob.T
        m = self.buffer_size
        nblocks = max(int(np.ceil(horizon / T)) + 1, 1)
        rows = self._block_rows(nblocks)
        masks = self._block_masks           # (nblocks, K) bool under churn
        # without drift every block row is the base row: re-solving per
        # block would repeat the static solve
        realloc = cfg.reallocate and self.drift is not None
        frng = (np.random.default_rng(int(self.rng.integers(2**31)))
                if cfg.has_faults else None)
        counters = _zero_fault_counters()
        # joules are charged at dispatch, against the problem's static
        # per-learner budget rows
        e_rows = prob.energy_rows()
        energy_spent = np.zeros(k_fleet)
        energy_violations = 0
        heap: list = []
        seq = 0
        server_version = 0
        arrivals: list[_Arrival] = []
        group: list[_Arrival] = []
        flush_id = 0
        next_did = 0                    # dispatch id
        dstate: dict[int, str] = {}     # did -> pending | arrived | cancelled
        open_gid = -1                   # quorum timer id of the open group
        gid_counter = 0

        def push(t: float, kind: int, payload) -> None:
            nonlocal seq
            heapq.heappush(heap, (t, kind, seq, payload))
            seq += 1

        def dispatch(k: int, t: float, attempt: int = 0) -> None:
            nonlocal next_did, energy_violations
            block = min(int(t // T), nblocks - 1)
            if masks is not None:
                # an offline learner cannot take a task: defer the dispatch
                # to the start of its next online block, or churn it out of
                # the run if none remains within the horizon
                b = block
                while b < nblocks and not masks[b][k]:
                    b += 1
                if b >= nblocks or b * T > horizon:
                    counters["offline_churned"] += 1
                    return
                if b != block:
                    counters["offline_deferrals"] += 1
                    block, t = b, b * T
            if realloc:
                tau_a, d_a = self._alloc_for_block(block, rows)
            else:
                tau_a, d_a = self._alloc_base()
            tau_k, d_k = int(tau_a[k]), int(d_a[k])
            if masks is not None and d_k == 0:
                # the masked solve gave this online learner nothing (the
                # budget fit in the rest of the fleet): try the next block
                if (block + 1) * T <= horizon and block + 1 < nblocks:
                    dispatch(k, (block + 1) * T, attempt)
                else:
                    counters["offline_churned"] += 1
                return
            idx = part.draw_indices(d_k)
            c2, c1, c0 = (r[block, k] for r in rows)
            cost = float(c2 * tau_k * d_k + c1 * d_k + c0)
            counters["dispatches"] += 1
            energy_j = 0.0
            if e_rows is not None:
                e2k, e1k, e0k, ebk = (row[k] for row in e_rows)
                energy_j = float(e2k * tau_k * d_k + e1k * d_k + e0k)
                energy_spent[k] += energy_j
                if energy_j > ebk * (1 + 1e-9):
                    energy_violations += 1
            dropped = False
            if frng is not None:
                # fixed per-dispatch draw order: straggle -> delay -> drop
                if (cfg.straggler_rate > 0
                        and frng.random() < cfg.straggler_rate):
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
                # lost in transit: only a deadline (if armed) hears of it again
                counters["drops"] += 1
            else:
                push(t + cost, _EV_ARRIVE,
                     (did, k, t, server_version, tau_k, d_k, idx, attempt, energy_j))
            if cfg.deadline > 0:
                push(t + cfg.deadline, _EV_DEADLINE, (did, k, attempt))

        def close_group(t_flush: float, timer: bool) -> None:
            """Flush the open buffered group (at M arrivals, or on a quorum
            timer firing at ``t_flush`` after the last arrival)."""
            nonlocal server_version, flush_id, group, open_gid
            taus = np.array([g.tau for g in group], float)
            ds = np.array([g.d for g in group], float)
            phi = staleness_factor(
                np.array([g.staleness for g in group], float),
                kind=cfg.staleness_fn, a=cfg.staleness_a, b=cfg.staleness_b,
            )
            # the paper's intra-buffer weighting, version-discounted by phi
            base = (fedavg_weights(ds)
                    if cfg.aggregation == "fedavg" else
                    staleness_weights(taus, ds, gamma=cfg.staleness_gamma))
            w = base * phi
            w = w / w.sum()
            for g, wg in zip(group, w):
                g.weight = float(wg)
                g.flush_id = flush_id
            closer = group[-1]
            closer.flush = True
            closer.timer_flush = timer
            closer.flush_t = t_flush
            closer.keep = 0.0
            closer.group_weights = np.asarray(w, np.float64)
            server_version += 1
            closer.version_after = server_version
            flush_id += 1
            group = []
            open_gid = -1

        for k in range(k_fleet):
            dispatch(k, 0.0)

        while heap and len(arrivals) < max_events:
            t_e, kind, _, payload = heapq.heappop(heap)
            if t_e > horizon:
                break
            if kind == _EV_DEADLINE:
                did, k, attempt = payload
                if dstate.get(did) != "pending":
                    continue   # arrived in time (or already cancelled)
                dstate[did] = "cancelled"
                counters["deadline_misses"] += 1
                counters["retries"] += 1
                backoff = min(cfg.retry_backoff * (2.0 ** attempt),
                              cfg.retry_backoff_cap)
                dispatch(k, t_e + backoff, attempt + 1)
                continue
            if kind == _EV_QUORUM:
                gid, extended = payload
                if gid != open_gid or not group:
                    continue   # the group already flushed at M
                if len(group) >= cfg.quorum:
                    counters["quorum_flushes"] += 1
                    close_group(t_e, timer=True)
                elif not extended:
                    # below quorum: extend the deadline once before degrading
                    counters["quorum_extensions"] += 1
                    push(t_e + cfg.flush_timeout, _EV_QUORUM, (gid, True))
                else:
                    # still below quorum: flush whatever arrived
                    counters["quorum_degradations"] += 1
                    close_group(t_e, timer=True)
                continue
            did, k, t_disp, v_disp, tau_k, d_k, idx, attempt, e_j = payload
            if dstate.get(did) == "cancelled":
                counters["late_discards"] += 1
                continue   # its deadline already fired and retried
            dstate[did] = "arrived"
            a = _Arrival(
                seq=len(arrivals), learner=k, t=t_e, tau=tau_k, d=d_k,
                idx=idx, dispatch_t=t_disp, dispatch_version=v_disp,
                staleness=server_version - v_disp, energy=e_j,
            )
            group.append(a)
            arrivals.append(a)
            if cfg.mode == "fedasync":
                phi = staleness_factor(
                    np.array([a.staleness], float),
                    kind=cfg.staleness_fn, a=cfg.staleness_a,
                    b=cfg.staleness_b,
                )
                w = np.array([cfg.alpha]) * phi
                a.weight = float(w[0])
                a.flush_id = flush_id
                a.flush = True
                a.flush_t = t_e
                a.keep = 1.0 - float(w[0])
                a.group_weights = np.asarray(w, np.float64)
                server_version += 1
                a.version_after = server_version
                flush_id += 1
                group = []
            elif len(group) == m:
                close_group(t_e, timer=False)
            else:
                if cfg.quorum > 0 and len(group) == 1:
                    gid_counter += 1
                    open_gid = gid_counter
                    push(t_e + cfg.flush_timeout, _EV_QUORUM,
                         (open_gid, False))
                a.version_after = server_version
            dispatch(k, t_e)   # immediate redispatch with the current server

        return _Schedule(
            arrivals=arrivals, n_flushes=flush_id,
            d_cap=max([a.d for a in arrivals], default=1),
            max_tau=max([a.tau for a in arrivals] + [1]),
            counters=counters,
            energy_spent=energy_spent, energy_violations=energy_violations,
        )

    def _schedule(self, train: Dataset, horizon: float, max_events: int) -> _Schedule:
        """Build this run's schedule, recording its fault tallies and ledger
        (reset first, so a build that raises leaves no stale tallies)."""
        self.fault_counters = _zero_fault_counters()
        part = FederatedPartitioner(train, seed=int(self.rng.integers(2**31)))
        sched = self._build_schedule(part, horizon, max_events)
        self.fault_counters = sched.counters
        self.energy_ledger = {"per_learner": sched.energy_spent,
                              "violations": sched.energy_violations}
        return sched

    def _eval_pair(self, eval_fn, eval_batch):
        if eval_fn is None:
            return None, None, None
        if eval_batch is None:
            raise ValueError("eval_fn needs eval_batch=(x, y)")
        ex, ey = (torch.as_tensor(a, device=self.device) for a in eval_batch)
        return eval_fn, ex, ey

    # -- eager event loop ----------------------------------------------------
    def run(
        self,
        train: Dataset,
        horizon: float | None = None,
        *,
        cycles: int | None = None,
        eval_fn=None,
        eval_batch=None,
        max_events: int = 100_000,
    ) -> list[dict]:
        """Simulate to virtual time ``horizon`` (seconds). Returns one
        history row per server aggregation (per arrival in fedasync mode,
        per buffer flush in buffered mode). ``eval_fn`` maps
        ``(params, x, y)`` to a scalar, evaluated on ``eval_batch`` after
        every aggregation.

        With ``cfg.barrier=True`` the run is round-gated instead (pass
        ``cycles``, or ``horizon`` as a multiple of T) and reproduces
        ``Orchestrator.run`` for the same seed.
        """
        if self.cfg.barrier:
            return self._run_barrier(
                train, horizon=horizon, cycles=cycles,
                eval_fn=eval_fn, eval_batch=eval_batch,
            )
        if horizon is None:
            raise ValueError("event mode needs a virtual-time horizon")
        sched = self._schedule(train, horizon, max_events)
        eval_fn, ex, ey = self._eval_pair(eval_fn, eval_batch)
        self.params, history = _replay_eager_schedule(
            self.params, sched, train, mode=self.cfg.mode, lr=self.cfg.lr,
            num_learners=self.problem.num_learners, loss_fn=self.loss_fn,
            eval_fn=eval_fn, ex=ex, ey=ey,
        )
        return history

    # -- barrier (paper-scheme) rounds --------------------------------------
    def _run_barrier(self, train, *, horizon, cycles, eval_fn, eval_batch):
        prob, cfg = self.problem, self.cfg
        if cycles is None:
            if horizon is None:
                raise ValueError("barrier mode needs cycles or horizon")
            cycles = int(np.floor(horizon / prob.T + 1e-9))
        part = FederatedPartitioner(train, seed=int(self.rng.integers(2**31)))
        self.fault_counters = _zero_fault_counters()   # barrier is fault-free
        e_rows = prob.energy_rows()
        energy_spent = np.zeros(prob.num_learners)
        energy_violations = 0
        eval_fn, ex, ey = self._eval_pair(eval_fn, eval_batch)
        # without drift, per-cycle re-solves would repeat the static solve
        rows = (self._block_rows(cycles)
                if cfg.reallocate and self.drift is not None else None)
        feat = train.x.shape[1]
        dev = self.device
        history = []
        for c in range(cycles):
            if rows is not None:
                tau, d = self._alloc_for_block(c, rows)
            else:
                tau = np.asarray(self.allocation.tau)
                d = np.asarray(self.allocation.d)
            x, y, msk = _stage_shards(part.draw(d), int(d.max()), feat)
            locals_ = local_train(
                self.params, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
                torch.from_numpy(msk).to(dev), torch.as_tensor(tau, device=dev),
                cfg.lr, max_tau=max(int(tau.max()), 1), loss_fn=self.loss_fn,
            )
            if cfg.aggregation == "staleness":
                w = staleness_weights(tau, d, gamma=cfg.staleness_gamma)
            else:
                w = fedavg_weights(d)
            # all versions are equal under the barrier, so the version
            # discount is exactly 1 and the weights are the orchestrator's
            self.params = aggregate(locals_, torch.as_tensor(w, dtype=torch.float32,
                                                             device=dev))
            if e_rows is not None:
                e2r, e1r, e0r, ebr = e_rows
                e_c = np.where(d > 0, e2r * tau * d + e1r * d + e0r, 0.0)
                energy_spent += e_c
                energy_violations += int(np.sum(e_c > ebr * (1 + 1e-9)))
            else:
                e_c = np.zeros(prob.num_learners)
            rec = {
                "event": c,
                "t": (c + 1) * prob.T,
                "mode": "cycle",
                "server_version": c + 1,
                "learners": list(range(prob.num_learners)),
                "tau": tau.copy(),
                "d": d.copy(),
                "staleness_list": [0] * prob.num_learners,
                "version_staleness_max": 0,
                "version_staleness_mean": 0.0,
                "weights": np.asarray(w, np.float64),
                "keep": 0.0,
                "energy": e_c,
                "max_staleness": max_staleness(tau),
                "avg_staleness": avg_staleness(tau),
                "cycle": c,
                "elapsed_s": (c + 1) * prob.T,
                "wall_clock_s": prob.T,
            }
            if eval_fn is not None:
                rec["accuracy"] = float(eval_fn(self.params, ex, ey))
            history.append(rec)
        self.energy_ledger = {"per_learner": energy_spent,
                              "violations": energy_violations}
        return history

    # -- grouped (kernel) paths -------------------------------------------------
    def _run_groups(self, groups, sched: _Schedule, train: Dataset, *,
                    eval_fn, eval_batch, seg_batch=None) -> list[dict]:
        self.params, history = _run_group_program(
            self.params, groups, sched, train, mode=self.cfg.mode,
            lr=self.cfg.lr, num_learners=self.problem.num_learners,
            loss_fn=self.loss_fn, eval_fn=eval_fn, eval_batch=eval_batch,
            seg_batch=seg_batch,
        )
        return history

    def run_events(
        self,
        train: Dataset,
        horizon: float,
        *,
        eval_fn=None,
        eval_batch=None,
        seg_batch=None,
        max_events: int = 100_000,
    ) -> list[dict]:
        """The eager event loop as one train+aggregate call per
        event-indexed (jagged) segment (``_event_segments``): one step per
        fedasync arrival or buffered flush group (split at learner
        repeats). Grouping by event index needs no time grid, so tied and
        near-tied completion times replay exactly.

        train : the Dataset the shard draws index into (the same schedule
            and rng discipline as ``run``).
        horizon : virtual-time horizon in seconds.
        eval_fn : optional ``(params, x, y) -> scalar``, evaluated after
            every flush on ``eval_batch`` (``(x, y)``, required with it).
        seg_batch : optional int — sub-batch each segment into chunks of at
            most this many arrivals, staged over arrival slots instead of
            all K learners; prefix chunks accumulate, the closing chunk
            flushes. Same history rows; params agree with the dense staging
            to float tolerance (the accumulate folds in chunks).
        max_events : schedule-length cap.

        Returns one history row per server aggregation, equal to ``run``'s
        for the same seed (both replay one schedule); params agree to
        float tolerance.
        """
        if self.cfg.barrier:
            raise ValueError(
                "the barrier (cycle-gated) regime's kernel path is "
                "Orchestrator.run_fused; run_events is the event-driven path"
            )
        sched = self._schedule(train, horizon, max_events)
        segments = _event_segments(sched.arrivals)
        if not segments:
            return []
        return self._run_groups(segments, sched, train, eval_fn=eval_fn,
                                eval_batch=eval_batch, seg_batch=seg_batch)

    def run_bucketed(
        self,
        train: Dataset,
        horizon: float,
        num_buckets: int,
        *,
        eval_fn=None,
        eval_batch=None,
        strict: bool = True,
        max_events: int = 100_000,
    ) -> list[dict]:
        """Fixed-grid twin of ``run_events``: arrivals grouped into
        ``num_buckets`` uniform time buckets instead of event segments.
        History rows equal ``run``'s; the aggregation matches to float
        tolerance whenever each bucket holds at most one arrival. The
        guards raise for grids too coarse to be faithful; ``strict=False``
        merges colliding fedasync arrivals through composed weights (exact
        aggregation, mid-bucket redispatch approximated). Prefer
        ``run_events``."""
        if self.cfg.barrier:
            raise ValueError(
                "the barrier (cycle-gated) regime's kernel path is "
                "Orchestrator.run_fused; run_bucketed is the event-driven path"
            )
        if num_buckets < 1:
            raise ValueError("num_buckets must be >= 1")
        sched = self._schedule(train, horizon, max_events)

        h = num_buckets
        width = horizon / h
        buckets: list[list[_Arrival]] = [[] for _ in range(h)]
        for a in sched.arrivals:
            if a.flush_id < 0:
                continue   # never-flushed trailing buffer: unobservable
            buckets[min(int(a.t / width), h - 1)].append(a)

        # guards: configurations the grid cannot represent at all
        for b, evs in enumerate(buckets):
            learners = [a.learner for a in evs]
            if len(set(learners)) < len(learners):
                raise ValueError(
                    f"bucket {b} holds two arrivals of the same learner — "
                    "its second task would need training before the bucket "
                    "ends; increase num_buckets"
                )
            if strict and len(evs) > 1:
                raise ValueError(
                    f"bucket {b} holds {len(evs)} arrivals; increase "
                    "num_buckets for an exact replay, pass strict=False "
                    "to merge them (exact aggregation via composed weights; "
                    "mid-bucket redispatches then see the bucket-end "
                    "server), or use run_events (exact without a grid)"
                )
            if self.cfg.mode == "buffered":
                tie = len({a.t for a in evs}) < len(evs)
                remedy = (
                    "arrival times tie exactly, so NO grid separates them "
                    "— use run_events (event-indexed segments replay tied "
                    "buffered schedules exactly)"
                    if tie else "increase num_buckets (or use run_events)"
                )
                nflush = sum(a.flush for a in evs)
                if nflush > 1:
                    raise ValueError(
                        f"bucket {b} holds {nflush} buffer flushes; {remedy}"
                    )
                if nflush == 1 and not evs[-1].flush:
                    raise ValueError(
                        f"a buffer flush splits bucket {b} (arrivals of "
                        f"the next group share it); {remedy}"
                    )

        return self._run_groups(buckets, sched, train, eval_fn=eval_fn,
                                eval_batch=eval_batch)


# ---------------------------------------------------------------------------
# the grouped executor
# ---------------------------------------------------------------------------

def _compose_group_row(evs, mode: str):
    """Per-group flush coefficients: the composed keep factor, the flush
    flag, and one contraction weight per arrival (arrival order).
    fedasync groups compose their sequential mixes into one contraction
    server' = prod(1-b_i) server + sum_i b_i prod_{j>i}(1-b_j) w_i — for
    single-arrival groups (always, on the jagged path) the schedule's own
    per-arrival coefficients, bitwise."""
    if mode == "fedasync":
        betas = np.array([a.weight for a in evs])
        suffix = np.cumprod((1.0 - betas)[::-1])[::-1]
        comp = betas * np.concatenate([suffix[1:], [1.0]])
        return float(suffix[0]), 1.0, comp
    comp = np.array([a.weight for a in evs])
    if evs[-1].flush:
        return float(evs[-1].keep), 1.0, comp
    return 1.0, 0.0, comp


@dataclasses.dataclass
class _Staged:
    """What a grouped run stages from its schedule, per step i and row j
    (a learner, or an arrival slot under ``seg_batch``): shard index rows
    ``idx`` (n, R, d_cap) into the training set with their mask ``m``,
    ``tau``/``w`` (n, R), ``keep``/``flush`` (n,), the learner of each row
    ``ids`` (n, R), and per learner which redispatch it takes: ``post``
    (the post-flush server) or ``pre`` (the step's incoming server),
    (n, K) bool."""

    idx: np.ndarray
    m: np.ndarray
    tau: np.ndarray
    w: np.ndarray
    keep: np.ndarray
    flush: np.ndarray
    ids: np.ndarray
    post: np.ndarray
    pre: np.ndarray


def _stage_groups(groups, *, mode: str, k_fleet: int, d_cap: int, slots) -> _Staged:
    """Stage one step per event group: over the K learner rows (``slots``
    None; row j is learner j) or over ``slots`` arrival slots with a
    slot-to-learner map. Padding rows index sample 0 with tau = 0, weight 0
    and mask 0: masked rows add exactly 0 to every gradient."""
    n = len(groups)
    rows = k_fleet if slots is None else slots
    st = _Staged(
        idx=np.zeros((n, rows, d_cap), np.int64),
        m=np.zeros((n, rows, d_cap), np.float32),
        tau=np.zeros((n, rows), np.int32),
        w=np.zeros((n, rows), np.float32),
        keep=np.ones(n, np.float32),
        flush=np.zeros(n, np.float32),
        ids=(np.broadcast_to(np.arange(k_fleet, dtype=np.int64), (n, k_fleet)).copy()
             if slots is None else np.zeros((n, rows), np.int64)),
        post=np.zeros((n, k_fleet), bool),
        pre=np.zeros((n, k_fleet), bool),
    )
    for i, evs in enumerate(groups):
        if not evs:
            continue
        st.keep[i], st.flush[i], comp = _compose_group_row(evs, mode)
        for j, (a, w_a) in enumerate(zip(evs, comp)):
            r = a.learner if slots is None else j
            st.ids[i, r] = a.learner
            st.w[i, r] = w_a
            st.tau[i, r] = a.tau
            st.idx[i, r, : a.d] = a.idx
            st.m[i, r, : a.d] = 1.0
            # a timer-flush closer redispatched BEFORE the timer fired, so it
            # takes the pre-flush server like any accumulate upload; only
            # arrival-triggered closers see the post-flush server
            if a.flush and not a.timer_flush:
                st.post[i, a.learner] = True
            else:
                st.pre[i, a.learner] = True
    return st


_STAGING_CACHE: "dict[tuple, tuple]" = {}
_STAGING_STATS = {"stages": 0, "hits": 0}
_STAGING_CACHE_MAX = 4


def staging_cache_stats() -> dict:
    """Copy of the group-staging cache counters."""
    return dict(_STAGING_STATS)


def clear_staging_cache() -> None:
    _STAGING_CACHE.clear()
    _STAGING_STATS["stages"] = 0
    _STAGING_STATS["hits"] = 0


def _schedule_digest(groups, *, mode: str, k_fleet: int, d_cap: int,
                     seg_batch) -> str:
    """Digest of everything the staged arrays depend on: the staging
    geometry and, per arrival, the fields the staging reads."""
    h = hashlib.sha1()
    h.update(repr((mode, k_fleet, d_cap, seg_batch)).encode())
    for i, evs in enumerate(groups):
        h.update(b"|g%d" % i)
        for a in evs:
            h.update(repr((a.learner, int(a.tau), int(a.d), float(a.weight),
                           bool(a.flush), bool(a.timer_flush),
                           float(a.keep))).encode())
            h.update(np.ascontiguousarray(a.idx).tobytes())
    return h.hexdigest()


def _staged_group_arrays(groups, train: Dataset, *, mode: str, k_fleet: int,
                         d_cap: int, seg_batch) -> _Staged:
    """The staging of a grouped run, cached on (dataset identity, schedule
    digest): replays of one schedule (sweeps, golden-trace replays) stage
    once."""
    key = (id(train), _schedule_digest(groups, mode=mode, k_fleet=k_fleet,
                                       d_cap=d_cap, seg_batch=seg_batch))
    hit = _STAGING_CACHE.get(key)
    # the entry pins the dataset object, so its id cannot be recycled
    # while the entry lives
    if hit is not None and hit[0] is train:
        _STAGING_STATS["hits"] += 1
        return hit[1]
    _STAGING_STATS["stages"] += 1
    staged = _stage_groups(groups, mode=mode, k_fleet=k_fleet, d_cap=d_cap,
                           slots=seg_batch)
    while len(_STAGING_CACHE) >= _STAGING_CACHE_MAX:
        _STAGING_CACHE.pop(next(iter(_STAGING_CACHE)))
    _STAGING_CACHE[key] = (train, staged)
    return staged


def _redispatch(old, post, new_post, pre, new_pre):
    """A (K, ...) dispatch leaf after a step: the post-flush server where
    ``post``, the step's incoming server where ``pre``, else unchanged."""
    shape = (-1,) + (1,) * new_post.dim()
    return torch.where(post.reshape(shape), new_post[None],
                       torch.where(pre.reshape(shape), new_pre[None], old))


def _run_group_program(params, groups, sched: _Schedule, train: Dataset, *,
                       mode: str, lr: float, num_learners: int, loss_fn,
                       eval_fn, eval_batch, seg_batch=None):
    """Replay a schedule's event groups, one ``ops.train_agg_step`` call
    (async form) per non-empty group, and rebuild the history rows — the
    shared back half of ``run_events`` (jagged segments) and
    ``run_bucketed`` (grid buckets). Returns ``(params, history)``.

    Per group: the fleet's carried dispatch models train (masked, each
    learner to its own tau), the group's arrivals fold into the
    accumulator, the flush (if any) applies, and the redispatch is split by
    mask: flush arrivals take the post-flush server, the other arrivals
    (buffered accumulate uploads, timer-flush closers) the group's incoming
    server. Empty groups are skipped on the host. fedasync groups of
    several arrivals (grid ``strict=False`` merging) compose their mixes
    into one contraction; the post-step accuracy is attributed to the
    group's last flush row.

    ``seg_batch`` sub-batches each group into chunks of at most that many
    arrivals, trained over arrival slots gathered out of the (K, ...)
    carry: prefix chunks accumulate only, the closing chunk flushes."""
    if loss_fn is not mlp.loss:
        raise ValueError("the grouped path trains mlp.loss only; use run() for "
                         "another loss function")
    if eval_fn is not None and eval_batch is None:
        raise ValueError("eval_fn needs eval_batch=(x, y)")
    if seg_batch is not None:
        if seg_batch < 1:
            raise ValueError("seg_batch must be >= 1")
        groups = [evs[j: j + seg_batch]
                  for evs in groups
                  for j in range(0, max(len(evs), 1), seg_batch)]
    k_fleet = num_learners
    st = _staged_group_arrays(groups, train, mode=mode, k_fleet=k_fleet,
                              d_cap=sched.d_cap, seg_batch=seg_batch)

    dev = _device_of(params)
    if eval_fn is not None:
        ex, ey = (torch.as_tensor(a, device=dev) for a in eval_batch)
    # the training set goes to the device once; each step gathers its shards
    tx = torch.from_numpy(train.x).to(dev)
    ty = torch.from_numpy(np.asarray(train.y, np.int32)).to(dev)
    idx, m, tau, w, ids, post, pre = (
        torch.from_numpy(a).to(dev)
        for a in (st.idx, st.m, st.tau, st.w, st.ids, st.post, st.pre))

    server = params
    disp = [{n: leaf.expand((k_fleet,) + leaf.shape) for n, leaf in layer.items()}
            for layer in params]
    acc = [{n: torch.zeros_like(leaf) for n, leaf in layer.items()} for layer in params]
    accs: dict[int, torch.Tensor] = {}
    for i, evs in enumerate(groups):
        if not evs:
            continue
        start = disp if seg_batch is None else [
            {n: leaf.index_select(0, ids[i]) for n, leaf in layer.items()}
            for layer in disp]
        server1, acc = ops.train_agg_step(
            start, tx[idx[i]], ty[idx[i]], m[i], tau[i], w[i], lr,
            max_tau=max(int(st.tau[i].max()), 1), server=server, acc=acc,
            keep=float(st.keep[i]), flush=float(st.flush[i]),
        )
        disp = [{n: _redispatch(leaf, post[i], server1[l][n], pre[i], server[l][n])
                 for n, leaf in layer.items()} for l, layer in enumerate(disp)]
        server = server1
        # only flush steps' accuracies are read back
        if eval_fn is not None and st.flush[i] > 0:
            accs[i] = eval_fn(server, ex, ey)
    read = {i: float(a) for i, a in accs.items()}

    history: list[dict] = []
    group: list[_Arrival] = []
    for i, evs in enumerate(groups):
        flushes = [a for a in evs if a.flush]
        for a in evs:
            group.append(a)
            if a.flush:
                rec = _flush_row(a, group, mode)
                if eval_fn is not None and a is flushes[-1]:
                    rec["accuracy"] = read[i]
                history.append(rec)
                group = []
    return server, history


def summarize_async_history(history: list[dict], *,
                            counters: dict | None = None,
                            energy: dict | None = None) -> dict:
    """Fleet-level summary of an async run: the version-staleness profile
    (mean/max and p50/p90/p99) over all aggregated uploads, aggregation
    counts, the virtual time span, the fault tallies (pass
    ``engine.fault_counters``; every ``FAULT_COUNTERS`` key is present) and
    the joule ledger (pass ``engine.energy_ledger``; all keys present,
    zeros without an energy model)."""
    stal: list[int] = []
    joules: list[float] = []
    for rec in history:
        stal.extend(rec.get("staleness_list", [0] * len(rec["learners"])))
        joules.extend(np.atleast_1d(rec.get("energy", [])).tolist())
    jarr = np.asarray(joules, np.float64)
    ledger = energy or {}
    per_learner = ledger.get("per_learner")
    return {
        "aggregations": len(history),
        "uploads": int(sum(len(r["learners"]) for r in history)),
        "virtual_time": float(history[-1]["t"]) if history else 0.0,
        "staleness": version_staleness_profile(np.asarray(stal)),
        "final_accuracy": history[-1].get("accuracy") if history else None,
        "faults": {**_zero_fault_counters(), **(counters or {})},
        "energy": {
            "joules_total": float(jarr.sum()) if jarr.size else 0.0,
            "joules_p50": float(np.percentile(jarr, 50)) if jarr.size else 0.0,
            "joules_p99": float(np.percentile(jarr, 99)) if jarr.size else 0.0,
            "per_learner": (np.asarray(per_learner, np.float64)
                            if per_learner is not None else None),
            "violations": int(ledger.get("violations", 0)),
        },
    }
