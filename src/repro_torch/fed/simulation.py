"""The end-to-end MEL experiment (the paper's Figs. 2-3), in torch.

Builds the 802.11 indoor environment, derives the time-model coefficients
from the paper's MNIST-DNN constants (S_m = 8,974,080 bits,
C_m = 1,123,736 FLOPs/sample), allocates with the requested scheme, and
runs federated training on synthetic MNIST-class data — the port of
``repro/fed/simulation.py``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (
    AllocationProblem,
    BatchedProblems,
    CapacityDrift,
    EnergyModel,
    MarkovAvailability,
    TimeModel,
    batched_avg_staleness,
    batched_max_staleness,
    indoor_80211_profile,
    mnist_dnn_cost,
    solve_energy_batched,
    solve_eta_batched,
    solve_kkt_batched,
)
from repro_torch.data.pipeline import Dataset, synthetic_mnist
from repro_torch.fed.async_engine import AsyncConfig, AsyncFedEngine, summarize_async_history
from repro_torch.fed.multimodel import MultiModelEngine
from repro_torch.fed.orchestrator import MELConfig, Orchestrator, _solver
from repro_torch.models import mlp

__all__ = [
    "async_mode_sweep",
    "build_energy_problem",
    "build_problem",
    "build_spread_problem",
    "churn_sweep",
    "drift_staleness_sweep",
    "energy_sweep",
    "fleet_scale_sweep",
    "laggard_time_to_accuracy",
    "multi_model_sweep",
    "run_async_experiment",
    "run_experiment",
    "staleness_sweep",
]


def build_problem(
    k: int,
    T: float,
    *,
    total_samples: int = 6000,
    d_lower_frac: float = 0.25,
    d_upper_frac: float = 3.0,
    seed: int = 0,
) -> AllocationProblem:
    cost = mnist_dnn_cost()
    profiles = indoor_80211_profile(k, seed=seed)
    tm = TimeModel.build(
        profiles,
        model_complexity_flops=cost.flops_per_sample,
        model_size_bits=cost.model_bits,
    )
    d_l = max(1, int(d_lower_frac * total_samples / k))
    d_u = min(total_samples, int(d_upper_frac * total_samples / k))
    return AllocationProblem(
        time_model=tm, T=T, total_samples=total_samples, d_lower=d_l, d_upper=d_u
    )


def build_spread_problem(
    k: int = 3, T: float = 6.0, *, total_samples: int = 60,
) -> AllocationProblem:
    """A small (K <= 5) fleet whose integer-rounded cycle times land well
    apart — the regime where the async engine's exact bucket grid stays
    small and local training stays cheap. The KKT allocator equalizes
    relaxed finish times, so the spread comes from the integer tau
    rounding: the coefficients are hand-picked to make that slack differ
    per learner."""
    if not (1 <= k <= 5):
        raise ValueError("the hand-tuned spread fleet has at most 5 learners")
    c2 = np.array([0.050, 0.031, 0.022, 0.045, 0.027])[:k]
    c1 = np.array([0.004, 0.006, 0.003, 0.005, 0.002])[:k]
    c0 = np.array([0.40, 0.55, 0.30, 0.25, 0.45])[:k]
    return AllocationProblem(
        time_model=TimeModel(c2=c2, c1=c1, c0=c0), T=T,
        total_samples=total_samples,
        d_lower=max(1, total_samples // (2 * k)),
        d_upper=min(total_samples, 2 * total_samples // k),
    )


_BATCHED_SCHEMES = {
    "kkt_sai": solve_kkt_batched,
    "eta": solve_eta_batched,
    "kkt_energy": solve_energy_batched,
}
_INFEASIBLE = "infeasible: even with tau=0 the deadline T cannot absorb d samples"


def staleness_sweep(ks, T: float, *, schemes=("kkt_sai", "slsqp", "eta"),
                    seed: int = 0, total_samples: int = 6000, seeds=None,
                    device=None) -> list[dict]:
    """Fig. 2: max/avg staleness vs number of learners K per scheme.

    Every (K, seed) fleet is padded into one ``BatchedProblems`` and each
    batched scheme (kkt_sai, eta, kkt_energy) is ONE ``solve_*_batched``
    call on ``device`` (``None``: the card) for the whole sweep; the other
    schemes (slsqp, pgd, sync) use their per-problem solvers, and an
    unknown scheme raises ``KeyError``. The time-varying sweep is
    ``drift_staleness_sweep``.
    """
    for scheme in schemes:
        if scheme not in _BATCHED_SCHEMES:
            _solver(scheme)
    seeds = (seed,) if seeds is None else tuple(seeds)
    cases = [(k, s) for k in ks for s in seeds]
    probs = [build_problem(k, T, seed=s, total_samples=total_samples) for k, s in cases]

    rows: list[dict] = []
    batched = {}
    bp = BatchedProblems.from_problems(probs)
    for scheme in schemes:
        if scheme in _BATCHED_SCHEMES:
            ba = _BATCHED_SCHEMES[scheme](bp, device=device)
            batched[scheme] = (ba, ba.summary(bp))

    for i, ((k, s), prob) in enumerate(zip(cases, probs)):
        for scheme in schemes:
            row = {"K": k, "T": T, "scheme": scheme}
            if len(seeds) > 1:
                row["seed"] = s
            if scheme in batched:
                ba, summ = batched[scheme]
                if not ba.feasible[i]:
                    row["error"] = _INFEASIBLE
                else:
                    row.update(
                        max_staleness=int(summ["max_staleness"][i]),
                        avg_staleness=float(summ["avg_staleness"][i]),
                        total_updates=int(summ["total_updates"][i]),
                    )
                rows.append(row)
                continue
            try:
                sm = _solver(scheme, device)(prob).summary(prob)
                row.update(
                    max_staleness=sm["max_staleness"],
                    avg_staleness=sm["avg_staleness"],
                    total_updates=sm["total_updates"],
                )
            except ValueError as e:
                row["error"] = str(e)
            rows.append(row)
    return rows


def drift_staleness_sweep(ks, T: float, *, cycles: int = 8,
                          drift: CapacityDrift | None = None,
                          schemes=("kkt_sai", "eta"), seed: int = 0,
                          total_samples: int = 6000, seeds=None,
                          device=None) -> list[dict]:
    """Adaptive-vs-static staleness under time-varying edge capacities.

    For every (K, seed) fleet the drifted capacity path (C cycles) is
    scored two ways per scheme:

      * ``mode="adaptive"`` — the allocation is re-solved on each cycle's
        true capacities; ALL case x cycle problems are padded into ONE
        mixed-K ``BatchedProblems`` and solved with a single
        ``solve_*_batched`` call per scheme on ``device`` (``None``: the
        card);
      * ``mode="static"`` — the allocation is solved once on the base
        capacities and frozen; each cycle's realized tau_k is the largest
        integer feasible under that cycle's true capacities with the frozen
        d_k.

    Rows report mean/worst max-staleness and mean avg-staleness over the C
    cycles. Ported schemes without a batched engine (``sync``) get error
    rows; a scheme the port lacks raises ``KeyError``.
    """
    drift = CapacityDrift(seed=seed) if drift is None else drift
    seeds_ = (seed,) if seeds is None else tuple(seeds)
    cases = [(k, s) for k in ks for s in seeds_]
    probs = [build_problem(k, T, seed=s, total_samples=total_samples) for k, s in cases]
    unsupported = [s for s in schemes if s not in _BATCHED_SCHEMES]
    for scheme in unsupported:
        _solver(scheme)
    schemes = [s for s in schemes if s in _BATCHED_SCHEMES]
    n = len(cases)
    kmax = max(p.num_learners for p in probs)

    # one (n * cycles, kmax) batch holding every drifted cycle-problem
    paths = [drift.coefficient_path(p.time_model, cycles) for p in probs]
    b = n * cycles
    c2 = np.ones((b, kmax)); c1 = np.ones((b, kmax)); c0 = np.zeros((b, kmax))
    d_lo = np.zeros((b, kmax)); d_hi = np.zeros((b, kmax))
    valid = np.zeros((b, kmax), bool)
    Tb = np.full(b, T); total = np.full(b, total_samples, np.int64)
    for i, (p, (c2s, c1s, c0s)) in enumerate(zip(probs, paths)):
        kk = p.num_learners
        rows = slice(i * cycles, (i + 1) * cycles)
        c2[rows, :kk], c1[rows, :kk], c0[rows, :kk] = c2s, c1s, c0s
        d_lo[rows, :kk] = p.d_lower
        d_hi[rows, :kk] = p.d_upper
        valid[rows, :kk] = True
    bp_drift = BatchedProblems(c2, c1, c0, Tb, total, d_lo, d_hi, valid)
    bp_base = BatchedProblems.from_problems(probs)

    out: list[dict] = []
    for scheme in unsupported:
        for (k, s) in cases:
            row = {"K": k, "T": T, "scheme": scheme, "cycles": cycles,
                   "error": (f"scheme {scheme!r} has no batched engine; the "
                             "drift sweep supports "
                             + " | ".join(sorted(_BATCHED_SCHEMES)))}
            if len(seeds_) > 1:
                row["seed"] = s
            out.append(row)
    for scheme in schemes:
        solver = _BATCHED_SCHEMES[scheme]
        ba = solver(bp_drift, device=device)
        summ = ba.summary(bp_drift)
        ba_static = solver(bp_base, device=device)
        for i, ((k, s), p, (c2s, c1s, c0s)) in enumerate(zip(cases, probs, paths)):
            rows = slice(i * cycles, (i + 1) * cycles)
            base = {"K": k, "T": T, "scheme": scheme, "cycles": cycles}
            if len(seeds_) > 1:
                base["seed"] = s
            if not ba.feasible[rows].all() or not ba_static.feasible[i]:
                out.append({**base, "error": _INFEASIBLE})
                continue
            smax = summ["max_staleness"][rows]
            savg = summ["avg_staleness"][rows]
            out.append({
                **base, "mode": "adaptive",
                "max_staleness_mean": float(smax.mean()),
                "max_staleness_worst": int(smax.max()),
                "avg_staleness_mean": float(savg.mean()),
                "total_updates_mean": float(summ["total_updates"][rows].mean()),
            })
            # frozen allocation, realized tau under each cycle's true caps:
            # a (C, K)-broadcast TimeModel reuses max_tau's clamp semantics
            kk = p.num_learners
            d0 = ba_static.d[i, :kk].astype(float)
            tau_c = TimeModel(c2=c2s, c1=c1s, c0=c0s).max_tau(
                np.broadcast_to(d0, c2s.shape), T)
            smax_s = batched_max_staleness(tau_c)
            savg_s = batched_avg_staleness(tau_c)
            upd = (tau_c * d0[None]).sum(axis=1)
            out.append({
                **base, "mode": "static",
                "max_staleness_mean": float(smax_s.mean()),
                "max_staleness_worst": int(smax_s.max()),
                "avg_staleness_mean": float(savg_s.mean()),
                "total_updates_mean": float(upd.mean()),
            })
    return out


def run_experiment(
    *,
    k: int = 10,
    T: float = 15.0,
    cycles: int = 12,
    scheme: str = "kkt_sai",
    aggregation: str = "staleness",
    total_samples: int = 6000,
    lr: float = 0.1,
    seed: int = 0,
    train: Dataset | None = None,
    test: Dataset | None = None,
    fused: bool = False,
    reallocate: bool = False,
    drift=None,
    device=None,
) -> dict:
    """One full MEL run; returns history with accuracy per global cycle.

    ``fused=True`` runs each cycle through the train+aggregate kernels
    (``Orchestrator.run_fused``) and gives the eager history for the same
    seed, to float32 tolerance. ``reallocate=True`` re-solves the
    allocation every cycle through the batched solver (the water-filling
    kernel on the card); pass a ``CapacityDrift`` or ``QueueDrift`` to make
    the re-solve follow time-varying capacities. ``drift`` without
    ``reallocate`` is ignored with a warning (the run simulates the base
    capacities). ``device=None`` means the card.
    """
    device = resolve_device(device)
    if train is None or test is None:
        train, test = synthetic_mnist(max(total_samples * 2, 12_000), seed=seed)
    prob = build_problem(k, T, total_samples=total_samples, seed=seed)
    mel = MELConfig(
        T=T, total_samples=total_samples, lr=lr, scheme=scheme, aggregation=aggregation
    )
    params = mlp.init(seed, device=device)
    orch = Orchestrator(mel, prob, mlp.loss, params, seed=seed, drift=drift)
    ex = torch.from_numpy(test.x[:2000]).to(device)
    ey = torch.from_numpy(test.y[:2000]).to(device)

    if fused:
        history = orch.run(
            train, cycles, fused=True, eval_fn=mlp.accuracy,
            eval_batch=(ex, ey), reallocate=reallocate,
        )
    else:
        history = orch.run(train, cycles, eval_fn=lambda p: mlp.accuracy(p, ex, ey),
                           reallocate=reallocate)
    return {
        "scheme": scheme,
        "K": k,
        "T": T,
        "history": history,
        "final_accuracy": history[-1]["accuracy"],
        "allocation": orch.allocation.summary(prob),
    }


# ---------------------------------------------------------------------------
# event-driven asynchronous federation (fed.async_engine)
# ---------------------------------------------------------------------------

def run_async_experiment(
    *,
    k: int = 6,
    T: float = 10.0,
    cycles: int = 6,
    mode: str = "fedasync",
    scheme: str = "kkt_sai",
    aggregation: str = "staleness",
    total_samples: int = 2000,
    lr: float = 0.1,
    seed: int = 0,
    drift=None,
    reallocate: bool = False,
    alpha: float = 0.6,
    staleness_fn: str = "poly",
    buffer_size: int = 0,
    bucketed: bool = False,
    num_buckets: int = 0,
    strict: bool = True,
    train: Dataset | None = None,
    test: Dataset | None = None,
    problem=None,
    max_events: int = 100_000,
    faults: dict | None = None,
    device=None,
) -> dict:
    """One event-driven async MEL run to virtual time ``cycles * T``.

    ``mode`` selects the server: ``"cycle"`` is the paper's cycle-gated
    scheme as the engine's barrier regime (buffered, M = K),
    ``"fedasync"`` mixes per upload with version-staleness discounting,
    ``"buffered"`` flushes a size-M buffer (default M = K/2, min 2).
    ``bucketed=True`` (event modes only) runs the grouped kernel path:
    ``num_buckets=0`` the event-indexed ``run_events``, ``num_buckets > 0``
    the fixed grid ``run_bucketed``; otherwise the eager ``run``. Pass
    ``problem`` to replace the MNIST-constants fleet (``build_problem``).
    ``drift`` takes a ``CapacityDrift`` or a state-coupled ``QueueDrift``
    (``reallocate=True`` required). ``faults`` forwards fault knobs
    (``drop_rate``, ``straggler_rate``, ``deadline``, ``quorum``, ... — see
    ``AsyncConfig``) into the config; the summary's ``"faults"`` holds the
    schedule's counters. ``device=None`` means the card.
    """
    device = resolve_device(device)
    if problem is None:
        problem = build_problem(k, T, total_samples=total_samples, seed=seed)
    else:
        k, T = problem.num_learners, problem.T
        total_samples = problem.total_samples
    # dataset sizing follows the resolved per-cycle budget
    if train is None or test is None:
        train, test = synthetic_mnist(max(total_samples * 2, 12_000), seed=seed)
    horizon = cycles * T
    common = dict(scheme=scheme, aggregation=aggregation, lr=lr,
                  reallocate=reallocate, **(faults or {}))
    if mode == "cycle":
        cfg = AsyncConfig(mode="buffered", barrier=True, **common)
    elif mode == "buffered":
        cfg = AsyncConfig(
            mode="buffered", alpha=alpha, staleness_fn=staleness_fn,
            buffer_size=buffer_size or max(2, k // 2), **common,
        )
    else:
        cfg = AsyncConfig(mode=mode, alpha=alpha, staleness_fn=staleness_fn, **common)
    params = mlp.init(seed, device=device)
    eng = AsyncFedEngine(cfg, problem, mlp.loss, params, seed=seed, drift=drift)
    eval_batch = (torch.from_numpy(test.x[:2000]).to(device),
                  torch.from_numpy(test.y[:2000]).to(device))
    if bucketed:
        if mode == "cycle":
            raise ValueError(
                "mode='cycle' is the barrier regime: its kernel path is "
                "Orchestrator.run_fused (run_experiment(fused=True)); "
                "bucketed=True applies to the event-driven modes"
            )
        if num_buckets:
            history = eng.run_bucketed(
                train, horizon, num_buckets, eval_fn=mlp.accuracy,
                eval_batch=eval_batch, strict=strict, max_events=max_events,
            )
        else:
            history = eng.run_events(
                train, horizon, eval_fn=mlp.accuracy, eval_batch=eval_batch,
                max_events=max_events,
            )
    else:
        history = eng.run(
            train, horizon, eval_fn=mlp.accuracy, eval_batch=eval_batch,
            max_events=max_events,
        )
    summary = summarize_async_history(
        history, counters=eng.fault_counters, energy=eng.energy_ledger
    )
    return {
        "mode": mode,
        "scheme": scheme,
        "K": k,
        "T": T,
        "cycles": cycles,
        "bucketed": bucketed,
        "history": history,
        "summary": summary,
        "final_accuracy": summary["final_accuracy"],
        "accuracy_trace": [
            (round(float(r["t"]), 3), round(float(r["accuracy"]), 4))
            for r in history if "accuracy" in r
        ],
    }


def async_mode_sweep(
    ks,
    T: float,
    *,
    cycles: int = 6,
    modes=("cycle", "fedasync", "buffered"),
    drift=None,
    scheme: str = "kkt_sai",
    seed: int = 0,
    total_samples: int = 2000,
    reallocate: bool = True,
    alpha: float = 0.6,
    staleness_fn: str = "poly",
    problem=None,
    train: Dataset | None = None,
    test: Dataset | None = None,
    device=None,
) -> list[dict]:
    """The paper's cycle-gated scheme against FedAsync and buffered
    aggregation at equal virtual time (``cycles * T`` seconds) under
    time-varying capacities: per (K, mode), final accuracy, the
    version-staleness profile and the aggregation/upload counts.
    ``drift`` defaults to ``CapacityDrift(seed=seed)``; ``reallocate=False``
    freezes every mode's allocation at the base capacities. An infeasible
    case gives an error row, as in the reference."""
    drift = CapacityDrift(seed=seed) if drift is None else drift
    rows: list[dict] = []
    for k in np.atleast_1d(ks):
        for mode in modes:
            try:
                res = run_async_experiment(
                    k=int(k), T=T, cycles=cycles, mode=mode, scheme=scheme,
                    seed=seed, total_samples=total_samples, drift=drift,
                    reallocate=reallocate, alpha=alpha,
                    staleness_fn=staleness_fn, problem=problem,
                    train=train, test=test, device=device,
                )
            except ValueError as e:
                rows.append({"K": int(k), "T": T, "mode": mode,
                             "cycles": cycles, "error": str(e)})
                continue
            s = res["summary"]
            rows.append({
                "K": res["K"],      # a problem= override resolves K and T
                "T": res["T"],
                "mode": mode,
                "cycles": cycles,
                "scheme": scheme,
                "reallocate": reallocate,
                "final_accuracy": res["final_accuracy"],
                "aggregations": s["aggregations"],
                "uploads": s["uploads"],
                "virtual_time": s["virtual_time"],
                "staleness_mean": s["staleness"]["mean"],
                "staleness_max": s["staleness"]["max"],
                "accuracy_trace": res["accuracy_trace"][:40],
            })
    return rows


def churn_sweep(
    drop_rates=(0.0, 0.2, 0.4),
    *,
    mode: str = "buffered",
    cycles: int = 10,
    seed: int = 0,
    policies=("adaptive", "static", "equal"),
    problem=None,
    train: Dataset | None = None,
    test: Dataset | None = None,
    device=None,
) -> list[dict]:
    """Adaptive KKT reallocation against frozen and equal allocation as the
    fleet churns: one event-driven run per (dropout rate, policy) cell under
    a compound fault schedule, at equal virtual time.

    Each ``rate`` drives both the availability chain
    (``MarkovAvailability(p_drop=rate)``: learners go offline between
    blocks) and upload loss (``drop_rate = rate / 2``), over a fixed
    straggler / delay / deadline-retry background and, in buffered mode, a
    quorum of 2 with graceful degradation. Policies: ``"adaptive"``
    re-solves the masked KKT allocation per drift block, ``"static"``
    freezes the base KKT solve (dispatched whenever a learner is online),
    ``"equal"`` re-solves the equal-task baseline per block. Every cell
    runs the grouped kernel path (``run_events``) on ``device`` (``None``:
    the card) and reports accuracy, staleness quantiles and the schedule's
    fault counters.
    """
    prob = problem or build_spread_problem(k=4, total_samples=80)
    k, T = prob.num_learners, prob.T
    if train is None or test is None:
        train, test = synthetic_mnist(6000, seed=seed)
    policy_kw = {
        "adaptive": dict(scheme="kkt_sai", reallocate=True),
        "static": dict(scheme="kkt_sai", reallocate=False),
        "equal": dict(scheme="eta", reallocate=True),
    }
    rows: list[dict] = []
    for rate in drop_rates:
        availability = MarkovAvailability(p_drop=float(rate), p_join=0.5, seed=seed)
        faults = dict(
            drop_rate=float(rate) / 2,
            straggler_rate=0.2, straggler_factor=3.0,
            delay_rate=0.2, delay_mean=0.5 * T,
            deadline=2.5 * T, retry_backoff=0.25 * T, retry_backoff_cap=T,
        )
        if mode == "buffered":
            faults.update(quorum=2, flush_timeout=1.5 * T)
        for policy in policies:
            res = run_async_experiment(
                mode=mode, cycles=cycles, seed=seed, problem=prob,
                train=train, test=test, drift=availability,
                buffer_size=min(3, k), bucketed=True, faults=faults,
                device=device, **policy_kw[policy],
            )
            s = res["summary"]
            rows.append({
                "K": k,
                "T": T,
                "mode": mode,
                "cycles": cycles,
                "drop_rate": float(rate),
                "policy": policy,
                "final_accuracy": res["final_accuracy"],
                "aggregations": s["aggregations"],
                "uploads": s["uploads"],
                "virtual_time": s["virtual_time"],
                "staleness_mean": s["staleness"]["mean"],
                "staleness_p50": s["staleness"]["p50"],
                "staleness_p90": s["staleness"]["p90"],
                "staleness_p99": s["staleness"]["p99"],
                "staleness_max": s["staleness"]["max"],
                "faults": s["faults"],
            })
    return rows


def build_energy_problem(
    k: int,
    T: float,
    *,
    total_samples: int = 2000,
    d_lower_frac: float = 0.25,
    d_upper_frac: float = 3.0,
    e_budget=None,
    seed: int = 0,
) -> AllocationProblem:
    """``build_problem`` with the matching per-cycle ``EnergyModel``
    attached: the same 802.11 profiles and MNIST-DNN constants feed the time
    model (Eq. 5) and its energy mirror. ``e_budget=None`` attaches the
    model for accounting only (any scheme may run); a finite budget makes
    the problem strict, solvable only by the energy-aware schemes
    (``kkt_energy``, the budgeted ``pgd``)."""
    cost = mnist_dnn_cost()
    profiles = indoor_80211_profile(k, seed=seed)
    tm = TimeModel.build(
        profiles,
        model_complexity_flops=cost.flops_per_sample,
        model_size_bits=cost.model_bits,
    )
    em = EnergyModel.build(
        profiles,
        model_complexity_flops=cost.flops_per_sample,
        model_size_bits=cost.model_bits,
    )
    d_l = max(1, int(d_lower_frac * total_samples / k))
    d_u = min(total_samples, int(d_upper_frac * total_samples / k))
    return AllocationProblem(
        time_model=tm, T=T, total_samples=total_samples,
        d_lower=d_l, d_upper=d_u, energy=em, e_budget=e_budget,
    )


def energy_sweep(
    budget_fracs=(0.5, 0.75, 1.0),
    *,
    k: int = 4,
    T: float = 10.0,
    cycles: int = 8,
    mode: str = "fedasync",
    schemes=("kkt_energy", "kkt_sai", "eta"),
    total_samples: int = 800,
    seed: int = 0,
    train: Dataset | None = None,
    test: Dataset | None = None,
    device=None,
) -> list[dict]:
    """Accuracy-vs-energy frontier: the budgeted KKT allocation against the
    energy-blind schemes across per-learner budgets, at equal virtual time,
    on ``device`` (``None``: the card).

    The budget axis is anchored to the fleet's own unconstrained spend: the
    blind ``kkt_sai`` allocation's per-learner cycle energies ``E0`` set the
    scale, and each level dispatches under the uniform budget
    ``frac * median(E0)`` joules per cycle. The energy-aware schemes solve
    with the budget (every re-dispatch through the budgeted policy) and
    report zero violations by construction; the blind schemes run on the
    same fleet with the energy model attached for accounting only, and
    their overruns are counted against the same budget from the
    per-dispatch joules in the history."""
    prob_free = build_energy_problem(k, T, total_samples=total_samples, seed=seed)
    em = prob_free.energy
    alloc0 = _solver("kkt_sai")(prob_free)
    e_blind = em.cycle_energy(alloc0.tau, alloc0.d)
    if train is None or test is None:
        train, test = synthetic_mnist(max(total_samples * 2, 12_000), seed=seed)
    rows: list[dict] = []
    for frac in budget_fracs:
        eb = float(frac) * float(np.median(e_blind))
        for scheme in schemes:
            aware = scheme in ("kkt_energy", "pgd")
            prob = dataclasses.replace(prob_free, e_budget=eb) if aware else prob_free
            res = run_async_experiment(
                mode=mode, cycles=cycles, seed=seed, problem=prob,
                train=train, test=test, scheme=scheme, reallocate=True,
                bucketed=(mode != "cycle"), device=device,
            )
            s = res["summary"]
            # blind schemes never see the budget: score their dispatches
            # against it after the fact
            overruns = sum(
                int((np.atleast_1d(r.get("energy", [])) > eb * (1 + 1e-9)).sum())
                for r in res["history"]
            )
            rows.append({
                "K": k,
                "T": T,
                "mode": mode,
                "cycles": cycles,
                "scheme": scheme,
                "energy_aware": aware,
                "budget_frac": float(frac),
                "e_budget_j": round(eb, 4),
                "final_accuracy": res["final_accuracy"],
                "aggregations": s["aggregations"],
                "uploads": s["uploads"],
                "joules_total": round(s["energy"]["joules_total"], 3),
                "joules_p50": round(s["energy"]["joules_p50"], 4),
                "joules_p99": round(s["energy"]["joules_p99"], 4),
                "violations": int(s["energy"]["violations"]) if aware else overruns,
                "staleness_mean": s["staleness"]["mean"],
                "staleness_max": s["staleness"]["max"],
            })
    return rows


# ---------------------------------------------------------------------------
# multi-tenant simultaneous training (fed.multimodel)
# ---------------------------------------------------------------------------

def fleet_scale_sweep(
    fleet_counts=(4, 16),
    *,
    k: int = 4,
    rounds: int = 3,
    T: float = 6.0,
    total_samples: int = 40,
    participation: float = 0.5,
    features: int = 64,
    hidden: int = 32,
    seed: int = 0,
    device=None,
    mesh=None,
    train: Dataset | None = None,
    test: Dataset | None = None,
) -> list[dict]:
    """Population-scale rows: one two-tier ``FleetEngine`` run per fleet
    count F, F fleets x ``k`` learners, FedAST partial participation at
    ``participation``, a compact ``[features, hidden, 10]`` model so the
    per-round cost is the fleet machinery's rather than one product's, on
    ``device`` (``None``: the card) over ``mesh`` (``None``: the engine's
    default, ``launch.mesh.host_mesh()``).

    Every fleet trains every round (unsampled fleets keep working on their
    stale pull), so one global round of virtual time T simulates F x k
    busy learners: ``learners_per_vtu`` is exactly F x k.
    ``mesh_devices`` is the mesh's rank count and ``fleet_axes`` the mesh
    axes the fleet axis was split over."""
    from repro_torch.fed.fleet import FleetConfig, FleetEngine, build_fleet_problems

    device = resolve_device(device)
    if train is None or test is None:
        train, test = synthetic_mnist(6000, n_test=2000, features=features, seed=seed)
    params = mlp.init(seed, layers=[features, hidden, 10], device=device)
    cfg = FleetConfig(participation=participation)
    rows: list[dict] = []
    for f in fleet_counts:
        bp = build_fleet_problems(int(f), k, T=T, total_samples=total_samples, seed=seed)
        eng = FleetEngine(cfg, bp, mlp.loss, params, seed=seed, mesh=mesh)
        t0 = time.time()
        hist = eng.run(train, rounds, eval_fn=mlp.accuracy,
                       eval_batch=(test.x[:1000], test.y[:1000]))
        wall = time.time() - t0
        learners = int(f) * k
        rows.append({
            "F": int(f),
            "K": k,
            "learners": learners,
            "rounds": rounds,
            "participation": participation,
            "mesh_devices": eng.mesh.size,
            "fleet_axes": list(eng.fleet_axes),
            "learners_per_vtu": learners,
            "final_accuracy": float(hist[-1]["accuracy"]),
            "fleet_staleness_max": max(r["fleet_staleness_max"] for r in hist),
            "wall_s": round(wall, 3),
            "learner_rounds_per_s": round(learners * rounds / max(wall, 1e-9), 1),
        })
    return rows


def multi_model_sweep(
    totals=(200, 200, 600),
    *,
    k: int = 4,
    T: float = 8.0,
    cycles: int = 8,
    splits=("deficit", "equal"),
    mode: str = "fedasync",
    alpha: float = 0.6,
    lr: float = 0.05,
    share_floor: float = 0.1,
    seed: int = 0,
    train: Dataset | None = None,
    test: Dataset | None = None,
    device=None,
) -> list[dict]:
    """S tenant models time-sharing one fleet, deficit split against equal
    split (``fed.multimodel.MultiModelEngine``, eager ``run``), at equal
    virtual time, on ``device`` (``None``: the card).

    The tenants differ only in their per-round sample budget (``totals``):
    the LAGGARD (largest total) needs more learner-seconds an aggregation,
    so under the equal split it falls behind in server versions. The
    deficit split reads that version gap and shifts each learner's time
    toward the laggard; the question is the laggard's time to accuracy.
    Each row reports per-model accuracy traces, final versions and the
    laggard's trace (see ``laggard_time_to_accuracy``). Tenant i starts
    from ``mlp.init(seed + i)``.

    ``share_floor`` defaults to 0.1 so that no tenant's slice of the
    deadline is so small that the deadline-filling solver piles hundreds
    of local steps onto a handful of samples (which diverges plain GD);
    ``lr`` is gentler than the single-model default for the same reason."""
    device = resolve_device(device)
    s = len(totals)
    probs = [build_problem(k, T, total_samples=int(t), seed=seed) for t in totals]
    if train is None or test is None:
        train, test = synthetic_mnist(max(max(totals) * 2, 12_000), seed=seed)
    eval_batch = (torch.from_numpy(test.x[:2000]).to(device),
                  torch.from_numpy(test.y[:2000]).to(device))
    params = tuple(mlp.init(seed + i, device=device) for i in range(s))
    laggard = int(np.argmax(totals))
    horizon = cycles * T
    rows: list[dict] = []
    for split in splits:
        cfg = AsyncConfig(mode=mode, alpha=alpha, lr=lr, staleness_fn="poly")
        eng = MultiModelEngine(cfg, probs, mlp.loss, params, seed=seed, split=split,
                               share_floor=share_floor)
        histories = eng.run([train] * s, horizon, eval_fns=[mlp.accuracy] * s,
                            eval_batches=[eval_batch] * s)
        traces = [
            [(round(float(r["t"]), 3), round(float(r["accuracy"]), 4))
             for r in h if "accuracy" in r]
            for h in histories
        ]
        rows.append({
            "S": s,
            "K": k,
            "T": T,
            "cycles": cycles,
            "mode": mode,
            "lr": lr,
            "split": split,
            "share_floor": share_floor,
            "totals": [int(t) for t in totals],
            "laggard": laggard,
            "versions": [int(h[-1]["server_version"]) if h else 0 for h in histories],
            "final_accuracy": [t[-1][1] if t else 0.0 for t in traces],
            "laggard_trace": traces[laggard],
            "events": sum(len(h) for h in histories),
            "split_weights_seen": [[round(float(x), 4) for x in w]
                                   for w in eng.split_weight_log[:8]],
        })
    return rows


def laggard_time_to_accuracy(rows, target: float | None = None):
    """First virtual time each split's laggard reaches ``target`` accuracy
    (default: 95% of the worst split's laggard final accuracy, so every row
    has a finite crossing). Returns ``({split: t}, target)``."""
    if target is None:
        finals = [r["laggard_trace"][-1][1] for r in rows if r["laggard_trace"]]
        target = 0.95 * min(finals)
    out = {}
    for r in rows:
        out[r["split"]] = next((t for t, acc in r["laggard_trace"] if acc >= target), None)
    return out, float(target)
