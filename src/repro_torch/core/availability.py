"""Per-learner availability (client churn) processes.

The paper's allocator assumes every learner handed a task returns it; real
edge fleets churn. This module models who is online as a process behind
the ``state_init / state_update / factors_at`` drift protocol of
``QueueDrift``, plus one more method, ``online_at(cycle, k, state) -> (K,)
bool``:

- ``MarkovAvailability``: a seeded two-state Markov chain per learner
  (P(online -> offline) = ``p_drop``, P(offline -> online) = ``p_join``);
- ``ActiveRateAvailability``: each learner draws a persistent active rate
  from a clipped lognormal once, then is online i.i.d. Bernoulli(rate) per
  block;
- ``TraceAvailability``: an explicit ``(C, K)`` boolean schedule, wrapped
  periodically.

Each process optionally wraps a base capacity drift (``CapacityDrift`` or
``QueueDrift``): ``factors_at`` delegates to it, so churn composes with
time-varying capacity. The joint state is the pair ``(avail_state,
base_state)``.

An offline learner is masked out of the allocation solve
(``solver_batched.apply_active_mask``): its slot gets the padded-slot
semantics and the sample budget is clipped into the live fleet's box.

A NumPy copy of ``repro/core/availability.py``. The reference draws the
masks from ``jax.random`` keyed on the cycle index; the port draws the same
bits from ``core._threefry``, so the uniform draws, and the masks compared
with them, are bitwise. ``ActiveRateAvailability.rates`` puts a float32
normal draw through NumPy's float32 ``exp``, which need not round as XLA's
does in the last bit; the parity tests show that no mask bit flips over
64 seeds x 16 learners x 32 blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

from repro_torch.core import _threefry
from repro_torch.core.time_model import CapacityDrift, QueueDrift, is_state_coupled

__all__ = [
    "MarkovAvailability",
    "ActiveRateAvailability",
    "TraceAvailability",
    "availability_masks",
    "capacity_state_coupled",
    "has_availability",
]

BaseDrift = Union[CapacityDrift, QueueDrift, None]
_F32 = np.float32


def has_availability(drift) -> bool:
    """True when ``drift`` models client availability (has ``online_at``)."""
    return drift is not None and hasattr(drift, "online_at")


def capacity_state_coupled(drift) -> bool:
    """Whether the capacity rows of ``drift`` depend on past allocations.

    For an availability process this looks through to the wrapped base
    drift: churn alone does not couple capacities to allocations, so a
    frozen (``reallocate=False``) schedule is still defined under a Markov
    on/off fleet, but not under a queue-backlogged one.
    """
    if has_availability(drift):
        return is_state_coupled(drift.base)
    return is_state_coupled(drift)


def _uniform(seed: int, data: int, k: int) -> np.ndarray:
    """``jax.random.uniform(fold_in(key(seed), data), (k,), float32)``."""
    return _threefry.uniform(_threefry.fold_in(_threefry.key(seed), data), k)


class _AvailabilityBase:
    """Protocol plumbing shared by the availability processes.

    Subclasses implement ``_avail_init(k)``, ``_avail_update(cycle,
    avail)`` and ``_online(cycle, k, avail)``; this mixin composes that
    per-learner on/off state with an optional base capacity drift.
    """

    base: BaseDrift

    # -- drift protocol -------------------------------------------------
    def state_init(self, k: int):
        if is_state_coupled(self.base):
            base_state = self.base.state_init(k)
        else:
            base_state = np.zeros((0,), _F32)
        return (self._avail_init(k), base_state)

    def state_update(self, cycle: int, state, tau, d):
        avail, base_state = state
        if is_state_coupled(self.base):
            base_state = self.base.state_update(cycle, base_state, tau, d)
        return (self._avail_update(cycle, avail), base_state)

    def factors_at(self, cycle: int, k: int, state):
        _, base_state = state
        if self.base is None:
            ones = np.ones((k,), _F32)
            return ones, ones.copy()
        if is_state_coupled(self.base):
            return self.base.factors_at(cycle, k, base_state)
        return self.base.factors_at(cycle, k)

    # -- availability ---------------------------------------------------
    def online_at(self, cycle: int, k: int, state) -> np.ndarray:
        """(K,) bool: who is online during drift block ``cycle``."""
        avail, _ = state
        return self._online(cycle, k, avail)


@dataclasses.dataclass(frozen=True)
class MarkovAvailability(_AvailabilityBase):
    """Two-state Markov on/off chain per learner, all online at block 0.

    ``state_update(c, ...)`` draws block ``c + 1``'s occupancy from the
    chain, so the mask a solve sees for block ``c`` is the state that
    entered it.
    """

    p_drop: float = 0.1
    p_join: float = 0.5
    seed: int = 0
    base: BaseDrift = None

    def __post_init__(self):
        if not (0.0 <= self.p_drop <= 1.0):
            raise ValueError("p_drop must be in [0, 1]")
        if not (0.0 <= self.p_join <= 1.0):
            raise ValueError("p_join must be in [0, 1]")

    def _avail_init(self, k: int):
        return np.ones((k,), _F32)

    def _avail_update(self, cycle: int, avail):
        u = _uniform(self.seed, int(cycle) + 1, avail.shape[-1])
        on = avail > _F32(0.5)
        nxt = np.where(on, u >= _F32(self.p_drop), u < _F32(self.p_join))
        return nxt.astype(_F32)

    def _online(self, cycle: int, k: int, avail):
        return avail > _F32(0.5)


@dataclasses.dataclass(frozen=True)
class ActiveRateAvailability(_AvailabilityBase):
    """Persistent per-learner active rates, lognormal around ``median``.

    Each learner draws ``rate_k = clip(median * exp(sigma * z_k), floor,
    1)`` once (seeded), then is online i.i.d. Bernoulli(``rate_k``) per
    block: occupancy is independent across blocks but heterogeneous across
    the fleet.
    """

    median: float = 0.8
    sigma: float = 0.5
    floor: float = 0.05
    seed: int = 0
    base: BaseDrift = None

    def __post_init__(self):
        if not (0.0 < self.median <= 1.0):
            raise ValueError("median must be in (0, 1]")
        if self.sigma < 0.0:
            raise ValueError("sigma must be >= 0")
        if not (0.0 < self.floor <= 1.0):
            raise ValueError("floor must be in (0, 1]")

    def rates(self, k: int) -> np.ndarray:
        """(K,) float32 persistent active rates, clipped to [floor, 1]."""
        key = _threefry.fold_in(_threefry.key(self.seed), 2**31 - 1)
        z = _threefry.normal(key, k)
        r = _F32(self.median) * np.exp(_F32(self.sigma) * z)
        return np.clip(r, _F32(self.floor), _F32(1.0))

    def _mask(self, cycle: int, k: int):
        u = _uniform(self.seed, int(cycle), k)
        return (u < self.rates(k)).astype(_F32)

    def _avail_init(self, k: int):
        return self._mask(0, k)

    def _avail_update(self, cycle: int, avail):
        return self._mask(int(cycle) + 1, avail.shape[-1])

    def _online(self, cycle: int, k: int, avail):
        return avail > _F32(0.5)


@dataclasses.dataclass(frozen=True)
class TraceAvailability(_AvailabilityBase):
    """Replay an explicit ``(C, K)`` boolean uptime trace, wrapped
    periodically past its horizon."""

    trace: np.ndarray = None
    base: BaseDrift = None

    def __post_init__(self):
        tr = np.asarray(self.trace, bool)
        if tr.ndim != 2 or tr.shape[0] < 1:
            raise ValueError("trace must be a (cycles, K) boolean schedule")
        object.__setattr__(self, "trace", tr)

    def _avail_init(self, k: int):
        if k != self.trace.shape[1]:
            raise ValueError(
                f"trace covers {self.trace.shape[1]} learners, fleet has {k}"
            )
        return np.zeros((0,), _F32)  # the mask is read from the trace

    def _avail_update(self, cycle: int, avail):
        return avail

    def _online(self, cycle: int, k: int, avail):
        return self.trace[int(cycle) % self.trace.shape[0]]


def availability_masks(drift, k: int, cycles: int, *, tau=None, d=None) -> np.ndarray:
    """(cycles, K) bool mask rollout under a frozen allocation.

    Steps the availability state with the given static ``(tau, d)`` (zeros
    by default; only a queue-coupled base reads them), for the
    ``reallocate=False`` regime where the schedule is fixed up front and
    churn evolves on its own. For a joint masked-solve rollout use
    ``fed.orchestrator.solve_rows_availability``.
    """
    tau = np.zeros((k,), np.int64) if tau is None else np.asarray(tau)
    d = np.zeros((k,), np.int64) if d is None else np.asarray(d)
    masks = np.zeros((cycles, k), bool)
    state = drift.state_init(k)
    for c in range(cycles):
        masks[c] = np.asarray(drift.online_at(c, k, state))
        state = drift.state_update(c, state, tau, d)
    return masks
