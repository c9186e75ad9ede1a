"""Per-learner energy model of the MEL global cycle (arXiv 2012.00143).

The authors' sequel ("Task Allocation for Asynchronous Mobile Edge
Learning with Delay and Energy Constraints") extends the Eq. 5 time
family with a per-learner energy budget. Each global cycle costs
learner ``k``

    E_k = e2_k * tau_k * d_k + e1_k * d_k + e0_k

with
  e2_k = kappa * f_k^2 * C_m                  (compute, J per sample-update)
  e1_k = P_k * (F * P_d + 2 P_m S_d) / R_k    (per-sample transfer)
  e0_k = P_k * 2 P_m S_m / R_k                (model down + up)

the energy mirror of ``TimeModel``'s (C2, C1, C0), so the KKT
water-filling absorbs the budget as one more per-learner cap on the
(tau_k, d_k) box (``solver_kkt.solve_energy``,
``batched_policy("kkt_energy")``).

``BatteryDrift`` closes the loop with client state: dispatched work
drains a per-learner battery, a seeded recharge process refills it, and
an empty battery takes the learner offline through the same ``online_at``
protocol as the churn processes in ``availability.py``.

A NumPy copy of ``repro/core/energy.py``. The reference's battery draws
its recharge from ``jax.random``; the port draws the same bits from
``core._threefry``. The charge arithmetic is float32, one rounded
operation at a time, as the reference's eager jax calls compute it, so a
rollout gives the reference's bits.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import _threefry
from repro_torch.core.time_model import CapacityDrift, LearnerProfile

__all__ = [
    "BatteryDrift",
    "EnergyModel",
]


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Vectorized energy coefficients (e2, e1, e0) for K learners.

    Attributes
    ----------
    e2, e1, e0 : np.ndarray shape (K,)
        Quadratic / linear / constant coefficients of the per-cycle
        energy ``E_k = e2 tau d + e1 d + e0`` (joules).
    """

    e2: np.ndarray
    e1: np.ndarray
    e0: np.ndarray

    @property
    def num_learners(self) -> int:
        return int(self.e2.shape[0])

    @staticmethod
    def build(
        profiles: Sequence[LearnerProfile],
        *,
        model_complexity_flops: float,     # C_m: clocks (~= FLOPs) per sample per epoch
        model_size_bits: float,            # P_m * S_m, full serialized model
        kappa: float = 1e-28,              # effective switched capacitance (J / (clock * Hz^2))
        features_per_sample: int = 784,    # F
        data_precision_bits: int = 32,     # P_d
        sample_model_scaling_bits: float = 0.0,  # P_m * S_d
        task_parallelization: bool = True,
    ) -> "EnergyModel":
        """Build (e2, e1, e0) from the learner profiles and workload
        constants ``TimeModel.build`` takes, plus ``kappa``.

        ``kappa ~ 1e-28`` puts a 2.4 GHz edge node at ~1e-3 J per
        sample-update for an MLP-class C_m: a few joules per cycle, the
        regime where single-digit budgets bind (2012.00143 Sec. V).
        """
        k = len(profiles)
        e2 = np.empty(k)
        e1 = np.empty(k)
        e0 = np.empty(k)
        for i, p in enumerate(profiles):
            rate = p.channel.rate_bps()
            power = p.channel.tx_power_w
            e2[i] = kappa * p.clock_hz**2 * model_complexity_flops
            data_bits = features_per_sample * data_precision_bits if task_parallelization else 0.0
            e1[i] = power * (data_bits + 2.0 * sample_model_scaling_bits) / rate
            e0[i] = power * 2.0 * model_size_bits / rate
        return EnergyModel(e2=e2, e1=e1, e0=e0)

    def cycle_energy(self, tau: np.ndarray, d: np.ndarray) -> np.ndarray:
        """E_k for each learner (joules), zero where d_k = 0 (an idle
        learner transfers and computes nothing)."""
        tau = np.asarray(tau, dtype=float)
        d = np.asarray(d, dtype=float)
        e = self.e2 * tau * d + self.e1 * d + self.e0
        return np.where(d > 0, e, 0.0)

    def min_dispatch_energy(self) -> np.ndarray:
        """(K,) joules of the smallest dispatchable task (tau=1, d=1): the
        battery floor below which a learner cannot accept work."""
        return self.e2 + self.e1 + self.e0

    def rows(self, e_budget=None) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(e2, e1, e0, eb) float64 rows for the solver layers; ``eb``
        broadcasts a scalar budget to (K,) and defaults to +inf (the
        unconstrained regime, decision-identical to ``kkt_sai``)."""
        k = self.num_learners
        if e_budget is None:
            eb = np.full(k, np.inf)
        else:
            eb = np.broadcast_to(np.asarray(e_budget, float), (k,)).copy()
        return (
            self.e2.astype(np.float64),
            self.e1.astype(np.float64),
            self.e0.astype(np.float64),
            eb.astype(np.float64),
        )


# ---------------------------------------------------------------------------
# Battery-drain drift (state-coupled availability)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatteryDrift:
    """State-coupled battery process: dispatched work drains the battery,
    a seeded recharge process refills it, an empty battery is offline.

    It follows the ``state_init / state_update / factors_at`` and
    ``online_at`` protocol of the churn processes in ``availability.py``
    (so it routes through ``solve_rows_availability`` and composes with
    ``apply_active_mask`` as Markov churn does), with one more method,
    ``budget_at``, that exposes the current charge as a per-dispatch energy
    budget, so an energy-aware scheme never dispatches a task the battery
    cannot finish:

      * state: a (K,) float32 charge (joules), starting full at
        ``capacity_j``;
      * drain (``state_update``): the served allocation costs
        ``E_k(tau_k, d_k)`` from the ``EnergyModel`` (zero where
        ``d_k = 0``);
      * recharge: each cycle each learner is plugged in i.i.d.
        Bernoulli(``p_plugged``) (a seeded ``fold_in`` draw) and recovers
        ``recharge_j`` joules, clipped at ``capacity_j``;
      * offline (``online_at``): a charge below the learner's
        ``min_dispatch_energy`` cannot accept any task; the solve masks it
        out and its share of the budget flows to the charged learners.

    The battery arithmetic is elementwise float32 with no transcendentals,
    bitwise as in the reference; a composed ``base`` ``CapacityDrift``
    brings its own capacity rows.
    """

    energy: EnergyModel = None
    capacity_j: float = 50.0     # full-charge energy (joules)
    recharge_j: float = 2.0      # joules recovered per plugged-in cycle
    p_plugged: float = 0.5       # P(a learner is on charge in a cycle)
    seed: int = 0
    base: CapacityDrift | None = None

    def __post_init__(self):
        if self.energy is None:
            raise ValueError("BatteryDrift needs an EnergyModel")
        if self.capacity_j <= 0:
            raise ValueError("capacity_j must be > 0")
        if self.recharge_j < 0:
            raise ValueError("recharge_j must be >= 0")
        if not (0.0 <= self.p_plugged <= 1.0):
            raise ValueError("p_plugged must be a probability in [0, 1]")

    # -- drift protocol -------------------------------------------------
    def state_init(self, k: int) -> np.ndarray:
        """Initial (K,) float32 charge: every battery full."""
        if k != self.energy.num_learners:
            raise ValueError(
                f"energy model covers {self.energy.num_learners} learners, "
                f"fleet has {k}"
            )
        return np.full((k,), np.float32(self.capacity_j))

    def factors_at(self, cycle, k: int, state) -> tuple[np.ndarray, np.ndarray]:
        """(clock_factor, rate_factor): the battery level does not change
        capacities (a drained phone is offline, not slow); the composed
        ``base`` drift's factors when there is one."""
        if self.base is not None:
            return self.base.factors_at(cycle, k)
        ones = np.ones((k,), np.float32)
        return ones, ones.copy()

    def state_update(self, cycle, state, tau, d) -> np.ndarray:
        """Next (K,) float32 charge after serving allocation ``(tau, d)``:
        drain by the allocation's energy, then the cycle's seeded recharge
        draw, clipped into [0, capacity_j]."""
        f32 = np.float32
        q = np.asarray(state, f32)
        tau_f = np.asarray(tau).astype(f32)
        d_f = np.asarray(d).astype(f32)
        e2 = self.energy.e2.astype(f32)
        e1 = self.energy.e1.astype(f32)
        e0 = self.energy.e0.astype(f32)
        cost = e2 * tau_f * d_f + e1 * d_f + e0
        drain = np.where(d_f > 0, cost, f32(0.0))
        key = _threefry.fold_in(_threefry.key(self.seed), int(cycle) + 1)
        u = _threefry.uniform(key, q.shape[-1])
        plugged = (u < f32(self.p_plugged)).astype(f32)
        q = q - drain + f32(self.recharge_j) * plugged
        return np.clip(q, f32(0.0), f32(self.capacity_j))

    # -- availability ---------------------------------------------------
    def online_at(self, cycle, k: int, state) -> np.ndarray:
        """(K,) bool: a learner is online iff its charge covers at least
        the smallest dispatchable task (tau=1, d=1)."""
        floor = self.energy.min_dispatch_energy().astype(np.float32)
        return np.asarray(state, np.float32) >= floor

    # -- energy budget ---------------------------------------------------
    def budget_at(self, cycle, k: int, state) -> np.ndarray:
        """(K,) float64 joules available for the next dispatch: the
        current charge, which an energy-aware solve passes as ``e_budget``
        so no task is dispatched that the battery cannot finish."""
        del cycle, k
        return np.asarray(state, np.float64)
