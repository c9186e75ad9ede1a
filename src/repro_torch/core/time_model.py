"""Per-learner time model of the MEL global cycle (paper Eqs. 1-5).

A NumPy copy of ``repro/core/time_model.py``: ``ChannelParams``,
``LearnerProfile``, ``TimeModel``, the reference environments
``indoor_80211_profile`` and ``pod_slice_profile``, and the per-cycle
capacity drifts ``CapacityDrift`` and ``QueueDrift``. The
reference draws the drift from ``jax.random``; the port draws the same bits
from its NumPy twin ``core._threefry``.

Total cycle time of learner k (Eq. 4/5):

    t_k = C2_k * tau_k * d_k + C1_k * d_k + C0_k

with C2_k = C_m / f_k, C1_k = (F * P_d + 2 * P_m * S_d) / R_k,
C0_k = 2 * P_m * S_m / R_k and R_k = W * log2(1 + P_k h_k / N0).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import _threefry

__all__ = [
    "CapacityDrift",
    "ChannelParams",
    "LearnerProfile",
    "QueueDrift",
    "TimeModel",
    "indoor_80211_profile",
    "is_state_coupled",
    "pod_slice_profile",
]


@dataclasses.dataclass(frozen=True)
class ChannelParams:
    """Link parameters for one learner<->orchestrator channel."""

    bandwidth_hz: float = 5e6        # W
    tx_power_w: float = 0.1          # P_ko (20 dBm)
    gain: float = 1e-8               # h_ko (path loss, linear; ~80 dB)
    noise_psd: float = 4e-21         # N0 (W/Hz), thermal ~ -174 dBm/Hz

    def rate_bps(self) -> float:
        snr = self.tx_power_w * self.gain / (self.noise_psd * self.bandwidth_hz)
        return self.bandwidth_hz * np.log2(1.0 + snr)


@dataclasses.dataclass(frozen=True)
class LearnerProfile:
    """One edge learner: compute rate + channel."""

    clock_hz: float                  # f_k, effective clocks/sec
    channel: ChannelParams
    name: str = "learner"


@dataclasses.dataclass(frozen=True)
class TimeModel:
    """Vectorized coefficients (C2, C1, C0) for K learners.

    Attributes
    ----------
    c2, c1, c0 : np.ndarray shape (K,)
        Quadratic / linear / constant coefficients of Eq. 5.
    """

    c2: np.ndarray
    c1: np.ndarray
    c0: np.ndarray

    @property
    def num_learners(self) -> int:
        return int(self.c2.shape[0])

    @staticmethod
    def build(
        profiles: Sequence[LearnerProfile],
        *,
        model_complexity_flops: float,     # C_m: clocks (~= FLOPs) per sample per epoch
        model_size_bits: float,            # S_m * P_m ... we take bits directly
        features_per_sample: int = 784,    # F
        data_precision_bits: int = 32,     # P_d
        model_precision_bits: int = 32,    # P_m (folded into sizes below)
        sample_model_scaling_bits: float = 0.0,  # P_m * S_d: model bits that scale w/ d_k
        task_parallelization: bool = True,
    ) -> "TimeModel":
        """Build (C2, C1, C0) from learner profiles (paper Sec. II).

        ``model_size_bits`` is the full serialized model (P_m * S_m).
        ``sample_model_scaling_bits`` is P_m * S_d - the per-sample part of
        the model transfer (zero for the architectures we care about).
        """
        k = len(profiles)
        c2 = np.empty(k)
        c1 = np.empty(k)
        c0 = np.empty(k)
        for i, p in enumerate(profiles):
            rate = p.channel.rate_bps()
            c2[i] = model_complexity_flops / p.clock_hz
            data_bits = features_per_sample * data_precision_bits if task_parallelization else 0.0
            c1[i] = (data_bits + 2.0 * sample_model_scaling_bits) / rate
            c0[i] = 2.0 * model_size_bits / rate
        del model_precision_bits  # already folded into the *_bits arguments
        return TimeModel(c2=c2, c1=c1, c0=c0)

    # --- Eq. 5 -----------------------------------------------------------
    def cycle_time(self, tau: np.ndarray, d: np.ndarray) -> np.ndarray:
        """t_k for each learner."""
        tau = np.asarray(tau, dtype=float)
        d = np.asarray(d, dtype=float)
        return self.c2 * tau * d + self.c1 * d + self.c0

    # --- the reduced form used by the solvers ----------------------------
    def tau_of_d(self, d: np.ndarray, T: float) -> np.ndarray:
        """tau_k(d_k) = (T - C0_k - C1_k d_k) / (C2_k d_k)  — Eq. 5 solved
        for tau with t_k = T. May be negative => learner infeasible."""
        d = np.asarray(d, dtype=float)
        return (T - self.c0 - self.c1 * d) / (self.c2 * d)

    def d_of_tau(self, tau: np.ndarray, T: float) -> np.ndarray:
        """d_k(tau_k) = (T - C0_k) / (C2_k tau_k + C1_k) — inverse map."""
        tau = np.asarray(tau, dtype=float)
        return (T - self.c0) / (self.c2 * tau + self.c1)

    def max_tau(self, d: np.ndarray, T: float) -> np.ndarray:
        """Largest integer tau_k with t_k <= T for given integer d_k."""
        d = np.asarray(d, dtype=float)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.floor((T - self.c0 - self.c1 * d) / (self.c2 * d))
        t = np.where(d > 0, t, 0.0)
        return np.maximum(t, 0.0).astype(np.int64)


# ---------------------------------------------------------------------------
# Time-varying capacities (per-cycle drift)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CapacityDrift:
    """Seeded per-cycle drift of a fleet's capacities (block model: the
    capacities hold within a cycle and are drawn anew for the next).

      * compute drift: the clock f_k jitters by a uniform factor in
        ``[1 - clock_jitter, 1 + clock_jitter]``, scaling C2_k by its inverse;
      * channel fading: the rate R_k is multiplied by ``10^(X/10)``,
        X ~ N(0, fading_sigma_db) clipped to +-fading_clip_db, scaling C1_k
        and C0_k by its inverse.

    Cycle c draws from ``fold_in(key(seed), c)``, as the reference does with
    ``jax.random``, so the path depends on ``seed`` alone. The draws are
    float32; the dB-to-linear power is taken in float64 and rounded once to
    float32, as in the reference.
    """

    clock_jitter: float = 0.1
    fading_sigma_db: float = 2.0
    fading_clip_db: float = 6.0
    seed: int = 0

    def _factors(self, cycles: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(clock, rate) factors, each (C, K) float32, of the given cycles."""
        f32 = np.float32
        keys = _threefry.split(_threefry.fold_in(_threefry.key(self.seed), cycles))
        clock = f32(1.0) + f32(self.clock_jitter) * (
            f32(2.0) * _threefry.uniform(keys[:, 0], k) - f32(1.0))
        db = np.clip(f32(self.fading_sigma_db) * _threefry.normal(keys[:, 1], k),
                     f32(-self.fading_clip_db), f32(self.fading_clip_db))
        rate = np.power(10.0, db.astype(np.float64) / 10.0).astype(f32)
        return clock, rate

    def factors_at(self, cycle: int, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(clock_factor, rate_factor), each (K,) float32, for one cycle."""
        clock, rate = self._factors(np.array([cycle]), k)
        return clock[0], rate[0]

    def coefficient_path(self, tm: "TimeModel", cycles: int
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Drifted (c2, c1, c0) float64 arrays of shape (C, K); row c is
        the fleet's capacity during global cycle c."""
        clock, rate = self._factors(np.arange(cycles), tm.num_learners)
        clock = clock.astype(np.float64)
        rate = rate.astype(np.float64)
        return tm.c2[None] / clock, tm.c1[None] / rate, tm.c0[None] / rate


# ---------------------------------------------------------------------------
# State-coupled capacities (queue-driven drift)
# ---------------------------------------------------------------------------

def is_state_coupled(drift) -> bool:
    """True when ``drift`` carries per-fleet state through the run
    (``state_init``/``state_update``) and its ``factors_at`` reads that
    state: its capacity rows then depend on the allocations and must be
    rolled out together with them (``QueueDrift.rollout``)."""
    return hasattr(drift, "state_update") and hasattr(drift, "state_init")


@dataclasses.dataclass(frozen=True)
class QueueDrift:
    """State-coupled drift: one congestion queue per learner, driven by the
    work the allocator dispatches.

      * state: a (K,) float32 backlog ``q``, empty at the start;
      * dynamics (``state_update``): ``q' = clip(q + gain * (d_k K / sum(d)
        - service), 0, q_max)``: a learner above its fair share of samples
        builds a backlog, one below it drains;
      * coupling (``factors_at``): ``rate_factor = 1 / (1 + congestion q_k)``
        scales C1_k and C0_k by its inverse; compute is untouched unless a
        ``base`` ``CapacityDrift`` is composed on top.

    The queue arithmetic is elementwise float32, bitwise as in the
    reference. The rows of cycle c depend on the allocations of cycles < c,
    so rows and allocations come together from ``rollout``.
    """

    congestion: float = 0.3     # rate degradation per unit backlog
    gain: float = 1.0           # backlog added per unit of excess load
    service: float = 1.0        # fair-share load served per cycle
    q_max: float = 8.0          # backlog clip (bounded buffers)
    base: CapacityDrift | None = None   # exogenous drift composed on top

    def state_init(self, k: int) -> np.ndarray:
        """Initial (K,) float32 backlog: empty queues."""
        return np.zeros((k,), np.float32)

    def factors_at(self, cycle: int, k: int, state) -> tuple[np.ndarray, np.ndarray]:
        """(clock_factor, rate_factor), each (K,) float32, for one cycle
        given the backlog ``state``."""
        if self.base is not None:
            clock, rate = self.base.factors_at(cycle, k)
        else:
            clock = np.ones((k,), np.float32)
            rate = np.ones((k,), np.float32)
        q = np.asarray(state, np.float32)
        return clock, rate / (np.float32(1.0) + np.float32(self.congestion) * q)

    def state_update(self, cycle: int, state, tau, d) -> np.ndarray:
        """Next (K,) float32 backlog after serving ``(tau, d)``. The load
        ``d_k K / sum(d)`` takes the integer sum exactly; ``tau`` and
        ``cycle`` are part of the protocol and unused here."""
        del cycle, tau
        d = np.asarray(d)
        k = d.shape[-1]
        tot = np.float32(max(int(d.sum()), 1))
        load = d.astype(np.float32) * np.float32(k) / tot
        q = np.asarray(state, np.float32)
        q = q + np.float32(self.gain) * (load - np.float32(self.service))
        return np.clip(q, np.float32(0.0), np.float32(self.q_max))

    def rollout_iter(self, tm: "TimeModel", cycles: int, solve):
        """Lazy rollout: per cycle, the drifted (c2, c1, c0) row from the
        current state, ``solve(cycle, c2_row, c1_row, c0_row) -> (tau, d)``,
        then the state advanced with that allocation; yields
        ``(c2_row, c1_row, c0_row, tau, d)``. A consumer trains between
        yields, so an infeasible cycle raises (from ``solve``) only after
        the feasible prefix ran."""
        k = tm.num_learners
        state = self.state_init(k)
        for c in range(cycles):
            clock, rate = self.factors_at(c, k, state)
            c2r = tm.c2 / clock.astype(np.float64)
            c1r = tm.c1 / rate.astype(np.float64)
            c0r = tm.c0 / rate.astype(np.float64)
            tau, d = solve(c, c2r, c1r, c0r)
            state = self.state_update(c, state, tau, d)
            yield c2r, c1r, c0r, tau, d

    def rollout(self, tm: "TimeModel", cycles: int, solve):
        """``rollout_iter`` collected: ``((c2s, c1s, c0s), (taus, ds))``,
        (C, K) float64 rows and (C, K) int64 allocations."""
        k = tm.num_learners
        rows = np.empty((3, cycles, k))
        alloc = np.zeros((2, cycles, k), np.int64)
        for c, (c2r, c1r, c0r, tau, d) in enumerate(self.rollout_iter(tm, cycles, solve)):
            rows[:, c] = c2r, c1r, c0r
            alloc[:, c] = tau, d
        return tuple(rows), tuple(alloc)


def indoor_80211_profile(
    k: int,
    *,
    seed: int = 0,
    radius_m: float = 50.0,
    bandwidth_hz: float = 5e6,
    tx_power_w: float = 0.1,
    noise_psd: float = 4e-21,
    fast_clock_hz: float = 2.4e9,
    slow_clock_hz: float = 0.7e9,
) -> list[LearnerProfile]:
    """The paper's simulation environment (Sec. V-A): K nodes within a 50 m
    radius over 802.11-type links; ~half are desktop/laptop class, half are
    Raspberry-Pi class. Path loss follows a standard indoor log-distance
    model (Table 1 of ref [9]: PL(d) = PL0 + 10 n log10(d), n ~= 3,
    PL0 ~= 40 dB at 1 m, plus lognormal shadowing sigma = 4 dB).
    """
    rng = np.random.default_rng(seed)
    dist = rng.uniform(2.0, radius_m, size=k)
    pl_db = 40.0 + 10.0 * 3.0 * np.log10(dist) + rng.normal(0.0, 4.0, size=k)
    gains = 10.0 ** (-pl_db / 10.0)
    profiles = []
    for i in range(k):
        fast = i % 2 == 0
        clock = fast_clock_hz if fast else slow_clock_hz
        # mild per-node compute jitter (thermal throttling etc.)
        clock *= rng.uniform(0.9, 1.1)
        profiles.append(
            LearnerProfile(
                clock_hz=clock,
                channel=ChannelParams(
                    bandwidth_hz=bandwidth_hz,
                    tx_power_w=tx_power_w,
                    gain=float(gains[i]),
                    noise_psd=noise_psd,
                ),
                name=f"{'edge' if fast else 'mcu'}-{i}",
            )
        )
    return profiles



def pod_slice_profile(
    k: int,
    *,
    seed: int = 0,
    chips_per_slice: int = 256,
    peak_flops: float = 197e12,
    mfu_range: tuple[float, float] = (0.3, 0.55),
    dcn_gbps_range: tuple[float, float] = (25.0, 100.0),
) -> list[LearnerProfile]:
    """A fleet of accelerator pod slices as learners: each has an effective
    throughput (chips x peak x MFU) and a fixed-rate datacenter link to the
    orchestrator, encoded as an equivalent (W, SNR) pair with rate ==
    ``dcn_gbps``.

    ``peak_flops`` is an input of this simulated fleet (the reference's
    default, a per-chip peak from a data sheet), not a measurement of any
    device this package runs on.
    """
    rng = np.random.default_rng(seed)
    profiles = []
    for i in range(k):
        mfu = rng.uniform(*mfu_range)
        flops = chips_per_slice * peak_flops * mfu
        rate_bps = rng.uniform(*dcn_gbps_range) * 1e9
        # encode the fixed rate: W = rate, SNR = 1 -> W*log2(2) = rate
        ch = ChannelParams(
            bandwidth_hz=rate_bps,
            tx_power_w=1.0,
            gain=1.0,
            noise_psd=1.0 / rate_bps,
        )
        profiles.append(LearnerProfile(clock_hz=flops, channel=ch, name=f"slice-{i}"))
    return profiles
