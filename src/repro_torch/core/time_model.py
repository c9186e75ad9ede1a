"""Per-learner time model of the MEL global cycle (paper Eqs. 1-5).

A NumPy copy of ``repro/core/time_model.py``: ``ChannelParams``,
``LearnerProfile``, ``TimeModel`` and ``indoor_80211_profile``. The drift
processes (``CapacityDrift``, ``QueueDrift``) come with the reallocation
slice of the port.

Total cycle time of learner k (Eq. 4/5):

    t_k = C2_k * tau_k * d_k + C1_k * d_k + C0_k

with C2_k = C_m / f_k, C1_k = (F * P_d + 2 * P_m * S_d) / R_k,
C0_k = 2 * P_m * S_m / R_k and R_k = W * log2(1 + P_k h_k / N0).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "ChannelParams",
    "LearnerProfile",
    "TimeModel",
    "indoor_80211_profile",
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

