"""Core of the paper: staleness-aware task allocation (host NumPy, copied
from ``repro.core``) and the torch model aggregation."""

from repro_torch.core.aggregation import aggregate, fedavg_weights, staleness_weights
from repro_torch.core.allocation import Allocation, AllocationProblem
from repro_torch.core.baselines import solve_eta, solve_synchronous
from repro_torch.core.complexity import ModelCost, mlp_cost, mnist_dnn_cost
from repro_torch.core.solver_kkt import solve as solve_kkt_sai
from repro_torch.core.solver_kkt import solve_relaxed, suggest_and_improve
from repro_torch.core.staleness import avg_staleness, max_staleness
from repro_torch.core.time_model import (
    ChannelParams,
    LearnerProfile,
    TimeModel,
    indoor_80211_profile,
)

__all__ = [
    "Allocation",
    "AllocationProblem",
    "ChannelParams",
    "LearnerProfile",
    "ModelCost",
    "TimeModel",
    "aggregate",
    "avg_staleness",
    "fedavg_weights",
    "indoor_80211_profile",
    "max_staleness",
    "mlp_cost",
    "mnist_dnn_cost",
    "solve_eta",
    "solve_kkt_sai",
    "solve_relaxed",
    "solve_synchronous",
    "staleness_weights",
    "suggest_and_improve",
]
