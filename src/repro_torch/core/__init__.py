"""Core of the paper: staleness-aware task allocation (host NumPy, copied
from ``repro.core``), the batched allocation engine on the device
(``solver_batched``), the capacity drifts, and the torch model
aggregation."""

from repro_torch.core.aggregation import aggregate, fedavg_weights, staleness_weights
from repro_torch.core.allocation import Allocation, AllocationProblem
from repro_torch.core.baselines import solve_eta, solve_synchronous
from repro_torch.core.complexity import ModelCost, mlp_cost, mnist_dnn_cost
from repro_torch.core.solver_batched import (
    POLICIES,
    BatchedAllocation,
    BatchedProblems,
    apply_active_mask,
    batched_avg_staleness,
    batched_max_staleness,
    batched_policy,
    batched_summary,
    solve_eta_batched,
    solve_kkt_batched,
)
from repro_torch.core.solver_kkt import solve as solve_kkt_sai
from repro_torch.core.solver_kkt import solve_relaxed, suggest_and_improve
from repro_torch.core.staleness import avg_staleness, max_staleness
from repro_torch.core.time_model import (
    CapacityDrift,
    ChannelParams,
    LearnerProfile,
    QueueDrift,
    TimeModel,
    indoor_80211_profile,
    is_state_coupled,
)

__all__ = [
    "Allocation",
    "AllocationProblem",
    "BatchedAllocation",
    "BatchedProblems",
    "CapacityDrift",
    "ChannelParams",
    "LearnerProfile",
    "ModelCost",
    "POLICIES",
    "QueueDrift",
    "TimeModel",
    "aggregate",
    "apply_active_mask",
    "avg_staleness",
    "batched_avg_staleness",
    "batched_max_staleness",
    "batched_policy",
    "batched_summary",
    "fedavg_weights",
    "indoor_80211_profile",
    "is_state_coupled",
    "max_staleness",
    "mlp_cost",
    "mnist_dnn_cost",
    "solve_eta",
    "solve_eta_batched",
    "solve_kkt_batched",
    "solve_kkt_sai",
    "solve_relaxed",
    "solve_synchronous",
    "staleness_weights",
    "suggest_and_improve",
]
