"""Core of the paper: staleness-aware task allocation (host NumPy, copied
from ``repro.core``), the batched allocation engine on the device
(``solver_batched``), the numeric solvers (``solver_numeric``), the
capacity drifts, client availability and the energy model, and the torch
model aggregation."""

from repro_torch.core.aggregation import (
    aggregate,
    aggregate_stacked,
    fedavg_weights,
    staleness_weights,
)
from repro_torch.core.allocation import Allocation, AllocationProblem
from repro_torch.core.availability import (
    ActiveRateAvailability,
    MarkovAvailability,
    TraceAvailability,
    availability_masks,
    capacity_state_coupled,
    has_availability,
)
from repro_torch.core.baselines import solve_eta, solve_synchronous
from repro_torch.core.complexity import ModelCost, mlp_cost, mnist_dnn_cost, transformer_cost
from repro_torch.core.energy import BatteryDrift, EnergyModel
from repro_torch.core.solver_batched import (
    POLICIES,
    BatchedAllocation,
    BatchedProblems,
    apply_active_mask,
    apply_energy_mask,
    apply_sampling_mask,
    batched_avg_staleness,
    batched_max_staleness,
    batched_policy,
    batched_summary,
    solve_energy_batched,
    solve_eta_batched,
    solve_kkt_batched,
)
from repro_torch.core.solver_kkt import solve as solve_kkt_sai
from repro_torch.core.solver_kkt import solve_energy as solve_kkt_energy
from repro_torch.core.solver_kkt import solve_relaxed, suggest_and_improve
from repro_torch.core.solver_numeric import solve_pgd_batched, solve_pgd_jax, solve_slsqp
from repro_torch.core.staleness import (
    STALENESS_FNS,
    avg_staleness,
    max_staleness,
    staleness_factor,
    version_staleness,
    version_staleness_profile,
)
from repro_torch.core.time_model import (
    CapacityDrift,
    ChannelParams,
    LearnerProfile,
    QueueDrift,
    TimeModel,
    indoor_80211_profile,
    is_state_coupled,
    pod_slice_profile,
)

__all__ = [
    "ActiveRateAvailability",
    "Allocation",
    "AllocationProblem",
    "BatchedAllocation",
    "BatchedProblems",
    "BatteryDrift",
    "CapacityDrift",
    "ChannelParams",
    "EnergyModel",
    "LearnerProfile",
    "MarkovAvailability",
    "ModelCost",
    "POLICIES",
    "QueueDrift",
    "STALENESS_FNS",
    "TimeModel",
    "TraceAvailability",
    "aggregate",
    "aggregate_stacked",
    "apply_active_mask",
    "apply_energy_mask",
    "apply_sampling_mask",
    "availability_masks",
    "avg_staleness",
    "batched_avg_staleness",
    "batched_max_staleness",
    "batched_policy",
    "batched_summary",
    "capacity_state_coupled",
    "fedavg_weights",
    "has_availability",
    "indoor_80211_profile",
    "is_state_coupled",
    "max_staleness",
    "mlp_cost",
    "mnist_dnn_cost",
    "transformer_cost",
    "pod_slice_profile",
    "solve_energy_batched",
    "solve_eta",
    "solve_eta_batched",
    "solve_kkt_batched",
    "solve_kkt_energy",
    "solve_kkt_sai",
    "solve_pgd_batched",
    "solve_pgd_jax",
    "solve_relaxed",
    "solve_slsqp",
    "solve_synchronous",
    "staleness_factor",
    "staleness_weights",
    "suggest_and_improve",
    "version_staleness",
    "version_staleness_profile",
]
