"""Analytic complexity accounting for the paper's MLP (Sec. II, V-A).

A copy of the ``ModelCost``/``mlp_cost``/``mnist_dnn_cost`` part of
``repro/core/complexity.py``: the allocator needs C_m (fwd+bwd FLOPs per
sample) and S_m (model bits). For [784, 300, 124, 60, 10] these are the
paper's 1,123,736 FLOPs and 8,974,080 bits.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelCost", "mlp_cost", "mnist_dnn_cost"]


@dataclasses.dataclass(frozen=True)
class ModelCost:
    params_total: int          # all parameters
    params_active: int         # activated per token (MoE: shared + top-k)
    flops_per_sample: float    # C_m: fwd+bwd FLOPs for one training sample
    model_bits: float          # S_m * P_m


def mlp_cost(layers: list[int], *, precision_bits: int = 32) -> ModelCost:
    """Fully-connected net with the paper's exact accounting (Sec. V-A):

    * S_m counts WEIGHT matrices only — [784,300,124,60,10] gives
      280,440 weights -> 8,974,080 bits at 32-bit precision (paper's number);
    * C_m = 4 FLOPs per parameter (weights + biases) per sample for the
      fwd+bwd pass — 4 * 280,934 = 1,123,736 FLOPs (paper's number).
    """
    weights = 0
    params = 0
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        weights += fan_in * fan_out
        params += fan_in * fan_out + fan_out
    flops = 4 * params
    return ModelCost(
        params_total=params,
        params_active=params,
        flops_per_sample=float(flops),
        model_bits=float(weights) * precision_bits,
    )


def mnist_dnn_cost() -> ModelCost:
    """The paper's network: [784, 300, 124, 60, 10] @ 32-bit params.
    Reproduces the paper's exact constants: model_bits == 8,974,080 and
    flops_per_sample == 1,123,736."""
    return mlp_cost([784, 300, 124, 60, 10], precision_bits=32)
