"""Analytic complexity accounting (``repro/core/complexity.py``, Sec. II,
V-A).

A copy of the reference's: the allocator needs C_m (fwd+bwd FLOPs per
sample) and S_m (model bits). For the paper's MLP [784, 300, 124, 60, 10]
these are its 1,123,736 FLOPs and 8,974,080 bits; a transformer's sample
is one sequence, at 6 FLOPs a parameter a token (``transformer_cost``).
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelCost", "mlp_cost", "mnist_dnn_cost", "transformer_cost"]


@dataclasses.dataclass(frozen=True)
class ModelCost:
    params_total: int          # all parameters
    params_active: int         # activated per token (MoE: shared + top-k)
    flops_per_sample: float    # C_m: fwd+bwd FLOPs for one training sample
    model_bits: float          # S_m * P_m

    @staticmethod
    def from_params(
        params_total: int,
        params_active: int,
        *,
        tokens_per_sample: int = 1,
        precision_bits: int = 32,
        train: bool = True,
    ) -> "ModelCost":
        mult = 6.0 if train else 2.0   # fwd+bwd vs fwd-only FLOPs per param
        return ModelCost(
            params_total=params_total,
            params_active=params_active,
            flops_per_sample=mult * params_active * tokens_per_sample,
            model_bits=float(params_total) * precision_bits,
        )


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


def transformer_cost(
    *,
    params_total: int,
    params_active: int,
    seq_len: int,
    precision_bits: int = 16,
) -> ModelCost:
    """A transformer 'sample' for allocation purposes is one sequence."""
    return ModelCost.from_params(
        params_total,
        params_active,
        tokens_per_sample=seq_len,
        precision_bits=precision_bits,
        train=True,
    )
