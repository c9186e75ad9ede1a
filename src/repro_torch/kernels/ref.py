"""Plain torch versions of the port's kernels: the CPU path of ``ops`` and
the oracle the CUDA kernels are held to on the card.

``train_agg_step_ref`` takes its gradients from autograd over the loss
function, so it stays independent of the kernel's hand-derived backward.
"""

from __future__ import annotations

import torch

from repro_torch.models import mlp

__all__ = ["fed_agg_ref", "train_agg_step_ref"]


def fed_agg_ref(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum over the leading learner axis, accumulated in float32
    and returned in the input dtype (``repro.kernels.ref.fed_agg_ref``)."""
    w = weights.to(torch.float32).reshape((-1,) + (1,) * (stacked.dim() - 1))
    return (stacked.to(torch.float32) * w).sum(dim=0).to(stacked.dtype)


def train_agg_step_ref(disp, x, y, m, tau, weights, lr, *, max_tau: int,
                       loss_fn=mlp.loss) -> list[dict]:
    """Cycle form of the train+aggregate step: ``local_train_stacked``
    (``tau_k`` masked GD steps per learner from its own parameters)
    followed by ``fed_agg_ref`` on every leaf."""
    from repro_torch.fed.orchestrator import local_train_stacked

    locals_ = local_train_stacked(disp, x, y, m, tau, lr, max_tau=max_tau,
                                  loss_fn=loss_fn)
    w = weights.to(torch.float32)
    return [{name: fed_agg_ref(leaf, w) for name, leaf in layer.items()}
            for layer in locals_]
