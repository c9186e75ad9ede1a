"""The paper's learning model: a fully-connected DNN for MNIST-class data
with layout [784, 300, 124, 60, 10] (Sec. V-A), in torch.

Parameters keep the reference's layout (``repro/models/mlp.py``): a list
of ``{"w": (fan_in, fan_out), "b": (fan_out,)}`` dicts.
"""

from __future__ import annotations

import torch

from repro_torch.models.params import ParamSpec, init_params

__all__ = ["PAPER_LAYERS", "build_specs", "init", "forward", "loss", "accuracy"]

PAPER_LAYERS = [784, 300, 124, 60, 10]


def build_specs(layers=None):
    layers = layers or PAPER_LAYERS
    out = []
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        out.append(
            {
                "w": ParamSpec((fan_in, fan_out), ("embed", "mlp"), scale=float(2.0 / fan_in) ** 0.5),
                "b": ParamSpec((fan_out,), ("mlp",), init="zeros"),
            }
        )
    return out


def init(seed: int = 0, layers=None, *, device=None):
    return init_params(build_specs(layers), seed, device=device)


def forward(params, x):
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def loss(params, batch):
    """Mean NLL; with a ``mask`` the masked mean, whose denominator is
    ``max(sum mask, 1)`` so an all-masked batch has loss and gradient 0."""
    logits = forward(params, batch["x"])
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["y"].long()[..., None])[..., 0]
    if "mask" in batch:
        m = batch["mask"].to(torch.float32)
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def accuracy(params, x, y):
    return (torch.argmax(forward(params, x), dim=-1) == y).to(torch.float32).mean()
