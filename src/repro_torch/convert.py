"""Carry model parameters between the JAX reference and the port.

Both packages lay an MLP out as a list of ``{"w": (fan_in, fan_out),
"b": (fan_out,)}`` dicts; the JAX side hands over NumPy arrays (or
anything ``np.asarray`` takes), never JAX arrays through this package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(params, device=None) -> list[dict]:
    """Copy a list of ``{name: array}`` dicts into torch tensors on ``device``."""
    device = resolve_device(device)
    return [{name: torch.tensor(np.asarray(leaf), device=device)
             for name, leaf in layer.items()} for layer in params]


def params_to_numpy(params) -> list[dict]:
    """Copy a list of ``{name: tensor}`` dicts into NumPy arrays on the host."""
    return [{name: leaf.detach().cpu().numpy() for name, leaf in layer.items()}
            for layer in params]
