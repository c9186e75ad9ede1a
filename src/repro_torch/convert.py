"""Carry model parameters between the JAX reference and the port.

Both packages lay an MLP out as a list of ``{"w": (fan_in, fan_out),
"b": (fan_out,)}`` dicts, and a model of the zoo as a tree of dicts and
lists with ``None`` leaves (its params and its caches); the JAX side hands
over NumPy arrays (or anything ``np.asarray`` takes), never JAX arrays
through this package.

bfloat16: JAX hands its bf16 arrays to NumPy as ``ml_dtypes.bfloat16``,
which ``torch`` does not take, and ``torch`` cannot hand a bf16 tensor to
NumPy. Both directions go through float32, which holds every bf16 value
exactly, so the round trip keeps the bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["params_from_jax", "params_to_numpy", "tree_from_jax", "tree_to_numpy"]


def params_from_jax(params, device=None) -> list[dict]:
    """Copy a list of ``{name: array}`` dicts into torch tensors on ``device``."""
    device = resolve_device(device)
    return [{name: torch.tensor(np.asarray(leaf), device=device)
             for name, leaf in layer.items()} for layer in params]


def params_to_numpy(params) -> list[dict]:
    """Copy a list of ``{name: tensor}`` dicts into NumPy arrays on the host."""
    return [{name: leaf.detach().cpu().numpy() for name, leaf in layer.items()}
            for layer in params]


def _leaf_from_numpy(leaf, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.tensor(arr, device=device)


def tree_from_jax(tree, device=None):
    """Copy a tree of dicts, lists and tuples of arrays (``None`` leaves
    kept) into torch tensors on ``device``; bf16 arrays become bf16
    tensors."""
    device = resolve_device(device)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: tree_from_jax(sub, device) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_jax(sub, device) for sub in tree]
    return _leaf_from_numpy(tree, device)


def tree_to_numpy(tree):
    """Copy a tree of dicts and lists of tensors (``None`` leaves kept) into
    NumPy arrays on the host; a bf16 tensor becomes a float32 array of the
    same values."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: tree_to_numpy(sub) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(sub) for sub in tree]
    leaf = tree.detach().to("cpu", copy=True)
    return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
