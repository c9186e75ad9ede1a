"""Tree checkpoints to ``.npz`` (``repro/checkpoint/checkpoint.py``), with
NumPy and json only.

Leaves are stored under the reference's archive names, their key paths as
``jax.tree_util.keystr`` parts joined by ``::``
(``['blocks']::[0]::['mixer']::['wq']``), so a file written by either
package restores in the other. bf16 leaves are stored as float32, which
holds every bf16 value exactly; a bf16 array the reference stored (NumPy
sees its ``ml_dtypes`` type as two raw bytes, ``|V2``) is read as the bf16
bit pattern it is. ``restore`` rebuilds into a template tree and casts
each leaf to the template's dtype, checking names and shapes.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from repro_torch import tree as _tree

__all__ = ["save", "restore", "save_metadata", "load_metadata"]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == np.dtype("V2"):   # a bf16 array, as bit patterns
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        return torch.from_numpy(bits.view(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(path: str | pathlib.Path, tree, *, step: int | None = None) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {_tree.path_str(p): _to_numpy(v) for p, v in _tree.leaves_with_path(tree)}
    np.savez(path, **arrays)
    if step is not None:
        save_metadata(path.with_suffix(".json"), {"step": step})


def restore(path: str | pathlib.Path, template, *, device=None):
    """The tree saved at ``path`` in ``template``'s structure, each leaf a
    tensor of its template's dtype on ``device`` (default: the template
    leaf's device; the CPU for a ``meta`` template)."""
    path = pathlib.Path(path)
    with np.load(path, allow_pickle=False) as z:
        def leaf(p, tmpl):
            key = _tree.path_str(p)
            if key not in z:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = z[key]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"{key}: shape {arr.shape} != template {tuple(tmpl.shape)}")
            dev = device if device is not None else (
                "cpu" if tmpl.device.type == "meta" else tmpl.device)
            return _from_numpy(arr).to(device=dev, dtype=tmpl.dtype)

        return _map_with_path(leaf, template, ())


def _map_with_path(fn, tree, path):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _map_with_path(fn, sub, path + (key,)) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, sub, path + (i,)) for i, sub in enumerate(tree)]
    return fn(path, tree)


def save_metadata(path, meta: dict) -> None:
    pathlib.Path(path).write_text(json.dumps(meta))


def load_metadata(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())
