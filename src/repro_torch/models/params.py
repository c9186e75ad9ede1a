"""Parameter specs and the port's deterministic init.

``ParamSpec`` keeps the reference's fields (``repro/models/params.py``).
``init_params`` draws each leaf from its own CPU ``torch.Generator``,
seeded from the init seed and ``zlib.crc32`` of the leaf's path (the
reference's ``keystr`` form, e.g. ``[0]['w']``), so a draw does not depend
on the process or on the order of the leaves. It cannot reproduce
``jax.random``'s threefry bits: to compare the two packages, carry the
reference's weights across with ``repro_torch.convert.params_from_jax``
(an MLP) or ``tree_from_jax`` (any tree, the model zoo's among them).

``abstract_params`` is the twin of the reference's ``ShapeDtypeStruct``
tree: tensors on the ``meta`` device, which carry shape and dtype and
allocate nothing.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["ParamSpec", "init_params", "abstract_params", "logical_axes", "param_count"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"           # normal | zeros | ones | decay | s4d | dt_bias
    scale: float | None = None     # stddev override (default fan-in)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _materialize(spec: ParamSpec, path: str, seed: int) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype)
    if spec.init == "decay":
        # small negative values -> exp(-exp(w)) decay close to 1
        return torch.full(spec.shape, -2.0, dtype=spec.dtype)
    if spec.init == "s4d":
        # S4D-real: A_log[d, n] = log(n + 1) per state column, in float32
        n = spec.shape[-1]
        col = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
        return col.expand(spec.shape).to(spec.dtype, copy=True)
    if spec.init == "dt_bias":
        # softplus^-1(dt) for dt ~ 0.001..0.1, around -4.6
        return torch.full(spec.shape, -4.6, dtype=spec.dtype)
    if spec.init == "normal":
        h = zlib.crc32(path.encode()) % (2**31 - 1)
        gen = torch.Generator().manual_seed(int(seed) * (2**31 - 1) + h)
        fan_in = spec.shape[0] if len(spec.shape) == 1 else int(np.prod(spec.shape[:-1]))
        scale = spec.scale if spec.scale is not None else 1.0 / max(np.sqrt(fan_in), 1.0)
        return (torch.randn(spec.shape, generator=gen) * scale).to(spec.dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(specs, seed: int, *, device=None):
    """Materialize a spec tree (lists and dicts of ``ParamSpec``, ``None``
    leaves kept) into tensors on ``device``. The draws are made on the
    CPU, so every device gets the same values."""
    device = resolve_device(device)

    def build(tree, path):
        if tree is None:
            return None
        if isinstance(tree, ParamSpec):
            return _materialize(tree, path, seed).to(device)
        if isinstance(tree, dict):
            return {key: build(sub, f"{path}[{key!r}]") for key, sub in tree.items()}
        return [build(sub, f"{path}[{i}]") for i, sub in enumerate(tree)]

    return build(specs, "")


def _map_specs(fn, tree):
    """``fn`` on every ``ParamSpec`` of a tree of dicts and lists; ``None``
    leaves stay ``None``."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {key: _map_specs(fn, sub) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_specs(fn, sub) for sub in tree]
    return tree


def abstract_params(specs):
    """The spec tree as ``meta`` tensors: shapes and dtypes, no storage."""
    return _map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def logical_axes(specs):
    """The tree of logical-axis tuples matching the params tree."""
    return _map_specs(lambda s: s.axes, specs)


def param_count(specs) -> int:
    count = 0

    def add(spec):
        nonlocal count
        count += int(np.prod(spec.shape))

    _map_specs(add, specs)
    return count
