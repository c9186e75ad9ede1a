"""The mesh surface of the port (the mesh part of ``repro/compat.py``),
over ``torch.distributed``.

  make_mesh(shape, axis_names)  a ``Mesh`` of named axes: a ``DeviceMesh``
                                over the default process group (NCCL on the
                                card, gloo on the CPU)
  set_mesh(mesh)                context manager installing the ambient mesh
  current_mesh()                the ambient mesh (an empty one when none is
                                installed)
  shard_map(f, ...)             ``f`` on this rank's block of each input; the
                                outputs gathered back by their specs
  psum(tensors, axes, mesh)     sum in place over the mesh axes ``axes``
                                (``jax.lax.psum``)

A spec (``PartitionSpec``) has one entry a dimension: ``None`` (the
dimension is whole on every rank), an axis name, or a tuple of axis names
(the dimension split over their product, the first axis outermost), as the
reference's ``PartitionSpec``. A rank's coordinates come from the
``DeviceMesh``, whose rank layout is row-major over ``shape``.

  cost_analysis_dict(fn, ...)   the built-in count of one call of ``fn``
                                (XLA's ``cost_analysis`` in the reference)

The collectives report their payload to ``roofline.op_cost`` while a
count is active.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist

from repro_torch.roofline import op_cost

__all__ = ["Mesh", "PartitionSpec", "cost_analysis_dict", "current_mesh", "make_mesh", "psum",
           "set_mesh", "shard_map"]


class PartitionSpec(tuple):
    """One entry a dimension: ``None``, a mesh axis name or a tuple of them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """Named axes over ranks. ``shape`` maps each axis name to its size, in
    order, as the reference's ``Mesh.shape`` does; ``device_mesh`` is the
    ``DeviceMesh`` whose groups the collectives use, or None for a mesh of
    one rank made without a process group (there is nothing to send);
    ``device_type`` is the ``DeviceMesh``'s (None without one)."""

    def __init__(self, shape, axis_names, device_mesh=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axis_names)} differ "
                             "in length")
        self.shape = dict(zip(axis_names, (int(s) for s in shape)))
        self.axis_names = tuple(axis_names)
        self.device_mesh = device_mesh
        self.device_type = None if device_mesh is None else device_mesh.device_type

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)

    def block(self, axes) -> tuple[int, int]:
        """(index, count) of this rank's block of a dimension split over
        ``axes``: the row-major index of its coordinates along them."""
        index, count = 0, 1
        for a in _entry_axes(axes):
            index = index * self.shape[a] + self.coordinate(a)
            count *= self.shape[a]
        return index, count

    def __repr__(self) -> str:
        kind = "DeviceMesh" if self.device_mesh is not None else "one rank, no group"
        return f"Mesh({self.shape}, {self.device_type}, {kind})"


_EMPTY = Mesh((), ())
_ambient: contextvars.ContextVar[Mesh] = contextvars.ContextVar("mesh", default=_EMPTY)


def make_mesh(shape, axis_names) -> Mesh:
    """A mesh of ``prod(shape)`` ranks over the default process group (its
    first ranks, row-major), of the group's device type: ``"cuda"`` under
    NCCL, ``"cpu"`` under gloo. A one-rank mesh needs no group; a larger one
    raises unless the group has its ranks."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    n = math.prod(shape)
    if not dist.is_initialized():
        if n == 1:
            return Mesh(shape, axis_names)
        raise RuntimeError(f"a mesh of {n} ranks {shape} needs a process group; none is "
                           "initialized")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"a mesh of {n} ranks {shape} needs {n} ranks; the process "
                           f"group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axis_names)
    return Mesh(shape, axis_names, dm)


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Install ``mesh`` as the ambient mesh for the duration."""
    token = _ambient.set(mesh)
    try:
        yield mesh
    finally:
        _ambient.reset(token)


def current_mesh() -> Mesh:
    """The ambient mesh; an empty mesh (empty ``shape``) when none is
    installed."""
    return _ambient.get()


def _check_axes(mesh: Mesh, spec, manual) -> None:
    for entry in spec or ():
        for a in _entry_axes(entry):
            if a not in mesh.shape:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of the mesh's "
                                 f"{mesh.axis_names}")
            if a not in manual:
                raise ValueError(f"spec {spec} names axis {a!r}, which is not manual "
                                 f"here ({sorted(manual)})")


def _local(x, spec, mesh: Mesh):
    """This rank's block of ``x`` by ``spec`` (``None``: all of it)."""
    if spec is None or not torch.is_tensor(x):
        return x
    for dim, entry in enumerate(spec):
        index, count = mesh.block(entry)
        if count > 1:
            if x.shape[dim] % count:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split "
                                 f"over {count} ranks ({entry})")
            size = x.shape[dim] // count
            x = x.narrow(dim, index * size, size)
    return x


def _gather(x, spec, mesh: Mesh):
    """The whole of ``x`` from every rank's block by ``spec``: an
    ``all_gather`` along each split dimension, the innermost axis first."""
    if spec is None or mesh.device_mesh is None:
        return x
    dtype = x.dtype
    # the collectives take no bool: it travels as bytes
    x = x.to(torch.uint8) if dtype == torch.bool else x
    for dim, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            parts = [torch.empty_like(x) for _ in range(mesh.shape[a])]
            op_cost.record_collective("all-gather", mesh.shape[a] * x.numel() * x.element_size())
            dist.all_gather(parts, x.contiguous(), group=mesh.device_mesh.get_group(a))
            x = torch.cat(parts, dim=dim)
    return x.to(dtype)


def shard_map(f, *, mesh: Mesh, in_specs, out_specs, axis_names=None, check_vma=False):
    """``f`` over the blocks of its inputs: each rank calls ``f`` on its
    block of every tensor input (``in_specs``, one spec an input, ``None``
    for an input taken whole), and each output is gathered by its spec in
    ``out_specs`` (an ``all_gather`` along a split dimension; a replicated
    output is returned as this rank computed it). ``axis_names`` are the
    axes the specs may split over (``None``: all); ``check_vma`` is taken
    for the reference's signature and checks nothing. On a one-rank mesh it
    is ``f`` itself."""
    del check_vma
    manual = set(mesh.axis_names if axis_names is None else axis_names)
    single = not isinstance(out_specs, (tuple, list)) or isinstance(out_specs, PartitionSpec)
    for spec in tuple(in_specs) + ((out_specs,) if single else tuple(out_specs)):
        _check_axes(mesh, spec, manual)

    def mapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} inputs for {len(in_specs)} in_specs")
        out = f(*(_local(x, s, mesh) for x, s in zip(args, in_specs)))
        if single:
            return _gather(out, out_specs, mesh)
        return tuple(_gather(x, s, mesh) for x, s in zip(out, out_specs))

    return mapped


def psum(tensors, axes, mesh: Mesh) -> None:
    """Sum each tensor in place over the ranks along the mesh axes
    ``axes`` (an ``all_reduce`` over each axis's group in turn). Nothing
    to do without a group."""
    if mesh.device_mesh is None:
        return
    for a in _entry_axes(axes):
        group = mesh.device_mesh.get_group(a)
        for t in tensors:
            op_cost.record_collective("all-reduce", t.numel() * t.element_size())
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def cost_analysis_dict(fn, *args, **kwargs) -> dict:
    """The port's built-in count of one call ``fn(*args, **kwargs)``:
    ``{"flops": ..., "bytes accessed": ...}``, as the reference reads XLA's
    ``cost_analysis``. ``flops`` is ``torch.utils.flop_counter``'s total,
    which does not see the hand-written kernels, as XLA's count does not
    see a while body's trips: the reason ``roofline.op_cost`` exists.
    ``bytes accessed`` is ``op_cost``'s."""
    cost, flops, _ = op_cost.analyze_with_builtin(fn, *args, **kwargs)
    return {"flops": flops, "bytes accessed": float(cost.bytes)}
