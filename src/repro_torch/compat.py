"""The mesh surface of the port (the mesh part of ``repro/compat.py``),
over ``torch.distributed``.

  make_mesh(shape, axis_names)  a ``Mesh`` of named axes: a ``DeviceMesh``
                                over the default process group (NCCL on the
                                card, gloo on the CPU)
  set_mesh(mesh)                context manager installing the ambient mesh
  current_mesh()                the ambient mesh (an empty one when none is
                                installed)
  shard_map(f, ...)             ``f`` on this rank's block of each input; the
                                outputs gathered back by their specs, or,
                                given DTensors, returned as DTensors
  on_blocks(fn, x)              ``fn`` on this rank's block of a DTensor, the
                                result placed as ``x`` (an op along whole
                                dimensions: a pad, a per-row norm)
  psum(tensors, axes, mesh)     sum in place over the mesh axes ``axes``
                                (``jax.lax.psum``)
  distribute(tree, pl, mesh)    each leaf a DTensor placed by its placements
                                (``jax.device_put`` with shardings); each
                                rank keeps its own block of a tree every
                                rank holds whole
  gather(tree)                  each DTensor leaf whole (``full_tensor``)
  placed_leaves(tree, pl)       (leaf, placements) pairs of a tree and its
                                placements tree
  local_shape(shape, pl, mesh)  the shape of one rank's block
  placed_zeros(...)             a tree of zeros made as DTensors, each rank
                                allocating its block only
  placed_ops(params)            context in which plain tensors meet DTensors
                                as replicated ones (a step's own constants)
  einsum(eq, a, b)              a product of DTensors on each rank's blocks
  spec_of(t)                    the spec of a DTensor's placements
  placed_for(t, like)           ``t`` placed as ``like`` for an elementwise op

A spec (``PartitionSpec``) has one entry a dimension: ``None`` (the
dimension is whole on every rank), an axis name, or a tuple of axis names
(the dimension split over their product, the first axis outermost), as the
reference's ``PartitionSpec``. A rank's coordinates come from the
``DeviceMesh``, whose rank layout is row-major over ``shape``.

  cost_analysis_dict(fn, ...)   the built-in count of one call of ``fn``
                                (XLA's ``cost_analysis`` in the reference)

The collectives report their payload to ``roofline.op_cost`` while a
count is active: ``psum`` and the gathers of plain ``shard_map`` through
``op_cost.record_collective``; DTensor's own (its redistributions, the
all-reduce after a row-parallel product) as the functional collectives
the counting mode sees.

A mesh made without a process group (``device_mesh is None``) places
nothing: ``distribute`` returns the tree as it is and the step runs on
plain tensors.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.roofline import op_cost

__all__ = ["Mesh", "PartitionSpec", "cost_analysis_dict", "current_mesh", "distribute", "einsum",
           "gather", "is_placed", "local_shape", "make_mesh", "mesh_of", "on_blocks", "placed_for",
           "placed_leaves", "placed_ops", "placed_zeros", "psum", "replicate_partial", "set_mesh",
           "shard_map", "spec_of"]


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


def shard_map(f, *, mesh: Mesh, in_specs, out_specs, axis_names=None, check_vma=False,
              out_partial=(), written=()):
    """``f`` over the blocks of its inputs: each rank calls ``f`` on its
    block of every tensor input (``in_specs``, one spec an input, ``None``
    for an input taken whole), and each output is gathered by its spec in
    ``out_specs`` (an ``all_gather`` along a split dimension; a replicated
    output is returned as this rank computed it). ``axis_names`` are the
    axes the specs may split over (``None``: all); ``check_vma`` is taken
    for the reference's signature and checks nothing. On a one-rank mesh it
    is ``f`` itself.

    Given DTensors (any input one), it is the reference's ``shard_map``
    over global arrays with every axis manual: each DTensor input is first
    redistributed to its spec where its placement differs (a counted
    collective), ``f`` runs on this rank's block as plain tensors, and each
    output comes back as a DTensor of the global shape placed by its spec,
    with no gather. A spec applies to every leaf of a dict or list input.
    Under autograd the gradient of an input replicated over an axis that
    some output is split over is the sum of the ranks' (the reference's
    transpose: each rank's block of the output read its own part of it);
    over an axis no output is split over, every rank computed the same,
    and so is its gradient.

    ``out_partial`` (DTensors only) names manual axes over which each
    rank's outputs are its term of a sum, where the reference's body would
    end in a ``psum``: they come back ``Partial`` there, and DTensor
    reduces them where an op needs the sum (one all-reduce, or none where
    a sum of sums follows). Their gradient reaches every rank whole.

    ``written`` (DTensors only) are the positions of inputs that ``f``
    writes into in place (a cache's state): each must be placed by its
    spec already, since a redistributed copy would take the write and
    leave the input stale; one placed otherwise raises."""
    del check_vma
    manual = set(mesh.axis_names if axis_names is None else axis_names)
    single = not isinstance(out_specs, (tuple, list)) or isinstance(out_specs, PartitionSpec)
    for spec in tuple(in_specs) + ((out_specs,) if single else tuple(out_specs)):
        _check_axes(mesh, spec, manual)

    def mapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} inputs for {len(in_specs)} in_specs")
        if any(isinstance(t, DTensor) for x in args for t in _leaves(x)):
            return _mapped_placed(f, mesh, args, in_specs, out_specs, single, manual,
                                  set(out_partial), set(written))
        if out_partial or written:
            raise ValueError("out_partial and written need DTensor inputs")
        out = f(*(_local(x, s, mesh) for x, s in zip(args, in_specs)))
        if single:
            return _gather(out, out_specs, mesh)
        return tuple(_gather(x, s, mesh) for x, s in zip(out, out_specs))

    return mapped


def _leaves(x) -> list:
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _map_leaves(fn, x):
    if isinstance(x, dict):
        return {k: _map_leaves(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map_leaves(fn, v) for v in x)
    return fn(x)


def _by_axis(spec) -> dict:
    """mesh axis -> ``Shard(dim)`` of the dimension ``spec`` splits over it."""
    return {a: Shard(dim) for dim, entry in enumerate(spec or ()) for a in _entry_axes(entry)}


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` of a contiguous block whose gradient comes back
    to the block placed as ``grads`` (a ``Partial`` output's whole on every
    rank): ``from_local``'s own ``grad_placements`` is not in every torch
    the port runs on."""

    @staticmethod
    def forward(ctx, local, dm, placements, shape, grads):
        ctx.dm, ctx.grads = dm, grads
        return DTensor.from_local(local, dm, placements, run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape))

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.grads:
            g = g.redistribute(ctx.dm, ctx.grads)
        return g.to_local(), None, None, None, None


class _SumGrad(torch.autograd.Function):
    """Identity; its backward sums a ``Partial`` gradient over the ranks
    (the reference's ``psum`` of a replicated input's cotangent), placed as
    the input."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def _mapped_placed(f, mesh: Mesh, args, in_specs, out_specs, single, manual, partial, written):
    dm = mesh.device_mesh
    if dm is None:
        raise ValueError("DTensors need a mesh with a process group; this one has none")
    names = mesh.axis_names
    if manual != set(names) or not partial <= manual:
        raise ValueError(f"a shard_map of DTensors takes every axis of {names} manual")
    specs = [out_specs] if single else list(out_specs)
    # the axes some output is split (or summed) over: an input replicated
    # there gets the ranks' summed gradient
    split_out = {a for s in specs for a in _by_axis(s)} | partial

    def enter(x, spec, i):
        if not isinstance(x, DTensor):
            if i in written and torch.is_tensor(x):
                raise ValueError(f"input {i} is written in place: pass a DTensor")
            return _local(x, spec, mesh) if torch.is_tensor(x) else x
        if x.device_mesh != dm:
            raise ValueError(f"a DTensor on {x.device_mesh} given to a shard_map on {dm}")
        by_axis = _by_axis(spec)
        want = [by_axis.get(a, Replicate()) for a in names]
        if list(x.placements) != want:
            if i in written:
                raise ValueError(f"input {i} is written in place and placed {x.placements}, "
                                 f"not {tuple(want)} as its spec {spec}: a redistributed "
                                 "copy would take the write")
            x = x.redistribute(dm, want)
        grads = [Partial() if a in split_out and not p.is_shard() else p
                 for a, p in zip(names, want)]
        if any(p.is_partial() for p in grads):
            x = _SumGrad.apply(x)
        return x.to_local(grad_placements=grads)

    def leave(y, spec):
        if not torch.is_tensor(y):
            return y
        by_axis = _by_axis(spec)
        shape = list(y.shape)
        for a, p in by_axis.items():
            shape[p.dim] *= mesh.shape[a]
        placements = [Partial() if a in partial else by_axis.get(a, Replicate())
                      for a in names]
        grads = [Replicate() if a in partial else p for a, p in zip(names, placements)]
        # the DTensor is laid out contiguous
        return _FromLocal.apply(y.contiguous(), dm, tuple(placements), torch.Size(shape),
                                tuple(grads))

    out = f(*(_map_leaves(lambda t, s=s, i=i: enter(t, s, i), x)
              for i, (x, s) in enumerate(zip(args, in_specs))))
    if single:
        return leave(out, out_specs)
    return tuple(leave(y, s) for y, s in zip(out, out_specs))


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


def is_placed(tree) -> bool:
    """Whether any leaf of ``tree`` is a DTensor."""
    return any(isinstance(t, DTensor) for t in _leaves(tree))


def mesh_of(t: DTensor) -> Mesh:
    """The ``Mesh`` of a DTensor's ``DeviceMesh``."""
    dm = t.device_mesh
    return Mesh(dm.shape, dm.mesh_dim_names, dm)


def _is_placement(x) -> bool:
    return isinstance(x, tuple) and bool(x) and all(hasattr(p, "is_shard") for p in x)


def _map_placed(fn, values, placements):
    """``fn(leaf, its placements)`` over a tree and its placements tree
    (``sharding.rules.tree_shardings``'s); ``None`` subtrees and leaves that
    are not tensors (a host ``cache_len``) stay as they are."""
    if values is None or placements is None:
        return values
    if _is_placement(placements):
        return fn(values, placements) if torch.is_tensor(values) else values
    if isinstance(values, dict):
        return {k: _map_placed(fn, v, placements[k]) for k, v in values.items()}
    return [_map_placed(fn, v, p) for v, p in zip(values, placements)]


def placed_leaves(values, placements) -> list:
    """[(leaf, its placements)] of a tree and its placements tree, for
    every tensor leaf, in the tree's own order."""
    out = []
    _map_placed(lambda t, pl: out.append((t, pl)), values, placements)
    return out


def local_shape(shape, placements, mesh: Mesh) -> list:
    """The shape of one rank's block of a ``shape`` laid out by
    ``placements`` on ``mesh``; raises where a split does not divide its
    dimension."""
    split: dict = {}
    for size, p in zip(mesh.shape.values(), placements):
        if p.is_shard():
            split[p.dim] = split.get(p.dim, 1) * size
    out = list(shape)
    for dim, n in split.items():
        if out[dim] % n:
            raise ValueError(f"a leaf of shape {tuple(shape)} does not split {n} ways along "
                             f"dimension {dim}")
        out[dim] //= n
    return out


def distribute(tree, placements_tree, mesh: Mesh):
    """Each tensor leaf of ``tree`` as a DTensor on ``mesh`` placed by its
    placements (``build_*``'s shardings), the counterpart of the
    reference's ``jax.device_put`` with shardings. Every rank holds the
    whole tree (``Model.init`` draws the same on every rank) and keeps its
    own block: nothing is sent. A leaf must lie on the mesh's device type
    (or ``meta``); a CPU tree on a CUDA mesh raises. On a mesh without a
    process group it returns ``tree`` itself."""
    if mesh.device_mesh is None:
        return tree
    from torch.distributed.tensor import distribute_tensor

    def place(t, pl):
        if isinstance(t, DTensor):
            raise ValueError("distribute takes plain tensors; this leaf is placed already")
        if t.device.type not in (mesh.device_type, "meta"):
            raise ValueError(f"a {t.device.type} tensor cannot be placed on a "
                             f"{mesh.device_type} mesh: move the tree to its device first")
        return distribute_tensor(t, mesh.device_mesh, pl, src_data_rank=None)

    return _map_placed(place, tree, placements_tree)


def replicate_partial(t):
    """``t`` with each ``Partial`` placement (a sum the ranks still owe,
    DTensor's masked lookup among them) reduced to ``Replicate``: one
    all-reduce; the other placements as they are. A plain tensor is
    returned as it is."""
    if not isinstance(t, DTensor):
        return t
    want = [Replicate() if p.is_partial() else p for p in t.placements]
    return t if want == list(t.placements) else t.redistribute(t.device_mesh, want)


def einsum(equation: str, a, b):
    """``torch.einsum(equation, a, b)``, and on DTensors the product of each
    rank's blocks, as GSPMD partitions a dot: a letter split in ``a`` stays
    so and ``b`` is split alike (a slice, nothing sent); a letter ``b``
    splits where ``a`` is replicated stays split, ``a`` sliced alike; a
    letter ``b`` splits over an axis ``a`` already uses, or where ``a`` is
    a sum still owed (``Partial``), is gathered first (FSDP's gather of a
    weight).
    An output letter is split as its operands' were; a contracted letter
    split over an axis leaves the output ``Partial`` there (a row-parallel
    product: the sum reduced where it is needed). DTensor's own einsum
    sharding differs from one torch release to the next (some refuse to
    flatten a split dimension), so the placed product goes through
    ``shard_map`` and is the same everywhere."""
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return torch.einsum(equation, a, b)
    mesh = mesh_of(a if isinstance(a, DTensor) else b)
    ins, out = equation.replace(" ", "").split("->")
    la, lb = ins.split(",")
    la, lb, out = _expand_ellipsis(la, a.dim(), lb, b.dim(), out)
    split_a = _letter_axes(a, la)
    split = dict(split_a)
    used = {ax for axes in split_a.values() for ax in axes}
    for letter, axes in _letter_axes(b, lb).items():
        if letter in split_a or used & set(axes) or (letter in la
                                                     and not _replicated(a, axes)):
            continue
        split[letter] = axes
        used |= set(axes)

    def spec(letters):
        return PartitionSpec(*(split.get(c) for c in letters))

    partial = tuple(ax for c, axes in split.items() if c not in out for ax in axes)
    return shard_map(lambda x, y: torch.einsum(f"{la},{lb}->{out}", x, y), mesh=mesh,
                     in_specs=(spec(la), spec(lb)), out_specs=spec(out),
                     out_partial=partial)(a, b)


def _expand_ellipsis(la: str, na: int, lb: str, nb: int, out: str):
    """The three subscripts with ``...`` spelled out in capital letters."""
    if "..." not in la + lb:
        return la, lb, out
    extra = max(n - len(s.replace("...", "")) for s, n in ((la, na), (lb, nb)) if "..." in s)
    fill = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"[:extra]

    def spell(s, n):
        return s.replace("...", fill[extra - (n - len(s.replace("...", ""))):])

    return spell(la, na), spell(lb, nb), out.replace("...", fill)


def _replicated(t, axes) -> bool:
    """Whether ``t`` is whole and the same on every rank of ``axes`` (a
    plain tensor is)."""
    if not isinstance(t, DTensor):
        return True
    names = t.device_mesh.mesh_dim_names
    return all(t.placements[names.index(a)].is_replicate() for a in axes)


def _letter_axes(t, letters: str) -> dict:
    """letter -> the mesh axes (in mesh order) ``t`` splits its dimension
    over; a plain tensor splits none."""
    if not isinstance(t, DTensor):
        return {}
    out: dict = {}
    for axis, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if p.is_shard():
            out[letters[p.dim]] = out.get(letters[p.dim], ()) + (axis,)
    return out


def spec_of(t) -> PartitionSpec:
    """The spec of a DTensor's placements: for each dimension, the mesh
    axes that split it, in mesh order, or ``None``; a ``Partial`` placement
    adds nothing."""
    axes: list[list[str]] = [[] for _ in range(t.dim())]
    for a, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if p.is_shard():
            axes[p.dim].append(a)
    return PartitionSpec(*(None if not e else e[0] if len(e) == 1 else tuple(e) for e in axes))


def on_blocks(fn, x):
    """``fn(x)``; given a DTensor, ``fn`` on this rank's block and the
    result placed as ``x`` (``compat.shard_map`` with ``x``'s own spec: a
    ``Partial`` is reduced first, nothing else moves). ``fn`` must act
    along the dimensions that are whole and keep the size of the split
    ones: a pad or a shift along the sequence, a norm over a row. DTensor's
    own rules for such ops are not in every torch the port runs on."""
    if not isinstance(x, DTensor):
        return fn(x)
    spec = spec_of(x)
    return shard_map(fn, mesh=mesh_of(x), in_specs=(spec,), out_specs=spec)(x)


def placed_for(t, like):
    """``t`` placed for an elementwise op with ``like`` (``t``'s dimensions
    ``like``'s trailing ones, broadcast): on each mesh axis split as
    ``like`` splits the matching dimension, else whole (an FSDP split
    gathered, a ``Partial`` reduced; a split of a dimension ``t`` holds
    whole is a slice, nothing sent). ``t`` itself when it is plain or placed
    so already. With both operands placed alike DTensor runs the op on the
    blocks as they are; given a conflict (a weight split over ``data``
    along d, the activation along the batch) it would choose a placement of
    its own, which differs between torch releases."""
    if not (isinstance(t, DTensor) and isinstance(like, DTensor)):
        return t
    off = like.dim() - t.dim()
    want = tuple(Shard(p.dim - off) if p.is_shard() and p.dim >= off
                 and t.shape[p.dim - off] == like.shape[p.dim] else Replicate()
                 for p in like.placements)
    return t if tuple(t.placements) == want else t.redistribute(t.device_mesh, want)


def gather(tree):
    """Each DTensor leaf of ``tree`` whole on every rank
    (``DTensor.full_tensor``); plain leaves as they are."""
    return _map_leaves(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def placed_zeros(abstract_tree, placements_tree, mesh: Mesh, device):
    """Zeros of each leaf's shape and dtype in ``abstract_tree`` (e.g. an
    ``abstract_cache``), as DTensors on ``mesh`` placed by their placements:
    each rank allocates its block on ``device`` only."""

    def zeros(t, pl):
        local = torch.zeros(local_shape(t.shape, pl, mesh), dtype=t.dtype, device=device)
        return DTensor.from_local(local, mesh.device_mesh, pl, run_check=False,
                                  shape=t.shape, stride=_contiguous_stride(t.shape))

    return _map_placed(zeros, abstract_tree, placements_tree)


@contextlib.contextmanager
def placed_ops(tree):
    """Where ``tree`` (a step's parameters) is placed: for the duration, a
    plain tensor that meets a DTensor in an op is taken as replicated on its
    mesh (DTensor's implicit replication), the positions, masks and
    constants a step makes for itself; the previous setting is restored on
    exit. Where it is not, nothing changes."""
    if not is_placed(tree):
        yield
        return
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def cost_analysis_dict(fn, *args, **kwargs) -> dict:
    """The port's built-in count of one call ``fn(*args, **kwargs)``:
    ``{"flops": ..., "bytes accessed": ...}``, as the reference reads XLA's
    ``cost_analysis``. ``flops`` is ``torch.utils.flop_counter``'s total,
    which does not see the hand-written kernels, as XLA's count does not
    see a while body's trips: the reason ``roofline.op_cost`` exists.
    ``bytes accessed`` is ``op_cost``'s."""
    cost, flops, _ = op_cost.analyze_with_builtin(fn, *args, **kwargs)
    return {"flops": flops, "bytes accessed": float(cost.bytes)}
