"""Operation and byte count of one step, eager (``repro/roofline/hlo_cost.py``).

The reference parses the compiled HLO of a jitted step, loops expanded.
The port has no HLO: ``analyze_step(fn, *args, **kwargs)`` runs ``fn``
once under a ``TorchDispatchMode`` and counts every aten op it reaches,
by ``hlo_cost``'s own rules:

  * a dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``, a convolution) counts
    2 * prod(result) * prod(contracting dims), an ``addmm``'s bias add one
    more FLOP an output element (elementwise);
  * an elementwise op counts 1 FLOP an output element, a transcendental 4
    (``hlo_cost``'s constant);
  * layout ops (views, aliases, empty allocations) are free, and so are ops
    on 0-d tensors alone (the wrapping of host scalars, which torch does
    differently on each device); every other op
    moves data and counts no FLOPs (a reduction among them, as
    ``hlo_cost`` counts XLA's ``reduce``);
  * bytes are the op's operands (but 0-d ones, host scalars) plus its
    results, except where
    ``hlo_cost`` counts the touched region: a gather (``index``,
    ``index_select``, ``gather``, ``embedding``) twice its result, a
    scatter (``index_put``, ``scatter``, ``index_add``) twice its updates
    plus its indices.

Eager mode fuses nothing, so every intermediate goes out and comes back
in: the bytes are an upper bound on the step's HBM traffic, not the
traffic of a fused program. Eager loops run every trip, so the count is
loop-aware by construction (``hlo_cost`` had to expand ``while`` bodies).

Each call of a function behind ``kernels/ops.py`` is one ``kernel`` entry,
worth its ``kernel_cost`` (``ops`` reports it while a count is active);
the aten ops inside that call are not counted (on the CPU they are the
plain version's). Under a gradient the call is one autograd node, whose
backward adds the backward's ``kernel_cost`` where the card launches the
backward kernel, and counts nothing inside. A count is therefore the same
on ``meta``, on the CPU and on the card. Collectives come from the port's
own (``record_collective``, which ``compat`` calls), tallied by
``roofline.analysis.collective_bytes``.

A sharded step (DTensors) is counted per device: the mode lets DTensor
handle each op of DTensors and counts what that reaches, this rank's ops
on its local blocks; the ops DTensor runs on fake tensors at the global
shapes to propagate shapes are not counted; its collectives (the
functional ``_c10d_functional`` ops of a redistribution, an all-reduce
after a row-parallel product) are counted by kind, each worth its
output's bytes (``hlo_cost``'s rule), and move no bytes in the op count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
    _get_current_dispatch_mode_stack,
)

from repro_torch.roofline.analysis import collective_bytes

__all__ = ["CLASSES", "StepCost", "active", "analyze_step", "analyze_with_builtin", "counting",
           "kernel_call", "record_collective"]

CLASSES = ("dot", "elementwise", "transcendental", "data", "kernel")
TRANSCENDENTAL_FLOPS = 4   # hlo_cost's FLOPs an element of a transcendental

_DOT = {"mm", "bmm", "addmm", "baddbmm", "convolution"}
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum",
    "clamp", "clamp_min", "clamp_max", "where", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "sign", "floor", "ceil", "round", "trunc",
    "relu", "threshold_backward", "addcmul", "addcdiv", "lerp", "reciprocal", "remainder",
    "fmod", "floor_divide", "masked_fill", "isfinite", "isinf", "isnan", "tanh_backward",
    "sigmoid_backward", "hardtanh",
}
_TRANSCENDENTAL = {
    "exp", "exp2", "log", "log2", "log10", "log1p", "expm1", "tanh", "sqrt", "rsqrt", "pow",
    "sigmoid", "sin", "cos", "erf", "erfinv", "atan2", "silu", "silu_backward", "gelu",
    "gelu_backward", "softplus", "softplus_backward", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "logsumexp", "logit",
}
# no data touched: aliases, allocations without a write, host scalars
_FREE = {
    "detach", "alias", "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type", "set_",
    "resize_", "record_stream", "_to_copy_meta",
}
_GATHER = {"index", "index_select", "gather", "embedding"}
# DTensor's functional collectives -> ``analysis.collective_bytes``'s kinds
# (``wait_tensor`` and the rest move nothing of their own)
_COLLECTIVES = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all",
                "permute_tensor": "collective-permute"}
# op name -> (position of the updates, position of the indices)
_SCATTER = {"index_put": (2, 1), "_index_put_impl": (2, 1), "scatter": (3, 2),
            "scatter_add": (3, 2), "index_add": (3, 2)}


@dataclasses.dataclass
class StepCost:
    """A step's count: ``flops`` and ``bytes`` (Python ints), the
    collectives' ``{op: {"bytes", "count"}}`` table, the split ``by_class``
    (``{class: {"flops", "bytes"}}`` over ``CLASSES``), each kernel's
    entries (``{name: {"calls", "flops", "bytes"}}``, backward kernels
    under their own ``*_bwd`` names), ``ops``, the aten ops counted, and
    ``op_calls``, their calls by name."""

    flops: int = 0
    bytes: int = 0
    ops: int = 0
    op_calls: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=collective_bytes)
    by_class: dict = dataclasses.field(
        default_factory=lambda: {c: {"flops": 0, "bytes": 0} for c in CLASSES})
    kernels: dict = dataclasses.field(default_factory=dict)

    def add(self, cls: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.by_class[cls]["flops"] += flops
        self.by_class[cls]["bytes"] += nbytes

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        self.add("kernel", int(flops), int(nbytes))
        entry = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        entry["calls"] += 1
        entry["flops"] += int(flops)
        entry["bytes"] += int(nbytes)

    def add_collective(self, op: str, nbytes: int) -> None:
        self.collectives[op]["bytes"] += int(nbytes)
        self.collectives[op]["count"] += 1


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    name = name.removeprefix("_foreach_")
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


def _dot_flops(name: str, args, out: torch.Tensor) -> int:
    if name == "convolution":
        weight = args[1]
        return 2 * out.numel() * math.prod(weight.shape[1:])
    lhs = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2 * out.numel() * lhs.shape[-1]


class _Counter(TorchDispatchMode):
    """The counting mode: every aten op it sees goes into ``cost``."""

    def __init__(self, cost: StepCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor runs it; its local ops come back here
        if torch._C._dispatch_has_kernel_for_dispatch_key(func.name(),
                                                          "CompositeImplicitAutograd"):
            # a composite op (``einsum``) reaches the mode only where autograd
            # is off (inference mode): its parts are counted, as elsewhere
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = _op_name(func)
        if func.is_view or name in _FREE:
            return
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs + _tensors((args, kwargs))):
            return   # DTensor's shape propagation at the global shapes
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                self.cost.add_collective(kind, sum(_nbytes(t) for t in outs))
            return
        if all(t.dim() == 0 for t in outs + _tensors((args, kwargs))):
            return   # host scalars wrapped as tensors: how depends on the device
        self.cost.ops += 1
        key = str(func)
        self.cost.op_calls[key] = self.cost.op_calls.get(key, 0) + 1
        if not outs and func.overloadpacket.__name__.endswith("_"):
            outs = _tensors(args[0])   # an in-place op returning nothing (foreach)
        if name in _GATHER:
            nbytes = 2 * sum(_nbytes(t) for t in outs)
        elif name in _SCATTER:
            upd, idx = _SCATTER[name]
            flat = list(args) + list(kwargs.values())
            nbytes = (2 * sum(_nbytes(t) for t in _tensors(flat[upd:upd + 1]))
                      + sum(_nbytes(t) for t in _tensors(flat[idx:idx + 1])))
        else:
            # a 0-d operand is a host scalar (a fill value), which torch
            # passes as a tensor on some devices and not on others
            nbytes = (sum(_nbytes(t) for t in _tensors((args, kwargs)) if t.dim())
                      + sum(_nbytes(t) for t in outs))
        elems = sum(t.numel() for t in outs)
        if name in _DOT:
            flops = _dot_flops(name, args, outs[0])
            self.cost.add("dot", flops, nbytes)
            if name in ("addmm", "baddbmm"):
                self.cost.add("elementwise", elems, 0)
        elif name in _ELEMENTWISE:
            self.cost.add("elementwise", elems, nbytes)
        elif name in _TRANSCENDENTAL:
            self.cost.add("transcendental", TRANSCENDENTAL_FLOPS * elems, nbytes)
        else:
            self.cost.add("data", 0, nbytes)


def active() -> StepCost | None:
    """The innermost active count on this thread (the autograd engine's
    threads inherit it), or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _Counter):
            return mode.cost
    return None


@contextlib.contextmanager
def counting():
    """Count every aten op, kernel and collective for the duration; yields
    the ``StepCost`` being filled."""
    cost = StepCost()
    with _Counter(cost):
        yield cost


def analyze_step(fn, *args, **kwargs) -> StepCost:
    """Run ``fn(*args, **kwargs)`` once and return its count."""
    with counting() as cost:
        fn(*args, **kwargs)
    return cost


def analyze_with_builtin(fn, *args, **kwargs) -> tuple[StepCost, float, object]:
    """Run ``fn(*args, **kwargs)`` once under the count and
    ``torch.utils.flop_counter.FlopCounterMode`` together; returns (the
    count, FlopCounterMode's FLOPs, ``fn``'s output). FlopCounterMode sees
    the matrix products of aten ops only: the hand-written kernels (and
    their plain versions, hidden from every mode) are not in its total."""
    from torch.utils.flop_counter import FlopCounterMode

    builtin = FlopCounterMode(display=False)
    with builtin, counting() as cost:
        out = fn(*args, **kwargs)
    return cost, float(builtin.get_total_flops()), out


def record_collective(op: str, nbytes: int) -> None:
    """A collective of ``nbytes`` payload (``analysis.collective_bytes``'s
    op names), added to the active count if there is one."""
    cost = active()
    if cost is not None:
        cost.add_collective(op, nbytes)


@contextlib.contextmanager
def _hidden(cost: StepCost | None):
    """No dispatch mode sees the ops inside (a kernel's plain version)."""
    if cost is None:
        yield
    else:
        with _disable_current_modes():
            yield


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _contiguous(tree):
    """Every tensor of ``tree`` contiguous: the layout of the card's kernel
    outputs and gradients, and of ``meta``'s, so the ops around a call see
    one layout on every device."""
    if _is_tensor(tree):
        return tree.contiguous()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_contiguous(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _contiguous(x) for k, x in tree.items()}
    return tree


def kernel_call(name: str, run, inputs: tuple, cost, bwd=None):
    """``run(*inputs)``, the body of an ``ops`` function, as one kernel
    call: while a count is active, one ``name`` entry worth ``cost()``
    (``(flops, bytes)``) and nothing of what ``run`` does inside. Where a
    gradient is needed and ``bwd = (bwd_name, bwd_cost)`` is given, on
    ``meta`` always and elsewhere while a count is active, the call is one
    autograd node whose backward adds one ``bwd_name`` entry worth
    ``bwd_cost()``: on ``meta`` it returns empty gradients of the inputs'
    shapes, elsewhere those of the autograd graph ``run`` built (on the
    card, the backward kernel's)."""
    count = active()
    tensors = [x for x in inputs if _is_tensor(x)]
    meta = any(t.device.type == "meta" for t in tensors)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if bwd is not None and grad and (meta or count is not None):
        out = _KernelNode.apply(count, name, run, cost, bwd, meta, *inputs)
        return out[0] if len(out) == 1 else out
    if count is None:
        return run(*inputs)
    _charge(count, name, cost)
    with _hidden(count):
        return _contiguous(run(*inputs))


def _charge(count: StepCost | None, name: str, cost) -> None:
    """One ``name`` entry worth ``cost()``, whose own ops (a count that reads
    its inputs) are not counted."""
    if count is not None:
        with _hidden(count):
            flops, nbytes = cost()
        count.add_kernel(name, flops, nbytes)


def _keep(t):
    return t


class _KernelNode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, count, name, run, cost, bwd, meta, *inputs):
        _charge(count, name, cost)
        ctx.count, ctx.bwd, ctx.meta = count, bwd, meta
        ctx.set_materialize_grads(False)
        with _hidden(count):
            if meta:
                out = run(*inputs)
                ctx.wants = [(x.shape, x.dtype) if _is_tensor(x) and x.requires_grad
                             else None for x in inputs]
            else:
                # the inner graph keeps what it saves: under a checkpoint's
                # hooks its backward (a graph task of its own) would run the
                # checkpointed forward once more, out of the count's sight
                with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                        _keep, _keep):
                    leaves = [x.detach().requires_grad_(True)
                              if _is_tensor(x) and x.requires_grad else x for x in inputs]
                    out = _contiguous(run(*leaves))
                ctx.leaves = leaves
        outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        ctx.outs = None if meta else outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        _charge(ctx.count, *ctx.bwd)
        with _hidden(ctx.count):
            if ctx.meta:
                got = [None if w is None else torch.empty(w[0], dtype=w[1], device="meta")
                       for w in ctx.wants]
            else:
                pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                         if g is not None and o.requires_grad]
                wrt = [x for x in ctx.leaves if _is_tensor(x) and x.requires_grad]
                found = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                                 [g for _, g in pairs], allow_unused=True)
                             if pairs else [None] * len(wrt))
                got = _contiguous([next(found) if _is_tensor(x) and x.requires_grad
                                   else None for x in ctx.leaves])
        ctx.outs = ctx.leaves = None
        return (None,) * 6 + tuple(got)
