"""CUDA kernels for one train+aggregate step of K learners.

Replaces the Pallas TPU megakernel ``train_agg_step_pallas``
(``repro/kernels/train_step.py:119``) in both its forms: each learner runs
``tau_k`` masked gradient steps of the MLP's masked mean NLL from its own
parameters, then

* cycle form: the trained learners are aggregated with weights ``w``, one
  ``fed_agg`` launch for every leaf; with ``groups=G`` the learners are G
  groups of consecutive ones (the fleets of a fleet of fleets), each
  aggregated into its own model by the same one launch;
* async form (``server``, ``acc``, ``keep``, ``flush`` given): they are
  folded into the accumulator and the flush applied, one ``accum_flush``
  launch for every leaf.

The training source, with its bound and design, is ``csrc/train_step.cu``:
one cooperative launch runs every step of every learner, walking the phase
plan ``_phase_plan`` builds here. The plain torch version is
``repro_torch.kernels.ref.train_agg_step_ref``; ``ops.train_agg_step``
picks between the two by the tensors' device.

``launches`` counts the training entry point's calls in this process (both
forms); set it to 0 to start a count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.accum_flush import accum_flush_leaves_cuda
from repro_torch.kernels.fed_agg import fed_agg_leaves_cuda

__all__ = ["train_agg_step_cuda", "launches"]

launches = 0
_MAX_LAYERS = 16    # csrc/train_step.cu MAX_LAYERS: the kernel's layer tables
_MAX_CLASSES = 64   # the loss gradient needs a row's logits in one 64-column tile
# the plan's op codes (csrc/train_step.cu, enum Op) and its ops a phase
_OPS = {"fwd": 1, "fwd_xent": 2, "gin": 3, "wgrad": 4, "bias": 5}
_MAX_OPS = _MAX_LAYERS + 1


def _phase_plan(n_layers: int) -> list[list[tuple[str, int]]]:
    """The phases of one GD step of an ``n_layers`` MLP, in order; each a
    list of ``(op, layer)`` items that run together between two grid syncs
    (layers count from 1; H_0 is x):

    * ``("fwd", l)``: H_l = relu(H_{l-1} W_l + b_l);
    * ``("fwd_xent", L)``: the logits H_{L-1} W_L + b_L and, in the same
      tile, the loss gradient G_L;
    * ``("gin", l)``: G_{l-1} = (G_l W_l^T) * [H_{l-1} > 0], from the old W_l;
    * ``("wgrad", l)``: W_l -= lr H_{l-1}^T G_l;
    * ``("bias", l)``: b_l -= lr colsum(G_l).

    L forward phases, L - 1 phases that carry the gradient down (G_{l-1}
    from the old W_l, with b_l's update), and one last phase that updates
    every W_l and b_1. Each weight gradient sums over the learner's rows,
    a chain as long as its shard whatever the layer's width, so the chains
    of all layers run side by side there instead of one phase each. No
    item reads what another item of its phase writes
    (``tests/test_torch_kernels.py`` runs the plan with torch ops and checks
    that)."""
    if not 1 <= n_layers <= _MAX_LAYERS:
        raise ValueError(f"the kernel takes 1 to {_MAX_LAYERS} layers, got {n_layers}")
    top = n_layers
    plan = [[("fwd", l)] for l in range(1, top)] + [[("fwd_xent", top)]]
    plan += [[("gin", l), ("bias", l)] for l in range(top, 1, -1)]
    plan.append([("wgrad", l) for l in range(1, top + 1)] + [("bias", 1)])
    return plan


def _plan_table(plan) -> "ctypes.Array":
    """The plan as the kernel's table: ``_MAX_OPS`` (op code, layer) int
    pairs a phase, (0, 0) where a phase has fewer ops."""
    flat = []
    for phase in plan:
        pairs = [(_OPS[op], layer) for op, layer in phase]
        pairs += [(0, 0)] * (_MAX_OPS - len(pairs))
        flat += [v for pair in pairs for v in pair]
    return (ctypes.c_int * len(flat))(*flat)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("train_step")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.train_cycle_f32.restype = i32
    lib.train_cycle_f32.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ctypes.c_float, i32, ptr, i32, ptr,
    ]
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [i32]
    return lib


def _check_inputs(disp, x, y, m, tau, weights, groups: int = 1) -> list[int]:
    """Validate what the kernel takes; returns the layer widths."""
    dev = x.device
    if not x.is_cuda:
        raise ValueError("train_agg_step_cuda takes CUDA tensors")
    if x.dim() != 3:
        raise ValueError(f"x must be (K, d_cap, features), got {tuple(x.shape)}")
    k, d_cap, feat = x.shape
    want = {
        "x": (x, torch.float32, (k, d_cap, feat)),
        "y": (y, torch.int32, (k, d_cap)),
        "m": (m, torch.float32, (k, d_cap)),
        "tau": (tau, torch.int32, (k,)),
        "weights": (weights, torch.float32, (k,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if groups < 1 or k % groups:
        raise ValueError(f"{k} learners do not split into {groups} groups")
    widths = [feat]
    for i, layer in enumerate(disp):
        w, b = layer["w"], layer["b"]
        rows = w.shape[0] if w.dim() == 3 else -1
        if (rows not in (k, groups) or tuple(w.shape[1:2]) != (widths[-1],)
                or tuple(b.shape) != (rows, w.shape[2])):
            raise ValueError(f"layer {i}: w {tuple(w.shape)}, b {tuple(b.shape)} do "
                             f"not chain from width {widths[-1]} over {k} learners")
        if w.dtype != torch.float32 or b.dtype != torch.float32:
            raise ValueError(f"layer {i} must be float32")
        if w.device != dev or b.device != dev:
            raise ValueError(f"layer {i} must be on {dev}")
        widths.append(int(w.shape[2]))
    if not 1 <= len(disp) <= _MAX_LAYERS:
        raise ValueError(f"the kernel takes 1 to {_MAX_LAYERS} layers, got {len(disp)}")
    if widths[-1] > _MAX_CLASSES:
        raise ValueError(f"the kernel takes 1 to {_MAX_CLASSES} classes, got widths {widths}")
    return widths


def train_agg_step_cuda(disp, x, y, m, tau, weights, lr: float, *, max_tau: int,
                        groups: int = 1, server=None, acc=None, keep=None, flush=None):
    """One train+aggregate step on the card; returns ``(new_server,
    new_acc)``, ``new_acc=None`` in cycle form (``acc=None``).

    disp : list of ``{"w": (K, fan_in, fan_out), "b": (K, fan_out)}``
        float32 — each learner's start parameters (a broadcast view is
        fine); in grouped cycle form the leaves may hold one model a group
        instead, (G, fan_in, fan_out) and (G, fan_out)
    x : (K, d_cap, F) float32; y : (K, d_cap) int32; m : (K, d_cap) float32
    tau : (K,) int32; weights : (K,) float32; all contiguous, on one card
    max_tau : the host's ``max(tau)`` bound on the steps (no device read)
    groups : G, the cycle form's aggregates: one for each of G groups of
        K / G consecutive learners, leaves (G, ...); 1 gives (...) leaves
    server, acc : the async form's server model and accumulator (lists of
        ``{"w", "b"}`` float32 leaves, contiguous); keep, flush : host numbers
    """
    global launches
    if acc is not None and groups != 1:
        raise ValueError("the async form aggregates one group")
    widths = _check_inputs(disp, x, y, m, tau, weights, groups)
    k, d_cap, _ = x.shape
    dev = x.device
    # the kernel updates the learners' parameters in place, so each
    # (possibly broadcast, or one-a-group) leaf is first copied into its own
    # (K, ...) buffer
    work = [{name: leaf.clone(memory_format=torch.contiguous_format) if leaf.shape[0] == k
             else leaf.repeat_interleave(k // groups, dim=0)
             for name, leaf in layer.items()} for layer in disp]
    ws = torch.empty(2 * k * d_cap * sum(widths[1:]), dtype=torch.float32, device=dev)
    rows = torch.empty(k, dtype=torch.int32, device=dev)
    inv_den = torch.empty(k, dtype=torch.float32, device=dev)
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    # each step's prefix sums of the learners' item counts (4 arrays of K + 1)
    prefix = torch.empty(max(int(max_tau), 1) * 4 * (k + 1), dtype=torch.int32, device=dev)
    n = len(work)
    plan = _phase_plan(n)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.train_cycle_f32(
            x.data_ptr(), y.data_ptr(), m.data_ptr(), tau.data_ptr(), k, d_cap, n,
            (ctypes.c_int * (n + 1))(*widths),
            (ctypes.c_void_p * n)(*[layer["w"].data_ptr() for layer in work]),
            (ctypes.c_void_p * n)(*[layer["b"].data_ptr() for layer in work]),
            ws.data_ptr(), rows.data_ptr(), inv_den.data_ptr(), counters.data_ptr(),
            prefix.data_ptr(), float(lr), int(max_tau), _plan_table(plan), len(plan), stream,
        )
    _build.check(lib, code, "train_agg_step kernel launch")
    launches += 1
    if acc is None:
        agg = iter(fed_agg_leaves_cuda([leaf for layer in work for leaf in layer.values()],
                                       weights, groups=groups))
        return [{name: next(agg) for name in layer} for layer in work], None
    keys = [(l, name) for l, layer in enumerate(work) for name in layer]
    servers, accs = accum_flush_leaves_cuda(
        [work[l][name] for l, name in keys], [acc[l][name] for l, name in keys],
        [server[l][name] for l, name in keys], weights, keep, flush)
    servers, accs = iter(servers), iter(accs)
    return ([{name: next(servers) for name in layer} for layer in work],
            [{name: next(accs) for name in layer} for layer in work])
