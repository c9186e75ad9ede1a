"""CUDA kernel for the accumulate/flush epilogue of the async train step.

Replaces the async form's epilogue of the Pallas TPU megakernel
``train_agg_step_pallas`` (``repro/kernels/train_step.py:119``): per leaf,
the trained learners are folded into the server's accumulator and the
masked flush is applied in one pass. One launch takes every leaf it is
given (``accum_flush_leaves_cuda``, at most ``MAX_LEAVES``);
``accum_flush_cuda`` is one leaf through the same launch. The source, with
its bound and design, is ``csrc/accum_flush.cu``. The plain torch version
is ``repro_torch.kernels.ref.accum_flush_ref``.

``launches`` counts the kernel's launches in this process; set it to 0 to
start a count.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from repro_torch.kernels import _build

__all__ = ["MAX_LEAVES", "accum_flush_cuda", "accum_flush_leaves_cuda", "launches"]

launches = 0
MAX_LEAVES = 32  # the kernel parameter's capacity (csrc/accum_flush.cu)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("accum_flush")
    ptr = ctypes.c_void_p
    lib.accum_flush_leaves_f32.restype = ctypes.c_int
    lib.accum_flush_leaves_f32.argtypes = [ptr, ctypes.c_int, ptr, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_float, ptr]
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(weights: torch.Tensor, locals_: list, accs: list, servers: list) -> int:
    """Refuse what the kernel does not take; returns K. Cheap per leaf: the
    call is on the host's path once a group step."""
    if not weights.is_cuda:
        raise ValueError("accum_flush takes CUDA tensors")
    if not 1 <= len(locals_) <= MAX_LEAVES:
        raise ValueError(f"accum_flush_leaves_cuda takes 1 to {MAX_LEAVES} leaves a "
                         f"launch, got {len(locals_)}")
    if not len(accs) == len(servers) == len(locals_):
        raise ValueError(f"{len(locals_)} locals, {len(accs)} accumulators and "
                         f"{len(servers)} server leaves")
    f32, dev = torch.float32, weights.get_device()
    if weights.dtype != f32 or weights.dim() != 1 or not weights.is_contiguous():
        raise ValueError(f"weights must be a contiguous float32 (K,) tensor, got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    k = weights.shape[0]
    for x, acc, server in zip(locals_, accs, servers):
        if not (x.dtype == acc.dtype == server.dtype == f32
                and x.get_device() == acc.get_device() == server.get_device() == dev
                and x.is_contiguous() and acc.is_contiguous() and server.is_contiguous()):
            raise ValueError(f"every leaf must be a contiguous float32 tensor on "
                             f"{weights.device}, got {x.dtype}, {acc.dtype}, {server.dtype} "
                             f"on {x.device}, {acc.device}, {server.device}")
        shape = x.shape
        if not shape or shape[0] != k:
            raise ValueError(f"weights {tuple(weights.shape)} do not match the learner "
                             f"axis of {tuple(shape)}")
        if acc.shape != shape[1:] or server.shape != shape[1:]:
            raise ValueError(f"acc {tuple(acc.shape)} and server {tuple(server.shape)} "
                             f"must be a leaf of {tuple(shape)}")
    return k


def _strides(shape) -> tuple[int, ...]:
    """A contiguous tensor's strides."""
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= n
    return tuple(reversed(out))


def accum_flush_leaves_cuda(locals_: list[torch.Tensor], accs: list[torch.Tensor],
                            servers: list[torch.Tensor], weights: torch.Tensor, keep: float,
                            flush: float) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """For every leaf ``(keep * server + flush * acc1, (1 - flush) * acc1)``
    with ``acc1 = acc + sum_k weights[k] * locals_[k]``, on the card in one
    launch.

    locals_ : (K, ...) float32 leaves with one K; accs, servers : the
    matching (...) float32 leaves; weights : (K,) float32; all contiguous on
    one card, at most ``MAX_LEAVES`` leaves. keep, flush : host numbers.
    Returns (new server leaves, new accumulator leaves), each list views of
    one buffer, every leaf starting on a 16-byte boundary."""
    global launches
    k = _check(weights, locals_, accs, servers)
    shapes = [acc.shape for acc in accs]
    sizes = [acc.numel() for acc in accs]
    starts = list(itertools.accumulate(((n + 3) // 4 * 4 for n in sizes), initial=0))
    flat_s = torch.empty(starts[-1], dtype=torch.float32, device=weights.device)
    flat_a = torch.empty(starts[-1], dtype=torch.float32, device=weights.device)
    strides = [_strides(shape) for shape in shapes]
    server_out = [flat_s.as_strided(sh, st, a) for sh, st, a in zip(shapes, strides, starts)]
    acc_out = [flat_a.as_strided(sh, st, a) for sh, st, a in zip(shapes, strides, starts)]
    if starts[-1] == 0:
        return server_out, acc_out
    count = len(accs)
    ps, pa = flat_s.data_ptr(), flat_a.data_ptr()
    table = (ctypes.c_longlong * (6 * count))(*itertools.chain.from_iterable(
        (x.data_ptr(), a.data_ptr(), s.data_ptr(), ps + 4 * o, pa + 4 * o, n)
        for x, a, s, o, n in zip(locals_, accs, servers, starts, sizes)))
    lib = _lib()
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.accum_flush_leaves_f32(table, count, weights.data_ptr(), k, float(keep),
                                          float(flush), stream)
    _build.check(lib, code, "accum_flush kernel launch")
    launches += 1
    return server_out, acc_out


def accum_flush_cuda(locals_: torch.Tensor, weights: torch.Tensor, acc: torch.Tensor,
                     server: torch.Tensor, keep: float, flush: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(keep * server + flush * acc1, (1 - flush) * acc1)`` with
    ``acc1 = acc + sum_k weights[k] * locals_[k]``, on the card: one leaf
    through the all-leaf launch.

    locals_ : (K, ...) float32; weights : (K,) float32; acc, server : (...)
    float32; all contiguous on one card. keep, flush : host numbers.
    """
    server_out, acc_out = accum_flush_leaves_cuda([locals_], [acc], [server], weights, keep,
                                                  flush)
    return server_out[0], acc_out[0]
