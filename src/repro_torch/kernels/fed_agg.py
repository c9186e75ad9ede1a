"""CUDA kernel for the weighted aggregation over the learner axis.

Replaces the Pallas TPU kernel ``fed_agg_pallas``
(``repro/kernels/fed_agg.py:30``); the source, with its bound and design,
is ``csrc/fed_agg.cu``. One launch aggregates every leaf it is given
(``fed_agg_leaves_cuda``, at most ``MAX_LEAVES``), and with ``groups=G``
each of G consecutive groups of learners into its own output (a fleet of
fleets); ``fed_agg_cuda`` is one leaf through the same launch. The plain
torch version is ``repro_torch.kernels.ref.fed_agg_ref``; ``ops.fed_agg``
and ``ops.fed_agg_leaves`` pick between the two by the tensors' device.

``launches`` counts the kernel's launches in this process; set it to 0 to
start a count.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math

import torch

from repro_torch.kernels import _build

__all__ = ["MAX_LEAVES", "fed_agg_cuda", "fed_agg_leaves_cuda", "launches"]

launches = 0
MAX_LEAVES = 32  # the kernel parameter's capacity (csrc/fed_agg.cu)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("fed_agg")
    lib.fed_agg_leaves_f32.restype = ctypes.c_int
    lib.fed_agg_leaves_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(x: torch.Tensor, weights: torch.Tensor) -> None:
    if not (x.is_cuda and weights.device == x.device):
        raise ValueError("fed_agg_cuda takes CUDA tensors on one device")
    if x.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError(f"fed_agg_cuda takes float32, got {x.dtype}, {weights.dtype}")
    if x.dim() < 1 or weights.shape != x.shape[:1]:
        raise ValueError(f"weights {tuple(weights.shape)} do not match the learner "
                         f"axis of {tuple(x.shape)}")
    if not (x.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fed_agg_cuda takes contiguous tensors")


def fed_agg_leaves_cuda(leaves: list[torch.Tensor], weights: torch.Tensor, *,
                        groups: int = 1) -> list[torch.Tensor]:
    """``[sum_k weights[k] * x[k] for x in leaves]`` on the card, in one
    launch. Each leaf is a contiguous float32 (N, ...) CUDA tensor with one
    N, ``weights`` a contiguous float32 (N,) tensor on the same device; at
    most ``MAX_LEAVES`` leaves. With ``groups=G`` the N = G K learners are
    G groups of K consecutive ones, and each output is (G, ...): group g's
    sum over its own K, each group the bits of a one-group launch on its
    slice. The outputs are contiguous views of one buffer."""
    global launches
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"fed_agg_leaves_cuda takes 1 to {MAX_LEAVES} leaves a launch, "
                         f"got {len(leaves)}")
    for x in leaves:
        _check(x, weights)
    n_rows = weights.shape[0]
    if groups < 1 or n_rows % groups:
        raise ValueError(f"{n_rows} learners do not split into {groups} groups")
    k = n_rows // groups
    lead = (groups,) if groups > 1 else ()
    # the outputs are views of one buffer (one allocation, not one a leaf),
    # each starting on a 16-byte boundary
    sizes = [math.prod(x.shape[1:]) for x in leaves]
    starts = list(itertools.accumulate(((groups * n + 3) // 4 * 4 for n in sizes),
                                       initial=0))
    flat = torch.empty(starts[-1], dtype=torch.float32, device=weights.device)
    outs = [flat[a:a + groups * n].view(lead + x.shape[1:])
            for a, n, x in zip(starts, sizes, leaves)]
    if starts[-1] == 0:
        return outs
    n = len(leaves)
    lib = _lib()
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fed_agg_leaves_f32(
            (ctypes.c_void_p * n)(*[x.data_ptr() for x in leaves]),
            (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]),
            (ctypes.c_longlong * n)(*sizes), n, weights.data_ptr(), k, groups, stream)
    _build.check(lib, code, "fed_agg kernel launch")
    launches += 1
    return outs


def fed_agg_cuda(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``sum_k weights[k] * stacked[k]`` on the card, one launch of the
    all-leaf kernel. ``stacked`` is a contiguous float32 (K, ...) CUDA
    tensor, ``weights`` a contiguous float32 (K,) tensor on the same device."""
    return fed_agg_leaves_cuda([stacked], weights)[0]
