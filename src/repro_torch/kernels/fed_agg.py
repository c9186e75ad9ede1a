"""CUDA kernel for the weighted aggregation over the learner axis.

Replaces the Pallas TPU kernel ``fed_agg_pallas``
(``repro/kernels/fed_agg.py:30``); the source, with its bound and design,
is ``csrc/fed_agg.cu``. The plain torch version is
``repro_torch.kernels.ref.fed_agg_ref``; ``ops.fed_agg`` picks between the
two by the tensors' device.

``launches`` counts the kernel's launches in this process; set it to 0 to
start a count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["fed_agg_cuda", "launches"]

launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("fed_agg")
    lib.fed_agg_f32.restype = ctypes.c_int
    lib.fed_agg_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def fed_agg_cuda(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``sum_k weights[k] * stacked[k]`` on the card. ``stacked`` is a
    contiguous float32 (K, ...) CUDA tensor, ``weights`` a contiguous
    float32 (K,) tensor on the same device."""
    global launches
    if not (stacked.is_cuda and weights.device == stacked.device):
        raise ValueError("fed_agg_cuda takes CUDA tensors on one device")
    if stacked.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError(f"fed_agg_cuda takes float32, got {stacked.dtype}, {weights.dtype}")
    if stacked.dim() < 1 or weights.shape != stacked.shape[:1]:
        raise ValueError(f"weights {tuple(weights.shape)} do not match the learner "
                         f"axis of {tuple(stacked.shape)}")
    if not (stacked.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fed_agg_cuda takes contiguous tensors")
    out = torch.empty(stacked.shape[1:], dtype=stacked.dtype, device=stacked.device)
    lib = _lib()
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fed_agg_f32(stacked.data_ptr(), weights.data_ptr(), out.data_ptr(),
                               stacked.shape[0], out.numel(), stream)
    _build.check(lib, code, "fed_agg kernel launch")
    launches += 1
    return out
