"""CUDA kernel for the fused SwiGLU FFN ``down(silu(x Wg) * (x Wu))``.

Replaces the Pallas TPU kernel ``swiglu_pallas``
(``repro/kernels/swiglu.py:48``); the source, with its bound and design,
is ``csrc/swiglu.cu``. Like the TPU kernel it widens the inputs to
float32, takes every product there and returns x's dtype; the plain torch
version of that function is ``repro_torch.kernels.ref.swiglu_ref`` on the
inputs widened to float32 (on the CPU, ``ops.swiglu_fused`` runs it in x's
own dtype, as the reference's does without its kernel).

A call launches the split-f kernel and its reduction pass (the second
pass of one design, see the source); ``launches`` counts such calls in
this process. Set it to 0 to start a count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

__all__ = ["launches", "swiglu_cuda"]

launches = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_M = 64        # rows of x a CTA (csrc/swiglu.cu, BM)
_GROUP = 256         # f columns of an h tile (csrc/swiglu.cu, FG)
_CTAS_PER_SM = 2     # the split-f kernel's occupancy


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("swiglu")
    lib.swiglu_fwd.restype = ctypes.c_int
    lib.swiglu_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p])
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(x, w_gate, w_up, w_down) -> None:
    if x.dim() < 1 or w_gate.dim() != 2:
        raise ValueError(f"x must be (..., d) and w_gate (d, f), got {tuple(x.shape)} and "
                         f"{tuple(w_gate.shape)}")
    d, f = w_gate.shape
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t, shape in (("x", x, tuple(x.shape[:-1]) + (d,)), ("w_gate", w_gate, (d, f)),
                           ("w_up", w_up, (d, f)), ("w_down", w_down, (f, d))):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"swiglu_cuda takes CUDA tensors on one device; {name} is on "
                             f"{t.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name} must be x's dtype {x.dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(d, f) >= 2**31 or x.numel() // max(d, 1) >= 2**31:
        raise ValueError("swiglu_cuda takes fewer than 2**31 rows and columns")


def _splits(m: int, f: int, sms: int) -> int:
    """Splits of the f axis: enough CTAs for every SM's slots, each split
    owning at least one group of f columns (the kernel refuses others)."""
    groups = math.ceil(f / _GROUP)
    splits = max(1, min(groups, math.ceil(_CTAS_PER_SM * sms / math.ceil(m / _BLOCK_M))))
    while splits > 1 and math.ceil(groups / splits) * (splits - 1) >= groups:
        splits -= 1
    return splits


def swiglu_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """The fused SwiGLU on the card. x: (..., d); w_gate, w_up: (d, f);
    w_down: (f, d); all float32 or all bfloat16, contiguous CUDA tensors.
    The inputs are widened to float32, every product and silu(g) * u is
    taken there, and the result (..., d) is returned in x's dtype."""
    global launches
    _check(x, w_gate, w_up, w_down)
    d, f = w_gate.shape
    m = x.numel() // d if d else 0
    if m == 0 or d == 0 or f == 0:  # nothing to compute, and no launch
        return torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    lib = _lib()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = _splits(m, f, sms)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ws = torch.empty((splits, m, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.swiglu_fwd(_DTYPES[x.dtype], x.data_ptr(), w_gate.data_ptr(),
                              w_up.data_ptr(), w_down.data_ptr(), ws.data_ptr(),
                              out.data_ptr(), m, d, f, splits, stream)
    _build.check(lib, code, "swiglu kernel launch")
    launches += 1
    return out
