"""CUDA kernel for the fused SwiGLU FFN ``down(silu(x Wg) * (x Wu))``.

Replaces the Pallas TPU kernel ``swiglu_pallas``
(``repro/kernels/swiglu.py:48``); the source, with its bound and design,
is ``csrc/swiglu.cu``. Like the TPU kernel it widens the inputs to
float32, takes every product there and returns x's dtype; the plain torch
version of that function is ``repro_torch.kernels.ref.swiglu_ref`` on the
inputs widened to float32 (on the CPU, ``ops.swiglu_fused`` runs it in x's
own dtype, as the reference's does without its kernel).

A call launches the packing pass where the operands need it, the gate/up
GEMM and the down GEMM (one design, see the source); ``launches`` counts
such calls in this process. Set it to 0 to start a count. ``H_PIECES`` is
the number of bf16 pieces h is split into for the down product
(``tests/test_torch_swiglu_split.py`` shows why two).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["H_PIECES", "launches", "swiglu_cuda"]

launches = 0
H_PIECES = 2        # csrc/swiglu.cu H_PIECES
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("swiglu")
    lib.swiglu_fwd.restype = ctypes.c_int
    lib.swiglu_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                               + [ctypes.c_void_p])
    lib.swiglu_workspace_bytes.restype = ctypes.c_longlong
    lib.swiglu_workspace_bytes.argtypes = [ctypes.c_int] * 4
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
    # TMA reads from 16-byte aligned addresses: a view that starts elsewhere is copied
    x, w_gate, w_up, w_down = (t if t.data_ptr() % 16 == 0 else t.clone()
                               for t in (x, w_gate, w_up, w_down))
    lib = _lib()
    bf16 = _DTYPES[x.dtype]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ws = torch.empty(lib.swiglu_workspace_bytes(bf16, m, d, f), dtype=torch.uint8,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.swiglu_fwd(bf16, x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                              w_down.data_ptr(), ws.data_ptr(), out.data_ptr(), m, d, f,
                              stream)
    _build.check(lib, code, "swiglu kernel launch")
    launches += 1
    return out
