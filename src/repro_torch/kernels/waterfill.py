"""CUDA kernel for the batched KKT water-filling residual.

Replaces the Pallas TPU kernel ``waterfill_residual_pallas``
(``repro/kernels/waterfill.py:47``), in float64 and float32; the source,
with its bound and design, is ``csrc/waterfill.cu``. The plain torch
version is ``repro_torch.kernels.ref.waterfill_residual_ref``;
``ops.waterfill_residual`` picks between the two by the tensors' device.

``launches`` counts the kernel's launches in this process; set it to 0 to
start a count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["launches", "waterfill_residual_cuda"]

launches = 0
_ENTRY = {torch.float64: "waterfill_residual_f64", torch.float32: "waterfill_residual_f32"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("waterfill")
    ptr = ctypes.c_void_p
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr] * 9 + [ctypes.c_longlong, ctypes.c_int, ptr]
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def waterfill_residual_cuda(tau_star, c2, c1, c0, T, d_lo, d_hi, total) -> torch.Tensor:
    """``sum_k clip((T - c0) / (c2 tau* + c1), d_lo, d_hi) - total`` per
    fleet, on the card. tau_star/T/total: (B,); c2/c1/c0/d_lo/d_hi: (B, K);
    all contiguous float64 or all float32 CUDA tensors on one device.
    Returns (B,) of the same dtype."""
    global launches
    rows = {"c2": c2, "c1": c1, "c0": c0, "d_lo": d_lo, "d_hi": d_hi}
    cols = {"tau_star": tau_star, "T": T, "total": total}
    if c2.dim() != 2 or c2.shape[1] < 1:
        raise ValueError(f"c2 must be (B, K) with K >= 1, got {tuple(c2.shape)}")
    b, k = c2.shape
    dtype, dev = c2.dtype, c2.device
    if dtype not in _ENTRY:
        raise ValueError(f"waterfill_residual_cuda takes float64 or float32, got {dtype}")
    if not c2.is_cuda:
        raise ValueError("waterfill_residual_cuda takes CUDA tensors")
    for group, shape in ((rows, (b, k)), (cols, (b,))):
        for name, t in group.items():
            if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {dtype} {shape} on {dev}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    out = torch.empty(b, dtype=dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, _ENTRY[dtype])(
            tau_star.data_ptr(), c2.data_ptr(), c1.data_ptr(), c0.data_ptr(),
            T.data_ptr(), d_lo.data_ptr(), d_hi.data_ptr(), total.data_ptr(),
            out.data_ptr(), b, k, stream)
    _build.check(lib, code, "waterfill_residual kernel launch")
    launches += 1
    return out
