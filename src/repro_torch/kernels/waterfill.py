"""CUDA kernels for the batched KKT water-filling residuals.

``waterfill_residual_cuda`` replaces the Pallas TPU kernel
``waterfill_residual_pallas`` (``repro/kernels/waterfill.py:47``) and
``waterfill_energy_residual_cuda`` its energy-budgeted twin
``waterfill_energy_residual_pallas`` (``repro/kernels/waterfill.py:117``),
both in float64 and float32; the source, with its bound and design, is
``csrc/waterfill.cu``. The plain torch versions are
``repro_torch.kernels.ref.waterfill_residual_ref`` and
``waterfill_energy_residual_ref``; ``ops`` picks between kernel and plain
version by the tensors' device.

``launches`` and ``energy_launches`` count each kernel's launches in this
process; set them to 0 to start a count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["energy_launches", "launches", "waterfill_energy_residual_cuda",
           "waterfill_residual_cuda"]

launches = 0
energy_launches = 0
_ENTRY = {torch.float64: "waterfill_residual_f64", torch.float32: "waterfill_residual_f32"}
_ENERGY_ENTRY = {torch.float64: "waterfill_energy_residual_f64",
                 torch.float32: "waterfill_energy_residual_f32"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("waterfill")
    ptr = ctypes.c_void_p
    for entries, n_ptr in ((_ENTRY, 9), (_ENERGY_ENTRY, 13)):
        for name in entries.values():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ptr] * n_ptr + [ctypes.c_longlong, ctypes.c_int, ptr]
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(what: str, rows: dict, cols: dict) -> tuple[int, int]:
    """Raise unless every (B, K) row and (B,) column is a contiguous CUDA
    tensor of one float dtype on one device; returns (B, K)."""
    c2 = rows["c2"]
    if c2.dim() != 2 or c2.shape[1] < 1:
        raise ValueError(f"c2 must be (B, K) with K >= 1, got {tuple(c2.shape)}")
    b, k = c2.shape
    dtype, dev = c2.dtype, c2.device
    if dtype not in _ENTRY:
        raise ValueError(f"{what} takes float64 or float32, got {dtype}")
    if not c2.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors")
    for group, shape in ((rows, (b, k)), (cols, (b,))):
        for name, t in group.items():
            if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {dtype} {shape} on {dev}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    return b, k


def _launch(entry: str, what: str, args: list, b: int) -> torch.Tensor:
    out = torch.empty(b, dtype=args[0].dtype, device=args[0].device)
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(*(t.data_ptr() for t in args), out.data_ptr(),
                                   b, args[1].shape[1], stream)
    _build.check(lib, code, f"{what} kernel launch")
    return out


def waterfill_residual_cuda(tau_star, c2, c1, c0, T, d_lo, d_hi, total) -> torch.Tensor:
    """``sum_k clip((T - c0) / (c2 tau* + c1), d_lo, d_hi) - total`` per
    fleet, on the card. tau_star/T/total: (B,); c2/c1/c0/d_lo/d_hi: (B, K);
    all contiguous float64 or all float32 CUDA tensors on one device.
    Returns (B,) of the same dtype."""
    global launches
    b, _ = _check("waterfill_residual_cuda",
                  {"c2": c2, "c1": c1, "c0": c0, "d_lo": d_lo, "d_hi": d_hi},
                  {"tau_star": tau_star, "T": T, "total": total})
    out = _launch(_ENTRY[c2.dtype], "waterfill_residual",
                  [tau_star, c2, c1, c0, T, d_lo, d_hi, total], b)
    launches += 1
    return out


def waterfill_energy_residual_cuda(tau_star, c2, c1, c0, T, e2, e1, e0, eb, d_lo,
                                   d_hi, total) -> torch.Tensor:
    """``sum_k clip(min((T - c0) / (c2 tau* + c1), (eb - e0) / (e2 tau* +
    e1)), d_lo, d_hi) - total`` per fleet, on the card. tau_star/T/total:
    (B,); the coefficient rows, ``eb`` and the bounds: (B, K); all
    contiguous float64 or all float32 CUDA tensors on one device. Returns
    (B,) of the same dtype."""
    global energy_launches
    b, _ = _check("waterfill_energy_residual_cuda",
                  {"c2": c2, "c1": c1, "c0": c0, "e2": e2, "e1": e1, "e0": e0,
                   "eb": eb, "d_lo": d_lo, "d_hi": d_hi},
                  {"tau_star": tau_star, "T": T, "total": total})
    out = _launch(_ENERGY_ENTRY[c2.dtype], "waterfill_energy_residual",
                  [tau_star, c2, c1, c0, T, e2, e1, e0, eb, d_lo, d_hi, total], b)
    energy_launches += 1
    return out
