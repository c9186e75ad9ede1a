"""CUDA kernels for GQA flash attention (forward, causal, optional window).

Replaces the Pallas TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py:91``); the source, with its bound and
design, is ``csrc/flash_attention.cu``: bf16 operands run on the tensor
cores (wgmma, TMA loads), float32 operands on the CUDA cores. The
tensor-core kernel's TMA maps need a 16-byte-aligned base and row
strides, which every contiguous input with d in ``HEAD_DIMS`` has. The
plain torch versions are the
dense ``repro_torch.kernels.ref.flash_attention_ref`` (the oracle) and the
chunked scan ``repro_torch.models.layers.flash_attention``, which
``ops.flash_attention`` runs for a CPU tensor.

``launches`` counts the kernel's launches in this process; set it to 0 to
start a count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["HEAD_DIMS", "flash_attention_cuda", "launches"]

launches = 0
HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(q, k, v, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention_cuda takes CUDA tensors on one device; "
                             f"{name} is on {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention_cuda takes float32 or bfloat16 operands of "
                             f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, heads, d), got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None) -> torch.Tensor:
    """GQA attention on the card. q: (B, Sq, H, d); k, v: (B, Skv, KV, d)
    with H a multiple of KV and d in ``HEAD_DIMS``; contiguous float32 or
    bfloat16 CUDA tensors of one dtype. Query and key positions both start
    at 0; ``causal`` masks keys after the query, ``window`` keys at least
    ``window`` before it. Returns (B, Sq, H, d) in q's dtype; a row with no
    key to attend to is 0."""
    global launches
    _check(q, k, v, window)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_fwd(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), out.data_ptr(), b, sq, skv, h, kvh, d,
                                       int(causal), int(window or 0), stream)
    _build.check(lib, code, "flash_attention kernel launch")
    launches += 1
    return out
