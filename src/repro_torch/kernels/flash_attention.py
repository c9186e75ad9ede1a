"""CUDA kernels for GQA flash attention (causal, optional window): the
forward and its gradient.

The forward replaces the Pallas TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py:91``); the source, with its bound and
design, is ``csrc/flash_attention.cu``: bf16 operands run on the tensor
cores (wgmma, TMA loads), float32 operands on the CUDA cores. The
tensor-core kernel's TMA maps need a 16-byte-aligned base and row
strides, which every contiguous input with d in ``HEAD_DIMS`` has. The
plain torch versions are the
dense ``repro_torch.kernels.ref.flash_attention_ref`` (the oracle) and the
chunked scan ``repro_torch.models.layers.flash_attention``, which
``ops.flash_attention`` runs for a CPU tensor.

The backward (``csrc/flash_attention_bwd.cu``) has no TPU counterpart: the
reference trains through ``jax.grad`` of its plain attention, and JAX
cannot differentiate the Pallas kernel. bf16 operands run its tensor-core
kernels (wgmma, TMA rings), float32 operands its CUDA-core ones; nothing
falls back from one to the other. ``FlashAttention`` is the
``torch.autograd.Function`` that ``ops.flash_attention`` runs on the card
whenever a gradient is needed: its forward launches the forward kernel,
which also writes each row's log-sum-exp, and its backward launches the
backward kernel. Its plain version is ``ref.flash_attention_bwd_ref``.

``launches`` counts the forward kernel's launches in this process and
``bwd_launches`` the backward's (one a call: its row pass, dK/dV and dQ
kernels); set them to 0 to start a count. ``last_bwd_kernel`` names the
kernels the backward's last call launched, as its C entry reports them:
"tc" (tensor cores) or "cc" (CUDA cores); None for a call with nothing to
launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["FlashAttention", "HEAD_DIMS", "bwd_launches", "flash_attention_bwd_cuda",
           "flash_attention_cuda", "last_bwd_kernel", "launches"]

launches = 0
bwd_launches = 0
last_bwd_kernel: str | None = None
HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention_bwd")
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                                        + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.flash_attention_bwd_last_kernel.restype = ctypes.c_int
    lib.flash_attention_bwd_last_kernel.argtypes = []
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
                         causal: bool = True, window: int | None = None,
                         return_lse: bool = False):
    """GQA attention on the card. q: (B, Sq, H, d); k, v: (B, Skv, KV, d)
    with H a multiple of KV and d in ``HEAD_DIMS``; contiguous float32 or
    bfloat16 CUDA tensors of one dtype. Query and key positions both start
    at 0; ``causal`` masks keys after the query, ``window`` keys at least
    ``window`` before it. Returns (B, Sq, H, d) in q's dtype; a row with no
    key to attend to is 0. With ``return_lse`` it returns (out, lse), lse
    float32 (B, H, Sq): each row's log-sum-exp of its scaled scores, -inf
    for a row with no key."""
    global launches
    _check(q, k, v, window)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse
           else None)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_fwd(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), out.data_ptr(), b, sq, skv, h, kvh, d,
                                       int(causal), int(window or 0),
                                       None if lse is None else lse.data_ptr(), stream)
    _build.check(lib, code, "flash_attention kernel launch")
    launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention_cuda`` on the card: (dq, dk, dv)
    in q's dtype and shapes from the forward's inputs, its output ``out``
    and ``lse`` (``return_lse=True``) and the output's gradient ``dout``
    (all of the forward's layouts; ``dout`` of q's dtype). Every sum is
    taken in float32 (bf16 products on the tensor cores, with P and dS in
    two bf16 pieces); dk and dv sum the G query heads of each kv head in
    one CTA, without atomics."""
    global bwd_launches, last_bwd_kernel
    _check(q, k, v, window)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be like q {tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 {(b, h, sq)} on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_bwd(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                                       lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                       dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, kvh, d,
                                       int(causal), int(window or 0), stream)
    _build.check(lib, code, "flash_attention backward kernel launch")
    bwd_launches += 1
    last_bwd_kernel = {0: "cc", 1: "tc"}.get(lib.flash_attention_bwd_last_kernel())
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention_cuda`` with its gradient from
    ``flash_attention_bwd_cuda``: ``FlashAttention.apply(q, k, v, causal,
    window)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout.contiguous(),
                                              causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
