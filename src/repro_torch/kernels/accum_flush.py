"""CUDA kernel for the accumulate/flush epilogue of the async train step.

Replaces the async form's epilogue of the Pallas TPU megakernel
``train_agg_step_pallas`` (``repro/kernels/train_step.py:119``): per leaf,
the trained learners are folded into the server's accumulator and the
masked flush is applied in one pass. The source, with its bound and
design, is ``csrc/accum_flush.cu``. The plain torch version is
``repro_torch.kernels.ref.accum_flush_ref``.

``launches`` counts the kernel's launches in this process; set it to 0 to
start a count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["accum_flush_cuda", "launches"]

launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("accum_flush")
    ptr = ctypes.c_void_p
    lib.accum_flush_f32.restype = ctypes.c_int
    lib.accum_flush_f32.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_float, ctypes.c_float,
                                    ptr, ptr, ctypes.c_int, ctypes.c_longlong, ptr]
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def accum_flush_cuda(locals_: torch.Tensor, weights: torch.Tensor, acc: torch.Tensor,
                     server: torch.Tensor, keep: float, flush: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(keep * server + flush * acc1, (1 - flush) * acc1)`` with
    ``acc1 = acc + sum_k weights[k] * locals_[k]``, on the card.

    locals_ : (K, ...) float32; weights : (K,) float32; acc, server : (...)
    float32; all contiguous on one card. keep, flush : host numbers.
    """
    global launches
    dev = locals_.device
    if not locals_.is_cuda:
        raise ValueError("accum_flush_cuda takes CUDA tensors")
    for name, t in (("locals_", locals_), ("weights", weights), ("acc", acc),
                    ("server", server)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if weights.shape != locals_.shape[:1]:
        raise ValueError(f"weights {tuple(weights.shape)} do not match the learner "
                         f"axis of {tuple(locals_.shape)}")
    if acc.shape != locals_.shape[1:] or server.shape != acc.shape:
        raise ValueError(f"acc {tuple(acc.shape)} and server {tuple(server.shape)} "
                         f"must be a leaf of {tuple(locals_.shape)}")
    server_out = torch.empty_like(server)
    acc_out = torch.empty_like(acc)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.accum_flush_f32(
            locals_.data_ptr(), weights.data_ptr(), acc.data_ptr(), server.data_ptr(),
            float(keep), float(flush), server_out.data_ptr(), acc_out.data_ptr(),
            locals_.shape[0], acc.numel(), stream)
    _build.check(lib, code, "accum_flush kernel launch")
    launches += 1
    return server_out, acc_out
