"""CUDA kernels for the RWKV-6 WKV recurrence (forward, with its final state).

Replace the Pallas TPU kernel ``wkv6_pallas`` (``repro/kernels/wkv6.py:58``);
the source, with its bound and design, is ``csrc/wkv6.cu``: a chunk kernel
on the tensor cores (3xTF32) for sequences of ``CHUNKED_MIN_SEQ`` steps or
more, and a step kernel for shorter ones (decode). A call is one launch of
one of them, chosen by S alone. The plain torch versions are the step loop
``repro_torch.kernels.ref.wkv6_ref`` (the oracle, and what ``ops.wkv6``
runs for a CPU tensor) and the chunked matmul form
``repro_torch.models.rwkv6.wkv_chunked``.

The kernels have no backward yet: called where a gradient is needed (grad
mode on and an input that requires grad) ``wkv6_cuda`` raises, naming
``BACKWARD_ITEM``; the CPU trains through autograd of the plain version.

``launches`` counts the kernels' launches in this process (either kernel);
set it to 0 to start a count. ``last_kernel`` names the kernel the last
launch ran, "step" or "chunked".
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["BACKWARD_ITEM", "CHUNK", "CHUNKED_MIN_SEQ", "HEAD_DIMS", "PIECES", "SUB_CHUNK",
           "last_kernel", "launches", "wkv6_cuda"]

BACKWARD_ITEM = "ROADMAP Queue 1 item 12g (the WKV-6 backward kernel)"

launches = 0
last_kernel: str | None = None
HEAD_DIMS = (32, 64, 128)
# the chunk kernel's shape (csrc/wkv6.cu): rows a chunk and a sub-chunk,
# tf32 pieces a product (3xTF32), and the shortest sequence it takes (a
# shorter one goes to the step kernel)
CHUNK = 64
SUB_CHUNK = 16
PIECES = 3
CHUNKED_MIN_SEQ = 48
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_KERNELS = {"step": 0, "chunked": 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("wkv6")
    args = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.wkv6_fwd.restype = lib.wkv6_fwd_with.restype = ctypes.c_int
    lib.wkv6_fwd.argtypes = args + [ctypes.POINTER(ctypes.c_int)]
    lib.wkv6_fwd_with.argtypes = [ctypes.c_int] + args
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def _check_tensor(name: str, t: torch.Tensor, device, dtypes, shape) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"wkv6_cuda takes CUDA tensors on one device; {name} is on "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {' or '.join(str(d) for d in dtypes)}, "
                         f"got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check(r, k, v, w, u, s0, out_state) -> None:
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, hd), got {tuple(r.shape)}")
    b, s, h, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one of {HEAD_DIMS}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k and v must be float32 or bfloat16 of one dtype, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    f32 = (torch.float32,)
    state = (b, h, hd, hd)
    for name, t, dtypes, shape in (("r", r, (r.dtype,), r.shape), ("k", k, (r.dtype,), r.shape),
                                   ("v", v, (r.dtype,), r.shape), ("w", w, f32, r.shape),
                                   ("u", u, f32, (h, hd)), ("s0", s0, f32, state),
                                   ("out_state", out_state, f32, state)):
        if t is not None:
            _check_tensor(name, t, r.device, dtypes, tuple(shape))
    if b * h * (hd // 32) >= 2**31:
        raise ValueError(f"B * H = {b * h} exceeds the grid")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, s0: torch.Tensor | None = None, *,
              out_state: torch.Tensor | None = None,
              kernel: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence on the card. r, k, v: (B, S, H, hd), float32 or
    bfloat16 of one dtype; w: (B, S, H, hd) float32; u: (H, hd) float32;
    s0: (B, H, hd, hd) float32 or None (zeros); hd in ``HEAD_DIMS``; all
    contiguous, 16-byte aligned CUDA tensors. Every product is taken in
    float32 (3xTF32 on the tensor cores in the chunk kernel). Returns
    (y float32 (B, S, H, hd), s_last float32 (B, H, hd, hd)); s_last is
    written into ``out_state`` when it is given, which may be ``s0`` itself
    (the state is then updated in place). ``kernel`` ("step" or "chunked")
    launches that kernel whatever S is, for measuring the two against each
    other; None (what the model runs) lets the C entry choose by S."""
    global launches, last_kernel
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (r, k, v, w, u, s0)):
        raise NotImplementedError("wkv6_cuda has no backward kernel yet: training RWKV-6 on "
                                  f"the card waits for {BACKWARD_ITEM}")
    _check(r, k, v, w, u, s0, out_state)
    if kernel is not None and kernel not in _KERNELS:
        raise ValueError(f"kernel must be one of {sorted(_KERNELS)} or None, got {kernel!r}")
    b, s, h, hd = r.shape
    y = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    s_last = (torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
              if out_state is None else out_state)
    if b * h == 0:  # nothing to compute, and no launch
        return y, s_last
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (_DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), 0 if s0 is None else s0.data_ptr(), y.data_ptr(),
                s_last.data_ptr(), b, s, h, hd, stream)
        which = ctypes.c_int(_KERNELS[kernel] if kernel is not None else -1)
        code = (lib.wkv6_fwd(*args, ctypes.byref(which)) if kernel is None
                else lib.wkv6_fwd_with(which.value, *args))
    _build.check(lib, code, "wkv6 kernel launch")
    launches += 1
    last_kernel = ("step", "chunked")[which.value]
    return y, s_last
