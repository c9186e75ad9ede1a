"""CUDA kernels for the RWKV-6 WKV recurrence: the forward (with its final
state) and its gradient.

Replace the Pallas TPU kernel ``wkv6_pallas`` (``repro/kernels/wkv6.py:58``);
the source, with its bound and design, is ``csrc/wkv6.cu``: a chunk kernel
on the tensor cores (3xTF32) for sequences of ``CHUNKED_MIN_SEQ`` steps or
more, and a step kernel for shorter ones (decode). A call is one launch of
one of them, chosen by S alone. The plain torch versions are the step loop
``repro_torch.kernels.ref.wkv6_ref`` (the oracle, and what ``ops.wkv6``
runs for a CPU tensor) and the chunked matmul form
``repro_torch.models.rwkv6.wkv_chunked``.

The backward (``csrc/wkv6_bwd.cu``) has no TPU counterpart: the reference
trains RWKV-6 through ``jax.grad`` of its plain scan, and JAX cannot
differentiate the Pallas kernel. It splits the time axis at the chunk
kernel's ``CHUNK`` steps: the chunk kernel (``csrc/wkv6_chunk.cuh``) run on
reversed time gives dv, ds0 and the state's gradient at every chunk
boundary, and a row walk a (b, h, chunk, 32 rows) gives dr, dk and dw.
``WKV6`` is the ``torch.autograd.Function`` that ``ops.wkv6`` runs on the
card whenever a gradient is needed: its forward launches the forward kernel
as above, keeping the state at every chunk boundary (``chunk_states``) for
its backward, ``wkv6_bwd_cuda``. Its plain versions are
``ref.wkv6_bwd_ref`` (written out) and autograd of ``ref.wkv6_ref``; the
CPU trains through the latter.

``launches`` counts the forward kernels' launches in this process (either
kernel) and ``bwd_launches`` the backward's calls (each launches the chunk
states' run where no states are given and there is more than one chunk,
the reversed chunk run, the row walk and du's sum); set them to 0 to start
a count. ``last_bwd_kernels`` is the number of kernels the last backward
call launched, as its C entry counted them.
``last_kernel`` names the kernel the last forward launch ran, "step" or
"chunked".
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["CHUNK", "CHUNKED_MIN_SEQ", "HEAD_DIMS", "PIECES", "SUB_CHUNK", "WKV6",
           "bwd_launches", "chunk_states_shape", "last_bwd_kernels", "last_kernel", "launches",
           "wkv6_bwd_cuda", "wkv6_cuda"]

launches = 0
bwd_launches = 0
last_bwd_kernels = 0
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
    args = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.wkv6_fwd.restype = lib.wkv6_fwd_with.restype = ctypes.c_int
    lib.wkv6_fwd.argtypes = args + [ctypes.POINTER(ctypes.c_int)]
    lib.wkv6_fwd_with.argtypes = [ctypes.c_int] + args
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library("wkv6_bwd")
    lib.wkv6_bwd.restype = ctypes.c_int
    lib.wkv6_bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    lib.wkv6_bwd_scratch.restype = ctypes.c_longlong
    lib.wkv6_bwd_scratch.argtypes = [ctypes.c_int] * 5
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


def chunk_states_shape(r: torch.Tensor) -> tuple[int, int, int, int, int]:
    """The shape of the chunk states of r's sequence: (B, H, chunks - 1,
    hd, hd), the state after each ``CHUNK``-step chunk but the last."""
    b, s, h, hd = r.shape
    return (b, h, max(-(-s // CHUNK) - 1, 0), hd, hd)


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, s0: torch.Tensor | None = None, *,
              out_state: torch.Tensor | None = None,
              kernel: str | None = None,
              chunk_states: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence on the card. r, k, v: (B, S, H, hd), float32 or
    bfloat16 of one dtype; w: (B, S, H, hd) float32; u: (H, hd) float32;
    s0: (B, H, hd, hd) float32 or None (zeros); hd in ``HEAD_DIMS``; all
    contiguous, 16-byte aligned CUDA tensors. Every product is taken in
    float32 (3xTF32 on the tensor cores in the chunk kernel). Returns
    (y float32 (B, S, H, hd), s_last float32 (B, H, hd, hd)); s_last is
    written into ``out_state`` when it is given, which may be ``s0`` itself
    (the state is then updated in place). ``kernel`` ("step" or "chunked")
    launches that kernel whatever S is, for measuring the two against each
    other; None (what the model runs) lets the C entry choose by S.
    ``chunk_states`` (``chunk_states_shape(r)``, float32) gets the state
    after each chunk but the last, as ``wkv6_bwd_cuda`` takes it; y and
    s_last are the same bits with or without it. Only the chunk kernel
    writes it: with more than one chunk, S is at least ``CHUNKED_MIN_SEQ``
    and the step kernel is refused."""
    global launches, last_kernel
    _check(r, k, v, w, u, s0, out_state)
    if kernel is not None and kernel not in _KERNELS:
        raise ValueError(f"kernel must be one of {sorted(_KERNELS)} or None, got {kernel!r}")
    if chunk_states is not None:
        _check_tensor("chunk_states", chunk_states, r.device, (torch.float32,),
                      chunk_states_shape(r))
        if kernel == "step" and chunk_states.shape[2]:
            raise ValueError("the step kernel writes no chunk states")
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
                s_last.data_ptr(), 0 if chunk_states is None else chunk_states.data_ptr(),
                b, s, h, hd, stream)
        which = ctypes.c_int(_KERNELS[kernel] if kernel is not None else -1)
        code = (lib.wkv6_fwd(*args, ctypes.byref(which)) if kernel is None
                else lib.wkv6_fwd_with(which.value, *args))
    _build.check(lib, code, "wkv6 kernel launch")
    launches += 1
    last_kernel = ("step", "chunked")[which.value]
    return y, s_last


def wkv6_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  u: torch.Tensor, dy: torch.Tensor, s0: torch.Tensor | None = None,
                  ds_last: torch.Tensor | None = None, *,
                  chunk_states: torch.Tensor | None = None):
    """The gradient of ``wkv6_cuda`` on the card: from its inputs (as
    ``wkv6_cuda`` takes them), the output's gradient dy (B, S, H, hd)
    float32 and the final state's ds_last (B, H, hd, hd) float32 or None
    (zeros), returns (dr, dk, dv in r's dtype, dw (B, S, H, hd), du (H, hd),
    ds0 (B, H, hd, hd) or None when s0 is None), all but the first three
    float32. ``chunk_states`` are the forward's (``wkv6_cuda``'s of the same
    inputs); without them the C entry computes them first, the same bits,
    so the gradients are the same either way. Every sum is taken in float32
    in a fixed order (no atomics): the bits repeat from call to call. The
    scratch allocated here holds the state's gradient at every chunk
    boundary, the chunk states when none are given, and du's partials."""
    global bwd_launches, last_bwd_kernels
    _check(r, k, v, w, u, s0, None)
    b, s, h, hd = r.shape
    f32 = (torch.float32,)
    for name, t, shape in (("dy", dy, r.shape), ("ds_last", ds_last, (b, h, hd, hd)),
                           ("chunk_states", chunk_states, chunk_states_shape(r))):
        if t is not None:
            _check_tensor(name, t, r.device, f32, tuple(shape))
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    du = torch.zeros((h, hd), dtype=torch.float32, device=r.device)
    ds0 = None if s0 is None else torch.empty_like(s0)
    if b * h == 0:  # nothing to compute, and no launch
        return dr, dk, dv, dw, du, ds0
    lib = _bwd_lib()
    launched = ctypes.c_int(0)
    scratch = torch.empty(lib.wkv6_bwd_scratch(b, s, h, hd, int(chunk_states is not None)),
                          dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.wkv6_bwd(_DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
                            w.data_ptr(), u.data_ptr(), 0 if s0 is None else s0.data_ptr(),
                            dy.data_ptr(), 0 if ds_last is None else ds_last.data_ptr(),
                            0 if chunk_states is None else chunk_states.data_ptr(),
                            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                            du.data_ptr(), 0 if ds0 is None else ds0.data_ptr(),
                            scratch.data_ptr(), b, s, h, hd, stream, ctypes.byref(launched))
    _build.check(lib, code, "wkv6 backward kernel launch")
    bwd_launches += 1
    last_bwd_kernels = launched.value
    return dr, dk, dv, dw, du, ds0


class WKV6(torch.autograd.Function):
    """``wkv6_cuda`` with its gradient from ``wkv6_bwd_cuda``:
    ``WKV6.apply(r, k, v, w, u, s0)`` returns (y, s_last), both
    differentiable; s0 may be None. Over more than one chunk the forward
    keeps the chunk states for the backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        shape = chunk_states_shape(r)
        states = (torch.empty(shape, dtype=torch.float32, device=r.device) if shape[2]
                  else None)
        y, s_last = wkv6_cuda(r, k, v, w, u, s0, chunk_states=states)
        ctx.save_for_backward(r, k, v, w, u, s0, states)
        ctx.set_materialize_grads(False)
        return y, s_last

    @staticmethod
    def backward(ctx, dy, ds_last):
        r, k, v, w, u, s0, states = ctx.saved_tensors
        dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device) if dy is None else dy
        return wkv6_bwd_cuda(r, k, v, w, u, dy.contiguous(), s0,
                             None if ds_last is None else ds_last.contiguous(),
                             chunk_states=states)
