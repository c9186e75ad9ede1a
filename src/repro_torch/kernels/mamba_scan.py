"""CUDA kernels for the Mamba (S6) selective scan: the forward (with its
final state) and its gradient.

Replaces the Pallas TPU kernel ``mamba_scan_pallas``
(``repro/kernels/mamba_scan.py:61``); the source, with its bound and
design, is ``csrc/mamba_scan.cu``. The plain torch version is the step
loop ``repro_torch.kernels.ref.mamba_scan_ref`` (the oracle, and what
``ops.mamba_scan`` runs for a CPU tensor).

The backward (``csrc/mamba_scan_bwd.cu``) has no TPU counterpart: the
reference trains Jamba through ``jax.grad`` of its ``lax.scan``, and JAX
cannot differentiate the Pallas kernel. ``MambaScan`` is the
``torch.autograd.Function`` that ``ops.mamba_scan`` runs on the card
whenever a gradient is needed: its forward launches the forward kernel,
and its backward ``mamba_scan_bwd_cuda``. Its plain versions are
``ref.mamba_scan_bwd_ref`` (written out) and autograd of
``ref.mamba_scan_ref``; the CPU trains through the latter.

``launches`` counts the forward kernel's launches in this process and
``bwd_launches`` the backward's (one a call: its reverse walk and the sums
over channel blocks and batch rows); set them to 0 to start a count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["MambaScan", "STATE_DIMS", "bwd_launches", "launches", "mamba_scan_bwd_cuda",
           "mamba_scan_cuda"]

launches = 0
bwd_launches = 0
STATE_DIMS = (4, 8, 16, 32)
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("mamba_scan")
    lib.mamba_scan_fwd.restype = ctypes.c_int
    lib.mamba_scan_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                                   + [ctypes.c_void_p])
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library("mamba_scan_bwd")
    lib.mamba_scan_bwd.restype = ctypes.c_int
    lib.mamba_scan_bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.mamba_scan_bwd_scratch.restype = ctypes.c_longlong
    lib.mamba_scan_bwd_scratch.argtypes = [ctypes.c_int] * 4
    lib.kernel_error_string.restype = ctypes.c_void_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def _check_tensor(name: str, t: torch.Tensor, device, dtypes, shape) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"mamba_scan_cuda takes CUDA tensors on one device; {name} is on "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {' or '.join(str(d) for d in dtypes)}, "
                         f"got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check(dt, x, b, c, a, h0, out_state) -> None:
    if dt.dim() != 3 or b.dim() != 3:
        raise ValueError(f"dt must be (B, S, D) and b (B, S, N), got {tuple(dt.shape)} and "
                         f"{tuple(b.shape)}")
    bsz, s, d = dt.shape
    n = b.shape[-1]
    if n not in STATE_DIMS:
        raise ValueError(f"state dim {n} is not one of {STATE_DIMS}")
    f32 = (torch.float32,)
    state = (bsz, d, n)
    for name, t, dtypes, shape in (("dt", dt, f32, (bsz, s, d)),
                                   ("x", x, tuple(_X_DTYPES), (bsz, s, d)),
                                   ("b", b, f32, (bsz, s, n)), ("c", c, f32, (bsz, s, n)),
                                   ("a", a, f32, (d, n)), ("h0", h0, f32, state),
                                   ("out_state", out_state, f32, state)):
        if t is not None:
            _check_tensor(name, t, dt.device, dtypes, shape)
    if bsz > 65535 or max(s, d) >= 2**31:
        raise ValueError(f"batch {bsz}, length {s} or width {d} exceeds the grid")


def mamba_scan_cuda(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    a: torch.Tensor, h0: torch.Tensor | None = None, *,
                    out_state: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan on the card. dt: (B, S, D) float32; x: (B, S, D)
    float32 or bfloat16 (widened exactly inside); b, c: (B, S, N) float32;
    a: (D, N) float32; h0: (B, D, N) float32 or None (zeros); N in
    ``STATE_DIMS``; all contiguous, 16-byte aligned CUDA tensors. Every
    product is taken in float32. Returns (y float32 (B, S, D), h_last
    float32 (B, D, N)); h_last is written into ``out_state`` when it is
    given, which may be ``h0`` itself (the state is then updated in
    place)."""
    global launches
    _check(dt, x, b, c, a, h0, out_state)
    bsz, s, d = dt.shape
    n = b.shape[-1]
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=dt.device)
    h_last = (torch.empty((bsz, d, n), dtype=torch.float32, device=dt.device)
              if out_state is None else out_state)
    if bsz * d == 0:  # nothing to compute, and no launch
        return y, h_last
    lib = _lib()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mamba_scan_fwd(_X_DTYPES[x.dtype], dt.data_ptr(), x.data_ptr(),
                                  b.data_ptr(), c.data_ptr(), a.data_ptr(),
                                  0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                                  h_last.data_ptr(), bsz, s, d, n, stream)
    _build.check(lib, code, "mamba_scan kernel launch")
    launches += 1
    return y, h_last


def mamba_scan_bwd_cuda(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        a: torch.Tensor, dy: torch.Tensor, h0: torch.Tensor | None = None,
                        dh_last: torch.Tensor | None = None):
    """The gradient of ``mamba_scan_cuda`` on the card: from its inputs (as
    ``mamba_scan_cuda`` takes them), the output's gradient dy (B, S, D)
    float32 and the final state's dh_last (B, D, N) float32 or None
    (zeros), returns (ddt (B, S, D), dx in x's dtype, db, dc (B, S, N), da
    (D, N), dh0 (B, D, N) or None when h0 is None), all but dx float32.
    Every sum is taken in float32 in a fixed order (no atomics): the bits
    repeat from call to call. The C entry first runs the forward recurrence
    to keep the states every 8 steps in scratch allocated here, with the
    partial sums of db, dc (over channel blocks) and da (over batch rows),
    then walks the 8-step sub-chunks back from the last, each recomputed
    with its decays kept for the walk."""
    global bwd_launches
    _check(dt, x, b, c, a, h0, None)
    bsz, s, d = dt.shape
    n = b.shape[-1]
    f32 = (torch.float32,)
    for name, t, shape in (("dy", dy, (bsz, s, d)), ("dh_last", dh_last, (bsz, d, n))):
        if t is not None:
            _check_tensor(name, t, dt.device, f32, shape)
    ddt = torch.empty_like(dt)
    dx = torch.empty_like(x)
    db, dc = torch.zeros_like(b), torch.zeros_like(c)
    da = torch.zeros_like(a)
    dh0 = None if h0 is None else torch.zeros_like(h0)
    if bsz * d == 0:  # nothing to compute, and no launch
        return ddt, dx, db, dc, da, dh0
    lib = _bwd_lib()
    scratch = torch.empty(lib.mamba_scan_bwd_scratch(bsz, s, d, n), dtype=torch.float32,
                          device=dt.device)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mamba_scan_bwd(_X_DTYPES[x.dtype], dt.data_ptr(), x.data_ptr(), b.data_ptr(),
                                  c.data_ptr(), a.data_ptr(), 0 if h0 is None else h0.data_ptr(),
                                  dy.data_ptr(),
                                  0 if dh_last is None else dh_last.data_ptr(), ddt.data_ptr(),
                                  dx.data_ptr(), db.data_ptr(), dc.data_ptr(), da.data_ptr(),
                                  0 if dh0 is None else dh0.data_ptr(), scratch.data_ptr(),
                                  bsz, s, d, n, stream)
    _build.check(lib, code, "mamba_scan backward kernel launch")
    bwd_launches += 1
    return ddt, dx, db, dc, da, dh0


class MambaScan(torch.autograd.Function):
    """``mamba_scan_cuda`` with its gradient from ``mamba_scan_bwd_cuda``:
    ``MambaScan.apply(dt, x, b, c, a, h0)`` returns (y, h_last), both
    differentiable; h0 may be None."""

    @staticmethod
    def forward(ctx, dt, x, b, c, a, h0):
        y, h_last = mamba_scan_cuda(dt, x, b, c, a, h0)
        ctx.save_for_backward(dt, x, b, c, a, h0)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, x, b, c, a, h0 = ctx.saved_tensors
        dy = torch.zeros(dt.shape, dtype=torch.float32, device=dt.device) if dy is None else dy
        return mamba_scan_bwd_cuda(dt, x, b, c, a, dy.contiguous(), h0,
                                   None if dh_last is None else dh_last.contiguous())
