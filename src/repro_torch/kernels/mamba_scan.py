"""CUDA kernel for the Mamba (S6) selective scan (forward, with its final
state).

Replaces the Pallas TPU kernel ``mamba_scan_pallas``
(``repro/kernels/mamba_scan.py:61``); the source, with its bound and
design, is ``csrc/mamba_scan.cu``. The plain torch version is the step
loop ``repro_torch.kernels.ref.mamba_scan_ref`` (the oracle, and what
``ops.mamba_scan`` runs for a CPU tensor).

The kernel has no backward yet: called where a gradient is needed (grad
mode on and an input that requires grad) ``mamba_scan_cuda`` raises,
naming ``BACKWARD_ITEM``; the CPU trains through autograd of the plain
version.

``launches`` counts the kernel's launches in this process; set it to 0 to
start a count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["BACKWARD_ITEM", "STATE_DIMS", "launches", "mamba_scan_cuda"]

BACKWARD_ITEM = "ROADMAP Queue 1 item 12h (the Mamba-scan backward kernel)"

launches = 0
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
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (dt, x, b, c, a, h0)):
        raise NotImplementedError("mamba_scan_cuda has no backward kernel yet: training Mamba "
                                  f"layers on the card waits for {BACKWARD_ITEM}")
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
