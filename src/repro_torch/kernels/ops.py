"""Dispatch of the port's hot spots by the tensors' device.

A CPU tensor takes the plain torch version in ``ref`` (attention: the
chunked scan in ``models.layers``, as the reference's CPU path does; the
WKV recurrence: the step loop, or its chunked matmul form in
``models.rwkv6`` when asked for; the Mamba scan: the step loop; the fused
SwiGLU: ``layers.swiglu``), under autograd where a gradient is asked
for. A CUDA tensor launches the hand-written kernel, or the call raises:
there is no switch and no fallback to the plain version. Where a gradient
is needed on the card, attention runs ``flash_attention.FlashAttention``,
the WKV recurrence ``wkv6.WKV6`` and the Mamba scan
``mamba_scan.MambaScan``: each the forward kernel, then its backward
kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fed_agg import fed_agg_cuda, fed_agg_leaves_cuda
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention_cuda
from repro_torch.kernels.mamba_scan import MambaScan, mamba_scan_cuda
from repro_torch.kernels.swiglu import swiglu_cuda
from repro_torch.kernels.train_step import train_agg_step_cuda
from repro_torch.kernels.waterfill import (
    waterfill_energy_residual_cuda,
    waterfill_residual_cuda,
)
from repro_torch.kernels.wkv6 import WKV6, wkv6_cuda
from repro_torch.models import layers

__all__ = ["fed_agg", "fed_agg_leaves", "flash_attention", "mamba_scan", "swiglu_fused",
           "train_agg_step", "waterfill_energy_residual", "waterfill_residual", "wkv6"]


def flash_attention(q, k, v, *, causal=True, window=None, chunk=512, p_bf16=False,
                    q_block=0):
    """GQA attention, q (B, Sq, H, d), k and v (B, Skv, KV, d), positions
    from 0, causal and an optional sliding window. On the CPU the chunked
    online-softmax scan ``models.layers.flash_attention`` with its
    ``chunk``/``p_bf16``/``q_block`` knobs, differentiated by autograd; on
    the card the kernel, which ignores them, as the TPU kernel does, and
    when a gradient is needed ``FlashAttention``, whose backward is the
    backward kernel."""
    if q.device.type == "cpu":
        return layers.flash_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                                      p_bf16=p_bf16, q_block=q_block)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def wkv6(r, k, v, w, u, s0=None, *, backend="scan", chunk=16, out_state=None):
    """The RWKV-6 WKV recurrence: r, k, v, w (B, S, H, hd), u (H, hd), s0
    (B, H, hd, hd) float32 or None; returns (y float32 (B, S, H, hd),
    s_last float32 (B, H, hd, hd)). On the CPU the chunked matmul form
    ``models.rwkv6.wkv_chunked`` (with ``chunk``) when ``backend ==
    "chunked"``, else the step loop ``ref.wkv6_ref``; on the card one
    launch, whatever the backend, as the TPU kernel ran: the chunk kernel
    from ``wkv6.CHUNKED_MIN_SEQ`` steps on, the step kernel below, and when
    a gradient is needed ``WKV6``, whose backward is the backward kernel.
    ``out_state``, a float32 (B, H, hd, hd) tensor, receives s_last and is
    returned as it; it may be ``s0`` itself, which then holds the new
    state. The card takes no ``out_state`` where a gradient is needed
    (training passes none)."""
    if r.device.type == "cpu":
        if backend == "chunked":
            from repro_torch.models.rwkv6 import wkv_chunked

            y, s_last = wkv_chunked(r, k, v, w, u, s0, chunk=chunk)
        else:
            y, s_last = ref.wkv6_ref(r, k, v, w, u, s0)
        return y, (s_last if out_state is None else out_state.copy_(s_last))
    if _needs_grad(r, k, v, w, u, s0):
        if out_state is not None:
            raise ValueError("wkv6 on the card takes no out_state where a gradient is needed")
        return WKV6.apply(r, k, v, w, u, s0)
    return wkv6_cuda(r, k, v, w, u, s0, out_state=out_state)


def mamba_scan(dt, x, b, c, a, h0=None, *, out_state=None):
    """The Mamba (S6) selective scan: dt, x (B, S, D), b, c (B, S, N), a
    (D, N), h0 (B, D, N) float32 or None; returns (y float32 (B, S, D),
    h_last float32 (B, D, N)). On the CPU the step loop
    ``ref.mamba_scan_ref``; on the card the kernel, and when a gradient is
    needed ``MambaScan``, whose backward is the backward kernel.
    ``out_state``, a float32 (B, D, N) tensor, receives h_last and is
    returned as it; it may be ``h0`` itself, which then holds the new
    state. The card takes no ``out_state`` where a gradient is needed."""
    if dt.device.type == "cpu":
        y, h_last = ref.mamba_scan_ref(dt, x, b, c, a, h0)
        return y, (h_last if out_state is None else out_state.copy_(h_last))
    if _needs_grad(dt, x, b, c, a, h0):
        if out_state is not None:
            raise ValueError("mamba_scan on the card takes no out_state where a gradient is "
                             "needed")
        return MambaScan.apply(dt, x, b, c, a, h0)
    return mamba_scan_cuda(dt, x, b, c, a, h0, out_state=out_state)


def swiglu_fused(x, w_gate, w_up, w_down):
    """The fused SwiGLU FFN ``down(silu(x Wg) * (x Wu))``: x (..., d),
    w_gate and w_up (d, f), w_down (f, d). On the CPU ``layers.swiglu`` in
    x's dtype, as the reference's ``ops.swiglu`` runs without its kernel;
    on the card the kernel, which takes every product in float32 from the
    widened inputs and returns x's dtype, as the TPU kernel does."""
    if x.device.type == "cpu":
        return ref.swiglu_ref(x, w_gate, w_up, w_down)
    return swiglu_cuda(x, w_gate, w_up, w_down)


def fed_agg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum over the leading learner axis of a stacked tensor."""
    if stacked.device.type == "cpu":
        return ref.fed_agg_ref(stacked, weights)
    return fed_agg_cuda(stacked, weights)


def fed_agg_leaves(leaves: list[torch.Tensor], weights: torch.Tensor) -> list[torch.Tensor]:
    """``fed_agg`` of every leaf with the same weights: on the card one
    launch for all of them (at most ``fed_agg.MAX_LEAVES``)."""
    if weights.device.type == "cpu":
        return [ref.fed_agg_ref(x, weights) for x in leaves]
    return fed_agg_leaves_cuda(leaves, weights)


def train_agg_step(disp, x, y, m, tau, weights, lr, *, max_tau: int, groups: int = 1,
                   server=None, acc=None, keep=None, flush=None):
    """One train+aggregate step of the MLP: ``tau_k`` masked GD steps of
    ``mlp.loss`` per learner from ``disp``, then

    * cycle form (``acc=None``): the weighted aggregation of the trained
      learners; returns ``(new_model, None)``. With ``groups=G`` the
      learners are G groups of consecutive ones (a fleet of fleets), each
      aggregated into its own model (leaves (G, ...)); ``disp`` may then
      hold one start model a group;
    * async form (``server``, ``acc``, ``keep``, ``flush`` given): the
      accumulate ``acc1 = acc + sum_k w_k local_k`` and the flush; returns
      ``(keep * server + flush * acc1, (1 - flush) * acc1)``.

    ``max_tau`` is the host's bound on ``max(tau)``; ``keep`` and ``flush``
    are host numbers."""
    kw = dict(max_tau=max_tau, groups=groups, server=server, acc=acc, keep=keep,
              flush=flush)
    if x.device.type == "cpu":
        return ref.train_agg_step_ref(disp, x, y, m, tau, weights, lr, **kw)
    return train_agg_step_cuda(disp, x, y, m, tau, weights, lr, **kw)


def waterfill_residual(tau_star, c2, c1, c0, T, d_lo, d_hi, total) -> torch.Tensor:
    """Batched water-filling residual
    ``sum_k clip((T - c0) / (c2 tau* + c1), d_lo, d_hi) - total`` of a
    (B, K) fleet batch: the inner evaluation of every bisection step in
    ``core.solver_batched``."""
    if c2.device.type == "cpu":
        return ref.waterfill_residual_ref(tau_star, c2, c1, c0, T, d_lo, d_hi, total)
    return waterfill_residual_cuda(tau_star, c2, c1, c0, T, d_lo, d_hi, total)


def waterfill_energy_residual(tau_star, c2, c1, c0, T, e2, e1, e0, eb, d_lo, d_hi,
                              total) -> torch.Tensor:
    """Energy-budgeted water-filling residual
    ``sum_k clip(min((T - c0) / (c2 tau* + c1), (eb - e0) / (e2 tau* + e1)),
    d_lo, d_hi) - total`` of a (B, K) fleet batch: the inner evaluation of
    every ``kkt_energy`` bisection step. ``eb = +inf`` rows give
    ``waterfill_residual``'s bits."""
    if c2.device.type == "cpu":
        return ref.waterfill_energy_residual_ref(tau_star, c2, c1, c0, T, e2, e1, e0, eb,
                                                 d_lo, d_hi, total)
    return waterfill_energy_residual_cuda(tau_star, c2, c1, c0, T, e2, e1, e0, eb,
                                          d_lo, d_hi, total)
