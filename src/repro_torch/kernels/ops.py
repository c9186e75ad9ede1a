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
kernel. A ``meta`` tensor computes nothing: the function returns empty
``meta`` outputs of the card's shapes and dtypes (under a gradient, through
one autograd node whose backward returns empty gradients of the inputs'
shapes), which is what the dry run (``launch.dryrun``) traces a full-size
step with. Any other device raises.

Given DTensors (a sharded step's activations), ``flash_attention``,
``wkv6`` and ``mamba_scan`` run the same dispatch on this rank's block
through ``compat.shard_map``, an input placed any other way redistributed
first (a counted collective):

  flash_attention  q, k, v (B, S, heads, d): the batch over the
                   ``pod``/``data`` axes, the heads over ``model``;
  wkv6             r, k, v, w (B, S, H, hd) and u (H, hd): the batch as r
                   is split, the heads as r's are (``model``); s0 and
                   out_state (B, H, hd, hd) as the cache (``("batch",
                   "heads", None, None)``);
  mamba_scan       dt, x (B, S, D) and a (D, N): the batch as dt is split,
                   D as dt's (``model``); b, c (B, S, N) whole over the
                   channels' axes (their gradient the ranks' sum); h0 and
                   out_state (B, D, N) as the cache (``("batch", "mlp",
                   "state")``).

An ``out_state`` must already be placed so: the kernel writes the local
block of the cache itself, and a redistributed copy raises rather than
take the write. Inside the block each is this function on plain tensors:
the plain version on the CPU, the kernel on the card, its autograd
Function under a gradient. A DTensor that reaches any other kernel raises:
no kernel is handed a DTensor, and nothing is gathered in silence.

Each function is one kernel call to ``roofline.op_cost``: while a count is
active (``op_cost.analyze_step``) it adds the function's work from
``roofline.kernel_cost`` (and, under a gradient, the backward's), on
every device alike; outside a count the call adds nothing and waits for
nothing.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch import compat
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
from repro_torch.roofline import kernel_cost, op_cost

__all__ = ["fed_agg", "fed_agg_leaves", "flash_attention", "mamba_scan", "swiglu_fused",
           "train_agg_step", "waterfill_energy_residual", "waterfill_residual", "wkv6"]


def _route(t: torch.Tensor) -> str:
    if isinstance(t, DTensor):
        raise TypeError("a DTensor reached a kernel's dispatch: only flash_attention, wkv6 and "
                        "mamba_scan take DTensors, through compat.shard_map on each rank's "
                        "block")
    kind = t.device.type
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"the port's kernels take cpu, cuda or meta tensors, not {t.device}")
    return kind


def _all_placed(name: str, *tensors) -> None:
    if not all(isinstance(t, DTensor) for t in tensors if t is not None):
        raise TypeError(f"{name} takes its tensors all DTensors or all plain tensors")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def flash_attention(q, k, v, *, causal=True, window=None, chunk=512, p_bf16=False,
                    q_block=0):
    """GQA attention, q (B, Sq, H, d), k and v (B, Skv, KV, d), positions
    from 0, causal and an optional sliding window. On the CPU the chunked
    online-softmax scan ``models.layers.flash_attention`` with its
    ``chunk``/``p_bf16``/``q_block`` knobs, differentiated by autograd; on
    the card the kernel, which ignores them, as the TPU kernel does, and
    when a gradient is needed ``FlashAttention``, whose backward is the
    backward kernel. Given DTensors, each rank runs this on its block
    (``_attention_on_blocks``) and the result is a DTensor."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        return _attention_on_blocks(q, k, v, causal=causal, window=window, chunk=chunk,
                                    p_bf16=p_bf16, q_block=q_block)
    route = _route(q)

    def run(q, k, v):
        if route == "cpu":
            return layers.flash_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                                          p_bf16=p_bf16, q_block=q_block)
        if route == "meta":
            return _meta(q.shape, q.dtype)
        if _needs_grad(q, k, v):
            return FlashAttention.apply(q, k, v, causal, window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)

    dims = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3])
    kw = dict(causal=causal, window=window, itemsize=q.element_size())
    return op_cost.kernel_call(
        "flash_attention", run, (q, k, v), lambda: kernel_cost.flash_attention(*dims, **kw),
        ("flash_attention_bwd", lambda: kernel_cost.flash_attention_bwd(*dims, **kw)))


def _attention_on_blocks(q, k, v, **kw):
    """``flash_attention`` of DTensors, each rank on its block: the batch
    split as q's is (k and v brought to it), the q heads over
    ``model`` where they divide, the k/v heads too where they divide. Where
    the q heads split and the k/v heads do not (a GQA model whose KV heads
    are fewer than the model axis), each rank holds every k/v head and cuts
    them to the ones its q heads read before the launch, so that the kernel
    sees a head ratio with the right groups; their gradient is then the
    ranks' sum. The output is placed as q's spec."""
    _all_placed("flash_attention", q, k, v)
    mesh = compat.mesh_of(q)
    h, kv = q.shape[2], k.shape[2]
    m = mesh.shape.get("model", 1)
    heads = "model" if "model" in mesh.shape and h % m == 0 else None
    batch = tuple(a for a, p in zip(mesh.axis_names, q.placements)
                  if p.is_shard(0) and a != heads) or None
    kv_heads = "model" if heads and kv % m == 0 else None
    group, local_h = h // kv, h // m
    if heads and not kv_heads and local_h % group and group % local_h:
        raise ValueError(f"{h} q heads over a {m}-way model axis straddle the groups of "
                         f"{kv} k/v heads")
    qspec = compat.PartitionSpec(batch, None, heads, None)
    kspec = compat.PartitionSpec(batch, None, kv_heads, None)

    def block(q, k, v):
        if heads and not kv_heads:
            first = mesh.coordinate("model") * local_h // group
            n = max(1, local_h // group)
            k, v = k.narrow(2, first, n).contiguous(), v.narrow(2, first, n).contiguous()
        return flash_attention(q, k, v, **kw)

    return compat.shard_map(block, mesh=mesh, in_specs=(qspec, kspec, kspec),
                            out_specs=qspec)(q, k, v)


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
    (training passes none). The backward's count takes no state gradient
    (training's). Given DTensors, each rank runs this on its block
    (``_wkv6_on_blocks``) and the results are DTensors."""
    if any(isinstance(t, DTensor) for t in (r, k, v, w, u, s0, out_state)):
        return _wkv6_on_blocks(r, k, v, w, u, s0, out_state, backend=backend, chunk=chunk)
    route = _route(r)

    def run(r, k, v, w, u, s0):
        if route == "cpu":
            if backend == "chunked":
                from repro_torch.models.rwkv6 import wkv_chunked

                y, s_last = wkv_chunked(r, k, v, w, u, s0, chunk=chunk)
            else:
                y, s_last = ref.wkv6_ref(r, k, v, w, u, s0)
            return y, (s_last if out_state is None else out_state.copy_(s_last))
        if route == "meta":
            b, s, h, hd = r.shape
            return (_meta((b, s, h, hd), torch.float32),
                    _meta((b, h, hd, hd), torch.float32) if out_state is None else out_state)
        if _needs_grad(r, k, v, w, u, s0):
            if out_state is not None:
                raise ValueError("wkv6 on the card takes no out_state where a gradient is "
                                 "needed")
            return WKV6.apply(r, k, v, w, u, s0)
        return wkv6_cuda(r, k, v, w, u, s0, out_state=out_state)

    kw = dict(itemsize=r.element_size(), with_state=s0 is not None)
    return op_cost.kernel_call(
        "wkv6", run, (r, k, v, w, u, s0), lambda: kernel_cost.wkv6(*r.shape, **kw),
        ("wkv6_bwd", lambda: kernel_cost.wkv6_bwd(*r.shape, **kw)))


def _wkv6_on_blocks(r, k, v, w, u, s0, out_state, **kw):
    """``wkv6`` of DTensors, each rank on its block: the batch and the heads
    split as r's are (the heads over ``model``, where the column-parallel
    r/k/v/g products put them), k, v, w alike, u's heads and the states'
    batch and heads likewise. ``out_state`` (the placed cache's state) is
    written in place on each rank's block. y and s_last come back placed
    so; u's gradient is the sum over the batch's ranks."""
    _all_placed("wkv6", r, k, v, w, u, s0, out_state)
    batch, _, heads, _ = compat.spec_of(r)
    seq = compat.PartitionSpec(batch, None, heads, None)
    state = compat.PartitionSpec(batch, heads, None, None)

    def block(r, k, v, w, u, s0, out_state):
        return wkv6(r, k, v, w, u, s0, out_state=out_state, **kw)

    return compat.shard_map(block, mesh=compat.mesh_of(r),
                            in_specs=(seq, seq, seq, seq, compat.PartitionSpec(heads, None),
                                      state, state),
                            out_specs=(seq, state), written=(6,))(r, k, v, w, u, s0, out_state)


def mamba_scan(dt, x, b, c, a, h0=None, *, out_state=None):
    """The Mamba (S6) selective scan: dt, x (B, S, D), b, c (B, S, N), a
    (D, N), h0 (B, D, N) float32 or None; returns (y float32 (B, S, D),
    h_last float32 (B, D, N)). On the CPU the step loop
    ``ref.mamba_scan_ref``; on the card the kernel, and when a gradient is
    needed ``MambaScan``, whose backward is the backward kernel.
    ``out_state``, a float32 (B, D, N) tensor, receives h_last and is
    returned as it; it may be ``h0`` itself, which then holds the new
    state. The card takes no ``out_state`` where a gradient is needed.
    Given DTensors, each rank runs this on its block (``_scan_on_blocks``)
    and the results are DTensors."""
    if any(isinstance(t, DTensor) for t in (dt, x, b, c, a, h0, out_state)):
        return _scan_on_blocks(dt, x, b, c, a, h0, out_state)
    route = _route(dt)

    def run(dt, x, b, c, a, h0):
        if route == "cpu":
            y, h_last = ref.mamba_scan_ref(dt, x, b, c, a, h0)
            return y, (h_last if out_state is None else out_state.copy_(h_last))
        if route == "meta":
            return (_meta(dt.shape, torch.float32),
                    _meta((dt.shape[0], dt.shape[2], a.shape[1]), torch.float32)
                    if out_state is None else out_state)
        if _needs_grad(dt, x, b, c, a, h0):
            if out_state is not None:
                raise ValueError("mamba_scan on the card takes no out_state where a gradient "
                                 "is needed")
            return MambaScan.apply(dt, x, b, c, a, h0)
        return mamba_scan_cuda(dt, x, b, c, a, h0, out_state=out_state)

    dims = (*dt.shape, a.shape[1])
    kw = dict(itemsize=x.element_size(), with_state=h0 is not None)
    return op_cost.kernel_call(
        "mamba_scan", run, (dt, x, b, c, a, h0), lambda: kernel_cost.mamba_scan(*dims, **kw),
        ("mamba_scan_bwd", lambda: kernel_cost.mamba_scan_bwd(*dims, **kw)))


def _scan_on_blocks(dt, x, b, c, a, h0, out_state):
    """``mamba_scan`` of DTensors, each rank on its block: the batch and the
    channels split as dt's are (the channels over ``model``, as d_inner's
    weights are), x and a's channels alike, the states' batch and channels
    likewise; b and c split as the batch only, whole over the channels'
    axes, so that their gradient is the sum over those ranks (the
    reference's transpose of a replicated input), a's over the batch's.
    ``out_state`` (the placed cache's state) is written in place on each
    rank's block."""
    _all_placed("mamba_scan", dt, x, b, c, a, h0, out_state)
    batch, _, chans = compat.spec_of(dt)
    seq = compat.PartitionSpec(batch, None, chans)
    whole = compat.PartitionSpec(batch, None, None)
    state = compat.PartitionSpec(batch, chans, None)
    return compat.shard_map(
        lambda dt, x, b, c, a, h0, out_state: mamba_scan(dt, x, b, c, a, h0,
                                                         out_state=out_state),
        mesh=compat.mesh_of(dt),
        in_specs=(seq, seq, whole, whole, compat.PartitionSpec(chans, None), state, state),
        out_specs=(seq, state), written=(6,))(dt, x, b, c, a, h0, out_state)


def swiglu_fused(x, w_gate, w_up, w_down):
    """The fused SwiGLU FFN ``down(silu(x Wg) * (x Wu))``: x (..., d),
    w_gate and w_up (d, f), w_down (f, d). On the CPU ``layers.swiglu`` in
    x's dtype, as the reference's ``ops.swiglu`` runs without its kernel;
    on the card the kernel, which takes every product in float32 from the
    widened inputs and returns x's dtype, as the TPU kernel does."""
    route = _route(x)

    def run(x, w_gate, w_up, w_down):
        if route == "cpu":
            return ref.swiglu_ref(x, w_gate, w_up, w_down)
        if route == "meta":
            return _meta(x.shape, x.dtype)
        return swiglu_cuda(x, w_gate, w_up, w_down)

    m, (d, f) = x.numel() // x.shape[-1], w_gate.shape
    return op_cost.kernel_call(
        "swiglu", run, (x, w_gate, w_up, w_down),
        lambda: kernel_cost.swiglu(m, d, f, itemsize=x.element_size()))


def fed_agg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum over the leading learner axis of a stacked tensor."""
    route = _route(stacked)

    def run(stacked, weights):
        if route == "cpu":
            return ref.fed_agg_ref(stacked, weights)
        if route == "meta":
            return _meta(stacked.shape[1:], stacked.dtype)
        return fed_agg_cuda(stacked, weights)

    return op_cost.kernel_call(
        "fed_agg", run, (stacked, weights),
        lambda: kernel_cost.fed_agg(stacked[0].numel(), stacked.shape[0],
                                    itemsize=stacked.element_size()))


def fed_agg_leaves(leaves: list[torch.Tensor], weights: torch.Tensor) -> list[torch.Tensor]:
    """``fed_agg`` of every leaf with the same weights: on the card one
    launch for all of them (at most ``fed_agg.MAX_LEAVES``)."""
    route = _route(weights)

    def run(weights):
        if route == "cpu":
            return [ref.fed_agg_ref(x, weights) for x in leaves]
        if route == "meta":
            return [_meta(x.shape[1:], x.dtype) for x in leaves]
        return fed_agg_leaves_cuda(leaves, weights)

    return op_cost.kernel_call(
        "fed_agg", run, (weights,),
        lambda: kernel_cost.fed_agg_leaves([x[0].numel() for x in leaves], weights.shape[0],
                                           itemsize=leaves[0].element_size()))


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
    are host numbers. Its count reads the row-steps sum tau_k d_k from
    ``tau`` and ``m`` (a wait on the card, while counting only); on
    ``meta``, which holds no values, it counts ``max_tau`` steps of every
    row, the most the call could need."""
    kw = dict(max_tau=max_tau, groups=groups, server=server, acc=acc, keep=keep,
              flush=flush)
    route = _route(x)

    def run(disp, x, y, m, tau, weights):
        if route == "cpu":
            return ref.train_agg_step_ref(disp, x, y, m, tau, weights, lr, **kw)
        if route == "meta":
            if acc is None:
                lead = (groups,) if groups > 1 else ()
                return [{n: _meta(lead + leaf.shape[1:], leaf.dtype)
                         for n, leaf in layer.items()} for layer in disp], None
            return tuple([{n: _meta(leaf.shape, leaf.dtype) for n, leaf in layer.items()}
                          for layer in tree] for tree in (server, acc))
        return train_agg_step_cuda(disp, x, y, m, tau, weights, lr, **kw)

    def cost():
        widths = [disp[0]["w"].shape[-2]] + [layer["w"].shape[-1] for layer in disp]
        if route == "meta":
            row_steps = max_tau * m.shape[0] * m.shape[1]
        else:
            row_steps = int((tau.to(torch.int64) * m.sum(1).round().to(torch.int64)).sum())
        return kernel_cost.train_agg_step(widths, row_steps=row_steps, learners=x.shape[0],
                                          d_cap=x.shape[1], starts=disp[0]["w"].shape[0],
                                          outputs=groups if acc is None else 4)

    return op_cost.kernel_call("train_agg_step", run, (disp, x, y, m, tau, weights), cost)


def waterfill_residual(tau_star, c2, c1, c0, T, d_lo, d_hi, total) -> torch.Tensor:
    """Batched water-filling residual
    ``sum_k clip((T - c0) / (c2 tau* + c1), d_lo, d_hi) - total`` of a
    (B, K) fleet batch: the inner evaluation of every bisection step in
    ``core.solver_batched``."""
    route = _route(c2)

    def run(*args):
        if route == "cpu":
            return ref.waterfill_residual_ref(*args)
        if route == "meta":
            return _meta(c2.shape[:1], c2.dtype)
        return waterfill_residual_cuda(*args)

    return op_cost.kernel_call(
        "waterfill_residual", run, (tau_star, c2, c1, c0, T, d_lo, d_hi, total),
        lambda: kernel_cost.waterfill_residual(*c2.shape, itemsize=c2.element_size()))


def waterfill_energy_residual(tau_star, c2, c1, c0, T, e2, e1, e0, eb, d_lo, d_hi,
                              total) -> torch.Tensor:
    """Energy-budgeted water-filling residual
    ``sum_k clip(min((T - c0) / (c2 tau* + c1), (eb - e0) / (e2 tau* + e1)),
    d_lo, d_hi) - total`` of a (B, K) fleet batch: the inner evaluation of
    every ``kkt_energy`` bisection step. ``eb = +inf`` rows give
    ``waterfill_residual``'s bits."""
    route = _route(c2)

    def run(*args):
        if route == "cpu":
            return ref.waterfill_energy_residual_ref(*args)
        if route == "meta":
            return _meta(c2.shape[:1], c2.dtype)
        return waterfill_energy_residual_cuda(*args)

    return op_cost.kernel_call(
        "waterfill_energy_residual", run,
        (tau_star, c2, c1, c0, T, e2, e1, e0, eb, d_lo, d_hi, total),
        lambda: kernel_cost.waterfill_energy_residual(*c2.shape, itemsize=c2.element_size()))
