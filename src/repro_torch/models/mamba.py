"""Mamba (S6) mixer of the Jamba hybrid (``repro/models/mamba.py``)
[arXiv:2403.19887]: a selective state-space layer with input-dependent
(dt, B, C) and a diagonal A. The decode state is O(d_inner * d_state),
constant in the context length.

Per channel d and state n, with ``a = -exp(a_log)``:
    h_t = exp(dt_t a) * h_{t-1} + (dt_t x_t) B_t,   y_t = h_t . C_t + d_skip x_t
where x is the causal depthwise convolution of the input projection, and
the output is gated by ``silu(z)``.

Train and prefill run the scan through ``kernels.ops.mamba_scan``: the
hand-written CUDA kernel on the card, the plain step loop
``ref.mamba_scan_ref`` on the CPU. Decode is one recurrence step in torch
on the cached conv window and state, as the reference's decode is (it
calls no kernel either). The casts follow the reference's: the
projections and the convolution in the compute dtype, dt, B, C and the
state in float32.

Unlike the reference, which is functional, a prefill given a cache writes
its states into it (the scan writes its final state into the cache's
slice itself), and decode updates the cache it is given in place and
returns it: a decoder's caches are slices of tensors stacked over its
layers.

Placed (a sharded step's DTensors, ``sharding.rules``): ``in_proj``,
``conv_w``, ``conv_b``, ``dt_w``, ``dt_b``, ``a_log`` and ``d_skip`` split
d_inner over ``model``, so each rank runs the conv, the scan (``ops.mamba_scan``
through ``compat.shard_map``) and the gate on its own channels; ``x_proj`` is
row-parallel, its ``Partial`` reduced (one all-reduce of (B, S, dt_rank +
2 N)) before the split into dt, B and C, which leaves B and C whole on every
rank; ``out_proj`` is row-parallel, left ``Partial`` for the decoder's
reduction. The cache's ``conv`` and ``ssm`` are written in place on each
rank's block.

``in_proj``'s 2 d_inner columns split into ``model``-many contiguous blocks,
so its blocks do not pair each rank's x channels with its z channels
(reduced Jamba on the (2, 4) ``test`` mesh: ranks 0-1 hold all of x, ranks
2-3 all of z). The reference lets GSPMD reshard its ``jnp.split``. Here each
rank computes its block of the product (nothing sent) and one
``all_to_all`` over ``model`` sends each half-block (d_inner / m channels)
to the rank that owns those channels (``_exchange_xz``): a rank receives
its x and z channels, 2 d_inner / m a token, against the (m - 1) blocks an
all-gather would bring. Its backward is the inverse ``all_to_all``; the dry
run counts both (``roofline.op_cost`` sees the functional collective).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import compat
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.params import ParamSpec

__all__ = ["specs", "apply", "init_cache_specs"]


def specs(cfg: ArchConfig) -> dict:
    d, di, n, dc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    dtr = cfg.resolved_dt_rank
    dt = cfg.pdtype()
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "mlp"), dtype=dt),
        "conv_w": ParamSpec((dc, di), ("conv", "mlp"), dtype=dt, scale=0.5),
        "conv_b": ParamSpec((di,), ("mlp",), init="zeros", dtype=dt),
        "x_proj": ParamSpec((di, dtr + 2 * n), ("mlp", None), dtype=dt),
        "dt_w": ParamSpec((dtr, di), (None, "mlp"), dtype=dt),
        "dt_b": ParamSpec((di,), ("mlp",), init="dt_bias", dtype=dt),
        "a_log": ParamSpec((di, n), ("mlp", "state"), init="s4d", dtype=torch.float32),
        "d_skip": ParamSpec((di,), ("mlp",), init="ones", dtype=torch.float32),
        "out_proj": ParamSpec((di, d), ("mlp", "embed"), dtype=dt),
    }


def init_cache_specs(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    del seq_len  # the state is O(1) in the context length
    di, n, dc = cfg.d_inner, cfg.d_state, cfg.d_conv
    return {
        "conv": ParamSpec((batch, dc - 1, di), ("batch", None, "mlp"), init="zeros",
                          dtype=cfg.cdtype()),
        "ssm": ParamSpec((batch, di, n), ("batch", "mlp", "state"), init="zeros",
                         dtype=torch.float32),
    }


def _softplus(v):
    """``jax.nn.softplus``: ``max(v, 0) + log1p(exp(-|v|))``."""
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs()))


def _split_xdbc(cfg: ArchConfig, p, x_conv):
    """x_conv (B, S, di) -> dt (B, S, di), B (B, S, N), C (B, S, N), all
    float32."""
    dtr, n = cfg.resolved_dt_rank, cfg.d_state
    cd = cfg.cdtype()
    # row-parallel placed: the sum over the ranks reduced before the split
    xdbc = compat.replicate_partial(compat.einsum("bsd,de->bse", x_conv, p["x_proj"].to(cd)))
    dt_raw, b_ssm, c_ssm = torch.split(xdbc, [dtr, n, n], dim=-1)
    dt = _softplus(compat.einsum("bsr,rd->bsd", dt_raw, p["dt_w"].to(cd)).to(torch.float32)
                   + p["dt_b"].to(torch.float32))
    return dt, b_ssm.to(torch.float32).contiguous(), c_ssm.to(torch.float32).contiguous()


class _Exchange(torch.autograd.Function):
    """The half-blocks of ``in_proj``'s product, each sent to the rank that
    owns its channels (one ``all_to_all_single`` over the axis's group); the
    backward sends the gradients back the same way. ``plan`` is this rank's
    (destinations of its two half-blocks, sources of its x and z halves)."""

    @staticmethod
    def forward(ctx, block, plan, group, m):
        ctx.plan, ctx.group, ctx.m = plan, group, m
        sends, recvs = plan
        half = block.shape[-1] // 2
        return _all_to_all((block[..., :half], block[..., half:]), sends, recvs, group, m)

    @staticmethod
    def backward(ctx, gx, gz):
        sends, recvs = ctx.plan
        g = _all_to_all((gx, gz), recvs, sends, ctx.group, ctx.m)
        return torch.cat(g, dim=-1), None, None, None


def _all_to_all(slabs, dests, sources, group, m: int):
    """``slabs`` (equal shapes) sent to the ranks ``dests`` (one each,
    distinct) of ``group`` (m ranks); returns the slabs this rank receives
    from ``sources`` (one each, distinct), in that order."""
    from torch.distributed import _functional_collectives as funcol

    out_of = sorted(range(len(slabs)), key=lambda i: dests[i])
    send = torch.stack([slabs[i] for i in out_of])
    got = funcol.all_to_all_single(send, [sources.count(r) for r in range(m)],
                                   [dests.count(r) for r in range(m)], group)
    got = funcol.wait_tensor(got)
    into = sorted(range(len(sources)), key=lambda i: sources[i])
    out = [None] * len(sources)
    for pos, i in enumerate(into):
        out[i] = got[pos]
    return tuple(out)


def _exchange_xz(xz, di: int):
    """x_in and z (B, S, di) of ``in_proj``'s product xz (B, S, 2 di): the
    two halves, as views; placed with its columns split over the ``model``
    axis (m ranks), each rank's x and z channels, d_inner / m each, split
    alike over ``model`` (the module's docstring). Rank q holds half-blocks
    2q and 2q + 1 of the 2m, half-block i being channels ``i % m`` of x (i <
    m) or z."""
    if not isinstance(xz, DTensor):
        return xz[..., :di], xz[..., di:]
    mesh = compat.mesh_of(xz)
    spec = compat.spec_of(xz)
    axes = spec[2]
    if axes is None:
        return xz[..., :di], xz[..., di:]
    if not isinstance(axes, str):
        raise ValueError(f"in_proj's columns split over {axes}: one axis is exchanged")
    m = mesh.shape[axes]
    if di % m:
        raise ValueError(f"d_inner {di} does not split over {m} ranks along {axes!r}")
    q = mesh.coordinate(axes)
    sends = [(2 * q + t) % m for t in (0, 1)]
    recvs = [(c * m + q) // 2 for c in (0, 1)]
    group = mesh.device_mesh.get_group(axes)

    def block(t):
        half = t.shape[-1] // 2
        if m == 1:
            return t[..., :half], t[..., half:]
        return _Exchange.apply(t, (sends, recvs), group, m)

    return compat.shard_map(block, mesh=mesh, in_specs=(spec,), out_specs=(spec, spec))(xz)


def apply(cfg: ArchConfig, p, x, *, mode: str = "train", cache=None):
    """x: (B, S, d) normed input. Returns (y, cache | None).

    mode: "train" | "prefill" (returns the cache; written into ``cache``
    when one is given) | "decode" (``cache`` required; updated in place).
    """
    cd = cfg.cdtype()
    di, dc = cfg.d_inner, cfg.d_conv
    xz = compat.einsum("bsd,de->bse", x, p["in_proj"].to(cd))
    x_in, z = _exchange_xz(xz, di)
    if mode == "decode":
        return _decode(cfg, p, x_in, z, cache)
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")

    b, s, _ = x_in.shape
    x_pad = compat.on_blocks(lambda t: F.pad(t, (0, 0, dc - 1, 0)), x_in)  # (B, S+dc-1, di)
    conv_w = p["conv_w"].to(cd)
    conv = x_pad[:, 0:s] * conv_w[0]
    for i in range(1, dc):
        conv = conv + x_pad[:, i:i + s] * conv_w[i]
    x_conv = F.silu(conv + p["conv_b"].to(cd))
    dt, b_ssm, c_ssm = _split_xdbc(cfg, p, x_conv)
    a = -torch.exp(p["a_log"])                                   # (di, N)
    out_state = cache["ssm"] if cache is not None and mode == "prefill" else None
    ys, h_last = kops.mamba_scan(dt, x_conv.contiguous(), b_ssm, c_ssm, a,
                                 out_state=out_state)
    y = ys + x_conv.to(torch.float32) * p["d_skip"]
    y = y.to(cd) * F.silu(z)
    out = compat.einsum("bsd,de->bse", y, p["out_proj"].to(cd))
    if mode == "train":
        return out, None
    # the last d_conv - 1 inputs (zeros before a prompt shorter than that)
    window = x_pad[:, -(dc - 1):]
    if cache is None:
        return out, {"conv": window.to(cd, copy=True), "ssm": h_last}
    cache["conv"].copy_(window)
    return out, cache


def _decode(cfg: ArchConfig, p, x_in, z, cache):
    """One recurrence step on the cached conv window and state, both
    updated in place."""
    if cache is None:
        raise ValueError("decode needs a cache")
    cd = cfg.cdtype()
    conv_state = cache["conv"]                                   # (B, dc-1, di)
    window = torch.cat([conv_state, x_in[:, 0:1].to(conv_state.dtype)], dim=1)
    # torch.einsum returns this product d-major; row-major, as the placed
    # product is, x_proj's product takes one layout (cuBLAS's bits follow it)
    conv = (compat.einsum("bcd,cd->bd", window.to(cd), p["conv_w"].to(cd)).contiguous()
            + p["conv_b"].to(cd))
    x_conv = F.silu(conv)[:, None]                               # (B, 1, di)
    dt, b_ssm, c_ssm = _split_xdbc(cfg, p, x_conv)
    a = -torch.exp(p["a_log"])
    dt_t, b_t, c_t = dt[:, 0], b_ssm[:, 0], c_ssm[:, 0]
    xf = x_conv[:, 0].to(torch.float32)
    h = cache["ssm"]
    da = torch.exp(dt_t[:, :, None] * a[None])
    h.copy_(h * da + (dt_t * xf)[:, :, None] * b_t[:, None, :])
    y = compat.einsum("bdn,bn->bd", h, c_t) + xf * p["d_skip"]
    y = y[:, None].to(cd) * F.silu(z)
    out = compat.einsum("bsd,de->bse", y, p["out_proj"].to(cd))
    conv_state.copy_(window[:, 1:])
    return out, cache
