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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    xdbc = torch.einsum("bsd,de->bse", x_conv, p["x_proj"].to(cd))
    dt_raw, b_ssm, c_ssm = torch.split(xdbc, [dtr, n, n], dim=-1)
    dt = _softplus(torch.einsum("bsr,rd->bsd", dt_raw, p["dt_w"].to(cd)).to(torch.float32)
                   + p["dt_b"].to(torch.float32))
    return dt, b_ssm.to(torch.float32).contiguous(), c_ssm.to(torch.float32).contiguous()


def apply(cfg: ArchConfig, p, x, *, mode: str = "train", cache=None):
    """x: (B, S, d) normed input. Returns (y, cache | None).

    mode: "train" | "prefill" (returns the cache; written into ``cache``
    when one is given) | "decode" (``cache`` required; updated in place).
    """
    cd = cfg.cdtype()
    di, dc = cfg.d_inner, cfg.d_conv
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"].to(cd))
    x_in, z = xz[..., :di], xz[..., di:]
    if mode == "decode":
        return _decode(cfg, p, x_in, z, cache)
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")

    b, s, _ = x_in.shape
    x_pad = F.pad(x_in, (0, 0, dc - 1, 0))                      # (B, S+dc-1, di)
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
    out = torch.einsum("bsd,de->bse", y, p["out_proj"].to(cd))
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
    conv = (torch.einsum("bcd,cd->bd", window.to(cd), p["conv_w"].to(cd))
            + p["conv_b"].to(cd))
    x_conv = F.silu(conv)[:, None]                               # (B, 1, di)
    dt, b_ssm, c_ssm = _split_xdbc(cfg, p, x_conv)
    a = -torch.exp(p["a_log"])
    dt_t, b_t, c_t = dt[:, 0], b_ssm[:, 0], c_ssm[:, 0]
    xf = x_conv[:, 0].to(torch.float32)
    h = cache["ssm"]
    da = torch.exp(dt_t[:, :, None] * a[None])
    h.copy_(h * da + (dt_t * xf)[:, :, None] * b_t[:, None, :])
    y = torch.einsum("bdn,bn->bd", h, c_t) + xf * p["d_skip"]
    y = y[:, None].to(cd) * F.silu(z)
    out = torch.einsum("bsd,de->bse", y, p["out_proj"].to(cd))
    conv_state.copy_(window[:, 1:])
    return out, cache
