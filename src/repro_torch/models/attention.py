"""Attention mixer: GQA + RoPE + optional sliding window, train/prefill/decode
(``repro/models/attention.py``), causal self-attention, an encoder's
non-causal attention and cross-attention to pre-projected K/V.

Prefill attends through ``kernels.ops.flash_attention``: the hand-written
kernel on the card, the chunked scan on the CPU. Decode attends with the
plain ``layers.decode_attention``, as the reference does, against a
(possibly rolling) KV cache: for sliding-window models the cache has exactly
``window`` slots and new KVs overwrite the oldest.

Unlike the reference, which is functional, decode writes the new token's
K/V into the cache tensors it is given, in place, and returns them: a
decoder's caches are slices of tensors stacked over its layers, and a copy
a step would move the whole cache per token.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.compat import einsum
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import decode_attention, rope
from repro_torch.models.params import ParamSpec

__all__ = ["specs", "apply", "init_cache_specs"]


def specs(cfg: ArchConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = cfg.pdtype()
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), dtype=dt),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"), dtype=dt),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"), dtype=dt),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"), dtype=dt),
    }


def cache_seq_len(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache_specs(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    s = cache_seq_len(cfg, seq_len)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, s, kv, hd)
    axes = ("batch", "cache_seq", "kv_heads", "head_dim")
    dt = cfg.cdtype()
    return {
        "k": ParamSpec(shape, axes, init="zeros", dtype=dt),
        "v": ParamSpec(shape, axes, init="zeros", dtype=dt),
    }


def _project_q(cfg: ArchConfig, p, x):
    return einsum("bsd,dhe->bshe", x, p["wq"].to(cfg.cdtype())).contiguous()


def _project_qkv(cfg: ArchConfig, p, x, positions, *, use_rope: bool = True):
    """q, k and v (B, S, heads, hd); placed, the heads split over ``model``
    as the weights are (column-parallel)."""
    cd = cfg.cdtype()
    q = einsum("bsd,dhe->bshe", x, p["wq"].to(cd))
    k = einsum("bsd,dke->bske", x, p["wk"].to(cd))
    v = einsum("bsd,dke->bske", x, p["wv"].to(cd))
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _grouped_heads(q, kv: int):
    """``q`` with its heads split over no more ranks than the ``kv`` k/v
    heads divide: decode attention groups the q heads by k/v head, which a
    DTensor can only do where each rank's q heads are whole groups. A
    (B, 1, H, hd) q is small, so the split is gathered; a plain q is
    returned as it is."""
    if not isinstance(q, DTensor):
        return q
    sizes = q.device_mesh.shape
    want = [Replicate() if p.is_shard(2) and kv % n else p
            for p, n in zip(q.placements, sizes)]
    return q if want == list(q.placements) else q.redistribute(q.device_mesh, want)


def _prefill_cache(cfg: ArchConfig, k, v, max_len: int | None, out=None) -> dict:
    """The cache a prefill of ``k``/``v`` (B, S, KV, hd) leaves, laid out so
    that token t lives in slot t % s_cache, which decode's rolling write
    relies on (``repro/models/attention.py:101-115``). With ``out`` (a dict
    of preallocated (B, s_cache, KV, hd) tensors) it is written there."""
    s = k.shape[1]
    s_cache = cache_seq_len(cfg, max(max_len or s, s))
    if out is None:
        out = {name: torch.zeros((k.shape[0], s_cache) + tuple(k.shape[2:]), dtype=k.dtype,
                                 device=k.device) for name in ("k", "v")}
    for name, t in (("k", k), ("v", v)):
        if s_cache >= s:
            out[name][:, :s] = t
            out[name][:, s:].zero_()
        else:
            out[name].copy_(torch.roll(t[:, -s_cache:], s % s_cache, dims=1))
    return out


def apply(
    cfg: ArchConfig,
    p,
    x,
    *,
    positions,
    mode: str = "train",
    cache=None,
    cache_len=None,
    causal: bool = True,
    use_rope: bool = True,
    kv_override=None,
    max_len: int | None = None,
):
    """Run the attention mixer.

    mode: "train" | "prefill" (returns the cache; written into ``cache``
    when one is given) | "decode" (``cache`` required; updated in place).
    ``causal=False`` is an encoder's attention; ``kv_override``, (k, v)
    (B, Skv, KV, hd) from an encoder (pre-projected), is cross-attention:
    the queries attend to every one of them, in every mode, and no cache is
    written.
    """
    cd = cfg.cdtype()
    if mode in ("train", "prefill"):
        if kv_override is not None:
            q = _project_q(cfg, p, x)
            k, v = (t.contiguous() for t in kv_override)
            out = kops.flash_attention(q, k, v, causal=False, window=None,
                                       chunk=cfg.attn_chunk)
            new_cache = None
        else:
            q, k, v = _project_qkv(cfg, p, x, positions, use_rope=use_rope)
            out = kops.flash_attention(
                q, k, v, causal=causal, window=cfg.sliding_window, chunk=cfg.attn_chunk,
                p_bf16=cfg.attn_p_bf16, q_block=cfg.attn_q_block)
            new_cache = (_prefill_cache(cfg, k, v, max_len, out=cache) if mode == "prefill"
                         else None)
        y = einsum("bshe,hed->bsd", out, p["wo"].to(cd))
        return y, new_cache

    # -- decode: single token ------------------------------------------------
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    if cache_len is None:
        raise ValueError("decode needs cache_len")
    if kv_override is not None:
        q = _project_q(cfg, p, x)
        k, v = kv_override
        out = decode_attention(_grouped_heads(q, k.shape[2]), k, v, k.shape[1])
        return einsum("bshe,hed->bsd", out, p["wo"].to(cd)), cache
    if cache is None:
        raise ValueError("decode needs a cache")
    q, k_new, v_new = _project_qkv(cfg, p, x, positions, use_rope=use_rope)
    s_cache = cache["k"].shape[1]
    write_pos = int(cache_len) % s_cache
    cache["k"][:, write_pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, write_pos] = v_new[:, 0].to(cache["v"].dtype)
    valid = min(int(cache_len) + 1, s_cache)
    out = decode_attention(_grouped_heads(q, cache["k"].shape[2]), cache["k"], cache["v"],
                           valid)
    y = einsum("bshe,hed->bsd", out, p["wo"].to(cd))
    return y, cache
