"""RWKV-6 "Finch" mixer and channel-mix (``repro/models/rwkv6.py``):
data-dependent decay linear attention [arXiv:2404.05892]. Attention-free:
the decode state is O(H * hd^2), constant in the context length.

Time-mix, per head with the state S (hd, hd):
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with token-shift ddlerp inputs and the data-dependent decay
    w_t = exp(-exp(w0 + tanh(x_w @ A_w) @ B_w)).

Channel-mix: k = relu(W_k x_k)^2, out = sigmoid(W_r x_r) * W_v k.

The recurrence goes through ``kernels.ops.wkv6``: the hand-written CUDA
kernel on the card, the plain step loop (or, with ``wkv_backend =
"chunked"``, the matmul form ``wkv_chunked``) on the CPU. The casts follow
the reference's, so that bf16 rounds where it rounds there: the ddlerp and
the projections in the compute dtype, the decay and the group norm in
float32.

Unlike the reference, which is functional, a prefill given a cache writes
its states into it, and decode updates the cache it is given in place and
returns it: a decoder's caches are slices of tensors stacked over its
layers. The wkv state is written by the kernel itself (its ``s_last`` may
alias ``s0``).

Placed (a sharded step's DTensors, ``sharding.rules``): the r/k/v/g
products are column-parallel, the heads split over ``model`` as ``wr``,
``wk``, ``wv`` and ``wg`` are (``compat.einsum``), and the recurrence runs
on each rank's heads and batch (``ops.wkv6`` through ``compat.shard_map``);
``wo`` and the channel-mix's ``cv`` are row-parallel. ``wo``'s product is
left ``Partial`` for the decoder's reduction; ``cv``'s is reduced before
the sigmoid gate multiplies it (one all-reduce either way; the gate's
factor is replicated over ``model``, and a product of sums is exact only
once summed). The token-shift mix and the decay LoRA are replicated over
``model`` and, in training, FSDP over ``data`` (``compat.einsum`` gathers
each such weight before its product, ``compat.placed_for`` before an
elementwise op). The decay, the group norm, ``ln_x`` and the gate act
per head, in (B, S, H, hd), so that no split head dimension is flattened;
the shift along the sequence and the group norm run on each rank's block
(``compat.on_blocks``). The cache's ``shift`` and ``wkv`` are written in
place on each rank's block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models.params import ParamSpec

__all__ = [
    "specs",
    "cmix_specs",
    "apply",
    "cmix_apply",
    "init_cache_specs",
    "cmix_cache_specs",
    "wkv_scan",
]

_MIX_TARGETS = 5  # r, k, v, w, g
_GROUP_NORM_EPS = 64e-5


def specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    lm, ld = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
    dt = cfg.pdtype()
    return {
        "mu_x": ParamSpec((d,), ("embed",), init="zeros", dtype=dt),
        "mu": ParamSpec((_MIX_TARGETS, d), (None, "embed"), init="zeros", dtype=dt),
        "tm_w1": ParamSpec((d, _MIX_TARGETS * lm), ("embed", None), dtype=dt, scale=0.01),
        "tm_w2": ParamSpec((_MIX_TARGETS, lm, d), (None, None, "embed"), dtype=dt, scale=0.01),
        "wr": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), dtype=dt),
        "wk": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), dtype=dt),
        "wv": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), dtype=dt),
        "wg": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), dtype=dt),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"), dtype=dt),
        "w0": ParamSpec((h, hd), ("heads", "head_dim"), init="decay", dtype=torch.float32),
        "dw1": ParamSpec((d, ld), ("embed", None), dtype=dt, scale=0.01),
        "dw2": ParamSpec((ld, d), (None, "embed"), dtype=dt, scale=0.01),
        "u": ParamSpec((h, hd), ("heads", "head_dim"), dtype=torch.float32, scale=0.1),
        "ln_x": ParamSpec((d,), ("embed",), init="ones", dtype=torch.float32),
    }


def cmix_specs(cfg: ArchConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.pdtype()
    return {
        "mu_k": ParamSpec((d,), ("embed",), init="zeros", dtype=dt),
        "mu_r": ParamSpec((d,), ("embed",), init="zeros", dtype=dt),
        "ck": ParamSpec((d, ff), ("embed", "mlp"), dtype=dt),
        "cv": ParamSpec((ff, d), ("mlp", "embed"), dtype=dt),
        "cr": ParamSpec((d, d), ("embed", None), dtype=dt),
    }


def init_cache_specs(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    del seq_len
    d = cfg.d_model
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    return {
        "shift": ParamSpec((batch, d), ("batch", "embed"), init="zeros", dtype=cfg.cdtype()),
        "wkv": ParamSpec((batch, h, hd, hd), ("batch", "heads", None, None), init="zeros",
                         dtype=torch.float32),
    }


def cmix_cache_specs(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    del seq_len
    return {
        "shift": ParamSpec((batch, cfg.d_model), ("batch", "embed"), init="zeros",
                           dtype=cfg.cdtype()),
    }


def wkv_scan(r, k, v, w, u, s0=None, *, unroll: int = 1):
    """The WKV-6 recurrence step by step: ``kernels.ref.wkv6_ref``. r, k, v,
    w: (B, S, H, hd); u: (H, hd); s0: (B, H, hd, hd) float32 or None.
    Returns (y (B, S, H, hd) float32, final state (B, H, hd, hd) float32).
    ``unroll`` is taken and ignored: in the reference it only sets how many
    steps XLA's scan runs an iteration, which does not change the result."""
    del unroll
    return ref.wkv6_ref(r, k, v, w, u, s0)


def wkv_chunked(r, k, v, w, u, s0=None, *, chunk: int = 64):
    """The WKV-6 recurrence in its chunked matmul form, the same math as
    ``wkv_scan``. Within a chunk of length C, with a_t = sum_{u<t} log w_u
    (chunk-local prefix, a_0 = 0) and A_T the sum over the whole chunk:

        y_t = (r_t * exp(a_t)) . S_chunk_start                 [cross term]
            + sum_{s<t} ( sum_d r_t[d] k_s[d] exp(a_t[d]-a_{s+1}[d]) ) v_s
            + (r_t * u * k_t) . v_t                            [bonus]
        S'  = diag(exp(A_T)) S + sum_s (k_s * exp(A_T - a_{s+1})) v_s^T

    Every exponent is a sum of log-decays over a forward interval, so <= 0.
    The chunk is the largest divisor of S not above ``chunk``."""
    b, s, h, hd = r.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    nc = s // chunk
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
             if s0 is None else s0.to(torch.float32))

    def to_chunks(t):
        return t.to(torch.float32).reshape(b, nc, chunk, h, hd)

    rc, kc, vc = to_chunks(r), to_chunks(k), to_chunks(v)
    lw = torch.log(torch.clamp(to_chunks(w), min=1e-30))      # (B,nc,C,H,hd), <= 0
    uf = u.to(torch.float32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=r.device),
                     diagonal=-1)                             # s < t
    ys = []
    for c in range(nc):
        rb, kb, vb, lwb = rc[:, c], kc[:, c], vc[:, c], lw[:, c]   # (B,C,H,hd)
        a = torch.cumsum(lwb, dim=1) - lwb                    # a_t = sum_{u<t}
        a_total = a[:, -1] + lwb[:, -1]                       # (B,H,hd) = A_T
        y = torch.einsum("bthi,bhij->bthj", rb * torch.exp(a), state)
        a_next = a + lwb                                      # a_{s+1}
        expo = a[:, :, None] - a_next[:, None, :]             # (B,t,s,H,hd)
        coef = torch.exp(torch.clamp(expo, max=0.0)) * tri[None, :, :, None, None]
        att = torch.einsum("bthd,bshd,btshd->bths", rb, kb, coef)
        y = y + torch.einsum("bths,bshj->bthj", att, vb)
        y = y + torch.einsum("bthd,bthd,bthj->bthj", rb * uf[None, None], kb, vb)
        k_dec = kb * torch.exp(a_total[:, None] - a_next)     # exp <= 1
        state = torch.exp(a_total)[..., None] * state + torch.einsum(
            "bshi,bshj->bhij", k_dec, vb)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _ddlerp(p, x, x_prev):
    """Data-dependent lerp producing the 5 mixed inputs (r, k, v, w, g):
    (B, S, 5, d) in x's dtype."""
    dx = x_prev - x
    inner = x + dx * compat.placed_for(p["mu_x"], x).to(x.dtype)
    lora = compat.einsum("bsd,de->bse", torch.tanh(inner), p["tm_w1"].to(x.dtype))
    lora = lora.reshape(*x.shape[:-1], _MIX_TARGETS, -1)
    lora = compat.einsum("bste,ted->bstd", lora, p["tm_w2"].to(x.dtype))
    mix = lora + compat.placed_for(p["mu"], lora).to(x.dtype)   # (B,S,5,d)
    return x[..., None, :] + dx[..., None, :] * mix


def _decay(cfg: ArchConfig, p, xw, like=None):
    """xw: (B, S, d) -> the per-channel decay in (0, 1): (B, S, H, hd)
    float32; placed, split as ``like`` (r: the heads as the products put
    them) before ``w0``'s heads meet it."""
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    lo = compat.einsum("bsd,dl->bsl", torch.tanh(xw), p["dw1"].to(xw.dtype))
    lo = compat.einsum("bsl,ld->bsd", lo, p["dw2"].to(xw.dtype))
    lo = compat.placed_for(lo.to(torch.float32).reshape(*xw.shape[:-1], h, hd), like)
    return torch.exp(-torch.exp(lo + compat.placed_for(p["w0"], lo)))


def _group_norm(y):
    """Per-head group norm (ddof 0, as jnp.var) of y (..., hd), float32."""
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    return (y - mu) * torch.rsqrt(var + _GROUP_NORM_EPS)


def _token_shift(x, mode: str, cache):
    """The previous position's input: zeros before a prompt, the cache's
    ``shift`` in decode."""
    if mode in ("train", "prefill"):
        return compat.on_blocks(lambda t: F.pad(t, (0, 0, 1, 0))[:, :-1], x)
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    if cache is None:
        raise ValueError("decode needs a cache")
    return cache["shift"][:, None].to(x.dtype)


def _new_cache(x, cd, cache, **states):
    """The cache after this call: ``shift``, the last position of the
    normed input, and ``states``; written into ``cache`` and returned as it
    when one is given (whose other states the caller wrote already)."""
    if cache is None:
        return {"shift": x[:, -1].to(cd, copy=True), **states}
    cache["shift"].copy_(x[:, -1])
    return cache


def apply(cfg: ArchConfig, p, x, *, mode: str = "train", cache=None):
    """Time-mix. x: (B, S, d) normed input. Returns (y, cache | None).

    mode: "train" | "prefill" (returns the cache; written into ``cache``
    when one is given) | "decode" (``cache`` required; updated in place).
    """
    cd = cfg.cdtype()
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    x_prev = _token_shift(x, mode, cache)
    s0 = cache["wkv"] if mode == "decode" else None

    mixed = _ddlerp(p, x, x_prev)                             # (B,S,5,d)
    xr, xk, xv, xw, xg = mixed.unbind(dim=2)
    r, k, v, g = (compat.einsum("bsd,dhe->bshe", xi, p[name].to(cd)).contiguous()
                  for xi, name in ((xr, "wr"), (xk, "wk"), (xv, "wv"), (xg, "wg")))
    w = _decay(cfg, p, xw, r)

    backend = cfg.wkv_backend if mode in ("train", "prefill") else "scan"
    out_state = cache["wkv"] if cache is not None and mode != "train" else None
    y, s_last = kops.wkv6(r, k, v, w, p["u"], s0, backend=backend, chunk=cfg.wkv_chunk,
                          out_state=out_state)

    # per-head group norm in float32, ln_x, then the gate, all per head
    y = compat.on_blocks(_group_norm, y)
    y = y * compat.placed_for(compat.placed_for(p["ln_x"], x).reshape(h, hd), y)
    y = y.to(cd) * F.silu(g)
    out = compat.einsum("bshe,hed->bsd", y, p["wo"].to(cd))

    if mode == "train":
        return out, None
    return out, _new_cache(x, cd, cache, wkv=s_last)


def cmix_apply(cfg: ArchConfig, p, x, *, mode: str = "train", cache=None):
    """Channel-mix. x: (B, S, d) normed input. Returns (y, cache | None),
    the cache as ``apply``'s."""
    cd = cfg.cdtype()
    x_prev = _token_shift(x, mode, cache)
    xk = x + (x_prev - x) * compat.placed_for(p["mu_k"], x).to(cd)
    xr = x + (x_prev - x) * compat.placed_for(p["mu_r"], x).to(cd)
    k = compat.einsum("bsd,df->bsf", xk, p["ck"].to(cd))
    k = torch.square(torch.relu(k))
    # row-parallel: placed, the sum over the ranks reduced before the gate
    kv = compat.replicate_partial(compat.einsum("bsf,fd->bsd", k, p["cv"].to(cd)))
    out = torch.sigmoid(compat.einsum("bsd,de->bse", xr, p["cr"].to(cd))) * kv
    if mode == "train":
        return out, None
    return out, _new_cache(x, cd, cache)
