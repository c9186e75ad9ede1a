"""Decoder trunk of the dense, MoE, RWKV-6 and hybrid (Jamba) families
(``repro/models/decoder.py``).

The reference groups the layer pattern into periods: the ``p`` layers of a
period have their params stacked over ``n_periods``, and its trunk is one
``lax.scan`` over periods. The port keeps that tree layout, a leading
``n_periods`` axis on every leaf of ``params["blocks"]`` and of the caches,
so that trees compare leaf by leaf, and runs the periods as a Python loop
over views of the stacked leaves. A prefill allocates each stacked cache
once and every layer writes its state into its slice: K/V for an attention
layer; for an RWKV-6 layer the mixer's token shift and wkv state and the
channel-mix's token shift; for a Mamba layer the conv window and the SSM
state. A decode step updates those slices in place (see
``models.attention``, ``models.rwkv6`` and ``models.mamba``), where the
reference's scan stacks new ones. Placed (a sharded step), the caches are
DTensors (``launch.steps.build_prefill`` allocates them placed, each rank
its block), a slice of one is a DTensor viewing its rank's block, and each
layer writes its states there: K/V by DTensor's indexing, the recurrent
states by the kernels on the rank's block (``kernels.ops``). Every mixer's
and FFN's output is reduced over ``model`` once before the residual add
(``_summed``).

Params tree:
  embed            (V, d)
  prefix           list of layer dicts (the non-periodic leading layers)
  blocks           list over period positions, each leaf stacked (n_periods, ...)
  final_norm       (d,)
  lm_head          (d, V)  (absent when tied)

Token or embedding inputs (the vlm's image embeddings ahead of its text),
the attention, Mamba and RWKV-6 mixers, dense and Mixture-of-Experts FFNs
and the RWKV-6 channel-mix run here; a prefill returns the MoE
load-balance loss summed over layers, as the reference's does.

Training: mode ``"train"`` returns the hidden states after the final norm
and that loss, writes no cache, and with ``cfg.remat`` runs each period
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of
its scan body), so a period's activations are recomputed in the backward.
``lm_loss`` takes the next-token cross entropy a sequence chunk at a time,
each chunk's logits under ``torch.utils.checkpoint``, so the (B, S, V)
logits never live whole. In training the stacked leaves of
``params["blocks"]`` are split with ``torch.unbind``, whose backward
stacks the periods' gradients once.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch import compat
from repro_torch.compat import PartitionSpec as P
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, ffn, mamba, rwkv6
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamSpec

__all__ = [
    "Layout",
    "layout_for",
    "build_specs",
    "init_cache_specs",
    "forward",
    "decode_step",
    "lm_logits",
    "lm_loss",
]


@dataclasses.dataclass(frozen=True)
class Layout:
    """Static description of the trunk layer pattern."""

    prefix: tuple[tuple[str, bool], ...]    # (mixer_kind, is_moe) per leading layer
    period: tuple[tuple[str, bool], ...]    # pattern of one period
    n_periods: int

    @property
    def p(self) -> int:
        return len(self.period)


def layout_for(cfg: ArchConfig) -> Layout:
    kinds = cfg.layer_kinds()
    moes = cfg.layer_is_moe()
    layers = list(zip(kinds, moes))
    n_prefix = cfg.moe_first_dense
    body = layers[n_prefix:]
    # smallest period that tiles the body
    p = 1
    while p <= len(body):
        if len(body) % p == 0 and body == body[:p] * (len(body) // p):
            break
        p += 1
    return Layout(
        prefix=tuple(layers[:n_prefix]),
        period=tuple(body[:p]),
        n_periods=len(body) // p,
    )


def _placed_lookup(table, tokens):
    """The embedding rows of ``tokens`` from a placed (V, d) table, on each
    rank's block (``compat.shard_map``): the table split over the vocab as
    placed (an FSDP split of its width gathered first, as FSDP gathers a
    weight), the tokens over the batch; each rank looks up the tokens its
    rows hold and zeros the rest, and the sum over the vocab's ranks is one
    all-reduce. It is the plain lookup on one rank, bit for bit, its
    gradient too (the same indexing, times ones), where DTensor's own
    masked lookup has no gradient and its indexing's backward is not
    placed alike by every torch release."""
    mesh = compat.mesh_of(table)
    vocab = tuple(a for a, p in zip(mesh.axis_names, table.placements) if p.is_shard(0))
    batch = tuple(a for a, p in zip(mesh.axis_names, getattr(tokens, "placements", ()))
                  if p.is_shard(0) and a not in vocab)

    def body(tok, block):
        if not vocab:
            return block[tok]
        index, _ = mesh.block(vocab)
        n = block.shape[0]
        rows = tok - index * n
        inside = (rows >= 0) & (rows < n)
        return block[rows.clamp(0, n - 1)] * inside[..., None].to(block.dtype)

    tspec = P(batch or None, *([None] * (tokens.dim() - 1)))
    return compat.replicate_partial(compat.shard_map(
        body, mesh=mesh, in_specs=(tspec, P(vocab or None, None)),
        out_specs=P(*tspec, None), out_partial=vocab)(tokens, table))


def _lookup(table, index):
    """The rows of ``index`` in ``table``; placed, on each rank's block
    (``_placed_lookup``)."""
    return _placed_lookup(table, index) if isinstance(table, DTensor) else table[index]


def _check_layer(kind: str) -> None:
    if kind not in ("attn", "mamba", "rwkv6"):
        raise NotImplementedError(f"{kind!r} is not a mixer the port runs")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _layer_specs(cfg: ArchConfig, kind: str, is_moe: bool) -> dict:
    _check_layer(kind)
    d = cfg.d_model
    dt = cfg.pdtype()
    if kind == "attn":
        mixer = attention.specs(cfg)
    elif kind == "mamba":
        mixer = mamba.specs(cfg)
    else:
        mixer = rwkv6.specs(cfg)
    # an RWKV-6 layer runs its channel-mix whatever the MoE pattern says,
    # as the reference's does
    if kind == "rwkv6":
        ffn_specs = rwkv6.cmix_specs(cfg)
    elif is_moe:
        ffn_specs = ffn.moe_specs(cfg)
    else:
        ffn_specs = ffn.dense_specs(cfg)
    return {
        "mixer_norm": ParamSpec((d,), ("embed",), init="ones", dtype=dt),
        "mixer": mixer,
        "ffn_norm": ParamSpec((d,), ("embed",), init="ones", dtype=dt),
        "ffn": ffn_specs,
    }


def _stack(spec_tree, n: int):
    if spec_tree is None:
        return None
    if isinstance(spec_tree, ParamSpec):
        s = spec_tree
        return ParamSpec((n,) + s.shape, ("layers",) + s.axes, init=s.init, scale=s.scale,
                         dtype=s.dtype)
    return {key: _stack(sub, n) for key, sub in spec_tree.items()}


def build_specs(cfg: ArchConfig) -> dict:
    lay = layout_for(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    dt = cfg.pdtype()
    out: dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), dtype=dt, scale=0.02),
        "prefix": [_layer_specs(cfg, k, m) for (k, m) in lay.prefix],
        "blocks": [
            _stack(_layer_specs(cfg, k, m), lay.n_periods) for (k, m) in lay.period
        ],
        "final_norm": ParamSpec((d,), ("embed",), init="ones", dtype=dt),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((d, v), ("embed", "vocab"), dtype=dt, scale=0.02)
    return out


def _layer_cache_specs(cfg: ArchConfig, kind: str, batch: int, seq_len: int) -> dict:
    _check_layer(kind)
    if kind == "rwkv6":
        return {"mixer": rwkv6.init_cache_specs(cfg, batch, seq_len),
                "ffn": rwkv6.cmix_cache_specs(cfg, batch, seq_len)}
    if kind == "mamba":
        return {"mixer": mamba.init_cache_specs(cfg, batch, seq_len), "ffn": None}
    return {"mixer": attention.init_cache_specs(cfg, batch, seq_len), "ffn": None}


def init_cache_specs(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    lay = layout_for(cfg)
    return {
        "prefix": [
            _layer_cache_specs(cfg, k, batch, seq_len) for (k, _) in lay.prefix
        ],
        "blocks": [
            _stack(_layer_cache_specs(cfg, k, batch, seq_len), lay.n_periods)
            for (k, _) in lay.period
        ],
    }


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _index(tree, i: int):
    """Views of period ``i`` of a tree of stacked leaves."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _index(sub, i) for key, sub in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """Period views of a tree of stacked leaves, ``[_index(tree, i) for i
    in range(n)]``, split with one ``torch.unbind`` a leaf: its backward
    stacks the n gradients once, where n ``select``s would each add a full
    stacked leaf of zeros."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        subs = {key: _unstack(sub, n) for key, sub in tree.items()}
        return [{key: sub[i] for key, sub in subs.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _zeros(spec_tree, device):
    """Zeros of a spec tree's shapes and dtypes, made on ``device``."""
    if spec_tree is None:
        return None
    if isinstance(spec_tree, ParamSpec):
        return torch.zeros(spec_tree.shape, dtype=spec_tree.dtype, device=device)
    return {key: _zeros(sub, device) for key, sub in spec_tree.items()}


def _zero_cache(cfg: ArchConfig, kind: str, batch: int, seq_len: int, n: int | None,
                device):
    """Zeroed caches of a prefill for a layer of ``kind``; stacked over
    ``n`` periods unless ``n`` is None."""
    specs = _layer_cache_specs(cfg, kind, batch, seq_len)
    return _zeros(specs if n is None else _stack(specs, n), device)


def _apply_layer(cfg: ArchConfig, p, x, *, kind: str, is_moe: bool, mode: str, positions,
                 cache, cache_len, max_len: int | None = None):
    """Pre-norm residual layer; a prefill or decode writes its state into
    ``cache``. Returns (x, the MoE load-balance loss or None)."""
    _check_layer(kind)
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    mc = cache["mixer"] if cache is not None else None
    if kind == "attn":
        y, _ = attention.apply(cfg, p["mixer"], h, positions=positions, mode=mode,
                               cache=mc, cache_len=cache_len, max_len=max_len)
    elif kind == "mamba":
        y, _ = mamba.apply(cfg, p["mixer"], h, mode=mode, cache=mc)
    else:
        y, _ = rwkv6.apply(cfg, p["mixer"], h, mode=mode, cache=mc)
    x = x + _summed(y)
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    aux = None
    if kind == "rwkv6":
        fc = cache["ffn"] if cache is not None else None
        y, _ = rwkv6.cmix_apply(cfg, p["ffn"], h, mode=mode, cache=fc)
    elif is_moe:
        y, aux = ffn.moe_apply(cfg, p["ffn"], h, train=(mode == "train"))
    else:
        y = ffn.dense_apply(cfg, p["ffn"], h)
    return x + _summed(y), aux


def _summed(y):
    """A block's output for the residual stream: placed, a row-parallel
    product's ``Partial`` sum is reduced here, one all-reduce (Megatron's
    place for it), so the stream stays replicated over ``model``."""
    return compat.replicate_partial(y)


def forward(params, cfg: ArchConfig, *, tokens=None, embeds=None, mode: str = "prefill",
            cache=None, cache_len=None, max_len: int | None = None):
    """Run the trunk on ``tokens`` (B, S) or, when given, ``embeds`` (B, S,
    d) in their place.

    train:   returns (hidden states after the final norm (B, S, d),
             aux_loss); no cache, each period rematerialized when
             ``cfg.remat``;
    prefill: returns (logits of the last position, cache, aux_loss), the
             aux_loss the MoE load-balance loss summed over layers (0
             without MoE); the cache holds ``max(max_len, S)`` positions (the window, for a
             sliding-window model);
    decode:  tokens (B, 1) at position ``cache_len``; returns (logits,
             cache), the cache updated in place.

    A prefill given ``cache`` (zeros of ``init_cache_specs``' tree, e.g.
    placed by ``launch.steps.build_prefill`` on a mesh) writes into it
    instead of allocating one; placed parameters need it, since the cache
    is placed as they are not.
    """
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r} is not a mode the port runs "
                                  "(train, prefill, decode)")
    lay = layout_for(cfg)
    cd = cfg.cdtype()
    x = embeds.to(cd) if embeds is not None else _lookup(params["embed"], tokens).to(cd)
    b, s, _ = x.shape
    dev = x.device

    if mode == "decode":
        if cache is None or cache_len is None:
            raise ValueError("decode needs a cache and cache_len")
        cache_len = int(cache_len)
        positions = torch.full((b, 1), cache_len, dtype=torch.int32, device=dev)
    elif mode == "train":
        positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
        cache = {"prefix": [None] * len(lay.prefix), "blocks": [None] * lay.p}
    else:
        positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
        seq = max(max_len or s, s)
        if cache is None and isinstance(x, DTensor):
            raise ValueError("a placed prefill writes into a placed cache: pass cache= "
                             "(launch.steps.build_prefill does)")
        cache = cache or {
            "prefix": [_zero_cache(cfg, k, b, seq, None, dev) for (k, _) in lay.prefix],
            "blocks": [_zero_cache(cfg, k, b, seq, lay.n_periods, dev)
                       for (k, _) in lay.period],
        }

    kw = dict(mode=mode, positions=positions, cache_len=cache_len, max_len=max_len)

    def period(x, aux_total, block_params, block_caches):
        # the load-balance losses summed in layer order, as the reference's
        # scan carries them
        for j, (kind, is_moe) in enumerate(lay.period):
            x, aux = _apply_layer(cfg, block_params[j], x, kind=kind, is_moe=is_moe,
                                  cache=block_caches[j], **kw)
            if aux is not None:
                aux_total = aux_total + aux
        return x, aux_total

    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    for i, (kind, is_moe) in enumerate(lay.prefix):
        x, aux = _apply_layer(cfg, params["prefix"][i], x, kind=kind, is_moe=is_moe,
                              cache=cache["prefix"][i], **kw)
        if aux is not None:
            aux_total = aux_total + aux
    split = _unstack if mode == "train" else (lambda t, n: [_index(t, i) for i in range(n)])
    blocks = [split(leaves, lay.n_periods) for leaves in params["blocks"]]
    caches = [split(c, lay.n_periods) for c in cache["blocks"]]
    for n in range(lay.n_periods):
        args = (x, aux_total, [blk[n] for blk in blocks], [c[n] for c in caches])
        if mode == "train" and cfg.remat:
            x, aux_total = checkpoint(period, *args, use_reentrant=False)
        else:
            x, aux_total = period(*args)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "train":
        # hidden states, not logits: lm_loss makes the (B, S, V) logits a
        # chunk at a time
        return x, aux_total
    if mode == "prefill":
        # only the last position's logits are needed to start decoding
        return lm_logits(params, cfg, x[:, -1:]), cache, aux_total
    return lm_logits(params, cfg, x), cache


def lm_logits(params, cfg: ArchConfig, hidden):
    cd = cfg.cdtype()
    head = params.get("lm_head")
    if head is None:
        return compat.einsum("bsd,vd->bsv", hidden, params["embed"].to(cd))
    return compat.einsum("bsd,dv->bsv", hidden, head.to(cd))


def _chunk_nll(head, tied: bool, cd, hidden, labels, mask):
    """(sum of the masked next-token losses, sum of the mask) of one chunk."""
    eq = "bsd,vd->bsv" if tied else "bsd,dv->bsv"
    logits = compat.einsum(eq, hidden, head.to(cd)).to(torch.float32)
    if isinstance(logits, DTensor):
        # the log-sum-exp and the label's logit over a vocab split over
        # ranks: one all-gather of the chunk's logits along it
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if p.is_shard(2) or p.is_partial() else p for p in logits.placements])
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def lm_loss(params, cfg: ArchConfig, hidden, labels, mask=None, *, chunk: int = 512):
    """Chunked next-token cross entropy (``repro/models/decoder.py:294``):
    the mean over the masked positions of ``logsumexp(logits) - logit of
    the label``, float32. The sequence is cut into chunks of the largest
    length not above ``chunk`` that divides S; each chunk's logits are
    made, and remade in the backward, under ``torch.utils.checkpoint``, so
    that only one chunk's (B, chunk, V) logits live at a time."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=hidden.device)
    head = params.get("lm_head")
    tied = head is None
    head = params["embed"] if tied else head
    sums = []
    for c in range(s // chunk):
        cut = slice(c * chunk, (c + 1) * chunk)
        sums.append(checkpoint(_chunk_nll, head, tied, cfg.cdtype(), hidden[:, cut],
                               labels[:, cut], mask[:, cut].to(torch.float32),
                               use_reentrant=False))
    # the chunks' sums added in order; placed, each is a partial sum over the
    # batch's ranks, and so are the totals, reduced once each
    total, count = sums[0]
    for nll, m in sums[1:]:
        total = total + nll
        count = count + m
    total, count = compat.replicate_partial(total), compat.replicate_partial(count)
    return total / torch.clamp_min(count, 1.0)


def decode_step(params, cfg: ArchConfig, cache, token, cache_len):
    """One decode step: token (B, 1) int, cache_len an int (or 0-d tensor)."""
    return forward(params, cfg, tokens=token, mode="decode", cache=cache,
                   cache_len=cache_len)
