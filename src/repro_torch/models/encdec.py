"""Whisper-style encoder-decoder backbone [arXiv:2212.04356]
(``repro/models/encdec.py``).

The mel-spectrogram + conv frontend is the allowed stub: the model takes
precomputed frame embeddings (B, encoder_seq, d), sinusoidal positions
already folded in. Everything after it is real: the encoder (non-causal
self-attention), the decoder (causal self-attention, then cross-attention
to the encoder's output) and the logits tied to the embedding.

Whisper uses LayerNorm with a bias and GELU MLPs, and absolute positions
(no RoPE). On the card each attention of a prefill launches the
flash-attention kernel: the encoder's non-causal over its frames, the
decoder's causal over the prompt, and the cross-attention's non-causal
with the prompt's queries against the frames' keys (Sq != Skv). The
decoder's self-attention caches as any decoder's does; the cross-attention
K/V are computed once from the encoder's output at prefill and kept in the
cache, and decode attends to them with ``layers.decode_attention``.

The reference stacks each layer's params over the layers and scans; the
port keeps that tree layout (a leading layer axis on every leaf of
``params["encoder"]["layers"]``, ``params["decoder"]["layers"]`` and the
caches) and loops over views of it. A prefill allocates each stacked cache
once (or writes the one it is given) and every layer writes its slice; a
decode step updates the self-attention slices in place. In training (mode
``"train"``) each decoder layer, its cross-attention K/V projection
included, runs under ``torch.utils.checkpoint`` when ``cfg.remat``, as the
reference's ``jax.checkpoint`` of its scan body; the encoder runs without.

Placed (a sharded step, the trees DTensors placed by ``launch.steps``'
shardings), every product goes through ``compat.einsum``, the token and
position lookups through ``decoder._placed_lookup``, and each block's
row-parallel output is reduced over ``model`` once before the residual add
(``decoder._summed``), as in the decoder trunk. Attention's kernel runs on
each rank's block (``kernels.ops``): the heads over ``model`` where they
divide it, the batch over the batch axes. The cross-attention K/V are made
placed as the cross cache is (the batch over the batch axes, ``kv_heads``
over ``model`` where they divide), so the prefill writes each rank's block
of a placed cache in place; a placed prefill takes its cache from the
caller (``launch.steps.build_prefill`` makes one).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import compat
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, ffn
from repro_torch.models.decoder import _index, _lookup, _stack, _summed, _unstack, _zeros
from repro_torch.models.layers import layer_norm
from repro_torch.models.params import ParamSpec

__all__ = ["build_specs", "init_cache_specs", "forward", "decode_step", "encode"]


def _ln_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    dt = cfg.pdtype()
    return {
        "w": ParamSpec((d,), ("embed",), init="ones", dtype=dt),
        "b": ParamSpec((d,), ("embed",), init="zeros", dtype=dt),
    }


def _enc_layer_specs(cfg: ArchConfig) -> dict:
    return {
        "ln1": _ln_specs(cfg),
        "attn": attention.specs(cfg),
        "ln2": _ln_specs(cfg),
        "mlp": ffn.dense_specs(cfg),
    }


def _dec_layer_specs(cfg: ArchConfig) -> dict:
    return {
        "ln1": _ln_specs(cfg),
        "self_attn": attention.specs(cfg),
        "ln_cross": _ln_specs(cfg),
        "cross_attn": attention.specs(cfg),
        "ln2": _ln_specs(cfg),
        "mlp": ffn.dense_specs(cfg),
    }


def build_specs(cfg: ArchConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    dt = cfg.pdtype()
    return {
        "encoder": {
            "layers": _stack(_enc_layer_specs(cfg), cfg.num_encoder_layers),
            "ln_post": _ln_specs(cfg),
        },
        "embed": ParamSpec((v, d), ("vocab", "embed"), dtype=dt, scale=0.02),
        # as long as the reference's (whisper itself stops at 448 positions)
        "pos_embed": ParamSpec((32768, d), (None, "embed"), dtype=dt, scale=0.01),
        "decoder": {
            "layers": _stack(_dec_layer_specs(cfg), cfg.num_layers),
            "ln_post": _ln_specs(cfg),
        },
    }


def init_cache_specs(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    n = cfg.num_layers
    cd = cfg.cdtype()
    cross = ParamSpec((n, batch, cfg.encoder_seq, kv, hd),
                      ("layers", "batch", None, "kv_heads", "head_dim"), init="zeros", dtype=cd)
    return {
        "self": _stack(attention.init_cache_specs(cfg, batch, seq_len), n),
        "cross": {"k": cross, "v": cross},
    }


def _ln(x, p, eps):
    return layer_norm(x, p["w"], p["b"], eps)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(params, cfg: ArchConfig, encoder_embeds):
    """The encoder over ``encoder_embeds`` (B, S_enc, d), the stubbed
    frontend's output; returns (B, S_enc, d) after the final LayerNorm."""
    x = encoder_embeds.to(cfg.cdtype())
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for lp in _unstack(params["encoder"]["layers"], cfg.num_encoder_layers):
        h = _ln(x, lp["ln1"], cfg.norm_eps)
        y, _ = attention.apply(cfg, lp["attn"], h, positions=positions, mode="train",
                               causal=False, use_rope=False)
        x = x + _summed(y)
        h = _ln(x, lp["ln2"], cfg.norm_eps)
        x = x + _summed(ffn.dense_apply(cfg, lp["mlp"], h))
    return _ln(x, params["encoder"]["ln_post"], cfg.norm_eps)


def _cross_kv(cfg: ArchConfig, lp, enc_out, out=None):
    """The cross-attention's K and V (B, S_enc, KV, hd) of the encoder's
    output; written into ``out`` (a pair of tensors) when given. Placed,
    the products split the batch as the encoder's output is and the k/v
    heads as ``wk``/``wv`` are, which is the cross cache's placement: each
    rank writes its block of ``out`` (the copy moves nothing)."""
    cd = cfg.cdtype()
    k = compat.einsum("bsd,dke->bske", enc_out, lp["cross_attn"]["wk"].to(cd))
    v = compat.einsum("bsd,dke->bske", enc_out, lp["cross_attn"]["wv"].to(cd))
    if out is None:
        return k.contiguous(), v.contiguous()
    out[0].copy_(compat.placed_for(k, out[0]))
    out[1].copy_(compat.placed_for(v, out[1]))
    return out


def _dec_layer(cfg: ArchConfig, lp, x, positions, kv, *, mode: str, self_c=None,
               cache_len=None, max_len: int | None = None):
    """One decoder layer: causal self-attention (writing ``self_c`` in a
    prefill or decode), cross-attention to ``kv``, the MLP."""
    h = _ln(x, lp["ln1"], cfg.norm_eps)
    y, _ = attention.apply(cfg, lp["self_attn"], h, positions=positions, mode=mode,
                           cache=self_c, cache_len=cache_len, causal=True, use_rope=False,
                           max_len=max_len)
    x = x + _summed(y)
    h = _ln(x, lp["ln_cross"], cfg.norm_eps)
    y, _ = attention.apply(cfg, lp["cross_attn"], h, positions=positions,
                           mode="decode" if mode == "decode" else "train",
                           cache_len=cache_len, kv_override=kv, use_rope=False)
    x = x + _summed(y)
    h = _ln(x, lp["ln2"], cfg.norm_eps)
    return x + _summed(ffn.dense_apply(cfg, lp["mlp"], h))


def _train_layer(cfg: ArchConfig, lp, x, positions, enc_out):
    """A decoder layer in training, its cross-attention K/V made inside
    (and so remade in the backward under remat, as the reference's are)."""
    return _dec_layer(cfg, lp, x, positions, _cross_kv(cfg, lp, enc_out), mode="train")


def forward(
    params,
    cfg: ArchConfig,
    *,
    tokens,
    encoder_embeds=None,
    enc_out=None,
    mode: str = "train",
    cache=None,
    cache_len=None,
    max_len: int | None = None,
):
    """train: (hidden states after the decoder's final LayerNorm, aux).
    prefill: (logits of the last position, cache, aux), the cache holding
    ``max(max_len, S)`` self-attention positions and the cross-attention
    K/V; given ``cache`` (zeros of ``init_cache_specs``' tree, placed by
    ``launch.steps.build_prefill`` on a mesh) it writes there, and placed
    parameters need one. decode: tokens (B, 1) at position ``cache_len``;
    (logits, cache), the cache updated in place. ``aux`` is 0 (there is no
    MoE). Train and prefill encode ``encoder_embeds`` unless ``enc_out`` is
    given; decode attends to the cached cross-attention K/V, not the
    encoder."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    cd = cfg.cdtype()
    b, s = tokens.shape
    dev = tokens.device
    if mode == "decode":
        if cache is None or cache_len is None:
            raise ValueError("decode needs a cache and cache_len")
        positions = torch.full((b, 1), int(cache_len), dtype=torch.int32, device=dev)
    else:
        if enc_out is None:
            enc_out = encode(params, cfg, encoder_embeds)
        positions = _positions(b, s, dev)
    x = _lookup(params["embed"], tokens).to(cd)
    x = x + compat.placed_for(_lookup(params["pos_embed"], positions).to(cd), x)
    if mode == "prefill" and cache is None:
        if isinstance(x, DTensor):
            raise ValueError("a placed prefill writes into a placed cache: pass cache= "
                             "(launch.steps.build_prefill does)")
        cache = _zeros(init_cache_specs(cfg, b, max(max_len or s, s)), dev)

    if mode == "train":
        for lp in _unstack(params["decoder"]["layers"], cfg.num_layers):
            if cfg.remat:
                x = checkpoint(_train_layer, cfg, lp, x, positions, enc_out,
                               use_reentrant=False)
            else:
                x = _train_layer(cfg, lp, x, positions, enc_out)
    else:
        layers = params["decoder"]["layers"]
        for i in range(cfg.num_layers):
            lp = _index(layers, i)
            if mode == "decode":
                kv = (cache["cross"]["k"][i], cache["cross"]["v"][i])
            else:
                kv = _cross_kv(cfg, lp, enc_out, out=(cache["cross"]["k"][i],
                                                      cache["cross"]["v"][i]))
            x = _dec_layer(cfg, lp, x, positions, kv, mode=mode,
                           self_c=_index(cache["self"], i), cache_len=cache_len,
                           max_len=max_len)

    x = _ln(x, params["decoder"]["ln_post"], cfg.norm_eps)
    embed = params["embed"].to(cd)
    if mode == "train":
        return x, torch.zeros((), dtype=torch.float32, device=dev)
    if mode == "prefill":
        logits = compat.einsum("bsd,vd->bsv", x[:, -1:], embed)
        return logits, cache, torch.zeros((), dtype=torch.float32, device=dev)
    return compat.einsum("bsd,vd->bsv", x, embed), cache


def decode_step(params, cfg: ArchConfig, cache, token, cache_len):
    """One decode step: token (B, 1) int, cache_len an int (or 0-d tensor)."""
    return forward(params, cfg, tokens=token, mode="decode", cache=cache,
                   cache_len=cache_len)
