"""Shared neural building blocks in plain torch (``repro/models/layers.py``).

The chunked flash attention here is the plain version of attention that
``kernels.ops.flash_attention`` runs on the CPU; on the card the same call
launches the hand-written kernel (``csrc/flash_attention.cu``), which is
held to the dense oracle ``kernels.ref.flash_attention_ref``. Every
function keeps the reference's layouts and dtype rules: statistics in
float32, results in the input's dtype. Constants enter as Python numbers,
never as tensors built on the device: a host-to-device copy of a scalar
would make the host wait for the card at every layer.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.compat import einsum

__all__ = [
    "rms_norm",
    "layer_norm",
    "rope",
    "flash_attention",
    "decode_attention",
    "swiglu",
    "gelu_mlp",
]


def rms_norm(x, weight, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last dimension (biased variance). Placed, the
    statistics are taken on each rank's block of rows (``compat.on_blocks``:
    not every torch release has DTensor rules for ``var``) and the weight
    and bias are placed as the rows are (an FSDP split of d gathered).
    The norm reads its input through one node (a cast, or a view of a
    float32 input), so that the gradients of its three reads are summed
    before a residual's joins them, placed or not, and the two give the
    same bits."""

    def normed(x):
        x32 = x.to(torch.float32)
        if x32 is x:
            x32 = x.view_as(x)
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        return (x32 - mu) * torch.rsqrt(var + eps)

    out = compat.on_blocks(normed, x)
    w, b = (compat.placed_for(t, out).to(torch.float32) for t in (weight, bias))
    return (out * w + b).to(x.dtype)


def rope(x, positions, theta: float = 500000.0):
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = 1.0 / torch.pow(float(np.float32(theta)), exps)
    angles = positions[..., :, None].to(torch.float32) * freq   # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]                    # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1f, x2f = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1f * cos - x2f * sin, x1f * sin + x2f * cos], dim=-1)
    return out.to(x.dtype)


def _chunk_mask(q_pos, k_pos, *, causal: bool, window: int | None):
    """(Sq, Ck) boolean mask: True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def _inv_sqrt(d: int) -> float:
    """``1 / sqrt(d)`` rounded as the reference's float32 ``1.0 / jnp.sqrt(d)``."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: int | None = None,
    chunk: int = 512,
    q_offset: int = 0,
    p_bf16: bool = False,
    q_block: int = 0,
):
    """Memory-efficient attention via an online-softmax scan over KV chunks.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D) with H = KV * G (GQA). Never
    materializes the (Sq, Skv) score matrix: the working set is
    O(Sq * chunk) per head group.

    Knobs (as the reference's):
      p_bf16  - cast the probabilities to bf16 for the PV product, after
                the float32 online-softmax statistics;
      q_block - when causal and Sq == Skv, process q in blocks of this size
                and scan only the kv chunks at or below each block's
                diagonal.
    """
    b, sq, h, d = q.shape
    _, skv, kv, _ = k.shape

    if (q_block and causal and window is None and sq == skv and sq % q_block == 0
            and q_block % chunk == 0):
        outs = []
        for qi in range(sq // q_block):
            hi = (qi + 1) * q_block
            outs.append(flash_attention(
                q[:, qi * q_block:hi], k[:, :hi], v[:, :hi], causal=True, window=None,
                chunk=chunk, q_offset=qi * q_block, p_bf16=p_bf16, q_block=0))
        return torch.cat(outs, dim=1)

    g = h // kv
    chunk = min(chunk, skv)
    while skv % chunk:          # largest divisor of skv not exceeding chunk
        chunk -= 1
    nc = skv // chunk

    qg = q.reshape(b, sq, kv, g, d).to(torch.float32)
    scale = _inv_sqrt(d)
    q_pos = q_offset + torch.arange(sq, device=q.device)

    m = torch.full((b, sq, kv, g), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, kv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kv, g, d), dtype=torch.float32, device=q.device)
    for ci in range(nc):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        k_pos = ci * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb.to(torch.float32)) * scale
        mask = _chunk_mask(q_pos, k_pos, causal=causal, window=window)[:, None, None, :]
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully masked rows (m_new = -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        if p_bf16:
            p = p.to(torch.bfloat16)
        pv = torch.einsum("bqkgc,bckd->bqkgd", p, vb.to(p.dtype)).to(torch.float32)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int | None = None):
    """Single-token attention against a (possibly over-allocated) KV cache.

    q: (B, 1, H, D); caches: (B, S, KV, D); cache_len: an int, a 0-d or a
    (B,) tensor, the number of valid cache entries (the new token's KV must
    already be written at position cache_len - 1).
    """
    b, _, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    g = h // kv
    qg = q.reshape(b, kv, g, d).to(torch.float32)
    logits = einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32)) * _inv_sqrt(d)
    pos = torch.arange(s, device=q.device)
    if isinstance(cache_len, int):
        cl = cache_len
    else:
        cl = torch.as_tensor(cache_len, device=q.device)
        cl = cl.reshape(-1, 1) if cl.dim() else cl.reshape(1, 1)
    valid = pos[None, :] < cl                      # (B|1, S)
    if window is not None:
        valid &= pos[None, :] >= cl - window
    logits = torch.where(valid[:, None, None, :], logits, -math.inf)
    p = torch.softmax(logits, dim=-1)
    out = einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, d).to(q.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU FFN: down(silu(x @ gate) * (x @ up))."""
    g = einsum("...d,df->...f", x, w_gate.to(x.dtype))
    u = einsum("...d,df->...f", x, w_up.to(x.dtype))
    return einsum("...f,fd->...d", F.silu(g) * u, w_down.to(x.dtype))


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """GELU MLP with the tanh approximation (``jax.nn.gelu``'s default).
    Placed, column-parallel then row-parallel: the hidden width split over
    ``model`` as ``w_in``'s columns and ``b_in`` are, the output's
    ``Partial`` sum reduced once before ``b_out`` is added (a bias added to
    each rank's term would count once a rank)."""
    h = einsum("...d,df->...f", x, w_in.to(x.dtype))
    h = F.gelu(h + compat.placed_for(b_in, h).to(x.dtype), approximate="tanh")
    y = compat.replicate_partial(einsum("...f,fd->...d", h, w_out.to(x.dtype)))
    return y + compat.placed_for(b_out, y).to(x.dtype)
