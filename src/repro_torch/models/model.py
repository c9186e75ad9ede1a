"""Public model API (``repro/models/model.py``), training and serving: the
dense, MoE, ssm (RWKV-6 and Mamba), hybrid (Jamba), vlm (InternVL2) and
audio (Whisper) families.

    m = Model(cfg)                                     # on the card
    params = m.init(seed)
    loss = m.loss(params, batch)                       # train
    logits, cache, aux = m.prefill(params, batch, max_len=...)
    logits, cache = m.decode(params, cache, token, cache_len)
    specs = m.input_specs(shape)                       # meta inputs of a shape

Batches (tokens int (B, S) tensors on the model's device; training adds
``labels`` of the tokens' shape):
  dense/moe/ssm/hybrid: {tokens}
  vlm:   {tokens (B, S_text), image_embeds (B, N_img, d)}: the image
         embeddings (the stubbed vision encoder's output) go ahead of the
         text, so decode starts at position N_img + S_text
  audio: {tokens (B, S), encoder_embeds (B, S_enc, d)} (``models.encdec``) On the card the
prefill's attention runs the hand-written CUDA kernel
(``kernels/flash_attention.py``), RWKV-6's recurrence runs its kernel
(``kernels/wkv6.py``) in prefill and decode, and the Mamba scan its kernel
(``kernels/mamba_scan.py``) in the prefill, which is what the reference's
``Model(cfg, use_pallas=True)`` does on a TPU; on the CPU they run the
plain versions, the reference's default. There is no switch between them.
Decode updates the cache it is given in place and returns it. The prefill's
``aux`` is the MoE load-balance loss summed over layers; ``loss`` adds it,
weighted by ``MOE_AUX_WEIGHT``, to the next-token loss of an MoE model. On
the card ``loss`` differentiates through each kernel's backward kernel:
attention's (``kernels.flash_attention.FlashAttention``), the WKV-6
recurrence's (``kernels.wkv6.WKV6``) and the Mamba scan's
(``kernels.mamba_scan.MambaScan``).
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import decoder, encdec
from repro_torch.models.params import (
    abstract_params,
    init_params,
    logical_axes,
    param_count,
)

__all__ = ["Model"]

MOE_AUX_WEIGHT = 0.01

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
SSM_KINDS = ("rwkv6", "mamba")


class Model:
    def __init__(self, cfg: ArchConfig, *, device=None):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(f"{cfg.family!r} is not a family the port runs "
                                      f"({', '.join(FAMILIES)})")
        if cfg.family == "ssm" and cfg.ssm_kind not in SSM_KINDS:
            raise NotImplementedError(f"'ssm' with {cfg.ssm_kind!r} mixers is not a family "
                                      f"the port runs (its ssm mixers: {', '.join(SSM_KINDS)})")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.specs = (encdec.build_specs(cfg) if cfg.family == "audio"
                      else decoder.build_specs(cfg))

    # -- params ------------------------------------------------------------
    def init(self, seed: int):
        """Weights drawn from ``seed`` on the CPU (the same on every device),
        then moved to the model's device."""
        return init_params(self.specs, seed, device=self.device)

    def abstract_params(self):
        return abstract_params(self.specs)

    def param_axes(self):
        return logical_axes(self.specs)

    def param_count(self) -> int:
        return param_count(self.specs)

    # -- caches ------------------------------------------------------------
    def cache_specs(self, batch: int, seq_len: int):
        if self.cfg.family == "audio":
            return encdec.init_cache_specs(self.cfg, batch, seq_len)
        return decoder.init_cache_specs(self.cfg, batch, seq_len)

    def cache_axes(self, batch: int, seq_len: int):
        return logical_axes(self.cache_specs(batch, seq_len))

    def abstract_cache(self, batch: int, seq_len: int):
        return abstract_params(self.cache_specs(batch, seq_len))

    def init_cache(self, batch: int, seq_len: int):
        return init_params(self.cache_specs(batch, seq_len), 0, device=self.device)

    # -- serving -------------------------------------------------------------
    def _embeds(self, params, batch):
        """The vlm's input embeddings: the image embeddings, then the text's
        token embeddings; None for the other families."""
        if self.cfg.family != "vlm":
            return None
        cd = self.cfg.cdtype()
        tok = params["embed"][batch["tokens"]].to(cd)
        return torch.cat([batch["image_embeds"].to(cd), tok], dim=1)

    def loss(self, params, batch):
        """The mean next-token cross entropy of ``batch["labels"]`` (float32,
        0-d), plus ``MOE_AUX_WEIGHT`` times the load-balance loss for an
        MoE model; the vlm's image positions carry no loss."""
        cfg = self.cfg
        if cfg.family == "audio":
            hidden, _ = encdec.forward(params, cfg, tokens=batch["tokens"],
                                       encoder_embeds=batch["encoder_embeds"], mode="train")
            return decoder.lm_loss(params, cfg, hidden, batch["labels"], chunk=cfg.loss_chunk)
        embeds = self._embeds(params, batch)
        hidden, aux = decoder.forward(params, cfg, tokens=None if embeds is not None
                                      else batch["tokens"], embeds=embeds, mode="train")
        if cfg.family == "vlm":
            hidden = hidden[:, cfg.num_image_tokens:]
        loss = decoder.lm_loss(params, cfg, hidden, batch["labels"], chunk=cfg.loss_chunk)
        if cfg.num_experts:
            loss = loss + MOE_AUX_WEIGHT * aux
        return loss

    def prefill(self, params, batch, *, max_len: int | None = None):
        """Returns (logits of the last position (B, 1, V), cache, aux)."""
        cfg = self.cfg
        if cfg.family == "audio":
            return encdec.forward(params, cfg, tokens=batch["tokens"],
                                  encoder_embeds=batch["encoder_embeds"], mode="prefill",
                                  max_len=max_len)
        embeds = self._embeds(params, batch)
        return decoder.forward(params, cfg, tokens=None if embeds is not None
                               else batch["tokens"], embeds=embeds, mode="prefill",
                               max_len=max_len)

    def decode(self, params, cache, token, cache_len, extras=None):
        """token (B, 1) at position ``cache_len``; returns (logits, cache)."""
        if self.cfg.family == "audio":
            return encdec.decode_step(params, self.cfg, cache, token, cache_len)
        return decoder.decode_step(params, self.cfg, cache, token, cache_len)

    # -- dry-run input specs ---------------------------------------------------
    def input_specs(self, shape: InputShape) -> dict:
        """``meta`` stand-ins for every model input of this shape (the
        reference's ``ShapeDtypeStruct``s): no storage, no device. Tokens and
        labels are int32, embeddings the compute dtype; decode gets one token,
        the ``abstract_cache`` of ``seq_len`` positions and a 0-d int32
        ``cache_len``."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        cd = cfg.cdtype()

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        def tok(bb, ss):
            return meta((bb, ss), torch.int32)

        if shape.kind in ("train", "prefill"):
            if cfg.family == "vlm":
                st = s - cfg.num_image_tokens
                out = {"tokens": tok(b, st),
                       "image_embeds": meta((b, cfg.num_image_tokens, cfg.d_model), cd)}
            elif cfg.family == "audio":
                st = s
                out = {"tokens": tok(b, s),
                       "encoder_embeds": meta((b, cfg.encoder_seq, cfg.d_model), cd)}
            else:
                st = s
                out = {"tokens": tok(b, s)}
            if shape.kind == "train":
                out["labels"] = tok(b, st)
            return out

        # decode: one token against a seq_len cache
        return {
            "token": tok(b, 1),
            "cache": self.abstract_cache(b, s),
            "cache_len": meta((), torch.int32),
        }
