"""Architecture + run configuration.

``ArchConfig`` is the single config object every layer of the stack consumes
(model construction, launcher, allocator complexity accounting), copied from
the reference (``repro/configs/base.py``) field for field. The dtypes stay
strings, so that a config compares equal to the reference's field by
field; ``pdtype()`` and ``cdtype()`` map them to ``torch.dtype``. One file
per assigned architecture lives next to this module; each exposes
``CONFIG`` (the exact published shape) and ``reduced()`` (a <=512-dim,
2-layer smoke variant of the same family).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "shape_for"]

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"{name!r} is not a torch dtype")
    return dtype


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: Family
    source: str = ""                  # citation for the shape

    # trunk
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                 # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"                 # silu (SwiGLU) | gelu (plain MLP)

    # attention variants
    sliding_window: int | None = None     # SWA width (h2o-danube)
    attn_chunk: int = 512                 # flash-attention KV chunk

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                     # routed-expert hidden dim
    moe_every: int = 1                    # MoE every n-th layer (jamba: 2)
    moe_first_dense: int = 0              # leading dense layers (deepseek: 1)
    capacity_factor: float = 1.25

    # SSM (mamba / rwkv6)
    ssm_kind: str = ""                    # "mamba" | "rwkv6"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                      # 0 -> d_model // 16
    rwkv_head_dim: int = 64
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32

    # hybrid (jamba): period layout, e.g. attention every 8th layer
    attn_every: int = 0                   # 0 -> pure; n -> layer i is attn iff i % n == n//2

    # enc-dec (whisper)
    num_encoder_layers: int = 0
    encoder_seq: int = 1500               # stubbed mel-frame count

    # vlm (internvl2)
    num_image_tokens: int = 256           # stubbed projected patch embeddings

    # perf knobs (§Perf hillclimbing; defaults = paper-faithful baseline)
    wkv_unroll: int = 1        # WKV recurrence steps per scan iteration
    mamba_unroll: int = 1      # selective-scan steps per scan iteration
    loss_chunk: int = 512      # vocab-logit chunk length in lm_loss
    moe_shard_map: bool = True # batch-manual shard_map around MoE dispatch
    attn_p_bf16: bool = False  # bf16 probabilities for the PV contraction
    attn_q_block: int = 0      # causal q-block kv-truncation (0 = off)
    wkv_backend: str = "scan"  # "scan" (step recurrence) | "chunked" (matmul form)
    wkv_chunk: int = 16        # chunk length for the chunked WKV backend

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # training
    learning_rate: float = 3e-4
    optimizer: str = "adamw"
    remat: bool = True                    # activation checkpoint per layer
    zero1: bool = True                    # shard optimizer state over fsdp axis

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or max(self.d_model // 16, 1)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def pdtype(self) -> torch.dtype:
        return _dtype(self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return _dtype(self.compute_dtype)

    def layer_kinds(self) -> list[str]:
        """Per-layer mixer kind for the decoder trunk."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append(self.ssm_kind)
            elif self.family == "hybrid" and self.attn_every:
                kinds.append("attn" if i % self.attn_every == self.attn_every // 2 else "mamba")
            else:
                kinds.append("attn")
        return kinds

    def layer_is_moe(self) -> list[bool]:
        out = []
        for i in range(self.num_layers):
            if self.num_experts == 0:
                out.append(False)
            elif i < self.moe_first_dense:
                out.append(False)
            else:
                out.append((i - self.moe_first_dense) % self.moe_every == 0)
        return out

    def supports_long_context(self) -> bool:
        """True iff decode with a 500k context is sub-quadratic / bounded."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window is not None
        )

    # -- allocator accounting ----------------------------------------------
    def param_counts(self) -> tuple[int, int]:
        """(total, active-per-token) parameter counts, analytic."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qo = d * self.num_heads * hd + self.num_heads * hd * d
        kv = 2 * d * self.num_kv_heads * hd
        dense_ffn = 3 * d * ff if self.act == "silu" else 2 * d * ff
        moe_ffn_total = moe_ffn_active = 0
        if self.num_experts:
            unit = 3 * d * self.moe_d_ff
            moe_ffn_total = (self.num_experts + self.num_shared_experts) * unit + d * self.num_experts
            moe_ffn_active = (self.top_k + self.num_shared_experts) * unit + d * self.num_experts
        mamba = (
            2 * d * self.d_inner                      # in_proj (x, z)
            + self.d_inner * self.d_conv              # conv
            + self.d_inner * (self.resolved_dt_rank + 2 * self.d_state)
            + self.resolved_dt_rank * self.d_inner    # dt proj
            + self.d_inner * self.d_state             # A
            + self.d_inner * d                        # out proj
        )
        rwkv = (
            5 * d * d                                  # r,k,v,g,o projections
            + 2 * d * self.rwkv_lora_decay + 6 * d * self.rwkv_lora_mix * 2
            + 2 * d                                    # decay base, bonus u
            + 3 * d * ff // 2                          # channel-mix (approx)
        )
        total = active = 0
        for kind, is_moe in zip(self.layer_kinds(), self.layer_is_moe()):
            mixer = {"attn": qo + kv, "mamba": mamba, "rwkv6": rwkv}[kind]
            ffn_t = moe_ffn_total if is_moe else dense_ffn
            ffn_a = moe_ffn_active if is_moe else dense_ffn
            total += mixer + ffn_t
            active += mixer + ffn_a
        emb = v * d * (1 if self.tie_embeddings else 2)
        total += emb
        active += emb
        if self.num_encoder_layers:
            enc = self.num_encoder_layers * (qo + kv + dense_ffn)
            cross = self.num_layers * (qo + kv)
            total += enc + cross
            active += enc + cross
        return int(total), int(active)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_for(name: str) -> InputShape:
    return INPUT_SHAPES[name]
