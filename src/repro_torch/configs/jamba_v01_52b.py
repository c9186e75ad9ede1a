"""jamba-v0.1-52b — hybrid Mamba + attention (1:7 interleave) with MoE
every other layer, 16 experts top-2 [arXiv:2403.19887].
32L d_model=4096 32H (kv=8) d_ff=14336 vocab=65536."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887 (Jamba v0.1)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    attn_every=8,          # 1 attention : 7 mamba per 8-layer period
    num_experts=16,
    top_k=2,
    moe_d_ff=14336,        # Jamba experts are full-width
    moe_every=2,
    d_state=16,
    d_conv=4,
    expand=2,
    param_dtype="bfloat16",
)


def reduced() -> ArchConfig:
    # 4 layers with attn_every=2 keeps the hybrid pattern (mamba+moe,
    # attn+dense, mamba+moe, attn+dense) at smoke scale.
    return dataclasses.replace(
        CONFIG,
        num_layers=4,
        attn_every=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        num_experts=4,
        top_k=2,
        moe_d_ff=256,
        d_state=8,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
