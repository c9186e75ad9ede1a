"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed experts,
top-6 routing, first layer dense [arXiv:2401.06066].
28L d_model=2048 16H d_ff(expert)=1408 vocab=102400."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066 (DeepSeekMoE 16B)",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,             # the single dense (first) layer, per model card
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,          # assigned expert hidden size
    moe_every=1,
    moe_first_dense=1,
    rope_theta=10000.0,
    param_dtype="bfloat16",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        num_experts=4,
        num_shared_experts=1,
        top_k=2,
        moe_d_ff=128,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
