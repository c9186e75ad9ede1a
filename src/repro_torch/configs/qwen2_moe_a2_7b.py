"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]. 24L d_model=2048 16H d_ff(expert)=1408
vocab=151936."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5632,              # shared-expert aggregate width (4 x 1408)
    vocab_size=151936,
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
    moe_every=1,
    rope_theta=1000000.0,
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
