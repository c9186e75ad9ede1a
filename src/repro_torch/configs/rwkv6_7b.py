"""rwkv6-7b — Finch: attention-free RNN with data-dependent decay
[arXiv:2404.05892]. 32L d_model=4096 d_ff=14336 vocab=65536."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892 (RWKV-6 Finch 7B)",
    ssm_kind="rwkv6",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # 4096 / head 64
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    param_dtype="bfloat16",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=896,
        vocab_size=512,
        rwkv_head_dim=64,
        rwkv_lora_decay=16,
        rwkv_lora_mix=8,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
