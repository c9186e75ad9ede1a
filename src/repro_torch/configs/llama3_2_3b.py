"""llama3.2-3b — small Llama-3 family dense model
[hf:meta-llama/Llama-3.2-1B family card]. 28L d_model=3072 24H (kv=8)
d_ff=8192 vocab=128256."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    source="hf:meta-llama/Llama-3.2-3B",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    param_dtype="bfloat16",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
