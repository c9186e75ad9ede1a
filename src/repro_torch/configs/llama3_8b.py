"""llama3-8b — dense GQA decoder with 128k vocab [arXiv:2407.21783].
32L d_model=4096 32H (kv=8) d_ff=14336 vocab=128256."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    source="arXiv:2407.21783 (Llama 3 8B)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
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
