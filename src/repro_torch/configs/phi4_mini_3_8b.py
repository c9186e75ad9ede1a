"""phi4-mini-3.8b — dense RoPE + SwiGLU + GQA, 200k vocab [arXiv:2412.08905].
32L d_model=3072 24H (kv=8) d_ff=8192 vocab=200064."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    source="arXiv:2412.08905 (Phi-4-mini)",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    rope_theta=10000.0,
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
