"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]. 24L d_model=2560 32H (kv=8) d_ff=6912 vocab=32000.
The 4096-token sliding window is what qualifies this dense arch for the
long_500k decode shape (rolling KV cache, O(window) state)."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    source="arXiv:2401.16818 (H2O-Danube 1.8B)",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
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
        sliding_window=32,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
