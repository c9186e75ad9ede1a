"""internvl2-76b — VLM backbone: InternViT (stub) + InternLM2-like decoder
[arXiv:2404.16821]. 80L d_model=8192 64H (kv=8) d_ff=28672 vocab=128256.
The vision encoder + projector are the allowed stub: input_specs feeds
projected patch embeddings (B, num_image_tokens, d_model)."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    source="arXiv:2404.16821 (InternVL2 76B)",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    num_image_tokens=256,
    rope_theta=1000000.0,
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
        num_image_tokens=8,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
