"""whisper-small — encoder-decoder speech backbone [arXiv:2212.04356].
12L(enc)+12L(dec) d_model=768 12H d_ff=3072 vocab=51865. The conv/mel
frontend is the allowed stub: input_specs feeds 1500 frame embeddings."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356 (Whisper small)",
    num_layers=12,
    num_encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    act="gelu",
    tie_embeddings=True,
    param_dtype="bfloat16",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        num_encoder_layers=2,
        encoder_seq=64,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
