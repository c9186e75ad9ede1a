"""Architecture registry: ``--arch <id>`` resolves here."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape, shape_for

_MODULES = {
    "rwkv6-7b": "rwkv6_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama3-8b": "llama3_8b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "whisper-small": "whisper_small",
    "llama3.2-3b": "llama3_2_3b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "internvl2-76b": "internvl2_76b",
}

ARCH_NAMES = list(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _mod(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _mod(name).reduced()


__all__ = [
    "ARCH_NAMES",
    "ArchConfig",
    "INPUT_SHAPES",
    "InputShape",
    "get_config",
    "get_reduced",
    "shape_for",
]
