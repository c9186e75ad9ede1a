"""FFN blocks: dense SwiGLU / GELU MLP (``repro/models/ffn.py``).

The reference's Mixture-of-Experts (``moe_specs``, ``moe_apply``) is not
ported yet: it comes with the hybrid/MoE slice.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import gelu_mlp, swiglu
from repro_torch.models.params import ParamSpec

__all__ = ["dense_specs", "dense_apply"]


def dense_specs(cfg: ArchConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.pdtype()
    if cfg.act == "gelu":
        return {
            "w_in": ParamSpec((d, ff), ("embed", "mlp"), dtype=dt),
            "b_in": ParamSpec((ff,), ("mlp",), init="zeros", dtype=dt),
            "w_out": ParamSpec((ff, d), ("mlp", "embed"), dtype=dt),
            "b_out": ParamSpec((d,), ("embed",), init="zeros", dtype=dt),
        }
    return {
        "w_gate": ParamSpec((d, ff), ("embed", "mlp"), dtype=dt),
        "w_up": ParamSpec((d, ff), ("embed", "mlp"), dtype=dt),
        "w_down": ParamSpec((ff, d), ("mlp", "embed"), dtype=dt),
    }


def dense_apply(cfg: ArchConfig, p, x):
    if cfg.act == "gelu":
        return gelu_mlp(x, p["w_in"], p["b_in"], p["w_out"], p["b_out"])
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
