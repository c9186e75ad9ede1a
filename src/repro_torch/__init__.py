"""PyTorch/CUDA port of the MEL system in ``repro`` (the JAX reference).

The layer map follows the reference package: ``configs/``, ``data/``,
``core/``, ``models/``, ``kernels/``, ``fed/``, ``launch/``. Host-side
allocation math is NumPy, copied from the reference; model math is torch.
Hand-written CUDA kernels (``kernels/``, sources in ``csrc/``) carry the
hot paths: the local-training steps (``train_step``), the cycle's
aggregate (``fed_agg``) and the async accumulate/flush (``accum_flush``);
the allocator's water-filling residuals, time-only and energy-budgeted
(``waterfill``); the serves' flash attention (``flash_attention``) and,
for training, its backward (``flash_attention_bwd``), the RWKV-6
recurrence (``wkv6``), the Mamba selective scan (``mamba_scan``) and the
fused SwiGLU (``swiglu``). Training (``optim/``, ``checkpoint/``,
``launch/steps.py`` and ``launch/train.py``) follows the reference's.

Entry points take ``device=None``, which means ``"cuda"``; on a machine
without a card they raise unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return dev
