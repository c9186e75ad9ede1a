"""Learning-rate schedules (``repro/optim/schedules.py``): pure functions
of the step counter, returning a float32 0-d tensor computed in float32
as the reference's jnp versions are."""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine", "warmup_linear_decay"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(lr: float, *, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    """Linear warmup to ``lr`` then cosine decay to ``final_frac * lr``."""

    def f(step):
        step = _step(step)
        warm = lr * torch.clamp_max(step / max(warmup_steps, 1), 1.0)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return f


def warmup_linear_decay(lr: float, *, warmup_steps: int, total_steps: int):
    def f(step):
        step = _step(step)
        warm = lr * torch.clamp_max(step / max(warmup_steps, 1), 1.0)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, lr * (1.0 - t))

    return f
