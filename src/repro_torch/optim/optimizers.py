"""Optimizers over trees of tensors (``repro/optim/optimizers.py``).

As the reference's: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, which returns new
tensors. ``apply(grads, state, params) -> (params, state)`` writes the new
state and parameters into the ones it was given, a leaf at a time, through
the expressions ``update`` uses, and returns those tensors: the caller
gives them up, as to a jitted step with donated buffers, and a step
holds one copy of the moments, not two. The moments are float32 whatever the
parameters' dtype; the step counter is an int32 0-d tensor on the
parameters' device, so nothing waits for the host. Three details keep the
port on the reference's numbers:

* ``clip_by_global_norm`` sums the squares in ``jax.tree_util``'s leaf
  order (``repro_torch.tree``), and scales each gradient in float32 before
  casting it back;
* Adam's bias corrections ``1 - b ** t`` are float32, from ``t`` cast to
  float32 (``optimizers.py:73-74``), not Python doubles;
* an update is cast to the parameter's dtype before it is added
  (``optimizers.py:26, 80``), which decides the bits of bf16 parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import compat, tree

__all__ = ["Optimizer", "sgd", "momentum", "adam", "adamw", "get_optimizer", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable          # params -> state
    update: Callable        # (grads, state, params) -> (updates, state)
    apply: Callable         # (grads, state, params) -> (params, state), in place


def _add(p, u):
    return (p + u).to(p.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``min(1, max_norm / |grads|)``, |grads|), the norm
    float32 over every leaf. On DTensor gradients each leaf's sum of squares
    is a partial value where the leaf is split, their sum too, and the one
    all-reduce comes at the square root: the norm is replicated."""
    squares = [torch.sum(g.to(torch.float32) ** 2) for g in tree.leaves(grads)]
    total = squares[0]
    for sq in squares[1:]:
        total = total + sq
    gn = torch.sqrt(compat.replicate_partial(total))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-12), 1.0)
    return tree.map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(lr: float) -> Optimizer:
    def apply(g, s, p):
        for gi, pi in zip(tree.leaves(g), tree.leaves(p)):
            pi.copy_(_add(pi, -lr * gi))
        return p, s

    return Optimizer(
        init=lambda params: (),
        update=lambda g, s, p: (tree.map(lambda x: -lr * x, g), s),
        apply=apply,
    )


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree.map(_zeros32, params)

    def moment(mi, gi):
        return beta * mi + gi.to(torch.float32)

    def update(g, m, p):
        m = tree.map(moment, m, g)
        return tree.map(lambda mi: -lr * mi, m), m

    def apply(g, m, p):
        for mi, gi, pi in zip(tree.leaves(m), tree.leaves(g), tree.leaves(p)):
            mi.copy_(moment(mi, gi))
            pi.copy_(_add(pi, -lr * mi))
        return p, m

    return Optimizer(init=init, update=update, apply=apply)


def _adam_core(lr, b1, b2, eps, wd):
    def init(params):
        device = next(iter(tree.leaves(params)), torch.empty(())).device
        return {
            "m": tree.map(_zeros32, params),
            "v": tree.map(_zeros32, params),
            "t": torch.zeros((), dtype=torch.int32, device=device),
        }

    def first(mi, gi):
        return b1 * mi + (1 - b1) * gi.to(torch.float32)

    def second(vi, gi):
        return b2 * vi + (1 - b2) * torch.square(gi.to(torch.float32))

    def corrections(t):
        tf = t.to(torch.float32)
        return 1 - b1 ** tf, 1 - b2 ** tf

    def upd(mi, vi, pi, bc1, bc2):
        step = (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
        if wd:
            step = step + wd * pi.to(torch.float32)
        return (-lr * step).to(pi.dtype)

    def update(g, state, params):
        t = state["t"] + 1
        m = tree.map(first, state["m"], g)
        v = tree.map(second, state["v"], g)
        bc1, bc2 = corrections(t)
        updates = tree.map(lambda mi, vi, pi: upd(mi, vi, pi, bc1, bc2), m, v, params)
        return updates, {"m": m, "v": v, "t": t}

    def apply(g, state, params):
        bc1, bc2 = corrections(state["t"] + 1)
        for mi, vi, gi, pi in zip(tree.leaves(state["m"]), tree.leaves(state["v"]),
                                  tree.leaves(g), tree.leaves(params)):
            mi.copy_(first(mi, gi))
            vi.copy_(second(vi, gi))
            pi.copy_(_add(pi, upd(mi, vi, pi, bc1, bc2)))
        state["t"].add_(1)
        return params, state

    return Optimizer(init=init, update=update, apply=apply)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, wd: float = 0.01) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, wd)


def get_optimizer(name: str, lr: float) -> Optimizer:
    return {
        "sgd": lambda: sgd(lr),
        "momentum": lambda: momentum(lr),
        "adam": lambda: adam(lr),
        "adamw": lambda: adamw(lr),
    }[name]()
