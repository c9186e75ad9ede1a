"""Step functions (train / prefill / decode) and their sharding trees
(``repro/launch/steps.py``).

``build_train``'s step is one optimizer step: the loss and its gradient
(autograd; on the card each kernel's gradient is its backward kernel's), the
gradients clipped to a global norm, then the optimizer's update. It takes
and returns plain tensors, and writes the new parameters and optimizer
state into the ones it was given (``Optimizer.apply``) and returns them,
as a jitted step with donated buffers would: a step holds one
copy of the parameters and moments, not two, and a caller that wants the
old ones keeps a copy. The shardings are the port's DTensor placements
(``sharding.rules.tree_shardings``) of each tree on the given mesh, where
the reference gives ``NamedSharding``s; on the one-rank
``"cpu"`` mesh every leaf is replicated.

A caller places the trees with those shardings, the counterpart of the
reference's ``jax.jit(step, in_shardings=...)``::

    step, (pshard, oshard, batch_sh), _, _ = build_train(model, mesh)
    params = compat.distribute(model.init(0), pshard, mesh)   # each rank its block
    opt_state = compat.distribute(opt.init(...), oshard, mesh)
    batch = compat.distribute(batch, batch_sh(batch), mesh)
    params, opt_state, metrics = step(params, opt_state, batch)

and the step runs on DTensors, for every family (dense, MoE, RWKV-6,
Jamba, the vlm and the encoder-decoder): each op carries its placements,
as GSPMD does, with DTensor inserting the collectives; attention's, the
WKV-6 and the Mamba scan's kernels run on each rank's block
(``kernels.ops``). ``build_prefill`` allocates the prefill's cache placed,
each rank its block (the encoder-decoder's cross-attention K/V among
it). What comes out is placed too: the
parameters and moments as they went in, the metrics replicated
(``compat.gather`` makes any of it whole). On a mesh without a process
group (``compat.Mesh``'s ``device_mesh`` is None, the ``"cpu"`` mesh)
``distribute`` returns the trees themselves and the step is the plain
one.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch import compat, tree
from repro_torch.compat import PartitionSpec as P
from repro_torch.configs.base import InputShape
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import clip_by_global_norm, get_optimizer
from repro_torch.sharding.rules import (
    SERVE_RULES,
    TRAIN_RULES,
    input_shardings,
    placements,
    resolve_spec,
    tree_shardings,
)

__all__ = ["opt_state_axes", "build_train", "build_prefill", "build_decode"]


def opt_state_axes(opt_name: str, param_axes):
    if opt_name == "sgd":
        return ()
    if opt_name == "momentum":
        return param_axes
    return {"m": param_axes, "v": param_axes, "t": ()}


def _grad_of(p):
    """``p``'s gradient, zeros where autograd left none; a DTensor gradient
    placed otherwise than its parameter (a ``Partial`` sum the backward did
    not reduce, a split it chose) is redistributed to the parameter's
    placements, once, before the clip."""
    g = torch.zeros_like(p) if p.grad is None else p.grad
    if isinstance(g, DTensor) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def build_train(model: Model, mesh, rules=None, *, grad_clip: float = 1.0):
    """Returns (step_fn, in_shardings, out_shardings, (abstract params,
    abstract optimizer state)); ``step_fn(params, opt_state, batch)`` gives
    ``(params, opt_state, {"loss", "grad_norm"})``, both metrics float32
    0-d tensors on the model's device; the returned ``params`` and
    ``opt_state`` are the given ones, updated in place."""
    cfg = model.cfg
    rules = rules or TRAIN_RULES
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)

    def step(params, opt_state, batch):
        live = tree.map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad(), compat.placed_ops(params):
            loss = model.loss(live, batch)
            loss.backward()
        with torch.no_grad(), compat.placed_ops(params):
            grads = tree.map(_grad_of, live)
            grads, gn = clip_by_global_norm(grads, grad_clip)
            del live  # the raw gradients go before the update
            params, opt_state = opt.apply(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gn}

    aparams = model.abstract_params()
    aopt = opt.init(aparams)
    pshard = tree_shardings(model.param_axes(), aparams, mesh, rules)
    oshard = (() if cfg.optimizer == "sgd" else
              tree_shardings(opt_state_axes(cfg.optimizer, model.param_axes()), aopt, mesh,
                             rules))

    def batch_shardings(input_specs):
        return input_shardings(input_specs, mesh, rules)

    metrics_shard = {"loss": placements(P(), mesh), "grad_norm": placements(P(), mesh)}
    return step, (pshard, oshard, batch_shardings), (pshard, oshard, metrics_shard), (aparams, aopt)


def build_prefill(model: Model, mesh, shape: InputShape, rules=None):
    rules = rules or SERVE_RULES

    @torch.no_grad()
    def step(params, batch):
        cache = None
        if mesh.device_mesh is not None and compat.is_placed(params):
            # the cache placed as build_decode's cshard, each rank its block
            b = next(iter(batch.values())).shape[0]
            acache = model.abstract_cache(b, shape.seq_len)
            device = tree.leaves(params)[0].to_local().device
            cache = compat.placed_zeros(acache, tree_shardings(
                model.cache_axes(b, shape.seq_len), acache, mesh, rules), mesh, device)
        return model.prefill(params, batch, max_len=shape.seq_len, cache=cache)

    aparams = model.abstract_params()
    pshard = tree_shardings(model.param_axes(), aparams, mesh, rules)

    def batch_shardings(input_specs):
        return input_shardings(input_specs, mesh, rules)

    return step, (pshard, batch_shardings), aparams


def build_decode(model: Model, mesh, shape: InputShape, rules=None):
    rules = rules or SERVE_RULES

    @torch.no_grad()
    def step(params, cache, token, cache_len):
        return model.decode(params, cache, token, cache_len)

    aparams = model.abstract_params()
    pshard = tree_shardings(model.param_axes(), aparams, mesh, rules)
    b = shape.global_batch
    cache_axes = model.cache_axes(b, shape.seq_len)
    acache = model.abstract_cache(b, shape.seq_len)
    cshard = tree_shardings(cache_axes, acache, mesh, rules)
    tshard = placements(resolve_spec(("batch", None), (b, 1), mesh, rules), mesh)
    lshard = placements(P(), mesh)
    return step, (pshard, cshard, tshard, lshard), (aparams, acache)
