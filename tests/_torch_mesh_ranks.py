"""Rank functions of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_sharded_step.py``).

``launch.mesh.run_ranks`` starts each rank in a fresh process that imports
this module by its path, so it imports torch and the port only: no jax,
nothing of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import compat
from repro_torch.compat import PartitionSpec as P
from repro_torch.configs import get_reduced
from repro_torch.configs.base import InputShape
from repro_torch.convert import params_to_numpy, tree_from_jax, tree_to_numpy
from repro_torch.data.pipeline import synthetic_mnist
from repro_torch.fed.fleet import FleetConfig, FleetEngine, build_fleet_problems
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import host_mesh
from repro_torch.models import mlp
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import get_optimizer

LAYERS = [16, 8, 10]
MM_DEFICITS, MM_FLOOR = (3.0, 1.0, 0.0), 0.1


def fleet_run(rank: int | None, mesh_shape, fleets: int, rounds: int, seed: int = 1) -> dict:
    """The fleet engine on ``mesh_shape`` ((shape, axes); ``"host"`` for
    ``host_mesh()``, None for the engine's default) over ``fleets`` fleets
    of 3: its records, versions, dispatch, global model after each round,
    fleet models (this rank's block) and an S = 3 ``solve_multimodel``, as
    numpy."""
    if mesh_shape is None:
        mesh = None
    elif mesh_shape == "host":
        mesh = host_mesh()
    else:
        mesh = compat.make_mesh(*mesh_shape)
    train, test = synthetic_mnist(1200, n_test=200, features=LAYERS[0], seed=0)
    bp = build_fleet_problems(fleets, 3, T=6.0, total_samples=30, seed=2)
    eng = FleetEngine(FleetConfig(participation=0.5), bp, mlp.loss,
                      mlp.init(seed, LAYERS, device="cpu"), seed=seed, mesh=mesh)
    merged = []

    def accuracy(params, x, y):
        # read after every merge: keep that round's global model
        merged.append([{k: a.copy() for k, a in leaf.items()}
                       for leaf in params_to_numpy(params)])
        return mlp.accuracy(params, x, y)

    hist = eng.run(train, rounds, eval_fn=accuracy, eval_batch=(test.x, test.y))
    return {"hist": hist, "tau": eng.tau, "d": eng.d, "pull": eng.pull_version,
            "version": eng.global_version, "params": params_to_numpy(eng.global_params),
            "merged": merged,
            "fleet_params": params_to_numpy(eng.fleet_params), "block": eng._block,
            "mesh_shape": dict(eng.mesh.shape), "fleet_axes": eng.fleet_axes,
            "mm": eng.solve_multimodel(np.asarray(MM_DEFICITS), share_floor=MM_FLOOR)}


def shard_map_blocks(rank: int, shape, axes) -> dict:
    """``compat.shard_map`` on a mesh of ``shape``: each rank's block of an
    (8, 3) tensor split over every axis, its sum over the replicated
    dimension, the gathered whole, and a ``psum`` over the mesh."""
    mesh = compat.make_mesh(shape, axes)
    x = torch.arange(24, dtype=torch.float64).reshape(8, 3)
    flag = torch.arange(8) % 3 == 0
    split = P(tuple(axes), None)
    seen = []

    def body(x, flag):
        seen.append((x.clone(), flag.clone()))
        return x * 2, x.sum(1), flag

    whole, sums, flags = compat.shard_map(body, mesh=mesh, in_specs=(split, P(tuple(axes))),
                                          out_specs=(split, P(tuple(axes)),
                                                     P(tuple(axes))))(x, flag)
    total = torch.full((2,), float(rank))
    compat.psum([total], tuple(axes), mesh)
    with compat.set_mesh(mesh):
        ambient = dict(compat.current_mesh().shape)
    return {"block": seen[0][0].numpy(), "flag_block": seen[0][1].numpy(),
            "whole": whole.numpy(), "sums": sums.numpy(), "flags": flags.numpy(),
            "psum": total.numpy(), "ambient": ambient,
            "empty_after": dict(compat.current_mesh().shape)}


def fails(rank: int) -> None:
    raise ValueError(f"rank {rank} fails on purpose")


def serve_and_train(mesh, arch: str, params_np, case: dict) -> dict:
    """The port's prefill, its decode steps and one train step of reduced
    ``arch`` from the numpy weights ``params_np`` on ``mesh`` (a mesh
    without a process group: the plain step), the trees placed by the
    steps' shardings (``compat.distribute``). ``case`` holds the prompt
    (B, S), the family's other inputs (``inputs``: the encoder's or the
    image embeddings, or none), the decode tokens (each (B, 1)) and the
    position of the first (``start``), ``max_len`` and the training batch.
    Returns every output gathered whole, as numpy: the prefill's
    logits and cache, each decode step's logits and the cache after them,
    the step's loss, gradient norm, raw and clipped gradients and new
    parameters, and whether each returned parameter kept its placements."""
    cfg = get_reduced(arch)
    model = Model(cfg, device="cpu")
    out = {}
    shape = InputShape("p", case["max_len"], case["prompt"].shape[0], "prefill")
    prefill, (pshard, batch_sh), _ = steps.build_prefill(model, mesh, shape)
    decode, (_, _, tshard, _), _ = steps.build_decode(model, mesh, shape)
    params = compat.distribute(tree_from_jax(params_np, "cpu"), pshard, mesh)
    batch = {k: torch.as_tensor(v) for k, v in {"tokens": case["prompt"],
                                                 **case["inputs"]}.items()}
    logits, cache, _ = prefill(params, compat.distribute(batch, batch_sh(batch), mesh))
    out["prefill"] = compat.gather(logits).numpy()
    out["prefill_cache"] = tree_to_numpy(compat.gather(cache))
    out["decode"] = []
    for i, tok in enumerate(case["decode"]):
        tok = compat.distribute(torch.as_tensor(tok), tshard, mesh)
        logits, cache = decode(params, cache, tok, case["start"] + i)
        out["decode"].append(compat.gather(logits).numpy())
    out["decode_cache"] = tree_to_numpy(compat.gather(cache))

    step, (pshard, oshard, batch_sh), _, _ = steps.build_train(model, mesh)
    start = tree_from_jax(params_np, "cpu")
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    params = compat.distribute(start, pshard, mesh)
    opt_state = compat.distribute(opt.init(tree_from_jax(params_np, "cpu")), oshard, mesh)
    batch = {k: torch.as_tensor(v) for k, v in case["train"].items()}
    seen = {}
    clip = steps.clip_by_global_norm

    def watched(grads, max_norm):
        clipped, gn = clip(grads, max_norm)
        seen["raw"], seen["clipped"] = (tree_to_numpy(compat.gather(g))
                                        for g in (grads, clipped))
        return clipped, gn

    steps.clip_by_global_norm = watched
    try:
        params, opt_state, met = step(params, opt_state,
                                      compat.distribute(batch, batch_sh(batch), mesh))
    finally:
        steps.clip_by_global_norm = clip
    out["loss"] = float(compat.gather(met["loss"]))
    out["grad_norm"] = float(compat.gather(met["grad_norm"]))
    out["grads"], out["clipped"] = seen["raw"], seen["clipped"]
    out["params"] = tree_to_numpy(compat.gather(params))
    out["placed_as_pshard"] = (mesh.device_mesh is None or all(
        p.placements == tuple(pl) for p, pl in compat.placed_leaves(params, pshard)))
    return out


# the recurrences' inputs: (name, shape, spec over ("data", "model")) of
# each, in the kernel's argument order, and the cotangents of the outputs
WKV_B, WKV_S, WKV_H, WKV_HD = 4, 12, 4, 16
SCAN_B, SCAN_S, SCAN_D, SCAN_N = 4, 12, 16, 8
KERNEL_INPUTS = {
    "wkv6": [("r", (WKV_B, WKV_S, WKV_H, WKV_HD), P("data", None, "model", None)),
             ("k", (WKV_B, WKV_S, WKV_H, WKV_HD), P("data", None, "model", None)),
             ("v", (WKV_B, WKV_S, WKV_H, WKV_HD), P("data", None, "model", None)),
             ("w", (WKV_B, WKV_S, WKV_H, WKV_HD), P("data", None, "model", None)),
             ("u", (WKV_H, WKV_HD), P("model", None)),
             ("s0", (WKV_B, WKV_H, WKV_HD, WKV_HD), P("data", "model", None, None))],
    "mamba_scan": [("dt", (SCAN_B, SCAN_S, SCAN_D), P("data", None, "model")),
                   ("x", (SCAN_B, SCAN_S, SCAN_D), P("data", None, "model")),
                   ("b", (SCAN_B, SCAN_S, SCAN_N), P("data", None, None)),
                   ("c", (SCAN_B, SCAN_S, SCAN_N), P("data", None, None)),
                   ("a", (SCAN_D, SCAN_N), P("model", None)),
                   ("h0", (SCAN_B, SCAN_D, SCAN_N), P("data", "model", None))],
}


def kernel_inputs(name: str, seed: int = 3) -> tuple[list, list]:
    """The inputs of ``ops.<name>`` (float32, drawn with numpy from
    ``seed``: decays in (0, 1), dt positive, a negative) and the cotangents
    of its two outputs."""
    rng = np.random.default_rng(seed)
    out = []
    for arg, shape, _ in KERNEL_INPUTS[name]:
        x = rng.standard_normal(shape).astype(np.float32)
        if arg == "w":
            x = np.exp(-np.exp(0.5 * x)).astype(np.float32)
        elif arg == "dt":
            x = np.log1p(np.exp(x)).astype(np.float32)
        elif arg == "a":
            x = -np.exp(0.5 * x).astype(np.float32)
        out.append(torch.from_numpy(x))
    # y has the first input's shape, the state the last's
    cots = [torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
            for t in (out[0], out[-1])]
    return out, cots


def placed_kernels(mesh) -> dict:
    """``ops.wkv6`` and ``ops.mamba_scan`` on DTensors placed on ``mesh`` by
    ``KERNEL_INPUTS``' specs: the outputs and states, the gradient of every
    input (of the outputs' products with the cotangents, summed), and, with
    the state given as its own ``out_state``, the placed state after the
    call and whether its block is the one the returned state views; all
    gathered whole, as numpy."""
    from repro_torch.sharding.rules import placements

    out = {}
    for name, fn in (("wkv6", ops.wkv6), ("mamba_scan", ops.mamba_scan)):
        inputs, cots = kernel_inputs(name)
        specs = [spec for _, _, spec in KERNEL_INPUTS[name]]

        def place(t, spec, grad=False):
            d = compat.distribute({"t": t.clone()}, {"t": placements(spec, mesh)}, mesh)["t"]
            return d.requires_grad_(grad)

        args = [place(t, spec, True) for t, spec in zip(inputs, specs)]
        y, state = fn(*args)
        cy, cs = (place(c, spec) for c, spec in zip(cots, (specs[0], specs[-1])))
        loss = compat.replicate_partial((y * cy).sum() + (state * cs).sum())
        loss.backward()
        got = {"y": compat.gather(y).detach().numpy(),
               "state": compat.gather(state).detach().numpy(),
               "grads": [compat.gather(a.grad).numpy() for a in args]}
        with torch.no_grad():
            args = [place(t, spec) for t, spec in zip(inputs, specs)]
            y2, new = fn(*args, out_state=args[-1])
            got["in_place_y"] = compat.gather(y2).numpy()
            got["in_place"] = compat.gather(args[-1]).numpy()
            got["aliased"] = new.to_local().data_ptr() == args[-1].to_local().data_ptr()
        out[name] = got
    return out


def sharded_steps(rank: int, layouts, cases: dict) -> dict:
    """``serve_and_train`` of each ``{arch: (params_np, case)}`` on each mesh
    of ``layouts`` (``(shape, axes, first rank)`` each: the mesh over that
    many ranks from that one, so that meshes on disjoint ranks run at the
    same time), in order, and ``placed_kernels`` under the key ``"ops"``:
    ``{mesh size: {arch or "ops": outputs}}`` of the meshes this rank
    belongs to. Every rank builds every mesh (making a mesh's groups is
    collective)."""
    from torch.distributed.device_mesh import DeviceMesh

    meshes = []
    for shape, axes, first in layouts:
        ranks = torch.arange(first, first + int(np.prod(shape))).reshape(shape)
        meshes.append((compat.Mesh(shape, axes, DeviceMesh("cpu", ranks, mesh_dim_names=axes)),
                       ranks))
    return {mesh.size: {"ops": placed_kernels(mesh),
                        **{arch: serve_and_train(mesh, arch, params_np, case)
                           for arch, (params_np, case) in cases.items()}}
            for mesh, ranks in meshes if rank in ranks}
