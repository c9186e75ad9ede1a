"""Rank functions of the port's mesh tests (``tests/test_torch_mesh.py``).

``launch.mesh.run_ranks`` starts each rank in a fresh process that imports
this module by its path, so it imports torch and the port only: no jax,
nothing of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import compat
from repro_torch.compat import PartitionSpec as P
from repro_torch.convert import params_to_numpy
from repro_torch.data.pipeline import synthetic_mnist
from repro_torch.fed.fleet import FleetConfig, FleetEngine, build_fleet_problems
from repro_torch.launch.mesh import host_mesh
from repro_torch.models import mlp

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
