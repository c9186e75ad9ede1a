"""Named meshes for the production pod(s), tests and host runs
(``repro/launch/mesh.py``), over ``torch.distributed``.

Functions only: importing this module starts no process group. A mesh of
n ranks needs a process group of at least n ranks (``compat.make_mesh``
raises otherwise); the one-rank ``"cpu"`` mesh needs none. ``host_mesh()``
picks the largest named mesh the process group can serve, so the same call
is the (2, 4) ``"test"`` mesh in an 8-rank group and one rank elsewhere.

Where the reference splits the host CPU into fake XLA devices with a flag
(``host_device_flags``), the port starts real ranks: ``run_ranks(fn, n)``
runs ``fn`` in n CPU processes joined by gloo through a ``FileStore``, the
rehearsal of a multi-card run on one machine. ``fake_group(n)`` makes this
one process rank 0 of n in torch's fake process group, whose collectives
send nothing and return what they are given: the dry run counts a
full-size sharded step with it, on ``meta``.
"""

from __future__ import annotations

import contextlib
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import compat

__all__ = [
    "make_production_mesh",
    "make_mesh_by_name",
    "MESH_SPECS",
    "device_count_for",
    "host_mesh",
    "run_ranks",
    "fake_group",
]


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.make_mesh(shape, axes)


# name -> (shape, axes); the "test" variants run in 8 and 16 ranks
MESH_SPECS = {
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
    "test": ((2, 4), ("data", "model")),
    "multitest": ((2, 2, 4), ("pod", "data", "model")),
    "cpu": ((1, 1), ("data", "model")),
}


def device_count_for(name: str) -> int:
    shape, _ = MESH_SPECS[name]
    n = 1
    for s in shape:
        n *= s
    return n


def make_mesh_by_name(name: str):
    shape, axes = MESH_SPECS[name]
    return compat.make_mesh(shape, axes)


def host_mesh(prefer: str = "test"):
    """The largest named mesh this process can build: ``prefer`` (default
    ``"test"``, 8 ranks) when the process group has that many ranks, else
    the one-rank ``"cpu"`` mesh. The fleet engine's default mesh."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    name = prefer if world >= device_count_for(prefer) else "cpu"
    return make_mesh_by_name(name)


def _rank_main(fn, rank: int, n: int, store_path: str, args, results) -> None:
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, n)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=n)
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


# seconds the ranks of one ``run_ranks`` call may take together
RANKS_TIMEOUT_S = 600.0


def run_ranks(fn, n: int, *args) -> list:
    """``fn(rank, *args)`` in ``n`` fresh CPU processes joined by one gloo
    process group (a ``FileStore`` in a temporary directory); returns the
    ranks' results in rank order. ``fn``, its arguments and its results are
    pickled (``fn`` by its module path). Raises with a rank's traceback if
    one fails, and if they do not finish within ``RANKS_TIMEOUT_S``."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, os.path.join(tmp, "store"), args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        try:
            # drain before joining: a process that wrote to the queue may
            # not exit until its data is read
            while len(got) < n:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} of {n} exited with code "
                                           f"{procs[dead[0]].exitcode}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{n - len(got)} of {n} ranks did not finish "
                                           f"within {RANKS_TIMEOUT_S} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
                got[rank] = value
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(n)]


@contextlib.contextmanager
def fake_group(n: int):
    """This process as rank 0 of an ``n``-rank fake process group (torch's
    own, ``torch.testing._internal.distributed.fake_pg``) for the duration:
    a mesh of up to ``n`` ranks can be built and DTensors placed on it,
    and every collective returns at once with its input's shape and
    nothing sent. Raises if a process group is already initialized."""
    if dist.is_initialized():
        raise RuntimeError("fake_group starts its own process group; one is initialized")
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
