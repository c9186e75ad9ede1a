"""Dry run: count every (architecture x input shape) step at full width and
depth, and its roofline terms (``repro/launch/dryrun.py``).

The reference lowers and compiles each step for 512 fake TPU devices and
reads the compiled HLO. The port runs the step once on the ``meta`` device
(shapes and dtypes, no storage, no card) under ``roofline.op_cost``'s
counting mode: each aten op by ``hlo_cost``'s rules, each hand-written
kernel by its ``kernel_cost``, a remat's rerun included. The roofline terms
are the H100's (``roofline.analysis.HW``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh cpu|pod|multipod|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k \\
      --set num_layers=4 --batch 4 --seq 2048 --device cuda   # run and timed on the card

On the one-rank ``cpu`` mesh (the default) the record is the whole step,
``n_chips`` 1, no collectives. On ``pod``, ``multipod``, ``test`` and
``multitest`` the dry run checks that the rules partition every leaf of
the parameters, the optimizer state, the batch and the cache
(``resolve_spec`` on a ``compat.Mesh`` made without a process group) and
records the per-device argument bytes of those placements. For every
family it then counts the sharded step per device: in a fake process group
of the mesh's size (``launch.mesh.fake_group``, which refuses a process
that has a group already), the ``meta`` trees placed by the step's
shardings (``compat.distribute``) and the step run once under
``op_cost``'s count, which sees this rank's local ops (each kernel at its
block's shapes) and the collectives: DTensor's, the port's own (the
lookups' all-reduce, Mamba's ``in_proj`` exchange, an ``all_to_all``).
Decode takes a concrete ``cache_len`` of ``seq_len - 1``, a full cache
(the models read it on the host), written into the record.

``--device cuda`` builds the weights from seed 0 on the card (cut the
depth with ``--set num_layers=...`` and the shape with ``--batch`` and
``--seq``: the input shapes are a pod's), counts the step while it runs, then
times it: ``measured_ms`` (host clock, warm, the median of 3),
``max_memory_allocated`` and ``share_of_bound`` (the larger roofline term
over the measured time). It raises without a card.

Records land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__<rules>]
[__<tag>].json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import time

import torch

from repro_torch import compat, resolve_device, tree
from repro_torch.compat import Mesh
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.mesh import MESH_SPECS, device_count_for, fake_group, make_mesh_by_name
from repro_torch.launch.steps import build_decode, build_prefill, build_train
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.roofline import op_cost
from repro_torch.roofline.analysis import HW, model_flops_per_step, roofline_terms
from repro_torch.sharding.rules import (
    EXPERT_PARALLEL_RULES,
    SERVE_RULES,
    TRAIN_RULES,
)

__all__ = ["RULE_SETS", "build_step", "main", "per_device_bytes",
           "place_inputs", "run_one", "should_skip", "step_inputs"]

RULE_SETS = {
    "train": TRAIN_RULES,
    "serve": SERVE_RULES,
    "expert_parallel": EXPERT_PARALLEL_RULES,
}


def should_skip(arch: str, shape_name: str) -> str | None:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.supports_long_context():
        return (
            "full-attention architecture: 500k-token decode is outside the "
            "published family's attention form (see DESIGN.md §5)"
        )
    return None


def _configure(arch: str, overrides: dict | None):
    cfg = get_config(arch)
    if overrides:
        typed = {}
        for k, v in overrides.items():
            cur = getattr(cfg, k)
            typed[k] = type(cur)(v) if cur is not None else v
        cfg = dataclasses.replace(cfg, **typed)
    return cfg


def _nbytes(t) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(t) if torch.is_tensor(x))


def step_inputs(model: Model, shape: InputShape, device):
    """The step's arguments for ``shape``: on ``meta`` the abstract
    parameters (and optimizer state) and ``input_specs``; elsewhere the
    weights drawn from seed 0 on the device and random inputs of the same
    shapes and dtypes. Returns (args after the params, the params); decode's
    ``cache_len`` is ``seq_len - 1``."""
    cfg = model.cfg
    specs = model.input_specs(shape)
    if torch.device(device).type == "meta":
        params = model.abstract_params()
    else:
        params = model.init(0)
        gen = torch.Generator().manual_seed(0)

        def real(spec):
            if spec.dtype == torch.int32:
                t = torch.randint(0, cfg.vocab_size, spec.shape, generator=gen,
                                  dtype=torch.int32)
            else:
                t = 0.02 * torch.randn(spec.shape, generator=gen)
            return t.to(device=device, dtype=spec.dtype)

        specs = {k: (model.init_cache(shape.global_batch, shape.seq_len) if k == "cache"
                     else real(v)) for k, v in specs.items()}
    if shape.kind == "train":
        opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
        return (opt.init(params), specs), params
    if shape.kind == "prefill":
        return (specs,), params
    return (specs["cache"], specs["token"], shape.seq_len - 1), params


def build_step(model: Model, shape: InputShape, mesh, rules):
    """The dry run's step of ``shape.kind`` from ``launch.steps``."""
    if shape.kind == "train":
        return build_train(model, mesh, rules)[0]
    if shape.kind == "prefill":
        return build_prefill(model, mesh, shape, rules)[0]
    return build_decode(model, mesh, shape, rules)[0]


def _card() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    name, power = (x.strip() for x in smi.stdout.strip().splitlines()[0].split(","))
    return {"name": name, "power_limit": power}


def per_device_bytes(values, placements_tree, mesh: Mesh) -> int:
    """The bytes one device holds of ``values`` laid out by its placements
    tree on ``mesh``; raises where a split does not divide its dimension."""
    return sum(math.prod(compat.local_shape(leaf.shape, pl, mesh)) * leaf.element_size()
               for leaf, pl in compat.placed_leaves(values, placements_tree))


def _input_placements(model: Model, shape: InputShape, mesh: Mesh, rules) -> dict:
    """{input tree: (its abstract tree, its placements tree)} of the step
    for ``shape.kind``, from the shardings ``launch.steps`` returns: the
    params, then the step's arguments in order (train: opt_state, batch;
    prefill: batch; decode: cache, token). An optimizer without state has
    the placements ``()``."""
    aparams = model.abstract_params()
    specs = model.input_specs(shape)
    if shape.kind == "train":
        _, (pshard, oshard, batch_sh), _, (_, aopt) = build_train(model, mesh, rules)
        return {"params": (aparams, pshard), "opt_state": (aopt, oshard),
                "batch": (specs, batch_sh(specs))}
    if shape.kind == "prefill":
        _, (pshard, batch_sh), _ = build_prefill(model, mesh, shape, rules)
        return {"params": (aparams, pshard), "batch": (specs, batch_sh(specs))}
    _, (pshard, cshard, tshard, _), _ = build_decode(model, mesh, shape, rules)
    return {"params": (aparams, pshard), "cache": (specs["cache"], cshard),
            "batch": (specs["token"], tshard)}


def _partition(model: Model, shape: InputShape, mesh: Mesh, rules) -> dict:
    """Every leaf of the params, optimizer state, batch and cache resolved on
    ``mesh`` (``per_device_bytes`` checks each split); returns the
    per-device bytes of each tree."""
    return {name: per_device_bytes(values, pl, mesh) if pl != () else 0
            for name, (values, pl) in _input_placements(model, shape, mesh, rules).items()}


def place_inputs(model: Model, shape: InputShape, mesh, rules, params, args):
    """(params, args) of ``step_inputs`` placed on ``mesh`` by the shardings
    ``launch.steps`` returns for ``shape.kind`` (``compat.distribute``)."""
    pshard, *placements = (pl for _, pl in
                           _input_placements(model, shape, mesh, rules).values())
    placed = tuple(compat.distribute(x, pl, mesh) if pl != () else x
                   for x, pl in zip(args, placements))
    return compat.distribute(params, pshard, mesh), placed + tuple(args[len(placements):])


def _count_sharded(model: Model, shape: InputShape, mesh_name: str, rules):
    """The per-device count of the sharded step on ``mesh_name``: rank 0 of
    a fake process group of the mesh's size, the ``meta`` trees placed."""
    with fake_group(device_count_for(mesh_name)):
        mesh = make_mesh_by_name(mesh_name)
        step = build_step(model, shape, mesh, rules)
        args, params = step_inputs(model, shape, "meta")
        params, args = place_inputs(model, shape, mesh, rules, params, args)
        return op_cost.analyze_step(step, params, *args)


def run_one(arch: str, shape_name: str, mesh_name: str, rules_name: str | None = None,
            out_dir: str = "artifacts/dryrun_torch", verbose: bool = True,
            overrides: dict | None = None, tag: str = "", device: str = "meta",
            batch: int | None = None, seq: int | None = None) -> dict:
    cfg = _configure(arch, overrides)
    shape = INPUT_SHAPES[shape_name]
    shape = dataclasses.replace(shape, global_batch=batch or shape.global_batch,
                                seq_len=seq or shape.seq_len)
    mesh = Mesh(*MESH_SPECS[mesh_name])
    n_chips = mesh.size
    rules_name = rules_name or ("train" if shape.kind == "train" else "serve")
    rules = RULE_SETS[rules_name]
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    if n_chips > 1 and dev.type != "meta":
        raise ValueError(f"--device {device} runs the one-rank cpu mesh only")
    model = Model(cfg, device=dev)
    total, active = cfg.param_counts()
    mf = model_flops_per_step(cfg, shape, n_chips)
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "mesh_shape": dict(mesh.shape),
        "rules": rules_name,
        "n_chips": n_chips,
        "kind": shape.kind,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "device": dev.type,
        "hardware": {**(_card() if dev.type == "cuda" else
                        {"name": "not measured (meta)", "power_limit": "not measured"}),
                     "peaks": dataclasses.asdict(HW),
                     "peaks_source": "NVIDIA H100 SXM data sheet, dense, 700 W"},
        "model_flops_per_chip": mf,
        "params_total": total,
        "params_active": active,
        "overrides": overrides or {},
        "tag": tag,
    }
    if shape.kind == "decode":
        record["cache_len"] = shape.seq_len - 1

    t0 = time.time()
    if n_chips > 1:
        per_dev = _partition(model, shape, mesh, rules)
        memory = {"argument_size_in_bytes": sum(per_dev.values()),
                  "argument_bytes_by_tree": per_dev}
        cost = _count_sharded(model, shape, mesh_name, rules)
        terms = roofline_terms(cost.flops, cost.bytes, cost.collectives)
        record.update({
            "trace_s": round(time.time() - t0, 2),
            "flops_per_device": cost.flops,
            "bytes_per_device": cost.bytes,
            "collectives": cost.collectives,
            "by_class": cost.by_class,
            "kernels": cost.kernels,
            "torch_cost_analysis": None,
            "memory": memory,
            "roofline": terms,
            "link_bw": HW.link_bw,
            "useful_flops_ratio": (mf / cost.flops) if cost.flops else None,
            "aten_ops": cost.ops,
        })
    else:
        step = build_step(model, shape, mesh, rules)
        args, params = step_inputs(model, shape, dev)
        arg_bytes = _nbytes((params, args))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        cost, builtin, out = op_cost.analyze_with_builtin(step, params, *args)
        flops, nbytes = cost.flops, cost.bytes
        terms = roofline_terms(flops, nbytes, cost.collectives)
        memory = {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": _nbytes(out)}
        del out
        record.update({
            "trace_s": round(time.time() - t0, 2),
            "flops_per_device": flops,
            "bytes_per_device": nbytes,
            "collectives": cost.collectives,
            "by_class": cost.by_class,
            "kernels": cost.kernels,
            "torch_cost_analysis": {"flops": builtin, "bytes_accessed": float(nbytes)},
            "memory": memory,
            "roofline": terms,
            "useful_flops_ratio": (mf / flops) if flops else None,
            "aten_ops": cost.ops,
        })
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            memory["temp_size_in_bytes"] = torch.cuda.max_memory_allocated(dev) - base
            times = []
            for _ in range(3):
                t1 = time.perf_counter()
                del_out = step(params, *args)
                torch.cuda.synchronize(dev)
                times.append(1e3 * (time.perf_counter() - t1))
                del del_out
            measured = statistics.median(times)
            record.update({
                "measured_ms": measured, "measured_ms_all": times,
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
                "share_of_bound": max(terms["compute_s"], terms["memory_s"]) / (measured / 1e3),
            })

    out_path = pathlib.Path(out_dir)
    out_path.mkdir(parents=True, exist_ok=True)
    suffix = f"__{rules_name}" if rules_name not in ("train", "serve") else ""
    if tag:
        suffix += f"__{tag}"
    path = out_path / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    path.write_text(json.dumps(record, indent=1))

    if verbose:
        r = record["roofline"]
        print(
            f"[dryrun] {arch:18s} {shape_name:12s} {mesh_name:9s} {rules_name:15s} "
            f"trace={record['trace_s']:6.1f}s flops/dev={record['flops_per_device']:.3e} "
            f"bytes/dev={record['bytes_per_device']:.3e} "
            f"coll={r['collective_bytes']:.3e}B dom={r['dominant']:10s} "
            f"comp={r['compute_s']*1e3:.2f}ms mem={r['memory_s']*1e3:.2f}ms "
            f"coll={r['collective_s']*1e3:.2f}ms"
            + (f" measured={record['measured_ms']:.1f}ms "
               f"share={record['share_of_bound']:.3f}" if "measured_ms" in record else ""),
            flush=True,
        )
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="cpu",
                    choices=["cpu", "pod", "multipod", "both", "test", "multitest"])
    ap.add_argument("--rules", default=None, choices=[None, *RULE_SETS], nargs="?")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    help="config override key=value (repeatable), e.g. --set num_layers=4")
    ap.add_argument("--tag", default="", help="artifact suffix for variant runs")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta counts without a card; cuda also runs and times the step")
    ap.add_argument("--batch", type=int, default=None, help="cut the shape's global batch")
    ap.add_argument("--seq", type=int, default=None, help="cut the shape's sequence length")
    args = ap.parse_args(argv)
    overrides = dict(s.split("=", 1) for s in args.sets)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = ARCH_NAMES if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape else [args.shape]

    failures = []
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                why = should_skip(arch, shape_name)
                if why:
                    print(f"[dryrun] {arch:18s} {shape_name:12s} SKIP: {why}", flush=True)
                    continue
                try:
                    run_one(arch, shape_name, mesh_name, args.rules, args.out,
                            overrides=overrides, tag=args.tag, device=args.device,
                            batch=args.batch, seq=args.seq)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape_name, mesh_name, repr(e)))
                    print(f"[dryrun] {arch:18s} {shape_name:12s} {mesh_name:9s} FAIL {e!r}",
                          flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print("[dryrun] all requested combinations counted OK")


if __name__ == "__main__":
    main()
