"""Logical-axis -> mesh-axis resolution, MaxText-style with a divisibility
fallback (``repro/sharding/rules.py``).

Each param, cache or input leaf carries a tuple of logical axis names (from
its ``ParamSpec``). A rule set maps every logical name to an ordered list of
candidate mesh-axis assignments; the resolver picks, per leaf dimension,
the first candidate whose mesh-axis product divides the dimension and whose
axes no other dimension of the leaf already uses. Anything unresolvable is
replicated (whisper's 12 heads on a 16-way model axis, for one).

TRAIN rules: FSDP ("embed" -> data), TP ("heads"/"mlp"/"vocab" -> model),
DP ("batch" -> pod, data). SERVE rules keep weights model-sharded only and
shard long KV caches over the data axis. FLEET rules spread the leading
fleet axis of the fleet engine's (F, K, ...) tensors over every mesh axis
F divides.

The resolver reads only ``mesh.shape`` (axis name -> size) and returns the
port's ``compat.PartitionSpec``; ``tree_shardings`` and ``input_shardings``
give DTensor placements, one a mesh dimension (``Shard(dim)`` or
``Replicate()``), where the reference gives a ``NamedSharding``.
"""

from __future__ import annotations

from typing import Sequence

from torch.distributed.tensor import Replicate, Shard

from repro_torch.compat import PartitionSpec as P

__all__ = [
    "TRAIN_RULES",
    "SERVE_RULES",
    "FLEET_RULES",
    "resolve_spec",
    "tree_shardings",
    "input_shardings",
    "fleet_partition_axes",
    "placements",
]

# logical axis -> ordered candidates; each candidate is a tuple of mesh axes
TRAIN_RULES: dict[str, list[tuple[str, ...]]] = {
    "batch": [("pod", "data"), ("data",), ("pod",)],
    "seq": [],
    "cache_seq": [("data",)],
    "embed": [("data",)],            # FSDP / ZeRO param+optimizer sharding
    "vocab": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "head_dim": [],
    "mlp": [("model",)],
    "moe_mlp": [("model",)],
    "experts": [],                   # baseline: experts replicated, TP inside
    "state": [],
    "conv": [],
    "layers": [],
}

SERVE_RULES: dict[str, list[tuple[str, ...]]] = {
    **TRAIN_RULES,
    "embed": [],                     # weight-stationary decode
}

# expert-parallel MoE
EXPERT_PARALLEL_RULES: dict[str, list[tuple[str, ...]]] = {
    **TRAIN_RULES,
    "experts": [("model",)],
    "moe_mlp": [],
}

# fleet-of-fleets federation (fed/fleet.py): the leading "fleet" axis of
# every (F, K, ...) fleet tensor spreads over ALL mesh axes when F divides
# the full device count (edge fleets are independent until the global
# merge), degrading to the data axis alone, then to replication. "learner"
# (the K axis) stays on one rank: one fleet's solve and training are the
# unit of work.
FLEET_RULES: dict[str, list[tuple[str, ...]]] = {
    "fleet": [("pod", "data", "model"), ("data", "model"), ("data",)],
    "learner": [],
    "sample": [],
    "feature": [],
}


def fleet_partition_axes(f: int, mesh) -> tuple[str, ...]:
    """The mesh axes the fleet dimension of an ``(F, ...)`` tensor is split
    over under ``FLEET_RULES``: the axes a global merge must sum across.
    Empty = the fleet axis is whole on every rank (an empty mesh, or an F
    no candidate divides)."""
    spec = resolve_spec(("fleet",), (f,), mesh, FLEET_RULES)
    entry = spec[0] if len(spec) else None
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def resolve_spec(
    axes: Sequence[str | None],
    shape: Sequence[int],
    mesh,
    rules: dict[str, list[tuple[str, ...]]],
) -> P:
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, axes):
        assignment = None
        if name is not None:
            for cand in rules.get(name, []):
                if any(a not in mesh.shape for a in cand):
                    continue
                size = 1
                for a in cand:
                    size *= mesh.shape[a]
                if dim % size == 0 and not (set(cand) & used):
                    assignment = cand
                    used.update(cand)
                    break
        if assignment is None:
            out.append(None)
        elif len(assignment) == 1:
            out.append(assignment[0])
        else:
            out.append(assignment)
    return P(*out)


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh axis in
    order, ``Shard(dim)`` of the dimension split over it, else
    ``Replicate()``."""
    by_axis = {}
    for dim, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            by_axis[a] = Shard(dim)
    return tuple(by_axis.get(a, Replicate()) for a in mesh.shape)


def _map(fn, axes_tree, shape_tree):
    if axes_tree is None or shape_tree is None:   # an empty subtree (cache["ffn"])
        return None
    if isinstance(axes_tree, tuple):
        return fn(axes_tree, shape_tree)
    if isinstance(axes_tree, dict):
        return {key: _map(fn, sub, shape_tree[key]) for key, sub in axes_tree.items()}
    return [_map(fn, a, s) for a, s in zip(axes_tree, shape_tree)]


def tree_shardings(axes_tree, abstract_tree, mesh, rules) -> object:
    """(logical-axes tree, tree of shaped leaves, e.g. ``abstract_params``)
    -> tree of DTensor placements."""
    return _map(lambda axes, leaf: placements(resolve_spec(axes, leaf.shape, mesh, rules),
                                              mesh), axes_tree, abstract_tree)


# logical axes of the model's inputs, by name
_INPUT_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "image_embeds": ("batch", "seq", None),
    "encoder_embeds": ("batch", "seq", None),
    "token": ("batch", None),
    "cache_len": (),
}


def input_shardings(input_specs: dict, mesh, rules, cache_axes=None) -> dict:
    out = {}
    for name, spec in input_specs.items():
        if name == "cache":
            if cache_axes is None:
                raise ValueError("input_shardings needs cache_axes for a cache input")
            out[name] = tree_shardings(cache_axes, spec, mesh, rules)
        else:
            out[name] = placements(resolve_spec(_INPUT_AXES[name], spec.shape, mesh, rules),
                                   mesh)
    return out
