"""FFN blocks: dense SwiGLU / GELU MLP and Mixture-of-Experts
(``repro/models/ffn.py``).

The MoE keeps the reference's grouped sort-based dispatch: tokens are
grouped per sequence, and within each group the top-k assignments are
sorted by expert id (a stable sort, as ``jnp.argsort`` is) and scattered
into a fixed (E, C) capacity buffer; assignments beyond an expert's
capacity are dropped (GShard/Switch semantics), exactly the ones the
reference drops. The reference's ``vmap`` over groups is a leading group
axis here, and the expert products are batched matrix products.

On plain tensors there is no mesh and no ``shard_map``:
``cfg.moe_shard_map`` changes nothing, as in the reference outside a
mesh. On DTensors (a sharded step) the dispatch runs inside
``compat.shard_map``, on each rank's block: the expert weights whole on
the ``pod``/``data`` axes (an FSDP split gathered) and their hidden width
split over ``model`` as placed, so each rank's output is its term of a sum
over ``model`` (``Partial``, reduced where the sum is needed). The
reference's gate (``repro/models/ffn.py:156-160``: ``cfg.moe_shard_map and
not train`` and the batch dividing the batch axes) decides whether the
groups are split over the batch axes there, each rank routing its own; a
train step takes the other branch, where the reference leaves the vmap to
GSPMD, and DTensor, which has no sharding rule for the sort-based
scatters, routes every group on every rank.

Where the reference adds a token's k expert outputs back with a
scatter-add, the port puts them back in (token, k) order and sums over k
in index order, so that a run on the card repeats itself (no atomics).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import compat
from repro_torch.compat import PartitionSpec as P
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import gelu_mlp, swiglu
from repro_torch.models.params import ParamSpec

__all__ = ["dense_specs", "dense_apply", "moe_specs", "moe_apply"]


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

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
    """Placed, column-parallel then row-parallel: the hidden width split
    over ``model`` as the weights are, the output a ``Partial`` sum that
    DTensor reduces where it is needed."""
    if cfg.act == "gelu":
        return gelu_mlp(x, p["w_in"], p["b_in"], p["w_out"], p["b_out"])
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_specs(cfg: ArchConfig) -> dict:
    d, e, mff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = cfg.pdtype()
    out = {
        "router": ParamSpec((d, e), ("embed", "experts"), dtype=dt, scale=0.02),
        "w_gate": ParamSpec((e, d, mff), ("experts", "embed", "moe_mlp"), dtype=dt),
        "w_up": ParamSpec((e, d, mff), ("experts", "embed", "moe_mlp"), dtype=dt),
        "w_down": ParamSpec((e, mff, d), ("experts", "moe_mlp", "embed"), dtype=dt),
    }
    if cfg.num_shared_experts:
        sff = cfg.num_shared_experts * mff
        out["shared"] = {
            "w_gate": ParamSpec((d, sff), ("embed", "mlp"), dtype=dt),
            "w_up": ParamSpec((d, sff), ("embed", "mlp"), dtype=dt),
            "w_down": ParamSpec((sff, d), ("mlp", "embed"), dtype=dt),
        }
    return out


def _capacity(tokens_per_group: int, top_k: int, num_experts: int, cf: float) -> int:
    c = math.ceil(tokens_per_group * top_k * cf / num_experts)
    return max(int(c), 1)


def _group_dispatch(x, gates, idx, p, cfg: ArchConfig, capacity: int):
    """The MoE of every group at once. x: (G, T, d); gates, idx: (G, T, k).
    Returns (G, T, d) in the compute dtype."""
    g_n, t, d = x.shape
    k = idx.shape[-1]
    e = cfg.num_experts
    cd = cfg.cdtype()
    dev = x.device
    rows = torch.arange(g_n, device=dev)[:, None]

    flat_e = idx.reshape(g_n, t * k)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)          # (T*k,)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se, st = torch.gather(flat_e, 1, order), flat_t[order]
    sg = torch.gather(gates.reshape(g_n, t * k), 1, order)
    counts = torch.zeros((g_n, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_in_e = torch.arange(t * k, device=dev) - torch.gather(starts, 1, se)
    keep = pos_in_e < capacity
    slot = torch.where(keep, se * capacity + pos_in_e, e * capacity)   # e * C: dropped

    # one spare row takes the dropped assignments and is cut off
    buf = torch.zeros((g_n, e * capacity + 1, d), dtype=cd, device=dev)
    buf[rows, slot] = x[rows, st].to(cd)
    buf = buf[:, :e * capacity].reshape(g_n, e, capacity, d)

    gt = torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(cd))
    up = torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(cd))
    y_buf = torch.einsum("gecf,efd->gecd", F.silu(gt) * up, p["w_down"].to(cd))

    y_tok = y_buf.reshape(g_n, e * capacity, d)
    y_sorted = y_tok[rows, torch.clamp_max(slot, e * capacity - 1)]
    y_sorted = y_sorted * (sg * keep).to(cd)[..., None]
    # back to (token, k) order, then the k contributions summed in index order
    y_tk = torch.empty_like(y_sorted)
    y_tk[rows, order] = y_sorted
    y_tk = y_tk.reshape(g_n, t, k, d)
    out = y_tk[:, :, 0]
    for j in range(1, k):
        out = out + y_tk[:, :, j]
    return out


def _placed_dispatch(x, gates, idx, p, cfg: ArchConfig, capacity: int, *, train: bool):
    """``_group_dispatch`` of DTensors through ``compat.shard_map``, every
    mesh axis manual: the groups split over the batch axes under the
    reference's gate, else whole; the experts' hidden width split as their
    weights are over ``model``; the output ``Partial`` over that axis."""
    mesh = compat.mesh_of(x)
    b = x.shape[0]
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    n_shards = math.prod(mesh.shape[a] for a in batch_axes)
    if cfg.moe_shard_map and not train and batch_axes and b % n_shards == 0:
        spec = P(batch_axes, None, None)
    else:
        spec = P()
    w_gate, w_up, w_down = (p[k] for k in ("w_gate", "w_up", "w_down"))
    hidden = tuple(a for a, pg, pd in zip(mesh.axis_names, w_gate.placements,
                                          w_down.placements)
                   if a == "model" and pg.is_shard(2) and pd.is_shard(1))
    entry = hidden or None

    def body(x, gates, idx, w_gate, w_up, w_down):
        return _group_dispatch(x, gates, idx, {"w_gate": w_gate, "w_up": w_up,
                                               "w_down": w_down}, cfg, capacity)

    return compat.shard_map(
        body, mesh=mesh, in_specs=(spec, spec, spec, P(None, None, entry),
                                   P(None, None, entry), P(None, entry, None)),
        out_specs=spec, out_partial=hidden)(x, gates, idx, w_gate, w_up, w_down)


def moe_apply(cfg: ArchConfig, p, x, *, train: bool = False):
    """x: (B, S, d) -> ((B, S, d), the Switch load-balance aux loss, a
    float32 scalar). Each sequence is a group of capacity
    ``ceil(S * top_k * capacity_factor / E)``. ``train`` is the reference's
    argument; with the mesh it chooses how the dispatch of DTensors is
    split (see the module's docstring)."""
    b, s, d = x.shape
    cd = cfg.cdtype()
    logits = compat.einsum("bsd,de->bse", x, p["router"].to(cd)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)

    # load-balance aux (Switch eq. 4): E * sum_e f_e * p_e
    # (B, S, k, E); a comparison, not F.one_hot, whose range check reads the
    # indices back to the host on the CPU and cannot run on meta
    experts = torch.arange(cfg.num_experts, device=idx.device)
    onehot = (idx[..., None] == experts).to(torch.float32)
    frac_tokens = onehot.sum(dim=2).mean(dim=(0, 1))
    frac_prob = probs.mean(dim=(0, 1))
    aux = cfg.num_experts * torch.sum(frac_tokens * frac_prob)

    capacity = _capacity(s, cfg.top_k, cfg.num_experts, cfg.capacity_factor)
    if isinstance(x, DTensor):
        out = _placed_dispatch(x, gates.to(cd), idx, p, cfg, capacity, train=train)
    else:
        out = _group_dispatch(x, gates.to(cd), idx, p, cfg, capacity)
    if cfg.num_shared_experts:
        sp = p["shared"]
        out = out + swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out.to(x.dtype), aux
