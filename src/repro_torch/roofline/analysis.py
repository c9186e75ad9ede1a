"""Roofline model of one NVIDIA H100 (``repro/roofline/analysis.py``).

Three terms, all in seconds (per training or serving step, per card):

    compute    = FLOPs / peak FLOP/s
    memory     = bytes / HBM bandwidth
    collective = sum_c (bytes_c * factor_c) / link bandwidth

The FLOPs and bytes come from ``roofline.op_cost.analyze_step`` (a step
run once under a counting dispatch mode), where the reference parses
XLA's compiled HLO. There is no HLO to parse for the collectives either:
``collective_bytes`` tallies the port's own, which ``compat.psum`` and
``compat.shard_map``'s gathers report to the active counter.

Bandwidth factors per collective (ring algorithms, n >> 1):
  all-reduce ~ 2x payload, all-gather / reduce-scatter / all-to-all ~ 1x,
  collective-permute ~ 1x.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "HW",
    "Hardware",
    "collective_bytes",
    "roofline_terms",
    "model_flops_per_step",
]


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Peaks of one card. The defaults are NVIDIA's data sheet for the
    H100 SXM (H100 80GB HBM3) at its 700 W power limit, dense rates
    without sparsity; a card set below 700 W runs slower under load."""

    peak_flops: float = 989e12          # bf16 (and fp16) tensor cores, FLOP/s; H100 80GB HBM3, 700 W
    tf32_flops: float = 495e12          # TF32 tensor cores, FLOP/s; H100 80GB HBM3, 700 W
    fp32_flops: float = 67e12           # float32 outside the tensor cores, FLOP/s; H100 80GB HBM3, 700 W
    fp64_flops: float = 34e12           # float64 outside the tensor cores, FLOP/s; H100 80GB HBM3, 700 W
    hbm_bw: float = 3.35e12             # HBM3, bytes/s; H100 80GB HBM3, 700 W
    link_bw: float = 450e9              # NVLink, bytes/s each way; H100 80GB HBM3, 700 W


HW = Hardware()

_COLL_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_bytes(calls=()) -> dict:
    """The ``{op: {"bytes", "count"}}`` table of ``hlo_collectives``, from
    the port's own collectives: ``calls`` is an iterable of ``(op,
    payload bytes)``, ``op`` one of the table's names."""
    out: dict[str, dict] = {k: {"bytes": 0, "count": 0} for k in _COLL_FACTOR}
    for op, nbytes in calls:
        out[op]["bytes"] += int(nbytes)
        out[op]["count"] += 1
    return out


def roofline_terms(flops: float, bytes_accessed: float, collectives: dict, hw: Hardware = HW) -> dict:
    coll_bytes_eff = sum(
        v["bytes"] * _COLL_FACTOR[k] for k, v in collectives.items()
    )
    coll_bytes_raw = sum(v["bytes"] for v in collectives.values())
    terms = {
        "compute_s": flops / hw.peak_flops,
        "memory_s": bytes_accessed / hw.hbm_bw,
        "collective_s": coll_bytes_eff / hw.link_bw,
        "collective_bytes": coll_bytes_raw,
    }
    dominant = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    terms["dominant"] = dominant.replace("_s", "")
    bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["compute_fraction_of_bound"] = (
        terms["compute_s"] / bound if bound > 0 else 0.0
    )
    return terms


def model_flops_per_step(cfg, shape, n_chips: int) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for train; 2 N D for
    a single forward token batch in decode; per chip."""
    total, active = cfg.param_counts()
    if shape.kind == "train":
        mult, tokens = 6.0, shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        mult, tokens = 2.0, shape.global_batch * shape.seq_len
    else:
        mult, tokens = 2.0, shape.global_batch  # one token per sequence
    return mult * active * tokens / n_chips
