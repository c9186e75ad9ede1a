"""The work of each function behind ``kernels/ops.py``, from its shapes.

Each function returns ``(flops, bytes)`` as Python ints: the operations
the function needs on these inputs (its least work, whatever implements
it) and the bytes it must move, each input read once and each output
written once. That is what a roofline bound divides, the same for the
hand-written kernel, the plain version and a library call; it is not
the work a kernel's design executes (a tiled kernel computes masked
entries too, a recurrence in chunk form does more products).
``roofline.op_cost`` charges one entry of these a call.

The counts:

* attention: 4 B H d FLOPs a live (query, key) pair (the scores and the
  weighted sum, two products each); its backward 2.5 times that (the
  scores again, dP, dS's three products less the forward's one);
* WKV-6: y and the state update, 5 float32 operations per (b, h, t, i, j)
  and 5 per (b, h, t, j); its backward 6 FMAs per (b, h, t, i, j) (the
  state's recompute, G's update, the sums of dr, dk, dv and dw);
* the Mamba scan: dt a, its exponential (counted as one), h da + (dt x) B
  and the y sum, 6 per (b, t, d, n), and dt x per (b, t, d); its backward
  20 per (b, t, d, n) and 4 per (b, t, d);
* SwiGLU: three products of 2 m d f;
* ``fed_agg``: a multiply-add per learner and element; the async
  epilogue (``accum_flush``) 2 K + 6 an element;
* ``train_agg_step``: 2 a weight per row and step forward, 2 for the
  weight's gradient and 2 for the input's gradient (none into the
  first layer), over the rows each learner's steps touch (sum tau_k d_k);
* the water-fillings: 7 per learner (time-only: the hyperbola's 4, a
  two-sided clip and the sum), 12 for the budgeted one (two hyperbolae
  and a min), and a subtract per fleet.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "accum_flush_leaves",
    "attention_pairs",
    "fed_agg",
    "fed_agg_leaves",
    "flash_attention",
    "flash_attention_bwd",
    "mamba_scan",
    "mamba_scan_bwd",
    "mlp_params",
    "mlp_row_flops",
    "swiglu",
    "train_agg_step",
    "waterfill_energy_residual",
    "waterfill_residual",
    "wkv6",
    "wkv6_bwd",
]


def attention_pairs(sq: int, skv: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask lets through, positions from 0: the work
    of these inputs."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, skv - 1) if causal else np.full(sq, skv - 1, np.int64)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention(b: int, sq: int, skv: int, h: int, kvh: int, d: int, *,
                    causal: bool = True, window: int | None = None,
                    itemsize: int = 2) -> tuple[int, int]:
    """GQA attention, q (B, Sq, H, d), k and v (B, Skv, KV, d): q, k, v read
    and the output written once, in the operands' dtype."""
    flops = 4 * b * h * d * attention_pairs(sq, skv, causal, window)
    return flops, itemsize * (2 * b * sq * h * d + 2 * b * skv * kvh * d)


def flash_attention_bwd(b: int, sq: int, skv: int, h: int, kvh: int, d: int, *,
                        causal: bool = True, window: int | None = None,
                        itemsize: int = 2) -> tuple[int, int]:
    """Attention's gradient: q, k, v, out and dout read, dq, dk, dv written
    once, and the rows' float32 log-sum-exp read."""
    flops = 10 * b * h * d * attention_pairs(sq, skv, causal, window)
    return flops, itemsize * (4 * b * sq * h * d + 4 * b * skv * kvh * d) + 4 * b * h * sq


def wkv6(b: int, s: int, h: int, hd: int, *, itemsize: int = 2,
         with_state: bool = False) -> tuple[int, int]:
    """The WKV-6 recurrence: r, k, v read in their dtype, w read and y
    written in float32, u read, s0 read (when given) and s_last written."""
    n = b * s * h * hd
    nbytes = (3 * itemsize * n + 4 * 2 * n + 4 * h * hd
              + 4 * b * h * hd * hd * (2 if with_state else 1))
    return 5 * b * h * s * (hd * hd + hd), nbytes


def wkv6_bwd(b: int, s: int, h: int, hd: int, *, itemsize: int = 2, with_state: bool = False,
             with_dlast: bool = False) -> tuple[int, int]:
    """The WKV-6 gradient: r, k, v and dr, dk, dv in their dtype, w, dy and
    dw in float32, u and du, the states given and returned."""
    n = b * s * h * hd
    nbytes = ((6 * itemsize + 12) * n + 8 * h * hd
              + 4 * b * h * hd * hd * (2 * with_state + with_dlast))
    return 12 * b * h * s * hd * hd, nbytes


def mamba_scan(b: int, s: int, d: int, n: int, *, itemsize: int = 4,
               with_state: bool = False) -> tuple[int, int]:
    """The S6 scan: dt read and y written in float32, x read in its dtype,
    B, C and a read, h0 read (when given) and h_last written."""
    nbytes = ((8 + itemsize) * b * s * d + 4 * 2 * b * s * n + 4 * d * n
              + 4 * b * d * n * (2 if with_state else 1))
    return 6 * b * s * d * n + b * s * d, nbytes


def mamba_scan_bwd(b: int, s: int, d: int, n: int, *, itemsize: int = 4,
                   with_state: bool = False, with_dlast: bool = False) -> tuple[int, int]:
    """The S6 scan's gradient: dt, dy read and ddt written in float32, x
    read and dx written in x's dtype, B, C read and dB, dC written, a and
    da, the states given and returned."""
    nbytes = ((12 + 2 * itemsize) * b * s * d + 16 * b * s * n + 8 * d * n
              + 4 * b * d * n * (2 * with_state + with_dlast))
    return 20 * b * s * d * n + 4 * b * s * d, nbytes


def swiglu(m: int, d: int, f: int, *, itemsize: int = 2) -> tuple[int, int]:
    """``down(silu(x Wg) * (x Wu))`` of m rows: x read, three weights read,
    the output written."""
    return 6 * m * d * f, itemsize * (2 * m * d + 3 * d * f)


def fed_agg_leaves(numels, k: int, *, groups: int = 1, itemsize: int = 4) -> tuple[int, int]:
    """The weighted sum over K learners of every leaf (``numels`` elements
    a learner each) with one float32 weight vector, into ``groups``
    outputs a leaf (K = groups x learners a group)."""
    total = sum(int(x) for x in numels)
    return 2 * k * total, itemsize * (k * total + groups * total) + 4 * k


def fed_agg(numel: int, k: int, *, groups: int = 1, itemsize: int = 4) -> tuple[int, int]:
    """``fed_agg_leaves`` of one leaf."""
    return fed_agg_leaves([numel], k, groups=groups, itemsize=itemsize)


def accum_flush_leaves(numels, k: int) -> tuple[int, int]:
    """The async epilogue of K float32 learners on every leaf: the
    accumulate and the flush read the learners, the accumulator and the
    server, and write the two new ones."""
    total = sum(int(x) for x in numels)
    return (2 * k + 6) * total, 4 * ((k + 4) * total + k)


def mlp_params(widths) -> int:
    """Weights and biases of an MLP of these layer widths."""
    return sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))


def mlp_row_flops(widths) -> int:
    """FLOPs of one GD step on one row of an MLP of these widths."""
    mats = [a * b for a, b in zip(widths[:-1], widths[1:])]
    return 2 * (2 * sum(mats) + sum(mats[1:]))


def train_agg_step(widths, *, row_steps: int, learners: int, d_cap: int, starts: int,
                   outputs: int) -> tuple[int, int]:
    """``row_steps`` (sum over learners of tau_k d_k) GD row-steps of the
    MLP, then the aggregate: x (``d_cap`` rows a learner), y and the mask
    read, tau and the weights read, ``starts`` start models read and
    ``outputs`` models written (the cycle form's groups; 4 for the async
    form: the server and accumulator read and written), all 4 bytes an
    element."""
    n_params = mlp_params(widths)
    nbytes = 4 * (learners * d_cap * (widths[0] + 2) + 2 * learners
                  + (starts + outputs) * n_params)
    return row_steps * mlp_row_flops(widths), nbytes


def waterfill_residual(b: int, k: int, *, itemsize: int = 8) -> tuple[int, int]:
    """The time-only residual of (B, K) fleets: c2, c1, c0, d_lo, d_hi read
    per learner, tau*, T, total read and the residual written per fleet."""
    return 7 * b * k + b, itemsize * (5 * b * k + 3 * b + b)


def waterfill_energy_residual(b: int, k: int, *, itemsize: int = 8) -> tuple[int, int]:
    """The budgeted residual: nine inputs per learner (the time and energy
    coefficients and the bounds), tau*, T, total read and the residual
    written per fleet."""
    return 12 * b * k + b, itemsize * (9 * b * k + 3 * b + b)
