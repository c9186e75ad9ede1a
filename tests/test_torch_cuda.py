"""The CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. This file imports neither jax nor the reference package, so it
runs on a machine with the card and no jax:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Shapes are small and ragged (not multiples of the kernels' tiles) and
cover the degenerate cases: a learner with tau_k = 0, one learner, an
all-masked shard, a mask with holes, every tau 0, more learners than the
persistent training kernel has CTAs, one learner training among ten at
tau 0. Tolerance: a few GD steps in float32 whose sums run in another
order than the plain version's, rtol 1e-5 and atol 1e-6 per element. A
call trains in one launch of the training kernel (counted by
``torch.profiler``), and refuses more than 16 layers or 64 classes.

The accumulate/flush kernel runs the plain version's sum in its order with
every product rounded, so it is held to 1e-6.

The water-filling residual kernel sums in the plain version's order and
rounds every operation as it does, so its tolerance is tight: absolute
1e-12 * max(1, |total|) in float64, 1e-5 * max(1, |total|) in float32.
A small ``solve_kkt_batched`` on the card must give the CPU's rows. The
budgeted water-filling kernel is held the same way; with ``eb = +inf`` it
must give the time-only kernel's output bitwise, and its NaNs must sit
where the plain version's do. A small ``solve_energy_batched`` on the card
must give the CPU's rows too.

The flash-attention kernel is held to the dense oracle
``ref.flash_attention_ref`` on the card. Both compute in float32 and add in
other orders (the kernel tile by tile with a running max), so float32 is
held to 1e-5 of max(1, max |oracle|); in bfloat16 the only rounding that
differs is the output's, one bf16 step (2^-8 relative), so 1e-2. The bf16
kernel (tensor cores, p split into two bf16 parts) is also held to the
float32 kernel on the same inputs widened: the float32 kernel's output
rounded to bf16 may differ from it by one bf16 step of the output's scale
and no more, which a p rounded to bf16 once would not hold. Two launches
on the same inputs give the same bits. A reduced-width 28-layer dense
prefill on the card launches it once a layer and decode never, and its
logits match the CPU's run of the same weights.

The all-leaf ``fed_agg`` launch sums over k in order with every product
rounded, so each leaf is bitwise the in-order per-leaf sum, and the
single-leaf launch; a fused cycle aggregates every leaf in one launch.

The WKV-6 kernel is held to the step loop ``ref.wkv6_ref`` on the card:
both take every product in float32 from the same inputs and sum over i in
other orders (the kernel with fused multiply-adds), and the output is
float32 for bf16 inputs too, so y and s_last are held to 1e-5 of
max(1, max |plain|) in both dtypes. The decode form writes the state over
its own s0. A reduced-width 4-layer RWKV-6 prefill launches it once a
layer, and decode once a layer a step, with logits matching the CPU's.

The Mamba scan kernel is held to the step loop ``ref.mamba_scan_ref``: both
take every product in float32 (a bf16 x widened exactly) and sum over n in
other orders (the kernel with fused multiply-adds), so y and h_last are
held to 1e-5 of max(1, max |plain|). The state may be written over its own
h0. A reduced-width 8-layer Jamba prefill launches it once a Mamba layer
(7) and decode never, with logits matching the CPU's.

The fused SwiGLU kernel takes its three products in float32 from the
widened inputs (bf16 on the tensor cores with h in two bf16 pieces,
float32 as 3xTF32) and returns x's dtype; it is held to ``ref.swiglu_ref``
on the inputs widened to float32, summed in another order: 1e-5 of
max(1, max |plain|) for float32, one bf16 step (2^-8) for bf16 output.
The shapes include strides TMA takes as they lie and ones the kernel
first packs (d or f not a multiple of 8 in bf16).

At the paper's widths the check is one step. Over several steps there, a
hidden pre-activation within float32 rounding of zero can take the other
side of the ReLU in the kernel than in the plain version, and that unit's
gradient then differs by its whole size, far beyond these tolerances,
with no fault in either (``chip_smoke.py`` prints both float32 versions'
distance from a float64 run after one step and after a full cycle, and
holds the full paper-width cycle to 1e-4 of each leaf's scale).
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.convert import tree_to_numpy
from repro_torch.core import solver_batched
from repro_torch.kernels import (
    accum_flush,
    fed_agg,
    flash_attention,
    mamba_scan,
    ops,
    ref,
    swiglu,
    train_step,
    waterfill,
    wkv6,
)
from repro_torch.models import mlp
from repro_torch.models.layers import flash_attention as chunked_attention
from repro_torch.models.model import Model

pytestmark = pytest.mark.cuda

LR = 0.1
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(k: int, layers, seed: int, dev):
    """K distinct learner models stacked on a leading axis."""
    models = [mlp.init(seed + i, layers, device=dev) for i in range(k)]
    return [{name: torch.stack([m[l][name] for m in models]) for name in models[0][l]}
            for l in range(len(layers) - 1)]


def _batch(k, n, layers, seed, dev):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((k, n, layers[0])), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.integers(0, layers[-1], (k, n)), dtype=torch.int32, device=dev)
    m = torch.tensor(rng.random((k, n)) < 0.8, dtype=torch.float32, device=dev)
    return x, y, m


@pytest.mark.parametrize("shape", [(1, 1), (3, 257), (10, 784, 300), (4, 1, 5)])
def test_fed_agg_kernel_matches_plain(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=dev)
    w = torch.softmax(torch.randn(shape[0], generator=gen, device=dev), 0)
    fed_agg.launches = 0
    got = ops.fed_agg(x, w)
    torch.cuda.synchronize()
    assert fed_agg.launches == 1
    torch.testing.assert_close(got, ref.fed_agg_ref(x, w), rtol=1e-6, atol=1e-6)


# the paper MLP's 8 leaves, and ragged sizes with an empty leaf
FED_AGG_LEAVES = {
    "paper_mlp": [(784, 300), (300,), (300, 124), (124,), (124, 60), (60,), (60, 10), (10,)],
    "ragged": [(1,), (257,), (3, 5, 7), (0, 4), (1000, 3), (33,)],
}


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("case", sorted(FED_AGG_LEAVES))
def test_fed_agg_all_leaf_launch_is_the_per_leaf_sum_bitwise(dev, case, k):
    gen = torch.Generator(device=dev).manual_seed(k + len(case))
    leaves = [torch.randn((k, *shape), generator=gen, device=dev)
              for shape in FED_AGG_LEAVES[case]]
    w = torch.softmax(torch.randn(k, generator=gen, device=dev), 0)
    fed_agg.launches = 0
    got = fed_agg.fed_agg_leaves_cuda(leaves, w)
    torch.cuda.synchronize()
    assert fed_agg.launches == 1
    for g, x in zip(got, leaves):
        want = torch.zeros(x.shape[1:], device=dev)
        for j in range(k):  # in order, each product rounded before the add
            want = want + w[j] * x[j]
        assert g.shape == x.shape[1:] and torch.equal(g, want)
        assert torch.equal(g, fed_agg.fed_agg_cuda(x, w))
        torch.testing.assert_close(g, ref.fed_agg_ref(x, w), rtol=1e-6, atol=1e-6)


def test_fed_agg_all_leaf_launch_refuses_what_it_does_not_take(dev):
    w = torch.ones(2, device=dev) / 2
    leaf = torch.randn(2, 3, device=dev)
    with pytest.raises(ValueError, match=f"1 to {fed_agg.MAX_LEAVES} leaves"):
        fed_agg.fed_agg_leaves_cuda([leaf] * (fed_agg.MAX_LEAVES + 1), w)
    with pytest.raises(ValueError, match="learner axis"):
        fed_agg.fed_agg_leaves_cuda([leaf, torch.randn(3, 3, device=dev)], w)
    fed_agg.launches = 0
    got = fed_agg.fed_agg_leaves_cuda([leaf] * fed_agg.MAX_LEAVES, w)
    torch.cuda.synchronize()
    assert fed_agg.launches == 1 and all(torch.equal(g, got[0]) for g in got)


def test_fed_agg_kernel_refuses_what_it_does_not_take(dev):
    x = torch.randn(3, 8, device=dev)
    w = torch.ones(3, device=dev) / 3
    with pytest.raises(ValueError, match="float32"):
        fed_agg.fed_agg_cuda(x.double(), w)
    with pytest.raises(ValueError, match="contiguous"):
        fed_agg.fed_agg_cuda(x.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="learner axis"):
        fed_agg.fed_agg_cuda(x, w[:2])


# layers, K, d_cap, tau, what to do to the mask
CASES = {
    "ragged": ([100, 70, 33, 10], 3, 70, [4, 2, 3], None),
    "tau_k_zero": ([100, 70, 33, 10], 3, 70, [3, 0, 2], None),
    "single_learner": ([64, 32, 16, 10], 1, 40, [3], None),
    "all_masked_shard": ([64, 32, 16, 10], 3, 40, [2, 3, 2], "dead"),
    "mask_with_holes": ([100, 70, 33, 10], 2, 130, [3, 2], "holes"),
    "all_tau_zero": ([64, 32, 16, 10], 2, 40, [0, 0], None),
    "paper_widths": (mlp.PAPER_LAYERS, 2, 150, [1, 0], None),
    # more learners than the persistent kernel has CTAs (2 an SM), and a
    # one-learner group among ten at tau 0 (the fedasync shape)
    "many_learners": ([16, 12, 10], 300, 20, [i % 4 for i in range(300)], None),
    "k64": ([32, 24, 10], 64, 30, [i % 3 for i in range(64)], None),
    "one_of_ten": ([100, 70, 33, 10], 10, 60, [3] + [0] * 9, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_agg_step_kernel_matches_plain(dev, case):
    layers, k, d_cap, tau, mask_kind = CASES[case]
    disp = _model(k, layers, seed=len(case), dev=dev)
    x, y, m = _batch(k, d_cap, layers, seed=k + d_cap, dev=dev)
    if mask_kind == "dead":
        m[1] = 0.0
    elif mask_kind == "holes":
        m[:, d_cap // 2:] = 0.0
        m[0, d_cap - 3] = 1.0
    tau_t = torch.tensor(tau, dtype=torch.int32, device=dev)
    w = torch.softmax(torch.arange(k, dtype=torch.float32, device=dev), 0)
    max_tau = max(max(tau), 1)
    fed_agg.launches = train_step.launches = 0
    got, none = ops.train_agg_step(disp, x, y, m, tau_t, w, LR, max_tau=max_tau)
    torch.cuda.synchronize()
    assert train_step.launches == 1
    assert fed_agg.launches == 1  # every leaf in one launch
    want, _ = ref.train_agg_step_ref(disp, x, y, m, tau_t, w, LR, max_tau=max_tau)
    assert none is None
    for g_layer, w_layer in zip(got, want):
        for name in w_layer:
            torch.testing.assert_close(g_layer[name], w_layer[name], **TOL)


def test_finished_learner_stays_bitwise_untouched(dev):
    """Weights one-hot on a learner with tau_k = 0 return its parameters."""
    layers = [100, 70, 33, 10]
    disp = _model(3, layers, seed=5, dev=dev)
    x, y, m = _batch(3, 70, layers, seed=6, dev=dev)
    tau = torch.tensor([3, 0, 2], dtype=torch.int32, device=dev)
    w = torch.tensor([0.0, 1.0, 0.0], device=dev)
    got, _ = ops.train_agg_step(disp, x, y, m, tau, w, LR, max_tau=3)
    for g_layer, d_layer in zip(got, disp):
        for name in d_layer:
            assert torch.equal(g_layer[name], d_layer[name][1])


def test_train_agg_step_kernel_refuses_what_it_does_not_take(dev):
    layers = [64, 32, 10]
    disp = _model(2, layers, seed=7, dev=dev)
    x, y, m = _batch(2, 16, layers, seed=8, dev=dev)
    tau = torch.tensor([1, 1], dtype=torch.int32, device=dev)
    w = torch.ones(2, device=dev) / 2
    with pytest.raises(ValueError, match="y must be"):
        train_step.train_agg_step_cuda(disp, x, y.long(), m, tau, w, LR, max_tau=1)
    with pytest.raises(ValueError, match="chain"):
        train_step.train_agg_step_cuda(disp[1:], x, y, m, tau, w, LR, max_tau=1)
    with pytest.raises(ValueError, match="classes"):
        wide = _model(2, [64, 100], seed=9, dev=dev)
        train_step.train_agg_step_cuda(wide, x, y, m, tau, w, LR, max_tau=1)
    with pytest.raises(ValueError, match="1 to 16 layers"):  # the kernel's layer tables
        deep = _model(2, [64] + [8] * 17, seed=10, dev=dev)
        train_step.train_agg_step_cuda(deep, x, y, m, tau, w, LR, max_tau=1)


def _kernel_launches(fn) -> list[str]:
    """The device kernels one call of ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():  # torch's note that one profiling cycle keeps its events
        warnings.filterwarnings("ignore", message=".*Profiler clears events", category=UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("form", ["cycle", "async"])
def test_train_agg_step_trains_in_one_kernel_launch_a_call(dev, form):
    """Every step of every learner runs in one launch of the persistent
    training kernel; the aggregation follows it (one all-leaf fed_agg
    launch, or accum_flush once a leaf)."""
    layers = [100, 70, 33, 10]
    k = 4
    disp = _model(k, layers, seed=21, dev=dev)
    x, y, m = _batch(k, 50, layers, seed=22, dev=dev)
    tau = torch.tensor([3, 1, 0, 2], dtype=torch.int32, device=dev)
    w = torch.softmax(torch.arange(k, dtype=torch.float32, device=dev), 0)
    kw = {"max_tau": 3}
    if form == "async":
        server = mlp.init(23, layers, device=dev)
        acc = [{n: 0.1 * torch.ones_like(v) for n, v in layer.items()} for layer in server]
        kw.update(server=server, acc=acc, keep=0.5, flush=1.0)
    ops.train_agg_step(disp, x, y, m, tau, w, LR, **kw)  # builds and loads the kernels
    names = _kernel_launches(lambda: ops.train_agg_step(disp, x, y, m, tau, w, LR, **kw))
    count = lambda key: sum(key in n for n in names)
    assert count("train_steps_kernel") == 1, names
    leaves = 2 * (len(layers) - 1)
    assert (count("fed_agg_kernel"), count("accum_flush_kernel")) == (
        (1, 0) if form == "cycle" else (0, leaves)), names


# async form: (keep, flush) of an accumulate-only step, a buffered flush and
# a fedasync mix
FLUSH_CASES = {"accumulate": (1.0, 0.0), "buffered_flush": (0.0, 1.0),
               "fedasync_mix": (0.4, 1.0)}


@pytest.mark.parametrize("case", sorted(FLUSH_CASES))
@pytest.mark.parametrize("shape", [(1, 1), (3, 257), (10, 784, 300), (5, 60, 10)])
def test_accum_flush_kernel_matches_plain(dev, shape, case):
    keep, flush = FLUSH_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    locals_ = torch.randn(shape, generator=gen, device=dev)
    acc, server = (torch.randn(shape[1:], generator=gen, device=dev) for _ in range(2))
    w = torch.softmax(torch.randn(shape[0], generator=gen, device=dev), 0) * 0.6
    accum_flush.launches = 0
    got = accum_flush.accum_flush_cuda(locals_, w, acc, server, keep, flush)
    torch.cuda.synchronize()
    assert accum_flush.launches == 1
    want = ref.accum_flush_ref(locals_, w, acc, server, keep, flush)
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=1e-6, atol=1e-6)
    if flush:
        assert bool((got[1] == 0).all())
    else:
        assert torch.equal(got[0], server)


def test_accum_flush_kernel_refuses_what_it_does_not_take(dev):
    locals_ = torch.randn(3, 8, device=dev)
    acc, server, w = torch.zeros(8, device=dev), torch.zeros(8, device=dev), torch.ones(3, device=dev)
    with pytest.raises(ValueError, match="float32"):
        accum_flush.accum_flush_cuda(locals_.double(), w, acc, server, 1.0, 0.0)
    with pytest.raises(ValueError, match="learner axis"):
        accum_flush.accum_flush_cuda(locals_, w[:2], acc, server, 1.0, 0.0)
    with pytest.raises(ValueError, match="leaf"):
        accum_flush.accum_flush_cuda(locals_, w, acc[:4], server, 1.0, 0.0)


@pytest.mark.parametrize("case", sorted(FLUSH_CASES))
def test_async_train_agg_step_kernel_matches_plain(dev, case):
    """One group step of the async form: the fedasync shape (one learner
    trains, the others have tau 0 and an all-zero mask) and a buffered one."""
    keep, flush = FLUSH_CASES[case]
    layers = [100, 70, 33, 10]
    k = 4
    disp = _model(k, layers, seed=11, dev=dev)
    server = mlp.init(12, layers, device=dev)
    acc = [{n: 0.1 * torch.ones_like(v) for n, v in layer.items()} for layer in server]
    x, y, m = _batch(k, 50, layers, seed=13, dev=dev)
    if case == "fedasync_mix":
        tau = [3, 0, 0, 0]
        m[1:] = 0.0
        w = torch.tensor([0.6, 0.0, 0.0, 0.0], device=dev)
    else:
        tau = [3, 1, 0, 2]
        w = torch.softmax(torch.arange(k, dtype=torch.float32, device=dev), 0)
    tau_t = torch.tensor(tau, dtype=torch.int32, device=dev)
    kw = dict(max_tau=max(tau), server=server, acc=acc, keep=keep, flush=flush)
    fed_agg.launches = train_step.launches = accum_flush.launches = 0
    got = ops.train_agg_step(disp, x, y, m, tau_t, w, LR, **kw)
    torch.cuda.synchronize()
    assert (train_step.launches, fed_agg.launches) == (1, 0)
    assert accum_flush.launches == 2 * (len(layers) - 1)
    want = ref.train_agg_step_ref(disp, x, y, m, tau_t, w, LR, **kw)
    for got_tree, want_tree in zip(got, want):
        for g_layer, w_layer in zip(got_tree, want_tree):
            for name in w_layer:
                torch.testing.assert_close(g_layer[name], w_layer[name], **TOL)


WATERFILL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _waterfill_args(b, k, dtype, dev, seed):
    """A (B, K) residual problem with padded slots (lo = hi = 0, c2 = c1 = 1,
    c0 = 0) in the last column and in a ragged tail of rows, and tau* = 0
    in the first fleet."""
    rng = np.random.default_rng(seed)
    c2 = rng.uniform(1e-4, 1e-2, (b, k))
    c1 = rng.uniform(1e-5, 1e-3, (b, k))
    c0 = rng.uniform(0.05, 1.0, (b, k))
    lo = np.full((b, k), 10.0)
    hi = rng.uniform(100.0, 2000.0, (b, k))
    pad = np.zeros((b, k), bool)
    pad[:, -1] = k > 1
    pad[b // 2:, k // 2:] = k > 2
    c2[pad], c1[pad], c0[pad], lo[pad], hi[pad] = 1.0, 1.0, 0.0, 0.0, 0.0
    tau = rng.uniform(0.0, 60.0, b)
    tau[0] = 0.0
    T = rng.uniform(2.0, 30.0, b)
    total = rng.uniform(10.0, 5000.0, b)
    return [torch.tensor(a, dtype=dtype, device=dev)
            for a in (tau, c2, c1, c0, T, lo, hi, total)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", [3, 10, 37])
@pytest.mark.parametrize("b", [1, 5, 1000])
def test_waterfill_kernel_matches_plain(dev, b, k, dtype):
    args = _waterfill_args(b, k, dtype, dev, seed=b * 7 + k)
    waterfill.launches = 0
    got = ops.waterfill_residual(*args)
    torch.cuda.synchronize()
    assert waterfill.launches == 1
    assert got.dtype == dtype and got.shape == (b,)
    want = ref.waterfill_residual_ref(*args)
    bound = WATERFILL_TOL[dtype] * torch.clamp_min(args[-1].abs(), 1.0)
    assert bool(((got - want).abs() <= bound).all())
    # a fleet of padded slots only absorbs nothing
    only_pad = [a.clone() for a in args]
    only_pad[5].zero_()
    only_pad[6].zero_()
    torch.testing.assert_close(ops.waterfill_residual(*only_pad), -only_pad[-1],
                               rtol=0, atol=0)


def test_waterfill_kernel_refuses_what_it_does_not_take(dev):
    args = _waterfill_args(4, 3, torch.float64, dev, seed=0)
    with pytest.raises(ValueError, match="float64 or float32"):
        waterfill.waterfill_residual_cuda(*[a.half() for a in args])
    with pytest.raises(ValueError, match="c1 must be"):
        waterfill.waterfill_residual_cuda(args[0], args[1], args[2].float(), *args[3:])
    with pytest.raises(ValueError, match="contiguous"):
        waterfill.waterfill_residual_cuda(args[0], args[1].t().contiguous().t(), *args[2:])
    with pytest.raises(ValueError, match="total must be"):
        waterfill.waterfill_residual_cuda(*args[:-1], args[-1][:3])


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_solve_kkt_batched_on_the_card_gives_the_cpu_rows(dev, x64):
    from repro_torch.core import CapacityDrift
    from repro_torch.fed.simulation import build_problem

    prob = build_problem(8, 15.0, seed=0)
    c2, c1, c0 = CapacityDrift(seed=0).coefficient_path(prob.time_model, 257)
    b = c2.shape[0]
    bp = solver_batched.BatchedProblems(
        c2, c1, c0, np.full(b, prob.T), np.full(b, prob.total_samples, np.int64),
        np.full(c2.shape, float(prob.d_lower)), np.full(c2.shape, float(prob.d_upper)),
        np.ones(c2.shape, bool))
    waterfill.launches = 0
    card = solver_batched.solve_kkt_batched(bp, x64=x64, device=dev)
    assert waterfill.launches == 1 + 1 + card.rounds["grow"] + card.rounds["bisection"]
    cpu = solver_batched.solve_kkt_batched(bp, x64=x64, device="cpu")
    for name in ("tau", "d", "feasible", "tau_star", "relaxed_d"):
        np.testing.assert_array_equal(getattr(card, name), getattr(cpu, name))
    assert card.rounds == cpu.rounds


def _energy_args(b, k, dtype, dev, seed):
    """``_waterfill_args`` with the four energy rows (padded slots with
    zero coefficients and an infinite budget), spliced in as the kernel
    takes them: tau*, c2, c1, c0, T, e2, e1, e0, eb, lo, hi, total."""
    tau, c2, c1, c0, T, lo, hi, total = _waterfill_args(b, k, dtype, dev, seed)
    rng = np.random.default_rng(seed + 1)
    e2 = torch.tensor(rng.uniform(1e-5, 1e-3, (b, k)), dtype=dtype, device=dev)
    e1 = torch.tensor(rng.uniform(1e-4, 1e-2, (b, k)), dtype=dtype, device=dev)
    e0 = torch.tensor(rng.uniform(0.05, 0.5, (b, k)), dtype=dtype, device=dev)
    eb = torch.tensor(rng.uniform(0.5, 8.0, (b, k)), dtype=dtype, device=dev)
    pad = hi == 0
    e2[pad], e1[pad], e0[pad], eb[pad] = 0.0, 0.0, 0.0, torch.inf
    return [tau, c2, c1, c0, T, e2, e1, e0, eb, lo, hi, total]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", [3, 10, 37])
@pytest.mark.parametrize("b", [1, 5, 1000])
def test_waterfill_energy_kernel_matches_plain(dev, b, k, dtype):
    args = _energy_args(b, k, dtype, dev, seed=b * 11 + k)
    waterfill.energy_launches = waterfill.launches = 0
    got = ops.waterfill_energy_residual(*args)
    torch.cuda.synchronize()
    assert waterfill.energy_launches == 1 and waterfill.launches == 0
    assert got.dtype == dtype and got.shape == (b,)
    want = ref.waterfill_energy_residual_ref(*args)
    bound = WATERFILL_TOL[dtype] * torch.clamp_min(args[-1].abs(), 1.0)
    assert bool(((got - want).abs() <= bound).all())
    # eb = +inf with zero energy coefficients: the time-only kernel's bits
    free = [a.clone() for a in args]
    for i in (5, 6, 7):
        free[i].zero_()
    free[8].fill_(torch.inf)
    assert torch.equal(ops.waterfill_energy_residual(*free),
                       ops.waterfill_residual(*free[:5], *free[9:]))
    # e2 = e1 = 0 with eb = e0: 0 / 0 in a few fleets, NaN where the plain version has it
    nan = [a.clone() for a in args]
    rows = torch.arange(b, device=dev) % 3 == 0
    nan[5][rows, 0] = 0.0
    nan[6][rows, 0] = 0.0
    nan[8][rows, 0] = nan[7][rows, 0]
    got = ops.waterfill_energy_residual(*nan)
    want = ref.waterfill_energy_residual_ref(*nan)
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(got).any())


def test_waterfill_energy_kernel_refuses_what_it_does_not_take(dev):
    args = _energy_args(4, 3, torch.float64, dev, seed=0)
    with pytest.raises(ValueError, match="float64 or float32"):
        waterfill.waterfill_energy_residual_cuda(*[a.half() for a in args])
    with pytest.raises(ValueError, match="eb must be"):
        waterfill.waterfill_energy_residual_cuda(*args[:8], args[8].float(), *args[9:])
    with pytest.raises(ValueError, match="contiguous"):
        waterfill.waterfill_energy_residual_cuda(*args[:5], args[5].t().contiguous().t(),
                                                 *args[6:])
    with pytest.raises(ValueError, match="total must be"):
        waterfill.waterfill_energy_residual_cuda(*args[:-1], args[-1][:3])
    with pytest.raises(ValueError, match="e1 must be"):
        waterfill.waterfill_energy_residual_cuda(*args[:6], args[6].cpu(), *args[7:])


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_solve_energy_batched_on_the_card_gives_the_cpu_rows(dev, x64):
    from repro_torch.core import CapacityDrift, solve_kkt_sai
    from repro_torch.fed.simulation import build_energy_problem

    prob = build_energy_problem(8, 15.0, seed=0)
    blind = solve_kkt_sai(prob)
    eb = 0.75 * float(np.median(prob.energy.cycle_energy(blind.tau, blind.d)))
    c2, c1, c0 = CapacityDrift(seed=0).coefficient_path(prob.time_model, 257)
    b = c2.shape[0]
    e2, e1, e0, ebr = (np.broadcast_to(r, c2.shape).copy() for r in prob.energy.rows(eb))
    bp = solver_batched.BatchedProblems(
        c2, c1, c0, np.full(b, prob.T), np.full(b, prob.total_samples, np.int64),
        np.full(c2.shape, float(prob.d_lower)), np.full(c2.shape, float(prob.d_upper)),
        np.ones(c2.shape, bool), e2, e1, e0, ebr)
    waterfill.energy_launches = waterfill.launches = 0
    card = solver_batched.solve_energy_batched(bp, x64=x64, device=dev)
    assert waterfill.energy_launches == 2 + card.rounds["grow"] + card.rounds["bisection"]
    assert waterfill.launches == 0
    cpu = solver_batched.solve_energy_batched(bp, x64=x64, device="cpu")
    for name in ("tau", "d", "feasible", "tau_star", "relaxed_d"):
        np.testing.assert_array_equal(getattr(card, name), getattr(cpu, name))
    assert card.rounds == cpu.rounds
    spent = np.where(card.d > 0, e2 * card.tau * card.d + e1 * card.d + e0, 0.0)
    assert (spent <= ebr * (1 + 1e-9)).all()


def test_budgeted_pgd_on_the_card_goes_through_the_energy_kernel(dev):
    """Budgeted ``pgd``: one energy water-filling a re-solve on the card.
    Over 30 steps the policy gives the CPU's rows; the full 600-step solves
    (the re-solve and the per-problem ``solve_pgd_jax``) are chaotic, so
    they are held to the sample sum and the budget."""
    import dataclasses

    from repro_torch.core import solve_kkt_sai
    from repro_torch.fed.orchestrator import _solver, solve_policy_row
    from repro_torch.fed.simulation import build_energy_problem

    free = build_energy_problem(4, 15.0, total_samples=1200, seed=0)
    blind = solve_kkt_sai(free)
    eb = 0.7 * float(np.median(free.energy.cycle_energy(blind.tau, blind.d)))
    prob = dataclasses.replace(free, e_budget=eb)
    bp = solver_batched.BatchedProblems.from_problems([prob, free])
    rows = (bp.c2, bp.c1, bp.c0, bp.T, bp.total, bp.d_lo, bp.d_hi, bp.valid)
    policy = solver_batched.batched_policy("pgd", pgd_steps=30)
    out = []
    for where in (dev, torch.device("cpu")):
        t = lambda x: torch.as_tensor(np.asarray(x), device=where)
        waterfill.energy_launches = waterfill.launches = 0
        out.append([o.cpu().numpy() for o in policy(
            *map(t, rows), tuple(map(t, bp.energy_rows())))])
        assert waterfill.energy_launches == int(where.type == "cuda")
        assert waterfill.launches == 0
    for g, w in zip(*out):
        np.testing.assert_array_equal(g, w)

    tm = prob.time_model
    waterfill.energy_launches = waterfill.launches = 0
    tau, d = solve_policy_row("pgd", tm.c2, tm.c1, tm.c0, prob, label="x", device=dev)
    assert (waterfill.energy_launches, waterfill.launches) == (1, 0)
    one = _solver("pgd", dev)(prob)
    assert one.method == "pgd_energy_sai"
    for t_, d_ in ((tau, d), (one.tau, one.d)):
        assert d_.sum() == prob.total_samples
        assert (prob.energy.cycle_energy(t_, d_) <= eb * (1 + 1e-9)).all()


# b, sq, skv, heads, kv heads, d, causal, window
FLASH_CASES = {
    "llama_gqa3_causal": (2, 256, 256, 6, 2, 128, True, None),
    "ragged_causal": (2, 100, 100, 4, 2, 64, True, None),
    "ragged_1000": (1, 1000, 1000, 4, 1, 128, True, None),
    "danube_window": (1, 300, 300, 4, 1, 80, True, 64),
    "window_tail": (2, 200, 200, 2, 2, 64, True, 16),
    "mha_noncausal": (1, 128, 128, 4, 4, 80, False, None),
    "cross_sq_lt_skv": (2, 70, 130, 4, 2, 128, False, None),
    "cross_sq_gt_skv": (1, 150, 40, 8, 2, 64, False, None),
    "one_row": (1, 1, 1, 2, 1, 128, True, None),
    "one_row_long_kv": (2, 1, 500, 4, 4, 80, False, None),
    "gqa3_d64_past_a_block": (1, 129, 129, 3, 1, 64, True, None),
    "causal_skv_gt_sq": (2, 70, 300, 6, 2, 80, True, None),
    "window_narrower_than_a_tile": (1, 260, 260, 8, 2, 128, True, 5),
    "fully_masked_rows": (2, 300, 100, 4, 1, 64, True, 8),
}
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _qkv(b, sq, skv, h, kvh, d, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape) * 0.5, dtype=torch.float32,
                         device=dev).to(dtype)
            for shape in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(dev, case, dtype):
    b, sq, skv, h, kvh, d, causal, window = FLASH_CASES[case]
    q, k, v = _qkv(b, sq, skv, h, kvh, d, dtype, seed=sq + skv + d, dev=dev)
    flash_attention.launches = 0
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    assert got.dtype == dtype and got.shape == q.shape
    # the dense oracle's softmax of a row with no allowed key is NaN; the
    # chunked scan (the CPU's path) gives 0 there, as the kernels do
    plain = chunked_attention if case == "fully_masked_rows" else ref.flash_attention_ref
    want = plain(q, k, v, causal=causal, window=window).float()
    err = (got.float() - want).abs().max().item()
    assert err <= FLASH_TOL[dtype] * max(1.0, want.abs().max().item()), err


def _bf16_step(scale: float) -> float:
    """The gap between neighbouring bf16 values at ``scale``."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_bf16_kernel_is_the_f32_kernel_within_a_bf16_step(dev, case):
    b, sq, skv, h, kvh, d, causal, window = FLASH_CASES[case]
    q, k, v = _qkv(b, sq, skv, h, kvh, d, torch.bfloat16, seed=sq + skv + d, dev=dev)
    got = ops.flash_attention(q, k, v, causal=causal, window=window).float()
    f32 = ops.flash_attention(q.float(), k.float(), v.float(), causal=causal,
                              window=window).to(torch.bfloat16).float()
    torch.cuda.synchronize()
    err = (got - f32).abs().max().item()
    assert err <= _bf16_step(f32.abs().max().item()), err
    if case == "fully_masked_rows":
        assert bool((got[:, 107:] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_repeats_itself_bitwise(dev, case, dtype):
    b, sq, skv, h, kvh, d, causal, window = FLASH_CASES[case]
    q, k, v = _qkv(b, sq, skv, h, kvh, d, dtype, seed=sq + skv + d, dev=dev)
    first = ops.flash_attention(q, k, v, causal=causal, window=window)
    second = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_flash_attention_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(1, 8, 8, 4, 2, 64, torch.float32, seed=0, dev=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention.flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_cuda(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                             v[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_cuda(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention.flash_attention_cuda(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="window"):
        flash_attention.flash_attention_cuda(q, k, v, window=0)


def test_dense_prefill_launches_the_kernel_once_a_layer(dev):
    """A 28-layer prefill at the reduced width: 28 launches, none in decode;
    prefill and decode logits match the CPU's run of the same weights."""
    cfg = dataclasses.replace(get_reduced("llama3.2-3b"), num_layers=28)
    card, cpu = Model(cfg, device=dev), Model(cfg, device="cpu")
    params = card.init(0)
    params_cpu = cpu.init(0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)))
    out = {}
    with torch.inference_mode():
        for name, m, p in (("card", card, params), ("cpu", cpu, params_cpu)):
            flash_attention.launches = 0
            logits, cache, _ = m.prefill(p, {"tokens": tokens.to(m.device)}, max_len=44)
            prefill_launches = flash_attention.launches
            tok = torch.argmax(logits[:, -1:], dim=-1)
            steps = []
            flash_attention.launches = 0
            for i in range(4):
                step, cache = m.decode(p, cache, tok, 40 + i)
                tok = torch.argmax(step[:, -1:], dim=-1)
                steps.append(step.cpu())
            out[name] = (logits.cpu(), steps, prefill_launches, flash_attention.launches)
    assert out["card"][2:] == (28, 0) and out["cpu"][2:] == (0, 0)
    for got, want in zip([out["card"][0], *out["card"][1]], [out["cpu"][0], *out["cpu"][1]]):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
    assert np.isfinite(tree_to_numpy(cache)["blocks"][0]["mixer"]["k"]).all()


# b, s, heads, hd, dtype, with s0
WKV_CASES = {
    "rwkv_head64": (2, 200, 4, 64, True),
    "ragged_no_state": (3, 37, 2, 64, False),
    "one_step": (4, 1, 3, 64, True),
    "head32": (2, 65, 3, 32, True),
    "head128": (1, 70, 2, 128, False),
    "empty_seq": (2, 0, 2, 64, True),
}
WKV_TOL = 1e-5


def _wkv_args(b, s, h, hd, dtype, with_state, seed, dev):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    r, k, v = (t(rng.standard_normal((b, s, h, hd)) * 0.5).to(dtype) for _ in range(3))
    w = t(np.exp(-np.exp(rng.standard_normal((b, s, h, hd)) - 1.0)))
    u = t(rng.standard_normal((h, hd)) * 0.1)
    s0 = t(rng.standard_normal((b, h, hd, hd)) * 0.1) if with_state else None
    return r, k, v, w, u, s0


def _wkv_close(got, want) -> None:
    err = (got - want).abs().max().item() if want.numel() else 0.0
    scale = want.abs().max().item() if want.numel() else 0.0
    assert err <= WKV_TOL * max(1.0, scale), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv6_kernel_matches_plain(dev, case, dtype):
    b, s, h, hd, with_state = WKV_CASES[case]
    args = _wkv_args(b, s, h, hd, dtype, with_state, seed=s + hd, dev=dev)
    wkv6.launches = 0
    y, s_last = ops.wkv6(*args)
    torch.cuda.synchronize()
    assert wkv6.launches == 1
    assert y.dtype == s_last.dtype == torch.float32
    assert y.shape == (b, s, h, hd) and s_last.shape == (b, h, hd, hd)
    want_y, want_s = ref.wkv6_ref(*args)
    _wkv_close(y, want_y)
    _wkv_close(s_last, want_s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wkv6_kernel_updates_the_state_in_place(dev, dtype):
    """The decode form: S = 1, s_last written over s0 (a slice of a stacked
    cache), as ``models.rwkv6.apply`` calls it; the slice's neighbours stay."""
    r, k, v, w, u, s0 = _wkv_args(4, 1, 64, 64, dtype, True, seed=7, dev=dev)
    stacked = torch.stack([s0 + 1.0, s0, s0 - 1.0])
    before = stacked.clone()
    want_y, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
    y, s_last = wkv6.wkv6_cuda(r, k, v, w, u, stacked[1], out_state=stacked[1])
    torch.cuda.synchronize()
    assert s_last.data_ptr() == stacked[1].data_ptr()
    _wkv_close(y, want_y)
    _wkv_close(stacked[1], want_s)
    assert torch.equal(stacked[0], before[0]) and torch.equal(stacked[2], before[2])


def test_wkv6_kernel_refuses_what_it_does_not_take(dev):
    r, k, v, w, u, s0 = _wkv_args(2, 5, 2, 64, torch.float32, True, seed=0, dev=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        wkv6.wkv6_cuda(r.double(), k.double(), v.double(), w, u, s0)
    with pytest.raises(ValueError, match="one dtype"):
        wkv6.wkv6_cuda(r, k.bfloat16(), v, w, u, s0)
    with pytest.raises(ValueError, match="w must be"):
        wkv6.wkv6_cuda(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="head dim"):
        wkv6.wkv6_cuda(*(t[..., :48].contiguous() for t in (r, k, v, w)), u[:, :48], None)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6.wkv6_cuda(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u, s0)
    with pytest.raises(ValueError, match="u must be"):
        wkv6.wkv6_cuda(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="s0 must be"):
        wkv6.wkv6_cuda(r, k, v, w, u, s0[:1])
    with pytest.raises(ValueError, match="one device"):
        wkv6.wkv6_cuda(r, k, v, w.cpu(), u, s0)
    shifted = torch.empty(s0.numel() + 1, device=dev)[1:].view(s0.shape)
    with pytest.raises(ValueError, match="aligned"):
        wkv6.wkv6_cuda(r, k, v, w, u, s0, out_state=shifted)


def test_wkv6_kernel_counts_no_launch_for_an_empty_batch(dev):
    args = _wkv_args(0, 5, 2, 64, torch.float32, True, seed=0, dev=dev)
    wkv6.launches = 0
    y, s_last = wkv6.wkv6_cuda(*args)
    assert wkv6.launches == 0
    assert y.shape == (0, 5, 2, 64) and s_last.shape == (0, 2, 64, 64)


def test_rwkv6_prefill_and_decode_launch_the_kernel_once_a_layer(dev):
    """A 4-layer RWKV-6 prefill at the reduced width: 4 launches, and 4 a
    decode step; prefill and decode logits match the CPU's run of the same
    weights."""
    cfg = dataclasses.replace(get_reduced("rwkv6-7b"), num_layers=4)
    card, cpu = Model(cfg, device=dev), Model(cfg, device="cpu")
    params = card.init(0)
    params_cpu = cpu.init(0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)))
    out = {}
    with torch.inference_mode():
        for name, m, p in (("card", card, params), ("cpu", cpu, params_cpu)):
            wkv6.launches = 0
            logits, cache, _ = m.prefill(p, {"tokens": tokens.to(m.device)}, max_len=44)
            prefill_launches = wkv6.launches
            tok = torch.argmax(logits[:, -1:], dim=-1)
            steps = []
            wkv6.launches = 0
            for i in range(4):
                step, cache = m.decode(p, cache, tok, 40 + i)
                tok = torch.argmax(step[:, -1:], dim=-1)
                steps.append(step.cpu())
            out[name] = (logits.cpu(), steps, prefill_launches, wkv6.launches,
                         tree_to_numpy(cache))
    assert out["card"][2:4] == (4, 16) and out["cpu"][2:4] == (0, 0)
    for got, want in zip([out["card"][0], *out["card"][1]], [out["cpu"][0], *out["cpu"][1]]):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
    got, want = (out[name][4]["blocks"][0]["mixer"]["wkv"] for name in ("card", "cpu"))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# b, s, d, n, x dtype, with h0
MAMBA_CASES = {
    "jamba_like": (2, 100, 300, 16, torch.bfloat16, False),
    "ragged_state": (3, 37, 129, 16, torch.float32, True),
    "state8": (2, 50, 64, 8, torch.float32, True),
    "state8_bf16": (1, 33, 200, 8, torch.bfloat16, True),
    "one_step": (4, 1, 256, 16, torch.bfloat16, True),
    "empty_seq": (2, 0, 96, 16, torch.float32, True),
    "empty_seq_no_state": (2, 0, 96, 8, torch.float32, False),
}
MAMBA_TOL = 1e-5


def _mamba_args(b, s, d, n, xdtype, with_state, seed, dev):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    dt = t(np.log1p(np.exp(-4.6 + 2.0 * rng.standard_normal((b, s, d)))))
    x = t(rng.standard_normal((b, s, d))).to(xdtype)
    bm, cm = (t(rng.standard_normal((b, s, n))) for _ in range(2))
    a = t(-np.exp(np.log(np.arange(1, n + 1))[None, :] + 0.1 * rng.standard_normal((d, n))))
    h0 = t(rng.standard_normal((b, d, n))) if with_state else None
    return dt, x, bm, cm, a, h0


@pytest.mark.parametrize("case", sorted(MAMBA_CASES))
def test_mamba_scan_kernel_matches_plain(dev, case):
    b, s, d, n, xdtype, with_state = MAMBA_CASES[case]
    args = _mamba_args(b, s, d, n, xdtype, with_state, seed=s + d, dev=dev)
    mamba_scan.launches = 0
    y, h_last = ops.mamba_scan(*args)
    torch.cuda.synchronize()
    assert mamba_scan.launches == 1
    assert y.dtype == h_last.dtype == torch.float32
    assert y.shape == (b, s, d) and h_last.shape == (b, d, n)
    want_y, want_h = ref.mamba_scan_ref(*args)
    _wkv_close(y, want_y)
    _wkv_close(h_last, want_h)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mamba_scan_kernel_updates_the_state_in_place(dev, xdtype):
    """h_last written over h0, a slice of a stacked cache; the slice's
    neighbours stay."""
    dt, x, bm, cm, a, h0 = _mamba_args(2, 20, 160, 16, xdtype, True, seed=11, dev=dev)
    stacked = torch.stack([h0 + 1.0, h0, h0 - 1.0])
    before = stacked.clone()
    want_y, want_h = ref.mamba_scan_ref(dt, x, bm, cm, a, h0)
    y, h_last = mamba_scan.mamba_scan_cuda(dt, x, bm, cm, a, stacked[1], out_state=stacked[1])
    torch.cuda.synchronize()
    assert h_last.data_ptr() == stacked[1].data_ptr()
    _wkv_close(y, want_y)
    _wkv_close(stacked[1], want_h)
    assert torch.equal(stacked[0], before[0]) and torch.equal(stacked[2], before[2])


def test_mamba_scan_kernel_refuses_what_it_does_not_take(dev):
    dt, x, bm, cm, a, h0 = _mamba_args(2, 5, 64, 16, torch.float32, True, seed=0, dev=dev)
    with pytest.raises(ValueError, match="x must be"):
        mamba_scan.mamba_scan_cuda(dt, x.double(), bm, cm, a, h0)
    with pytest.raises(ValueError, match="dt must be"):
        mamba_scan.mamba_scan_cuda(dt.bfloat16(), x, bm, cm, a, h0)
    with pytest.raises(ValueError, match="state dim"):
        mamba_scan.mamba_scan_cuda(dt, x, bm[..., :12].contiguous(), cm[..., :12].contiguous(),
                                   a[:, :12].contiguous(), None)
    with pytest.raises(ValueError, match="a must be"):
        mamba_scan.mamba_scan_cuda(dt, x, bm, cm, a[:1], h0)
    with pytest.raises(ValueError, match="h0 must be"):
        mamba_scan.mamba_scan_cuda(dt, x, bm, cm, a, h0[:1])
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan.mamba_scan_cuda(dt.transpose(1, 2).contiguous().transpose(1, 2), x, bm, cm,
                                   a, h0)
    with pytest.raises(ValueError, match="one device"):
        mamba_scan.mamba_scan_cuda(dt, x, bm.cpu(), cm, a, h0)
    shifted = torch.empty(h0.numel() + 1, device=dev)[1:].view(h0.shape)
    with pytest.raises(ValueError, match="aligned"):
        mamba_scan.mamba_scan_cuda(dt, x, bm, cm, a, h0, out_state=shifted)


def test_mamba_scan_kernel_counts_no_launch_for_an_empty_batch(dev):
    args = _mamba_args(0, 5, 64, 16, torch.float32, True, seed=0, dev=dev)
    mamba_scan.launches = 0
    y, h_last = mamba_scan.mamba_scan_cuda(*args)
    assert mamba_scan.launches == 0
    assert y.shape == (0, 5, 64) and h_last.shape == (0, 64, 16)


def test_jamba_prefill_launches_the_scan_once_a_mamba_layer(dev):
    """An 8-layer Jamba (one period: 7 Mamba layers and attention at layer
    4, MoE every other layer) at the reduced width: 7 scan and 1 attention
    launches a prefill, none in decode; prefill and decode logits, the
    load-balance loss and the SSM states match the CPU's run of the same
    weights."""
    cfg = dataclasses.replace(get_reduced("jamba-v0.1-52b"), num_layers=8, attn_every=8)
    card, cpu = Model(cfg, device=dev), Model(cfg, device="cpu")
    params = card.init(0)
    params_cpu = cpu.init(0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)))
    out = {}
    with torch.inference_mode():
        for name, m, p in (("card", card, params), ("cpu", cpu, params_cpu)):
            mamba_scan.launches = flash_attention.launches = 0
            logits, cache, aux = m.prefill(p, {"tokens": tokens.to(m.device)}, max_len=44)
            prefill_launches = (mamba_scan.launches, flash_attention.launches)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            steps = []
            mamba_scan.launches = flash_attention.launches = 0
            for i in range(4):
                step, cache = m.decode(p, cache, tok, 40 + i)
                tok = torch.argmax(step[:, -1:], dim=-1)
                steps.append(step.cpu())
            out[name] = (logits.cpu(), steps, prefill_launches,
                         (mamba_scan.launches, flash_attention.launches), float(aux),
                         tree_to_numpy(cache))
    assert out["card"][2:4] == ((7, 1), (0, 0)) and out["cpu"][2:4] == ((0, 0), (0, 0))
    for got, want in zip([out["card"][0], *out["card"][1]], [out["cpu"][0], *out["cpu"][1]]):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
    assert abs(out["card"][4] - out["cpu"][4]) <= 1e-4 * out["cpu"][4]
    got, want = (out[name][5]["blocks"][0]["mixer"]["ssm"] for name in ("card", "cpu"))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# m, d, f, dtype
SWIGLU_CASES = {
    "ragged_f32": (100, 96, 300, torch.float32),
    "ragged_bf16": (70, 128, 520, torch.bfloat16),
    "one_row": (1, 64, 256, torch.float32),
    "many_splits_bf16": (64, 64, 1100, torch.bfloat16),
    "odd_d": (33, 70, 130, torch.float32),
    # strides TMA takes as they lie: no packing pass for bf16
    "tma_strides_bf16": (256, 512, 1024, torch.bfloat16),
    "tma_strides_f32": (256, 512, 1024, torch.float32),
}
SWIGLU_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-8}


def _swiglu_args(m, d, f, dtype, seed, dev):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev).to(dtype)

    return (t(rng.standard_normal((m, d))), t(rng.standard_normal((d, f)) / np.sqrt(d)),
            t(rng.standard_normal((d, f)) / np.sqrt(d)),
            t(rng.standard_normal((f, d)) / np.sqrt(f)))


@pytest.mark.parametrize("case", sorted(SWIGLU_CASES))
def test_swiglu_kernel_matches_plain(dev, case):
    m, d, f, dtype = SWIGLU_CASES[case]
    args = _swiglu_args(m, d, f, dtype, seed=m + f, dev=dev)
    swiglu.launches = 0
    got = ops.swiglu_fused(*args)
    torch.cuda.synchronize()
    assert swiglu.launches == 1
    assert got.dtype == dtype and got.shape == (m, d)
    want = ref.swiglu_ref(*(a.float() for a in args))
    err = (got.float() - want).abs().max().item()
    assert err <= SWIGLU_TOL[dtype] * max(1.0, want.abs().max().item()), err


def test_swiglu_kernel_takes_leading_axes(dev):
    x, wg, wu, wd = _swiglu_args(24, 64, 256, torch.bfloat16, seed=3, dev=dev)
    got = swiglu.swiglu_cuda(x.reshape(2, 3, 4, 64), wg, wu, wd)
    assert got.shape == (2, 3, 4, 64)
    assert torch.equal(got.reshape(24, 64), swiglu.swiglu_cuda(x, wg, wu, wd))


def test_swiglu_kernel_refuses_what_it_does_not_take(dev):
    x, wg, wu, wd = _swiglu_args(8, 64, 128, torch.float32, seed=0, dev=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        swiglu.swiglu_cuda(x.double(), wg, wu, wd)
    with pytest.raises(ValueError, match="dtype"):
        swiglu.swiglu_cuda(x, wg.bfloat16(), wu, wd)
    with pytest.raises(ValueError, match="w_down must be"):
        swiglu.swiglu_cuda(x, wg, wu, wd[:3])
    with pytest.raises(ValueError, match="contiguous"):
        swiglu.swiglu_cuda(x, wg.t().contiguous().t(), wu, wd)
    with pytest.raises(ValueError, match="one device"):
        swiglu.swiglu_cuda(x, wg, wu.cpu(), wd)


def test_swiglu_kernel_counts_no_launch_for_no_rows(dev):
    x, wg, wu, wd = _swiglu_args(0, 64, 128, torch.float32, seed=0, dev=dev)
    swiglu.launches = 0
    got = swiglu.swiglu_cuda(x, wg, wu, wd)
    assert swiglu.launches == 0 and got.shape == (0, 64)
