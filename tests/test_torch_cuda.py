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
every product rounded, so it is held to 1e-6; one launch takes every leaf
of a group step, and each leaf is bitwise the same through it as alone.

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

Attention's backward kernel (``csrc/flash_attention_bwd.cu``) runs under
``ops.flash_attention`` whenever a gradient is needed, once a call after
one forward launch; its dq, dk, dv are held to the dense plain backward
``ref.flash_attention_bwd_ref`` on every ``FLASH_CASES`` shape, 1e-4 of a
gradient's scale in float32 and 1e-2 in bf16 (bf16 on the tensor-core
kernels, float32 on the CUDA-core ones, ``flash_attention.last_bwd_kernel``
names which), and repeat their bits (no atomics), also at the bf16
training shape cut to B 1; the forward's log-sum-exp is held to the dense
scores'. One
``launch.steps.build_train`` step of the reduced dense, MoE and vlm
configs (head dim 64), remat off and on, runs on the card and on the CPU
from the same weights: the loss, the gradient norm and every clipped
gradient leaf agree, the card's parameters are the CPU's AdamW step from
the card's gradients, and the attention launches are the counts remat
implies; the same for the reduced RWKV-6 and Jamba configs, whose WKV-6
and Mamba-scan kernels run their forward once a layer (twice under remat)
and their backward once.

The WKV-6 and Mamba-scan backward kernels (``csrc/wkv6_bwd.cu``,
``csrc/mamba_scan_bwd.cu``) are held to both plain versions, the
written-out ``ref.wkv6_bwd_ref``/``ref.mamba_scan_bwd_ref`` and autograd of
the step loops, on the same inputs and cotangents: a gradient returned in
float32 to 1e-4 of its scale (at least 1e-3 max |dy|), one returned in
bf16 to one bf16 step; over lengths that cross several checkpoints and
end ragged, with and without a starting state and a final-state
cotangent, decays of 0 and near 1, underflowing decays. Their bits repeat
(no atomics); under a gradient ``ops`` runs each through its Function
(one forward and one backward launch), and refuses an ``out_state``.

The all-leaf ``fed_agg`` launch sums over k in order with every product
rounded, so each leaf is bitwise the in-order per-leaf sum, and the
single-leaf launch; a fused cycle aggregates every leaf in one launch.

The WKV-6 kernels are held to the step loop ``ref.wkv6_ref`` on the card:
the step kernel takes every product in float32 and the chunk kernel as
3xTF32 on the tensor cores, both from the same inputs, summing in other
orders; the output is float32 for bf16 inputs too, so y and s_last are
held to 1e-5 of max(1, max |plain|) in both dtypes. Lengths on both sides
of ``wkv6.CHUNKED_MIN_SEQ`` run each kernel (``wkv6.last_kernel`` names which),
with decays of 0 and within 1e-7 of 1; each kernel forced at any length
holds the same gate, and repeats its bits. The decode form and a 1000-step
prefill write the state over their own s0. A reduced-width 4-layer RWKV-6
prefill launches it once a layer, and decode once a layer a step, with
logits matching the CPU's.

The Mamba scan kernel is held to the step loop ``ref.mamba_scan_ref``: both
take every product in float32 (a bf16 x widened exactly) and sum over n in
other orders (the kernel with fused multiply-adds), and the kernel takes
its decays by ``ex2.approx``, so y and h_last are held to 1e-5 of max(1,
max |plain|): at decays within 1e-6 of 1 over 2048 steps, underflowing
decays, channels whose dt is 0 (their state kept bit for bit), N 4 to 32,
and widths that are no multiple of a CTA's channels or of 8. With decays
near 1 and a state of unit size over 2048 steps the float32 step loop
itself drifts past that gate from a float64 step loop, and the kernel is
held to a float64 step loop within 1e-4 of the scale on five seeds, a
limit set from the card's readings. Two launches give the same bits. The state may
be written over its own h0. A reduced-width 8-layer Jamba prefill
launches it once a Mamba layer (7) and decode never, with logits matching
the CPU's.

The fused SwiGLU kernel takes its three products in float32 from the
widened inputs (bf16 on the tensor cores with h in two bf16 pieces,
float32 as 3xTF32) and returns x's dtype; it is held to ``ref.swiglu_ref``
on the inputs widened to float32, summed in another order: 1e-5 of
max(1, max |plain|) for float32, one bf16 step (2^-8) for bf16 output.
The shapes include strides TMA takes as they lie and ones the kernel
first packs (d or f not a multiple of 8 in bf16).

The multi-tenant scheduler (``fed.multimodel``) at S = 3 on the spread
fleet, narrow width: ``run_events`` on the card gives the rows, the
split-weight log and the counters of the same run on the CPU, launches the
training and ``accum_flush`` kernels once a group and the water-filling
kernel once for each residual the CPU run evaluated; at S = 1 it gives
``AsyncFedEngine.run_events``'s rows and parameters on the card bitwise.

The fleet engine refuses on the card a loss the training kernel does not
take; over ``host_mesh()`` in a one-rank NCCL group it gives the engine
without a group its rows and models bit for bit. The attention kernel
takes Whisper's encoder (1500 frames, non-causal) and cross-attention
(queries against 1500 keys) shapes; Whisper at full width (2 + 2 layers)
and the reduced InternVL2 serve on the card as on the CPU, float32.

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


@pytest.mark.parametrize("groups,k", [(1, 5), (3, 4), (1250, 8), (7, 1)])
def test_grouped_fed_agg_is_each_group_alone_bitwise(dev, groups, k):
    """One grouped launch over G groups of K learners: each group's output is
    a one-group launch on its slice, bitwise, and close to the plain
    version; G = 1 gives the ungrouped leaves' shapes."""
    gen = torch.Generator(device=dev).manual_seed(groups + k)
    shapes = FED_AGG_LEAVES["paper_mlp"] if groups > 100 else FED_AGG_LEAVES["ragged"]
    leaves = [torch.randn((groups * k, *shape), generator=gen, device=dev)
              for shape in shapes]
    w = torch.rand(groups * k, generator=gen, device=dev)
    fed_agg.launches = 0
    got = fed_agg.fed_agg_leaves_cuda(leaves, w, groups=groups)
    torch.cuda.synchronize()
    assert fed_agg.launches == 1
    lead = (groups,) if groups > 1 else ()
    for gl, x, shape in zip(got, leaves, shapes):
        assert gl.shape == lead + shape
        torch.testing.assert_close(gl, ref.fed_agg_ref(x, w, groups=groups), rtol=1e-6,
                                   atol=1e-6)
        for g in range(0, groups, max(1, groups // 5)):
            one = fed_agg.fed_agg_cuda(x[g * k:(g + 1) * k].contiguous(), w[g * k:(g + 1) * k])
            assert torch.equal(gl[g] if groups > 1 else gl, one)
    with pytest.raises(ValueError, match="groups"):
        fed_agg.fed_agg_leaves_cuda(leaves, w, groups=groups * k + 1)


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


@pytest.mark.parametrize("groups", [1, 4])
def test_grouped_train_agg_step_matches_plain_and_one_call_a_group(dev, groups):
    """G fleets of K learners in one call, each fleet's learners starting
    from the fleet's model: one training launch and one grouped fed_agg
    launch; each fleet's aggregate is the bits of the fleet's call alone,
    and close to the plain version."""
    layers, k, d_cap = [100, 70, 33, 10], 3, 40
    n = groups * k
    starts = _model(groups, layers, seed=31, dev=dev)
    x, y, m = _batch(n, d_cap, layers, seed=32, dev=dev)
    tau = torch.tensor([(i * 5) % 4 for i in range(n)], dtype=torch.int32, device=dev)
    w = torch.rand(n, device=dev)
    fed_agg.launches = train_step.launches = 0
    got, _ = ops.train_agg_step(starts, x, y, m, tau, w, LR, max_tau=3, groups=groups)
    torch.cuda.synchronize()
    assert (train_step.launches, fed_agg.launches) == (1, 1)
    want, _ = ref.train_agg_step_ref(starts, x, y, m, tau, w, LR, max_tau=3, groups=groups)
    for g_layer, w_layer in zip(got, want):
        for name in w_layer:
            torch.testing.assert_close(g_layer[name], w_layer[name], **TOL)
    for g in range(groups):
        sl = slice(g * k, (g + 1) * k)
        one, _ = ops.train_agg_step([{n_: v[g:g + 1] for n_, v in layer.items()}
                                     for layer in starts], x[sl], y[sl], m[sl], tau[sl],
                                    w[sl], LR, max_tau=3)
        for g_layer, o_layer in zip(got, one):
            for name in o_layer:
                assert torch.equal(g_layer[name][g] if groups > 1 else g_layer[name],
                                   o_layer[name])


def test_ten_thousand_learners_train_as_ten_calls_of_a_thousand(dev):
    """Learners are independent: a launch of 10,000 learners (a fleet of
    fleets, d_cap 15, tau up to 44) gives each learner the bits of ten
    launches of 1,000. Trained parameters read back through weights
    one-hot on a learner a group."""
    from repro_torch.fed.fleet import build_fleet_problems
    from repro_torch.core import batched_policy

    layers = [16, 12, 10]
    bp = build_fleet_problems(1250, 8)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    tau, d, _ = batched_policy("kkt_sai")(
        f64(bp.c2), f64(bp.c1), f64(bp.c0), f64(bp.T),
        torch.as_tensor(bp.total, device=dev), f64(bp.d_lo), f64(bp.d_hi),
        torch.as_tensor(bp.valid, device=dev))
    tau, d = tau.reshape(-1).to(torch.int32), d.reshape(-1)
    n, d_cap, max_tau = tau.numel(), int(d.max()), int(tau.max())
    disp = _model(1, layers, seed=41, dev=dev)
    x, y, _ = _batch(n, d_cap, layers, seed=42, dev=dev)
    m = (torch.arange(d_cap, device=dev)[None] < d[:, None]).to(torch.float32)
    # one learner a group of 8 read back: weights one-hot on learner g*8 + 3
    pick = torch.zeros(n, device=dev)
    pick[3::8] = 1.0
    start = [{k_: v.expand((n,) + v.shape[1:]) for k_, v in layer.items()} for layer in disp]
    whole, _ = ops.train_agg_step(start, x, y, m, tau, pick, LR, max_tau=max_tau,
                                  groups=n // 8)
    for c in range(10):
        sl = slice(c * 1000, (c + 1) * 1000)
        part, _ = ops.train_agg_step([{k_: v[sl] for k_, v in layer.items()} for layer in start],
                                     x[sl], y[sl], m[sl], tau[sl], pick[sl], LR,
                                     max_tau=max_tau, groups=125)
        for w_layer, p_layer in zip(whole, part):
            for name in p_layer:
                assert torch.equal(w_layer[name][c * 125:(c + 1) * 125], p_layer[name])


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
    launch, or one all-leaf accum_flush launch)."""
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
    assert (count("fed_agg_kernel"), count("accum_flush_kernel")) == (
        (1, 0) if form == "cycle" else (0, 1)), names


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


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("case", sorted(FLUSH_CASES))
@pytest.mark.parametrize("leaves", sorted(FED_AGG_LEAVES))
def test_accum_flush_all_leaf_launch_is_each_leaf_alone_bitwise(dev, leaves, case, k):
    """Every leaf through one launch gives the bits of that leaf through the
    launch alone (a leaf of a size that is not a multiple of 4 takes single
    floats, the others float4s), within 1e-6 of the plain version."""
    keep, flush = FLUSH_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(k + len(leaves))
    shapes = FED_AGG_LEAVES[leaves]
    locals_ = [torch.randn((k, *s), generator=gen, device=dev) for s in shapes]
    accs = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    servers = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    w = torch.softmax(torch.randn(k, generator=gen, device=dev), 0) * 0.6
    accum_flush.launches = 0
    got_s, got_a = accum_flush.accum_flush_leaves_cuda(locals_, accs, servers, w, keep, flush)
    torch.cuda.synchronize()
    assert accum_flush.launches == 1
    for x, acc, server, gs, ga in zip(locals_, accs, servers, got_s, got_a):
        assert gs.shape == ga.shape == acc.shape
        assert gs.data_ptr() % 16 == 0 and ga.data_ptr() % 16 == 0
        alone = accum_flush.accum_flush_cuda(x, w, acc, server, keep, flush)
        assert torch.equal(gs, alone[0]) and torch.equal(ga, alone[1])
        want = ref.accum_flush_ref(x, w, acc, server, keep, flush)
        for g, p in zip((gs, ga), want):
            torch.testing.assert_close(g, p, rtol=1e-6, atol=1e-6)


def test_accum_flush_all_leaf_launch_refuses_what_it_does_not_take(dev):
    w = torch.ones(2, device=dev) / 2
    leaf, acc = torch.randn(2, 3, device=dev), torch.randn(3, device=dev)
    many = accum_flush.MAX_LEAVES + 1
    with pytest.raises(ValueError, match=f"1 to {accum_flush.MAX_LEAVES} leaves"):
        accum_flush.accum_flush_leaves_cuda([leaf] * many, [acc] * many, [acc] * many, w,
                                            1.0, 0.0)
    with pytest.raises(ValueError, match="learner axis"):
        accum_flush.accum_flush_leaves_cuda([leaf, torch.randn(3, 3, device=dev)],
                                            [acc, acc], [acc, acc], w, 1.0, 0.0)
    with pytest.raises(ValueError, match="float32"):
        accum_flush.accum_flush_leaves_cuda([leaf, leaf.double()], [acc, acc], [acc, acc], w,
                                            1.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        accum_flush.accum_flush_leaves_cuda([leaf, torch.randn(3, 2, device=dev).t()],
                                            [acc, acc], [acc, acc], w, 1.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        accum_flush.accum_flush_leaves_cuda([leaf], [torch.randn(6, device=dev)[::2]], [acc],
                                            w, 1.0, 0.0)
    accum_flush.launches = 0
    got_s, got_a = accum_flush.accum_flush_leaves_cuda(
        [leaf] * accum_flush.MAX_LEAVES, [acc] * accum_flush.MAX_LEAVES,
        [acc] * accum_flush.MAX_LEAVES, w, 0.4, 1.0)
    torch.cuda.synchronize()
    assert accum_flush.launches == 1
    assert all(torch.equal(g, got_s[0]) for g in got_s)
    assert all(torch.equal(g, got_a[0]) for g in got_a)


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
    assert accum_flush.launches == 1
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
    # Whisper's encoder (1500 frames, the last key tile partial) and its
    # cross-attention (a prompt's queries against the frames)
    "whisper_encoder": (1, 1500, 1500, 12, 12, 64, False, None),
    "whisper_cross": (2, 64, 1500, 12, 12, 64, False, None),
    # both sides of the backward's tensor-core tiles (64 rows, 128 a CTA),
    # G = 8 heads on one query row, and d 80 causal past many tiles
    "tile_edge_127": (1, 127, 127, 4, 2, 128, True, None),
    "tile_edge_128": (2, 128, 128, 4, 2, 64, True, None),
    "tile_edge_129": (1, 129, 129, 6, 2, 80, True, None),
    "tile_edge_257": (1, 257, 257, 4, 1, 128, True, None),
    "tile_edge_cross_127_257": (1, 127, 257, 4, 2, 64, False, None),
    "tile_edge_cross_257_129": (1, 257, 129, 4, 4, 128, False, None),
    "gqa8_one_row": (2, 1, 257, 8, 1, 128, False, None),
    "d80_causal_1000": (1, 1000, 1000, 4, 2, 80, True, None),
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


# b, s, heads, hd, with s0, decays: below wkv6.CHUNKED_MIN_SEQ (48) the step
# kernel runs, from it on the chunk kernel; "zero" sets whole channels and
# single steps of others to w = 0, "one" channels to within 1e-7 of 1
WKV_CASES = {
    "rwkv_head64": (2, 200, 4, 64, True, ()),
    "ragged_no_state": (3, 37, 2, 64, False, ()),
    "one_step": (4, 1, 3, 64, True, ()),
    "head32": (2, 65, 3, 32, True, ()),
    "head128": (1, 70, 2, 128, False, ()),
    "empty_seq": (2, 0, 2, 64, True, ()),
    "below_threshold": (2, 47, 2, 64, True, ()),
    "at_threshold": (2, 48, 2, 64, False, ()),
    "ragged_1000": (2, 1000, 2, 64, True, ()),
    "head128_long": (1, 300, 2, 128, True, ()),
    "head32_prime": (2, 131, 2, 32, False, ()),
    "strong_decay": (2, 300, 3, 64, True, ("zero", "one")),
    "strong_decay_step": (2, 40, 3, 64, True, ("zero", "one")),
}
WKV_TOL = 1e-5


def _wkv_args(b, s, h, hd, dtype, with_state, seed, dev, decays=()):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    r, k, v = (t(rng.standard_normal((b, s, h, hd)) * 0.5).to(dtype) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, hd)) - 1.0))
    if "zero" in decays:
        w[..., ::7] = 0.0
        w[:, ::13, :, 1::5] = 0.0
    if "one" in decays:
        w[..., 3::7] = 1.0 - rng.uniform(0.0, 1e-7, w[..., 3::7].shape)
    u = t(rng.standard_normal((h, hd)) * 0.1)
    s0 = t(rng.standard_normal((b, h, hd, hd)) * 0.1) if with_state else None
    return r, k, v, t(w), u, s0


def _wkv_close(got, want) -> None:
    err = (got - want).abs().max().item() if want.numel() else 0.0
    scale = want.abs().max().item() if want.numel() else 0.0
    assert err <= WKV_TOL * max(1.0, scale), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv6_kernel_matches_plain(dev, case, dtype):
    b, s, h, hd, with_state, decays = WKV_CASES[case]
    args = _wkv_args(b, s, h, hd, dtype, with_state, seed=s + hd, dev=dev, decays=decays)
    wkv6.launches, wkv6.last_kernel = 0, None
    y, s_last = ops.wkv6(*args)
    torch.cuda.synchronize()
    assert wkv6.launches == 1
    assert wkv6.last_kernel == ("chunked" if s >= wkv6.CHUNKED_MIN_SEQ else "step")
    assert y.dtype == s_last.dtype == torch.float32
    assert y.shape == (b, s, h, hd) and s_last.shape == (b, h, hd, hd)
    want_y, want_s = ref.wkv6_ref(*args)
    _wkv_close(y, want_y)
    _wkv_close(s_last, want_s)


@pytest.mark.parametrize("s", [1, 1000], ids=["decode_step", "prefill_1000"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wkv6_kernel_updates_the_state_in_place(dev, dtype, s):
    """The decode form (S = 1, the step kernel) and a prefill given a cache
    (S = 1000, the chunk kernel): s_last written over s0 (a slice of a
    stacked cache), as ``models.rwkv6.apply`` calls it; the slice's
    neighbours stay."""
    r, k, v, w, u, s0 = _wkv_args(4, s, 64 if s == 1 else 8, 64, dtype, True, seed=7, dev=dev)
    stacked = torch.stack([s0 + 1.0, s0, s0 - 1.0])
    before = stacked.clone()
    want_y, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
    y, s_last = wkv6.wkv6_cuda(r, k, v, w, u, stacked[1], out_state=stacked[1])
    torch.cuda.synchronize()
    assert s_last.data_ptr() == stacked[1].data_ptr()
    _wkv_close(y, want_y)
    _wkv_close(stacked[1], want_s)
    assert torch.equal(stacked[0], before[0]) and torch.equal(stacked[2], before[2])


@pytest.mark.parametrize("s", [40, 200], ids=["step", "chunk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wkv6_kernels_repeat_their_bits(dev, dtype, s):
    """A repeat call gives the same bits (no atomics, a fixed order)."""
    args = _wkv_args(2, s, 4, 64, dtype, True, seed=s, dev=dev)
    first = ops.wkv6(*args)
    second = ops.wkv6(*args)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("s", [1, 40, 48, 64, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wkv6_both_kernels_match_plain_at_any_length(dev, dtype, s):
    """Each kernel forced on either side of the threshold: the same gate."""
    args = _wkv_args(2, s, 3, 64, dtype, True, seed=s + 1, dev=dev, decays=("zero",))
    want_y, want_s = ref.wkv6_ref(*args)
    for kernel in ("step", "chunked"):
        wkv6.launches = 0
        y, s_last = wkv6.wkv6_cuda(*args, kernel=kernel)
        torch.cuda.synchronize()
        assert wkv6.launches == 1
        _wkv_close(y, want_y)
        _wkv_close(s_last, want_s)
    with pytest.raises(ValueError, match="kernel must be"):
        wkv6.wkv6_cuda(*args, kernel="scan")


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


# b, s, d, n, x dtype, with h0[, decays (see _mamba_args)]
MAMBA_CASES = {
    "jamba_like": (2, 100, 300, 16, torch.bfloat16, False),
    "ragged_state": (3, 37, 129, 16, torch.float32, True),
    "state8": (2, 50, 64, 8, torch.float32, True),
    "state8_bf16": (1, 33, 200, 8, torch.bfloat16, True),
    "one_step": (4, 1, 256, 16, torch.bfloat16, True),
    "empty_seq": (2, 0, 96, 16, torch.float32, True),
    "empty_seq_no_state": (2, 0, 96, 8, torch.float32, False),
    "near_one_2048": (2, 2048, 192, 16, torch.bfloat16, False, "near1"),
    "underflow": (2, 300, 256, 16, torch.float32, True, "underflow"),
    "dt_zero": (2, 300, 256, 16, torch.bfloat16, True, "zero"),
    "state4": (3, 131, 100, 4, torch.bfloat16, True),
    "state32": (2, 257, 96, 32, torch.float32, True),
    "width_off_the_lanes": (2, 77, 131, 16, torch.bfloat16, True),
}
MAMBA_TOL = 1e-5
# decays near 1 with a state, against a float64 step loop (see
# test_mamba_scan_kernel_near_one_holds_the_float64_loop)
MAMBA_NEAR_ONE_TOL = 1e-4


def _mamba_args(b, s, d, n, xdtype, with_state, seed, dev, decays=""):
    """dt = softplus(-4.6 + 2 z), a near the S4D init -(n + 1); ``decays``:
    "near1" makes dt 1e-5..1e-4 and a -1e-3..-1e-2 (every decay within 1e-6
    of 1), "underflow" sets every third channel's dt to 6..20 (dt a < -90
    from the 16th state on), "zero" every fourth channel's dt to 0."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    dt = np.log1p(np.exp(-4.6 + 2.0 * rng.standard_normal((b, s, d))))
    if decays == "near1":
        dt = rng.uniform(1e-5, 1e-4, (b, s, d))
    if decays == "underflow":
        dt[..., ::3] = rng.uniform(6.0, 20.0, dt[..., ::3].shape)
    if decays == "zero":
        dt[..., ::4] = 0.0
    dt = t(dt)
    x = t(rng.standard_normal((b, s, d))).to(xdtype)
    bm, cm = (t(rng.standard_normal((b, s, n))) for _ in range(2))
    a = t(-np.exp(np.log(np.arange(1, n + 1))[None, :] + 0.1 * rng.standard_normal((d, n))))
    if decays == "near1":
        a = t(-rng.uniform(1e-3, 1e-2, (d, n)))
    h0 = t(rng.standard_normal((b, d, n))) if with_state else None
    return dt, x, bm, cm, a, h0


@pytest.mark.parametrize("case", sorted(MAMBA_CASES))
def test_mamba_scan_kernel_matches_plain(dev, case):
    b, s, d, n, xdtype, with_state, *decays = MAMBA_CASES[case]
    args = _mamba_args(b, s, d, n, xdtype, with_state, seed=s + d, dev=dev, decays="".join(decays))
    mamba_scan.launches = 0
    y, h_last = ops.mamba_scan(*args)
    torch.cuda.synchronize()
    assert mamba_scan.launches == 1
    assert y.dtype == h_last.dtype == torch.float32
    assert y.shape == (b, s, d) and h_last.shape == (b, d, n)
    want_y, want_h = ref.mamba_scan_ref(*args)
    _wkv_close(y, want_y)
    _wkv_close(h_last, want_h)


def test_mamba_scan_kernel_keeps_the_state_where_dt_is_zero(dev):
    """A channel whose dt is 0 at every step decays by exactly 1 (2^0 on
    the SFU) and adds 0 B: its h_last is its h0."""
    args = _mamba_args(2, 300, 256, 16, torch.float32, True, seed=3, dev=dev, decays="zero")
    _, h_last = mamba_scan.mamba_scan_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(h_last[:, ::4], args[5][:, ::4])


def _mamba_step64(dt, x, bm, cm, a, h0):
    """The step loop of ``ref.mamba_scan_ref`` in float64."""
    dt, x, bm, cm, a, h = (t.double() for t in (dt, x, bm, cm, a, h0))
    y = torch.empty_like(dt)
    for t in range(dt.shape[1]):
        h = (h * torch.exp(dt[:, t, :, None] * a)
             + (dt[:, t] * x[:, t])[:, :, None] * bm[:, t, None, :])
        y[:, t] = torch.einsum("bdn,bn->bd", h, cm[:, t])
    return y, h


@pytest.mark.parametrize("seed", [9, 10, 11, 12, 13])
def test_mamba_scan_kernel_near_one_holds_the_float64_loop(dev, seed):
    """Decays within 1e-6 of 1 and h0 ~ 1 over 2048 steps: every decay's
    error, of one sign near 1, adds up in the state, and the float32 step
    loop (torch's exp) itself drifts past the 1e-5 gate from a float64 step
    loop. So the kernel is held to the float64 loop within
    ``MAMBA_NEAR_ONE_TOL`` of max(1, scale), set from the card's readings
    on these seeds (PERF.md)."""
    args = _mamba_args(1, 2048, 256, 16, torch.float32, True, seed=seed, dev=dev,
                       decays="near1")
    want = _mamba_step64(*args)
    got = mamba_scan.mamba_scan_cuda(*args)
    drift = max((g.double() - w).abs().max().item() / max(1.0, w.abs().max().item())
                for g, w in zip(got, want))
    assert drift <= MAMBA_NEAR_ONE_TOL, drift


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mamba_scan_kernel_repeats_its_bits(dev, xdtype):
    """The lanes' partial y are summed in a fixed order: two launches on
    the same inputs give the same bits."""
    args = _mamba_args(4, 517, 1000, 16, xdtype, True, seed=21, dev=dev)
    first = mamba_scan.mamba_scan_cuda(*args)
    second = mamba_scan.mamba_scan_cuda(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(first, second))


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


# -- the multi-tenant scheduler ---------------------------------------------

MM_LAYERS = [16, 16, 4]
MM_TOTALS = (60, 60, 180)


def _mm_setup(mode: str):
    from repro_torch.core import CapacityDrift
    from repro_torch.data.pipeline import synthetic_mnist
    from repro_torch.fed.async_engine import AsyncConfig
    from repro_torch.fed.simulation import build_spread_problem

    train, test = synthetic_mnist(2000, n_test=200, features=16, classes=4, seed=0)
    cfg = AsyncConfig(mode=mode, reallocate=True,
                      **({"buffer_size": 2} if mode == "buffered" else {}))
    probs = [build_spread_problem(4, 6.0, total_samples=t) for t in MM_TOTALS]
    return train, test, cfg, probs, lambda: CapacityDrift(seed=0)


def _rows_equal(got, want, skip=("accuracy", "model")):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for key in w.keys() - set(skip):
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)


@pytest.mark.parametrize("mode", ["fedasync", "buffered"])
def test_multimodel_run_events_on_the_card_gives_the_cpu_rows(dev, mode, monkeypatch):
    from repro_torch.fed.multimodel import MultiModelEngine

    train, test, cfg, probs, drift = _mm_setup(mode)

    def run(device):
        eng = MultiModelEngine(cfg, probs, mlp.loss,
                               tuple(mlp.init(i, MM_LAYERS, device=device) for i in range(3)),
                               seed=2, drift=drift(), share_floor=0.1)
        batch = (torch.from_numpy(test.x).to(device), torch.from_numpy(test.y).to(device))
        return eng, eng.run_events([train] * 3, 12.0, eval_fns=mlp.accuracy,
                                   eval_batches=[batch] * 3)

    calls = {"train_agg_step": 0, "waterfill_residual": 0}
    with monkeypatch.context() as patch:
        for name in calls:
            def counted(*args, _fn=getattr(ops, name), _name=name, **kw):
                calls[_name] += 1
                return _fn(*args, **kw)
            patch.setattr(ops, name, counted)
        cpu, cpu_hists = run("cpu")
    train_step.launches = accum_flush.launches = waterfill.launches = 0
    card, card_hists = run(dev)
    assert train_step.launches == accum_flush.launches == calls["train_agg_step"] > 0
    assert waterfill.launches == calls["waterfill_residual"] > 0
    for g, w in zip(card_hists, cpu_hists):
        _rows_equal(g, w)
        np.testing.assert_allclose([r["accuracy"] for r in g], [r["accuracy"] for r in w],
                                   rtol=0, atol=0.01)
    assert len(card.split_weight_log) == len(cpu.split_weight_log) > 0
    for g, w in zip(card.split_weight_log, cpu.split_weight_log):
        np.testing.assert_array_equal(g, w)
    assert card.fault_counters == cpu.fault_counters


def test_multimodel_s1_on_the_card_is_the_async_engine(dev):
    from repro_torch.fed.async_engine import AsyncFedEngine
    from repro_torch.fed.multimodel import MultiModelEngine

    train, test, cfg, probs, drift = _mm_setup("fedasync")
    batch = (torch.from_numpy(test.x).to(dev), torch.from_numpy(test.y).to(dev))
    single = AsyncFedEngine(cfg, probs[2], mlp.loss, mlp.init(0, MM_LAYERS, device=dev),
                            seed=2, drift=drift())
    want = single.run_events(train, 18.0, eval_fn=mlp.accuracy, eval_batch=batch)
    multi = MultiModelEngine(cfg, [probs[2]], mlp.loss, mlp.init(0, MM_LAYERS, device=dev),
                             seed=2, drift=drift())
    got = multi.run_events([train], 18.0, eval_fns=[mlp.accuracy], eval_batches=[batch])[0]
    _rows_equal(got, want, skip=("model",))
    for g, w in zip(multi.params[0], single.params):
        for name in w:
            assert torch.equal(g[name], w[name]), name


FLEET_LAYERS = [16, 8, 10]


def test_fleet_f1_on_the_card_is_run_fused(dev):
    """One fleet, full participation: the fleet engine's rows, accuracies
    and parameters are the fused orchestrator's, bitwise, with the same
    training launches and one more fed_agg launch a round (the merge)."""
    from repro_torch.core import BatchedProblems
    from repro_torch.data.pipeline import synthetic_mnist
    from repro_torch.fed.fleet import FleetConfig, FleetEngine
    from repro_torch.fed.orchestrator import MELConfig, Orchestrator
    from repro_torch.fed.simulation import build_spread_problem

    train, test = synthetic_mnist(1200, n_test=200, features=16, seed=0)
    batch = (torch.from_numpy(test.x).to(dev), torch.from_numpy(test.y).to(dev))
    prob = build_spread_problem(3, 6.0, total_samples=60)
    orch = Orchestrator(MELConfig(T=6.0, total_samples=60), prob, mlp.loss,
                        mlp.init(1, FLEET_LAYERS, device=dev), seed=3)
    train_step.launches = fed_agg.launches = 0
    want = orch.run_fused(train, 3, eval_fn=mlp.accuracy, eval_batch=batch)
    assert (train_step.launches, fed_agg.launches) == (3, 3)
    eng = FleetEngine(FleetConfig(), BatchedProblems.from_problems([prob]), mlp.loss,
                      mlp.init(1, FLEET_LAYERS, device=dev), seed=3)
    train_step.launches = fed_agg.launches = 0
    got = eng.run(train, 3, eval_fn=mlp.accuracy, eval_batch=batch)
    assert (train_step.launches, fed_agg.launches) == (3, 6)
    for rf, ro in zip(got, want):
        np.testing.assert_array_equal(rf["tau"][0], ro["tau"])
        np.testing.assert_array_equal(rf["d"][0], ro["d"])
        assert rf["accuracy"] == ro["accuracy"]
    for g, w in zip(eng.global_params, orch.params):
        for name in w:
            assert torch.equal(g[name], w[name]), name


def test_fleet_on_the_card_gives_the_cpu_schedule(dev):
    """F = 4 at participation 0.5: the card's rows (sampled fleets, tau, d,
    staleness) are the CPU's, accuracies within 0.01; one training, one
    grouped fed_agg and one merge launch a round."""
    from repro_torch.data.pipeline import synthetic_mnist
    from repro_torch.fed.fleet import FleetConfig, FleetEngine, build_fleet_problems

    train, test = synthetic_mnist(1200, n_test=200, features=16, seed=0)

    def run(device):
        eng = FleetEngine(FleetConfig(participation=0.5),
                          build_fleet_problems(4, 3, T=6.0, total_samples=30, seed=2),
                          mlp.loss, mlp.init(0, FLEET_LAYERS, device=device), seed=1)
        batch = (torch.from_numpy(test.x).to(device), torch.from_numpy(test.y).to(device))
        return eng, eng.run(train, 3, eval_fn=mlp.accuracy, eval_batch=batch)

    cpu, cpu_hist = run("cpu")
    train_step.launches = fed_agg.launches = 0
    card, card_hist = run(dev)
    assert (train_step.launches, fed_agg.launches) == (3, 6)
    _rows_equal(card_hist, cpu_hist)
    np.testing.assert_allclose([r["accuracy"] for r in card_hist],
                               [r["accuracy"] for r in cpu_hist], rtol=0, atol=0.01)
    np.testing.assert_array_equal(card.pull_version, cpu.pull_version)


def test_fleet_engine_refuses_another_loss_on_the_card(dev):
    """A loss the training kernel does not take trains on the CPU only
    (the plain round); on the card the engine refuses it."""
    from repro_torch.fed.fleet import FleetConfig, FleetEngine, build_fleet_problems

    def decayed(params, batch):
        return mlp.loss(params, batch) + 1e-2 * sum((layer["w"] ** 2).sum() for layer in params)

    with pytest.raises(ValueError, match="mlp.loss only"):
        FleetEngine(FleetConfig(), build_fleet_problems(2, 3), decayed,
                    mlp.init(0, FLEET_LAYERS, device=dev))


def test_fleet_engine_on_a_one_rank_nccl_mesh_is_bitwise(dev):
    """The fleet engine over ``host_mesh()`` in a one-rank NCCL process
    group (its merge an ``all_reduce``, its solve's rows an
    ``all_gather``) gives the engine without a group its rows, versions,
    dispatch and models bit for bit; a CPU engine on that group's default
    mesh is refused."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import synthetic_mnist
    from repro_torch.fed.fleet import FleetConfig, FleetEngine, build_fleet_problems
    from repro_torch.launch.mesh import host_mesh

    train, test = synthetic_mnist(1200, n_test=200, features=16, seed=0)
    batch = (torch.from_numpy(test.x).to(dev), torch.from_numpy(test.y).to(dev))

    def run(mesh):
        eng = FleetEngine(FleetConfig(participation=0.5),
                          build_fleet_problems(5, 3, T=6.0, total_samples=30, seed=2),
                          mlp.loss, mlp.init(0, FLEET_LAYERS, device=dev), seed=1, mesh=mesh)
        return eng, eng.run(train, 3, eval_fn=mlp.accuracy, eval_batch=batch)

    alone, alone_hist = run(None)
    assert alone.mesh.device_mesh is None
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = host_mesh()
        assert mesh.device_mesh is not None and mesh.device_type == "cuda"
        train_step.launches = fed_agg.launches = 0
        meshed, meshed_hist = run(mesh)
        assert (train_step.launches, fed_agg.launches) == (3, 6)
        with pytest.raises(ValueError, match="cuda mesh cannot move the engine's cpu"):
            FleetEngine(FleetConfig(), build_fleet_problems(2, 3, T=6.0, total_samples=30,
                                                            seed=2),
                        mlp.loss, mlp.init(0, FLEET_LAYERS, device="cpu"))
    finally:
        dist.destroy_process_group()
    assert meshed.fleet_axes == ("data", "model") and meshed.mesh.size == 1
    _rows_equal(meshed_hist, alone_hist, skip=())
    for key in ("tau", "d", "pull_version"):
        np.testing.assert_array_equal(getattr(meshed, key), getattr(alone, key))
    for tree in ("global_params", "fleet_params"):
        for g, w in zip(getattr(meshed, tree), getattr(alone, tree)):
            for name in w:
                assert torch.equal(g[name], w[name]), (tree, name)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-76b"])
def test_placed_encdec_and_vlm_prefill_on_a_one_rank_nccl_mesh_is_bitwise(dev, arch):
    """Whisper at full width cut to 2 + 2 layers (bf16, as published) and
    the reduced InternVL2: ``build_prefill`` and two ``build_decode`` steps
    on trees placed by the steps' shardings on ``host_mesh()`` in a
    one-rank NCCL group give the plain trees' logits and caches (Whisper's
    cross-attention K/V among them) bit for bit, with the prefill's
    attention launches on the rank's block (one an encoder layer, two a
    decoder layer) and none in decode."""
    import torch.distributed as dist

    from repro_torch import compat, tree
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import serve, steps
    from repro_torch.launch.mesh import host_mesh

    if arch == "whisper-small":
        cfg = dataclasses.replace(get_config(arch), num_layers=2, num_encoder_layers=2)
        launches = cfg.num_encoder_layers + 2 * cfg.num_layers
    else:
        cfg = get_reduced(arch)
        launches = cfg.num_layers
    model = Model(cfg, device=dev)
    params = model.init(0)
    batch = serve.prompt_batch(cfg, 2, 16, 0, dev)
    start = serve.start_position(cfg, batch)
    shape = InputShape("p", start + 4, 2, "prefill")

    def run(mesh, params, batch):
        prefill, (pshard, batch_sh), _ = steps.build_prefill(model, mesh, shape)
        decode, (_, _, tshard, _), _ = steps.build_decode(model, mesh, shape)
        params = compat.distribute(params, pshard, mesh)
        flash_attention.launches = 0
        logits, cache, _ = prefill(params, compat.distribute(batch, batch_sh(batch), mesh))
        counted = flash_attention.launches
        out = [compat.gather(logits)]
        for i in range(2):
            tok = torch.argmax(out[-1][:, -1:], dim=-1)
            logits, cache = decode(params, cache, compat.distribute(tok, tshard, mesh),
                                   start + i)
            out.append(compat.gather(logits))
        return out, compat.gather(cache), (counted, flash_attention.launches)

    want, want_cache, want_n = run(host_mesh(), params, batch)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = host_mesh()
        assert mesh.device_mesh is not None and mesh.device_type == "cuda"
        got, got_cache, got_n = run(mesh, params, batch)
    finally:
        dist.destroy_process_group()
    assert got_n == want_n == (launches, launches)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(tree.leaves(got_cache), tree.leaves(want_cache)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-76b"])
def test_encdec_and_vlm_serves_on_the_card_match_the_cpu(dev, arch):
    """Whisper at full width cut to 2 + 2 layers (the reduced config's head
    dim, 32, is not one the attention kernel takes) and the reduced
    InternVL2, float32, from one seed on the card and on the CPU: the
    prefill's logits within 1e-4 of their scale and four greedy tokens
    equal; a Whisper prefill launches the attention kernel for each
    encoder layer and twice for each decoder layer, decode never."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    if arch == "whisper-small":
        cfg = dataclasses.replace(get_config(arch), num_layers=2, num_encoder_layers=2,
                                  param_dtype="float32", compute_dtype="float32")
        launches = cfg.num_encoder_layers + 2 * cfg.num_layers
    else:
        cfg = get_reduced(arch)
        launches = cfg.num_layers
    runs = {}
    for device in ("cpu", dev):
        model = Model(cfg, device=device)
        params = model.init(0)
        batch = serve.prompt_batch(cfg, 2, 16, 0, device)
        flash_attention.launches = 0
        with torch.inference_mode():
            logits, cache, tok = serve.prefill(model, params, batch, 16 + 5 + (
                cfg.num_image_tokens if cfg.family == "vlm" else 0))
            counted = flash_attention.launches
            rest, _ = serve.decode(model, params, cache, tok,
                                   serve.start_position(cfg, batch), 3)
        runs[str(device)] = (logits.float().cpu(), torch.cat([tok, rest], 1).cpu(), counted,
                             flash_attention.launches)
    (cl, ct, *_), (gl, gt, prefill_n, total_n) = runs["cpu"], runs[str(dev)]
    assert (prefill_n, total_n) == (launches, launches)
    assert (gl - cl).abs().max().item() <= 1e-4 * cl.abs().max().item()
    assert torch.equal(gt, ct)


# -- attention's gradient and training ---------------------------------------

FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _flash_grads(q, k, v, do, causal, window):
    """(out, dq, dk, dv) through ``ops.flash_attention`` under autograd."""
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    out.backward(do)
    return out.detach(), q.grad, k.grad, v.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_backward_matches_plain(dev, case, dtype):
    """``ops.flash_attention`` under a gradient runs the forward kernel once
    and the backward kernel once; dq, dk, dv are held to the dense plain
    backward ``ref.flash_attention_bwd_ref`` on the same inputs: 1e-4 of each
    gradient's scale in float32 (dk and dv sum G * Sq terms, in another
    order), 1e-2 in bf16 (one bf16 step of the outputs, and D taken from the
    kernel's bf16 output where the plain version uses its float32 one). A
    gradient's scale is at least 1e-3 max |dO| max |v|, the size of dP and
    D whose difference dS is: with one key dS, dq and dk are 0 but for
    rounding. Rows with no key give 0, not NaN. bf16 runs the tensor-core
    kernels and float32 the CUDA-core ones, as the C entry reports."""
    b, sq, skv, h, kvh, d, causal, window = FLASH_CASES[case]
    q, k, v = _qkv(b, sq, skv, h, kvh, d, dtype, seed=sq + skv + d, dev=dev)
    (do,) = _qkv(b, sq, sq, h, h, d, dtype, seed=sq + 1, dev=dev)[:1]
    flash_attention.launches = flash_attention.bwd_launches = 0
    flash_attention.last_bwd_kernel = None
    _, *got = _flash_grads(q, k, v, do, causal, window)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.bwd_launches) == (1, 1)
    assert flash_attention.last_bwd_kernel == ("tc" if dtype == torch.bfloat16 else "cc")
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    floor = 1e-3 * do.float().abs().max().item() * v.float().abs().max().item()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all()), name
        scale = max(w.float().abs().max().item(), floor)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= FLASH_BWD_TOL[dtype] * scale, (name, err, scale)
    if case == "fully_masked_rows":
        assert bool((got[0][:, 107:] == 0).all())


# Llama-3.2-3B's training shape (chip_smoke.py phase 15) cut to B 1
FLASH_TRAIN_B1 = (1, 2048, 2048, 24, 8, 128, True, None)


@pytest.mark.parametrize("case,dtype", [
    pytest.param(case, dtype, id=f"{case}-{name}")
    for case in ("llama_gqa3_causal", "window_narrower_than_a_tile", "whisper_cross")
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
] + [pytest.param("llama_train_b1", torch.bfloat16, id="llama_train_b1-bf16")])
def test_flash_attention_backward_repeats_its_bits(dev, case, dtype):
    """No atomics: dk and dv of a kv head are summed by one CTA in one order,
    and dq by one CTA a query block."""
    b, sq, skv, h, kvh, d, causal, window = (FLASH_TRAIN_B1 if case == "llama_train_b1"
                                             else FLASH_CASES[case])
    q, k, v = _qkv(b, sq, skv, h, kvh, d, dtype, seed=sq + skv + d, dev=dev)
    (do,) = _qkv(b, sq, sq, h, h, d, dtype, seed=sq + 1, dev=dev)[:1]
    first = _flash_grads(q, k, v, do, causal, window)
    second = _flash_grads(q, k, v, do, causal, window)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


def test_flash_attention_lse_is_the_rows_log_sum_exp(dev):
    """The forward's lse (what the backward rebuilds p from) against the
    dense scores' logsumexp, in both kernels; -inf for a row with no key."""
    b, sq, skv, h, kvh, d, causal, window = FLASH_CASES["fully_masked_rows"]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(b, sq, skv, h, kvh, d, dtype, seed=3, dev=dev)
        _, lse = flash_attention.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                                      return_lse=True)
        g = h // kvh
        s = torch.einsum("bqkgd,bckd->bkgqc", q.float().reshape(b, sq, kvh, g, d),
                         k.float()) / math.sqrt(d)
        qp, kp = torch.arange(sq, device=dev)[:, None], torch.arange(skv, device=dev)[None]
        s = torch.where((qp >= kp) & (qp - kp < window), s, -math.inf)
        want = torch.logsumexp(s, dim=-1).reshape(b, h, sq)
        finite = torch.isfinite(want)
        assert torch.equal(finite, torch.isfinite(lse)) and not bool(finite.all())
        assert (lse[finite] - want[finite]).abs().max().item() <= 1e-5


def test_flash_attention_backward_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(1, 8, 8, 4, 2, 64, torch.float32, seed=0, dev=dev)
    out, lse = flash_attention.flash_attention_cuda(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="dout must be like q"):
        flash_attention.flash_attention_bwd_cuda(q, k, v, out, lse, out.bfloat16())
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention.flash_attention_bwd_cuda(q, k, v, out, lse[:, :2].contiguous(), out)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_bwd_cuda(*(t[..., :32].contiguous()
                                                   for t in (q, k, v, out)), lse, out)


@pytest.mark.parametrize("arch,remat", [("llama3.2-3b", False), ("llama3.2-3b", True),
                                        ("qwen2-moe-a2.7b", False),
                                        ("internvl2-76b", False), ("rwkv6-7b", False),
                                        ("rwkv6-7b", True), ("jamba-v0.1-52b", False),
                                        ("jamba-v0.1-52b", True)])
def test_train_step_on_the_card_matches_the_cpu(dev, arch, remat, monkeypatch):
    """One ``build_train`` step (AdamW, clip 1.0) of a reduced config (head
    dim 64) on the card and on the CPU from the same weights and batch: the
    loss within 1e-5 relative, the gradient norm within 1e-4, every
    gradient leaf (captured where the step clips it) within 1e-4 of its
    scale. The parameters after the step are held to the CPU's AdamW step
    from the card's own clipped gradients, within 1e-5 of their scale: the
    first Adam step divides each gradient by its own size (plus eps
    1e-8), so where a gradient is near eps a rounding of it moves the
    parameter by a share of the learning rate, and the two devices' steps
    are compared through their gradients instead. On the card each
    layer's kernel (attention, WKV-6 or the Mamba scan) runs its forward
    once (twice under remat) and its backward once."""
    from repro_torch import tree
    from repro_torch.data.pipeline import token_batches
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_mesh_by_name
    from repro_torch.optim.optimizers import get_optimizer

    clipped = []
    clip = steps.clip_by_global_norm

    def capture(grads, max_norm):
        out = clip(grads, max_norm)
        clipped.append(out[0])
        return out

    monkeypatch.setattr(steps, "clip_by_global_norm", capture)
    cfg = dataclasses.replace(get_reduced(arch), remat=remat)
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    rng = np.random.default_rng(0)
    nb = train.with_extras(cfg, next(token_batches(rng, 2, 65, cfg.vocab_size)), rng, 64)
    kernels = {"attn": flash_attention, "rwkv6": wkv6, "mamba": mamba_scan}
    runs = {}
    for device in ("cpu", dev):
        model = Model(cfg, device=device)
        params = model.init(0)
        step = steps.build_train(model, make_mesh_by_name("cpu"))[0]
        for module in kernels.values():
            module.launches = module.bwd_launches = 0
        new, _, met = step(params, opt.init(params), {k: torch.as_tensor(a, device=device)
                                                      for k, a in nb.items()})
        runs[str(device)] = (new, clipped[-1], met["loss"].item(), met["grad_norm"].item(),
                             {kind: (m.launches, m.bwd_launches) for kind, m in kernels.items()})
    (cp, cgr, cl, cg, cpu_counts), (gp, ggr, gl, gg, counts) = runs["cpu"], runs[str(dev)]
    assert set(cpu_counts.values()) == {(0, 0)}
    kinds = cfg.layer_kinds()
    assert counts == {kind: ((2 if remat else 1) * kinds.count(kind), kinds.count(kind))
                      for kind in kernels}
    assert abs(gl - cl) <= 1e-5 * abs(cl) and abs(gg - cg) <= 1e-4 * cg
    for g, w in zip(tree.leaves(ggr), tree.leaves(cgr)):
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * w.abs().max().item()
        assert w.abs().max().item() > 0
    params = Model(cfg, device="cpu").init(0)
    want, _ = opt.apply(tree.map(lambda g: g.cpu(), ggr), opt.init(params), params)
    for g, w in zip(tree.leaves(gp), tree.leaves(want)):
        assert (g.cpu() - w).abs().max().item() <= 1e-5 * w.abs().max().item()


# -- the WKV-6 and Mamba-scan gradients -----------------------------------------

# a gradient returned in float32 to 1e-4 of its scale, one returned in bf16
# to one bf16 step; a scale is at least 1e-3 max |dy|
SSM_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-8}

# b, s, heads, hd, with s0, with ds_last, decays (see _wkv_args). The
# kernel splits the sequence at 64-step chunks (its reversed run pads the
# ragged one at its head) and walks a chunk in 8-step sub-chunks: the
# lengths cross several and end ragged, and 63, 64, 65 and 129 sit on the
# chunks' edges at both ends of the head dims
WKV_BWD_CASES = {
    "rwkv_head64": (2, 200, 4, 64, True, True, ()),
    "ragged_no_state": (3, 37, 2, 64, False, False, ()),
    "one_step": (2, 1, 3, 64, True, True, ()),
    "head32": (2, 65, 3, 32, True, False, ()),
    "head128": (1, 71, 2, 128, True, True, ()),
    "empty_seq": (2, 0, 2, 64, True, True, ()),
    "ragged_1000": (2, 1000, 2, 64, True, True, ()),
    "strong_decay": (2, 300, 3, 64, True, True, ("zero", "one")),
    "s63_head32": (1, 63, 3, 32, True, True, ()),
    "s63_head128": (1, 63, 2, 128, False, True, ()),
    "s64_head32": (1, 64, 3, 32, False, False, ("zero",)),
    "s64_head128": (1, 64, 2, 128, True, True, ()),
    "s65_head32": (1, 65, 3, 32, True, False, ("one",)),
    "s65_head128": (1, 65, 2, 128, True, True, ("zero", "one")),
    "s129_head32": (1, 129, 3, 32, True, True, ()),
    "s129_head128": (1, 129, 2, 128, False, True, ()),
}
# the RWKV-6 7B training shape cut to B 1 (15d times it at B 4)
WKV_TRAIN_B1 = (1, 2048, 64, 64, False, False, ())


def _grads_close(names, got, wants, dtypes, floor) -> None:
    """Each returned gradient against each plain version's, within
    ``SSM_BWD_TOL`` of the gradient's dtype of max(scale, floor)."""
    for name, g, dtype, *ws in zip(names, got, dtypes, *wants):
        if ws[0] is None:
            assert g is None, name
            continue
        assert g.dtype == dtype and bool(torch.isfinite(g).all()), name
        for w in ws:
            scale = max(w.float().abs().max().item() if w.numel() else 0.0, floor)
            err = (g.float() - w.float()).abs().max().item() if w.numel() else 0.0
            assert err <= SSM_BWD_TOL[dtype] * scale, (name, err, scale)


def _autograd(fn, inputs, cotangents):
    """torch autograd of ``fn(*inputs)`` (an input that is None gives None;
    one the output does not reach, zeros)."""
    leaves = [None if t is None else t.detach().clone().requires_grad_(True) for t in inputs]
    live = [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad(fn(*leaves), live, cotangents, allow_unused=True))
    out = []
    for t in leaves:
        g = None if t is None else next(grads)
        out.append(g if g is not None or t is None else torch.zeros_like(t))
    return out


def _wkv_bwd_args(case, dtype, dev):
    b, s, h, hd, with_state, with_dlast, decays = WKV_BWD_CASES[case]
    args = _wkv_args(b, s, h, hd, dtype, with_state, seed=s + hd + 5, dev=dev, decays=decays)
    rng = np.random.default_rng(s + 1)
    dy = torch.tensor(rng.standard_normal((b, s, h, hd)), dtype=torch.float32, device=dev)
    dlast = (torch.tensor(rng.standard_normal((b, h, hd, hd)), dtype=torch.float32, device=dev)
             if with_dlast else None)
    return args, dy, dlast


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(WKV_BWD_CASES))
def test_wkv6_backward_matches_plain(dev, case, dtype):
    """``wkv6_bwd_cuda`` (one call) against the written-out
    ``ref.wkv6_bwd_ref`` and autograd of ``ref.wkv6_ref`` on the same
    inputs: dr, dk, dv in r's dtype, dw, du and ds0 float32."""
    (r, k, v, w, u, s0), dy, dlast = _wkv_bwd_args(case, dtype, dev)
    wkv6.bwd_launches = 0
    got = wkv6.wkv6_bwd_cuda(r, k, v, w, u, dy, s0, dlast)
    torch.cuda.synchronize()
    assert wkv6.bwd_launches == 1
    # the C entry's kernels: the reversed chunk run and du's sum, the row
    # walk where there is a step, the chunk states' run past one chunk
    chunks = -(-r.shape[1] // wkv6.CHUNK)
    assert wkv6.last_bwd_kernels == 2 + int(chunks > 0) + int(chunks > 1)
    wants = [ref.wkv6_bwd_ref(r, k, v, w, u, dy, s0, dlast)]
    if r.shape[1]:  # autograd of the step loop (with no step, y is no function of the inputs)
        zeros = torch.zeros((r.shape[0], r.shape[2], r.shape[3], r.shape[3]), device=dev)
        wants.append(_autograd(ref.wkv6_ref, (r, k, v, w, u, s0),
                               (dy, zeros if dlast is None else dlast)))
    floor = 1e-3 * (dy.abs().max().item() if dy.numel() else 1.0)
    _grads_close(("dr", "dk", "dv", "dw", "du", "ds0"), got, wants,
                 (dtype,) * 3 + (torch.float32,) * 3, floor)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wkv6_backward_repeats_its_bits(dev, dtype):
    """No atomics: every sum has one order (du over the batch too)."""
    (r, k, v, w, u, s0), dy, dlast = _wkv_bwd_args("rwkv_head64", dtype, dev)
    first = wkv6.wkv6_bwd_cuda(r, k, v, w, u, dy, s0, dlast)
    second = wkv6.wkv6_bwd_cuda(r, k, v, w, u, dy, s0, dlast)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wkv6_backward_repeats_its_bits_at_the_training_shape(dev, dtype):
    """The same at the training shape cut to B 1: 32 chunks, each walked by
    two CTAs, du summed over them in order; with and without the forward's
    chunk states the gradients are the same bits."""
    b, s, h, hd, with_state, with_dlast, decays = WKV_TRAIN_B1
    r, k, v, w, u, s0 = _wkv_args(b, s, h, hd, dtype, with_state, seed=11, dev=dev)
    dy = torch.randn((b, s, h, hd), generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev)
    states = torch.empty(wkv6.chunk_states_shape(r), device=dev)
    wkv6.wkv6_cuda(r, k, v, w, u, s0, chunk_states=states)
    first = wkv6.wkv6_bwd_cuda(r, k, v, w, u, dy, s0)
    second = wkv6.wkv6_bwd_cuda(r, k, v, w, u, dy, s0)
    kept = wkv6.wkv6_bwd_cuda(r, k, v, w, u, dy, s0, chunk_states=states)
    torch.cuda.synchronize()
    for a, b_, c in zip(first, second, kept):
        assert (a is None and b_ is None and c is None) or (torch.equal(a, b_)
                                                             and torch.equal(a, c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["rwkv_head64", "s129_head128", "s65_head32", "s64_head32"])
def test_wkv6_chunk_states_leave_the_forward_bitwise(dev, case, dtype):
    """``wkv6_cuda(..., chunk_states=t)`` writes the state after each chunk
    but the last into t (the step loop's to ``WKV_TOL`` of its scale), and
    its y and s_last are the same bits as without it."""
    b, s, h, hd, with_state, _, decays = WKV_BWD_CASES[case]
    args = _wkv_args(b, s, h, hd, dtype, with_state, seed=s + 3, dev=dev, decays=decays)
    states = torch.full(wkv6.chunk_states_shape(args[0]), float("nan"), device=dev)
    y, s_last = wkv6.wkv6_cuda(*args, chunk_states=states)
    want_y, want_s = wkv6.wkv6_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, want_y) and torch.equal(s_last, want_s)
    r, k, v, w, u, s0 = args
    for c in range(states.shape[2]):
        cut = (c + 1) * wkv6.CHUNK
        _, plain = ref.wkv6_ref(*(x[:, :cut] for x in (r, k, v, w)), u, s0)
        _wkv_close(states[:, :, c], plain)
    if states.shape[2]:
        with pytest.raises(ValueError, match="step kernel writes no chunk states"):
            wkv6.wkv6_cuda(*args, kernel="step", chunk_states=states)


@pytest.mark.parametrize("with_state", [False, True], ids=["no_state", "state"])
def test_wkv6_under_a_gradient_runs_both_kernels(dev, with_state):
    """``ops.wkv6`` with inputs that require grad runs ``WKV6``: one forward
    and one backward launch, the forward's outputs the kernel's bits and
    the gradients ``wkv6_bwd_cuda``'s bits on the same cotangents."""
    case = "rwkv_head64" if with_state else "ragged_no_state"
    args, dy, dlast = _wkv_bwd_args(case, torch.bfloat16, dev)
    leaves = [None if t is None else t.detach().clone().requires_grad_(True) for t in args]
    wkv6.launches = wkv6.bwd_launches = 0
    y, s_last = ops.wkv6(*leaves)
    loss = (y * dy).sum() + ((s_last * dlast).sum() if with_state else 0.0)
    loss.backward()
    torch.cuda.synchronize()
    assert (wkv6.launches, wkv6.bwd_launches) == (1, 1)
    want_y, want_s = wkv6.wkv6_cuda(*args)
    assert torch.equal(y.detach(), want_y) and torch.equal(s_last.detach(), want_s)
    want = wkv6.wkv6_bwd_cuda(*args[:5], dy, args[5], dlast if with_state else None)
    for leaf, g in zip(leaves, want):
        assert (leaf is None and g is None) or torch.equal(leaf.grad, g)


def test_wkv6_backward_refuses_what_it_does_not_take(dev):
    (r, k, v, w, u, s0), dy, dlast = _wkv_bwd_args("ragged_no_state", torch.float32, dev)
    with pytest.raises(ValueError, match="head dim"):
        wkv6.wkv6_bwd_cuda(*(t[..., :48].contiguous() for t in (r, k, v, w)), u[:, :48], dy)
    with pytest.raises(ValueError, match="dy must be"):
        wkv6.wkv6_bwd_cuda(r, k, v, w, u, dy.bfloat16())
    with pytest.raises(ValueError, match="ds_last must be"):
        wkv6.wkv6_bwd_cuda(r, k, v, w, u, dy, None, dy[:, 0])
    with pytest.raises(ValueError, match="chunk_states must be"):
        wkv6.wkv6_bwd_cuda(r, k, v, w, u, dy, chunk_states=dy[:, :1])
    leaves = [t.detach().clone().requires_grad_(True) for t in (r, k, v, w, u)]
    state = torch.zeros((r.shape[0], r.shape[2], 64, 64), device=dev)
    with pytest.raises(ValueError, match="no out_state where a gradient is needed"):
        ops.wkv6(*leaves, out_state=state)


# b, s, d, n, x dtype, with h0, with dh_last, decays (see _mamba_args). The
# kernel keeps a checkpoint at the start of every 8-step sub-chunk: 63, 64
# and 65 end one step short of, on and one step past a sub-chunk's edge, at
# both ends of the state dims
MAMBA_BWD_CASES = {
    "jamba_like": (2, 100, 300, 16, torch.bfloat16, True, True, ""),
    "ragged_no_state": (3, 37, 129, 16, torch.float32, False, False, ""),
    "state8": (2, 50, 64, 8, torch.float32, True, True, ""),
    "state4_bf16": (3, 131, 100, 4, torch.bfloat16, True, False, ""),
    "state32": (2, 257, 96, 32, torch.float32, True, True, ""),
    "one_step": (4, 1, 256, 16, torch.bfloat16, True, True, ""),
    "empty_seq": (2, 0, 96, 16, torch.float32, True, True, ""),
    "near_one_2048": (2, 2048, 192, 16, torch.float32, False, False, "near1"),
    "underflow": (2, 300, 256, 16, torch.float32, True, True, "underflow"),
    "dt_zero": (2, 300, 256, 16, torch.bfloat16, True, True, "zero"),
    "s63_n4": (1, 63, 136, 4, torch.float32, True, True, ""),
    "s63_n32": (1, 63, 96, 32, torch.bfloat16, False, True, ""),
    "s64_n4": (1, 64, 200, 4, torch.bfloat16, True, False, "underflow"),
    "s64_n32": (1, 64, 64, 32, torch.float32, True, True, ""),
    "s65_n4": (1, 65, 129, 4, torch.float32, False, False, ""),
    "s65_n32": (1, 65, 160, 32, torch.float32, True, True, "near1"),
}
# the Jamba training shape cut to B 1 (15d times it at B 4)
MAMBA_TRAIN_B1 = (1, 2048, 8192, 16)


def _mamba_bwd_args(case, dev):
    b, s, d, n, xdtype, with_state, with_dlast, decays = MAMBA_BWD_CASES[case]
    args = _mamba_args(b, s, d, n, xdtype, with_state, seed=s + d + 5, dev=dev, decays=decays)
    rng = np.random.default_rng(s + 2)
    dy = torch.tensor(rng.standard_normal((b, s, d)), dtype=torch.float32, device=dev)
    dlast = (torch.tensor(rng.standard_normal((b, d, n)), dtype=torch.float32, device=dev)
             if with_dlast else None)
    return args, dy, dlast


@pytest.mark.parametrize("case", sorted(MAMBA_BWD_CASES))
def test_mamba_scan_backward_matches_plain(dev, case):
    """``mamba_scan_bwd_cuda`` (one launch) against the written-out
    ``ref.mamba_scan_bwd_ref`` and autograd of ``ref.mamba_scan_ref``: dx in
    x's dtype, ddt, db, dc, da and dh0 float32; finite where decays
    underflow."""
    (dt, x, bm, cm, a, h0), dy, dlast = _mamba_bwd_args(case, dev)
    mamba_scan.bwd_launches = 0
    got = mamba_scan.mamba_scan_bwd_cuda(dt, x, bm, cm, a, dy, h0, dlast)
    torch.cuda.synchronize()
    assert mamba_scan.bwd_launches == 1
    wants = [ref.mamba_scan_bwd_ref(dt, x, bm, cm, a, dy, h0, dlast)]
    if dt.shape[1]:
        zeros = torch.zeros((dt.shape[0], dt.shape[2], bm.shape[2]), device=dev)
        wants.append(_autograd(ref.mamba_scan_ref, (dt, x, bm, cm, a, h0),
                               (dy, zeros if dlast is None else dlast)))
    floor = 1e-3 * (dy.abs().max().item() if dy.numel() else 1.0)
    _grads_close(("ddt", "dx", "db", "dc", "da", "dh0"), got, wants,
                 (torch.float32, x.dtype) + (torch.float32,) * 4, floor)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mamba_scan_backward_repeats_its_bits(dev, xdtype):
    """No atomics: db and dc sum the channel blocks in order, da the batch
    rows."""
    args = _mamba_args(4, 517, 1000, 16, xdtype, True, seed=23, dev=dev)
    dy = torch.randn((4, 517, 1000), generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    first = mamba_scan.mamba_scan_bwd_cuda(*args[:5], dy, args[5])
    second = mamba_scan.mamba_scan_bwd_cuda(*args[:5], dy, args[5])
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(first, second))


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mamba_scan_backward_repeats_its_bits_at_the_training_shape(dev, xdtype):
    """The same at the training shape cut to B 1: 256 sub-chunks, each
    recomputed from its checkpoint, and 128 channel blocks summed in order
    for dB and dC."""
    b, s, d, n = MAMBA_TRAIN_B1
    args = _mamba_args(b, s, d, n, xdtype, False, seed=29, dev=dev)
    dy = torch.randn((b, s, d), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    first = mamba_scan.mamba_scan_bwd_cuda(*args[:5], dy)
    second = mamba_scan.mamba_scan_bwd_cuda(*args[:5], dy)
    torch.cuda.synchronize()
    assert all((p is None and q is None) or torch.equal(p, q) for p, q in zip(first, second))


@pytest.mark.parametrize("with_state", [False, True], ids=["no_state", "state"])
def test_mamba_scan_under_a_gradient_runs_both_kernels(dev, with_state):
    """``ops.mamba_scan`` with inputs that require grad runs ``MambaScan``:
    one forward and one backward launch, the gradients
    ``mamba_scan_bwd_cuda``'s bits on the same cotangents."""
    case = "jamba_like" if with_state else "ragged_no_state"
    args, dy, dlast = _mamba_bwd_args(case, dev)
    leaves = [None if t is None else t.detach().clone().requires_grad_(True) for t in args]
    mamba_scan.launches = mamba_scan.bwd_launches = 0
    y, h_last = ops.mamba_scan(*leaves)
    loss = (y * dy).sum() + ((h_last * dlast).sum() if with_state else 0.0)
    loss.backward()
    torch.cuda.synchronize()
    assert (mamba_scan.launches, mamba_scan.bwd_launches) == (1, 1)
    want = mamba_scan.mamba_scan_bwd_cuda(*args[:5], dy, args[5],
                                          dlast if with_state else None)
    for leaf, g in zip(leaves, want):
        assert (leaf is None and g is None) or torch.equal(leaf.grad, g)


def test_mamba_scan_backward_refuses_what_it_does_not_take(dev):
    (dt, x, bm, cm, a, h0), dy, dlast = _mamba_bwd_args("state8", dev)
    with pytest.raises(ValueError, match="state dim"):
        mamba_scan.mamba_scan_bwd_cuda(dt, x, bm[..., :6].contiguous(),
                                       cm[..., :6].contiguous(), a[:, :6].contiguous(), dy)
    with pytest.raises(ValueError, match="dy must be"):
        mamba_scan.mamba_scan_bwd_cuda(dt, x, bm, cm, a, dy[:, :1].contiguous())
    with pytest.raises(ValueError, match="dh_last must be"):
        mamba_scan.mamba_scan_bwd_cuda(dt, x, bm, cm, a, dy, h0, dlast.bfloat16())
    leaves = [t.detach().clone().requires_grad_(True) for t in (dt, x, bm, cm, a)]
    with pytest.raises(ValueError, match="no out_state where a gradient is needed"):
        ops.mamba_scan(*leaves, out_state=torch.zeros_like(h0))
