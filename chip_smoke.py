#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel);
  2. ``fed_agg`` kernel vs its plain version at the paper model's leaf
     shapes (K = 10): all 8 leaves in one launch, each bitwise the
     single-leaf launch's, timed against one launch a leaf, the plain
     version and the 8 ``torch.tensordot`` calls;
  3. ``train_agg_step`` kernel vs its plain version (autograd) for one
     cycle at full width: the [784, 300, 124, 60, 10] MLP, K = 10 learners
     with the allocation ``solve_kkt_sai`` gives the paper's fleet; the
     cycle's device kernels by ``torch.profiler``, with exactly one launch of
     the persistent training kernel;
  4. the main path, ``run_experiment(k=10, T=15, cycles=3)``, fused (through
     the kernels, launch counts checked) and eager (plain torch), compared,
     and the fused run again, warm;
  5. the reallocation path:
     a. ``waterfill_residual`` kernel vs its plain version on a fleet-scale
        batch (the paper's 8-learner fleet under ``CapacityDrift(seed=0)``
        over 131,072 cycles, one problem a cycle), at tau* = 0, the solved
        tau* and 2 tau*, in float64 and float32, with kernel, plain and
        bound times;
     b. ``solve_kkt_batched`` of that batch on the card against the CPU,
        with the card's time split into bisection, integerize and SAI;
     c. ``run_experiment(k=10, T=15, cycles=3, reallocate=True)`` under
        ``CapacityDrift(seed=0)`` and ``QueueDrift(base=CapacityDrift(seed=0))``,
        fused and eager, with its rows held to the CPU solver's;
  6. the async path:
     a. ``accum_flush`` kernel vs its plain version at the paper model's
        leaf shapes (K = 10): all 8 leaves in one launch, each bitwise the
        leaf alone through the launch, in the three flush cases (accumulate
        only, a buffered flush, a fedasync mix), with kernel, plain, bound
        and ``torch.tensordot`` (the accumulate's contraction) times;
     b. one async group step (training + ``accum_flush``) at full width vs
        its plain version: the buffered run's widest flush group (one
        training-kernel launch a call, by ``torch.profiler``), and the
        fedasync shape (one learner trains, nine sit at tau = 0) dense
        against the same step over one slot;
     c. ``run_async_experiment(k=10, T=15, cycles=3, CapacityDrift(seed=0),
        reallocate=True)`` in fedasync and buffered (M = 5), grouped
        (``bucketed=True``, through the kernels) and eager (plain torch), with
        rows held to each other and to the CPU schedule's, every launch
        count held exactly, and ms per aggregation; fedasync again with
        ``seg_batch=1``;
  7. the energy and churn paths:
     a. ``waterfill_energy_residual`` kernel vs its plain version on phase
        5's fleet-scale batch with the energy rows of
        ``build_energy_problem(8, 15.0, seed=0)`` and a budget of 0.75 x
        the median spend of the blind ``kkt_sai`` allocation, at tau* = 0,
        the solved tau* and 2 tau*, in float64 and float32, with kernel,
        plain and bound times; at eb = +inf it must give the time-only
        kernel's output bitwise, and NaN fleets (e2 = e1 = 0, eb = e0)
        must sit where the plain version's do;
     b. ``solve_energy_batched`` of that batch on the card against the CPU,
        with zero budget violations and the card's split;
     c. ``run_async_experiment(k=10, T=15, cycles=3, scheme="kkt_energy",
        reallocate=True)`` on ``build_energy_problem`` with that budget
        under ``BatteryDrift(base=CapacityDrift(seed=0))``, fedasync and
        buffered (M = 5), grouped and eager, with rows and the energy
        ledger held to a CPU-built schedule, zero violations and every
        launch count exact;
     d. churn: the buffered run under ``MarkovAvailability(p_drop=0.2,
        base=CapacityDrift(seed=0))`` with ``churn_sweep``'s fault mix,
        grouped, its masks, rows and counters held to the CPU's;
     e. budgeted ``pgd`` on the card: ``solve_policy_row("pgd", ...)`` on
        three drifted rows of phase 7c's budgeted fleet (one energy
        water-filling a re-solve, counted) and the per-problem
        ``solve_pgd_jax`` that a run with ``scheme="pgd"`` starts from,
        each held to its budget and compared with the CPU's;
  8. the dense serving path (Llama-3.2-3B at full width):
     a. ``flash_attention`` kernel vs its plain version at the prefill
        shapes of Llama-3.2-3B (B 4, S 2048, 24/8 heads, d 128, causal, bf16
        and float32), a ragged S = 1000, and H2O-Danube-1.8B (B 1, S 8192,
        32/8 heads, d 80, window 4096, bf16), and Whisper-small's encoder
        (B 8, 1500 frames, 12/12 heads, d 64, non-causal) and
        cross-attention (64 queries against 1500 keys, non-causal) and
        decoder self-attention (B 8, S 64, causal), and InternVL2-76B's
        prefill (B 4, S 512, 64/8 heads, d 128, causal), bf16 and float32,
        with kernel, plain, bound and
        ``scaled_dot_product_attention`` times and TFLOP/s; each bf16 case
        also against the float32 kernel on the widened inputs (within one
        bf16 step of the output's scale);
     b. the serve: ``Model(get_config("llama3.2-3b"))`` with weights drawn
        from the seed, ``serve.prefill`` of 4 x 2048 tokens and
        ``serve.decode`` of 31 greedy steps, through the kernel (28 launches
        in the prefill, none in decode, every other kernel none), init,
        prefill and decode times and peak memory; the prefill's
        last-position logits held to the same prefill with
        ``ops.flash_attention`` bound to the plain chunked scan (in this
        script only, ``plain_attention``), greedy agreement printed;
     c. the same width in float32 at 2 layers, kernel vs plain: logits
        within 1e-4 of their scale, 16 greedy decode steps equal;
  9. the RWKV-6 serving path (RWKV-6 "Finch" 7B at full width):
     a. ``wkv6`` kernels vs their plain version, the step loop
        ``ref.wkv6_ref``: the chunk kernel at the prefill shape (B 4, S 2048,
        64 heads of 64, bf16 and float32 r/k/v, no starting state), a ragged
        S = 1000 with a starting state, and S = 1000 with strong decays (w = 0
        and within 1e-7 of 1 in some channels; in bf16 writing the state over
        a copy of its own s0); the step kernel at the decode shape (S = 1,
        both dtypes) writing the state over a copy of its own s0; with kernel
        (CUDA events and the profiler's device time), plain and bound times,
        and the chunk design's executed work (no single PyTorch call
        computes this function);
     b. the serve: ``Model(get_config("rwkv6-7b"))`` with weights drawn from
        the seed (32 layers, d 4096, 7,576,621,056 parameters, bf16),
        ``serve.prefill`` of 4 x 2048 tokens and ``serve.decode`` of 31
        greedy steps, through the kernel (32 launches in the prefill, 32 a
        decode step, every other kernel none), init, prefill and decode
        times, idle shares and peak memory; the prefill's last-position
        logits held to the same prefill with ``ops.wkv6`` bound to the step
        loop (in this script only, ``plain_wkv``), greedy agreement printed;
     c. the same width in float32 at 2 layers, kernel vs plain: logits
        within 1e-4 of their scale, 16 greedy decode steps equal;
 10. the hybrid serving path (Jamba v0.1 at full width, one period):
     a. ``mamba_scan`` kernel vs its plain version, the step loop
        ``ref.mamba_scan_ref``, at the prefill shape (B 4, S 2048, d_inner
        8192, 16 states, bf16 and float32 x, no starting state), a ragged
        S = 1000 with a starting state, S = 1000 writing the state over a
        copy of its own h0, decays within 1e-6 of 1 over 2048 steps (with
        a state held to a float64 step loop within 1e-4 of its scale, where
        the float32 step loop itself drifts past 1e-5) and underflowing
        decays (S = 1000, with a state), with kernel, plain and bound
        times, the SFU floor, the share of the exponentials on the FMA
        pipes and the lanes a channel (no single PyTorch call computes this
        function);
     b. the serve: ``Model`` of ``jamba-v0.1-52b`` cut to one 8-layer period
        (7 Mamba layers, attention at layer 4, MoE every other layer, all
        at full width, 13,295,235,072 parameters, bf16; the published 32
        layers need 103 GB), ``serve.prefill`` of 4 x 2048 tokens and
        ``serve.decode`` of 31 greedy steps, through the kernels (7
        ``mamba_scan`` and 1 ``flash_attention`` launches in the prefill,
        none in decode, every other kernel none), init, prefill and decode
        times, idle shares and peak memory; the prefill's last-position
        logits held to the same prefill with ``ops.mamba_scan`` bound to the
        step loop (in this script only, ``plain_mamba``);
     c. a Mamba+MoE and a Mamba+dense layer at full width in float32,
        kernel vs plain: logits within 1e-4 of their scale, 16 greedy
        decode steps equal;
 11. ``swiglu_fused``, the entry point of the fused SwiGLU kernel (no model
     path calls it): the kernel vs ``ref.swiglu_ref`` on the inputs
     widened to float32 at the Jamba dense-FFN prefill shape (m 8192, d
     4096, f 14336) in bf16 and float32 and at a ragged m and f, with
     kernel, plain, bound and library (``layers.swiglu``'s three cuBLAS
     products) times and TFLOP/s, and the bound of the work the design
     executes on the tensor cores (two bf16 pieces of h, or 3xTF32); then
     ``ops.swiglu_fused`` once at that shape;
 12. the multi-tenant scheduler (``fed.multimodel.MultiModelEngine``): three
     tenants of the paper's fleet, ``build_problem(10, 15.0, seed=0)`` with
     2000, 2000 and 6000 samples a round, each the full-width MLP from its
     own init (``mlp.init(seed + i)``), ``multi_model_sweep``'s server knobs
     (alpha 0.6, lr 0.05, poly discount), the deficit split with a 0.1 share
     floor, ``CapacityDrift(seed=0)`` with ``reallocate=True``, horizon 3 x
     15 s:
     a. fedasync, ``run_events`` (through the kernels) twice and ``run``
        (plain torch): every tenant's rows, the split-weight log, the fault
        counters and the ledgers held to the schedule built on the CPU, each
        launch count exact (training and ``accum_flush`` once a group of
        each tenant, one water-filling a bisection step of the CPU build's
        re-solves), the warm run's staging all from the cache and its
        accuracies the first run's bitwise, accuracy within 0.01 of
        ``run``'s; ms per aggregation over all tenants, the re-solves and
        their share of the wall time;
     b. the same, buffered (M = 5), without ``run`` (phase 6c holds the
        buffered grouped path to it; here it would add ~1 min), and the
        device's idle share over a third grouped run (``torch.profiler``);
     c. S = 1 on the card: the engine with one tenant against
        ``AsyncFedEngine.run_events`` on the same problem and seed, rows and
        parameters bitwise, the same launches;
     d. ``kkt_energy`` with three ``build_energy_problem`` tenants under
        phase 7c's budget: every re-solve through the budgeted
        water-filling kernel, rows and ledgers held to the CPU build, no
        dispatch over budget, and in every split allocation each learner's
        joules summed over the tenants within its budget.

 13. the fleet-of-fleets engine (``fed.fleet.FleetEngine``), every fleet on
     one card as a batch axis:
     a. the grouped ``fed_agg`` at 1250 fleets of 8 over the paper MLP's 8
        leaves against its plain version, each group bitwise its one-group
        launch, with kernel, plain, bound and ``torch.bmm`` times; one
        training launch of 10^4 learners (the population's first dispatch)
        bitwise ten launches of 1000, against its plain version, with its
        device split and its bounds;
     b. the F = 1 anchor: ``build_problem(10, 15.0, seed=0)`` as one fleet,
        3 rounds, rows, accuracies and parameters bitwise
        ``Orchestrator.run_fused``'s;
     c. ``build_fleet_problems(1250, 8, T=6, total_samples=60, seed=0)``,
        the paper MLP, participation 0.5, 3 rounds: rows, versions and the
        next dispatch held to a schedule built on the CPU, launches exact
        (one training, one grouped ``fed_agg`` and one merge launch a round,
        the water-fillings of the CPU's solves), ms a round warm, learner-
        rounds a second, the solves' share, the idle share and peak memory;
        at 64 fleets, the accuracy within 0.005 of the plain path's;
     d. ``solve_multimodel`` S = 3 on that population in the eager-rounding
        cases, card vs CPU bitwise; a ``kkt_energy`` round on the population
        with joule budgets, held to the CPU's schedule and launches, no
        dispatch over budget (nor the S = 3 split's sum);
     e. c's population and rounds over ``launch.mesh.host_mesh()`` in a
        one-rank NCCL process group (the merge an ``all_reduce``, the
        solve's rows an ``all_gather``): rows, versions, dispatch, launches
        and every model bitwise c's engine's; ``mesh_devices`` and
        ``fleet_axes`` printed (one card: no multi-card time is measured);
 14. the audio serving path: ``Model(get_config("whisper-small"))`` at full
     width and published depth (12 + 12 layers, d 768, 1500 frames, bf16),
     ``serve.prefill`` of 8 x 64 decoder tokens over the frames and 31
     greedy decode steps, through the kernel (36 launches in the prefill:
     one an encoder layer, non-causal, two a decoder layer, causal and
     cross with Sq != Skv; none in decode), times, idle shares and peak
     memory, the logits held to the plain attention's; then 2 + 2 layers
     at full width in float32 from the same seed on the card and on the
     CPU: logits within 1e-4 of their scale, 4 greedy tokens equal;
     b. the vlm path: InternVL2-76B at full width (d 8192, 64/8 heads, d_ff
        28672) with its depth cut to 2 of 80 layers (80 need ~141 GB in
        bf16), 256 image embeddings ahead of 256 text tokens, batch 4,
        prefill and 31 greedy decode steps from position 512 (2 launches a
        prefill, none in decode), held to the plain attention.
 15. training:
     a. attention's backward kernel (``csrc/flash_attention_bwd.cu``, no TPU
        counterpart) against its plain versions (the written-out
        ``ref.flash_attention_bwd_ref`` and autograd of the dense oracle,
        float32) at Llama-3.2-3B's training shape (bf16 and float32), d 80
        with a window narrower than a tile, Whisper's encoder and cross
        shapes and rows that see no key; bf16 must run the tensor-core
        kernels and float32 the CUDA-core ones (``last_bwd_kernel``);
        timed against the plain backward, its bound (2.5x the forward's
        FLOPs) and SDPA's backward, with the FLOPs it executes and its
        kernels' ptxas registers (15b's profile splits it by pass);
     b. ``launch.steps.build_train`` on Llama-3.2-3B at full width, its
        depth cut to 4 layers (phase 8's weights), bf16, remat, AdamW at
        3e-4, 8 steps of 4 x 2048 tokens from ``token_batches``: losses
        finite and falling, every leaf's gradient nonzero, 8 forward and 4
        backward attention launches a step (the backward's on the tensor
        cores); step ms, tokens/s, the share of
        989 TFLOP/s, peak memory and the device time by kernel;
     c. float32 at 2 layers, one step on the card and one on the CPU from
        the same weights and batch: the loss, every gradient leaf, and the
        card's AdamW step against the CPU's on the same gradients;
     d. the WKV-6 and Mamba-scan backward kernels (``csrc/wkv6_bwd.cu``,
        ``csrc/mamba_scan_bwd.cu``, no TPU counterpart) against both their
        plain versions (the written-out ``ref.wkv6_bwd_ref`` /
        ``ref.mamba_scan_bwd_ref`` and autograd of the step loops) at the
        training shapes (WKV: B 4, S 2048, 64 heads of 64; scan: B 4, S
        2048, D 8192, N 16), bf16 and float32, S = 1001 (ragged against
        the WKV backward's 64-step chunks and the scan's 8-step
        sub-chunks) with a starting state and a final-state gradient, the
        decays "zero" and "one" of 9a and "near1" and "underflow" of 10a,
        and at B 1 a chunk-edge case each (WKV S 129; the scan S 65 at D
        8196, staged element by element): float32 gradients to 1e-4 of
        their scale, bf16 ones to 2^-8; their bits repeat from call to
        call, and WKV's are the same bits from the forward's chunk states;
        WKV's kernels a call as its C entry counts them (a reversed chunk
        run, a row walk and du's sum, and the chunk states' run where the
        forward kept none), and each call's launches by the profiler with
        their times (the scan: its walk and its sums) where its trace holds
        every one of them (it has been seen to drop some);
        kernel (CUDA events; WKV from the forward's chunk states, as 15e
        runs it, and alone, with the forward's cost of keeping them),
        plain and bound times and each kernel's ptxas registers and spills
        (no PyTorch call computes either gradient);
     e. ``launch.steps.build_train`` on RWKV-6 7B cut to 4 of 32 layers
        (phase 9's weights) and on Jamba cut to the period's first 2
        layers, Mamba+MoE and Mamba+dense (phase 10's), as 15b: bf16,
        remat, AdamW at 3e-4 (the step updates the parameters and moments
        in place, as the launcher's does), 4 steps of 4 x 2048 tokens;
        losses finite and falling, every leaf's gradient nonzero, launches
        exact (8 ``wkv6`` and 4 ``wkv6_bwd`` a step; 4 ``mamba_scan`` and
        2 ``mamba_scan_bwd``); step ms, tokens/s, the share of 989 TFLOP/s,
        peak memory and device ms by kernel;
     f. one float32 step of each family's reduced config on the card and
        on the CPU, gated as c.
 16. the dry run and the roofline (``launch.dryrun``, ``roofline``):
     a. the dry run on meta, in process, of llama3-8b train_4k,
        deepseek-moe-16b decode_32k, rwkv6-7b long_500k and jamba-v0.1-52b
        train_4k at full width and depth on the one-rank ``cpu`` mesh: each
        record's FLOPs positive and its dominant term named;
     b. 8b's prefill (28 layers, 4 x 2048, phase 8's weights) and 15b's
        train step (4 layers, the same weights), each counted by
        ``roofline.op_cost`` while its kernels run on the card: the count
        equal, as integers, to the meta count of the same config and shape,
        its kernel entries equal to the wrappers' launch counters; the
        counted FLOPs and bytes, ``model_flops_per_step``, the useful ratio,
        the warm ms of a separate run outside the count and the share of
        the bound (and, for the step, the smoke's own model FLOPs);
     c. each torch twin of the root examples (``examples/torch_*.py``) once
        on the card as a subprocess, all at once, at small sizes: rc 0.

Phases 4, 5c, 6c, 7c-e, 8b, 9b, 10b, 11, 12, 13b-e, 14, 14b, 15b-f and 16b
each set the kernels' launch counters (``wkv6_bwd`` and ``mamba_scan_bwd``
among them) to 0 just before the run they check and read them just after.

It then prints one JSON line describing each kernel and, last, a JSON line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints neither.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.roofline import kernel_cost  # noqa: E402
from repro_torch.roofline.analysis import HW  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W; roofline.analysis.HW):
# FP32 and FP64 outside the tensor cores, HBM3 bandwidth, bf16 and TF32 on
# the tensor cores
PEAK_FP32_FLOPS = HW.fp32_flops
PEAK_FP64_FLOPS = HW.fp64_flops
PEAK_BYTES_PER_S = HW.hbm_bw
PEAK_BF16_FLOPS = HW.peak_flops
PEAK_TF32_FLOPS = HW.tf32_flops
# traces of torch.profiler taken before a kernel's absence counts (see
# device_time_by_kernel)
PROFILE_TRIES = 3

FED_AGG_TOL = 1e-5      # max |kernel - plain| / max(1, max |plain|)
TRAIN_STEP_TOL = 1e-4   # per leaf: max |kernel - plain| / max |plain|
ACC_TOL = 0.005         # |fused - eager| accuracy on 2000 test samples (10 samples)
K, T_CYCLE, TOTAL, SEED, LR = 10, 15.0, 6000, 0, 0.1
CYCLES = 3
# phase 5: the fleet-scale batch, and the waterfill kernel's tolerance
# (absolute, times max(1, |total|)): the kernel rounds every operation and
# sums in the plain version's order, so it should agree to the last bits
FLEET_K, FLEET_B = 8, 131_072
WATERFILL_TOL = {"float64": 1e-12, "float32": 1e-5}
TIE_SHARE = 1e-3        # fleets allowed to differ card vs CPU by a remainder tie
# phase 6: the accum_flush kernel rounds as its plain version does and sums
# in the same order, so it is held like fed_agg; the async runs' accuracy
# after 30 sequential float32 mixes, grouped vs eager
ACCUM_FLUSH_TOL = 1e-5  # max |kernel - plain| / max(1, max |plain|)
ASYNC_ACC_TOL = 0.01    # |grouped - eager| accuracy on 2000 test samples (20 samples)
# a full group step at paper width is held to one GD step's parity
# (TRAIN_STEP_TOL) and, over all its steps, to float32's own spread: the
# kernel may sit at most this factor further from float64 than the plain
# float32 version does
FLOAT32_SPREAD = 1.5
ASYNC_MODES = {"fedasync": {}, "buffered": {"buffer_size": 5}}
# phase 7: the budget is this share of the blind kkt_sai allocation's median
# per-learner spend (energy_sweep's anchor); the churn run's Markov chain
BUDGET_FRAC = 0.75
CHURN_P_DROP = 0.2
PGD_RESOLVES = 3
# phase 8: the serve's shapes and the attention kernel's tolerances. The
# kernel and its plain versions all compute in float32 and add in other
# orders, so float32 is held to 1e-5 of max(1, max |plain|); in bf16 the
# only rounding that differs is the output's, one bf16 step (2^-8), so 1e-2.
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "llama3.2-3b", 4, 2048, 32
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the bf16 serve, kernel vs plain: last-position logits, of max |plain|.
# Each layer's attention output may round to the neighbouring bf16 value
# in one and not the other (2^-8 relative), and 28 layers of bf16 compute
# carry that into the logits
SERVE_BF16_TOL = 5e-2
# the float32 gate (2 layers): the attention outputs agree to ~1e-6, and
# the float32 layers around them carry that into the logits
E2E_LAYERS, E2E_STEPS, E2E_TOL = 2, 16, 1e-4
# the dense oracle's (B, Sq, KV, G, Skv) float32 scores up to this size;
# beyond it the plain version is the chunked scan
DENSE_REF_BYTES = 4e9
# phase 14: the Whisper-small serve at full width and published depth (12 +
# 12 layers, 1500 frames), a batch of 64-token decoder prompts
WHISPER_ARCH, WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN = "whisper-small", 8, 64, 32
# its float32 gate, card vs CPU: 2 + 2 layers at full width (the reduced
# config's head dim, 32, is not one the kernel takes), the prefill's logits
# held like phase 8c's and this many greedy tokens equal
WHISPER_E2E_LAYERS, WHISPER_E2E_BATCH, WHISPER_E2E_STEPS = 2, 2, 4
# phase 14b: InternVL2-76B's vlm path at full width, its depth cut to 2 of
# 80 layers (80 need ~150 GB in bf16, the card holds 80), 256 image tokens
# ahead of a 256-token text prompt
VLM_ARCH, VLM_LAYERS, VLM_BATCH, VLM_PROMPT, VLM_GEN = "internvl2-76b", 2, 4, 256, 32
VLM_IMAGE_TOKENS = 256  # the config's num_image_tokens; 14b checks it
# phase 16: the dry run's pairs (the reference's own dry-run test's), and the
# twins of the root examples with the arguments that keep them small
DRYRUN_PAIRS = [("llama3-8b", "train_4k"), ("deepseek-moe-16b", "decode_32k"),
                ("rwkv6-7b", "long_500k"), ("jamba-v0.1-52b", "train_4k")]
TWIN_RUNS = [("quickstart", []), ("allocate_pods", []),
             ("train_mnist_fed", ["--cycles", "2"]),
             ("async_fleet", ["--cycles", "2", "--bucketed"]),
             ("realloc_drift", ["--k", "5", "--cycles", "4", "--train"]),
             ("serve_batch", ["--arch", "llama3-8b"])]
TWIN_TIMEOUT_S = 300
# phase 8a: name, B, S (of the queries), heads, kv heads, d, dtype, causal,
# window, timed calls, and Skv where it is not S; the first is the dense
# serve's prefill and gives the kernels line its row
FLASH_CASES = [
    ("llama3.2-3b prefill", SERVE_BATCH, SERVE_PROMPT, 24, 8, 128, "bfloat16", True, None, 10),
    ("llama3.2-3b prefill", SERVE_BATCH, SERVE_PROMPT, 24, 8, 128, "float32", True, None, 5),
    ("ragged", SERVE_BATCH, 1000, 24, 8, 128, "bfloat16", True, None, 10),
    ("h2o-danube-1.8b prefill", 1, 8192, 32, 8, 80, "bfloat16", True, 4096, 5),
    ("whisper-small encoder", WHISPER_BATCH, 1500, 12, 12, 64, "bfloat16", False, None, 10),
    ("whisper-small encoder", WHISPER_BATCH, 1500, 12, 12, 64, "float32", False, None, 5),
    ("whisper-small cross", WHISPER_BATCH, WHISPER_PROMPT, 12, 12, 64, "bfloat16", False, None,
     10, 1500),
    ("whisper-small cross", WHISPER_BATCH, WHISPER_PROMPT, 12, 12, 64, "float32", False, None,
     10, 1500),
    ("whisper-small decoder self", WHISPER_BATCH, WHISPER_PROMPT, 12, 12, 64, "bfloat16", True,
     None, 10),
    ("whisper-small decoder self", WHISPER_BATCH, WHISPER_PROMPT, 12, 12, 64, "float32", True,
     None, 10),
    ("internvl2-76b prefill", VLM_BATCH, VLM_IMAGE_TOKENS + VLM_PROMPT, 64, 8, 128, "bfloat16",
     True, None, 10),
    ("internvl2-76b prefill", VLM_BATCH, VLM_IMAGE_TOKENS + VLM_PROMPT, 64, 8, 128, "float32",
     True, None, 10),
]
# phase 15: training. Llama-3.2-3B at full width with its depth cut to
# TRAIN_LAYERS (phase 8's weights), bf16 parameters, AdamW at the config's
# 3e-4, remat on, TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens from
# token_batches. 15c: TRAIN_F32_LAYERS in float32, one step on the card and
# one on the CPU (B x S small enough for the CPU's step).
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "llama3.2-3b", 4, 4, 2048, 8
TRAIN_F32_LAYERS, TRAIN_F32_BATCH, TRAIN_F32_SEQ = 2, 1, 256
# the loss of one float32 step, card vs CPU (relative), and each gradient
# leaf (of its scale): the same arithmetic in other orders; a leaf's
# gradient sums over every position of the batch
TRAIN_F32_LOSS_TOL, TRAIN_F32_GRAD_TOL = 1e-5, 1e-4
# the parameters after the card's AdamW step against the CPU's AdamW step
# from the card's own clipped gradients (of their scale): elementwise
# float32 on both sides. The card's and the CPU's steps are compared
# through their gradients: Adam's first step divides a gradient by its own
# size plus eps (1e-8), so where a gradient is near eps a rounding of it
# moves its parameter by a share of the learning rate (the direct distance
# is printed)
TRAIN_F32_STEP_TOL = 1e-5
# 15a: attention's backward kernel against its plain versions: float32 to
# 1e-4 of a gradient's scale (dk and dv sum G x Sq terms in another
# order), bf16 to 1e-2 (one bf16 step of the outputs, and D taken from the
# forward's bf16 output); a scale is at least 1e-3 max|dO| max|v|, the
# size of dP and D whose difference dS is. The two plain versions (the
# written-out backward and autograd of the dense oracle, both float32)
# agree to 1e-5.
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
BWD_PLAIN_TOL = 1e-5
# name, B, Sq, heads, kv heads, d, dtype, causal, window, Skv (None: Sq),
# timed calls; the first is the training shape and gives the kernels line
# its row
BWD_CASES = [
    ("llama3.2-3b train", TRAIN_BATCH, TRAIN_SEQ, 24, 8, 128, "bfloat16", True, None, None, 3),
    ("llama3.2-3b train", TRAIN_BATCH, TRAIN_SEQ, 24, 8, 128, "float32", True, None, None, 2),
    ("d80, window 40", 1, 2048, 32, 8, 80, "bfloat16", True, 40, None, 3),
    ("whisper-small encoder", WHISPER_BATCH, 1500, 12, 12, 64, "bfloat16", False, None, None,
     3),
    ("whisper-small cross", WHISPER_BATCH, WHISPER_PROMPT, 12, 12, 64, "bfloat16", False, None,
     1500, 3),
    ("fully masked rows", 2, 300, 4, 1, 64, "float32", True, 8, 100, 3),
]
# 15d: the WKV-6 and Mamba-scan backward kernels against their two plain
# versions (the written-out backward and autograd of the step loop, both
# float32), at the training shapes and edge cases. A gradient returned in
# float32 to 1e-4 of its scale, one returned in bf16 to one bf16 step
# (2^-8); a scale is at least 1e-3 max |dy|
SSM_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-8}
# name, B, S, heads, head dim, r/k/v dtype, with s0, with ds_last, decays
# (as 9a's), timed calls; the first is the training shape (bf16, no state,
# as the 15e step runs it) and gives the kernels line its row
WKV_BWD_CASES = [
    ("rwkv6-7b train", TRAIN_BATCH, TRAIN_SEQ, 64, 64, "bfloat16", False, False, "", 5),
    ("rwkv6-7b train", TRAIN_BATCH, TRAIN_SEQ, 64, 64, "float32", False, False, "", 3),
    ("ragged, state", TRAIN_BATCH, 1001, 64, 64, "bfloat16", True, True, "", 3),
    ("decay zero", TRAIN_BATCH, 1001, 64, 64, "float32", True, True, "zero", 3),
    ("decay near 1", TRAIN_BATCH, 1001, 64, 64, "float32", True, True, "one", 3),
    ("chunk edges", 1, 129, 64, 64, "bfloat16", True, True, "zero", 3),
]
# name, B, S, d_inner, d_state, x dtype, with h0, with dh_last, decays (as
# 10a's), timed calls; the first is the training shape
MAMBA_BWD_CASES = [
    ("jamba train", TRAIN_BATCH, TRAIN_SEQ, 8192, 16, "bfloat16", False, False, "", 5),
    ("jamba train", TRAIN_BATCH, TRAIN_SEQ, 8192, 16, "float32", False, False, "", 3),
    ("ragged, state", TRAIN_BATCH, 1001, 8192, 16, "bfloat16", True, True, "", 3),
    ("decays near 1", TRAIN_BATCH, TRAIN_SEQ, 8192, 16, "float32", False, False, "near1", 3),
    ("underflowing decays", TRAIN_BATCH, 1001, 8192, 16, "bfloat16", True, True, "underflow",
     3),
    ("sub-chunk edges, D 8196", 1, 65, 8196, 16, "float32", True, True, "", 3),
]
# 15e: RWKV-6 7B and Jamba at full width, their depth cut (phase 9's and 10's
# weights), trained as 15b's Llama: bf16, remat, AdamW at 3e-4,
# SSM_TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens
RWKV_TRAIN_LAYERS, JAMBA_TRAIN_LAYERS, SSM_TRAIN_STEPS = 4, 2, 4
# 15f: one float32 step of each family's reduced config, card vs CPU, gated
# as 15c
SSM_F32_BATCH, SSM_F32_SEQ = 2, 256
# phase 9: the RWKV-6 serve at the dense serve's batch and lengths. The WKV
# kernel and the step loop take every product in float32 from the same
# inputs and sum over i in other orders; the output is float32 for bf16
# inputs too, so both are held to 1e-5 of max(1, max |plain|)
RWKV_ARCH = "rwkv6-7b"
WKV_TOL = 1e-5
# phase 9a: name, B, S, heads, head dim, r/k/v dtype, with s0, state written
# over s0, decays, timed calls; the first is the serve's prefill and gives
# the kernels line its row. S from wkv6.CHUNKED_MIN_SEQ on runs the chunk
# kernel, shorter the step kernel. Decays: "" as the model makes them,
# "zero" some channels' w = 0 (exp(-exp(raw)) underflows for raw >~ 4.5),
# "one" some within 1e-7 of 1. Each case is held to the float32 step loop
# ref.wkv6_ref, except "one" at 1000 steps: there the float32 step loop
# itself drifts ~1e-5 of the scale from the exact recurrence (its w S,
# with w = 1 - 2^-24, rounds the same way every step, and the state grows),
# so that case is held to a float64 step loop, with the float32 loop's own
# distance from it printed beside the kernel's
WKV_CASES = [
    ("rwkv6-7b prefill", SERVE_BATCH, SERVE_PROMPT, 64, 64, "bfloat16", False, False, "", 10),
    ("rwkv6-7b prefill", SERVE_BATCH, SERVE_PROMPT, 64, 64, "float32", False, False, "", 10),
    ("ragged", SERVE_BATCH, 1000, 64, 64, "bfloat16", True, False, "", 10),
    ("strong decay", SERVE_BATCH, 1000, 64, 64, "bfloat16", True, True, "zero", 10),
    ("strong decay", SERVE_BATCH, 1000, 64, 64, "float32", True, False, "zero", 10),
    ("decay near 1", SERVE_BATCH, 300, 64, 64, "bfloat16", True, False, "one", 10),
    ("decay near 1", SERVE_BATCH, 1000, 64, 64, "float32", True, False, "one", 10),
    ("rwkv6-7b decode step", SERVE_BATCH, 1, 64, 64, "bfloat16", True, True, "", 200),
    ("rwkv6-7b decode step", SERVE_BATCH, 1, 64, 64, "float32", True, True, "", 200),
]
# phase 10: the Jamba serve, one 8-layer period of jamba-v0.1-52b at full
# width (the published 32 layers need 103 GB in bf16, more than the card's
# 80), at the dense serve's batch and lengths. The scan kernel and the step
# loop take every product in float32 from the same inputs and sum over n in
# other orders, so both are held to 1e-5 of max(1, max |plain|)
JAMBA_ARCH, JAMBA_LAYERS = "jamba-v0.1-52b", 8
MAMBA_TOL = 1e-5
# decays near 1 with a state: each decay's error has one sign step after
# step and adds up in the state, and the float32 step loop itself drifts
# past MAMBA_TOL from the exact recurrence; such a case is held to a
# float64 step loop within this share of max(1, scale), the card tests'
# limit (tests/test_torch_cuda.py, set from the card's readings)
MAMBA_NEAR_ONE_TOL = 1e-4
# phase 10a: name, B, S, d_inner, d_state, x dtype, with h0, state written
# over h0, decays, timed calls; the first is the serve's prefill and gives
# the kernels line its row. Decays: "near1" makes dt 1e-5..1e-4 and a
# -1e-3..-1e-2 (every decay within 1e-6 of 1; with h0, held to a float64
# step loop), "underflow" sets every third channel's dt to 6..20 (dt a <
# -90 from the 16th state on)
MAMBA_CASES = [
    ("jamba prefill", SERVE_BATCH, SERVE_PROMPT, 8192, 16, "bfloat16", False, False, "", 10),
    ("jamba prefill", SERVE_BATCH, SERVE_PROMPT, 8192, 16, "float32", False, False, "", 10),
    ("ragged", SERVE_BATCH, 1000, 8192, 16, "bfloat16", True, False, "", 10),
    ("ragged, state in place", SERVE_BATCH, 1000, 8192, 16, "float32", True, True, "", 10),
    ("decays near 1", SERVE_BATCH, SERVE_PROMPT, 8192, 16, "bfloat16", False, False, "near1",
     10),
    ("decays near 1", SERVE_BATCH, SERVE_PROMPT, 8192, 16, "float32", False, False, "near1", 3),
    ("decays near 1, state", SERVE_BATCH, SERVE_PROMPT, 8192, 16, "float32", True, False,
     "near1", 3),
    ("underflowing decays", SERVE_BATCH, 1000, 8192, 16, "bfloat16", True, False, "underflow",
     3),
]
# phase 11: the fused SwiGLU at Jamba's dense-FFN prefill shape (m = 4 x
# 2048 tokens, d 4096, f 14336). The kernel takes its products in float32
# from the widened inputs and returns x's dtype; it is held to
# ref.swiglu_ref on the widened inputs: float32 to 1e-5 of max(1, max
# |plain|) (sums over 4096 and 14336 terms in another order), a bf16 output
# to one bf16 step (2^-8) of it. Name, m, d, f, dtype, timed calls
SWIGLU_TOL = {"float32": 1e-5, "bfloat16": 2.0**-8}
SWIGLU_CASES = [
    ("jamba dense ffn prefill", SERVE_BATCH * SERVE_PROMPT, 4096, 14336, "bfloat16", 3),
    ("jamba dense ffn prefill", SERVE_BATCH * SERVE_PROMPT, 4096, 14336, "float32", 2),
    ("ragged", 1000, 4096, 14000, "bfloat16", 3),
]


# phase 12: three tenants of the paper's fleet, multimodel_bench's (200,
# 200, 600) x 10 samples a round (the laggard carries the paper's 6000), and
# multi_model_sweep's knobs
MM_TOTALS = (2000, 2000, 6000)
MM_SHARE_FLOOR = 0.1
MM_LR = 0.05
# phase 13: the fleet of fleets. build_fleet_problems' population (K = 8,
# T = 6 s, 60 samples a fleet) at 1250 fleets is 10^4 learners a round, the
# reference's acceptance point (benchmarks/fleet_scale.py), with the paper
# MLP; fleet_scale_sweep's participation; 64 fleets for the accuracy gate
# against the plain path; the split cases where the reference's eager
# floored share differs from a fused one (tests/test_torch_fleet.py)
POP_F, POP_K, POP_T, POP_TOTAL = 1250, 8, 6.0, 60
POP_PARTICIPATION, POP_ROUNDS, POP_SMALL_F = 0.5, 3, 64
# the engine's default lr (0.1) is set for fleet_scale_sweep's [64, 32, 10]
# model; the paper MLP on 3-15 samples a learner and up to 44 steps
# diverges to NaN there within a round (and at 0.05), so the population
# trains at 0.01
POP_LR = 0.01
POP_CHUNK = 1000        # 13a: learners a launch of the ten-launch comparison
# 13a: the training kernel at 10^4 learners against its plain version, per
# leaf of max |plain|, after up to 44 float32 GD steps, where a ReLU input
# near 0 may take the other side in either (tests/test_torch_slice.py holds
# the paper run to 2e-2 for that reason; phase 3 holds one step to 1e-4)
POP_TRAIN_TOL = 1e-2
POP_ACC_TOL = 0.005     # F = 64, kernels vs plain, on 2000 test samples
# F = 64 after 3 rounds, kernels vs plain: the global and fleet models, per
# leaf of max |plain| (the training kernel's float32 sums in other orders
# than autograd's). Read on the H100: 6.3e-6 (global) and 6.5e-5 (fleets);
# every leaf's training moves it by far more (printed beside)
POP_MODEL_TOL = 1e-3
POP_FMA_CASES = [((3.0, 1.0, 0.0), 0.1), ((4.0, 1.0, 2.0), 0.1), ((0.0, 4.0, 3.0), 0.1),
                 ((0.0, 1.0, 3.0), 0.1)]


# each source's nvcc output of this run's build (phase 1)
BUILD_LOGS: dict[str, str] = {}


def ptxas_entries(log: str) -> list[tuple[str, str]]:
    """(kernel, ptxas line) for every register and spill line of a build
    log, each kernel named from its mangled entry as namespace::name<args>."""
    out, entry = [], "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1] if "'" in line else line
            m = re.search(r"(\d+)(tc|cc)(\d+)(\w+?)I((?:Li\d+E)+)", mangled)
            if m:
                args = ", ".join(re.findall(r"Li(\d+)E", m.group(5)))
                entry = f"{m.group(2)}::{m.group(4)}<{args}>"
            else:  # a kernel templated on its element type (and sizes)
                names = [(g.group(2), g.end(2)) for g in
                         re.finditer(r"(?=(\d+)([a-z_][a-z0-9_]*_kernel)I)", mangled)
                         if int(g.group(1)) == len(g.group(2))]
                kind = "bf16" if "bfloat16" in mangled else "float"
                if names:
                    name, end = names[0]
                    sizes = [v if k == "i" else ("true" if v == "1" else "false") for k, v in
                             re.findall(r"L([ib])(\d+)E", mangled[end:].split("EEv")[0])]
                    entry = f"{name}<{', '.join([kind] + sizes)}>"
                else:
                    entry = mangled
        elif "registers" in line or "spill" in line:
            out.append((entry, line.strip()))
    return out


def ptxas_of(lib: str, entry: str) -> str:
    """The ptxas lines (registers, spills) of ``entry`` in ``lib``'s build
    log, as ``ptxas_entries`` names it."""
    lines = [line for name, line in ptxas_entries(BUILD_LOGS.get(lib, "")) if name == entry]
    return "; ".join(lines) or "not in this run's build log"


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up,
    from CUDA events on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_by_kernel(fn, expect: str | tuple[str, ...] | None = None
                          ) -> list[tuple[str, float, int]]:
    """(kernel, device ms, launches) for one call of ``fn``, most time
    first, from ``torch.profiler``; empty if the profiler saw no device time.

    With ``expect`` (a name, or several), a trace that lacks a kernel whose
    name contains one of them is taken again (``fn`` called again), up to
    ``PROFILE_TRIES`` traces in all: on the card's machine the profiler has
    been seen to drop most of a trace's kernel records, the training
    kernel's among them, in runs whose results showed the kernels ran. A
    kernel that does not run stays absent from every trace, and the
    caller's check fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0)
            if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                rows.append((ev.key, us / 1e3, ev.count))
        rows.sort(key=lambda r: -r[1])
        wanted = (expect,) if isinstance(expect, str) else expect or ()
        if all(any(name in key for key, _, _ in rows) for name in wanted):
            break
        print(f"torch.profiler: trace {attempt} of at most {PROFILE_TRIES} holds no {expect} "
              f"launch ({len(rows)} kernels recorded)")
    return rows


def kernel_device_ms(fn, name: str, calls: int) -> float:
    """Device time a launch of the kernel whose name contains ``name``,
    from ``torch.profiler`` over ``calls`` calls of ``fn``; fails when the
    profiler sees no such kernel."""
    rows = device_time_by_kernel(lambda: [fn() for _ in range(calls)], expect=name)
    hits = [(ms, n) for key, ms, n in rows if name in key]
    require(bool(hits), f"torch.profiler saw no {name} launches")
    return sum(ms for ms, _ in hits) / sum(n for _, n in hits)


def training_launches(breakdown) -> int:
    """Launches of the persistent training kernel in a ``device_time_by_kernel``
    breakdown."""
    return sum(calls for name, _, calls in breakdown if "train_steps_kernel" in name)


def leaf_errors(got, want) -> tuple[float, float]:
    """(max abs error, max over leaves of max abs error / max |plain|)."""
    abs_err, rel_err = 0.0, 0.0
    for g_layer, w_layer in zip(got, want):
        for name in w_layer:
            g, w = g_layer[name].double(), w_layer[name].double()
            e = (g - w).abs().max().item()
            abs_err = max(abs_err, e)
            rel_err = max(rel_err, e / max(w.abs().max().item(), 1e-30))
    return abs_err, rel_err


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


class CallCounter:
    """Counts the calls of ``ops.<name>`` while it is entered: on the CPU
    these are the plain version's calls, one for each launch the card's
    run of the same schedule makes."""

    def __init__(self, name: str):
        from repro_torch.kernels import ops

        self.ops, self.name, self.calls = ops, name, 0

    def __enter__(self):
        self.fn = getattr(self.ops, self.name)

        def counted(*args):
            self.calls += 1
            return self.fn(*args)

        setattr(self.ops, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.fn)


def reset_launches() -> None:
    from repro_torch.kernels import (accum_flush, fed_agg, flash_attention, mamba_scan,
                                     swiglu, train_step, waterfill, wkv6)

    waterfill.launches = waterfill.energy_launches = 0
    train_step.launches = fed_agg.launches = accum_flush.launches = 0
    flash_attention.launches = flash_attention.bwd_launches = wkv6.launches = 0
    wkv6.bwd_launches = mamba_scan.launches = mamba_scan.bwd_launches = swiglu.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import (accum_flush, fed_agg, flash_attention, mamba_scan,
                                     swiglu, train_step, waterfill, wkv6)

    return {"train_agg_step": train_step.launches, "accum_flush": accum_flush.launches,
            "fed_agg": fed_agg.launches, "waterfill_residual": waterfill.launches,
            "waterfill_energy_residual": waterfill.energy_launches,
            "flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention.bwd_launches, "wkv6": wkv6.launches,
            "wkv6_bwd": wkv6.bwd_launches, "mamba_scan": mamba_scan.launches,
            "mamba_scan_bwd": mamba_scan.bwd_launches, "swiglu": swiglu.launches}


def cpu_schedule(train, horizon: float, prob, cfg, drift, counted: str) -> dict:
    """The async engine's schedule built on the CPU with the engine's rng
    discipline: flush rows, groups, counters, ledger, block masks, and the
    calls of ``ops.<counted>`` its re-solves made."""
    from repro_torch.data.pipeline import FederatedPartitioner
    from repro_torch.fed import async_engine as ae
    from repro_torch.models import mlp

    eng = ae.AsyncFedEngine(cfg, prob, mlp.loss, mlp.init(SEED, device="cpu"), seed=SEED,
                            drift=drift)
    part = FederatedPartitioner(train, seed=int(eng.rng.integers(2**31)))
    with CallCounter(counted) as count:
        sched = eng._build_schedule(part, horizon, 100_000)
    rows, group = [], []
    for a in sched.arrivals:
        if a.flush_id >= 0:
            group.append(a)
            if a.flush:
                rows.append(ae._flush_row(a, group, cfg.mode))
                group = []
    return {"rows": rows, "groups": ae._event_segments(sched.arrivals), "sched": sched,
            "solves": count.calls, "masks": eng._block_masks,
            "blocks": sorted(eng._alloc_cache)}


def check_rows(hist, want_rows, what: str) -> None:
    import numpy as np

    require(len(hist) == len(want_rows), f"{what}: {len(hist)} aggregations, the CPU "
            f"schedule has {len(want_rows)}")
    for i, (r, w) in enumerate(zip(hist, want_rows)):
        for name in w:
            require(np.array_equal(np.asarray(r[name]), np.asarray(w[name])),
                    f"{what}: row {i} column {name} differs from the CPU schedule's")


def count_phase(dev, tag, cfg, shape, params, args, want: dict, smoke_flops=None) -> None:
    """Phase 16b, one step: ``launch.dryrun``'s step of ``cfg`` at ``shape``
    run once on the card under ``roofline.op_cost``'s count (the kernels
    launching), held equal, as integers, to the meta count of the same
    config and shape, its kernel entries to the wrappers' launch counters
    (``want``, every other kernel 0); then timed outside the count (host
    clock, warm, the median of 3). Prints the counts, ``model_flops_per_step``,
    the useful ratio, the ms and the share of the bound (``smoke_flops``,
    (FLOPs, active matrix parameters): the smoke's own model FLOPs)."""
    import statistics

    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_by_name
    from repro_torch.models.model import Model
    from repro_torch.roofline import op_cost
    from repro_torch.roofline.analysis import model_flops_per_step, roofline_terms

    mesh = make_mesh_by_name("cpu")
    rules = dryrun.RULE_SETS["train" if shape.kind == "train" else "serve"]
    step = dryrun.build_step(Model(cfg, device=dev), shape, mesh, rules)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    cost, builtin, out = op_cost.analyze_with_builtin(step, params, *args)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = read_launches()
    del out
    meta_model = Model(cfg, device="meta")
    margs, mparams = dryrun.step_inputs(meta_model, shape, "meta")
    t0 = time.perf_counter()
    meta, _, _ = op_cost.analyze_with_builtin(dryrun.build_step(meta_model, shape, mesh, rules),
                                              mparams, *margs)
    meta_s = time.perf_counter() - t0
    same = ((cost.flops, cost.bytes, cost.ops, cost.by_class, cost.kernels)
            == (meta.flops, meta.bytes, meta.ops, meta.by_class, meta.kernels))
    if not same:
        for key in sorted(set(cost.op_calls) | set(meta.op_calls)):
            if cost.op_calls.get(key) != meta.op_calls.get(key):
                print(f"{tag}: {key} card {cost.op_calls.get(key)} meta {meta.op_calls.get(key)}")
        print(f"{tag}: by class card {cost.by_class} meta {meta.by_class}; kernels card "
              f"{cost.kernels} meta {meta.kernels}")
    require(same, f"{tag}: the card's count ({cost.flops} FLOPs, {cost.bytes} bytes, "
            f"{cost.ops} ops) is not the meta count ({meta.flops}, {meta.bytes}, {meta.ops})")
    entries = {name: e["calls"] for name, e in cost.kernels.items()}
    require(launches == {**{name: 0 for name in launches}, **want} and entries == want,
            f"{tag}: kernel entries {entries}, launches {launches}, want {want}")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, *args)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        del out
    warm_ms = statistics.median(times)
    terms = roofline_terms(cost.flops, cost.bytes, cost.collectives)
    bound_s = max(terms["compute_s"], terms["memory_s"])
    mf = model_flops_per_step(cfg, shape, 1)
    print(f"{tag} {cfg.name} ({cfg.num_layers} layers) {shape.global_batch} x {shape.seq_len}: "
          f"counted {cost.flops} FLOPs, {cost.bytes} bytes, {cost.ops} aten ops (dot "
          f"{cost.by_class['dot']['flops']:.4g}, elementwise "
          f"{cost.by_class['elementwise']['flops']:.4g}, transcendental "
          f"{cost.by_class['transcendental']['flops']:.4g}, kernels "
          f"{cost.by_class['kernel']['flops']:.4g} FLOPs; {entries}), equal to the meta "
          f"count ({meta_s:.1f} s) and to the launch counters; FlopCounterMode "
          f"{builtin:.4g} (no kernels); model_flops_per_step {mf:.4g}, useful ratio "
          f"{mf / cost.flops:.3f}; bound {1e3 * bound_s:.2f} ms ({terms['dominant']}); "
          f"warm {warm_ms:.1f} ms (host clock, median of {times}; the counted run "
          f"{1e3 * counted_s:.1f} ms), {bound_s / (warm_ms * 1e-3):.3f} of the bound")
    if smoke_flops is not None:
        flops, active = smoke_flops
        total, act = cfg.param_counts()
        print(f"{tag}: the smoke's model FLOPs {flops:.4g} (6 x {active} active matrix "
              f"params x tokens + 3 x the attention's 4 B H d pairs a layer) against "
              f"model_flops_per_step {mf:.4g} (6 x param_counts' {act} active x tokens): "
              f"the difference {mf - flops:.4g} is the embedding's {act - active} "
              f"parameters, which param_counts counts and a lookup does not multiply, less "
              f"the attention's scores, which param_counts does not count")


def dryrun_phase() -> None:
    """Phase 16a: the dry run on meta of ``DRYRUN_PAIRS`` in process."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "artifacts", "dryrun_torch")
    for arch, shape in DRYRUN_PAIRS:
        rec = dryrun.run_one(arch, shape, "cpu", out_dir=out_dir)
        require(rec["flops_per_device"] > 0 and rec["roofline"]["dominant"] in
                ("compute", "memory", "collective"), f"16a: {arch} {shape} counted "
                f"{rec['flops_per_device']} FLOPs, dominant {rec['roofline']['dominant']}")
        print(f"16a dryrun {arch} {shape}: {rec['flops_per_device']:.4g} FLOPs, "
              f"{rec['bytes_per_device']:.4g} bytes, {rec['aten_ops']} aten ops, kernels "
              f"{ {k: v['calls'] for k, v in rec['kernels'].items()} }, dominant "
              f"{rec['roofline']['dominant']}, useful ratio {rec['useful_flops_ratio']:.3f}, "
              f"{rec['trace_s']} s on meta")
    print(f"16a: {time.perf_counter() - t0:.1f} s")


def twins_phase() -> None:
    """Phase 16c: every torch twin of the root examples on the card, each
    a subprocess, all started together."""
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", f"torch_{name}.py"), *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, args in TWIN_RUNS}
    failed = []
    for name, proc in procs.items():
        try:
            out = proc.communicate(timeout=TWIN_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            out = proc.communicate()[0]
        last = [line for line in out.strip().splitlines() if line.strip()][-1:]
        print(f"16c torch_{name}.py {' '.join(dict(TWIN_RUNS)[name])}: rc {proc.returncode}; "
              f"{last[0][:160] if last else ''}")
        if proc.returncode != 0:
            failed.append(name)
            print(out[-3000:])
    require(not failed, f"16c: twins failed on the card: {failed}")
    print(f"16c: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1

    import numpy as np

    from repro_torch.core import solve_kkt_sai, staleness_weights
    from repro_torch.data.pipeline import FederatedPartitioner, synthetic_mnist
    from repro_torch.fed.orchestrator import _broadcast, _stage_shards
    from repro_torch.fed.simulation import build_problem, run_experiment
    from repro_torch.kernels import _build, fed_agg, ref, train_step
    from repro_torch.models import mlp

    # the plain versions' matrix products stay in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. card and build ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    logs = _build.build_all()
    BUILD_LOGS.update(logs)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s for {', '.join(_build.SOURCES)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- 2. fed_agg at the paper model's leaf shapes ----------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    widths = mlp.PAPER_LAYERS
    shapes = []
    for fi, fo in zip(widths[:-1], widths[1:]):
        shapes += [(K, fi, fo), (K, fo)]
    leaves = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    wts = torch.softmax(torch.randn(K, generator=gen, device=dev), 0)
    # every leaf in one launch: each leaf bitwise the single-leaf launch's,
    # and within FED_AGG_TOL of the plain version
    fa_err = 0.0
    for leaf, got in zip(leaves, fed_agg.fed_agg_leaves_cuda(leaves, wts)):
        require(torch.equal(got, fed_agg.fed_agg_cuda(leaf, wts)),
                "the all-leaf fed_agg launch differs from the single-leaf launch")
        want = ref.fed_agg_ref(leaf, wts)
        err = (got - want).abs().max().item()
        require(err <= FED_AGG_TOL * max(1.0, want.abs().max().item()),
                f"fed_agg kernel differs from its plain version by {err:g}")
        fa_err = max(fa_err, err)
    fa_ms = cuda_ms(lambda: fed_agg.fed_agg_leaves_cuda(leaves, wts), 200)
    fa_dev_ms = kernel_device_ms(lambda: fed_agg.fed_agg_leaves_cuda(leaves, wts),
                                 "fed_agg_kernel", 20)
    fa_leaf_ms = cuda_ms(lambda: [fed_agg.fed_agg_cuda(x, wts) for x in leaves], 200)
    fa_plain_ms = cuda_ms(lambda: [ref.fed_agg_ref(x, wts) for x in leaves], 200)
    fa_lib_ms = cuda_ms(lambda: [torch.tensordot(wts, x, dims=1) for x in leaves], 200)
    n_params = sum(math.prod(s[1:]) for s in shapes)
    fa_flops, fa_bytes = kernel_cost.fed_agg_leaves([math.prod(s[1:]) for s in shapes], K)
    fa_bound_ms = 1e3 * max(fa_bytes / PEAK_BYTES_PER_S, fa_flops / PEAK_FP32_FLOPS)
    print(f"fed_agg: {len(shapes)} leaves, {n_params} params, max_abs_err "
          f"{fa_err:.3g}; one launch for all leaves {fa_ms:.4f} ms ({fa_dev_ms:.4f} ms of "
          f"device time, torch.profiler), one launch a leaf {fa_leaf_ms:.4f} ms, plain "
          f"{fa_plain_ms:.4f} ms, {len(shapes)} tensordot {fa_lib_ms:.4f} ms, bound "
          f"{fa_bound_ms:.4f} ms (bytes); all-leaf launch "
          f"{'below' if fa_ms < fa_lib_ms else 'NOT below'} the tensordots")

    # -- 3. train_agg_step for one cycle at full width --------------------------
    prob = build_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    alloc = solve_kkt_sai(prob)
    tau, d = np.asarray(alloc.tau), np.asarray(alloc.d)
    train, test = synthetic_mnist(max(2 * TOTAL, 12_000), seed=SEED)
    shards = FederatedPartitioner(train, seed=SEED).draw(d)
    x, y, m = (torch.from_numpy(a).to(dev)
               for a in _stage_shards(shards, int(d.max()), train.x.shape[1]))
    tau_t = torch.as_tensor(tau, dtype=torch.int32, device=dev)
    w_t = torch.as_tensor(staleness_weights(tau, d), dtype=torch.float32, device=dev)
    disp = _broadcast(mlp.init(SEED, device=dev), K)
    max_tau = int(tau.max())
    print(f"train_agg_step: x {tuple(x.shape)}, tau {tau.tolist()}, d {d.tolist()}")
    got, _ = train_step.train_agg_step_cuda(disp, x, y, m, tau_t, w_t, LR, max_tau=max_tau)
    want, _ = ref.train_agg_step_ref(disp, x, y, m, tau_t, w_t, LR, max_tau=max_tau)
    torch.cuda.synchronize()
    ts_abs, ts_rel = leaf_errors(got, want)
    require(all(torch.isfinite(t).all().item() for layer in got for t in layer.values()),
            "train_agg_step kernel gave non-finite params")
    require(ts_rel <= TRAIN_STEP_TOL,
            f"train_agg_step kernel differs from its plain version: {ts_rel:g} relative")
    # float32's own spread: both float32 versions against the plain version
    # in float64, after one step and after the whole cycle
    disp64 = [{n: leaf.double() for n, leaf in layer.items()} for layer in disp]
    for steps in (1, max_tau):
        tau_s = torch.clamp(tau_t, max=steps)
        k32, _ = train_step.train_agg_step_cuda(disp, x, y, m, tau_s, w_t, LR,
                                                max_tau=steps)
        p32, _ = ref.train_agg_step_ref(disp, x, y, m, tau_s, w_t, LR, max_tau=steps)
        p64, _ = ref.train_agg_step_ref(disp64, x.double(), y, m.double(), tau_s,
                                        w_t.double(), LR, max_tau=steps)
        print(f"train_agg_step after {steps} step(s), max relative (per leaf) to "
              f"float64: kernel {leaf_errors(k32, p64)[1]:.3g}, plain float32 "
              f"{leaf_errors(p32, p64)[1]:.3g}")
    ts_ms = cuda_ms(lambda: train_step.train_agg_step_cuda(
        disp, x, y, m, tau_t, w_t, LR, max_tau=max_tau), 5)
    ts_plain_ms = cuda_ms(lambda: ref.train_agg_step_ref(
        disp, x, y, m, tau_t, w_t, LR, max_tau=max_tau), 3)
    breakdown = device_time_by_kernel(lambda: train_step.train_agg_step_cuda(
        disp, x, y, m, tau_t, w_t, LR, max_tau=max_tau), expect="train_steps_kernel")
    busy = sum(ms for _, ms, _ in breakdown)
    print(f"train_agg_step device time by kernel (torch.profiler, one cycle): "
          f"{busy:.3f} ms busy of {ts_ms:.3f} ms" if breakdown else
          "train_agg_step device time by kernel: not measured (no device events)")
    for name, ms, calls in breakdown[:10]:
        print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")
    ts_launches = training_launches(breakdown)
    print(f"train_agg_step: {ts_launches} training-kernel launch(es) a cycle (torch.profiler)")
    require(ts_launches == 1, f"a cycle made {ts_launches} training-kernel launches, not 1")
    row_flops = kernel_cost.mlp_row_flops(widths)
    # inputs read once (x, y, m, tau, w, the K dispatched models), output written once
    ts_flops, ts_bytes = kernel_cost.train_agg_step(
        widths, row_steps=int((tau * d).sum()), learners=K, d_cap=x.shape[1], starts=K,
        outputs=1)
    ts_bound_ms = 1e3 * max(ts_flops / PEAK_FP32_FLOPS, ts_bytes / PEAK_BYTES_PER_S)
    print(f"train_agg_step: max_abs_err {ts_abs:.3g}, max relative (per leaf) "
          f"{ts_rel:.3g} <= {TRAIN_STEP_TOL}; kernel {ts_ms:.3f} ms, plain "
          f"{ts_plain_ms:.3f} ms, bound {ts_bound_ms:.3f} ms ({ts_flops:.4g} FP32 FLOPs)")

    # -- 4. the main path: run_experiment fused (kernels) and eager (plain) ----
    runs = {}
    for mode in ("fused", "eager"):
        if mode == "fused":
            fed_agg.launches = 0
            train_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[mode] = run_experiment(k=K, T=T_CYCLE, cycles=CYCLES, total_samples=TOTAL,
                                    seed=SEED, train=train, test=test,
                                    fused=(mode == "fused"))
        torch.cuda.synchronize()
        runs[mode]["ms_per_cycle"] = 1e3 * (time.perf_counter() - t0) / CYCLES
        if mode == "fused":
            launches = {"train_agg_step": train_step.launches, "fed_agg": fed_agg.launches}
    require(launches == {"train_agg_step": CYCLES, "fed_agg": CYCLES},
            f"the fused run's kernel launches were {launches}")
    fused_h, eager_h = runs["fused"]["history"], runs["eager"]["history"]
    acc_f = [h["accuracy"] for h in fused_h]
    acc_e = [h["accuracy"] for h in eager_h]
    for hf, he in zip(fused_h, eager_h):
        require(np.array_equal(hf["tau"], he["tau"]) and np.array_equal(hf["d"], he["d"]),
                "fused and eager runs allocated differently")
        require(np.array_equal(hf["tau"], tau) and np.array_equal(hf["d"], d),
                "run_experiment allocated differently from solve_kkt_sai")
    require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in acc_f + acc_e),
            f"accuracies out of range: {acc_f}, {acc_e}")
    require(max(abs(a - b) for a, b in zip(acc_f, acc_e)) <= ACC_TOL,
            f"fused {acc_f} and eager {acc_e} accuracies differ by more than {ACC_TOL}")
    require(acc_f[-1] > acc_f[0], f"accuracy did not rise: {acc_f}")
    print(f"run_experiment k={K} T={T_CYCLE} cycles={CYCLES}: fused accuracy {acc_f}, "
          f"eager {acc_e}; launches {launches}")
    # the first fused run also loads torch's kernels for the staging; a
    # second one gives the warm cycle
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_experiment(k=K, T=T_CYCLE, cycles=CYCLES, total_samples=TOTAL, seed=SEED,
                   train=train, test=test, fused=True)
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t0) / CYCLES
    print(f"run_experiment ms per cycle (staging and eval included): fused "
          f"{runs['fused']['ms_per_cycle']:.1f} (first run), {warm_ms:.1f} (warm), eager "
          f"{runs['eager']['ms_per_cycle']:.1f}")

    wf = realloc_phase(dev, train, test)
    async_rows = async_phase(dev, train, test, row_flops=row_flops)
    energy_row = energy_phase(dev, train, test)
    attention_row, whisper_case, train_weights = serve_phase(dev)
    wkv_row, rwkv_weights = rwkv_phase(dev)
    mamba_row, jamba_weights = jamba_phase(dev)
    swiglu_row = swiglu_phase(dev)
    multimodel_phase(dev, train, test)
    fleet_rows = fleet_phase(dev, train, test)
    whisper_row = whisper_phase(dev, whisper_case)
    vlm_phase(dev)
    bwd_rows = train_phase(dev, train_weights, rwkv_weights, jamba_weights)
    del train_weights, rwkv_weights, jamba_weights
    torch.cuda.empty_cache()
    dryrun_phase()
    twins_phase()

    kernels = [
        {"name": "train_agg_step", "route": "cuda",
         "source": "src/repro_torch/csrc/train_step.cu",
         "replaces": "src/repro/kernels/train_step.py:119",
         "launches": launches["train_agg_step"], "max_abs_err": ts_abs,
         "ms": ts_ms, "plain_ms": ts_plain_ms, "bound_ms": ts_bound_ms,
         "bound_by": "operations", "library_ms": None},
        {"name": "fed_agg", "route": "cuda",
         "source": "src/repro_torch/csrc/fed_agg.cu",
         "replaces": "src/repro/kernels/fed_agg.py:30",
         "launches": launches["fed_agg"], "max_abs_err": fa_err,
         "ms": fa_ms, "plain_ms": fa_plain_ms, "bound_ms": fa_bound_ms,
         "bound_by": "bytes", "library_ms": fa_lib_ms},
        wf,
        *async_rows,
        energy_row,
        attention_row,
        wkv_row,
        mamba_row,
        swiglu_row,
        *fleet_rows,
        whisper_row,
        *bwd_rows,
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def realloc_phase(dev, train, test) -> dict:
    """Phase 5; returns the waterfill kernel's entry of the kernels line."""
    import numpy as np
    import torch

    from repro_torch.core import CapacityDrift, QueueDrift, solver_batched as sb
    from repro_torch.fed.orchestrator import (
        coefficient_rows,
        solve_policy_row,
        solve_rows_state_coupled,
    )
    from repro_torch.fed.simulation import build_problem, run_experiment
    from repro_torch.kernels import fed_agg, ref, train_step, waterfill

    # -- 5a. the kernel against its plain version at fleet scale --------------
    prob = build_problem(FLEET_K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    c2, c1, c0 = CapacityDrift(seed=SEED).coefficient_path(prob.time_model, FLEET_B)
    b, k = c2.shape
    bp = sb.BatchedProblems(
        c2, c1, c0, np.full(b, prob.T), np.full(b, prob.total_samples, np.int64),
        np.full((b, k), float(prob.d_lower)), np.full((b, k), float(prob.d_upper)),
        np.ones((b, k), bool))
    print(f"fleet batch: B = {b} drifted problems of K = {k} ({b * k} learners), "
          f"d in [{prob.d_lower}, {prob.d_upper}], total {prob.total_samples}")
    waterfill.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = sb.solve_kkt_batched(bp, device=dev)
    solve_wall_ms = 1e3 * (time.perf_counter() - t0)
    solve_launches = waterfill.launches
    require(bool(card.feasible.all()), "the drifted fleet batch has infeasible rows")

    wf_err = {}
    for dtype in (torch.float64, torch.float32):
        t = sb._to_device(bp, dtype == torch.float64, dev)
        args = [t["c2"], t["c1"], t["c0"], t["T"], t["d_lo"], t["d_hi"],
                t["total_i"].to(dtype)]
        tau_star = torch.as_tensor(card.tau_star, dtype=dtype, device=dev)
        bound = WATERFILL_TOL[str(dtype)[6:]] * torch.clamp_min(args[-1].abs(), 1.0)
        err = 0.0
        for name, tau in (("0", torch.zeros_like(tau_star)), ("tau*", tau_star),
                          ("2 tau*", 2.0 * tau_star)):
            got = waterfill.waterfill_residual_cuda(tau, *args)
            want = ref.waterfill_residual_ref(tau, *args)
            diff = (got - want).abs()
            require(bool(torch.isfinite(got).all()), f"waterfill kernel gave non-finite "
                    f"residuals at tau = {name}, {dtype}")
            require(bool((diff <= bound).all()), f"waterfill kernel differs from its "
                    f"plain version by {diff.max().item():g} at tau = {name}, {dtype}")
            err = max(err, diff.max().item())
        wf_err[dtype] = err
        if dtype == torch.float64:
            wf_args = [tau_star, *args]
    f32_args = [a.float() for a in wf_args]
    # back-to-back calls are paced by the host (the wrapper's checks and the
    # ctypes call), so the kernel's own time is its device time a launch
    # from torch.profiler; CUDA events over the loop give the paced time
    wf_ms, wf32_ms = (kernel_device_ms(lambda a=a: waterfill.waterfill_residual_cuda(*a),
                                       "waterfill_residual_kernel", 50)
                      for a in (wf_args, f32_args))
    wf_paced_ms = cuda_ms(lambda: waterfill.waterfill_residual_cuda(*wf_args), 200)
    wf_plain_ms = cuda_ms(lambda: ref.waterfill_residual_ref(*wf_args), 50)
    wf_flops, wf_bytes = kernel_cost.waterfill_residual(b, k, itemsize=8)
    wf_bound_ms = 1e3 * max(wf_bytes / PEAK_BYTES_PER_S, wf_flops / PEAK_FP64_FLOPS)
    print(f"waterfill_residual: max_abs_err float64 {wf_err[torch.float64]:.3g}, float32 "
          f"{wf_err[torch.float32]:.3g} (at tau* = 0, tau*, 2 tau*); kernel device time "
          f"{wf_ms:.4f} ms a launch (float32 {wf32_ms:.4f}; host-paced loop {wf_paced_ms:.4f}), "
          f"plain {wf_plain_ms:.4f} ms, bound {wf_bound_ms:.4f} ms ({wf_bytes / 1e6:.1f} MB, "
          f"bytes; float32 half)")

    # -- 5b. the batched solve, card against CPU, and the card's split --------
    t = sb._to_device(bp, True, dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    events[0].record()
    feas, tau_star, _, d_r, relax_rounds = sb._relaxed_batched(
        t["c2"], t["c1"], t["c0"], t["T"], t["total_i"].double(), t["d_lo"], t["d_hi"],
        tol=1e-10, max_iter=200)
    events[1].record()
    d_r, total_safe, lo_i, hi_i = sb._integer_inputs(d_r, feas, t["total_i"], t["d_lo"],
                                                     t["d_hi"])
    d_int, _, int_rounds = sb._integerize(d_r, total_safe, lo_i, hi_i)
    events[2].record()
    tau_c, d_c, sai_rounds = sb._sai(d_int, t["c2"], t["c1"], t["c0"], t["T"], lo_i,
                                     hi_i, t["valid"], max_rounds=10_000)
    events[3].record()
    torch.cuda.synchronize()
    stage_ms = [events[i].elapsed_time(events[i + 1]) for i in range(3)]
    require(np.array_equal(tau_c.cpu().numpy(), card.tau)
            and np.array_equal(d_c.cpu().numpy(), card.d),
            "the staged solve differs from solve_kkt_batched")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sb.solve_kkt_batched(bp, device=dev)
    warm_ms = 1e3 * (time.perf_counter() - t0)
    breakdown = device_time_by_kernel(lambda: sb.solve_kkt_batched(bp, device=dev))
    t0 = time.perf_counter()
    cpu = sb.solve_kkt_batched(bp, device="cpu")
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    require(np.array_equal(card.feasible, cpu.feasible), "card and CPU feasibility differ")
    ties = 0
    for i in np.flatnonzero(~((card.tau == cpu.tau).all(1) & (card.d == cpu.d).all(1))):
        ties += 1
        require(np.ptp(card.tau[i]) == np.ptp(cpu.tau[i])
                and np.abs(card.d[i] - cpu.d[i]).max() <= 2,
                f"fleet {i}: card and CPU allocations differ beyond a remainder tie")
    require(ties <= TIE_SHARE * b, f"{ties} remainder ties between card and CPU")
    stale = sb.batched_max_staleness(card.tau, card.valid)
    print(f"solve_kkt_batched B={b}: card {solve_wall_ms:.1f} ms first call, {warm_ms:.1f} "
          f"ms warm (host clock, copies in), CPU {cpu_ms:.1f} ms; waterfill launches per "
          f"solve {solve_launches}; card split "
          f"(CUDA events): bisection {stage_ms[0]:.2f} ms ({relax_rounds['grow']} grow + "
          f"{relax_rounds['bisection']} bisection steps), integerize {stage_ms[1]:.2f} ms "
          f"({int_rounds} rounds), SAI {stage_ms[2]:.2f} ms ({sai_rounds} rounds); fleets "
          f"differing card vs CPU: {ties} (remainder ties); max staleness mean "
          f"{stale.mean():.3f}, worst {stale.max()}")
    busy = sum(ms for _, ms, _ in breakdown)
    print(f"solve_kkt_batched device time by kernel (torch.profiler, one warm solve): "
          f"{busy:.2f} ms busy in {sum(n for *_, n in breakdown)} launches" if breakdown else
          "solve_kkt_batched device time by kernel: not measured (no device events)")
    for name, ms, calls in breakdown[:12]:
        print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")

    # -- 5c. the main path with reallocation: run_experiment, fused and eager --
    drifts = {"CapacityDrift": lambda: CapacityDrift(seed=SEED),
              "QueueDrift": lambda: QueueDrift(base=CapacityDrift(seed=SEED))}
    prob = build_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    rows = coefficient_rows(prob, CapacityDrift(seed=SEED), CYCLES)
    solve_policy_row("kkt_sai", *(r[0] for r in rows), prob, label="warm-up", device=dev)
    waterfill.launches = 0
    t0 = time.perf_counter()
    for rep in range(5):
        for c in range(CYCLES):
            solve_policy_row("kkt_sai", *(r[c] for r in rows), prob, label=f"cycle {c}",
                             device=dev)
    row_ms = 1e3 * (time.perf_counter() - t0) / (5 * CYCLES)
    print(f"one-fleet re-solve on the card (solve_policy_row, K = {K}): {row_ms:.2f} ms "
          f"(host clock), {waterfill.launches / (5 * CYCLES):.1f} waterfill launches")
    def cpu_row_solves(rows):
        """The CPU solver on each cycle's capacity row alone, as a run
        re-solves it (one fleet, ``solve_policy_row``'s tolerances)."""
        one = lambda v, dt=np.float64: np.full((1, K), v, dt)
        return [sb.solve_kkt_batched(sb.BatchedProblems(
            *(r[c][None] for r in rows), np.full(1, prob.T), np.full(1, TOTAL, np.int64),
            one(float(prob.d_lower)), one(float(prob.d_upper)), one(True, bool)),
            device="cpu") for c in range(CYCLES)]

    realloc_launches = None
    for name, make in drifts.items():
        # the CPU solver's rows for the same capacity rows
        drift = make()
        if name == "QueueDrift":
            rows, _ = solve_rows_state_coupled("kkt_sai", drift, prob, CYCLES,
                                               label="cycle {}", device="cpu")
        else:
            rows = coefficient_rows(prob, drift, CYCLES)
        solves = cpu_row_solves(rows)
        taus, ds = [s.tau[0] for s in solves], [s.d[0] for s in solves]
        # a re-solve launches the kernel at tau = 0 (feasibility) and at the
        # first bracket tau = 1, then once a grow and once a bisection step
        n_wf = sum(2 + s.rounds["grow"] + s.rounds["bisection"] for s in solves)
        want = {"fused": {"train_agg_step": CYCLES, "fed_agg": CYCLES,
                          "waterfill_residual": n_wf},
                "eager": {"train_agg_step": 0, "fed_agg": 0, "waterfill_residual": n_wf}}
        runs = {}
        for mode in ("fused", "eager"):
            waterfill.launches = train_step.launches = fed_agg.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[mode] = run_experiment(k=K, T=T_CYCLE, cycles=CYCLES, total_samples=TOTAL,
                                        seed=SEED, train=train, test=test,
                                        fused=(mode == "fused"), reallocate=True,
                                        drift=make())
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / CYCLES
            counts = {"train_agg_step": train_step.launches, "fed_agg": fed_agg.launches,
                      "waterfill_residual": waterfill.launches}
            require(counts == want[mode], f"{name}: the {mode} reallocating run's kernel "
                    f"launches were {counts}, not {want[mode]}")
            if mode == "fused" and realloc_launches is None:
                realloc_launches = counts["waterfill_residual"]
            runs[mode]["ms"], runs[mode]["counts"] = ms, counts
        hist_f, hist_e = runs["fused"]["history"], runs["eager"]["history"]
        for c, (hf, he) in enumerate(zip(hist_f, hist_e)):
            require(np.array_equal(hf["tau"], he["tau"]) and np.array_equal(hf["d"], he["d"]),
                    f"{name}: fused and eager runs allocated cycle {c} differently")
            require(np.array_equal(hf["tau"], taus[c]) and np.array_equal(hf["d"], ds[c]),
                    f"{name}: cycle {c} differs from the CPU solver's allocation")
        acc_f = [h["accuracy"] for h in hist_f]
        acc_e = [h["accuracy"] for h in hist_e]
        require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in acc_f + acc_e),
                f"{name}: accuracies out of range: {acc_f}, {acc_e}")
        require(max(abs(a - e) for a, e in zip(acc_f, acc_e)) <= ACC_TOL,
                f"{name}: fused {acc_f} and eager {acc_e} accuracies differ by more "
                f"than {ACC_TOL}")
        require(acc_f[-1] > acc_f[0], f"{name}: accuracy did not rise: {acc_f}")
        print(f"run_experiment reallocate=True drift={name}: d by cycle "
              f"{[h['d'].tolist() for h in hist_f]}, tau {[h['tau'].tolist() for h in hist_f]}; "
              f"fused accuracy {acc_f}, eager {acc_e}; ms per cycle fused "
              f"{runs['fused']['ms']:.1f}, eager {runs['eager']['ms']:.1f}; launches fused "
              f"{runs['fused']['counts']}, eager {runs['eager']['counts']}")

    return {"name": "waterfill_residual", "route": "cuda",
            "source": "src/repro_torch/csrc/waterfill.cu",
            "replaces": "src/repro/kernels/waterfill.py:47",
            "launches": realloc_launches, "max_abs_err": wf_err[torch.float64],
            "ms": wf_ms, "plain_ms": wf_plain_ms, "bound_ms": wf_bound_ms,
            "bound_by": "bytes", "library_ms": None}


def async_phase(dev, train, test, *, row_flops: int) -> list[dict]:
    """Phase 6; returns the async train step's and ``accum_flush``'s entries
    of the kernels line."""
    import numpy as np
    import torch

    from repro_torch.core import CapacityDrift
    from repro_torch.fed import async_engine as ae
    from repro_torch.fed.simulation import build_problem, run_async_experiment
    from repro_torch.kernels import accum_flush, ref, train_step
    from repro_torch.models import mlp

    widths = mlp.PAPER_LAYERS
    horizon = CYCLES * T_CYCLE

    # -- 6a. accum_flush at the paper model's leaf shapes --------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    shapes = []
    for fi, fo in zip(widths[:-1], widths[1:]):
        shapes += [(fi, fo), (fo,)]
    locs = [torch.randn((K, *s), generator=gen, device=dev) for s in shapes]
    accs = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    servers = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    wts = torch.softmax(torch.randn(K, generator=gen, device=dev), 0) * 0.6
    cases = {"accumulate": (1.0, 0.0), "buffered flush": (0.0, 1.0),
             "fedasync mix": (0.4, 1.0)}
    af_err = 0.0
    for case, (keep, flush) in cases.items():
        got_s, got_a = accum_flush.accum_flush_leaves_cuda(locs, accs, servers, wts, keep,
                                                           flush)
        for loc, acc, srv, gs, ga in zip(locs, accs, servers, got_s, got_a):
            alone = accum_flush.accum_flush_cuda(loc, wts, acc, srv, keep, flush)
            require(torch.equal(gs, alone[0]) and torch.equal(ga, alone[1]),
                    f"accum_flush: a leaf of the all-leaf launch differs from the leaf "
                    f"alone ({case})")
            want = ref.accum_flush_ref(loc, wts, acc, srv, keep, flush)
            for g, w in zip((gs, ga), want):
                require(bool(torch.isfinite(g).all()), f"accum_flush gave non-finite "
                        f"values ({case})")
                err = (g - w).abs().max().item()
                require(err <= ACCUM_FLUSH_TOL * max(1.0, w.abs().max().item()),
                        f"accum_flush differs from its plain version by {err:g} ({case})")
                af_err = max(af_err, err)
    all_leaves = list(zip(locs, accs, servers))
    af_ms = cuda_ms(lambda: accum_flush.accum_flush_leaves_cuda(locs, accs, servers, wts,
                                                                0.4, 1.0), 200)
    af_launch_ms = kernel_device_ms(
        lambda: accum_flush.accum_flush_leaves_cuda(locs, accs, servers, wts, 0.4, 1.0),
        "accum_flush_kernel", 20)
    af_plain_ms = cuda_ms(lambda: [ref.accum_flush_ref(l, wts, a, s, 0.4, 1.0)
                                   for l, a, s in all_leaves], 200)
    af_lib_ms = cuda_ms(lambda: [torch.tensordot(wts, l, dims=1) for l, _, _ in all_leaves],
                        200)
    n_params = sum(math.prod(s) for s in shapes)
    af_flops, af_bytes = kernel_cost.accum_flush_leaves([math.prod(s) for s in shapes], K)
    af_bound_ms = 1e3 * max(af_bytes / PEAK_BYTES_PER_S, af_flops / PEAK_FP32_FLOPS)
    print(f"accum_flush: {len(shapes)} leaves, {n_params} params, K = {K}, max_abs_err "
          f"{af_err:.3g} over {', '.join(cases)}, each leaf bitwise as alone; kernel "
          f"{af_ms:.4f} ms (one launch for all leaves, CUDA events; device time "
          f"{af_launch_ms:.4f} ms by torch.profiler), plain "
          f"{af_plain_ms:.4f} ms, tensordot of the accumulate {af_lib_ms:.4f} ms, bound "
          f"{af_bound_ms:.4f} ms ({af_bytes / 1e6:.1f} MB, bytes)")

    # the CPU schedule of each mode, with the engine's rng discipline: the
    # rows the card's runs must give, the groups, the blocks re-solved and
    # the water-fillings their re-solves make
    prob = build_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    cpu = {mode: cpu_schedule(train, horizon, prob,
                              ae.AsyncConfig(mode=mode, reallocate=True, **extra),
                              CapacityDrift(seed=SEED), "waterfill_residual")
           for mode, extra in ASYNC_MODES.items()}

    # -- 6b. one async group step at full width ---------------------------------
    tx = torch.from_numpy(train.x).to(dev)
    ty = torch.from_numpy(train.y).to(dev)
    init = mlp.init(SEED, device=dev)

    def group_inputs(mode, groups, slots=None):
        st = ae._stage_groups(groups, mode=mode, k_fleet=K, d_cap=cpu[mode]["sched"].d_cap,
                              slots=slots)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        rows_ = K if slots is None else slots
        disp = [{n: leaf.expand((rows_,) + leaf.shape) for n, leaf in layer.items()}
                for layer in init]
        acc0 = [{n: 0.01 * torch.ones_like(leaf) for n, leaf in layer.items()}
                for layer in init]
        args = (disp, tx[t(st.idx[0])], ty[t(st.idx[0])], t(st.m[0]), t(st.tau[0]),
                t(st.w[0]), LR)
        kw = dict(max_tau=max(int(st.tau[0].max()), 1), server=init, acc=acc0,
                  keep=float(st.keep[0]), flush=float(st.flush[0]))
        return args, kw

    def tree_errors(got, want) -> tuple[float, float]:
        """``leaf_errors`` over both returned models (server', acc')."""
        errs = [leaf_errors(g, w) for g, w in zip(got, want)]
        return max(e[0] for e in errs), max(e[1] for e in errs)

    buf_groups = cpu["buffered"]["groups"]
    widest = max((g for g in buf_groups if g[-1].flush), key=len)
    args, kw = group_inputs("buffered", [widest])
    # the parity gate at full width: one GD step a learner (see phase 3)
    args1 = (*args[:4], torch.clamp(args[4], max=1), *args[5:])
    kw1 = {**kw, "max_tau": 1}
    gs1_rel = tree_errors(train_step.train_agg_step_cuda(*args1, **kw1),
                          ref.train_agg_step_ref(*args1, **kw1))[1]
    require(gs1_rel <= TRAIN_STEP_TOL, f"the async group step (one GD step a learner) "
            f"differs from its plain version: {gs1_rel:g} relative")
    # the whole group step: the kernel against the plain version, and both
    # float32 versions against the plain version in float64
    got = train_step.train_agg_step_cuda(*args, **kw)
    want = ref.train_agg_step_ref(*args, **kw)
    f64 = lambda tree: [{n: v.double() for n, v in layer.items()} for layer in tree]
    args64 = (f64(args[0]), args[1].double(), args[2], args[3].double(), args[4],
              args[5].double(), LR)
    want64 = ref.train_agg_step_ref(*args64, **{**kw, "server": f64(kw["server"]),
                                                "acc": f64(kw["acc"])})
    torch.cuda.synchronize()
    require(all(torch.isfinite(t).all().item() for tree in got for layer in tree
                for t in layer.values()), "the async group step gave non-finite params")
    gs_abs, gs_rel = tree_errors(got, want)
    k64, p64 = tree_errors(got, want64)[1], tree_errors(want, want64)[1]
    require(k64 <= FLOAT32_SPREAD * p64, f"the async group step sits {k64:g} (relative) "
            f"from float64, the plain float32 version {p64:g}")
    print(f"async group step, max relative (per leaf): one GD step {gs1_rel:.3g} <= "
          f"{TRAIN_STEP_TOL}; all {max(a.tau for a in widest)} steps: kernel vs plain "
          f"{gs_rel:.3g}, to float64: kernel {k64:.3g}, plain float32 {p64:.3g}")
    gs_ms = cuda_ms(lambda: train_step.train_agg_step_cuda(*args, **kw), 5)
    gs_plain_ms = cuda_ms(lambda: ref.train_agg_step_ref(*args, **kw), 3)
    td = int(sum(a.tau * a.d for a in widest))
    d_cap = cpu["buffered"]["sched"].d_cap
    # inputs read once (x, y, m, tau, w, K dispatched models, server, acc),
    # outputs (server', acc') written once
    gs_flops, gs_bytes = kernel_cost.train_agg_step(widths, row_steps=td, learners=K,
                                                    d_cap=d_cap, starts=K, outputs=4)
    gs_bound_ms = 1e3 * max(gs_flops / PEAK_FP32_FLOPS, gs_bytes / PEAK_BYTES_PER_S)
    breakdown = device_time_by_kernel(lambda: train_step.train_agg_step_cuda(*args, **kw),
                                      expect="train_steps_kernel")
    busy = sum(ms for _, ms, _ in breakdown)
    print(f"async group step (buffered flush of {len(widest)}: learners "
          f"{[a.learner for a in widest]}, tau {[a.tau for a in widest]}, d "
          f"{[a.d for a in widest]}): max_abs_err {gs_abs:.3g}; kernel {gs_ms:.3f} ms, plain "
          f"{gs_plain_ms:.3f} ms, bound {gs_bound_ms:.3f} ms ({gs_flops:.4g} FP32 FLOPs); "
          + (f"{busy:.3f} ms busy by torch.profiler" if breakdown else
             "device time by kernel not measured (no device events)"))
    for name, ms, calls in breakdown[:8]:
        print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")
    gs_launches = training_launches(breakdown)
    print(f"async group step: {gs_launches} training-kernel launch(es) a call (torch.profiler)")
    require(gs_launches == 1, f"an async group step made {gs_launches} training-kernel "
            f"launches, not 1")
    # fedasync: one learner trains, nine sit at tau = 0 with an all-zero
    # mask; every kernel should stop at once for them
    fa_groups = cpu["fedasync"]["groups"]
    big = max(fa_groups, key=lambda g: g[0].tau * g[0].d)
    dense = group_inputs("fedasync", [big])
    slot = group_inputs("fedasync", [big], slots=1)
    fa_dense_ms = cuda_ms(lambda: train_step.train_agg_step_cuda(*dense[0], **dense[1]), 5)
    fa_slot_ms = cuda_ms(lambda: train_step.train_agg_step_cuda(*slot[0], **slot[1]), 5)
    d_out = train_step.train_agg_step_cuda(*dense[0], **dense[1])
    s_out = train_step.train_agg_step_cuda(*slot[0], **slot[1])
    ds_rel = max(leaf_errors(g, w)[1] for g, w in zip(d_out, s_out))
    require(ds_rel <= TRAIN_STEP_TOL, f"the fedasync step dense and over one slot "
            f"differ: {ds_rel:g} relative")
    busy = [sum(ms for _, ms, _ in device_time_by_kernel(
        lambda a=a: train_step.train_agg_step_cuda(*a[0], **a[1]))) for a in (dense, slot)]
    print(f"fedasync group step (learner {big[0].learner}, tau {big[0].tau}, d "
          f"{big[0].d}): dense over K = {K} {fa_dense_ms:.3f} ms ({busy[0]:.3f} ms busy "
          f"by torch.profiler), one slot {fa_slot_ms:.3f} ms ({busy[1]:.3f} busy); max "
          f"relative difference {ds_rel:.3g}")

    # -- 6c. the async main path: run_async_experiment, grouped and eager ------
    # the eager runs go first: a process's first run also loads torch's kernels
    out = {}
    total_launches = 0
    for mode, extra in ASYNC_MODES.items():
        want_rows = cpu[mode]["rows"]
        n_groups = len(cpu[mode]["groups"])
        n_wf = cpu[mode]["solves"]
        fixed = {"fed_agg": 0, "waterfill_residual": n_wf, "waterfill_energy_residual": 0,
                 "flash_attention": 0, "flash_attention_bwd": 0, "wkv6": 0, "wkv6_bwd": 0,
                 "mamba_scan": 0, "mamba_scan_bwd": 0, "swiglu": 0}
        want = {"eager": {"train_agg_step": 0, "accum_flush": 0, **fixed},
                "grouped": {"train_agg_step": n_groups, "accum_flush": n_groups, **fixed}}
        runs = {}
        for path in ("eager", "grouped", "grouped warm"):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_async_experiment(
                k=K, T=T_CYCLE, cycles=CYCLES, total_samples=TOTAL, seed=SEED,
                mode=mode, drift=CapacityDrift(seed=SEED), reallocate=True,
                bucketed=path != "eager", train=train, test=test,
                buffer_size=extra.get("buffer_size", 0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches()
            key = path.split()[0]
            require(counts == want[key], f"{mode}: the {path} run's kernel launches were "
                    f"{counts}, not {want[key]}")
            hist = res["history"]
            check_rows(hist, want_rows, f"{mode} {path}")
            accs = [r["accuracy"] for r in hist]
            require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
                    f"{mode} {path}: accuracies out of range")
            require(accs[-1] > accs[0], f"{mode} {path}: accuracy did not rise: {accs}")
            runs[path] = {"ms": 1e3 * wall / len(hist), "accs": accs, "counts": counts}
            if path == "grouped":
                total_launches += counts["train_agg_step"]
        # where a warm grouped run's time goes: the device's busy time by
        # kernel (torch.profiler, whose tracing slows the host several-fold)
        # against the unprofiled warm run's host clock
        rows_ = device_time_by_kernel(lambda: run_async_experiment(
            k=K, T=T_CYCLE, cycles=CYCLES, total_samples=TOTAL, seed=SEED, mode=mode,
            drift=CapacityDrift(seed=SEED), reallocate=True, bucketed=True, train=train,
            test=test, buffer_size=extra.get("buffer_size", 0)))
        wall_ms = runs["grouped warm"]["ms"] * len(want_rows)
        busy = sum(ms for _, ms, _ in rows_)
        print(f"{mode} grouped run: device busy {busy:.1f} ms (torch.profiler) of "
              f"{wall_ms:.1f} ms warm wall ({100 * (1 - busy / wall_ms):.0f}% idle), in "
              f"{sum(n for *_, n in rows_)} launches" if rows_ else
              f"{mode} grouped run: device time not measured (no device events)")
        for name, ms, calls in rows_[:8]:
            print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")
        acc_e, acc_g = runs["eager"]["accs"], runs["grouped"]["accs"]
        gap = max(abs(a - b) for a, b in zip(acc_e, acc_g))
        require(gap <= ASYNC_ACC_TOL, f"{mode}: grouped and eager accuracies differ by "
                f"{gap:g} > {ASYNC_ACC_TOL}")
        sched = cpu[mode]["sched"]
        print(f"run_async_experiment mode={mode} k={K} cycles={CYCLES} CapacityDrift "
              f"reallocate: {len(want_rows)} aggregations in {n_groups} groups, tau up to "
              f"{sched.max_tau}, d up to {sched.d_cap}, blocks re-solved "
              f"{cpu[mode]['blocks']}; final accuracy grouped {acc_g[-1]:.4f}, eager "
              f"{acc_e[-1]:.4f} (max gap {gap:.4f}); ms per aggregation grouped "
              f"{runs['grouped']['ms']:.2f} (first), {runs['grouped warm']['ms']:.2f} "
              f"(warm), eager {runs['eager']['ms']:.2f}; launches grouped "
              f"{runs['grouped']['counts']}")
        out[mode] = runs

    # fedasync over arrival slots (seg_batch=1): the same rows, one slot a step
    eng = ae.AsyncFedEngine(ae.AsyncConfig(mode="fedasync", reallocate=True), prob,
                            mlp.loss, mlp.init(SEED, device=dev), seed=SEED,
                            drift=CapacityDrift(seed=SEED))
    train_step.launches = accum_flush.launches = 0
    ex, ey = (torch.from_numpy(a[:2000]).to(dev) for a in (test.x, test.y))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = eng.run_events(train, horizon, eval_fn=mlp.accuracy, eval_batch=(ex, ey),
                          seg_batch=1)
    torch.cuda.synchronize()
    sb_ms = 1e3 * (time.perf_counter() - t0) / max(len(hist), 1)
    want_rows = cpu["fedasync"]["rows"]
    require(len(hist) == len(want_rows) and all(
        np.array_equal(np.asarray(r[n]), np.asarray(w[n]))
        for r, w in zip(hist, want_rows) for n in w), "seg_batch=1 changed the rows")
    require(train_step.launches == len(want_rows), "seg_batch=1 launch count")
    print(f"fedasync run_events seg_batch=1: {sb_ms:.2f} ms per aggregation (dense warm "
          f"{out['fedasync']['grouped warm']['ms']:.2f}); final accuracy "
          f"{hist[-1]['accuracy']:.4f}")

    return [
        {"name": "train_agg_step_async", "route": "cuda",
         "source": "src/repro_torch/csrc/train_step.cu",
         "replaces": "src/repro/kernels/train_step.py:119",
         "launches": total_launches, "max_abs_err": gs_abs,
         "ms": gs_ms, "plain_ms": gs_plain_ms, "bound_ms": gs_bound_ms,
         "bound_by": "operations" if gs_flops / PEAK_FP32_FLOPS > gs_bytes / PEAK_BYTES_PER_S
         else "bytes", "library_ms": None},
        {"name": "accum_flush", "route": "cuda",
         "source": "src/repro_torch/csrc/accum_flush.cu",
         "replaces": "src/repro/kernels/train_step.py:119",
         "launches": total_launches, "max_abs_err": af_err,
         "ms": af_ms, "plain_ms": af_plain_ms, "bound_ms": af_bound_ms,
         "bound_by": "bytes", "library_ms": af_lib_ms},
    ]


def energy_phase(dev, train, test) -> dict:
    """Phase 7; returns the budgeted water-filling kernel's entry of the
    kernels line."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import (
        BatteryDrift,
        CapacityDrift,
        MarkovAvailability,
        solve_kkt_sai,
        solver_batched as sb,
    )
    from repro_torch.fed import async_engine as ae
    from repro_torch.fed.orchestrator import solve_rows_availability
    from repro_torch.fed.simulation import (
        build_energy_problem,
        build_problem,
        run_async_experiment,
    )
    from repro_torch.kernels import ref, waterfill

    # -- 7a. the kernel against its plain version at fleet scale --------------
    free = build_energy_problem(FLEET_K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    blind = solve_kkt_sai(free)
    eb = BUDGET_FRAC * float(np.median(free.energy.cycle_energy(blind.tau, blind.d)))
    c2, c1, c0 = CapacityDrift(seed=SEED).coefficient_path(free.time_model, FLEET_B)
    b, k = c2.shape
    e2, e1, e0, ebr = (np.broadcast_to(r, (b, k)).copy() for r in free.energy.rows(eb))
    bp = sb.BatchedProblems(
        c2, c1, c0, np.full(b, free.T), np.full(b, free.total_samples, np.int64),
        np.full((b, k), float(free.d_lower)), np.full((b, k), float(free.d_upper)),
        np.ones((b, k), bool), e2, e1, e0, ebr)
    print(f"energy fleet batch: B = {b} drifted problems of K = {k}, budget {eb:.4f} J "
          f"({BUDGET_FRAC} x the median blind kkt_sai spend; the blind spend by learner "
          f"{np.round(free.energy.cycle_energy(blind.tau, blind.d), 3).tolist()})")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = sb.solve_energy_batched(bp, device=dev)
    solve_wall_ms = 1e3 * (time.perf_counter() - t0)
    solve_launches = read_launches()
    require(bool(card.feasible.all()), "the energy fleet batch has infeasible rows")
    require(solve_launches["waterfill_energy_residual"]
            == 2 + card.rounds["grow"] + card.rounds["bisection"]
            and solve_launches["waterfill_residual"] == 0,
            f"solve_energy_batched launched {solve_launches}")

    ew_err, times = {}, {}
    for dtype in (torch.float64, torch.float32):
        x64 = dtype == torch.float64
        t = sb._to_device(bp, x64, dev)
        en = sb._energy_to_device(bp, x64, dev)
        # the residual as the solve calls it: on the affordability-masked box
        total_m, lo_m, hi_m, _ = sb.apply_energy_mask(t["total_i"], t["d_lo"], t["d_hi"],
                                                      t["valid"], en)
        args = [t["c2"], t["c1"], t["c0"], t["T"], *en, lo_m, hi_m, total_m.to(dtype)]
        tau_star = torch.as_tensor(card.tau_star, dtype=dtype, device=dev)
        bound = WATERFILL_TOL[str(dtype)[6:]] * torch.clamp_min(args[-1].abs(), 1.0)
        err = 0.0
        for name, tau in (("0", torch.zeros_like(tau_star)), ("tau*", tau_star),
                          ("2 tau*", 2.0 * tau_star)):
            got = waterfill.waterfill_energy_residual_cuda(tau, *args)
            want = ref.waterfill_energy_residual_ref(tau, *args)
            diff = (got - want).abs()
            require(bool(torch.isfinite(got).all()), f"energy waterfill kernel gave "
                    f"non-finite residuals at tau = {name}, {dtype}")
            require(bool((diff <= bound).all()), f"energy waterfill kernel differs from "
                    f"its plain version by {diff.max().item():g} at tau = {name}, {dtype}")
            err = max(err, diff.max().item())
        # eb = +inf with zero energy coefficients: the time-only kernel's bits
        inf_args = [*args[:4], *(torch.zeros_like(e) for e in en[:3]),
                    torch.full_like(en[3], torch.inf), *args[8:]]
        require(torch.equal(waterfill.waterfill_energy_residual_cuda(tau_star, *inf_args),
                            waterfill.waterfill_residual_cuda(tau_star, *args[:4],
                                                              *args[8:])),
                f"at eb = +inf the energy kernel differs from the time-only kernel, {dtype}")
        # e2 = e1 = 0 with eb = e0 in every 4096th fleet's first learner: 0 / 0
        nan_args = [a.clone() for a in args]
        rows = torch.arange(b, device=dev) % 4096 == 0
        nan_args[4][rows, 0] = 0.0
        nan_args[5][rows, 0] = 0.0
        nan_args[7][rows, 0] = nan_args[6][rows, 0]
        got = waterfill.waterfill_energy_residual_cuda(tau_star, *nan_args)
        want = ref.waterfill_energy_residual_ref(tau_star, *nan_args)
        require(torch.equal(torch.isnan(got), torch.isnan(want))
                and int(torch.isnan(got).sum()) == int(rows.sum()),
                f"the energy kernel's NaNs sit elsewhere than the plain version's, {dtype}")
        ew_err[dtype] = err
        kernel_args = [tau_star, *args]
        # back-to-back launches are host-paced, so the kernel's own time is
        # its device time a launch by torch.profiler
        times[dtype] = {
            "ms": kernel_device_ms(lambda a=kernel_args:
                                   waterfill.waterfill_energy_residual_cuda(*a),
                                   "waterfill_energy_residual_kernel", 50),
            "paced_ms": cuda_ms(lambda a=kernel_args:
                                waterfill.waterfill_energy_residual_cuda(*a), 200),
            "plain_ms": cuda_ms(lambda a=kernel_args:
                                ref.waterfill_energy_residual_ref(*a), 50),
        }
        size = torch.finfo(dtype).bits // 8
        # per learner: 4 + 4 for the two hyperbolae, a min, a two-sided
        # clip and an add; one subtract per fleet
        ew_ops, ew_bytes = kernel_cost.waterfill_energy_residual(b, k, itemsize=size)
        peak = PEAK_FP64_FLOPS if x64 else PEAK_FP32_FLOPS
        times[dtype]["bytes_ms"] = 1e3 * ew_bytes / PEAK_BYTES_PER_S
        times[dtype]["ops_ms"] = 1e3 * ew_ops / peak
        times[dtype]["mb"] = ew_bytes / 1e6
    f64, f32 = times[torch.float64], times[torch.float32]
    bound_ms = max(f64["bytes_ms"], f64["ops_ms"])
    print(f"waterfill_energy_residual: max_abs_err float64 {ew_err[torch.float64]:.3g}, "
          f"float32 {ew_err[torch.float32]:.3g} (at tau* = 0, tau*, 2 tau*); eb = +inf equal "
          f"to the time-only kernel; NaN fleets where the plain version's are; kernel "
          f"device time {f64['ms']:.4f} ms a launch float64 (float32 {f32['ms']:.4f}; "
          f"host-paced loop {f64['paced_ms']:.4f} / {f32['paced_ms']:.4f}), plain "
          f"{f64['plain_ms']:.4f} / {f32['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms float64 "
          f"({f64['mb']:.1f} MB; operations {f64['ops_ms']:.5f} ms), "
          f"{max(f32['bytes_ms'], f32['ops_ms']):.4f} ms float32 ({f32['mb']:.1f} MB)")

    # -- 7b. the budgeted batched solve, card against CPU --------------------
    t = sb._to_device(bp, True, dev)
    en = sb._energy_to_device(bp, True, dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    events[0].record()
    total_m, lo_m, hi_m, valid_m = sb.apply_energy_mask(t["total_i"], t["d_lo"], t["d_hi"],
                                                        t["valid"], en)
    feas, _, _, d_r, relax_rounds = sb._relaxed_batched(
        t["c2"], t["c1"], t["c0"], t["T"], total_m.double(), lo_m, hi_m, tol=1e-10,
        max_iter=200, energy=en)
    events[1].record()
    d_r, total_safe, lo_i, hi_i = sb._integer_inputs(d_r, feas, total_m, lo_m, hi_m)
    d_int, _, int_rounds = sb._integerize(d_r, total_safe, lo_i, hi_i)
    events[2].record()
    tau_c, d_c, sai_rounds = sb._sai(d_int, t["c2"], t["c1"], t["c0"], t["T"], lo_i, hi_i,
                                     valid_m, max_rounds=10_000, energy=en)
    events[3].record()
    torch.cuda.synchronize()
    stage_ms = [events[i].elapsed_time(events[i + 1]) for i in range(3)]
    require(np.array_equal(tau_c.cpu().numpy(), card.tau)
            and np.array_equal(d_c.cpu().numpy(), card.d),
            "the staged energy solve differs from solve_energy_batched")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sb.solve_energy_batched(bp, device=dev)
    warm_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    cpu = sb.solve_energy_batched(bp, device="cpu")
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    require(np.array_equal(card.feasible, cpu.feasible),
            "card and CPU feasibility differ (energy)")
    ties = 0
    for i in np.flatnonzero(~((card.tau == cpu.tau).all(1) & (card.d == cpu.d).all(1))):
        ties += 1
        require(np.ptp(card.tau[i]) == np.ptp(cpu.tau[i])
                and np.abs(card.d[i] - cpu.d[i]).max() <= 2,
                f"fleet {i}: card and CPU energy allocations differ beyond a remainder tie")
    require(ties <= TIE_SHARE * b, f"{ties} remainder ties between card and CPU (energy)")
    spent = np.where(card.d > 0, e2 * card.tau * card.d + e1 * card.d + e0, 0.0)
    violations = int((spent > ebr * (1 + 1e-9)).sum())
    require(violations == 0, f"{violations} learners over budget in the card's energy solve")
    # learners whose tau the budget caps below what the deadline allows
    with np.errstate(divide="ignore", invalid="ignore"):
        tau_time = np.floor((free.T - c0 - c1 * card.d) / (c2 * card.d))
        tau_energy = np.floor((ebr - e0 - e1 * card.d) / (e2 * card.d))
    binding = float(((card.d > 0) & (tau_energy < tau_time)).mean())
    stale = sb.batched_max_staleness(card.tau, card.valid)
    print(f"solve_energy_batched B={b}: card {solve_wall_ms:.1f} ms first call, "
          f"{warm_ms:.1f} ms warm (host clock, copies in), CPU {cpu_ms:.1f} ms; energy "
          f"water-fillings per solve {solve_launches['waterfill_energy_residual']}; card "
          f"split (CUDA events): mask + bisection {stage_ms[0]:.2f} ms "
          f"({relax_rounds['grow']} grow + {relax_rounds['bisection']} bisection steps), "
          f"integerize {stage_ms[1]:.2f} ms ({int_rounds} rounds), SAI {stage_ms[2]:.2f} ms "
          f"({sai_rounds} rounds); fleets differing card vs CPU: {ties}; budget violations "
          f"0; learners whose tau the budget caps {100 * binding:.1f}%; max staleness mean "
          f"{stale.mean():.3f}, worst {stale.max()}")

    # -- 7c. the energy main path: run_async_experiment under BatteryDrift ------
    horizon = CYCLES * T_CYCLE
    free = build_energy_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    blind = solve_kkt_sai(free)
    eb = BUDGET_FRAC * float(np.median(free.energy.cycle_energy(blind.tau, blind.d)))
    prob = dataclasses.replace(free, e_budget=eb)

    def battery():
        return BatteryDrift(energy=prob.energy, capacity_j=2 * eb, recharge_j=0.25 * eb,
                            p_plugged=0.5, seed=SEED, base=CapacityDrift(seed=SEED))

    energy_launches = 0
    for mode, extra in ASYNC_MODES.items():
        cfg = ae.AsyncConfig(mode=mode, scheme="kkt_energy", reallocate=True, **extra)
        cpu_s = cpu_schedule(train, horizon, prob, cfg, battery(), "waterfill_energy_residual")
        n_groups = len(cpu_s["groups"])
        sched = cpu_s["sched"]
        require(sched.energy_violations == 0, f"{mode}: the CPU schedule overspends")
        want = {"eager": {"train_agg_step": 0, "accum_flush": 0},
                "grouped": {"train_agg_step": n_groups, "accum_flush": n_groups}}
        runs = {}
        for path in ("eager", "grouped", "grouped warm"):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_async_experiment(
                problem=prob, cycles=CYCLES, seed=SEED, mode=mode, scheme="kkt_energy",
                drift=battery(), reallocate=True, bucketed=path != "eager", train=train,
                test=test, buffer_size=extra.get("buffer_size", 0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches()
            key = path.split()[0]
            require(counts == {**want[key], "fed_agg": 0, "waterfill_residual": 0,
                               "waterfill_energy_residual": cpu_s["solves"],
                               "flash_attention": 0, "flash_attention_bwd": 0, "wkv6": 0,
                               "wkv6_bwd": 0, "mamba_scan": 0, "mamba_scan_bwd": 0,
                               "swiglu": 0},
                    f"{mode} energy {path}: kernel launches {counts}, CPU solves "
                    f"{cpu_s['solves']}")
            hist = res["history"]
            check_rows(hist, cpu_s["rows"], f"{mode} energy {path}")
            led = res["summary"]["energy"]
            require(led["violations"] == 0, f"{mode} energy {path}: {led['violations']} "
                    "budget violations")
            require(np.array_equal(np.asarray(led["per_learner"]), sched.energy_spent),
                    f"{mode} energy {path}: the ledger differs from the CPU schedule's")
            require(res["summary"]["faults"] == sched.counters,
                    f"{mode} energy {path}: counters differ from the CPU schedule's")
            accs = [r["accuracy"] for r in hist]
            require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
                    f"{mode} energy {path}: accuracies out of range")
            runs[path] = {"ms": 1e3 * wall / len(hist), "accs": accs, "counts": counts}
        energy_launches += runs["grouped"]["counts"]["waterfill_energy_residual"]
        rows_ = device_time_by_kernel(lambda: run_async_experiment(
            problem=prob, cycles=CYCLES, seed=SEED, mode=mode, scheme="kkt_energy",
            drift=battery(), reallocate=True, bucketed=True, train=train, test=test,
            buffer_size=extra.get("buffer_size", 0)))
        wall_ms = runs["grouped warm"]["ms"] * len(cpu_s["rows"])
        busy = sum(ms for _, ms, _ in rows_)
        gap = max(abs(a - e) for a, e in zip(runs["grouped"]["accs"], runs["eager"]["accs"]))
        require(gap <= ASYNC_ACC_TOL, f"{mode} energy: grouped and eager accuracies differ "
                f"by {gap:g} > {ASYNC_ACC_TOL}")
        print(f"run_async_experiment mode={mode} kkt_energy BatteryDrift k={K} "
              f"cycles={CYCLES}: {len(cpu_s['rows'])} aggregations in {n_groups} groups, "
              f"tau up to {sched.max_tau}, d up to {sched.d_cap}; joules by learner "
              f"{np.round(sched.energy_spent, 2).tolist()} (budget {eb:.4f} J a dispatch), "
              f"0 violations; final accuracy grouped {runs['grouped']['accs'][-1]:.4f}, "
              f"eager {runs['eager']['accs'][-1]:.4f} (max gap {gap:.4f}); ms per "
              f"aggregation grouped {runs['grouped']['ms']:.2f} (first), "
              f"{runs['grouped warm']['ms']:.2f} (warm), eager {runs['eager']['ms']:.2f}; "
              f"launches grouped {runs['grouped']['counts']}")
        print(f"  device busy {busy:.1f} ms (torch.profiler) of {wall_ms:.1f} ms warm wall "
              f"({100 * (1 - busy / wall_ms):.0f}% idle) in {sum(n for *_, n in rows_)} "
              f"launches" if rows_ else "  device time not measured (no device events)")
        for name, ms, calls in rows_[:6]:
            print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")
    require(energy_launches > 0, "the energy main path launched no energy water-filling")

    budgeted = prob

    # -- 7d. churn: the buffered run under a Markov availability chain --------
    prob = build_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    faults = dict(drop_rate=CHURN_P_DROP / 2, straggler_rate=0.2, straggler_factor=3.0,
                  delay_rate=0.2, delay_mean=0.5 * T_CYCLE, deadline=2.5 * T_CYCLE,
                  retry_backoff=0.25 * T_CYCLE, retry_backoff_cap=T_CYCLE, quorum=2,
                  flush_timeout=1.5 * T_CYCLE)

    def churn():
        return MarkovAvailability(p_drop=CHURN_P_DROP, p_join=0.5, seed=SEED,
                                  base=CapacityDrift(seed=SEED))

    cfg = ae.AsyncConfig(mode="buffered", buffer_size=5, reallocate=True, **faults)
    cpu_s = cpu_schedule(train, horizon, prob, cfg, churn(), "waterfill_residual")
    counters = cpu_s["sched"].counters
    require(counters["offline_deferrals"] >= 1, "the churn schedule deferred no dispatch")
    nblocks = len(cpu_s["masks"])
    rows_c, alloc_c, masks_c = solve_rows_availability("kkt_sai", churn(), prob, nblocks,
                                                       label="block {}", device=dev)
    require(np.array_equal(masks_c, cpu_s["masks"]), "the card's churn masks differ")
    rows_h, alloc_h, _ = solve_rows_availability("kkt_sai", churn(), prob, nblocks,
                                                 label="block {}", device="cpu")
    require(all(np.array_equal(a, h) for a, h in zip((*rows_c, *alloc_c),
                                                     (*rows_h, *alloc_h))),
            "the card's masked re-solves differ from the CPU's")
    n_groups = len(cpu_s["groups"])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_async_experiment(problem=prob, cycles=CYCLES, seed=SEED, mode="buffered",
                               drift=churn(), reallocate=True, bucketed=True, train=train,
                               test=test, buffer_size=5, faults=faults)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    require(counts == {"train_agg_step": n_groups, "accum_flush": n_groups,
                       "fed_agg": 0, "waterfill_residual": cpu_s["solves"],
                       "waterfill_energy_residual": 0, "flash_attention": 0,
                       "flash_attention_bwd": 0, "wkv6": 0, "wkv6_bwd": 0, "mamba_scan": 0,
                       "mamba_scan_bwd": 0, "swiglu": 0},
            f"churn run: kernel launches {counts}, CPU solves {cpu_s['solves']}")
    check_rows(res["history"], cpu_s["rows"], "churn run")
    require(res["summary"]["faults"] == counters, "churn run: counters differ from the CPU's")
    accs = [r["accuracy"] for r in res["history"]]
    require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
            "churn run: accuracies out of range")
    print(f"run_async_experiment buffered churn MarkovAvailability(p_drop={CHURN_P_DROP}) "
          f"k={K} cycles={CYCLES}: online by block {cpu_s['masks'].sum(1).tolist()}, "
          f"{len(accs)} aggregations in {n_groups} groups, counters "
          f"{ {n: v for n, v in counters.items() if v} }; final accuracy {accs[-1]:.4f}; "
          f"{1e3 * wall / len(accs):.2f} ms per aggregation; launches {counts}")

    # -- 7e. budgeted pgd on the card ------------------------------------------
    energy_launches += pgd_step(dev, budgeted)

    return {"name": "waterfill_energy_residual", "route": "cuda",
            "source": "src/repro_torch/csrc/waterfill.cu",
            "replaces": "src/repro/kernels/waterfill.py:117",
            "launches": energy_launches, "max_abs_err": ew_err[torch.float64],
            "ms": f64["ms"], "plain_ms": f64["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "bytes" if f64["bytes_ms"] >= f64["ops_ms"] else "operations",
            "library_ms": None}


def pgd_step(dev, prob) -> int:
    """Phase 7e: budgeted ``pgd`` re-solves (``solve_policy_row``, float64)
    and the per-problem ``solve_pgd_jax`` (float32) on the card against the
    CPU. The 600-step gradient stage is chaotic (a start one ulp away moves
    the budgeted allocation tens of samples; ``tests/test_torch_solver_numeric.py``),
    so card and CPU are held to the same feasibility, sample sum and budget,
    and their distance is reported. Returns the re-solves' energy
    water-filling launches."""
    import numpy as np
    import torch

    from repro_torch.core import CapacityDrift
    from repro_torch.core.staleness import max_staleness
    from repro_torch.fed.orchestrator import _solver, solve_policy_row

    c2s, c1s, c0s = CapacityDrift(seed=SEED).coefficient_path(prob.time_model, PGD_RESOLVES)
    eb = prob.energy_rows()[3]

    def resolves(device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = [solve_policy_row("pgd", c2s[c], c1s[c], c0s[c], prob, label=f"pgd row {c}",
                                 device=device) for c in range(PGD_RESOLVES)]
        torch.cuda.synchronize()
        return rows, 1e3 * (time.perf_counter() - t0) / PGD_RESOLVES

    reset_launches()
    card, card_ms = resolves(dev)
    counts = read_launches()
    require(counts == {"train_agg_step": 0, "accum_flush": 0, "fed_agg": 0,
                       "waterfill_residual": 0, "waterfill_energy_residual": PGD_RESOLVES,
                       "flash_attention": 0, "flash_attention_bwd": 0, "wkv6": 0,
                       "wkv6_bwd": 0, "mamba_scan": 0, "mamba_scan_bwd": 0, "swiglu": 0},
            f"budgeted pgd re-solves: kernel launches {counts}, want one energy "
            f"water-filling each of {PGD_RESOLVES}")
    cpu, cpu_ms = resolves("cpu")
    same, dmax, sgap = 0, 0, 0
    for c, ((tau, d), (tau_h, d_h)) in enumerate(zip(card, cpu)):
        require(int(d.sum()) == int(d_h.sum()) == prob.total_samples,
                f"pgd row {c}: sample sums card {d.sum()}, CPU {d_h.sum()}")
        for name, (t_, d_) in (("card", (tau, d)), ("CPU", (tau_h, d_h))):
            require(bool((prob.energy.cycle_energy(t_, d_) <= eb * (1 + 1e-9)).all()),
                    f"pgd row {c}: the {name}'s allocation overspends its budget")
        same += int(np.array_equal(tau, tau_h) and np.array_equal(d, d_h))
        dmax = max(dmax, int(np.abs(d - d_h).max()))
        sgap = max(sgap, abs(max_staleness(tau) - max_staleness(tau_h)))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = _solver("pgd", dev)(prob)
    torch.cuda.synchronize()
    one_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    one_h = _solver("pgd", "cpu")(prob)
    one_cpu_ms = 1e3 * (time.perf_counter() - t0)
    require(one.method == one_h.method == "pgd_energy_sai"
            and int(one.d.sum()) == int(one_h.d.sum()),
            f"solve_pgd_jax card {one.method}/{one.d.sum()} vs CPU {one_h.method}/"
            f"{one_h.d.sum()}")
    require(bool((prob.energy.cycle_energy(one.tau, one.d) <= eb * (1 + 1e-9)).all()),
            "solve_pgd_jax on the card overspends its budget")
    print(f"budgeted pgd k={prob.num_learners}: {PGD_RESOLVES} solve_policy_row re-solves "
          f"(float64) {card_ms:.1f} ms each on the card, {cpu_ms:.1f} ms on the CPU (host "
          f"clock); launches {counts}; equal to the CPU on {same} of {PGD_RESOLVES} rows, "
          f"max |d card - d CPU| {dmax}, max staleness gap {sgap}; solve_pgd_jax (float32) "
          f"{one_ms:.1f} ms on the card, {one_cpu_ms:.1f} ms on the CPU, max |d card - d "
          f"CPU| {int(np.abs(one.d - one_h.d).max())}, max staleness "
          f"{max_staleness(one.tau)} / {max_staleness(one_h.tau)}; 0 budget violations")
    return counts["waterfill_energy_residual"]


def serve_breakdown(arch, model, params, cache, tokens, tok, t0, t1, t2, gen) -> None:
    """Device time by kernel (``torch.profiler``) over one more prefill and
    one more decode step (at the cache's last position), beside the wall
    time of the timed prefill (t0 to t1) and decode step (t1 to t2, over
    ``gen - 1`` steps): the device's idle share of each. ``tokens`` is the
    prompt's tokens or the family's input dict (``serve.prompt_batch``)."""
    from repro_torch.launch import serve

    s = serve.start_position(model.cfg, tokens)
    for what, fn, wall_ms in (
            ("prefill", lambda: serve.prefill(model, params, tokens, s + gen),
             1e3 * (t1 - t0)),
            ("decode step", lambda: serve.decode(model, params, cache, tok, s + gen - 1, 1),
             1e3 * (t2 - t1) / (gen - 1))):
        rows = device_time_by_kernel(fn)
        busy = sum(ms for _, ms, _ in rows)
        print(f"serve {arch} {what}: device busy {busy:.2f} ms (torch.profiler) of "
              f"{wall_ms:.2f} ms wall ({100 * (1 - busy / wall_ms):.0f}% idle) in "
              f"{sum(n for *_, n in rows)} launches" if rows else
              f"serve {arch} {what}: device time not measured (no device events)")
        # the most time first, and the repository's own kernels wherever they rank
        for name, ms, calls in rows[:10] + [row for row in rows[10:]
                                           if "(anonymous namespace)::" in row[0]]:
            print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")


@contextlib.contextmanager
def plain_attention():
    """``ops.flash_attention`` bound to its plain version, the chunked scan
    ``models.layers.flash_attention`` (what the CPU runs), for the duration;
    restored on leaving. This script's comparison only: the package has no
    such switch, and on the card it always launches the kernel."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    kernel = ops.flash_attention
    ops.flash_attention = layers.flash_attention
    try:
        yield
    finally:
        ops.flash_attention = kernel


def flash_case(dev, name, b, s, h, kvh, d, dtype, causal, window, iters, skv=None) -> dict:
    """Phase 8a, one case: the kernel against its plain version (in bf16
    also against the float32 kernel), timed with its plain version, its
    bound and ``scaled_dot_product_attention``. ``s`` queries attend to
    ``skv`` keys (default ``s``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref
    from repro_torch.models import layers

    dtype = getattr(torch, dtype)
    skv = s if skv is None else skv
    gen = torch.Generator(device=dev).manual_seed(SEED + s + d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, s, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))
    kw = dict(causal=causal, window=window)
    score_bytes = 4 * b * s * h * skv
    if score_bytes <= DENSE_REF_BYTES:
        plain_name, plain = "dense ref.flash_attention_ref", ref.flash_attention_ref
    else:
        plain_name, plain = "chunked layers.flash_attention", layers.flash_attention
    got = flash_attention.flash_attention_cuda(q, k, v, **kw)
    want = plain(q, k, v, **kw)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{name}: the kernel gave non-finite values")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    tol = FLASH_TOL[str(dtype).removeprefix("torch.")]
    require(err <= tol * scale, f"{name}: the kernel differs from its plain version "
            f"({plain_name}) by {err:g} > {tol} x {scale:g}")
    f32_step_err = None
    if dtype == torch.bfloat16:
        # the tensor-core kernel against the float32 (CUDA-core) kernel on the
        # same inputs widened: within one bf16 step of the output's scale
        f32 = flash_attention.flash_attention_cuda(q.float(), k.float(), v.float(), **kw)
        f32 = f32.to(torch.bfloat16).float()
        f32_step_err = (got.float() - f32).abs().max().item()
        step = 2.0 ** (math.floor(math.log2(f32.abs().max().item())) - 7)
        del f32
        require(f32_step_err <= step, f"{name}: the bf16 kernel differs from the float32 "
                f"kernel by {f32_step_err:g}, more than one bf16 step ({step:g})")
    ms = cuda_ms(lambda: flash_attention.flash_attention_cuda(q, k, v, **kw), iters)
    plain_ms = cuda_ms(lambda: plain(q, k, v, **kw), max(2, iters // 4))
    # the library call, in its (B, H, S, d) layout; a window goes in as a
    # boolean mask, with the kv heads repeated (the masked kernels take no
    # grouped heads)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window is None:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)
    else:
        require(skv == s, f"{name}: a window case needs Sq = Skv")
        pos = torch.arange(s, device=dev)
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
        kt, vt = (t.repeat_interleave(h // kvh, dim=1) for t in (kt, vt))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    lib_err = (library().transpose(1, 2).float() - want.float()).abs().max().item()
    library_ms = cuda_ms(library, iters)
    flops, nbytes = kernel_cost.flash_attention(b, s, skv, h, kvh, d, causal=causal,
                                                window=window, itemsize=q.element_size())
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES_PER_S
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err}
    print(f"flash_attention {name}: B {b}, S {s}"
          f"{'' if skv == s else f' against Skv {skv}'}, {h}/{kvh} heads, d {d}, "
          f"{str(dtype).removeprefix('torch.')}, causal {causal}, window {window}: "
          f"max_abs_err {err:.3g} vs {plain_name} (<= {tol} x {scale:.3g}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (max_abs_err "
          f"{lib_err:.3g}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{flops:.4g} FLOPs at {peak / 1e12:g} TFLOP/s, {nbytes:.4g} bytes); kernel at "
          f"{flops / (ms * 1e9):.1f} TFLOP/s, sdpa at {flops / (library_ms * 1e9):.1f}"
          + ("" if f32_step_err is None else
             f"; vs the float32 kernel {f32_step_err:.3g} (<= one bf16 step)"))
    return row


def serve_phase(dev) -> tuple[dict, dict, dict]:
    """Phase 8; returns the attention kernel's entry of the kernels line,
    phase 8a's row of the bf16 Whisper encoder case, and the first
    ``TRAIN_LAYERS`` layers of the serve's weights (with its embedding,
    head and final norm) copied to the host, which phase 15 trains."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    # -- 8a. the kernel against its plain version at the path's shapes -------
    rows = [flash_case(dev, *case) for case in FLASH_CASES]
    main_case = rows[0]
    whisper_case = rows[[case[0] for case in FLASH_CASES].index("whisper-small encoder")]
    torch.cuda.empty_cache()

    # -- 8b. the serve at full width -------------------------------------------
    cfg = get_config(SERVE_ARCH)
    b, s, gen = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = serve.prompt_tokens(cfg, b, s, SEED, dev)
    with torch.inference_mode():
        serve.prefill(model, params, tokens, s + gen)       # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        logits, cache, tok = serve.prefill(model, params, tokens, s + gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_prefill = read_launches()
        rest, _ = serve.decode(model, params, cache, tok, s, gen - 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after_decode = read_launches()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        tokens_out = torch.cat([tok, rest], dim=1)
        nothing = {name: 0 for name in after_decode}
        require(after_prefill == {**nothing, "flash_attention": cfg.num_layers},
                f"the prefill's kernel launches were {after_prefill}, want "
                f"{cfg.num_layers} flash_attention and no other")
        require(after_decode == after_prefill,
                f"decode launched kernels: {after_prefill} after the prefill, "
                f"{after_decode} after decode")
        require(tuple(logits.shape) == (b, 1, cfg.vocab_size)
                and bool(torch.isfinite(logits).all()), "the prefill's logits are not "
                f"finite of shape ({b}, 1, {cfg.vocab_size})")
        require(tuple(tokens_out.shape) == (b, gen) and int(tokens_out.min()) >= 0
                and int(tokens_out.max()) < cfg.vocab_size, "generated tokens out of range")
        require(all(bool(torch.isfinite(t).all()) for blk in cache["blocks"]
                    for t in blk["mixer"].values()), "the KV cache is not finite")
        # where the time goes: device time by kernel over one prefill and
        # one decode step (the cache's last free slot), beside their wall time
        serve_breakdown(SERVE_ARCH, model, params, cache, tokens, tok, t0, t1, t2, gen)
        with plain_attention():
            p_logits, p_cache, p_tok = serve.prefill(model, params, tokens, s + gen)
            p_rest, _ = serve.decode(model, params, p_cache, p_tok, s, gen - 1)
        del p_cache
        p_tokens = torch.cat([p_tok, p_rest], dim=1)
        err = (logits.float() - p_logits.float()).abs().max().item()
        scale = p_logits.float().abs().max().item()
        require(err <= SERVE_BF16_TOL * scale, f"the bf16 serve's logits differ from the "
                f"plain attention's by {err:g} > {SERVE_BF16_TOL} x {scale:g}")
    del cache, p_logits
    # -- 16b. one prefill at this shape, counted while its kernels run --------
    with torch.inference_mode():
        count_phase(dev, "16b prefill", cfg, InputShape("8b", s, b, "prefill"), params,
                    ({"tokens": tokens.to(torch.int32)},), {"flash_attention": cfg.num_layers})
    prefill_ms, decode_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (gen - 1)
    agree = float((tokens_out == p_tokens).float().mean().item())
    first = float((tokens_out[:, 0] == p_tokens[:, 0]).float().mean().item())
    print(f"serve {SERVE_ARCH} ({model.param_count()} params, {cfg.param_dtype}): init "
          f"{init_s:.1f} s (drawn on the host, copied to the card); prefill {b}x{s} "
          f"{prefill_ms:.1f} ms; decode {gen - 1} steps {decode_ms:.2f} ms a step "
          f"({b * 1e3 / decode_ms:.1f} tok/s); peak memory {peak_gb:.2f} GB; launches "
          f"prefill {after_prefill['flash_attention']}, decode "
          f"{after_decode['flash_attention'] - after_prefill['flash_attention']}; "
          f"last-position logits vs plain attention max_abs_err {err:.3g}, "
          f"{err / scale:.3g} of their scale {scale:.3g} (<= {SERVE_BF16_TOL}); greedy agreement with plain: first token "
          f"{first:.2f}, all {gen} tokens {agree:.3f}; sample {tokens_out[0, :8].tolist()}")

    train_weights = cut_layers(params, TRAIN_LAYERS, "cpu")

    # -- 8c. float32 at 2 layers: kernel vs plain, tight -----------------------
    cfg32 = dataclasses.replace(cfg, num_layers=E2E_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    m32 = Model(cfg32, device=dev)
    p32 = {name: (leaf.float() if torch.is_tensor(leaf) else leaf)
           for name, leaf in params.items() if name != "blocks"}
    p32["blocks"] = [{name: {n: t[:E2E_LAYERS].float() for n, t in sub.items()}
                      if isinstance(sub, dict) else sub[:E2E_LAYERS].float()
                      for name, sub in blk.items()} for blk in params["blocks"]]
    del params
    torch.cuda.empty_cache()
    runs = {}
    with torch.inference_mode():
        for name, ctx in (("kernel", contextlib.nullcontext()), ("plain", plain_attention())):
            with ctx:
                lg, c32, t = serve.prefill(m32, p32, tokens, s + E2E_STEPS + 1)
                steps, logits_seq = [t], [lg]
                for i in range(E2E_STEPS):
                    lg, c32 = m32.decode(p32, c32, t, s + i)
                    t = torch.argmax(lg[:, -1:], dim=-1)
                    steps.append(t)
                    logits_seq.append(lg)
                runs[name] = (torch.cat(steps, dim=1), logits_seq)
                del c32
    e2e_err = max((a - w).abs().max().item() / w.abs().max().item()
                  for a, w in zip(runs["kernel"][1], runs["plain"][1]))
    require(e2e_err <= E2E_TOL, f"float32 {E2E_LAYERS}-layer serve: logits differ from "
            f"plain attention by {e2e_err:g} of their scale > {E2E_TOL}")
    require(torch.equal(runs["kernel"][0], runs["plain"][0]),
            f"float32 {E2E_LAYERS}-layer serve: greedy tokens differ from plain attention")
    print(f"float32 {E2E_LAYERS}-layer {SERVE_ARCH} serve {b}x{s}, kernel vs plain "
          f"attention: logits max relative error {e2e_err:.3g} (<= {E2E_TOL}) over the "
          f"prefill and {E2E_STEPS} decode steps; greedy tokens equal "
          f"({runs['kernel'][0].numel()})")
    del p32
    torch.cuda.empty_cache()

    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:91",
            "launches": after_decode["flash_attention"], **main_case}, whisper_case, train_weights


@contextlib.contextmanager
def plain_wkv():
    """``ops.wkv6`` bound to its plain version, the step loop
    ``ref.wkv6_ref`` (what the CPU runs), for the duration; restored on
    leaving. This script's comparison only: the package has no such
    switch, and on the card it always launches the kernel."""
    from repro_torch.kernels import ops, ref

    kernel = ops.wkv6

    def plain(r, k, v, w, u, s0=None, *, out_state=None, **_):
        y, s_last = ref.wkv6_ref(r, k, v, w, u, s0)
        return y, (s_last if out_state is None else out_state.copy_(s_last))

    ops.wkv6 = plain
    try:
        yield
    finally:
        ops.wkv6 = kernel


def wkv_chunk_work(b: int, s: int, h: int, hd: int, bf16: bool) -> tuple[int, int]:
    """The chunk kernel's executed work at (B, S, H, hd), from its design
    (csrc/wkv6.cu): (tensor-core FLOPs, CUDA-core flops of the triangles).
    A CTA owns (b, h, nj = min(hd, 64) columns) in warps of 32 columns and
    walks ceil(S / 64) chunks; per chunk, m16n8k8 products of 2048 FLOPs:
    the six blocks between sub-chunks (two 8-column halves each) and the
    four squares, 3 a k-step of 8 over hd; the cross term, 3; the state
    update (hd / 16 row tiles, 8 k-steps) and A V (2 (m + 1) k-steps for
    the rows of sub-chunk m), 2 where V is bf16, else 3; 4 n-tiles a warp.
    The triangles: per half of 8 rows, 32 lanes, hd / 16 float4 channel
    groups a lane, 7 row slots of 4 FMAs and 4 multiplies (12 flops)."""
    chunks = -(-s // 64)
    ks = hd // 8
    nj = min(hd, 64)
    col_warps = nj // 32
    pv = 2 if bf16 else 3
    mma = (6 * 2 * ks * 3 + 4 * ks * 3
           + col_warps * 4 * ks * 4 * 3
           + col_warps * (hd // 16) * 8 * 4 * pv
           + col_warps * 20 * 4 * pv)
    ctas = b * h * (hd // nj)
    triangles = 8 * 32 * (hd // 16) * 7 * 12
    return 2048 * mma * chunks * ctas, triangles * chunks * ctas


def wkv_step64(r, k, v, w, u, s0):
    """The WKV-6 step loop in float64 (the recurrence of ``ref.wkv6_ref``)."""
    import torch

    b, s, h, hd = r.shape
    rf, kf, vf, wf = (t.to(torch.float64) for t in (r, k, v, w))
    uf = u.to(torch.float64)[..., :, None]
    state = s0.to(torch.float64).clone()
    y = torch.empty((b, s, h, hd), dtype=torch.float64, device=r.device)
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        y[:, t] = torch.einsum("bhi,bhij->bhj", rf[:, t], state + uf * kv)
        state = wf[:, t, :, :, None] * state + kv
    return y, state


def wkv_case(dev, name, b, s, h, hd, dtype, with_state, in_place, decays, iters) -> dict:
    """Phase 9a, one case: the kernel against the step loop, timed with it
    and beside its bound. ``in_place``: the kernel writes the state over a
    copy of s0, as decode writes the cache. ``decays``: "zero" sets some
    channels' w to 0 (whole channels, and single steps of others), "one"
    some within 1e-7 of 1 (WKV_CASES says which oracle holds which)."""
    import torch

    from repro_torch.kernels import ref, wkv6

    dtype = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + s + hd)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = (randn(b, s, h, hd).mul_(0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, s, h, hd) - 1.0))
    if decays == "zero":
        w[..., ::7] = 0.0
        w[:, ::13, :, 1::5] = 0.0
    elif decays == "one":
        w[..., 3::7] = 1.0 - 1e-7 * torch.rand(w[..., 3::7].shape, generator=gen, device=dev)
    u = randn(h, hd).mul_(0.1)
    s0 = randn(b, h, hd, hd).mul_(0.1) if with_state else None
    state = s0.clone() if in_place else None
    got_y, got_s = wkv6.wkv6_cuda(r, k, v, w, u, state if in_place else s0, out_state=state)
    want_y, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
    oracle = "the float32 step loop"
    if decays == "one" and s >= 1000:
        f32 = (want_y, want_s)
        want_y, want_s = wkv_step64(r, k, v, w, u, s0)
        drift = max((a - p).abs().max().item() / max(1.0, p.abs().max().item())
                    for a, p in zip(f32, (want_y, want_s)))
        oracle = (f"a float64 step loop (the float32 step loop is {drift:.3g} of max(1, "
                  f"scale) from it)")
    torch.cuda.synchronize()
    require(not in_place or got_s.data_ptr() == state.data_ptr(),
            f"wkv6 {name}: the state was not written over s0")
    err = 0.0
    for what, got, want in (("y", got_y, want_y), ("s_last", got_s, want_s)):
        require(bool(torch.isfinite(got).all()), f"wkv6 {name}: non-finite {what}")
        e = (got.double() - want.double()).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        require(e <= WKV_TOL * scale, f"wkv6 {name}: the kernel's {what} differs from "
                f"{oracle} by {e:g} > {WKV_TOL} x {scale:g}")
        err = max(err, e)

    def kernel():
        return wkv6.wkv6_cuda(r, k, v, w, u, state if in_place else s0, out_state=state)

    chunked = s >= wkv6.CHUNKED_MIN_SEQ
    kname = "chunk_kernel" if chunked else "wkv6_kernel"
    require(wkv6.last_kernel == ("chunked" if chunked else "step"),
            f"wkv6 {name}: S = {s} ran the {wkv6.last_kernel} kernel")
    # the least of three timings: CUDA events also count the gaps when the
    # host stalls between launches (a decode step's launch is the host's
    # time), so the profiler's device time a launch stands beside them
    ms = min(cuda_ms(kernel, iters) for _ in range(3))
    dev_ms = kernel_device_ms(kernel, kname, min(iters, 20))
    plain_ms = cuda_ms(lambda: ref.wkv6_ref(r, k, v, w, u, s0), max(2, iters // 5))
    # r, k, v read once in their dtype, w read and y written in float32, u
    # and s0 read once, s_last written once; the least work: y_j = sum_i
    # r_i S_ij + v_j sum_i r_i u_i k_i and S_ij <- w_i S_ij + k_i v_j, 5
    # float32 operations per (b, h, t, i, j) and 5 per (b, h, t, j)
    flops, nbytes = kernel_cost.wkv6(b, s, h, hd, itemsize=r.element_size(),
                                     with_state=with_state)
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err,
           "device_ms": dev_ms, "kernel": "chunk" if chunked else "step"}
    design = ""
    if chunked:
        tensor, tri = wkv_chunk_work(b, s, h, hd, dtype == torch.bfloat16)
        design = (f"; the chunk design executes {tensor:.4g} tensor FLOPs as 3xTF32 "
                  f"({1e3 * tensor / PEAK_TF32_FLOPS:.4f} ms at {PEAK_TF32_FLOPS / 1e12:g} "
                  f"TF32 TFLOP/s) and {tri:.4g} flops of triangles on the CUDA cores "
                  f"({1e3 * tri / PEAK_FP32_FLOPS:.4f} ms)")
    print(f"wkv6 {name}: B {b}, S {s}, {h} heads of {hd}, {str(dtype).removeprefix('torch.')} "
          f"r/k/v, s0 {'given' if with_state else 'none'}{', state in place' if in_place else ''}"
          f"{', decays ' + decays if decays else ''}: {row['kernel']} kernel, max_abs_err "
          f"{err:.3g} against {oracle} (<= {WKV_TOL} x max(1, scale)); kernel {ms:.4f} ms "
          f"(CUDA events, the "
          f"least of 3 timings; device time {dev_ms:.4f} ms a launch by torch.profiler), plain "
          f"{plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {flops:.4g} "
          f"FP32 FLOPs at {PEAK_FP32_FLOPS / 1e12:g} TFLOP/s, {nbytes:.4g} bytes); kernel at "
          f"{flops / (ms * 1e9):.1f} TFLOP/s, {row['bound_ms'] / ms:.3f} of the bound{design}")
    return row


def rwkv_phase(dev) -> tuple[dict, dict]:
    """Phase 9; returns the WKV kernel's entry of the kernels line and the
    first ``RWKV_TRAIN_LAYERS`` layers of the serve's weights (with its
    embedding, head and norms) copied to the host, which phase 15e
    trains."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    # -- 9a. the kernel against the step loop at the path's shapes -----------
    rows = [wkv_case(dev, *case) for case in WKV_CASES]
    main_case = {key: rows[0][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                               "bound_by", "max_abs_err")}
    torch.cuda.empty_cache()

    # -- 9b. the serve at full width -------------------------------------------
    cfg = get_config(RWKV_ARCH)
    b, s, gen = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = serve.prompt_tokens(cfg, b, s, SEED, dev)
    with torch.inference_mode():
        serve.prefill(model, params, tokens, s + gen)       # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        logits, cache, tok = serve.prefill(model, params, tokens, s + gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_prefill = read_launches()
        rest, _ = serve.decode(model, params, cache, tok, s, gen - 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after_decode = read_launches()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        tokens_out = torch.cat([tok, rest], dim=1)
        nothing = {name: 0 for name in after_decode}
        layers = cfg.num_layers
        require(after_prefill == {**nothing, "wkv6": layers},
                f"the prefill's kernel launches were {after_prefill}, want {layers} wkv6 "
                "and no other")
        require(after_decode == {**nothing, "wkv6": layers * gen},
                f"the serve's kernel launches were {after_decode} after {gen - 1} decode "
                f"steps, want {layers} wkv6 a step and no other")
        require(tuple(logits.shape) == (b, 1, cfg.vocab_size)
                and bool(torch.isfinite(logits).all()), "the prefill's logits are not "
                f"finite of shape ({b}, 1, {cfg.vocab_size})")
        require(tuple(tokens_out.shape) == (b, gen) and int(tokens_out.min()) >= 0
                and int(tokens_out.max()) < cfg.vocab_size, "generated tokens out of range")
        require(all(bool(torch.isfinite(t).all()) for blk in cache["blocks"]
                    for part in blk.values() for t in part.values()),
                "the RWKV state cache is not finite")
        serve_breakdown(RWKV_ARCH, model, params, cache, tokens, tok, t0, t1, t2, gen)
        with plain_wkv():
            p_logits, p_cache, p_tok = serve.prefill(model, params, tokens, s + gen)
            p_rest, _ = serve.decode(model, params, p_cache, p_tok, s, gen - 1)
        del p_cache
        p_tokens = torch.cat([p_tok, p_rest], dim=1)
        err = (logits.float() - p_logits.float()).abs().max().item()
        scale = p_logits.float().abs().max().item()
        require(err <= SERVE_BF16_TOL * scale, f"the bf16 RWKV-6 serve's logits differ from "
                f"the step loop's by {err:g} > {SERVE_BF16_TOL} x {scale:g}")
    del cache
    prefill_ms, decode_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (gen - 1)
    agree = float((tokens_out == p_tokens).float().mean().item())
    first = float((tokens_out[:, 0] == p_tokens[:, 0]).float().mean().item())
    print(f"serve {RWKV_ARCH} ({model.param_count()} params, {cfg.param_dtype}): init "
          f"{init_s:.1f} s (drawn on the host, copied to the card); prefill {b}x{s} "
          f"{prefill_ms:.1f} ms; decode {gen - 1} steps {decode_ms:.2f} ms a step "
          f"({b * 1e3 / decode_ms:.1f} tok/s); peak memory {peak_gb:.2f} GB; wkv6 launches "
          f"prefill {after_prefill['wkv6']}, decode "
          f"{after_decode['wkv6'] - after_prefill['wkv6']}; last-position logits vs the "
          f"step loop max_abs_err {err:.3g}, {err / scale:.3g} of their scale {scale:.3g} "
          f"(<= {SERVE_BF16_TOL}); greedy agreement with the step loop: first token "
          f"{first:.2f}, all {gen} tokens {agree:.3f}; sample {tokens_out[0, :8].tolist()}")

    train_weights = cut_layers(params, RWKV_TRAIN_LAYERS, "cpu")

    # -- 9c. float32 at 2 layers: kernel vs plain, tight -----------------------
    cfg32 = dataclasses.replace(cfg, num_layers=E2E_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    m32 = Model(cfg32, device=dev)
    p32 = {name: (leaf.float() if torch.is_tensor(leaf) else leaf)
           for name, leaf in params.items() if name != "blocks"}
    p32["blocks"] = [{name: {n: t[:E2E_LAYERS].float() for n, t in sub.items()}
                      if isinstance(sub, dict) else sub[:E2E_LAYERS].float()
                      for name, sub in blk.items()} for blk in params["blocks"]]
    del params
    torch.cuda.empty_cache()
    runs = {}
    with torch.inference_mode():
        for name, ctx in (("kernel", contextlib.nullcontext()), ("plain", plain_wkv())):
            with ctx:
                lg, c32, t = serve.prefill(m32, p32, tokens, s + E2E_STEPS + 1)
                steps, logits_seq = [t], [lg]
                for i in range(E2E_STEPS):
                    lg, c32 = m32.decode(p32, c32, t, s + i)
                    t = torch.argmax(lg[:, -1:], dim=-1)
                    steps.append(t)
                    logits_seq.append(lg)
                runs[name] = (torch.cat(steps, dim=1), logits_seq)
                del c32
    e2e_err = max((a - w).abs().max().item() / w.abs().max().item()
                  for a, w in zip(runs["kernel"][1], runs["plain"][1]))
    require(e2e_err <= E2E_TOL, f"float32 {E2E_LAYERS}-layer RWKV-6 serve: logits differ "
            f"from the step loop by {e2e_err:g} of their scale > {E2E_TOL}")
    require(torch.equal(runs["kernel"][0], runs["plain"][0]),
            f"float32 {E2E_LAYERS}-layer RWKV-6 serve: greedy tokens differ from the step loop")
    print(f"float32 {E2E_LAYERS}-layer {RWKV_ARCH} serve {b}x{s}, kernel vs the step loop: "
          f"logits max relative error {e2e_err:.3g} (<= {E2E_TOL}) over the prefill and "
          f"{E2E_STEPS} decode steps; greedy tokens equal ({runs['kernel'][0].numel()})")
    del p32
    torch.cuda.empty_cache()

    return {"name": "wkv6", "route": "cuda", "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:58",
            "launches": after_decode["wkv6"], **main_case}, train_weights



@contextlib.contextmanager
def plain_mamba():
    """``ops.mamba_scan`` bound to its plain version, the step loop
    ``ref.mamba_scan_ref`` (what the CPU runs), for the duration; restored
    on leaving. This script's comparison only: the package has no such
    switch, and on the card it always launches the kernel."""
    from repro_torch.kernels import ops, ref

    kernel = ops.mamba_scan

    def plain(dt, x, b, c, a, h0=None, *, out_state=None):
        y, h_last = ref.mamba_scan_ref(dt, x, b, c, a, h0)
        return y, (h_last if out_state is None else out_state.copy_(h_last))

    ops.mamba_scan = plain
    try:
        yield
    finally:
        ops.mamba_scan = kernel


def mamba_case(dev, name, b, s, d, n, dtype, with_state, in_place, decays, iters) -> dict:
    """Phase 10a, one case: the kernel against the step loop, timed with it
    and beside its bound and the SFU floor. ``in_place``: the kernel writes
    the state over a copy of h0, as a caller updating its state would;
    ``decays``: see MAMBA_CASES."""
    import torch

    from repro_torch.kernels import mamba_scan, ref

    dtype = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + s + d)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # dt around softplus(-4.6), a near the S4D init -(n + 1), as the layer makes them
    dt = torch.nn.functional.softplus(randn(b, s, d).mul_(2.0).sub_(4.6))
    x = randn(b, s, d).to(dtype)
    bm, cm = randn(b, s, n), randn(b, s, n)
    a = -torch.exp(torch.log(torch.arange(1, n + 1, device=dev, dtype=torch.float32))
                   + randn(d, n).mul_(0.1))
    if decays == "near1":
        dt = torch.rand(b, s, d, generator=gen, device=dev).mul_(9e-5).add_(1e-5)
        a = -torch.rand(d, n, generator=gen, device=dev).mul_(9e-3).add_(1e-3)
    elif decays == "underflow":
        dt[..., ::3] = torch.rand(dt[..., ::3].shape, generator=gen, device=dev).mul_(14.0) + 6.0
    h0 = randn(b, d, n) if with_state else None
    state = h0.clone() if in_place else None
    got_y, got_h = mamba_scan.mamba_scan_cuda(dt, x, bm, cm, a, state if in_place else h0,
                                              out_state=state)
    want_y, want_h = ref.mamba_scan_ref(dt, x, bm, cm, a, h0)
    oracle, tol = "the float32 step loop", MAMBA_TOL
    if decays == "near1" and with_state:
        f32 = (want_y, want_h)
        want_y, want_h = mamba_step64(dt, x, bm, cm, a, h0)
        drift = max((p.double() - w).abs().max().item() / max(1.0, w.abs().max().item())
                    for p, w in zip(f32, (want_y, want_h)))
        del f32
        oracle, tol = (f"a float64 step loop (the float32 step loop is {drift:.3g} of max(1, "
                       f"scale) from it)"), MAMBA_NEAR_ONE_TOL
    torch.cuda.synchronize()
    require(not in_place or got_h.data_ptr() == state.data_ptr(),
            f"mamba_scan {name}: the state was not written over h0")
    err = rel = 0.0
    for what, got, want in (("y", got_y, want_y), ("h_last", got_h, want_h)):
        require(bool(torch.isfinite(got).all()), f"mamba_scan {name}: non-finite {what}")
        e = (got.double() - want.double()).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        require(e <= tol * scale, f"mamba_scan {name}: the kernel's {what} differs "
                f"from {oracle} by {e:g} > {tol} x {scale:g}")
        err, rel = max(err, e), max(rel, e / scale)
    del want_y, want_h

    def kernel():
        return mamba_scan.mamba_scan_cuda(dt, x, bm, cm, a, state if in_place else h0,
                                          out_state=state)

    # the least of three timings, as phase 9a takes them
    ms = min(cuda_ms(kernel, iters) for _ in range(3))
    plain_ms = cuda_ms(lambda: ref.mamba_scan_ref(dt, x, bm, cm, a, h0), 2)
    # dt read and y written in float32, x read once in its dtype, b, c and a
    # read once, h0 read and h_last written once; the least work: dt a, its
    # exponential, h da + (dt x) B and the y sum, 6 float32 operations per
    # (b, t, d, n) counting the exponential as one, and dt x per (b, t, d)
    flops, nbytes = kernel_cost.mamba_scan(b, s, d, n, itemsize=x.element_size(),
                                           with_state=with_state)
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    # the SFU floor: every exponential one MUFU.EX2 (the kernel sends them
    # all there, none to the FMA pipes), 16 a clock an SM at the card's
    # highest SM clock
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sfu_ms = 1e3 * b * s * d * n / (16 * sms * max_sm_clock_mhz() * 1e6)
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err}
    print(f"mamba_scan {name}: B {b}, S {s}, D {d}, N {n}, "
          f"{str(dtype).removeprefix('torch.')} x, h0 {'given' if with_state else 'none'}"
          f"{', state in place' if in_place else ''}{', decays ' + decays if decays else ''}: "
          f"max_abs_err {err:.3g}, {rel:.3g} of max(1, scale), against {oracle} (<= {tol}); "
          f"kernel {ms:.4f} ms (CUDA events, the least of 3 timings), plain {plain_ms:.3f} ms, "
          f"bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes:.4g} bytes, {flops:.4g} FP32 "
          f"operations at {PEAK_FP32_FLOPS / 1e12:g} TFLOP/s); SFU floor {sfu_ms:.4f} ms "
          f"({b * s * d * n:.4g} exponentials at 16 a clock an SM, {sms} SMs at "
          f"{max_sm_clock_mhz():.0f} MHz; FMA-pipe share 0, every exponential on the SFU; "
          f"{mamba_lanes()} lanes a channel); {row['bound_ms'] / ms:.3f} of the bound, "
          f"{sfu_ms / ms:.3f} of the SFU floor, {b * s * d * n / (ms * 1e9):.1f} G state "
          f"updates/s")
    return row


def mamba_step64(dt, x, bm, cm, a, h0):
    """The selective-scan step loop in float64 (the recurrence of
    ``ref.mamba_scan_ref``)."""
    import torch

    dt, x, bm, cm, a, h = (t.to(torch.float64) for t in (dt, x, bm, cm, a, h0))
    y = torch.empty_like(dt)
    for t in range(dt.shape[1]):
        h = (h * torch.exp(dt[:, t, :, None] * a)
             + (dt[:, t] * x[:, t])[:, :, None] * bm[:, t, None, :])
        y[:, t] = torch.einsum("bdn,bn->bd", h, cm[:, t])
    return y, h


def mamba_lanes() -> int:
    """The lanes a channel of the scan kernel, read from its source."""
    src = os.path.join(ROOT, "src", "repro_torch", "csrc", "mamba_scan.cu")
    with open(src) as f:
        return int(re.search(r"constexpr int LANES = (\d+);", f.read())[1])


@functools.cache
def max_sm_clock_mhz() -> float:
    """The card's highest SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.split()
    return float(out[0])


def _positions(tree, layers: int, fn):
    """A params tree with every leaf through ``fn`` and its stacked blocks
    cut to their first ``layers`` period positions."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        return None if t is None else fn(t)

    out = {k: conv(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = conv(tree["blocks"][:layers])
    return out


def jamba_phase(dev) -> tuple[dict, dict]:
    """Phase 10; returns the scan kernel's entry of the kernels line and the
    period's first ``JAMBA_TRAIN_LAYERS`` layers of the serve's weights
    (with its embedding, head and norms) copied to the host, which phase
    15e trains."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    # -- 10a. the kernel against the step loop at the path's shapes ----------
    rows = [mamba_case(dev, *case) for case in MAMBA_CASES]
    main_case = {key: rows[0][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                               "bound_by", "max_abs_err")}
    torch.cuda.empty_cache()

    # -- 10b. the serve at full width, one period ------------------------------
    cfg = dataclasses.replace(get_config(JAMBA_ARCH), num_layers=JAMBA_LAYERS)
    kinds = cfg.layer_kinds()
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
    b, s, gen = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = serve.prompt_tokens(cfg, b, s, SEED, dev)
    with torch.inference_mode():
        serve.prefill(model, params, tokens, s + gen)       # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        logits, cache, tok = serve.prefill(model, params, tokens, s + gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_prefill = read_launches()
        rest, _ = serve.decode(model, params, cache, tok, s, gen - 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after_decode = read_launches()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        tokens_out = torch.cat([tok, rest], dim=1)
        nothing = {name: 0 for name in after_decode}
        want = {**nothing, "mamba_scan": n_mamba, "flash_attention": n_attn}
        require((n_mamba, n_attn) == (7, 1) and after_prefill == want,
                f"the prefill's kernel launches were {after_prefill}, want {want}")
        require(after_decode == after_prefill,
                f"decode launched kernels: {after_prefill} after the prefill, "
                f"{after_decode} after decode")
        require(tuple(logits.shape) == (b, 1, cfg.vocab_size)
                and bool(torch.isfinite(logits).all()), "the prefill's logits are not "
                f"finite of shape ({b}, 1, {cfg.vocab_size})")
        require(tuple(tokens_out.shape) == (b, gen) and int(tokens_out.min()) >= 0
                and int(tokens_out.max()) < cfg.vocab_size, "generated tokens out of range")
        require(all(bool(torch.isfinite(t).all()) for blk in cache["blocks"]
                    for t in blk["mixer"].values()), "the Jamba cache is not finite")
        serve_breakdown(JAMBA_ARCH, model, params, cache, tokens, tok, t0, t1, t2, gen)
        with plain_mamba():
            p_logits, p_cache, p_tok = serve.prefill(model, params, tokens, s + gen)
            p_rest, _ = serve.decode(model, params, p_cache, p_tok, s, gen - 1)
        del p_cache
        p_tokens = torch.cat([p_tok, p_rest], dim=1)
        err = (logits.float() - p_logits.float()).abs().max().item()
        scale = p_logits.float().abs().max().item()
        require(err <= SERVE_BF16_TOL * scale, f"the bf16 Jamba serve's logits differ from "
                f"the step loop's by {err:g} > {SERVE_BF16_TOL} x {scale:g}")
    del cache
    prefill_ms, decode_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (gen - 1)
    agree = float((tokens_out == p_tokens).float().mean().item())
    first = float((tokens_out[:, 0] == p_tokens[:, 0]).float().mean().item())
    print(f"serve {JAMBA_ARCH}, {JAMBA_LAYERS} of its 32 layers ({model.param_count()} "
          f"params, {cfg.param_dtype}): init {init_s:.1f} s (drawn on the host, copied to "
          f"the card); prefill {b}x{s} {prefill_ms:.1f} ms; decode {gen - 1} steps "
          f"{decode_ms:.2f} ms a step ({b * 1e3 / decode_ms:.1f} tok/s); peak memory "
          f"{peak_gb:.2f} GB; launches prefill mamba_scan {after_prefill['mamba_scan']}, "
          f"flash_attention {after_prefill['flash_attention']}, decode none; last-position "
          f"logits vs the step loop max_abs_err {err:.3g}, {err / scale:.3g} of their scale "
          f"{scale:.3g} (<= {SERVE_BF16_TOL}); greedy agreement with the step loop: first "
          f"token {first:.2f}, all {gen} tokens {agree:.3f}; sample "
          f"{tokens_out[0, :8].tolist()}")

    # -- 10c. float32 at 2 layers (Mamba+MoE, Mamba+dense): kernel vs plain ------
    cfg32 = dataclasses.replace(cfg, num_layers=E2E_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    m32 = Model(cfg32, device=dev)
    require([(k, moe) for k, moe in zip(cfg32.layer_kinds(), cfg32.layer_is_moe())]
            == [("mamba", True), ("mamba", False)], "the float32 gate's layers are not "
            "a Mamba+MoE and a Mamba+dense layer")
    p32 = _positions(params, E2E_LAYERS, lambda t: t.float())
    train_weights = _positions(params, JAMBA_TRAIN_LAYERS, lambda t: t.to("cpu", copy=True))
    del params
    torch.cuda.empty_cache()
    runs = {}
    with torch.inference_mode():
        for name, ctx in (("kernel", contextlib.nullcontext()), ("plain", plain_mamba())):
            with ctx:
                reset_launches()
                lg, c32, t = serve.prefill(m32, p32, tokens, s + E2E_STEPS + 1)
                launched = read_launches()["mamba_scan"]
                steps, logits_seq = [t], [lg]
                for i in range(E2E_STEPS):
                    lg, c32 = m32.decode(p32, c32, t, s + i)
                    t = torch.argmax(lg[:, -1:], dim=-1)
                    steps.append(t)
                    logits_seq.append(lg)
                runs[name] = (torch.cat(steps, dim=1), logits_seq, launched)
                del c32
    require((runs["kernel"][2], runs["plain"][2]) == (E2E_LAYERS, 0),
            f"float32 gate: scan launches {runs['kernel'][2]} (kernel) and "
            f"{runs['plain'][2]} (plain), want {E2E_LAYERS} and 0")
    e2e_err = max((a - w).abs().max().item() / w.abs().max().item()
                  for a, w in zip(runs["kernel"][1], runs["plain"][1]))
    require(e2e_err <= E2E_TOL, f"float32 {E2E_LAYERS}-layer Jamba serve: logits differ "
            f"from the step loop by {e2e_err:g} of their scale > {E2E_TOL}")
    require(torch.equal(runs["kernel"][0], runs["plain"][0]),
            f"float32 {E2E_LAYERS}-layer Jamba serve: greedy tokens differ from the step loop")
    print(f"float32 {E2E_LAYERS}-layer {JAMBA_ARCH} serve (Mamba+MoE, Mamba+dense) {b}x{s}, "
          f"kernel vs the step loop: logits max relative error {e2e_err:.3g} (<= {E2E_TOL}) "
          f"over the prefill and {E2E_STEPS} decode steps; greedy tokens equal "
          f"({runs['kernel'][0].numel()})")
    del p32
    torch.cuda.empty_cache()

    return {"name": "mamba_scan", "route": "cuda", "source": "src/repro_torch/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan.py:61",
            "launches": after_decode["mamba_scan"], **main_case}, train_weights


def swiglu_case(dev, name, m, d, f, dtype, iters) -> dict:
    """Phase 11, one case: the kernel against its plain version on the
    widened inputs, timed with it, its bound and the library call (the
    three cuBLAS products of ``layers.swiglu`` in the inputs' dtype)."""
    import torch

    from repro_torch.kernels import ref, swiglu
    from repro_torch.models import layers

    name_dtype = dtype
    dtype = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + m + f)
    x = torch.randn((m, d), generator=gen, device=dev).to(dtype)
    wg, wu = (torch.randn((d, f), generator=gen, device=dev).div_(math.sqrt(d)).to(dtype)
              for _ in range(2))
    wd = torch.randn((f, d), generator=gen, device=dev).div_(math.sqrt(f)).to(dtype)
    wide = [t.float() for t in (x, wg, wu, wd)]
    got = swiglu.swiglu_cuda(x, wg, wu, wd)
    want = ref.swiglu_ref(*wide)
    torch.cuda.synchronize()
    require(got.dtype == dtype and bool(torch.isfinite(got).all()),
            f"swiglu {name}: the kernel gave non-finite values or the wrong dtype")
    err = (got.float() - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    tol = SWIGLU_TOL[name_dtype]
    require(err <= tol * scale, f"swiglu {name}: the kernel differs from its plain version "
            f"by {err:g} > {tol} x {scale:g}")
    ms = min(cuda_ms(lambda: swiglu.swiglu_cuda(x, wg, wu, wd), iters) for _ in range(3))
    plain_ms = cuda_ms(lambda: ref.swiglu_ref(*wide), iters)
    library_ms = cuda_ms(lambda: layers.swiglu(x, wg, wu, wd), iters)
    lib_err = (layers.swiglu(x, wg, wu, wd).float() - want).abs().max().item()
    del wide
    flops, nbytes = kernel_cost.swiglu(m, d, f, itemsize=x.element_size())
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES_PER_S
    # the work the design executes on the tensor cores: in bf16 the gate and
    # up products and the down product once a piece of h; in float32 every
    # product three times (3xTF32)
    if dtype == torch.bfloat16:
        done, done_peak = (4 + 2 * swiglu.H_PIECES) * m * d * f, PEAK_BF16_FLOPS
        how = f"{swiglu.H_PIECES} bf16 pieces of h"
    else:
        done, done_peak = 3 * flops, PEAK_TF32_FLOPS
        how = "3xTF32"
    done_ms = 1e3 * done / done_peak
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err}
    print(f"swiglu {name}: m {m}, d {d}, f {f}, {name_dtype}: max_abs_err {err:.3g} vs the "
          f"float32 plain version (<= {tol:.3g} x {scale:.3g}); kernel {ms:.3f} ms (CUDA "
          f"events, the least of 3 timings), plain (float32 cuBLAS) {plain_ms:.3f} ms, "
          f"library (layers.swiglu in {name_dtype}, cuBLAS) {library_ms:.3f} ms (max_abs_err "
          f"{lib_err:.3g}), bound {row['bound_ms']:.3f} ms ({row['bound_by']}: {flops:.4g} "
          f"FLOPs at {peak / 1e12:g} TFLOP/s, {nbytes:.4g} bytes); kernel at "
          f"{flops / (ms * 1e9):.1f} TFLOP/s of the function's work, library at "
          f"{flops / (library_ms * 1e9):.1f}; the design's tensor-core work ({how}) "
          f"{done:.4g} FLOPs, bound {done_ms:.3f} ms at {done_peak / 1e12:g} TFLOP/s, "
          f"executed at {done / (ms * 1e9):.1f} TFLOP/s")
    return row


def swiglu_phase(dev) -> dict:
    """Phase 11; returns the SwiGLU kernel's entry of the kernels line. No
    model path calls the kernel (the reference's dense FFN calls the plain
    ``layers.swiglu``), so its launches are this phase's own: the entry
    point ``ops.swiglu_fused`` once at the Jamba dense-FFN shape, with the
    counters set to 0 just before."""
    import torch

    from repro_torch.kernels import ops

    rows = [swiglu_case(dev, *case) for case in SWIGLU_CASES]
    torch.cuda.empty_cache()
    _, m, d, f, dtype, _ = SWIGLU_CASES[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((SERVE_BATCH, m // SERVE_BATCH, d), generator=gen, device=dev)
    w = [torch.randn(shape, generator=gen, device=dev).div_(math.sqrt(shape[0]))
         for shape in ((d, f), (d, f), (f, d))]
    x, *w = (t.to(getattr(torch, dtype)) for t in (x, *w))
    reset_launches()
    out = ops.swiglu_fused(x, *w)
    torch.cuda.synchronize()
    counts = read_launches()
    require(counts == {**{k: 0 for k in counts}, "swiglu": 1},
            f"ops.swiglu_fused on the card: kernel launches {counts}, want one swiglu")
    require(out.shape == x.shape and bool(torch.isfinite(out).all()),
            "ops.swiglu_fused gave non-finite values or the wrong shape")
    del x, w, out
    torch.cuda.empty_cache()
    return {"name": "swiglu", "route": "cuda", "source": "src/repro_torch/csrc/swiglu.cu",
            "replaces": "src/repro/kernels/swiglu.py:48", "launches": counts["swiglu"],
            **rows[0]}


def mm_problems(energy: bool = False) -> list:
    """Phase 12's tenants: ``build_problem`` at ``MM_TOTALS``, or their
    ``build_energy_problem`` twins under phase 7c's budget."""
    import numpy as np

    from repro_torch.core import solve_kkt_sai
    from repro_torch.fed.simulation import build_energy_problem, build_problem

    if not energy:
        return [build_problem(K, T_CYCLE, total_samples=t, seed=SEED) for t in MM_TOTALS]
    free = [build_energy_problem(K, T_CYCLE, total_samples=t, seed=SEED) for t in MM_TOTALS]
    ref_free = build_energy_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    blind = solve_kkt_sai(ref_free)
    eb = BUDGET_FRAC * float(np.median(ref_free.energy.cycle_energy(blind.tau, blind.d)))
    return [dataclasses.replace(p, e_budget=eb) for p in free]


def mm_engine(cfg, probs, dev):
    from repro_torch.core import CapacityDrift
    from repro_torch.fed.multimodel import MultiModelEngine
    from repro_torch.models import mlp

    inits = tuple(mlp.init(SEED + i, device=dev) for i in range(len(probs)))
    return MultiModelEngine(cfg, probs, mlp.loss, inits, seed=SEED,
                            drift=CapacityDrift(seed=SEED), split="deficit",
                            share_floor=MM_SHARE_FLOOR)


def cpu_multimodel_schedule(train, horizon: float, cfg, probs, counted: str) -> dict:
    """The multi-tenant schedule built on the CPU with the engine's rng
    discipline: each tenant's flush rows and groups, the counters, the
    split-weight log, the ledgers, and the calls of ``ops.<counted>`` its
    re-solves made."""
    from repro_torch.fed import async_engine as ae

    eng = mm_engine(cfg, probs, "cpu")
    with CallCounter(counted) as count:
        _, _, _, parts = eng._prep_run([train] * len(probs), None, None)
        scheds, counters = eng._build_schedules(parts, horizon, 100_000)
    eng._set_ledgers(scheds)
    rows = []
    for sched in scheds:
        rows.append([])
        group = []
        for a in sched.arrivals:
            if a.flush_id >= 0:
                group.append(a)
                if a.flush:
                    rows[-1].append(ae._flush_row(a, group, cfg.mode))
                    group = []
    return {"rows": rows, "groups": [ae._event_segments(sc.arrivals) for sc in scheds],
            "scheds": scheds, "counters": counters, "solves": count.calls,
            "weights": eng.split_weight_log, "ledgers": eng.energy_ledgers}


class SolveTimer:
    """Counts and times (host clock; a solve returns host arrays, so it
    ends synchronized) the engine's multi-model re-solves while entered."""

    def __init__(self):
        from repro_torch.fed import multimodel

        self.module, self.calls, self.seconds = multimodel, 0, 0.0

    def __enter__(self):
        self.fn = self.module.solve_multimodel_rows

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return self.fn(*args, **kw)
            finally:
                self.calls += 1
                self.seconds += time.perf_counter() - t0

        self.module.solve_multimodel_rows = timed
        return self

    def __exit__(self, *exc):
        self.module.solve_multimodel_rows = self.fn


def check_multimodel(eng, hists, cpu: dict, what: str) -> None:
    """A card run of the multi-tenant engine against its CPU build: every
    tenant's rows, the split-weight log, the counters and the ledgers."""
    import numpy as np

    require(len(hists) == len(cpu["rows"]), f"{what}: {len(hists)} tenants")
    for si, (hist, want) in enumerate(zip(hists, cpu["rows"])):
        check_rows(hist, want, f"{what} tenant {si}")
        accs = [r["accuracy"] for r in hist]
        require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
                f"{what} tenant {si}: accuracies out of range")
    require(len(eng.split_weight_log) == len(cpu["weights"]) and all(
        np.array_equal(a, b) for a, b in zip(eng.split_weight_log, cpu["weights"])),
        f"{what}: the split weights differ from the CPU build's")
    require(eng.fault_counters == cpu["counters"], f"{what}: counters differ from the CPU's")
    require(all(np.array_equal(a["per_learner"], b["per_learner"])
                and a["violations"] == b["violations"]
                for a, b in zip(eng.energy_ledgers, cpu["ledgers"])),
            f"{what}: the energy ledgers differ from the CPU build's")


def multimodel_phase(dev, train, test) -> None:
    """Phase 12: the multi-tenant scheduler on the card (no kernel of its
    own: its path launches the async training, ``accum_flush`` and the
    water-filling kernels)."""
    import numpy as np
    import torch

    from repro_torch.core import CapacityDrift
    from repro_torch.fed import async_engine as ae
    from repro_torch.fed.multimodel import MultiModelEngine
    from repro_torch.fed.simulation import build_problem
    from repro_torch.models import mlp

    horizon = CYCLES * T_CYCLE
    s = len(MM_TOTALS)
    ex, ey = (torch.from_numpy(a[:2000]).to(dev) for a in (test.x, test.y))
    zero = {name: 0 for name in read_launches()}

    def drive(eng, path, n_models):
        run = eng.run if path == "eager" else eng.run_events
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hists = run([train] * n_models, horizon, eval_fns=[mlp.accuracy] * n_models,
                    eval_batches=[(ex, ey)] * n_models)
        torch.cuda.synchronize()
        return hists, time.perf_counter() - t0

    # -- 12a-b. fedasync and buffered, grouped twice (and 12a eager) ----------
    for label, mode, extra in (("12a", "fedasync", {}), ("12b", "buffered", {"buffer_size": 5})):
        eager = mode == "fedasync"
        cfg = ae.AsyncConfig(mode=mode, alpha=0.6, lr=MM_LR, staleness_fn="poly",
                             reallocate=True, **extra)
        probs = mm_problems()
        cpu = cpu_multimodel_schedule(train, horizon, cfg, probs, "waterfill_residual")
        n_groups = sum(len(g) for g in cpu["groups"])
        n_aggs = sum(len(r) for r in cpu["rows"])
        want = {"eager": {**zero, "waterfill_residual": cpu["solves"]},
                "grouped": {**zero, "train_agg_step": n_groups, "accum_flush": n_groups,
                            "waterfill_residual": cpu["solves"]}}
        runs = {}
        for path in ("grouped", "grouped warm", "eager")[:3 if eager else 2]:
            eng = mm_engine(cfg, probs, dev)
            before = ae.staging_cache_stats()
            with SolveTimer() as solves:
                reset_launches()
                hists, wall = drive(eng, path, s)
                counts = read_launches()
            after = ae.staging_cache_stats()
            key = path.split()[0]
            require(counts == want[key], f"{label} {mode} {path}: kernel launches {counts}, "
                    f"not {want[key]}")
            check_multimodel(eng, hists, cpu, f"{label} {mode} {path}")
            staged = {n: after[n] - before[n] for n in after}
            if path == "grouped warm":
                require(staged == {"stages": 0, "hits": s}, f"{label} {mode}: the warm "
                        f"run's staging {staged}, not {s} cache hits")
            runs[path] = {"ms": 1e3 * wall / n_aggs, "wall": wall, "counts": counts,
                          "accs": [[r["accuracy"] for r in h] for h in hists],
                          "solves": solves.calls, "solve_s": solves.seconds,
                          "staged": staged, "weights": eng.split_weight_log,
                          "versions": eng.server_versions.tolist()}
        warm = runs["grouped warm"]
        require(warm["accs"] == runs["grouped"]["accs"], f"{label} {mode}: the warm grouped "
                "run's accuracies differ from the first's")
        if eager:
            gap = max(abs(a - b) for ge, gg in zip(runs["eager"]["accs"],
                                                   runs["grouped"]["accs"])
                      for a, b in zip(ge, gg))
            require(gap <= ASYNC_ACC_TOL, f"{label} {mode}: grouped and eager accuracies "
                    f"differ by {gap:g} > {ASYNC_ACC_TOL}")
            vs_eager = (f", eager {[a[-1] for a in runs['eager']['accs']]} (max gap "
                        f"{gap:.4f})")
        else:
            vs_eager = ""
        # the profiler's tracing slows the host several-fold, so the busy
        # time is read over a third run and set against the warm run's wall
        rows_ = ([] if eager else
                 device_time_by_kernel(lambda: drive(mm_engine(cfg, probs, dev), "grouped", s)))
        busy = sum(ms for _, ms, _ in rows_)
        seen = sorted({tuple(np.round(w, 4).tolist()) for w in warm["weights"]})
        print(f"multimodel {label} {mode} S={s} totals {list(MM_TOTALS)} k={K} "
              f"cycles={CYCLES} CapacityDrift deficit split floor {MM_SHARE_FLOOR}: "
              f"{n_aggs} aggregations ({[len(r) for r in cpu['rows']]} by tenant) in "
              f"{n_groups} groups; versions {warm['versions']}; final accuracy grouped "
              f"{[a[-1] for a in runs['grouped']['accs']]}{vs_eager}")
        print(f"  ms per aggregation over all tenants (host clock): grouped "
              f"{runs['grouped']['ms']:.2f} (first), {warm['ms']:.2f} (warm)"
              + (f", eager {runs['eager']['ms']:.2f}" if eager else "")
              + f"; re-solves {warm['solves']} ({cpu['solves']} "
              f"water-fillings), {1e3 * warm['solve_s']:.0f} ms of the warm run's "
              f"{1e3 * warm['wall']:.0f} ({100 * warm['solve_s'] / warm['wall']:.0f}%, "
              f"{1e3 * warm['solve_s'] / max(warm['solves'], 1):.1f} ms a re-solve); "
              f"staging first {runs['grouped']['staged']}, warm {warm['staged']}; "
              f"launches grouped {runs['grouped']['counts']}")
        if not eager:
            print(f"  device busy {busy:.1f} ms (torch.profiler) of "
                  f"{1e3 * warm['wall']:.1f} ms warm wall "
                  f"({100 * (1 - busy / (1e3 * warm['wall'])):.0f}% idle) in "
                  f"{sum(n for *_, n in rows_)} launches" if rows_ else
                  "  device time not measured (no device events)")
        for name, ms, calls in rows_[:6]:
            print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")
        print(f"  split weights seen ({len(seen)} distinct of {len(warm['weights'])} "
              f"re-solves): {seen[:8]}")

    # -- 12c. S = 1 on the card: the single-model engine's records -------------
    cfg = ae.AsyncConfig(mode="fedasync", alpha=0.6, lr=MM_LR, staleness_fn="poly",
                         reallocate=True)
    prob = build_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    single = ae.AsyncFedEngine(cfg, prob, mlp.loss, mlp.init(SEED, device=dev), seed=SEED,
                               drift=CapacityDrift(seed=SEED))
    reset_launches()
    want = single.run_events(train, horizon, eval_fn=mlp.accuracy, eval_batch=(ex, ey))
    want_counts = read_launches()
    multi = MultiModelEngine(cfg, [prob], mlp.loss, mlp.init(SEED, device=dev), seed=SEED,
                             drift=CapacityDrift(seed=SEED))
    reset_launches()
    got, wall = drive(multi, "grouped", 1)
    got = got[0]
    counts = read_launches()
    require(len(got) == len(want) > 0 and all(
        r.keys() - {"model"} == w.keys() and all(
            np.array_equal(np.asarray(r[n]), np.asarray(w[n])) for n in w)
        for r, w in zip(got, want)), "12c: S = 1 rows differ from AsyncFedEngine's")
    require(all(torch.equal(g[n], w[n]) for g, w in zip(multi.params[0], single.params)
                for n in w), "12c: S = 1 parameters differ from AsyncFedEngine's")
    require(counts == want_counts and counts["train_agg_step"] > 0,
            f"12c: launches {counts}, AsyncFedEngine's {want_counts}")
    print(f"multimodel 12c S=1 fedasync k={K}: {len(got)} aggregations, rows and parameters "
          f"bitwise AsyncFedEngine.run_events's; launches {counts}; "
          f"{1e3 * wall / len(got):.2f} ms per aggregation; final accuracy "
          f"{got[-1]['accuracy']:.4f}")

    # -- 12d. kkt_energy: the budgeted water-filling on every re-solve ----------
    cfg = ae.AsyncConfig(mode="fedasync", alpha=0.6, lr=MM_LR, staleness_fn="poly",
                         reallocate=True, scheme="kkt_energy")
    probs = mm_problems(energy=True)
    cpu = cpu_multimodel_schedule(train, horizon, cfg, probs, "waterfill_energy_residual")
    require(all(sc.energy_violations == 0 for sc in cpu["scheds"]),
            "12d: the CPU build overspends")
    n_groups = sum(len(g) for g in cpu["groups"])
    n_aggs = sum(len(r) for r in cpu["rows"])
    eng = mm_engine(cfg, probs, dev)
    with SolveTimer() as solves:
        reset_launches()
        hists, wall = drive(eng, "grouped", s)
        counts = read_launches()
    want = {**zero, "train_agg_step": n_groups, "accum_flush": n_groups,
            "waterfill_energy_residual": cpu["solves"]}
    require(counts == want, f"12d: kernel launches {counts}, not {want}")
    check_multimodel(eng, hists, cpu, "12d kkt_energy")
    require(eng.energy_ledger["violations"] == 0, "12d: budget violations")
    e2, e1, e0, eb = probs[0].energy_rows()
    worst = 0.0
    for key, (tau, d) in eng._alloc_cache.items():
        joules = np.where(d > 0, e2 * tau * d + e1 * d + e0, 0.0).sum(axis=0)
        require(bool((joules <= eb * (1 + 1e-9)).all()), f"12d: the split allocation at "
                f"{key} spends {joules.tolist()} J over the budget {eb.tolist()}")
        worst = max(worst, float((joules / eb).max()))
    print(f"multimodel 12d kkt_energy S={s} budget {float(eb[0]):.4f} J a dispatch: {n_aggs} "
          f"aggregations in {n_groups} groups, {solves.calls} re-solves "
          f"({cpu['solves']} energy water-fillings, {1e3 * solves.seconds:.0f} ms of "
          f"{1e3 * wall:.0f}); joules by learner "
          f"{np.round(eng.energy_ledger['per_learner'], 2).tolist()}, 0 violations; the "
          f"tenants' summed joules at most {worst:.4f} of a learner's budget in "
          f"{len(eng._alloc_cache)} split allocations; "
          f"{1e3 * wall / n_aggs:.2f} ms per aggregation; final accuracy "
          f"{[h[-1]['accuracy'] for h in hists]}; launches {counts}")


@contextlib.contextmanager
def plain_training():
    """``ops.train_agg_step`` and ``ops.fed_agg_leaves`` bound to their
    plain versions (autograd, torch sums) for the duration; restored on
    leaving. This script's comparison only: on the card the package always
    launches the kernels."""
    from repro_torch.kernels import ops, ref

    saved = ops.train_agg_step, ops.fed_agg_leaves
    ops.train_agg_step = ref.train_agg_step_ref
    ops.fed_agg_leaves = lambda leaves, w: [ref.fed_agg_ref(x, w) for x in leaves]
    try:
        yield
    finally:
        ops.train_agg_step, ops.fed_agg_leaves = saved


@contextlib.contextmanager
def capture_merges(out: list):
    """``ops.fed_agg_leaves`` recording each call in ``out`` for the
    duration (the fleet engine's merge over the F axis): (leaves, weights,
    outputs) for the first call, the weights alone after it; restored on
    leaving."""
    from repro_torch.kernels import ops

    saved = ops.fed_agg_leaves

    def recorded(leaves, w):
        got = saved(leaves, w)
        out.append((leaves, w, got) if not out else (None, w, None))
        return got

    ops.fed_agg_leaves = recorded
    try:
        yield
    finally:
        ops.fed_agg_leaves = saved


def merge_error(merges: list, n_leaves: int) -> tuple[float, int]:
    """Phase 13c: the first round's merge launch over the F axis (the
    fleet models' leaves, the staleness-discounted weights of the sampled
    fleets; ``capture_merges``) against its plain version at FED_AGG_TOL;
    one launch a round. Returns (max abs error, fleets weighted)."""
    from repro_torch.kernels import ref

    leaves, w, out = merges[0]
    require(len(merges) == POP_ROUNDS and len(leaves) == n_leaves
            and leaves[0].shape[0] == POP_F, f"13c: {len(merges)} merge launches of "
            f"{len(leaves)} leaves, not {POP_ROUNDS} of {n_leaves} over {POP_F} fleets")
    worst = 0.0
    for got, x in zip(out, leaves):
        want = ref.fed_agg_ref(x, w)
        err = (got - want).abs().max().item()
        require(err <= FED_AGG_TOL * max(1.0, want.abs().max().item()),
                f"13c: the merge launch over {POP_F} fleets differs from its plain version "
                f"by {err:g}")
        worst = max(worst, err)
    return worst, int((w > 0).sum())


def pop_problems(f: int, energy: bool = False):
    """Phase 13's population of ``f`` fleets; with ``energy``, joules as a
    learner's power (1 to 3 W, drawn from the seed) times its time
    coefficients, and a budget of ``BUDGET_FRAC`` x the median spend of the
    blind ``kkt_sai`` dispatch."""
    import numpy as np

    from repro_torch.core import solve_kkt_batched
    from repro_torch.fed.fleet import build_fleet_problems

    bp = build_fleet_problems(f, POP_K, T=POP_T, total_samples=POP_TOTAL, seed=SEED)
    if not energy:
        return bp
    power = np.random.default_rng(SEED).uniform(1.0, 3.0, bp.c2.shape)
    e2, e1, e0 = power * bp.c2, power * bp.c1, power * bp.c0
    blind = solve_kkt_batched(bp, device="cpu")
    spend = np.where(blind.d > 0, e2 * blind.tau * blind.d + e1 * blind.d + e0, 0.0)
    eb = np.full(bp.c2.shape, BUDGET_FRAC * float(np.median(spend)))
    return dataclasses.replace(bp, e2=e2, e1=e1, e0=e0, e_budget=eb)


def cpu_fleet_schedule(cfg, bp, train, rounds: int, counted: str) -> dict:
    """The fleet engine's schedule built on the CPU: the rows (all but the
    accuracy), versions and dispatches of ``rounds`` rounds with the
    training stubbed out (the schedule does not read the models), and the
    calls of ``ops.<counted>`` its solves made."""
    from repro_torch.fed.fleet import FleetEngine
    from repro_torch.kernels import ops
    from repro_torch.models import mlp

    eng = FleetEngine(cfg, bp, mlp.loss, mlp.init(SEED, [train.x.shape[1], 10], device="cpu"),
                      seed=SEED)
    trained = ops.train_agg_step
    ops.train_agg_step = lambda disp, *args, **kw: (disp, None)
    try:
        with CallCounter(counted) as count:
            hist = eng.run(train, rounds)
    finally:
        ops.train_agg_step = trained
    return {"hist": hist, "eng": eng, "solves": count.calls}


def check_fleet(eng, hist, cpu: dict, what: str) -> None:
    """A card run of the fleet engine against its CPU schedule: rows,
    versions and the next dispatch."""
    import numpy as np

    check_rows(hist, [{n: v for n, v in r.items() if n != "accuracy"} for r in cpu["hist"]],
               what)
    ref_eng = cpu["eng"]
    require(eng.global_version == ref_eng.global_version
            and np.array_equal(eng.pull_version, ref_eng.pull_version)
            and np.array_equal(eng.tau, ref_eng.tau) and np.array_equal(eng.d, ref_eng.d),
            f"{what}: versions or the next dispatch differ from the CPU schedule's")
    accs = [r.get("accuracy", 0.0) for r in hist]
    require(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
            f"{what}: accuracies out of range: {accs}")


def over_budget(bp, taus, ds) -> float:
    """The largest share of a learner's joule budget that the summed
    dispatches ``(taus[i], ds[i])`` spend (<= 1 within rounding: no
    violation)."""
    import numpy as np

    joules = sum(np.where(d > 0, bp.e2 * tau * d + bp.e1 * d + bp.e0, 0.0)
                 for tau, d in zip(taus, ds))
    return float((joules / bp.e_budget).max())


def fleet_phase(dev, train, test) -> list[dict]:
    """Phase 13: the fleet-of-fleets engine on the card; returns the fleet
    shape's entries of the kernels line (the training kernel at 10^4
    learners and the grouped ``fed_agg``)."""
    import numpy as np
    import torch

    from repro_torch.core import BatchedProblems
    from repro_torch.fed.fleet import FleetConfig, FleetEngine
    from repro_torch.fed.orchestrator import MELConfig, Orchestrator
    from repro_torch.fed.simulation import build_problem
    from repro_torch.kernels import fed_agg, ref, train_step
    from repro_torch.models import mlp

    t_phase = time.perf_counter()
    ex, ey = (torch.from_numpy(a[:2000]).to(dev) for a in (test.x, test.y))
    zero = {name: 0 for name in read_launches()}
    widths = mlp.PAPER_LAYERS
    mats = list(zip(widths[:-1], widths[1:]))
    n_params = kernel_cost.mlp_params(widths)
    bp = pop_problems(POP_F)
    cfg = FleetConfig(participation=POP_PARTICIPATION, lr=POP_LR)
    n = POP_F * POP_K

    # -- 13a. the kernels at the population's shapes ---------------------------
    # the grouped fed_agg: 1250 fleets of 8 over the paper MLP's 8 leaves
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [s for fi, fo in mats for s in ((fi, fo), (fo,))]
    leaves = [torch.randn((n, *s), generator=gen, device=dev) for s in shapes]
    w = torch.rand(n, generator=gen, device=dev)
    got = fed_agg.fed_agg_leaves_cuda(leaves, w, groups=POP_F)
    fa_err = 0.0
    for g_leaf, x in zip(got, leaves):
        want = ref.fed_agg_ref(x, w, groups=POP_F)
        err = (g_leaf - want).abs().max().item()
        require(err <= FED_AGG_TOL * max(1.0, want.abs().max().item()),
                f"13a: the grouped fed_agg differs from its plain version by {err:g}")
        fa_err = max(fa_err, err)
        del want
    for g in range(POP_F):
        sl = slice(g * POP_K, (g + 1) * POP_K)
        one = fed_agg.fed_agg_leaves_cuda([x[sl] for x in leaves], w[sl])
        require(all(torch.equal(a[g], b) for a, b in zip(got, one)),
                f"13a: group {g} of the grouped fed_agg differs from its one-group launch")
    del got
    fa_ms = cuda_ms(lambda: fed_agg.fed_agg_leaves_cuda(leaves, w, groups=POP_F), 10)
    # the device time is read for the print only: late in a long smoke the
    # card's torch.profiler has been seen to record no kernel at all
    hits = [(ms, calls) for key, ms, calls in device_time_by_kernel(
        lambda: [fed_agg.fed_agg_leaves_cuda(leaves, w, groups=POP_F) for _ in range(3)],
        expect="fed_agg_kernel") if "fed_agg_kernel" in key]
    fa_dev = (f"{sum(ms for ms, _ in hits) / sum(c for _, c in hits):.3f} ms device, "
              "torch.profiler" if hits else "device time not measured")
    fa_plain_ms = cuda_ms(lambda: [ref.fed_agg_ref(x, w, groups=POP_F) for x in leaves], 2)
    wg = w.view(POP_F, 1, POP_K)
    fa_lib_ms = cuda_ms(lambda: [torch.bmm(wg, x.view(POP_F, POP_K, -1)) for x in leaves], 5)
    fa_flops, fa_bytes = kernel_cost.fed_agg_leaves([x[0].numel() for x in leaves], n,
                                                    groups=POP_F)
    fa_bound_ms = 1e3 * max(fa_bytes / PEAK_BYTES_PER_S, fa_flops / PEAK_FP32_FLOPS)
    del leaves
    torch.cuda.empty_cache()
    print(f"fleet 13a fed_agg grouped G={POP_F} K={POP_K}, 8 leaves ({fa_bytes / 1e9:.2f} GB): "
          f"every group bitwise its one-group launch, max_abs_err {fa_err:.3g}; one launch "
          f"{fa_ms:.3f} ms ({fa_dev}), plain {fa_plain_ms:.3f} "
          f"ms, 8 x bmm {fa_lib_ms:.3f} ms, bound {fa_bound_ms:.3f} ms (bytes)")

    # the training kernel: 10^4 learners of the population's first dispatch
    # in one launch, against ten launches of 1000 (learners are independent)
    eng = FleetEngine(cfg, bp, mlp.loss, mlp.init(SEED, device=dev), seed=SEED)
    tau_h, d_h = eng.tau.reshape(-1), eng.d.reshape(-1)
    d_cap, max_tau = int(d_h.max()), int(tau_h.max())
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(train.x[rng.integers(0, train.size, (n, d_cap))]).to(dev)
    y = torch.from_numpy(train.y[rng.integers(0, train.size, (n, d_cap))]).to(dev)
    m = (torch.arange(d_cap, device=dev)[None] < torch.from_numpy(d_h).to(dev)[:, None]
         ).to(torch.float32)
    tau_t = torch.from_numpy(tau_h.astype(np.int32)).to(dev)
    w_t = torch.from_numpy(eng._weights().reshape(-1)).to(dev)
    starts = [{k: v.expand((POP_F,) + v.shape[1:]) for k, v in layer.items()}
              for layer in eng.fleet_params]

    def step(lo=0, hi=n, fn=train_step.train_agg_step_cuda):
        sub = [{k: v[lo // POP_K:hi // POP_K] for k, v in layer.items()} for layer in starts]
        return fn(sub, x[lo:hi], y[lo:hi], m[lo:hi], tau_t[lo:hi], w_t[lo:hi], POP_LR,
                  max_tau=max_tau, groups=(hi - lo) // POP_K)[0]

    whole = step()
    for c in range(n // POP_CHUNK):
        part = step(c * POP_CHUNK, (c + 1) * POP_CHUNK)
        g0 = c * POP_CHUNK // POP_K
        require(all(torch.equal(a[k][g0:g0 + len(b[k])], b[k]) for a, b in zip(whole, part)
                    for k in b), f"13a: learners {c * POP_CHUNK}.. differ between one launch "
                "of 10^4 and launches of 1000")
        del part
    ts_ms = cuda_ms(step, 3)
    split = device_time_by_kernel(step, expect="train_steps_kernel")
    # the plain version once (autograd over 10^4 learners holds ~35 GB), timed
    # by CUDA events around that call
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record()
    plain = step(fn=ref.train_agg_step_ref)
    events[1].record()
    torch.cuda.synchronize()
    ts_plain_ms = events[0].elapsed_time(events[1])
    ts_abs, ts_rel = leaf_errors(whole, plain)
    require(ts_rel <= POP_TRAIN_TOL, f"13a: the training kernel at 10^4 learners is "
            f"{ts_rel:g} of a leaf's scale from its plain version")
    del plain, whole
    torch.cuda.empty_cache()
    row_steps = int((tau_h * d_h).sum())
    ts_flops, ts_bytes = kernel_cost.train_agg_step(widths, row_steps=row_steps, learners=n,
                                                    d_cap=d_cap, starts=POP_F, outputs=POP_F)
    ts_bound_ms = 1e3 * max(ts_flops / PEAK_FP32_FLOPS, ts_bytes / PEAK_BYTES_PER_S)
    stream_ms = 1e3 * int(tau_h.sum()) * 2 * 4 * n_params / PEAK_BYTES_PER_S
    train_dev = [ms for name, ms, _ in split if "train_steps_kernel" in name]
    train_dev = (f"the training kernel {train_dev[0]:.1f} ms device (torch.profiler)"
                 if train_dev else "device split not measured")
    print(f"fleet 13a train_agg_step {n} learners (F={POP_F} x K={POP_K}), d_cap {d_cap}, "
          f"max_tau {max_tau}, sum tau d {row_steps} row-steps: one launch bitwise ten of "
          f"{POP_CHUNK}; {ts_ms:.1f} ms a call ({train_dev}); plain {ts_plain_ms:.1f} ms; "
          f"max relative (per leaf) to plain {ts_rel:.3g}; bound {ts_bound_ms:.2f} ms ({ts_flops:.4g} FP32 FLOPs at 67 "
          f"TFLOP/s; bytes once {ts_bytes / 1e9:.2f} GB); a step-synchronous design streams "
          f"each learner's weights in and out every step: {int(tau_h.sum())} learner-steps x "
          f"{8 * n_params / 1e6:.2f} MB = {stream_ms:.1f} ms at 3.35 TB/s")
    for name, ms, calls in split[:6]:
        print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")
    del x, y, m, starts, eng
    torch.cuda.empty_cache()

    # -- 13b. the F = 1 anchor: the paper's fleet, bitwise run_fused -----------
    prob = build_problem(K, T_CYCLE, total_samples=TOTAL, seed=SEED)
    orch = Orchestrator(MELConfig(), prob, mlp.loss, mlp.init(SEED, device=dev), seed=SEED)
    reset_launches()
    want = orch.run_fused(train, CYCLES, eval_fn=mlp.accuracy, eval_batch=(ex, ey))
    want_counts = read_launches()
    single = BatchedProblems.from_problems([prob])
    solves = cpu_fleet_schedule(FleetConfig(), single, train, CYCLES,
                                "waterfill_residual")["solves"]
    one = FleetEngine(FleetConfig(), single, mlp.loss, mlp.init(SEED, device=dev), seed=SEED)
    reset_launches()
    got_h = one.run(train, CYCLES, eval_fn=mlp.accuracy, eval_batch=(ex, ey))
    counts = read_launches()
    require(all(np.array_equal(g["tau"][0], w_["tau"]) and np.array_equal(g["d"][0], w_["d"])
                and g["accuracy"] == w_["accuracy"] for g, w_ in zip(got_h, want)),
            "13b: F = 1 rows differ from run_fused's")
    require(all(torch.equal(a[k], b[k]) for a, b in zip(one.global_params, orch.params)
                for k in b), "13b: F = 1 parameters differ from run_fused's")
    # the engine re-solves each round's dispatch (the water-fillings of the
    # CPU's solves) and merges the one fleet (a second fed_agg launch)
    require(counts == {**want_counts, "fed_agg": 2 * CYCLES, "waterfill_residual": solves}
            and want_counts == {**zero, "train_agg_step": CYCLES, "fed_agg": CYCLES},
            f"13b: launches {counts}, run_fused's {want_counts}")
    print(f"fleet 13b F=1 (k={K}, {TOTAL} samples, T={T_CYCLE}) {CYCLES} rounds: rows, "
          f"accuracies {[r['accuracy'] for r in got_h]} and parameters bitwise "
          f"run_fused's; launches {counts}")

    # -- 13c. the population at full width, three rounds ------------------------
    cpu = cpu_fleet_schedule(cfg, bp, train, POP_ROUNDS, "waterfill_residual")
    want_counts = {**zero, "train_agg_step": POP_ROUNDS, "fed_agg": 2 * POP_ROUNDS,
                   "waterfill_residual": cpu["solves"]}
    runs = {}
    merges = []   # the first run's merge launches: (leaves, weights, outputs)
    for label in ("first", "warm"):
        eng = FleetEngine(cfg, bp, mlp.loss, mlp.init(SEED, device=dev), seed=SEED)
        solve_s = []
        solve = eng._solve

        def timed(sampled, _solve=solve):
            t0 = time.perf_counter()
            try:
                return _solve(sampled)
            finally:
                solve_s.append(time.perf_counter() - t0)

        eng._solve = timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        with capture_merges(merges) if label == "first" else contextlib.nullcontext():
            hist = eng.run(train, POP_ROUNDS, eval_fn=mlp.accuracy, eval_batch=(ex, ey))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        require(counts == want_counts, f"13c {label}: launches {counts}, not {want_counts}")
        check_fleet(eng, hist, cpu, f"13c {label}")
        runs[label] = {"wall": wall, "solve": sum(solve_s), "hist": hist,
                       "peak": torch.cuda.max_memory_allocated(dev) / 1e9}
        if label == "warm":
            warm_eng = eng
        del eng
        if label == "first":
            merge_err, n_merged = merge_error(merges, len(mats) * 2)
            merges.clear()
            torch.cuda.empty_cache()
    warm = runs["warm"]
    require([r["accuracy"] for r in warm["hist"]] == [r["accuracy"] for r in runs["first"]["hist"]],
            "13c: the warm run's accuracies differ from the first's")
    split = device_time_by_kernel(lambda: FleetEngine(
        cfg, bp, mlp.loss, mlp.init(SEED, device=dev), seed=SEED).run(train, POP_ROUNDS),
        expect="train_steps_kernel")
    busy = sum(ms for _, ms, _ in split)
    round_ms = 1e3 * warm["wall"] / POP_ROUNDS
    stale = [r["fleet_staleness_max"] for r in warm["hist"]]
    print(f"fleet 13c F={POP_F} K={POP_K} ({n} learners) paper MLP participation "
          f"{POP_PARTICIPATION} {POP_ROUNDS} rounds: rows, versions and dispatch equal the CPU "
          f"schedule's; launches {counts}; sampled {[r['sampled_fleets'] for r in warm['hist']]}"
          f", fleet staleness max {stale}; accuracy {[r['accuracy'] for r in warm['hist']]}; "
          f"the first round's merge launch ({POP_F} rows, {n_merged} weighted, 8 leaves) "
          f"max_abs_err {merge_err:.3g} from plain")
    print(f"  ms a round (host clock, staging, solve and eval in): "
          f"{1e3 * runs['first']['wall'] / POP_ROUNDS:.1f} first, {round_ms:.1f} warm; "
          f"{n * POP_ROUNDS / warm['wall']:.0f} learner-rounds a second; the solves "
          f"{1e3 * warm['solve'] / POP_ROUNDS:.1f} ms a round "
          f"({100 * warm['solve'] / warm['wall']:.0f}%); peak memory "
          f"{warm['peak']:.2f} GB")
    print(f"  device busy {busy:.1f} ms (torch.profiler, a third run) of {1e3 * warm['wall']:.1f}"
          f" ms warm wall ({100 * (1 - busy / (1e3 * warm['wall'])):.0f}% idle) in "
          f"{sum(c for *_, c in split)} launches" if split else
          "  device time not measured (no device events)")
    for name, ms, calls in split[:8]:
        print(f"  {ms:9.3f} ms {calls:6d} x  {name[:90]}")
    fleet_counts = counts
    fleet_mesh_phase(dev, train, (ex, ey), cfg, bp, warm_eng, warm["hist"], want_counts)
    del warm_eng
    torch.cuda.empty_cache()

    # F = 64: the kernels' models and accuracy against the plain path's
    small = pop_problems(POP_SMALL_F)
    accs, models = {}, {}
    for path in ("kernels", "plain"):
        eng = FleetEngine(cfg, small, mlp.loss, mlp.init(SEED, device=dev), seed=SEED)
        with plain_training() if path == "plain" else contextlib.nullcontext():
            hist = eng.run(train, POP_ROUNDS, eval_fn=mlp.accuracy, eval_batch=(ex, ey))
        accs[path] = [r["accuracy"] for r in hist]
        models[path] = (eng.global_params, eng.fleet_params)
        if path == "kernels":
            small_hist = hist
        else:
            check_rows(hist, [{k: v for k, v in r.items() if k != "accuracy"}
                              for r in small_hist], "13c F=64 plain")
    gap = max(abs(a - b) for a, b in zip(accs["kernels"], accs["plain"]))
    require(gap <= POP_ACC_TOL, f"13c F={POP_SMALL_F}: kernel accuracies {accs['kernels']} "
            f"and plain {accs['plain']} differ by {gap:g} > {POP_ACC_TOL}")
    g_abs, g_rel = leaf_errors(models["kernels"][0], models["plain"][0])
    f_abs, f_rel = leaf_errors(models["kernels"][1], models["plain"][1])
    # the least that the plain path's training moved a leaf of the global
    # model from its init, per leaf of max |plain|
    moved = min(((g[name] - w[name]).abs().max() / w[name].abs().max()).item()
                for g, w in zip(mlp.init(SEED, device=dev), models["plain"][0]) for name in w)
    require(max(g_rel, f_rel) <= POP_MODEL_TOL, f"13c F={POP_SMALL_F}: the kernels' global "
            f"model is {g_rel:g} and fleet models {f_rel:g} of a leaf's scale from the plain "
            f"path's (limit {POP_MODEL_TOL:g})")
    print(f"fleet 13c F={POP_SMALL_F}: accuracy kernels {accs['kernels']}, plain "
          f"{accs['plain']} (max gap {gap:.4f} <= {POP_ACC_TOL}); kernels vs plain, per leaf "
          f"of max |plain|: global model {g_rel:.3g} (max_abs_err {g_abs:.3g}), fleet models "
          f"{f_rel:.3g} (max_abs_err {f_abs:.3g}) <= {POP_MODEL_TOL:g}; the plain path moved "
          f"each leaf of the global model at least {moved:.3g} of its scale from its init")

    # -- 13d. solve_multimodel on the population, and a budgeted round ----------
    cpu_eng = FleetEngine(cfg, bp, mlp.loss, mlp.init(SEED, [784, 10], device="cpu"),
                          seed=SEED)
    card_eng = FleetEngine(cfg, bp, mlp.loss, mlp.init(SEED, [784, 10], device=dev),
                           seed=SEED)
    for deficits, floor in POP_FMA_CASES:
        t0 = time.perf_counter()
        got3 = card_eng.solve_multimodel(np.asarray(deficits), share_floor=floor)
        card_s = time.perf_counter() - t0
        want3 = cpu_eng.solve_multimodel(np.asarray(deficits), share_floor=floor)
        require(all(np.array_equal(a, b) for a, b in zip(got3, want3)),
                f"13d: solve_multimodel {deficits} on the card differs from the CPU's")
    print(f"fleet 13d solve_multimodel S=3 on F={POP_F}: (tau, d, w) bitwise the CPU's in the "
          f"{len(POP_FMA_CASES)} eager-rounding cases (last w {got3[2].tolist()}, "
          f"{1e3 * card_s:.0f} ms on the card)")
    bp_e = pop_problems(POP_F, energy=True)
    cfg_e = FleetConfig(participation=POP_PARTICIPATION, lr=POP_LR, scheme="kkt_energy")
    cpu_e = cpu_fleet_schedule(cfg_e, bp_e, train, 1, "waterfill_energy_residual")
    eng = FleetEngine(cfg_e, bp_e, mlp.loss, mlp.init(SEED, device=dev), seed=SEED)
    first = (eng.tau, eng.d)
    reset_launches()
    hist = eng.run(train, 1, eval_fn=mlp.accuracy, eval_batch=(ex, ey))
    counts = read_launches()
    want_counts = {**zero, "train_agg_step": 1, "fed_agg": 2,
                   "waterfill_energy_residual": cpu_e["solves"]}
    require(counts == want_counts, f"13d kkt_energy: launches {counts}, not {want_counts}")
    check_fleet(eng, hist, cpu_e, "13d kkt_energy")
    worst = max(over_budget(bp_e, [first[0]], [first[1]]),
                over_budget(bp_e, [eng.tau], [eng.d]))
    require(worst <= 1.0 + 1e-9, f"13d: a dispatch spends {worst:.6f} of a learner's budget")
    tau3, d3, w3 = eng.solve_multimodel(np.asarray(POP_FMA_CASES[0][0]),
                                        share_floor=POP_FMA_CASES[0][1])
    want3 = cpu_e["eng"].solve_multimodel(np.asarray(POP_FMA_CASES[0][0]),
                                          share_floor=POP_FMA_CASES[0][1])
    require(all(np.array_equal(a, b) for a, b in zip((tau3, d3, w3), want3)),
            "13d: the budgeted solve_multimodel on the card differs from the CPU's")
    split_worst = over_budget(bp_e, tau3, d3)
    require(split_worst <= 1.0 + 1e-9, f"13d: the tenants' summed dispatches spend "
            f"{split_worst:.6f} of a learner's budget")
    print(f"fleet 13d kkt_energy F={POP_F} budget {float(bp_e.e_budget[0, 0]):.4f} J: one round "
          f"(rows as the CPU's, launches {counts}), 0 violations (largest share of a budget "
          f"{worst:.4f}; the S=3 split's summed {split_worst:.4f})")
    print(f"fleet phase 13: {time.perf_counter() - t_phase:.1f} s")

    return [
        {"name": f"train_agg_step (fleet, {n} learners)", "route": "cuda",
         "source": "src/repro_torch/csrc/train_step.cu",
         "replaces": "src/repro/kernels/train_step.py:119",
         "launches": fleet_counts["train_agg_step"], "max_abs_err": ts_abs, "ms": ts_ms,
         "plain_ms": ts_plain_ms, "bound_ms": ts_bound_ms, "bound_by": "operations",
         "library_ms": None},
        {"name": f"fed_agg (grouped, {POP_F} x {POP_K})", "route": "cuda",
         "source": "src/repro_torch/csrc/fed_agg.cu",
         "replaces": "src/repro/kernels/fed_agg.py:30",
         "launches": fleet_counts["fed_agg"], "max_abs_err": fa_err, "ms": fa_ms,
         "plain_ms": fa_plain_ms, "bound_ms": fa_bound_ms, "bound_by": "bytes",
         "library_ms": fa_lib_ms},
    ]


def fleet_mesh_phase(dev, train, eval_batch, cfg, bp, want_eng, want_hist,
                     want_counts) -> None:
    """Phase 13e: phase 13c's population and rounds over ``host_mesh()`` in a
    one-rank NCCL process group (no network: the group meets through a
    ``HashStore``): the merge's ``all_reduce`` and
    the solve's ``all_gather`` run, and every row, version, dispatch and
    model must be 13c's warm engine's (``want_eng``) bit for bit, with its
    launches (``want_counts``)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.fed.fleet import FleetEngine
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.models import mlp

    # NCCL binds the group to one card, named with its index
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = host_mesh()
        eng = FleetEngine(cfg, bp, mlp.loss, mlp.init(SEED, device=dev), seed=SEED, mesh=mesh)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        hist = eng.run(train, POP_ROUNDS, eval_fn=mlp.accuracy, eval_batch=eval_batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        try:
            FleetEngine(cfg, bp, mlp.loss, mlp.init(SEED, device="cpu"), seed=SEED)
            refused = False
        except ValueError as e:
            refused = "cannot move" in str(e)
    finally:
        dist.destroy_process_group()
    require(refused, "13e: a CPU engine on the NCCL group's default mesh was not refused")
    require(mesh.device_mesh is not None, "13e: host_mesh() built no DeviceMesh")
    require(counts == want_counts, f"13e: launches {counts}, not {want_counts}")
    check_rows(hist, want_hist, "13e")
    require(eng.global_version == want_eng.global_version
            and all(np.array_equal(getattr(eng, key), getattr(want_eng, key))
                    for key in ("pull_version", "tau", "d")),
            "13e: versions or the next dispatch differ from 13c's")
    for tree in ("global_params", "fleet_params"):
        require(all(torch.equal(a[k], b[k]) for a, b in zip(getattr(eng, tree),
                                                            getattr(want_eng, tree))
                    for k in b), f"13e: the mesh engine's {tree} differ from 13c's")
    print(f"fleet 13e F={POP_F} K={POP_K} over host_mesh() in a one-rank nccl group: "
          f"mesh_devices {eng.mesh.size}, fleet_axes {list(eng.fleet_axes)}; rows, "
          f"accuracies, versions, dispatch and every model bitwise 13c's; launches {counts}; "
          f"a CPU engine on that mesh refused; {1e3 * wall / POP_ROUNDS:.1f} ms a round "
          "(host clock, warm)")


def whisper_phase(dev, enc_row: dict) -> dict:
    """Phase 14: the Whisper-small serve at full width and published depth,
    bf16, with the attention kernel non-causal over the frames (encoder) and
    with Sq != Skv (cross-attention), held to the plain attention; then its
    float32 gate, card against CPU. Returns the Whisper path's entry of the
    kernels line (phase 8a's bf16 encoder case, ``enc_row``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    cfg = get_config(WHISPER_ARCH)
    b, s, gen = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = serve.prompt_batch(cfg, b, s, SEED, dev)
    per_prefill = cfg.num_encoder_layers + 2 * cfg.num_layers
    with torch.inference_mode():
        serve.prefill(model, params, batch, s + gen)        # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        logits, cache, tok = serve.prefill(model, params, batch, s + gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_prefill = read_launches()
        rest, _ = serve.decode(model, params, cache, tok, s, gen - 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after_decode = read_launches()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        tokens_out = torch.cat([tok, rest], dim=1)
        nothing = {name: 0 for name in after_decode}
        require(after_prefill == {**nothing, "flash_attention": per_prefill},
                f"14: the prefill's kernel launches were {after_prefill}, want {per_prefill} "
                "flash_attention (one an encoder layer, two a decoder layer) and no other")
        require(after_decode == after_prefill, f"14: decode launched kernels: {after_prefill} "
                f"after the prefill, {after_decode} after decode")
        require(tuple(logits.shape) == (b, 1, cfg.vocab_size)
                and bool(torch.isfinite(logits).all()), "14: the prefill's logits are not "
                f"finite of shape ({b}, 1, {cfg.vocab_size})")
        require(tuple(tokens_out.shape) == (b, gen) and int(tokens_out.min()) >= 0
                and int(tokens_out.max()) < cfg.vocab_size, "14: generated tokens out of range")
        require(all(bool(torch.isfinite(t).all()) for part in cache.values()
                    for t in part.values()), "14: the caches are not finite")
        serve_breakdown(WHISPER_ARCH, model, params, cache, batch, tok, t0, t1, t2, gen)
        with plain_attention():
            p_logits, p_cache, p_tok = serve.prefill(model, params, batch, s + gen)
            p_rest, _ = serve.decode(model, params, p_cache, p_tok, s, gen - 1)
        del p_cache
        err = (logits.float() - p_logits.float()).abs().max().item()
        scale = p_logits.float().abs().max().item()
        require(err <= SERVE_BF16_TOL * scale, f"14: the bf16 serve's logits differ from the "
                f"plain attention's by {err:g} > {SERVE_BF16_TOL} x {scale:g}")
    agree = float((tokens_out == torch.cat([p_tok, p_rest], dim=1)).float().mean().item())
    n_params = model.param_count()
    del cache, params, model
    torch.cuda.empty_cache()
    prefill_ms, decode_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (gen - 1)
    print(f"serve {WHISPER_ARCH} ({n_params} params, {cfg.param_dtype}, "
          f"{cfg.num_encoder_layers} + {cfg.num_layers} layers, {cfg.encoder_seq} frames): "
          f"init {init_s:.1f} s; prefill "
          f"{b}x{s} {prefill_ms:.1f} ms; decode {gen - 1} steps {decode_ms:.2f} ms a step "
          f"({b * 1e3 / decode_ms:.1f} tok/s); peak memory {peak_gb:.2f} GB; launches prefill "
          f"{after_prefill['flash_attention']}, decode "
          f"{after_decode['flash_attention'] - after_prefill['flash_attention']}; "
          f"last-position logits vs plain attention max_abs_err {err:.3g}, {err / scale:.3g} "
          f"of their scale {scale:.3g} (<= {SERVE_BF16_TOL}); greedy agreement with plain "
          f"{agree:.3f}; sample {tokens_out[0, :8].tolist()}")

    # -- 14, float32 gate: the same seed on the card and on the CPU ------------
    cfg32 = dataclasses.replace(cfg, num_layers=WHISPER_E2E_LAYERS,
                                num_encoder_layers=WHISPER_E2E_LAYERS,
                                param_dtype="float32", compute_dtype="float32")
    steps = WHISPER_E2E_STEPS
    runs = {}
    for device in ("cpu", dev):
        m32 = Model(cfg32, device=device)
        p32 = m32.init(SEED)
        bt = serve.prompt_batch(cfg32, WHISPER_E2E_BATCH, s, SEED, device)
        reset_launches()
        with torch.inference_mode():
            lg, c32, t = serve.prefill(m32, p32, bt, s + steps)
            more, _ = serve.decode(m32, p32, c32, t, s, steps - 1)
        runs[str(device)] = (lg.float().cpu(), torch.cat([t, more], dim=1).cpu(),
                             read_launches()["flash_attention"])
        del m32, p32, c32
    (cpu_l, cpu_t, _), (card_l, card_t, card_n) = runs["cpu"], runs[str(dev)]
    torch.cuda.empty_cache()
    want_n = WHISPER_E2E_LAYERS + 2 * WHISPER_E2E_LAYERS
    require(card_n == want_n, f"14 float32: {card_n} flash_attention launches, not {want_n}")
    e2e_err = (card_l - cpu_l).abs().max().item() / cpu_l.abs().max().item()
    require(e2e_err <= E2E_TOL, f"14 float32: the card's logits differ from the CPU's by "
            f"{e2e_err:g} of their scale > {E2E_TOL}")
    require(torch.equal(card_t, cpu_t), f"14 float32: greedy tokens differ from the CPU's: "
            f"{card_t.tolist()} vs {cpu_t.tolist()}")
    print(f"float32 {WHISPER_ARCH} at full width, {WHISPER_E2E_LAYERS} + {WHISPER_E2E_LAYERS} "
          f"layers, {WHISPER_E2E_BATCH}x{s}, card vs CPU: prefill logits max relative error "
          f"{e2e_err:.3g} (<= {E2E_TOL}), {steps} greedy tokens equal; {card_n} kernel "
          f"launches; phase 14 {time.perf_counter() - t_phase:.1f} s")
    return {"name": f"flash_attention ({WHISPER_ARCH} encoder)", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:91",
            "launches": after_decode["flash_attention"], **enc_row}


def vlm_phase(dev) -> None:
    """Phase 14b: InternVL2-76B's vlm path at full width, its depth cut to
    VLM_LAYERS: image embeddings ahead of a text prompt, a bf16 prefill
    and greedy decode from position N_img + S_text, held to the plain
    attention."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, num_layers=VLM_LAYERS)
    b, s, gen = VLM_BATCH, VLM_PROMPT, VLM_GEN
    require(cfg.num_image_tokens == VLM_IMAGE_TOKENS,
            f"14b: {VLM_ARCH} has {cfg.num_image_tokens} image tokens, phase 8a checks "
            f"{VLM_IMAGE_TOKENS}")
    model = Model(cfg, device=dev)
    print(f"serve {VLM_ARCH} vlm path: d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
          f"heads, d_ff {cfg.d_ff}, {cfg.num_image_tokens} image tokens ahead of {s} text "
          f"tokens; depth cut from {full.num_layers} to {cfg.num_layers} layers ({VLM_ARCH} "
          f"holds {Model(full, device='cpu').param_count()} params, ~"
          f"{2 * Model(full, device='cpu').param_count() / 1e9:.0f} GB in bf16; the card 80)")
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = serve.prompt_batch(cfg, b, s, SEED, dev)
    start = serve.start_position(cfg, batch)
    with torch.inference_mode():
        serve.prefill(model, params, batch, start + gen)    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        logits, cache, tok = serve.prefill(model, params, batch, start + gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_prefill = read_launches()
        rest, _ = serve.decode(model, params, cache, tok, start, gen - 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after_decode = read_launches()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        tokens_out = torch.cat([tok, rest], dim=1)
        nothing = {name: 0 for name in after_decode}
        require(after_prefill == {**nothing, "flash_attention": cfg.num_layers},
                f"14b: the prefill's kernel launches were {after_prefill}, want "
                f"{cfg.num_layers} flash_attention and no other")
        require(after_decode == after_prefill, f"14b: decode launched kernels: "
                f"{after_prefill} after the prefill, {after_decode} after decode")
        require(tuple(logits.shape) == (b, 1, cfg.vocab_size)
                and bool(torch.isfinite(logits).all()), "14b: the prefill's logits are not "
                f"finite of shape ({b}, 1, {cfg.vocab_size})")
        require(tuple(tokens_out.shape) == (b, gen) and int(tokens_out.min()) >= 0
                and int(tokens_out.max()) < cfg.vocab_size, "14b: tokens out of range")
        serve_breakdown(VLM_ARCH, model, params, cache, batch, tok, t0, t1, t2, gen)
        with plain_attention():
            p_logits, p_cache, p_tok = serve.prefill(model, params, batch, start + gen)
        del p_cache
        err = (logits.float() - p_logits.float()).abs().max().item()
        scale = p_logits.float().abs().max().item()
        require(err <= SERVE_BF16_TOL * scale, f"14b: the bf16 serve's logits differ from "
                f"the plain attention's by {err:g} > {SERVE_BF16_TOL} x {scale:g}")
    first = float((tok == p_tok).float().mean().item())
    n_params = model.param_count()
    del cache, params, model
    torch.cuda.empty_cache()
    prefill_ms, decode_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (gen - 1)
    print(f"serve {VLM_ARCH} ({n_params} params, {cfg.param_dtype}, {cfg.num_layers} layers): "
          f"init {init_s:.1f} s; prefill {b}x({cfg.num_image_tokens}+{s}) {prefill_ms:.1f} ms; "
          f"decode {gen - 1} steps from position {start} {decode_ms:.2f} ms a step "
          f"({b * 1e3 / decode_ms:.1f} tok/s); peak memory {peak_gb:.2f} GB; launches prefill "
          f"{after_prefill['flash_attention']}, decode 0; last-position logits vs plain "
          f"attention max_abs_err {err:.3g}, {err / scale:.3g} of their scale {scale:.3g} "
          f"(<= {SERVE_BF16_TOL}); first token agreement {first:.2f}; sample "
          f"{tokens_out[0, :8].tolist()}; phase 14b {time.perf_counter() - t_phase:.1f} s")


def cut_layers(params, layers: int, device) -> dict:
    """A decoder's params with the first ``layers`` periods of every
    stacked leaf of ``blocks``, copied to ``device``."""
    import torch

    def cut(t):
        return t[:layers].to(device, copy=True) if torch.is_tensor(t) else cut_tree(t)

    def cut_tree(tree):
        return {k: cut(v) for k, v in tree.items()}

    out = {k: (v.to(device, copy=True) if torch.is_tensor(v) else v)
           for k, v in params.items() if k != "blocks"}
    out["blocks"] = [cut_tree(blk) for blk in params["blocks"]]
    return out


def bwd_case(dev, name, b, s, h, kvh, d, dtype, causal, window, skv, iters) -> dict:
    """Phase 15a, one case: attention's backward kernel against its plain
    versions, timed with the plain backward, its bound and the backward of
    ``scaled_dot_product_attention`` (the library column)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref
    from repro_torch.models import layers

    dtype = getattr(torch, dtype)
    skv = s if skv is None else skv
    gen = torch.Generator(device=dev).manual_seed(SEED + 7 * s + d)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, s, h, d), (b, skv, kvh, d), (b, skv, kvh, d),
                                 (b, s, h, d)))
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    flash_attention.last_bwd_kernel = None
    got = flash_attention.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    route = flash_attention.last_bwd_kernel
    require(route == ("tc" if dtype == torch.bfloat16 else "cc"),
            f"15a {name}: {str(dtype).removeprefix('torch.')} ran the backward's {route} "
            f"kernels")
    plain = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), do.float(), **kw)
    # autograd of the dense oracle (whose rows with no key are NaN: the
    # chunked scan there, which gives them 0)
    masked = causal and window is not None and s > skv + window
    fwd = layers.flash_attention if masked else ref.flash_attention_ref
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(fwd(*leaves, **kw), leaves, do.float())
    del leaves
    torch.cuda.synchronize()
    floor = 1e-3 * do.float().abs().max().item() * v.float().abs().max().item()
    tol = BWD_TOL[str(dtype).removeprefix("torch.")]
    err, plain_err = 0.0, 0.0
    for what, g, w, a in zip(("dq", "dk", "dv"), got, plain, auto):
        require(bool(torch.isfinite(g).all()), f"15a {name}: {what} is not finite")
        scale = max(w.abs().max().item(), floor)
        e = (g.float() - w).abs().max().item()
        require(e <= tol * scale, f"15a {name}: the backward kernel's {what} differs from "
                f"the plain backward by {e:g} > {tol} x {scale:g}")
        pe = (a - w).abs().max().item()
        require(pe <= BWD_PLAIN_TOL * scale, f"15a {name}: the two plain backwards' {what} "
                f"differ by {pe:g} > {BWD_PLAIN_TOL} x {scale:g}")
        err, plain_err = max(err, e), max(plain_err, pe / scale)
    del auto
    if masked:
        require(bool((got[0][:, skv - 1 + window:] == 0).all()),
                f"15a {name}: rows with no key have a nonzero dq")
    ms = cuda_ms(lambda: flash_attention.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw),
                 iters)
    plain_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, do, **kw), 2)
    del plain
    # the library: the backward alone of scaled_dot_product_attention at
    # the same shape, (B, H, S, d), its graph kept between calls
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    if window is None and not (causal and s != skv):
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib_inputs = (qt, kt, vt)
    else:
        qpos, kpos = torch.arange(s, device=dev)[:, None], torch.arange(skv, device=dev)[None]
        mask = torch.ones((s, skv), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos >= kpos
        if window is not None:
            mask &= qpos - kpos < window
        kr, vr = (t.repeat_interleave(h // kvh, dim=1) for t in (kt, vt))
        o = F.scaled_dot_product_attention(qt, kr, vr, attn_mask=mask)
        lib_inputs = (qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(o, lib_inputs, dot, retain_graph=True),
                         iters)
    del o
    # 2.5 x the forward's 4 B H d pairs
    flops, nbytes = kernel_cost.flash_attention_bwd(b, s, skv, h, kvh, d, causal=causal,
                                                    window=window, itemsize=q.element_size())
    executed = bwd_executed_flops(b, s, skv, h, d, causal, window, route)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES_PER_S
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err}
    print(f"flash_attention_bwd {name}: B {b}, S {s}"
          f"{'' if skv == s else f' against Skv {skv}'}, {h}/{kvh} heads, d {d}, "
          f"{str(dtype).removeprefix('torch.')}, causal {causal}, window {window}, "
          f"{route} kernels: max_abs_err {err:.3g} (<= {tol} of each gradient's scale), "
          f"plain backwards agree to {plain_err:.3g}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops:.4g} FLOPs at "
          f"{peak / 1e12:g} TFLOP/s, {nbytes:.4g} bytes); kernel at {flops / (ms * 1e9):.1f} "
          f"TFLOP/s of the gradient's 2.5x-forward FLOPs, {executed / (ms * 1e9):.1f} of the "
          f"{executed:.4g} it executes; sdpa at {flops / (library_ms * 1e9):.1f}")
    return row


def bwd_executed_flops(b, sq, skv, h, d, causal, window, route) -> int:
    """The FLOPs attention's backward kernels execute: every product over
    each live 64 x 64 (query, key) tile pair of every (b, head), masked
    entries included. "tc": S and dP (d rounded up to 16) and the five
    products with a register operand (dV, dK, dQ; P and dS in two pieces)
    over d rounded up to 64 columns; "cc": seven products of 64 x 64 x d."""
    import numpy as np

    qt = np.arange((sq + 63) // 64)[:, None] * 64
    kt = np.arange((skv + 63) // 64)[None] * 64
    live = np.ones((qt.size, kt.size), bool)
    if causal:
        live &= qt + 63 >= kt
    if window:
        live &= qt - (kt + 63) < window
    per_pair = (2 * 64 * 64 * (4 * 16 * -(-d // 16) + 6 * 64 * -(-d // 64)) if route == "tc"
                else 7 * 2 * 64 * 64 * d)
    return int(live.sum()) * b * h * per_pair


def train_step_capturing(model):
    """``build_train``'s step (in place, as the launcher's), and a list that
    receives each call's clipped gradients (captured where the step clips
    them)."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_by_name

    clipped = []
    clip = steps.clip_by_global_norm

    def capture(grads, max_norm):
        out = clip(grads, max_norm)
        clipped.append(out[0])
        return out

    step = steps.build_train(model, make_mesh_by_name("cpu"))[0]

    def run(*args):
        steps.clip_by_global_norm = capture
        try:
            return step(*args)
        finally:
            steps.clip_by_global_norm = clip

    return run, clipped


def autograd_of(fn, inputs, cotangents) -> list:
    """torch autograd of ``fn(*inputs)`` with the outputs' ``cotangents``;
    None for an input that is None."""
    import torch

    leaves = [None if t is None else t.detach().clone().requires_grad_(True) for t in inputs]
    grads = iter(torch.autograd.grad(fn(*leaves), [t for t in leaves if t is not None],
                                     cotangents))
    return [None if t is None else next(grads) for t in leaves]


def ssm_grads_check(tag, names, got, plain, auto, floor) -> float:
    """Phase 15d: each gradient a backward kernel returned against both
    plain versions, within ``SSM_BWD_TOL`` of its dtype of max(scale,
    floor); returns the largest error against the written-out one."""
    import torch

    err = 0.0
    for name, g, p, a in zip(names, got, plain, auto):
        if p is None:
            require(g is None, f"{tag}: {name} returned for an input not given")
            continue
        require(g.dtype == p.dtype and bool(torch.isfinite(g).all()),
                f"{tag}: {name} is not finite {p.dtype}")
        tol = SSM_BWD_TOL[str(g.dtype).removeprefix("torch.")]
        for which, want in (("the written-out backward", p), ("autograd of the step loop", a)):
            scale = max(want.float().abs().max().item(), floor)
            e = (g.float() - want.float()).abs().max().item()
            require(e <= tol * scale, f"{tag}: the kernel's {name} differs from {which} by "
                    f"{e:g} > {tol} x {scale:g}")
        err = max(err, (g.float() - p.float()).abs().max().item())
    return err


def events_ms(fn):
    """(fn(), its device ms by CUDA events around the one call)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def split_of(rows, names) -> str:
    """``device_time_by_kernel`` rows as "name ms x launches" for each name
    (a substring of the kernel's), in that order."""
    parts = []
    for label, sub in names:
        hits = [(ms, n) for key, ms, n in rows if sub in key]
        parts.append(f"{label} {sum(ms for ms, _ in hits):.4f} ms x {sum(n for _, n in hits)}")
    return ", ".join(parts)


def launches_of(rows, sub) -> int:
    return sum(n for key, _, n in rows if sub in key)


def profiled_launches(label, fn, want: dict[str, int], passes) -> str:
    """One call of ``fn`` under ``torch.profiler``: its launches of each
    kernel (a substring of its name) held to ``want`` exactly, and the
    passes' split of its device time. On the card's machine the profiler
    has been seen to drop some or all of a trace's kernel records (one
    trace held the WKV backward's reversed chunk run and not the row walk
    or du's sum that the C entry counted), so a trace that still lacks a
    kernel of ``want`` after ``PROFILE_TRIES`` traces is reported as not
    measured: the launches themselves are held by the wrapper's and the C
    entry's counts. A trace that holds them all must count each exactly,
    and no launch of a kernel that ``want`` puts at 0."""
    expect = tuple(sub for sub, n in want.items() if n)
    rows = device_time_by_kernel(fn, expect=expect)
    got = {sub: launches_of(rows, sub) for sub in want}
    if not all(got[sub] for sub in expect):
        return (f"not measured (the profiler recorded {len(rows)} kernel(s), "
                f"launches {got})")
    require(got == want, f"{label}: the profiler saw launches {got}, want {want}")
    return split_of(rows, passes)


# the WKV-6 backward's launches, as the profiler names them: the chunk
# states' run (only where the forward kept none), the reversed chunk run,
# the row walk, du's sum
WKV_BWD_PASSES = (("chunk states", ", false, false, true>"),
                  ("reversed chunk run", ", true, true, true>"), ("row walk", "rows_kernel"),
                  ("du sum", "du_sum_kernel"))


def wkv_bwd_case(dev, name, b, s, h, hd, dtype, with_state, with_dlast, decays,
                 iters) -> dict:
    """Phase 15d, one case: the WKV-6 backward kernel against its plain
    versions, its bits from call to call and with or without the forward's
    chunk states, its launches a call, timed with the written-out plain
    backward and beside its bound."""
    import torch

    from repro_torch.kernels import ref, wkv6

    kind = "bf16" if dtype == "bfloat16" else "float"
    dtype = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3 * s + hd)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = (randn(b, s, h, hd).mul_(0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, s, h, hd) - 1.0))
    if decays == "zero":
        w[..., ::7] = 0.0
        w[:, ::13, :, 1::5] = 0.0
    elif decays == "one":
        w[..., 3::7] = 1.0 - 1e-7 * torch.rand(w[..., 3::7].shape, generator=gen, device=dev)
    u = randn(h, hd).mul_(0.1)
    s0 = randn(b, h, hd, hd).mul_(0.1) if with_state else None
    dy = randn(b, s, h, hd)
    dlast = randn(b, h, hd, hd) if with_dlast else None
    args = (r, k, v, w, u, dy, s0, dlast)
    # the chunk states as the training step's forward keeps them
    states = torch.empty(wkv6.chunk_states_shape(r), device=dev)
    wkv6.wkv6_cuda(r, k, v, w, u, s0, chunk_states=states)
    wkv6.bwd_launches = 0
    got = wkv6.wkv6_bwd_cuda(*args)
    again = wkv6.wkv6_bwd_cuda(*args)
    kept = wkv6.wkv6_bwd_cuda(*args, chunk_states=states)
    torch.cuda.synchronize()
    require(wkv6.bwd_launches == 3, f"15d wkv6_bwd {name}: {wkv6.bwd_launches} launches "
            "for 3 calls")
    repeats = all(x is None or (torch.equal(x, y) and torch.equal(x, z))
                  for x, y, z in zip(got, again, kept))
    require(repeats, f"15d wkv6_bwd {name}: two calls, or a call from the forward's chunk "
            "states, gave different bits")
    del again, kept
    plain, plain_ms = events_ms(lambda: ref.wkv6_bwd_ref(*args))
    zeros = torch.zeros((b, h, hd, hd), device=dev)
    auto = autograd_of(ref.wkv6_ref, (r, k, v, w, u, s0), (dy, zeros if dlast is None else dlast))
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    err = ssm_grads_check(f"15d wkv6_bwd {name}", names, got, plain, auto,
                          1e-3 * dy.abs().max().item())
    del got, plain, auto
    # as the training step runs it (from the forward's chunk states), alone,
    # and the forward's cost of keeping the states
    ms = min(cuda_ms(lambda: wkv6.wkv6_bwd_cuda(*args, chunk_states=states), iters)
             for _ in range(2))
    alone_ms = min(cuda_ms(lambda: wkv6.wkv6_bwd_cuda(*args), iters) for _ in range(2))
    fwd_ms = [min(cuda_ms(lambda: wkv6.wkv6_cuda(r, k, v, w, u, s0, chunk_states=kept_),
                          iters) for _ in range(2)) for kept_ in (None, states)]
    # each call's launches, as its C entry counts them: a reversed chunk
    # run, a row walk and a du sum, and the chunk states' run only without
    # them; and by the profiler, with their times, where its trace holds
    # them all
    nc = -(-s // wkv6.CHUNK)
    split = {}
    for tag, kw in (("states", {"chunk_states": states}), ("alone", {})):
        wkv6.wkv6_bwd_cuda(*args, **kw)
        kernels = 3 + int(not kw and nc > 1)
        require(wkv6.last_bwd_kernels == kernels, f"15d wkv6_bwd {name} {tag}: "
                f"{wkv6.last_bwd_kernels} kernels launched by a call, want {kernels}")
        want = {"rows_kernel": 1, ", true, true, true>": 1, "du_sum_kernel": 1,
                ", false, false, true>": kernels - 3}
        split[tag] = profiled_launches(f"15d wkv6_bwd {name} {tag}",
                                       lambda: wkv6.wkv6_bwd_cuda(*args, **kw), want,
                                       WKV_BWD_PASSES)
    # the least work: the state's recompute, G's update and the sums of dr,
    # dk, dv and dw, 6 FMAs per (b, h, t, i, j); the least bytes: r, k, v
    # in their dtype and w, dy in float32 read once, dr, dk, dv in r's
    # dtype and dw written once, u and du, the states given and returned
    flops, nbytes = kernel_cost.wkv6_bwd(b, s, h, hd, itemsize=r.element_size(),
                                         with_state=with_state, with_dlast=with_dlast)
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    regs = "; ".join(f"{label} {ptxas_of('wkv6_bwd', entry)}" for label, entry in (
        ("row walk", f"rows_kernel<{kind}, {hd}>"),
        ("reversed chunk run", f"chunk_kernel<{kind}, {hd}, true, true, true>"),
        ("chunk states", f"chunk_kernel<{kind}, {hd}, false, false, true>")))
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err}
    print(f"15d wkv6_bwd {name}: B {b}, S {s}, {h} heads of {hd}, "
          f"{str(dtype).removeprefix('torch.')} r/k/v, s0 {'given' if with_state else 'none'}, "
          f"ds_last {'given' if with_dlast else 'none'}{', decays ' + decays if decays else ''}: "
          f"max_abs_err {err:.3g} against the written-out backward (each gradient within "
          f"{SSM_BWD_TOL[str(dtype).removeprefix('torch.')]:g} of its scale of both plain "
          f"versions); bits repeat (and with the forward's chunk states): {repeats}; kernel "
          f"{ms:.4f} ms from the forward's chunk states (CUDA events, the least of 2 timings; "
          f"the forward {fwd_ms[0]:.4f} ms, {fwd_ms[1]:.4f} keeping them), alone "
          f"{alone_ms:.4f} ms, plain {plain_ms:.1f} ms (written out, one call), bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops:.4g} FP32 FLOPs at "
          f"{PEAK_FP32_FLOPS / 1e12:g} TFLOP/s, {nbytes:.4g} bytes), {row['bound_ms'] / ms:.3f} "
          f"of the bound; passes (torch.profiler, one call): from the states "
          f"{split['states']}; alone {split['alone']}; ptxas: {regs}")
    return row


def mamba_bwd_case(dev, name, b, s, d, n, dtype, with_state, with_dlast, decays,
                   iters) -> dict:
    """Phase 15d, one case: the scan's backward kernel against its plain
    versions, its bits from call to call, timed with the written-out plain
    backward and beside its bound and the SFU floor."""
    import torch

    from repro_torch.kernels import mamba_scan, ref

    kind = "bf16" if dtype == "bfloat16" else "float"
    dtype = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3 * s + d)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dt = torch.nn.functional.softplus(randn(b, s, d).mul_(2.0).sub_(4.6))
    x = randn(b, s, d).to(dtype)
    bm, cm = randn(b, s, n), randn(b, s, n)
    a = -torch.exp(torch.log(torch.arange(1, n + 1, device=dev, dtype=torch.float32))
                   + randn(d, n).mul_(0.1))
    if decays == "near1":
        dt = torch.rand(b, s, d, generator=gen, device=dev).mul_(9e-5).add_(1e-5)
        a = -torch.rand(d, n, generator=gen, device=dev).mul_(9e-3).add_(1e-3)
    elif decays == "underflow":
        dt[..., ::3] = torch.rand(dt[..., ::3].shape, generator=gen, device=dev).mul_(14.0) + 6.0
    h0 = randn(b, d, n) if with_state else None
    dy = randn(b, s, d)
    dlast = randn(b, d, n) if with_dlast else None
    args = (dt, x, bm, cm, a, dy, h0, dlast)
    mamba_scan.bwd_launches = 0
    got = mamba_scan.mamba_scan_bwd_cuda(*args)
    again = mamba_scan.mamba_scan_bwd_cuda(*args)
    torch.cuda.synchronize()
    require(mamba_scan.bwd_launches == 2, f"15d mamba_scan_bwd {name}: "
            f"{mamba_scan.bwd_launches} launches for 2 calls")
    # a call's launches by the profiler, where its trace holds them all:
    # the walk and the sums
    split = profiled_launches(f"15d mamba_scan_bwd {name}",
                              lambda: mamba_scan.mamba_scan_bwd_cuda(*args),
                              {"mamba_scan_bwd_kernel": 1, "mamba_bwd_sum_kernel": 1},
                              (("walk", "mamba_scan_bwd_kernel"),
                               ("sums", "mamba_bwd_sum_kernel")))
    repeats = all(t is None or torch.equal(t, y) for t, y in zip(got, again))
    require(repeats, f"15d mamba_scan_bwd {name}: two calls gave different bits")
    del again
    plain, plain_ms = events_ms(lambda: ref.mamba_scan_bwd_ref(*args))
    zeros = torch.zeros((b, d, n), device=dev)
    auto = autograd_of(ref.mamba_scan_ref, (dt, x, bm, cm, a, h0),
                       (dy, zeros if dlast is None else dlast))
    names = ("ddt", "dx", "db", "dc", "da", "dh0")
    err = ssm_grads_check(f"15d mamba_scan_bwd {name}", names, got, plain, auto,
                          1e-3 * dy.abs().max().item())
    del got, plain, auto
    ms = min(cuda_ms(lambda: mamba_scan.mamba_scan_bwd_cuda(*args), iters) for _ in range(2))
    # the least work per (b, t, d, n), the exponential counted as one: e and
    # h_t once each (5), G *= e (1), G += dy C and the sums of dc, db and
    # dx's sum over n (2 each), q = G e h_t-1, da += dt q and ddt's sum of
    # a q (6); per (b, t, d) dt x, dx = dt sum_n G b and ddt += x sum_n G b
    # (4), which shares dx's sum. The least bytes: dt, dy in
    # float32 and x in its dtype read once, ddt and dx written once, b, c
    # read and db, dc written, a and da, the states given and returned
    flops, nbytes = kernel_cost.mamba_scan_bwd(b, s, d, n, itemsize=x.element_size(),
                                               with_state=with_state, with_dlast=with_dlast)
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sfu_ms = 1e3 * b * s * d * n / (16 * sms * max_sm_clock_mhz() * 1e6)
    vec = "true" if d % 8 == 0 else "false"  # staged 16 bytes a copy
    regs = ptxas_of("mamba_scan_bwd", f"mamba_scan_bwd_kernel<{kind}, {n}, {vec}>")
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err}
    print(f"15d mamba_scan_bwd {name}: B {b}, S {s}, D {d}, N {n}, "
          f"{str(dtype).removeprefix('torch.')} x, h0 {'given' if with_state else 'none'}, "
          f"dh_last {'given' if with_dlast else 'none'}{', decays ' + decays if decays else ''}: "
          f"max_abs_err {err:.3g} against the written-out backward (each gradient within "
          f"1e-4 (float32) or 2^-8 (bf16) of its scale of both plain versions); bits repeat: "
          f"{repeats}; kernel {ms:.4f} ms (CUDA events, the least of 2 timings), plain "
          f"{plain_ms:.1f} ms (written out, one call), bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {flops:.4g} FP32 operations at {PEAK_FP32_FLOPS / 1e12:g} "
          f"TFLOP/s, {nbytes:.4g} bytes); SFU floor {sfu_ms:.4f} ms (one exponential an "
          f"element; the kernel takes two IEEE expf: phase A and the recompute); "
          f"{row['bound_ms'] / ms:.3f} of the bound; passes (torch.profiler, one call): "
          f"{split}; ptxas: {regs}")
    return row


def train_run(dev, tag, arch, cfg, host_weights, steps, want, extra_flops, expect) -> dict:
    """Phases 15b and 15e: ``steps`` steps of ``launch.steps.build_train``
    (in place, as the launcher's) on ``cfg`` (bf16, remat, AdamW) from
    ``host_weights`` copied to the card, TRAIN_BATCH x TRAIN_SEQ tokens a
    step from ``token_batches``: the
    launch counts over the run held to ``want`` (every other kernel 0),
    the losses finite and falling, every gradient leaf nonzero. Prints the
    warm step ms, tokens/s, the share of 989 TFLOP/s by model FLOPs (6 x
    the active matrix params x tokens, an MoE's experts by top_k / E, +
    ``extra_flops``), peak memory and the device time by kernel of one more
    step (a trace held to show ``expect``). Returns the counts."""
    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.data.pipeline import token_batches
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import get_optimizer

    require(cfg.remat and cfg.param_dtype == "bfloat16" and cfg.optimizer == "adamw",
            f"{tag}: {arch} is not the bf16, remat, AdamW config it was")
    model = Model(cfg, device=dev)
    params = tree.map(lambda t: t.to(dev), host_weights)
    require([tuple(p.shape) for p in tree.leaves(params)]
            == [tuple(p.shape) for p in tree.leaves(model.abstract_params())],
            f"{tag}: the serve's weights do not fit the cut {arch} config")
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    state = opt.init(params)
    step, clipped = train_step_capturing(model)
    gen = token_batches(np.random.default_rng(SEED), TRAIN_BATCH, TRAIN_SEQ + 1, cfg.vocab_size)
    batches = [{k: torch.as_tensor(a, device=dev) for k, a in next(gen).items()}
               for _ in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses, gnorms, step_ms, zero_grads = [], [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(met["loss"].item())
        gnorms.append(met["grad_norm"].item())
        grads = clipped.pop()
        zero_grads.append([tree.path_str(p) for p, g in tree.leaves_with_path(grads)
                           if not bool((g != 0).any())])
        del grads
    counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    require(counts == {**{name: 0 for name in counts}, **want},
            f"{tag}: kernel launches {counts}, want {want} (remat runs each forward twice) "
            "and no other")
    require(all(math.isfinite(x) for x in losses + gnorms), f"{tag}: losses {losses}, "
            f"gradient norms {gnorms}")
    require(losses[-1] < losses[0], f"{tag}: the loss did not fall: {losses}")
    require(not any(zero_grads), f"{tag}: leaves with an all-zero gradient: {zero_grads}")
    warm_ms = float(np.median(step_ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_flops, active = smoke_model_flops(cfg, params, tokens, extra_flops)
    share = model_flops / (warm_ms * 1e-3 * PEAK_BF16_FLOPS)
    print(f"{tag} train {arch} at full width, {cfg.num_layers} layers "
          f"({model.param_count()} params, bf16, remat, AdamW lr {cfg.learning_rate}"
          f", in place), "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: losses "
          f"{[round(x, 4) for x in losses]}, gradient norms {[round(x, 4) for x in gnorms]}; "
          f"step ms {[round(x, 1) for x in step_ms]} (first includes torch's own warm-up), "
          f"warm median {warm_ms:.1f} ms, {tokens / (warm_ms * 1e-3):.0f} tokens/s, "
          f"{model_flops:.4g} model FLOPs a step ({active} active matrix params x 6 x tokens "
          f"+ {extra_flops:.4g}), {100 * share:.1f}% of {PEAK_BF16_FLOPS / 1e12:g} TFLOP/s; "
          f"peak memory {peak_gb:.2f} GB; launches a step: "
          + ", ".join(f"{k} {v // steps}" for k, v in want.items()))
    # where a step's device time goes (one more step, from the same state;
    # its launches are not the counted run's)
    rows_t = device_time_by_kernel(lambda: step(params, state, batches[0]), expect=expect)
    clipped.clear()
    busy = sum(ms for _, ms, _ in rows_t)
    print(f"{tag} step device time by kernel (torch.profiler): {busy:.1f} ms busy of "
          f"{warm_ms:.1f} ms warm wall ({100 * (1 - busy / warm_ms):.0f}% idle)" if rows_t
          else f"{tag} step device time by kernel: not measured (no device events)")
    for kname, ms, calls in rows_t[:12] + [r for r in rows_t[12:]
                                          if "(anonymous namespace)::" in r[0]]:
        print(f"  {ms:9.3f} ms {calls:6d} x  {kname[:90]}")
    del params, state, batches
    torch.cuda.empty_cache()
    return counts


def smoke_model_flops(cfg, params, tokens: int, extra_flops: int) -> tuple[int, int]:
    """(6 x the active matrix parameters x tokens + ``extra_flops``, the
    active matrix parameters): every parameter of two or more dimensions
    but the embedding, an MoE's experts by top_k / E."""
    from repro_torch import tree

    active = 0
    for path, p in tree.leaves_with_path(params):
        name = tree.path_str(path)
        if p.dim() > 1 and name != "['embed']":
            experts = (cfg.num_experts and "['ffn']" in name and p.dim() == 4
                       and p.shape[1] == cfg.num_experts)
            active += p.numel() * cfg.top_k // cfg.num_experts if experts else p.numel()
    return 6 * active * tokens + extra_flops, active


def f32_card_vs_cpu(dev, tag, arch, cfg32, host32, batch, seq, want) -> None:
    """Phases 15c and 15f: one float32 ``build_train`` step of ``cfg32`` on
    the card and on the CPU from ``host32`` and one batch: the card's
    launches ``want`` (every other kernel 0, none on the CPU), the loss to
    TRAIN_F32_LOSS_TOL, every clipped gradient leaf to TRAIN_F32_GRAD_TOL
    of its scale, and the card's AdamW step to TRAIN_F32_STEP_TOL of the
    CPU's AdamW step from the card's own gradients."""
    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.data.pipeline import token_batches
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import get_optimizer

    nb = next(token_batches(np.random.default_rng(SEED + 1), batch, seq + 1, cfg32.vocab_size))
    opt32 = get_optimizer(cfg32.optimizer, cfg32.learning_rate)
    runs = {}
    t0 = time.perf_counter()
    for device in ("cpu", dev):
        m32 = Model(cfg32, device=device)
        p32 = tree.map(lambda t: t.to(device, copy=True), host32)  # the step writes p32
        step32, clipped32 = train_step_capturing(m32)
        reset_launches()
        new, _, met = step32(p32, opt32.init(p32), {k: torch.as_tensor(a, device=device)
                                                    for k, a in nb.items()})
        runs["cpu" if device == "cpu" else "card"] = (
            tree.map(lambda t: t.cpu(), new), tree.map(lambda t: t.cpu(), clipped32.pop()),
            met["loss"].item(), read_launches())
        del new, p32, m32
    cpu_s = time.perf_counter() - t0
    (cp, cg, cl, cpu_counts), (gp, gg, gl, card_counts) = runs["cpu"], runs["card"]
    require(card_counts == {**{name: 0 for name in card_counts}, **want}
            and not any(cpu_counts.values()),
            f"{tag}: launches card {card_counts} (want {want}), CPU {cpu_counts}")

    def rel(got, ref_):
        return max((g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                   for g, w in zip(tree.leaves(got), tree.leaves(ref_)))

    loss_err = abs(gl - cl) / abs(cl)
    require(loss_err <= TRAIN_F32_LOSS_TOL, f"{tag}: the float32 loss card {gl} vs CPU {cl}")
    grad_err = rel(gg, cg)
    require(grad_err <= TRAIN_F32_GRAD_TOL, f"{tag}: a gradient leaf differs card vs CPU by "
            f"{grad_err:g} of its scale > {TRAIN_F32_GRAD_TOL}")
    want_p, _ = opt32.apply(gg, opt32.init(host32), tree.map(lambda t: t.clone(), host32))
    step_err = rel(gp, want_p)
    require(step_err <= TRAIN_F32_STEP_TOL, f"{tag}: the card's AdamW step differs from the "
            f"CPU's on the same gradients by {step_err:g} of a leaf's scale")
    print(f"{tag} float32 {cfg32.num_layers}-layer {arch} step, {batch} x {seq} tokens, card "
          f"vs CPU: loss {gl:.6f} vs {cl:.6f} ({loss_err:.3g} relative, <= "
          f"{TRAIN_F32_LOSS_TOL}); gradient leaves within {grad_err:.3g} of their scale (<= "
          f"{TRAIN_F32_GRAD_TOL}); the AdamW step from the card's gradients within "
          f"{step_err:.3g} of the CPU's (<= {TRAIN_F32_STEP_TOL}); parameters after the two "
          f"steps within {rel(gp, cp):.3g} of their scale (not a gate); launches on the card "
          f"{ {k: v for k, v in card_counts.items() if v} }; {cpu_s:.1f} s")


def kernel_counts(cfg, steps: int) -> dict:
    """The launches ``steps`` train steps of ``cfg`` make on the card: each
    layer's kernel (attention, WKV-6, the Mamba scan) its forward once, or
    twice under remat, and its backward once, a step."""
    kinds = cfg.layer_kinds()
    fwd = 2 if cfg.remat else 1
    out = {}
    for kind, key in (("attn", "flash_attention"), ("rwkv6", "wkv6"), ("mamba", "mamba_scan")):
        if kinds.count(kind):
            out[key] = fwd * kinds.count(kind) * steps
            out[f"{key}_bwd"] = kinds.count(kind) * steps
    return out


def train_phase(dev, host_weights, rwkv_weights, jamba_weights) -> list[dict]:
    """Phase 15: training on the card. Returns the kernels line's entries
    of attention's, the WKV-6 and the scan's backward kernels."""
    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import token_batches
    from repro_torch.kernels import flash_attention
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import get_optimizer

    t_phase = time.perf_counter()
    # -- 15a. the backward kernel against its plain versions -------------------
    for kname, line in ptxas_entries(BUILD_LOGS.get("flash_attention_bwd", "")):
        print(f"15a ptxas flash_attention_bwd {kname}: {line}")
    rows = [bwd_case(dev, *case) for case in BWD_CASES]
    torch.cuda.empty_cache()

    # -- 15b. Llama-3.2-3B at full width, TRAIN_LAYERS layers, TRAIN_STEPS steps
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    pairs = kernel_cost.attention_pairs(TRAIN_SEQ, TRAIN_SEQ, True, None)
    attn_flops = 3 * 4 * TRAIN_BATCH * cfg.num_heads * cfg.resolved_head_dim * pairs
    train_counts = train_run(dev, "15b", TRAIN_ARCH, cfg, host_weights, TRAIN_STEPS,
                             kernel_counts(cfg, TRAIN_STEPS), cfg.num_layers * attn_flops,
                             "dkdv_kernel")
    require(flash_attention.last_bwd_kernel == "tc",
            f"15b: the step's attention backward ran the {flash_attention.last_bwd_kernel} "
            f"kernels, not the tensor-core ones")

    # -- 16b. the same step counted while its kernels run ----------------------
    params = tree.map(lambda t: t.to(dev, copy=True), host_weights)
    batch = next(token_batches(np.random.default_rng(SEED), TRAIN_BATCH, TRAIN_SEQ + 1,
                               cfg.vocab_size))
    batch = {k: torch.as_tensor(a, device=dev).to(torch.int32) for k, a in batch.items()}
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    count_phase(dev, "16b train", cfg, InputShape("15b", TRAIN_SEQ, TRAIN_BATCH, "train"),
                params, (opt.init(params), batch), kernel_counts(cfg, 1),
                smoke_flops=smoke_model_flops(cfg, params, TRAIN_BATCH * TRAIN_SEQ,
                                              cfg.num_layers * attn_flops))
    del params, batch
    torch.cuda.empty_cache()

    # -- 15c. the float32 gate: one step on the card and on the CPU -----------
    cfg32 = dataclasses.replace(cfg, num_layers=TRAIN_F32_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    host32 = tree.map(lambda t: t.float(), cut_layers(host_weights, TRAIN_F32_LAYERS, "cpu"))
    f32_card_vs_cpu(dev, "15c", TRAIN_ARCH, cfg32, host32, TRAIN_F32_BATCH, TRAIN_F32_SEQ,
                    kernel_counts(cfg32, 1))
    del host32

    # -- 15d. the WKV-6 and scan backward kernels against their plain versions
    wkv_rows = [wkv_bwd_case(dev, *case) for case in WKV_BWD_CASES]
    torch.cuda.empty_cache()
    mamba_rows = [mamba_bwd_case(dev, *case) for case in MAMBA_BWD_CASES]
    torch.cuda.empty_cache()

    # -- 15e. RWKV-6 and Jamba at full width, their depth cut
    rcfg = dataclasses.replace(get_config(RWKV_ARCH), num_layers=RWKV_TRAIN_LAYERS)
    h, hd = rcfg.rwkv_heads, rcfg.rwkv_head_dim
    wkv_flops = 3 * 4 * TRAIN_BATCH * TRAIN_SEQ * h * hd * hd  # y and the state, fwd + bwd
    rwkv_counts = train_run(dev, "15e", RWKV_ARCH, rcfg, rwkv_weights, SSM_TRAIN_STEPS,
                            kernel_counts(rcfg, SSM_TRAIN_STEPS), rcfg.num_layers * wkv_flops,
                            "rows_kernel")
    jcfg = dataclasses.replace(get_config(JAMBA_ARCH), num_layers=JAMBA_TRAIN_LAYERS)
    require(list(zip(jcfg.layer_kinds(), jcfg.layer_is_moe())) == [("mamba", True),
                                                                   ("mamba", False)],
            "15e: Jamba's cut is not a Mamba+MoE and a Mamba+dense layer")
    scan_flops = 3 * 6 * TRAIN_BATCH * TRAIN_SEQ * jcfg.d_inner * jcfg.d_state
    jamba_counts = train_run(dev, "15e", JAMBA_ARCH, jcfg, jamba_weights, SSM_TRAIN_STEPS,
                             kernel_counts(jcfg, SSM_TRAIN_STEPS),
                             jcfg.num_layers * scan_flops, "mamba_scan_bwd_kernel")

    # -- 15f. float32 steps of the reduced configs, card vs CPU ----------------
    for arch in (RWKV_ARCH, JAMBA_ARCH):
        fcfg = get_reduced(arch)
        require(fcfg.param_dtype == fcfg.compute_dtype == "float32",
                f"15f: the reduced {arch} is not float32")
        f32_card_vs_cpu(dev, "15f", arch, fcfg, Model(fcfg, device="cpu").init(SEED),
                        SSM_F32_BATCH, SSM_F32_SEQ, kernel_counts(fcfg, 1))
    print(f"training phase 15: {time.perf_counter() - t_phase:.1f} s")

    return [
        {"name": "flash_attention_bwd (bf16: tc, wgmma from TMA rings, warp-specialised, "
                 "P and dS in two bf16 pieces, no atomics)", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu", "replaces": None,
         "launches": train_counts["flash_attention_bwd"], **rows[0]},
        {"name": "wkv6_bwd (64-step chunks: the forward's chunk states; the chunk kernel on "
                 "reversed time for dv, ds0 and the boundary gradients, 3xTF32 mma.sync; a "
                 "row walk a (b, h, chunk, 32 rows) on the CUDA cores for dr, dk, dw; "
                 "cp.async staging; no atomics)",
         "route": "cuda", "source": "src/repro_torch/csrc/wkv6_bwd.cu", "replaces": None,
         "launches": rwkv_counts["wkv6_bwd"], **wkv_rows[0]},
        {"name": "mamba_scan_bwd (CUDA cores, float32, IEEE expf twice an element, a "
                 "checkpoint a sub-chunk, decays kept from the recompute, dB/dC by a "
                 "transposed butterfly over a warp's channels, cp.async ring, no atomics)", "route": "cuda",
         "source": "src/repro_torch/csrc/mamba_scan_bwd.cu", "replaces": None,
         "launches": jamba_counts["mamba_scan_bwd"], **mamba_rows[0]},
    ]


if __name__ == "__main__":
    sys.exit(main())
