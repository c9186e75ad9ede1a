"""Two-tier fleet-of-fleets federation, in torch (``repro/fed/fleet.py``).

Everything below this module simulates ONE edge fleet of K learners. This
is the population-scale layer: F fleets of K learners, as an (F, K)
``BatchedProblems`` population, (F K, d_cap, features) staged samples and
a parameter set per fleet with a leading F axis. The fleet axis is split
over a mesh of ranks (``launch.mesh``, ``sharding.rules.FLEET_RULES``):
F is padded to a multiple of the mesh's size with all-invalid fleets, and
each rank holds and trains its block of F_pad / n fleets. A global round:

  1. every fleet runs its paper-scheme cycle: its K learners train from
     the fleet's parameters for their tau steps and the fleet server
     aggregates them, staleness-weighted. All of a rank's fleets go through
     ONE ``kernels.ops.train_agg_step`` call grouped by fleet: on the card
     one training-kernel launch and one grouped ``fed_agg`` launch, on the
     CPU their plain versions. A loss other than ``mlp.loss`` trains on
     the CPU only, through the plain autograd round
     (``orchestrator.local_train_stacked`` and each fleet's weighted sum),
     as the reference's unfused round does; on the card it is refused;
  2. the global server merges the round's SAMPLED fleets (FedAST-style
     partial participation): each sampled fleet's model is weighted by its
     data volume times the version-staleness discount
     ``staleness_factor(g - pull_version)``, normalised, and mixed into the
     global model at ``server_mix`` (1 selects the merged model). Each rank
     sums its own fleets in one ``ops.fed_agg_leaves`` call, and one
     ``all_reduce`` over the mesh axes the fleet axis is split over adds
     the ranks' sums (the reference's ``psum``);
  3. the next dispatch is solved for the sampled fleets with ONE
     ``batched_policy`` call on the sampling-masked (F, K) problem
     (``apply_sampling_mask``: a sampled-out fleet is exactly an all-offline
     fleet is exactly a row of padded slots), while unsampled fleets keep
     training on their stale dispatch. The solve runs through
     ``compat.shard_map``: each rank solves its block of rows (a row's
     bisection stops on its own test, so its (tau, d) does not depend on
     the rows beside it) and the rows are gathered. On the card every
     bisection step launches the water-filling kernel.

The schedule (sampling, staleness, weights, (tau, d)) is host NumPy and
whole on every rank, so every rank writes the same records. Fleet f's
partitioner seed is drawn from the engine rng in fleet order on every
rank, so fleet f draws the same shards whatever the mesh.

Exactness: with F = 1, full participation and a one-rank mesh every stage
degenerates to the single-fleet path (one group, a merge weight of exactly
1.0, ``server_mix = 1`` selecting the merged model), so the engine
reproduces ``Orchestrator.run_fused`` record for record and parameter for
parameter. On n ranks the records are the one-rank engine's bit for bit;
the models differ by the order of the merge's sums.

The engine runs on the device that holds ``init_params``; the mesh's
collectives run on the process group's backend (NCCL on the card, gloo on
the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import (
    BatchedProblems,
    apply_active_mask,
    apply_sampling_mask,
    batched_avg_staleness,
    batched_max_staleness,
    batched_policy,
    fedavg_weights,
    staleness_weights,
)
from repro_torch import compat
from repro_torch.compat import PartitionSpec as P
from repro_torch.core.solver_batched import POLICIES, cross_model_weights
from repro_torch.core.staleness import STALENESS_FNS, staleness_factor
from repro_torch.data.pipeline import Dataset, FederatedPartitioner
from repro_torch.fed.orchestrator import ENERGY_SCHEMES, local_train_stacked
from repro_torch.kernels import ops
from repro_torch.launch.mesh import host_mesh
from repro_torch.models import mlp
from repro_torch.sharding.rules import fleet_partition_axes

__all__ = ["FleetConfig", "FleetEngine", "build_fleet_problems"]

# seed-sequence tag of the per-round fleet-sampling draws (disjoint from the
# partitioners' draws, which live under per-fleet seeds)
_SAMPLE_STREAM = 0x5AB5


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs of the two-tier engine (per-fleet problem knobs live in the
    ``BatchedProblems`` population passed to ``FleetEngine``)."""

    lr: float = 0.1
    scheme: str = "kkt_sai"            # batched policy of the fleet solves
    aggregation: str = "staleness"     # intra-fleet: staleness | fedavg
    staleness_gamma: float = 1.0
    participation: float = 1.0         # fraction of fleets sampled a round
    server_mix: float = 1.0            # global server's mixing rate (1 = replace)
    staleness_fn: str = "poly"         # cross-tier discount of stale fleets
    staleness_a: float = 0.5
    staleness_b: float = 4.0

    def __post_init__(self):
        if self.scheme not in POLICIES:
            raise ValueError(
                f"the fleet engine solves through batched_policy; scheme "
                f"{self.scheme!r} has none ({' | '.join(POLICIES)})"
            )
        if self.aggregation not in ("staleness", "fedavg"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}")
        if not (0.0 < self.participation <= 1.0):
            raise ValueError("participation must be in (0, 1]")
        if not (0.0 < self.server_mix <= 1.0):
            raise ValueError("server_mix must be in (0, 1]")
        if self.staleness_fn not in STALENESS_FNS:
            raise ValueError(
                f"unknown staleness fn {self.staleness_fn!r}: "
                + " | ".join(STALENESS_FNS)
            )


def build_fleet_problems(
    f: int,
    k: int = 8,
    *,
    T: float = 6.0,
    total_samples: int = 60,
    seed: int = 0,
    jitter: float = 0.25,
) -> BatchedProblems:
    """An (F, K) fleet population around the hand-tuned spread coefficients:
    every draw comes from one generator keyed by ``(seed, f, k)`` drawing
    whole (F, K) arrays at once, so the population is the same in every
    process."""
    base_c2 = np.array([0.050, 0.031, 0.022, 0.045, 0.027, 0.038, 0.019, 0.042])
    base_c1 = np.array([0.004, 0.006, 0.003, 0.005, 0.002, 0.004, 0.006, 0.003])
    base_c0 = np.array([0.40, 0.55, 0.30, 0.25, 0.45, 0.35, 0.50, 0.28])
    if k > base_c2.size:
        reps = -(-k // base_c2.size)
        base_c2, base_c1, base_c0 = (
            np.tile(a, reps) for a in (base_c2, base_c1, base_c0)
        )
    rng = np.random.default_rng(np.random.SeedSequence((seed, f, k)))
    scale = np.exp(jitter * rng.standard_normal((3, f, k)))
    c2 = base_c2[:k][None] * scale[0]
    c1 = base_c1[:k][None] * scale[1]
    c0 = base_c0[:k][None] * scale[2]
    return BatchedProblems(
        c2=c2, c1=c1, c0=c0,
        T=np.full(f, float(T)),
        total=np.full(f, int(total_samples), np.int64),
        d_lo=np.full((f, k), float(max(1, total_samples // (2 * k)))),
        d_hi=np.full((f, k), float(min(total_samples, 2 * total_samples // k))),
        valid=np.ones((f, k), bool),
    )




def _fleet_spec(axes: tuple[str, ...], extra: int = 0) -> P:
    """The spec of a tensor whose LEADING dimension is the fleet axis, split
    over ``axes``, and whose ``extra`` other dimensions are whole."""
    lead = None if not axes else (axes[0] if len(axes) == 1 else tuple(axes))
    return P(lead, *([None] * extra))


class FleetEngine:
    """F fleets x K learners, two-tier servers, on the device that holds
    ``init_params`` (a list of ``{"w", "b"}`` leaves of ``mlp``), over
    ``mesh`` (default ``launch.mesh.host_mesh()``: the (2, 4) ``"test"``
    mesh in a process group of 8 ranks or more, else one rank).

    ``problems`` is the (F, K) ``BatchedProblems`` population (build one
    with ``build_fleet_problems``); F is padded up to a multiple of the
    mesh's size with all-invalid fleets (never sampled, zero weight, zero
    work: the padded-slot semantics lifted one axis up). ``tau``, ``d``,
    ``pull_version`` and the records cover every fleet on every rank;
    ``fleet_params`` holds this rank's block of fleets only. ``loss_fn`` is
    ``mlp.loss`` (the train+aggregate kernel) or, on the CPU, any
    ``(params, batch) -> scalar`` of the MLP's parameters."""

    def __init__(self, cfg: FleetConfig, problems: BatchedProblems, loss_fn,
                 init_params, *, seed: int = 0, mesh=None):
        self.device = init_params[0]["w"].device
        if loss_fn is not mlp.loss and self.device.type != "cpu":
            raise ValueError("on the card the fleet engine trains mlp.loss only (through "
                             "ops.train_agg_step); another loss trains on the CPU")
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.global_params = init_params
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.mesh = host_mesh() if mesh is None else mesh
        if self.mesh.device_mesh is not None and self.mesh.device_type != self.device.type:
            raise ValueError(f"a {self.mesh.device_type} mesh cannot move the engine's "
                             f"{self.device.type} tensors")

        self.num_fleets = problems.num_problems
        n_dev = self.mesh.size
        f_pad = -(-self.num_fleets // n_dev) * n_dev
        self.problems = self._pad_problems(problems, f_pad)
        self.fleet_axes = fleet_partition_axes(f_pad, self.mesh)
        self._real = np.zeros(f_pad, bool)
        self._real[: self.num_fleets] = True
        index, count = self.mesh.block(self.fleet_axes)
        size = f_pad // count
        self._block = slice(index * size, (index + 1) * size)
        self._args = self._solve_args()
        self._energy = self._energy_args()

        self.global_version = 0
        self.pull_version = np.zeros(f_pad, np.int64)
        self.rounds_run = 0
        self.tau, self.d = self._solve(self._real)
        self._check_feasible(self._real, self._last_feasible, "initial dispatch")
        # every fleet of this rank's block starts from the global model
        # (version-0 dispatch)
        self.fleet_params = [
            {n: leaf[None].expand((size,) + leaf.shape) for n, leaf in layer.items()}
            for layer in init_params
        ]

    @staticmethod
    def _pad_problems(bp: BatchedProblems, f_pad: int) -> BatchedProblems:
        """``bp`` padded with all-invalid fleets up to ``f_pad`` (never
        sampled, zero weight, zero work: the padded-slot semantics lifted
        one axis up), so that the fleet axis splits evenly over the mesh."""
        f = bp.num_problems
        if f == f_pad:
            return bp
        pad = lambda a, fill: np.concatenate(
            [np.asarray(a),
             np.full((f_pad - f,) + np.asarray(a).shape[1:], fill,
                     np.asarray(a).dtype)]
        )
        energy = {}
        if bp.has_energy:
            # padded fleets are free: zero coefficients, infinite budget
            k = np.asarray(bp.c2).shape[1]
            e2, e1, e0, eb = bp.energy_rows()
            energy = dict(
                e2=pad(e2, 0.0), e1=pad(e1, 0.0), e0=pad(e0, 0.0),
                e_budget=pad(np.broadcast_to(eb, (f, k)), np.inf),
            )
        return BatchedProblems(
            c2=pad(bp.c2, 1.0), c1=pad(bp.c1, 1.0), c0=pad(bp.c0, 0.0),
            T=pad(bp.T, 1.0), total=pad(bp.total, 0),
            d_lo=pad(bp.d_lo, 0.0), d_hi=pad(bp.d_hi, 0.0),
            valid=pad(bp.valid, False), **energy,
        )

    # -- allocation ---------------------------------------------------------
    def _solve_args(self) -> tuple:
        """The population's policy tensors on the engine's device:
        ``(c2, c1, c0, T, total, d_lo, d_hi, valid)``, float64, int64 and
        bool."""
        bp, dev = self.problems, self.device
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
        return (f64(bp.c2), f64(bp.c1), f64(bp.c0), f64(bp.T),
                torch.as_tensor(np.asarray(bp.total, np.int64), device=dev),
                f64(bp.d_lo), f64(bp.d_hi),
                torch.as_tensor(np.asarray(bp.valid, bool), device=dev))

    def _energy_args(self) -> tuple:
        """Trailing ``(e2, e1, e0, e_budget)`` policy rows, only for the
        energy-aware schemes (a population without an energy model gets
        zero coefficients and infinite budgets, which decide as
        ``kkt_sai``)."""
        if self.cfg.scheme not in ENERGY_SCHEMES:
            return ()
        f, k = np.asarray(self.problems.c2).shape
        rows = self.problems.energy_rows()
        return tuple(torch.as_tensor(np.array(np.broadcast_to(r, (f, k)), np.float64),
                                     device=self.device) for r in rows)

    def _policy_solve(self, args, sampled, en, axes):
        """ONE ``batched_policy`` call on the sampling-masked rows, each
        rank solving its block of them (split over the mesh axes ``axes``)
        and the rows gathered; returns host (tau, d, feasible)."""
        policy = batched_policy(self.cfg.scheme)

        def body(c2, c1, c0, T, total, lo, hi, valid, sampled, *en):
            tot_m, lo_m, hi_m, valid_m = apply_sampling_mask(total, lo, hi, valid, sampled)
            extra = (en,) if en else ()
            return policy(c2, c1, c0, T, tot_m, lo_m, hi_m, valid_m, *extra)

        row, vec = _fleet_spec(axes, 1), _fleet_spec(axes)
        tau, d, feas = compat.shard_map(
            body, mesh=self.mesh,
            in_specs=(row, row, row, vec, vec, row, row, row, vec) + (row,) * len(en),
            out_specs=(row, row, vec),
        )(*args, torch.as_tensor(np.asarray(sampled, bool), device=self.device), *en)
        return (tau.cpu().numpy().astype(np.int64), d.cpu().numpy().astype(np.int64),
                feas.cpu().numpy().astype(bool))

    def _solve(self, sampled: np.ndarray):
        """(tau, d) int64 host arrays for the sampled fleets (zeros in the
        rest), one batched policy call over the mesh."""
        tau, d, self._last_feasible = self._policy_solve(self._args, sampled, self._energy,
                                                         self.fleet_axes)
        return tau, d

    def solve_multimodel(self, deficits, *, split: str = "deficit",
                         share_floor: float = 0.0, sampled=None):
        """(tau, d, w) for S tenant models time-sharing the whole (F, K)
        population, the fleet-scale face of the cross-model allocation
        layer (``core.solver_batched.multimodel_policy``).

        ``deficits`` is the (S,) progress-deficit signal of the tenants'
        global servers; ``cross_model_weights`` turns it into shares ``w``
        splitting every fleet's deadline ``T_f`` (and the joule budgets,
        for the energy-aware schemes), each model's sample budget is
        ``round(w_s * total_f)``, and cells whose share cannot cover
        ``c0 + c1 d_lo`` at tau = 0 degrade to padded slots. The S x F_pad
        problems are flattened model-major to (S F_pad, K) and solved with
        ONE batched policy call over the mesh (``fleet_partition_axes`` of
        S F_pad). The reference computes this split outside a jit, each
        operation rounded on its own, and so does this one: the floored
        share ``(1 - S floor) p + floor`` and the degrade test's ``c0 + c1
        d_lo`` round twice here, where ``multimodel_policy`` (a jit in the
        reference) rounds them once.

        Returns ``(tau, d, w)`` with tau, d (S, F_pad, K) int64. S = 1 is
        ``_solve``'s call, bitwise."""
        sampled = self._real if sampled is None else np.asarray(sampled, bool)
        deficits = np.asarray(deficits, np.float64)
        s = int(deficits.shape[0])
        if s == 1:
            tau, d = self._solve(sampled)
            return tau[None], d[None], np.ones(1)
        f, k = np.asarray(self.problems.c2).shape
        w = cross_model_weights(deficits, policy=split, share_floor=share_floor, fused=False)
        c2, c1, c0, T, total, lo, hi, valid = self._args
        tile = lambda a: a.repeat((s,) + (1,) * (a.dim() - 1))
        w_f = torch.repeat_interleave(w.to(device=self.device, dtype=T.dtype), f)  # (S F,)
        T_s = w_f * tile(T)
        total_s = torch.round(w_f * tile(total).to(T.dtype)).to(total.dtype)
        c2_t, c1_t, c0_t = tile(c2), tile(c1), tile(c0)
        lo_t, hi_t, valid_t = tile(lo), tile(hi), tile(valid)
        active = valid_t & (T_s[:, None] >= c0_t + c1_t * lo_t)
        total_s, lo_t, hi_t, valid_t = apply_active_mask(total_s, lo_t, hi_t, valid_t, active)
        en = self._energy
        if en:
            e2, e1, e0, eb = (tile(e) for e in en)
            en = (e2, e1, e0, torch.where(torch.isinf(eb), eb, w_f[:, None] * eb))
        tau, d, feas = self._policy_solve(
            (c2_t, c1_t, c0_t, T_s, total_s, lo_t, hi_t, valid_t), np.tile(sampled, s), en,
            fleet_partition_axes(s * f, self.mesh))
        for si in range(s):
            self._check_feasible(sampled, feas.reshape(s, f)[si],
                                 f"multimodel solve, model {si}")
        return tau.reshape(s, f, k), d.reshape(s, f, k), w.numpy()

    def _check_feasible(self, sampled, feas, label: str):
        bad = self._real & np.asarray(sampled, bool) & ~np.asarray(feas, bool)
        if bad.any():
            raise ValueError(
                "infeasible: even with tau=0 the deadline T cannot absorb "
                f"d samples (fleet {int(np.argmax(bad))} at {label})"
            )

    # -- per-round staging --------------------------------------------------
    def _sample_mask(self, r: int) -> np.ndarray:
        f = self.num_fleets
        mask = np.zeros(self._real.size, bool)
        if self.cfg.participation >= 1.0:
            mask[:f] = True
            return mask
        n = max(1, int(round(self.cfg.participation * f)))
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, _SAMPLE_STREAM, r))
        )
        mask[rng.choice(f, size=n, replace=False)] = True
        return mask

    def _stage(self, parts, n_train: int, d_cap: int) -> np.ndarray:
        """(F_b, K, d_cap) row indices into the training set for this
        round's dispatch of this rank's block of fleets: fleet f's draw of
        ``d[f].sum()`` samples split over its learners in order, each
        learner's rows past its d_k pointing at ``n_train``, the zero row
        the caller appends (the reference's zero-padded shards)."""
        d = self.d[self._block]
        draws = [parts[i].draw_indices(int(self.d[i].sum())) if self._real[i]
                 else np.zeros(0, np.int64)
                 for i in range(self._block.start, self._block.stop)]
        flat = np.concatenate(draws + [np.full(1, n_train)])
        sizes = np.asarray([x.size for x in draws], np.int64)
        first = (np.cumsum(sizes) - sizes)[:, None] + (np.cumsum(d, axis=1) - d)
        j = np.arange(d_cap)
        return flat[np.where(j < d[..., None], first[..., None] + j, flat.size - 1)]

    def _weights(self) -> np.ndarray:
        """(F_b, K) float32 intra-fleet aggregation weights of this rank's
        block: each fleet's ``staleness_weights`` (or ``fedavg_weights``)
        in float64, then float32, as the orchestrator computes them; a
        padded fleet's are 0 (its learners do no work)."""
        k = self.d.shape[1]
        rows = []
        for i in range(self._block.start, self._block.stop):
            if not self._real[i]:
                rows.append(np.zeros(k))
            elif self.cfg.aggregation == "staleness":
                rows.append(staleness_weights(self.tau[i], self.d[i],
                                              gamma=self.cfg.staleness_gamma))
            else:
                rows.append(fedavg_weights(self.d[i]))
        return np.stack(rows).astype(np.float32)

    # -- one round's two tiers ------------------------------------------------
    def _plain_round(self, x, y, m, tau, w, max_tau: int) -> list[dict]:
        """Tier 1 through autograd, for a loss the training kernel does not
        take (the CPU only): each learner's tau GD steps from its fleet's
        parameters (``orchestrator.local_train_stacked``), then each
        fleet's weighted sum over its K learners (the contraction of
        ``core.aggregation.aggregate``). Returns (F_b, ...) leaves."""
        fb, k = self._block.stop - self._block.start, self.d.shape[1]
        stacked = [{n: leaf[:, None].expand((fb, k) + leaf.shape[1:]).reshape(
                        (fb * k,) + leaf.shape[1:]) for n, leaf in layer.items()}
                   for layer in self.fleet_params]
        learners = local_train_stacked(stacked, x, y, m, tau, self.cfg.lr, max_tau=max_tau,
                                       loss_fn=self.loss_fn)
        ww = w.reshape(fb, k)

        def wsum(leaf):
            leaf = leaf.reshape((fb, k) + leaf.shape[1:])
            return (leaf * ww.reshape((fb, k) + (1,) * (leaf.dim() - 2))).sum(dim=1)

        return [{n: wsum(leaf) for n, leaf in layer.items()} for layer in learners]

    def _merge(self, fleet_new, wg: np.ndarray) -> list[dict]:
        """The sampled fleets' weighted sum: this rank's fleets in one
        ``ops.fed_agg_leaves`` call, then one ``all_reduce`` over the mesh
        axes the fleet axis is split over."""
        keys = [(l, n) for l, layer in enumerate(fleet_new) for n in layer]
        sums = ops.fed_agg_leaves([fleet_new[l][n] for l, n in keys],
                                  torch.from_numpy(wg[self._block]).to(self.device))
        if self.fleet_axes and self.mesh.device_mesh is not None:
            flat = torch.cat([t.reshape(-1) for t in sums])
            compat.psum([flat], self.fleet_axes, self.mesh)
            sums = [part.view(t.shape) for part, t in
                    zip(torch.split(flat, [t.numel() for t in sums]), sums)]
        merged = iter(sums)
        return [{n: next(merged) for n in layer} for layer in fleet_new]

    # -- full run -----------------------------------------------------------
    def run(self, train: Dataset, rounds: int, *, eval_fn=None,
            eval_batch=None) -> list[dict]:
        """Run ``rounds`` global rounds; returns one history record per
        round. ``eval_fn`` is ``(params, x, y) -> scalar`` (e.g.
        ``mlp.accuracy``), read on ``eval_batch`` after every merge.
        Repeated calls continue from the current state (fresh
        partitioners, as ``Orchestrator.run``)."""
        if eval_fn is not None and eval_batch is None:
            raise ValueError("eval_fn needs eval_batch=(x, y)")
        cfg, dev, real, blk = self.cfg, self.device, self._real, self._block
        fb, k = blk.stop - blk.start, self.d.shape[1]
        parts = [
            FederatedPartitioner(train, seed=int(self.rng.integers(2**31)))
            for _ in range(self.num_fleets)
        ]
        # the training set on the device once a run, with a zero row at its
        # end for the padded rows
        tx = torch.from_numpy(np.concatenate(
            [train.x, np.zeros((1,) + train.x.shape[1:], train.x.dtype)])).to(dev)
        ty = torch.from_numpy(np.concatenate(
            [train.y, np.zeros(1, train.y.dtype)]).astype(np.int32)).to(dev)
        if eval_fn is not None:
            ex, ey = (torch.as_tensor(a, device=dev) for a in eval_batch)
        t_round = float(self.problems.T[real].max())
        history: list[dict] = []
        for r in range(self.rounds_run, self.rounds_run + rounds):
            sampled = self._sample_mask(r)
            d_cap = max(1, int(self.d[real].max()))
            max_tau = max(1, int(self.tau[real].max()))
            idx = torch.from_numpy(self._stage(parts, train.size, d_cap).reshape(fb * k, d_cap))
            idx = idx.to(dev)
            stale = np.maximum(self.global_version - self.pull_version, 0)
            phi = staleness_factor(
                stale, kind=cfg.staleness_fn, a=cfg.staleness_a, b=cfg.staleness_b,
            )
            n_f = self.d.sum(axis=1).astype(np.float64)
            base_w = np.where(real, n_f * phi, 0.0)

            # -- tier 1: each fleet trains its K learners and aggregates ----
            m = (torch.arange(d_cap, device=dev)[None, :]
                 < torch.as_tensor(self.d[blk].reshape(-1), device=dev)[:, None]
                 ).to(torch.float32)
            tau_t = torch.as_tensor(self.tau[blk].reshape(-1), dtype=torch.int32, device=dev)
            w_t = torch.as_tensor(self._weights().reshape(-1), device=dev)
            if self.loss_fn is mlp.loss:
                fleet_new, _ = ops.train_agg_step(self.fleet_params, tx[idx], ty[idx], m,
                                                  tau_t, w_t, cfg.lr, max_tau=max_tau,
                                                  groups=fb)
                fleet_new = [{n: leaf.reshape((fb,) + self.global_params[l][n].shape)
                              for n, leaf in layer.items()}
                             for l, layer in enumerate(fleet_new)]
            else:
                fleet_new = self._plain_round(tx[idx], ty[idx], m, tau_t, w_t, max_tau)

            # -- tier 2: staleness-discounted merge of the sampled fleets ---
            bw = np.where(sampled, base_w, 0.0)
            norm = bw.sum()
            any_sampled = bool(norm > 0.0)
            wg = (bw / (norm if any_sampled else 1.0)).astype(np.float32)
            merged = self._merge(fleet_new, wg)
            new_g = self.global_params
            if any_sampled and cfg.server_mix == 1.0:
                # server_mix == 1 SELECTS the merged model (no 0 g + 1 m
                # blend, which would flip signed zeros)
                new_g = merged
            elif any_sampled:
                mix = torch.tensor(cfg.server_mix, dtype=torch.float32, device=dev)
                new_g = [{n: ((1.0 - mix) * g[n] + mix * mg[n]).to(g[n].dtype) for n in g}
                         for g, mg in zip(self.global_params, merged)]

            # -- next dispatch: ONE masked policy solve for sampled fleets --
            tau_n, d_n = self._solve(sampled)
            self._check_feasible(sampled, self._last_feasible, f"round {r}")

            # sampled fleets pull the new global; the rest keep training stale
            keep = torch.as_tensor(sampled[blk], device=dev)
            fleet_out = [{n: torch.where(keep.reshape((-1,) + (1,) * g[n].dim()), g[n][None],
                                         fn[n])
                          for n in fn} for fn, g in zip(fleet_new, new_g)]
            acc = float(eval_fn(new_g, ex, ey)) if eval_fn is not None else None
            self.global_params, self.fleet_params = new_g, fleet_out
            rec = {
                "round": r,
                "cycle": r,
                "elapsed_s": (r + 1) * t_round,
                "wall_clock_s": t_round,
                "fleets": int(self.num_fleets),
                "sampled_fleets": int(sampled.sum()),
                "tau": self.tau[real].copy(),
                "d": self.d[real].copy(),
                "max_staleness": batched_max_staleness(self.tau[real], self.problems.valid[real]),
                "avg_staleness": batched_avg_staleness(self.tau[real], self.problems.valid[real]),
                "fleet_staleness_max": int(stale[sampled].max()),
                "fleet_staleness_mean": float(stale[sampled].mean()),
            }
            if eval_fn is not None:
                rec["accuracy"] = acc
            history.append(rec)
            # bookkeeping: the merge bumps the global version; sampled fleets
            # pulled it and re-dispatch with the freshly solved (tau, d)
            self.global_version += 1
            self.pull_version[sampled] = self.global_version
            self.tau = np.where(sampled[:, None], tau_n, self.tau)
            self.d = np.where(sampled[:, None], d_n, self.d)
        self.rounds_run += rounds
        return history
