"""Asynchronous MEL orchestrator (paper Sec. II + V), in torch.

One global cycle of wall-clock budget ``T``:
  1. allocate (tau_k, d_k) with the chosen scheme,
  2. dispatch the global model + per-learner batches,
  3. every learner runs tau_k local GD updates on its masked shard,
  4. staleness-aware aggregation (ref [10]) of the returned models.

Two paths, as in ``repro/fed/orchestrator.py``:

  * ``run`` / ``run_cycle`` — eager: shards staged each cycle, local
    training by autograd (``local_train``), aggregation by ``aggregate``;
    plain torch on whichever device holds the parameters.
  * ``run_fused`` — all cycles' shards are staged up front on the device,
    then each cycle is one ``kernels.ops.train_agg_step`` call: the CUDA
    train+aggregate kernels on the card, their plain version on the CPU.

Both draw the same shards and allocation for the same seed. Per-cycle
reallocation and capacity drift come with a later slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import (
    Allocation,
    AllocationProblem,
    aggregate,
    fedavg_weights,
    solve_eta,
    solve_kkt_sai,
    solve_synchronous,
    staleness_weights,
)
from repro_torch.core.staleness import avg_staleness, max_staleness
from repro_torch.data.pipeline import Dataset, FederatedPartitioner
from repro_torch.kernels import ops
from repro_torch.models import mlp

__all__ = ["MELConfig", "Orchestrator", "SCHEMES", "local_train", "local_train_stacked"]

SCHEMES: dict[str, Callable[[AllocationProblem], Allocation]] = {
    "kkt_sai": solve_kkt_sai,
    "eta": solve_eta,
    "sync": solve_synchronous,
}

_LATER = "comes with a later slice of the port (ROADMAP Queue 1)"


def _solver(scheme: str) -> Callable[[AllocationProblem], Allocation]:
    if scheme not in SCHEMES:
        raise KeyError(f"scheme {scheme!r} is not ported yet (ported: "
                       f"{', '.join(SCHEMES)}); it {_LATER}")
    return SCHEMES[scheme]


@dataclasses.dataclass(frozen=True)
class MELConfig:
    T: float = 15.0
    total_samples: int = 6000          # d dispatched per cycle
    d_lower_frac: float = 0.25         # d_l = frac * d/K
    d_upper_frac: float = 3.0          # d_u = frac * d/K
    lr: float = 0.1
    scheme: str = "kkt_sai"
    aggregation: str = "staleness"     # staleness | fedavg
    staleness_gamma: float = 1.0


def local_train_stacked(stacked, x, y, mask, tau, lr, *, max_tau: int, loss_fn):
    """Run tau_k local GD updates on each of K learners, each from its OWN
    params (leading K axis on every leaf), with gradients from autograd.

    x: (K, d_max, F); y, mask: (K, d_max); tau: (K,) int.
    Steps at ``i >= tau_k`` leave learner k untouched (the reference's
    per-learner ``lax.cond``). Returns stacked per-learner params.
    """
    grad = torch.func.vmap(torch.func.grad(
        lambda p, xk, yk, mk: loss_fn(p, {"x": xk, "y": yk, "mask": mk})
    ))
    p = stacked
    for i in range(max_tau):
        g = grad(p, x, y, mask)
        live = i < tau
        p = [
            {name: torch.where(live.reshape((-1,) + (1,) * (leaf.dim() - 1)),
                               leaf - lr * g[l][name], leaf)
             for name, leaf in layer.items()}
            for l, layer in enumerate(p)
        ]
    return p


def _broadcast(params, k: int):
    """Every leaf viewed with a leading K learner axis (no copy)."""
    return [{name: leaf.expand((k,) + leaf.shape) for name, leaf in layer.items()}
            for layer in params]


def local_train(global_params, x, y, mask, tau, lr, *, max_tau: int, loss_fn):
    """``local_train_stacked`` with every learner starting from the same
    global model (the paper's cycle-gated dispatch)."""
    return local_train_stacked(
        _broadcast(global_params, x.shape[0]), x, y, mask, tau, lr,
        max_tau=max_tau, loss_fn=loss_fn,
    )


def _stage_shards(shards: "list[Dataset]", d_max: int, feat: int):
    """Zero-pad per-learner shards into (K, d_max, ...) host arrays with a
    validity mask — shared by the eager per-cycle path and the fused
    pre-staging so their padding semantics cannot diverge."""
    k = len(shards)
    x = np.zeros((k, d_max, feat), np.float32)
    y = np.zeros((k, d_max), np.int32)
    m = np.zeros((k, d_max), np.float32)
    for i, sh in enumerate(shards):
        n = sh.size
        x[i, :n], y[i, :n], m[i, :n] = sh.x, sh.y, 1.0
    return x, y, m


class Orchestrator:
    """Runs the global cycles on the device that holds ``init_params``."""

    def __init__(
        self,
        mel: MELConfig,
        problem: AllocationProblem,
        loss_fn,
        init_params,
        *,
        seed: int = 0,
        drift=None,
    ):
        if drift is not None:
            raise NotImplementedError(f"capacity drift {_LATER}")
        self.mel = mel
        self.problem = problem
        self.loss_fn = loss_fn
        self.params = init_params
        self.device = init_params[0]["w"].device
        self.rng = np.random.default_rng(seed)
        self.allocation = _solver(mel.scheme)(problem)

    def _weights(self, tau, d) -> torch.Tensor:
        if self.mel.aggregation == "staleness":
            w = staleness_weights(tau, d, gamma=self.mel.staleness_gamma)
        else:
            w = fedavg_weights(d)
        return torch.as_tensor(w, dtype=torch.float32, device=self.device)

    def _record(self, tau, d) -> dict:
        return {
            "max_staleness": max_staleness(tau),
            "avg_staleness": avg_staleness(tau),
            "tau": tau.copy(),
            "d": d.copy(),
            "wall_clock_s": self.mel.T,
        }

    # -- one global cycle ---------------------------------------------------
    def run_cycle(self, shards: list[Dataset]) -> dict:
        alloc = self.allocation
        tau = np.asarray(alloc.tau)
        d = np.asarray(alloc.d)
        x, y, m = _stage_shards(shards, int(d.max()), shards[0].x.shape[1])
        dev = self.device
        locals_ = local_train(
            self.params, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
            torch.from_numpy(m).to(dev), torch.as_tensor(tau, device=dev),
            self.mel.lr, max_tau=max(int(tau.max()), 1), loss_fn=self.loss_fn,
        )
        self.params = aggregate(locals_, self._weights(tau, d))
        return self._record(tau, d)

    # -- full run -------------------------------------------------------------
    def run(
        self,
        train: Dataset,
        cycles: int,
        *,
        eval_fn=None,
        reallocate: bool = False,
        fused: bool = False,
        eval_batch=None,
    ) -> list[dict]:
        """Eager run (``fused=True`` routes to ``run_fused``). ``eval_fn``
        maps the params to a scalar, read after every cycle."""
        if fused:
            return self.run_fused(train, cycles, eval_fn=eval_fn,
                                  eval_batch=eval_batch, reallocate=reallocate)
        if reallocate:
            raise NotImplementedError(f"per-cycle reallocation {_LATER}")
        part = FederatedPartitioner(train, seed=int(self.rng.integers(2**31)))
        history = []
        for c in range(cycles):
            rec = self.run_cycle(part.draw(self.allocation.d))
            rec["cycle"] = c
            rec["elapsed_s"] = (c + 1) * self.mel.T
            if eval_fn is not None:
                rec["accuracy"] = float(eval_fn(self.params))
            history.append(rec)
        return history

    # -- fused path -----------------------------------------------------------
    def run_fused(
        self,
        train: Dataset,
        cycles: int,
        *,
        eval_fn=None,
        eval_batch=None,
        reallocate: bool = False,
    ) -> list[dict]:
        """Twin of ``run`` through ``ops.train_agg_step``: the same shard
        draws and allocation, every cycle's shards staged on the device up
        front, one train+aggregate call a cycle.

        eval_fn : optional ``(params, x, y) -> scalar`` (e.g.
            ``mlp.accuracy``), evaluated each cycle on ``eval_batch``.
        eval_batch : ``(x, y)`` arrays or tensors; required with ``eval_fn``.

        Returns one history dict per cycle, the rows ``run`` produces.
        """
        if reallocate:
            raise NotImplementedError(f"per-cycle reallocation {_LATER}")
        if self.loss_fn is not mlp.loss:
            raise ValueError("the fused path trains mlp.loss only; use run() "
                             "for another loss function")
        if eval_fn is not None and eval_batch is None:
            raise ValueError("run_fused needs eval_batch=(x, y) with eval_fn")
        alloc = self.allocation
        tau = np.asarray(alloc.tau)
        d = np.asarray(alloc.d)
        k = len(d)
        d_max = int(d.max())
        feat = train.x.shape[1]
        dev = self.device

        # identical shard sequence to the eager path (same rng consumption)
        part = FederatedPartitioner(train, seed=int(self.rng.integers(2**31)))
        xs = np.zeros((cycles, k, d_max, feat), np.float32)
        ys = np.zeros((cycles, k, d_max), np.int32)
        ms = np.zeros((cycles, k, d_max), np.float32)
        for c in range(cycles):
            xs[c], ys[c], ms[c] = _stage_shards(part.draw(d), d_max, feat)
        xs, ys, ms = (torch.from_numpy(a).to(dev) for a in (xs, ys, ms))
        tau_t = torch.as_tensor(tau, dtype=torch.int32, device=dev)
        w = self._weights(tau, d)
        if eval_fn is not None:
            ex, ey = (torch.as_tensor(a, device=dev) for a in eval_batch)

        max_tau = max(int(tau.max()), 1)
        accs = []
        for c in range(cycles):
            self.params = ops.train_agg_step(
                _broadcast(self.params, k), xs[c], ys[c], ms[c], tau_t, w,
                self.mel.lr, max_tau=max_tau,
            )
            if eval_fn is not None:
                accs.append(eval_fn(self.params, ex, ey))

        history = []
        for c in range(cycles):
            rec = self._record(tau, d)
            rec["cycle"] = c
            rec["elapsed_s"] = (c + 1) * self.mel.T
            if eval_fn is not None:
                rec["accuracy"] = float(accs[c])
            history.append(rec)
        return history
