"""The JAX reference package, loaded for the port's parity tests.

The reference imports ``enable_x64`` from ``jax.experimental``, which newer
jax releases no longer ship (they have ``jax.enable_x64``). This loader is a
test-side shim: where the name is missing it adds the alias while the
reference modules below are imported and again inside ``loaded()`` (the
drift's ``coefficient_path`` and ``rollout_iter`` import it when called),
and removes it on leaving either. Nothing in ``src/repro`` changes, and no
other jax name is aliased.

The modules it loads are then taken out of ``sys.modules`` again, so that
the reference's own tests import it as they would without this file (and
fail where they fail on this jax). ``loaded()`` puts them back while a
parity test runs, because some reference functions import others of its
modules when called; a test module enters it once through a module-scoped
fixture.
"""

from __future__ import annotations

import contextlib
import sys

import jax
import jax.experimental


@contextlib.contextmanager
def _enable_x64_alias():
    """``jax.experimental.enable_x64`` for the duration, where jax lacks it."""
    added = not hasattr(jax.experimental, "enable_x64")
    if added:
        jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
    try:
        yield
    finally:
        if added:
            del jax.experimental.enable_x64


_before = set(sys.modules)
with _enable_x64_alias():
    from repro import core
    from repro.core import (aggregation, availability, energy, solver_batched, solver_kkt,
                            solver_numeric, staleness, time_model)
    from repro.data import pipeline
    from repro.fed import async_engine, multimodel, orchestrator, simulation
    from repro import configs
    from repro.checkpoint import checkpoint
    from repro.launch import mesh as launch_mesh
    from repro.launch import steps as launch_steps
    from repro.models import encdec
    from repro.optim import optimizers, schedules
    from repro.kernels import flash_attention as kernels_flash_attention
    from repro.kernels import mamba_scan as kernels_mamba_scan
    from repro.kernels import ops as kernels_ops
    from repro.kernels import ref as kernels_ref
    from repro.kernels import swiglu as kernels_swiglu
    from repro.kernels import waterfill as kernels_waterfill
    from repro.kernels import wkv6 as kernels_wkv6
    from repro.models import (attention, decoder, ffn, layers, mamba, mlp, model, params,
                              rwkv6)

__all__ = ["aggregation", "async_engine", "attention", "availability", "checkpoint", "configs",
           "core", "decoder", "encdec", "energy", "ffn", "kernels_flash_attention", "kernels_mamba_scan",
           "kernels_ops", "kernels_ref", "kernels_swiglu", "kernels_waterfill",
           "kernels_wkv6", "launch_mesh", "launch_steps", "layers", "loaded", "mamba", "mlp",
           "model", "multimodel", "optimizers", "orchestrator", "params", "pipeline", "rwkv6",
           "schedules", "simulation", "solver_batched", "solver_kkt", "solver_numeric",
           "staleness", "time_model"]


def _is_reference(name: str) -> bool:
    return name.split(".")[0] == "repro"


_modules = {name: sys.modules[name] for name in set(sys.modules) - _before
            if _is_reference(name)}


def _bind() -> None:
    sys.modules.update(_modules)
    for name, module in _modules.items():
        parent, _, child = name.rpartition(".")
        if parent and parent not in _modules and parent in sys.modules:
            setattr(sys.modules[parent], child, module)


def _unbind() -> None:
    for name, module in _modules.items():
        sys.modules.pop(name, None)
        parent, _, child = name.rpartition(".")
        if (parent and parent not in _modules
                and getattr(sys.modules.get(parent), child, None) is module):
            delattr(sys.modules[parent], child)


@contextlib.contextmanager
def loaded():
    """The reference's modules in ``sys.modules``, and the ``enable_x64``
    alias, for the duration; any of its modules first imported inside are
    kept with them and taken out too."""
    before = set(sys.modules)
    _bind()
    try:
        with _enable_x64_alias():
            yield
    finally:
        _modules.update({name: sys.modules[name] for name in set(sys.modules) - before
                         if _is_reference(name)})
        _unbind()


_unbind()
