"""Builds the CUDA sources in ``repro_torch/csrc`` with ``nvcc`` into shared
libraries with a plain C interface, loaded through ``ctypes``.

The first use of any kernel compiles every source that is not built yet,
one ``nvcc`` process per source, all started together, into
``<repo>/build/repro_torch/``. A library's file name carries a hash of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. Nothing is compiled or loaded when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

__all__ = ["SOURCES", "build_all", "check", "library"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("accum_flush", "fed_agg", "flash_attention", "mamba_scan", "swiglu", "train_step",
           "waterfill", "wkv6")
# no --use_fast_math: expf/logf and the rounding of every product stay IEEE
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every source not built yet, all at once; returns each
    compiled source's compiler output (registers, shared memory, spills)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in SOURCES:
        src, lib = _target(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs[name] = (proc, tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {name}.cu\n{logs[name]}" for name in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        _, lib = _target(name)
        if not lib.exists():
            build_all()
        _loaded[name] = ctypes.CDLL(str(lib))
    return _loaded[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if code != 0:
        msg = ctypes.string_at(lib.kernel_error_string(code)).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
