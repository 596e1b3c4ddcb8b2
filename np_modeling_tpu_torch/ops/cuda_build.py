"""Builds and loads the port's CUDA kernels (route: nvcc -> shared library
with a plain C interface -> ctypes).

Each library is built at its first use from the sources in this package's
``csrc/`` into ``build/np_modeling_tpu_torch/`` at the checkout's root (the
directory ``.gitignore`` lists), under a name keyed by a hash of the
sources and flags, so a changed source or flag builds anew and an unchanged
one is loaded as it is. A failed build or load raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "np_modeling_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    pass


class Library:
    """A loaded kernel library: ``lib`` (ctypes), the build's seconds (0 when
    loaded from an earlier build) and the compiler's register/spill report."""

    def __init__(self, lib, path, build_seconds, log):
        self.lib, self.path = lib, path
        self.build_seconds, self.log = build_seconds, log


_loaded: dict[str, Library] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise KernelBuildError("no CUDA toolkit found (CUDA_HOME unset and "
                               "no nvcc on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load(name: str) -> Library:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"lib{name}_{digest}.so"
    log_path = path.with_suffix(".log")
    seconds = 0.0
    if not path.exists():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log_path.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed on {src.name} (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    log = log_path.read_text() if log_path.exists() else ""
    _loaded[name] = Library(lib, path, seconds, log)
    return _loaded[name]
