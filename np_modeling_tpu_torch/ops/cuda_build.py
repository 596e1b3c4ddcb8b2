"""Builds and loads the port's CUDA kernels (route: nvcc -> shared library
with a plain C interface -> ctypes).

Each library is built at its first use from the sources in this package's
``csrc/`` into ``build/np_modeling_tpu_torch/`` at the checkout's root (the
directory ``.gitignore`` lists), under a name keyed by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so a changed
source, header or flag builds anew and an unchanged one is loaded as it
is. A failed build or load raises; nothing falls back.
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
# Per library: the paged kernel's 72 instantiations (q and page dtypes, head
# dims, window and softcap) and the flash kernels' 204 (dtypes, head dims,
# segment ids, window and softcap) are optimized in parallel, one thread a
# CPU.
EXTRA_FLAGS = {"paged_attention": ("-split-compile=0",),
               "flash_attention": ("-split-compile=0",)}


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


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


def _target(name: str):
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(_flags(name)).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"lib{name}_{digest}.so"
    return src, path, path.with_suffix(".log")


def build(*names: str) -> dict[str, Library]:
    """Build the named libraries that are not built yet (one nvcc each, all
    started together) and load them; cached per process."""
    todo = [name for name in names if name not in _loaded]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in todo:
        src, path, log_path = _target(name)
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [_nvcc(), *_flags(name), "-o", str(tmp), str(src)],
                stdout=log, stderr=subprocess.STDOUT)
        started[name] = (proc, time.perf_counter(), tmp)
    seconds, failed = {}, []
    while len(seconds) < len(started):       # each build's own seconds
        for name, (proc, t0, tmp) in started.items():
            if name in seconds or proc.poll() is None:
                continue
            seconds[name] = time.perf_counter() - t0
            src, path, log_path = _target(name)
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name} (rc "
                              f"{proc.returncode}):\n{log_path.read_text()}")
            else:
                os.replace(tmp, path)
        time.sleep(0.05)
    if failed:
        raise KernelBuildError("\n".join(failed))
    for name in todo:
        _, path, log_path = _target(name)
        log = log_path.read_text() if log_path.exists() else ""
        _loaded[name] = Library(ctypes.CDLL(str(path)), path,
                                seconds.get(name, 0.0), log)
    return {name: _loaded[name] for name in names}


def load(name: str) -> Library:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process
    (a loaded library costs one dict lookup: wrappers call this per launch)."""
    if name in _loaded:
        return _loaded[name]
    return build(name)[name]
