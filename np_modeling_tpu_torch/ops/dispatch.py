"""Backend dispatch: hand-written CUDA kernel vs. plain PyTorch version.

The rule is by device, with no environment variable and no fallback: an op
whose inputs lie on a CUDA device launches its kernel (and raises if the
kernel cannot take them); an op whose inputs lie on the CPU runs the plain
PyTorch version. ``force_plain()`` runs the plain version on CUDA tensors
too, in a scope — ``chip_smoke.py`` and the card-only tests use it to hold a
kernel against its plain version on the same inputs.

``force_kernels()`` is the counterpart of the JAX package's
``force_pallas(True)``: in its scope, an op whose default on the card is a
library call (as XLA is JAX's default there) takes its kernel on CUDA
tensors. Today that op is ``ops.matmul`` (K11); every other op launches its
kernel on the card anyway. CPU tensors still run the plain versions, and
``force_plain()`` inside ``force_kernels()`` wins, as ``force_pallas(False)``
would.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def plain_forced() -> bool:
    return bool(getattr(_state, "force_plain", False))


@contextlib.contextmanager
def force_plain():
    """Run every op's plain PyTorch version in this scope, on any device."""
    prev = plain_forced()
    _state.force_plain = True
    try:
        yield
    finally:
        _state.force_plain = prev


def kernels_forced() -> bool:
    return bool(getattr(_state, "force_kernels", False))


@contextlib.contextmanager
def force_kernels():
    """Take the kernel where the default on the card is a library call, in
    this scope (CUDA tensors only; ``force_plain()`` still wins)."""
    prev = kernels_forced()
    _state.force_kernels = True
    try:
        yield
    finally:
        _state.force_kernels = prev


def scopes() -> tuple:
    """The scopes in force on this thread: (kernels forced, plain forced)."""
    return kernels_forced(), plain_forced()


@contextlib.contextmanager
def within(saved: tuple):
    """Re-enter ``scopes()`` as saved. Autograd runs the backward of CUDA
    tensors on a thread of its own, which does not see the scopes of the
    thread that ran the forward: a Function whose backward dispatches saves
    them in its forward and runs its backward within them."""
    prev = scopes()
    _state.force_kernels, _state.force_plain = saved
    try:
        yield
    finally:
        _state.force_kernels, _state.force_plain = prev


def use_kernel(x: torch.Tensor) -> bool:
    """True if an op on ``x`` must launch its CUDA kernel."""
    if x.device.type == "cpu" or plain_forced():
        return False
    if x.device.type != "cuda":
        raise NotImplementedError(
            f"no kernel for device {x.device}; the port runs on CUDA "
            "(kernels) or on the CPU (plain versions)")
    return True
