"""Backend dispatch: hand-written CUDA kernel vs. plain PyTorch version.

The rule is by device, with no environment variable and no fallback: an op
whose inputs lie on a CUDA device launches its kernel (and raises if the
kernel cannot take them); an op whose inputs lie on the CPU runs the plain
PyTorch version. ``force_plain()`` runs the plain version on CUDA tensors
too, in a scope — ``chip_smoke.py`` and the card-only tests use it to hold a
kernel against its plain version on the same inputs.
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


def use_kernel(x: torch.Tensor) -> bool:
    """True if an op on ``x`` must launch its CUDA kernel."""
    if x.device.type == "cpu" or plain_forced():
        return False
    if x.device.type != "cuda":
        raise NotImplementedError(
            f"no kernel for device {x.device}; the port runs on CUDA "
            "(kernels) or on the CPU (plain versions)")
    return True
