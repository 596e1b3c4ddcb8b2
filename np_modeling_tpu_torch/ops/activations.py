"""Activations (forward only; the serving slice is inference-only).

Counterpart of np_modeling_tpu/ops/activations.py. ``gelu`` is the tanh
approximation (HF ``gelu_new``), computed in the input's dtype as the JAX
op does.
"""

from __future__ import annotations

import torch

_GELU_C = 0.7978845608028654  # sqrt(2/pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    inner = _GELU_C * (x + 0.044715 * x ** 3)
    return 0.5 * x * (1.0 + torch.tanh(inner))


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


_ACTIVATIONS = {"gelu": gelu, "relu": relu}


def get_activation(name):
    """Activation by name (``"relu"`` | ``"gelu"``) or a callable."""
    if callable(name):
        return name
    if name not in _ACTIVATIONS:
        raise NotImplementedError(
            f"activation {name!r} is not ported yet (have "
            f"{sorted(_ACTIVATIONS)})")
    return _ACTIVATIONS[name]
