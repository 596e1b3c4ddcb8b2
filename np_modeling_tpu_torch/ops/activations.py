"""Activations with hand-written backwards.

Counterpart of np_modeling_tpu/ops/activations.py. ``relu`` passes the
gradient where x >= 0, x == 0 included (the reference framework's
convention, JAX :30-32); ``torch.relu``'s own backward does not, so relu is
a Function here. ``gelu`` is the tanh approximation (HF ``gelu_new``),
computed in the input's dtype as the JAX op does.
"""

from __future__ import annotations

import torch

_GELU_C = 0.7978845608028654  # sqrt(2/pi)


class _Relu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, 0.0)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0.0, dy, 0.0)


class _Gelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        inner = _GELU_C * (x + 0.044715 * x ** 3)
        return 0.5 * x * (1.0 + torch.tanh(inner))

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        inner = _GELU_C * (x + 0.044715 * x ** 3)
        t = torch.tanh(inner)
        sech2 = 1.0 - t * t
        dinner = _GELU_C * (1.0 + 3 * 0.044715 * x * x)
        return dy * (0.5 * (1.0 + t) + 0.5 * x * sech2 * dinner)


def relu(x: torch.Tensor) -> torch.Tensor:
    return _Relu.apply(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return _Gelu.apply(x)


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
