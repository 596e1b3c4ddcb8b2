"""Activations with hand-written backwards.

Counterpart of np_modeling_tpu/ops/activations.py. ``relu`` passes the
gradient where x >= 0, x == 0 included (the reference framework's
convention, JAX :30-32); ``torch.relu``'s own backward does not, so relu is
a Function here. ``gelu`` is the tanh approximation (HF ``gelu_new``),
computed in the input's dtype as the JAX op does. ``gelu_exact`` is the
erf form ``x Phi(x)`` (HF ``hidden_act="gelu"``: BERT, GPT-NeoX; JAX
:96-122), its backward ``Phi(x) + x phi(x)`` written by hand as JAX's.
``silu`` is ``x * sigmoid(x)`` (JAX :126-140), the swiglu FFN's gate.
``activation_grad`` is each of those backwards on its own, for modules whose
backward is written by hand (``nn.moe``).
"""

from __future__ import annotations

import torch

_GELU_C = 0.7978845608028654  # sqrt(2/pi)
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _relu_grad(x, dy):
    return torch.where(x >= 0.0, dy, 0.0)


def _gelu_grad(x, dy):
    inner = _GELU_C * (x + 0.044715 * x ** 3)
    t = torch.tanh(inner)
    sech2 = 1.0 - t * t
    dinner = _GELU_C * (1.0 + 3 * 0.044715 * x * x)
    return dy * (0.5 * (1.0 + t) + 0.5 * x * sech2 * dinner)


def _gelu_exact_grad(x, dy):
    cdf = 0.5 * (1.0 + torch.erf(x * _INV_SQRT2))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * x * x)
    return dy * (cdf + x * pdf)


def _silu_grad(x, dy):
    s = torch.sigmoid(x)
    return dy * (s * (1.0 + x * (1.0 - s)))


class _Relu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, 0.0)

    @staticmethod
    def backward(ctx, dy):
        return _relu_grad(*ctx.saved_tensors, dy)


class _Gelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        inner = _GELU_C * (x + 0.044715 * x ** 3)
        return 0.5 * x * (1.0 + torch.tanh(inner))

    @staticmethod
    def backward(ctx, dy):
        return _gelu_grad(*ctx.saved_tensors, dy)


class _GeluExact(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return 0.5 * x * (1.0 + torch.erf(x * _INV_SQRT2))

    @staticmethod
    def backward(ctx, dy):
        return _gelu_exact_grad(*ctx.saved_tensors, dy)


class _Silu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * torch.sigmoid(x)

    @staticmethod
    def backward(ctx, dy):
        return _silu_grad(*ctx.saved_tensors, dy)


def relu(x: torch.Tensor) -> torch.Tensor:
    return _Relu.apply(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return _Gelu.apply(x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return _GeluExact.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return _Silu.apply(x)


_ACTIVATIONS = {"gelu": gelu, "gelu_exact": gelu_exact, "relu": relu,
                "silu": silu}
_GRADS = {"gelu": _gelu_grad, "gelu_exact": _gelu_exact_grad,
          "relu": _relu_grad, "silu": _silu_grad}


def get_activation(name):
    """Activation by name (``"relu"`` | ``"gelu"`` | ``"gelu_exact"`` |
    ``"silu"``) or a callable."""
    if callable(name):
        return name
    if name not in _ACTIVATIONS:
        raise NotImplementedError(
            f"activation {name!r} is not ported yet (have "
            f"{sorted(_ACTIVATIONS)})")
    return _ACTIVATIONS[name]


def activation_grad(name: str, x: torch.Tensor,
                    dy: torch.Tensor) -> torch.Tensor:
    """The backward of activation ``name`` at its input ``x`` for the output
    gradient ``dy``: what that activation's own backward returns."""
    if name not in _GRADS:
        raise NotImplementedError(f"no hand-written backward for activation "
                                  f"{name!r} (have {sorted(_GRADS)})")
    return _GRADS[name](x, dy)
