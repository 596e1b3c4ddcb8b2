"""Linear, Dense and LayerNorm modules.

Counterpart of np_modeling_tpu/nn/linear.py, with the same parameter names:
Linear ``w`` [in, out] and ``b`` [out]; Dense wraps a Linear named
``linear``; LayerNorm ``gamma``/``beta``. Parameters are allocated at
construction and filled by ``init(generator)`` (or loaded, see
``utils.convert``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn import initializers
from np_modeling_tpu_torch.nn.module import maybe_cast


def _param(shape, device):
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device))


class Linear(nn.Module):
    """Affine layer. ``dtype`` is the compute dtype: params stay fp32 and
    are cast with the input for the product."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.w = _param((in_features, features), device)
        self.b = _param((features,), device) if use_bias else None

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.w.copy_(initializers.lecun_normal(generator, self.w.shape))
        if self.b is not None:
            self.b.copy_(initializers.zeros(generator, self.b.shape))
        return self

    def forward(self, x):
        return ops.linear(maybe_cast(x, self.dtype),
                          maybe_cast(self.w, self.dtype),
                          maybe_cast(self.b, self.dtype))


class Dense(nn.Module):
    """Linear + activation (``"relu"`` | ``"gelu"``)."""

    def __init__(self, in_features: int, features: int,
                 activation: Any = "relu", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.linear = Linear(in_features, features, use_bias, dtype, device)
        self._act = ops.get_activation(activation)

    def init(self, generator: torch.Generator):
        self.linear.init(generator)
        return self

    def forward(self, x):
        return self._act(self.linear(x))


class LayerNorm(nn.Module):
    """Last-axis LayerNorm, fp32 statistics, output in the input's dtype."""

    def __init__(self, features: int, epsilon: float = 1e-3, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = _param((features,), device)
        self.beta = _param((features,), device)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.gamma.copy_(initializers.ones(generator, self.gamma.shape))
        self.beta.copy_(initializers.zeros(generator, self.beta.shape))
        return self

    def forward(self, x):
        return ops.layer_norm(x, self.gamma, self.beta, self.epsilon)
