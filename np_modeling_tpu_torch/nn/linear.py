"""Linear, Dense, LayerNorm, RMSNorm and Dropout modules.

Counterpart of np_modeling_tpu/nn/linear.py, with the same parameter names:
Linear ``w`` [in, out] and ``b`` [out]; Dense wraps a Linear named
``linear``; LayerNorm ``gamma``/``beta``; RMSNorm ``gamma``. Parameters are allocated at
construction and filled by ``init(generator)`` (or loaded, see
``utils.convert``). ``forward`` takes JAX's ``training`` and ``rngs``, which
only Dropout reads, so any of them can sit in a ``Sequential``.

A Linear can hold a weight-only int8 weight (JAX :42-48, the leaf
``{"int8", "scale"}`` of ``ops.quantize_params_int8``): ``load_int8_``
puts an ``Int8Weight`` at ``w``, whose buffers ``int8`` [in, out] and
``scale`` [1, out] sit under the JAX paths (``...linear.w.int8``), and
``forward`` then runs ``ops.int8_matmul``. That op has no backward, so such a
Linear serves inference only.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from np_modeling_tpu_torch import ops, rng
from np_modeling_tpu_torch.nn import initializers
from np_modeling_tpu_torch.nn.module import maybe_cast


def _param(shape, device):
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device))


class Int8Weight(nn.Module):
    """A weight-only int8 weight: ``int8`` [in, out] and per-output-column
    fp32 ``scale`` [1, out], as buffers (nothing here trains)."""

    def __init__(self, values: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("int8", values)
        self.register_buffer("scale", scale)


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

    @torch.no_grad()
    def load_int8_(self, values, scale):
        """Replace the weight by int8 ``values`` [in, out] and fp32
        ``scale`` [1, out] (numpy arrays or tensors), on the weight's
        device."""
        shape, device = tuple(self.w.shape), self.w.device
        values = torch.as_tensor(values).to(device)
        scale = torch.as_tensor(scale).to(device, torch.float32)
        if values.dtype != torch.int8 or tuple(values.shape) != shape \
                or tuple(scale.shape) != (1, shape[1]):
            raise ValueError(f"int8 weight {values.dtype} "
                             f"{tuple(values.shape)}, scale "
                             f"{tuple(scale.shape)}: want int8 {shape} and "
                             f"[1, {shape[1]}]")
        del self.w
        self.w = Int8Weight(values.contiguous(), scale.contiguous())
        return self

    def forward(self, x, training: bool = False, rngs=None):
        del training, rngs
        if isinstance(self.w, Int8Weight):
            if torch.is_grad_enabled() and (
                    x.requires_grad or (self.b is not None
                                        and self.b.requires_grad)):
                raise RuntimeError(
                    "a Linear with an int8 weight serves inference only "
                    "(ops.int8_matmul has no backward): call it under "
                    "torch.no_grad()")
            return ops.int8_matmul(maybe_cast(x, self.dtype), self.w.int8,
                                   self.w.scale, self.b,
                                   out_dtype=self.dtype or x.dtype)
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

    def forward(self, x, training: bool = False, rngs=None):
        del training, rngs
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

    def forward(self, x, training: bool = False, rngs=None):
        del training, rngs
        return ops.layer_norm(x, self.gamma, self.beta, self.epsilon)


class RMSNorm(nn.Module):
    """Last-axis RMSNorm (JAX :159-171). ``offset`` (Gemma): the gain is
    ``gamma + 1`` and ``gamma`` starts at 0."""

    def __init__(self, features: int, epsilon: float = 1e-6,
                 offset: bool = False, device=None):
        super().__init__()
        self.epsilon, self.offset = epsilon, offset
        self.gamma = _param((features,), device)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        init = initializers.zeros if self.offset else initializers.ones
        self.gamma.copy_(init(generator, self.gamma.shape))
        return self

    def forward(self, x, training: bool = False, rngs=None):
        del training, rngs
        g = self.gamma + 1.0 if self.offset else self.gamma
        return ops.rms_norm(x, g, self.epsilon)


class Dropout(nn.Module):
    """Inverted dropout (JAX :113-130). Rate 0, or ``training=False``, is the
    identity; in training the stream ``rngs[rng_name]`` (a CPU generator or
    an integer seed) with ``salt`` folded in seeds ``ops.dropout``."""

    def __init__(self, rate: float, rng_name: str = "dropout"):
        super().__init__()
        self.rate, self.rng_name = rate, rng_name

    def init(self, generator: torch.Generator):
        del generator        # no parameters
        return self

    def forward(self, x, training: bool = False, rngs=None, salt: int = 0):
        if not training or self.rate == 0.0:
            return x
        if rngs is None or self.rng_name not in rngs:
            raise ValueError(
                f"Dropout needs rngs={{'{self.rng_name}': generator or seed}}"
                " in training")
        seed = rng.fold_seed(rng.seed_of(rngs[self.rng_name]), salt)
        return ops.dropout(x, seed, self.rate, training=True)
