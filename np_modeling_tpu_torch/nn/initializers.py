"""Weight initializers drawn from a ``torch.Generator``.

Counterpart of np_modeling_tpu/nn/initializers.py: the same distributions
(the numbers differ, since the two frameworks' generators do). Each draws on
the generator's device and returns the tensor on ``device``.
"""

from __future__ import annotations

import math

import torch


def _empty(generator, shape):
    return torch.empty(shape, dtype=torch.float32, device=generator.device)


def _fans(shape):
    """jax.nn.initializers' fans: in axis -2, out axis -1, the rest is the
    receptive field."""
    if len(shape) < 2:
        raise ValueError(f"fan-in needs >= 2 dims, got {shape}")
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def lecun_normal(generator, shape, device=None):
    """Truncated normal in [-2, 2] std, variance 1/fan_in (JAX's
    ``variance_scaling(1, "fan_in", "truncated_normal")``)."""
    fan_in, _ = _fans(shape)
    # Std of a unit normal truncated to [-2, 2].
    stddev = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = _empty(generator, shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * stddev).to(device)


def normal(generator, shape, device=None, stddev=0.02):
    t = _empty(generator, shape)
    t.normal_(0.0, stddev, generator=generator)
    return t.to(device)


def clipped_normal(generator, shape, device=None):
    """clip(N(0, 1), -1, 1): the reference framework's initializer."""
    t = _empty(generator, shape)
    t.normal_(0.0, 1.0, generator=generator)
    return t.clamp_(-1.0, 1.0).to(device)


def zeros(generator, shape, device=None):
    del generator
    return torch.zeros(shape, dtype=torch.float32, device=device)


def ones(generator, shape, device=None):
    del generator
    return torch.ones(shape, dtype=torch.float32, device=device)
