"""Compute-dtype handling (mixed precision), rng streams and Sequential.

Counterpart of np_modeling_tpu/nn/module.py. The port's modules are
``torch.nn.Module``s that own their parameters; parameters stay fp32 and
each module casts them to its compute ``dtype`` at use. ``forward`` takes
``training`` and ``rngs`` as JAX's ``apply`` does.

Rngs. JAX threads keys, ``rngs={"dropout": key}``. Here a stream is a CPU
``torch.Generator`` or a 64-bit integer seed: ``resolve_rngs`` draws one
seed from each generator (a model does this once a call, so the caller's
generator advances by one draw a step), and ``split_rngs`` folds a salt
into every stream, as JAX folds a layer index into every key. No seed is
ever read from a device tensor.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from np_modeling_tpu_torch import rng

Rngs = Optional[dict]


def maybe_cast(x, dtype):
    """Cast to a compute dtype; None (for either) keeps ``x`` as it is."""
    if x is None or dtype is None:
        return x
    return x.to(dtype)


def resolve_rngs(rngs: Rngs) -> Rngs:
    """Every stream as an integer seed (one draw from each generator)."""
    if rngs is None:
        return None
    return {k: rng.seed_of(v) for k, v in rngs.items()}


def split_rngs(rngs: Rngs, salt: int) -> Rngs:
    """Fold a salt into every rng stream (for per-layer decorrelation)."""
    if rngs is None:
        return None
    return {k: rng.fold_seed(rng.seed_of(v), salt)
            for k, v in rngs.items()}


@contextlib.contextmanager
def swapped(module: nn.Module, tensors: dict):
    """Within the scope, ``module``'s parameter ``name`` (a dotted path)
    reads ``tensors[name]``; the parameters come back on exit. A
    ``scan_layers`` GPT runs its one block over a layer's slices of the
    stacked parameters this way."""
    saved = []
    for name, t in tensors.items():
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        saved.append((owner, attr, owner._parameters[attr]))
        owner._parameters[attr] = t
    try:
        yield module
    finally:
        for owner, attr, p in reversed(saved):
            owner._parameters[attr] = p


class Sequential(nn.Module):
    """Sequence of single-input modules, registered as ``'0', '1', ...``
    (JAX's parameter keys). Each layer gets ``training`` and the rngs with
    its index folded in."""

    def __init__(self, layers):
        super().__init__()
        for i, layer in enumerate(layers):
            self.add_module(str(i), layer)

    def init(self, generator: torch.Generator):
        for layer in self.children():
            layer.init(generator)
        return self

    def forward(self, x, training: bool = False, rngs: Rngs = None):
        rngs = resolve_rngs(rngs) if training else None
        for i, layer in enumerate(self.children()):
            x = layer(x, training=training, rngs=split_rngs(rngs, i))
        return x
