"""Optimizers as gradient transformations over named parameters.

Counterpart of np_modeling_tpu/training/optimizers.py (:23-128, :346-376): an
``Optimizer`` is ``(init, update)`` with ``update(grads, state, params) ->
(updates, state)``; here the pytrees are ``dict[str, Tensor]`` keyed by
parameter name (``dict(model.named_parameters())`` and the matching
gradients). Learning rates are a float or a schedule ``count -> lr``, read
at the count before the step's increment. Moments and the step count live
on the parameters' device, so an update launches no host sync.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]   # (grads, state, params) -> (updates, state)


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """Adds each update to its parameter IN PLACE (under ``torch.no_grad``,
    so ``nn.Parameter``s stay leaves of the next step's graph) and returns
    ``params``. JAX's ``apply_updates`` returns new arrays; the values are
    the same, ``(p + u)`` in p's dtype."""
    for name, p in params.items():
        p.add_(updates[name].to(p.dtype))
    return params


def _lr_at(learning_rate, count):
    return learning_rate(count) if callable(learning_rate) else learning_rate


def _count0(params):
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(learning_rate) -> Optimizer:
    """``w -= lr * g``; lr a float or a schedule."""

    def init(params):
        return _count0(params)

    def update(grads, state, params=None):
        del params
        lr = _lr_at(learning_rate, state)
        return {k: -lr * g for k, g in grads.items()}, state + 1

    return Optimizer(init, update)


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: dict
    nu: dict


def adam(learning_rate, beta1: float = 0.9, beta2: float = 0.999,
         epsilon: float = 1e-8, reference_epsilon: bool = False) -> Optimizer:
    """Bias-corrected Adam; lr a float or a schedule.

    ``reference_epsilon=True`` puts epsilon inside the root,
    ``m_hat / sqrt(v_hat + eps)`` (the reference framework's form); False
    is the canonical ``m_hat / (sqrt(v_hat) + eps)``. Bias correction uses
    the count after the increment; a schedule reads the count before it.
    """

    def init(params):
        return AdamState(_count0(params),
                         {k: torch.zeros_like(p) for k, p in params.items()},
                         {k: torch.zeros_like(p) for k, p in params.items()})

    def update(grads, state, params=None):
        del params
        count = state.count + 1
        t = count.float()
        mu = {k: beta1 * state.mu[k] + (1 - beta1) * g
              for k, g in grads.items()}
        nu = {k: beta2 * state.nu[k] + (1 - beta2) * g.square()
              for k, g in grads.items()}
        bc1 = 1 - beta1 ** t
        bc2 = 1 - beta2 ** t
        lr = _lr_at(learning_rate, state.count)

        def u(m, v):
            vhat = v / bc2
            denom = (torch.sqrt(vhat + epsilon) if reference_epsilon
                     else torch.sqrt(vhat) + epsilon)
            return -lr * (m / bc1) / denom

        updates = {k: u(mu[k], nu[k]) for k in grads}
        return updates, AdamState(count, mu, nu)

    return Optimizer(init, update)


def adamw(learning_rate, beta1: float = 0.9, beta2: float = 0.999,
          epsilon: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    """Adam with decoupled weight decay (JAX :116-128): the update is
    ``adam_update - lr * weight_decay * p`` with the pre-update ``p`` and
    the lr at the count before the increment, for every parameter (biases
    and norms included, as in JAX)."""
    base = adam(learning_rate, beta1, beta2, epsilon)

    def update(grads, state, params):
        lr = _lr_at(learning_rate, state.count)
        updates, state2 = base.update(grads, state, params)
        return ({k: u - lr * weight_decay * params[k]
                 for k, u in updates.items()}, state2)

    return Optimizer(base.init, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """Scales every gradient by ``min(1, max_norm / max(norm, 1e-12))``,
    ``norm = sqrt(sum over tensors of sum(g^2))`` in fp32 (JAX :346-360);
    the scale stays a device tensor."""

    def init(params):
        del params
        return ()

    def update(grads, state, params=None):
        del params
        norm = torch.stack([g.float().square().sum()
                            for g in grads.values()]).sum().sqrt()
        # A true division (``scalar / tensor`` would multiply by a reciprocal).
        scale = torch.clamp(torch.full_like(norm, max_norm)
                            / torch.clamp(norm, min=1e-12), max=1.0)
        return {k: g * scale for k, g in grads.items()}, state

    return Optimizer(init, update)


def chain(*transforms: Optimizer) -> Optimizer:
    """Compose transforms left to right, each one's output feeding the next
    (JAX :363-376)."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s2 = t.update(grads, s, params)
            new_state.append(s2)
        return grads, tuple(new_state)

    return Optimizer(init, update)
