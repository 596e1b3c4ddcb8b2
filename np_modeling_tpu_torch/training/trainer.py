"""The training loop: one train step over the model's parameters and an
optimizer state.

Counterpart of np_modeling_tpu/training/trainer.py (:29-152). JAX jits the
step with its parameters and optimizer state donated (``donate_argnums=(0,
1)``), so that XLA updates them in place. Here the step runs eagerly: the
parameters are always updated in place (``apply_updates``), and with
``donate=True`` (JAX's default) so is the optimizer state, through the
optimizer's donated ``update_``, which also turns the gradients into the
updates in place: a step then allocates nothing the size of the model
beyond the gradients. ``apply_fn(x, training=True, rngs={"dropout": rng})`` is the
model's forward (a module's own parameters are its state) and ``params`` is
``dict(model.named_parameters())``. An rng is a CPU ``torch.Generator`` or
an integer seed (``np_modeling_tpu_torch.rng``); losses stay device tensors.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn.module import Sequential
from np_modeling_tpu_torch.rng import fold_seed, seed_of
from np_modeling_tpu_torch.training.optimizers import (Optimizer,
                                                       apply_updates)

LOSSES = {
    "mse": ops.mse,
    "cross_entropy": ops.cross_entropy_probs,
    "softmax_cross_entropy":
        lambda y, t: ops.softmax_cross_entropy(y, t).mean(),
}


def resolve_loss(loss):
    if callable(loss):
        return loss
    return LOSSES[loss]


def make_train_step(apply_fn: Callable, loss_fn, optimizer: Optimizer,
                    donate: bool = True, grad_accum: int = 1):
    """``step(params, opt_state, x, targets, rng) -> (params, opt_state,
    loss)``. ``donate=True`` consumes ``opt_state``, as JAX's donated
    buffer: the returned state is the same object, its tensors updated in
    place, and the old values are gone; ``donate=False`` leaves it as it
    was and returns a new one. ``grad_accum > 1`` splits the batch into that
    many microbatches, folds the microbatch index into the rng (JAX :73),
    sums their gradients and divides by ``grad_accum`` before the one
    optimizer update."""
    loss_fn = resolve_loss(loss_fn)
    update = optimizer.update_ if donate else optimizer.update

    def step(params, opt_state, x, targets, rng):
        for p in params.values():
            p.grad = None
        if grad_accum == 1:
            loss = loss_fn(apply_fn(x, training=True, rngs={"dropout": rng}),
                           targets)
            loss.backward()
            grads = {k: p.grad for k, p in params.items()}
        else:
            b = x.shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} does not split into {grad_accum} "
                                 "microbatches")
            seed = seed_of(rng)
            loss = 0.0
            for i, (xi, ti) in enumerate(zip(x.chunk(grad_accum),
                                             targets.chunk(grad_accum))):
                li = loss_fn(apply_fn(xi, training=True,
                                      rngs={"dropout": fold_seed(seed, i)}),
                             ti)
                li.backward()                  # gradients add up in p.grad
                loss = loss + li.detach()
            loss = loss / grad_accum
            grads = {k: p.grad.div_(grad_accum) for k, p in params.items()}
        updates, opt_state = update(grads, opt_state, params)
        apply_updates(params, updates)
        for p in params.values():       # the updates' memory goes now
            p.grad = None
        return params, opt_state, loss.detach()

    return step


def make_eval_step(apply_fn: Callable, loss_fn):
    loss_fn = resolve_loss(loss_fn)

    @torch.no_grad()
    def step(params, x, targets):
        del params
        return loss_fn(apply_fn(x, training=False), targets)

    return step


class Trainer:
    """Convenience wrapper with the JAX Trainer's surface."""

    def __init__(self, model: nn.Module | Sequence[nn.Module], loss="mse",
                 optimizer: Optimizer | None = None, seed: int = 0):
        if not isinstance(model, nn.Module):
            model = Sequential(model)
        self.model = model
        self.loss = resolve_loss(loss)
        self.optimizer = optimizer
        self._gen = torch.Generator().manual_seed(seed)
        self._train_step = None
        self._eval_step = None

    def init(self, x=None) -> dict:
        """Fills the model's parameters from the trainer's generator and
        returns them by name (``x`` is accepted for JAX's signature: the
        port's modules know their shapes)."""
        del x
        self.model.init(self._gen)
        return dict(self.model.named_parameters())

    def fit(self, params, inputs, targets, steps: int,
            optimizer: Optimizer | None = None, log_every: int = 0,
            opt_state=None):
        """``steps`` full-batch steps of the donated step; returns (params,
        opt_state, losses). Pass ``opt_state`` back in to continue training
        (it is consumed: the returned state is the one to keep)."""
        opt = optimizer or self.optimizer
        if opt is None:
            raise ValueError("provide an optimizer")
        if self._train_step is None:
            self._train_step = make_train_step(self.model, self.loss, opt)
        if opt_state is None:
            opt_state = opt.init(params)
        losses = []
        for i in range(steps):
            params, opt_state, loss = self._train_step(
                params, opt_state, inputs, targets, seed_of(self._gen))
            losses.append(loss)
            if log_every and i % log_every == 0:
                print(f"Step: {i}  Loss: {float(loss):.6f}")
        return params, opt_state, torch.stack(losses)

    def evaluate(self, params, inputs, targets):
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.model, self.loss)
        return self._eval_step(params, inputs, targets)
