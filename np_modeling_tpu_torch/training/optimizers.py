"""Optimizers as gradient transformations over named parameters.

Counterpart of np_modeling_tpu/training/optimizers.py: an ``Optimizer`` is
``(init, update, update_)``. ``update(grads, state, params) -> (updates,
state)`` is JAX's functional form: it returns new tensors and leaves its
arguments as they were. ``update_`` is the donated form, the counterpart of
JAX's ``jax.jit(step, donate_argnums=(0, 1))`` (trainer.py:88-89): it writes
the new state into ``state``'s own tensors and the updates into ``grads``'
own tensors, and returns those same objects, so that a step allocates
nothing the size of the model (one tensor's temporaries at a time). After a
donated call the caller's old state is gone, as a donated JAX buffer is.
Each optimizer is written once, as ``update_`` in JAX's order of operations;
``update`` runs it on copies of the gradients and the state, so the two
forms agree bit for bit.

The pytrees are ``dict[str, Tensor]`` keyed by parameter name
(``dict(model.named_parameters())`` and the matching gradients). Learning
rates are a float or a schedule ``count -> lr``, read at the count before
the step's increment. Moments and counts live on the parameters' device, so
an update never reads the device from the host.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]    # (grads, state, params) -> (updates, state)
    update_: Callable[..., tuple]   # the same, donated


def _tensors(tree):
    """The tensors of a state tree (dicts, tuples, NamedTuples), in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _clone(tree):
    """``tree`` (dicts, tuples, NamedTuples) with every tensor cloned."""
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _optimizer(init, update_) -> Optimizer:
    """The ``Optimizer`` of a donated update: its functional form runs the
    donated one on copies of the gradients and the state."""
    update_ = torch.no_grad()(update_)

    def update(grads, state, params=None):
        return update_(_clone(grads), _clone(state), params)

    return Optimizer(init, update, update_)


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

    def update_(grads, state, params=None):
        del params
        neg_lr = -_lr_at(learning_rate, state)
        for g in grads.values():
            g.mul_(neg_lr)
        return grads, state.add_(1)

    return _optimizer(init, update_)


def momentum(learning_rate: float, beta: float = 0.9) -> Optimizer:
    """Heavy ball: ``v = beta * v + g``, ``w -= lr * v`` (JAX :56-66); the
    state is the velocity dict, lr a float."""

    def init(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update_(grads, state, params=None):
        del params
        for k, g in grads.items():
            v = state[k].mul_(beta).add_(g)
            g.copy_(v).mul_(-learning_rate)
        return grads, state

    return _optimizer(init, update_)


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: dict
    nu: dict


def _adam_denom(v, bc2, epsilon, reference_epsilon):
    """``sqrt(v / bc2 + eps)`` or ``sqrt(v / bc2) + eps``, in a new tensor."""
    d = v / bc2
    return d.add_(epsilon).sqrt_() if reference_epsilon \
        else d.sqrt_().add_(epsilon)


def _adam(learning_rate, beta1, beta2, epsilon, reference_epsilon,
          weight_decay=0.0) -> Optimizer:
    """Adam, with adamw's decay folded into its loop (each tensor is read
    once; JAX :88-128's operations in their order)."""

    def init(params):
        return AdamState(_count0(params),
                         {k: torch.zeros_like(p) for k, p in params.items()},
                         {k: torch.zeros_like(p) for k, p in params.items()})

    def update_(grads, state, params=None):
        lr = _lr_at(learning_rate, state.count)
        count = state.count.add_(1)
        t = count.float()
        bc1, bc2 = 1 - beta1 ** t, 1 - beta2 ** t
        neg_lr, decay = -lr, lr * weight_decay
        for k, g in grads.items():
            m = state.mu[k].mul_(beta1).add_(g * (1 - beta1))
            v = state.nu[k].mul_(beta2).add_(g.square().mul_(1 - beta2))
            g.copy_(m).div_(bc1).mul_(neg_lr).div_(
                _adam_denom(v, bc2, epsilon, reference_epsilon))
            if weight_decay:
                g.sub_(params[k] * decay)
        return grads, state

    return _optimizer(init, update_)


def adam(learning_rate, beta1: float = 0.9, beta2: float = 0.999,
         epsilon: float = 1e-8, reference_epsilon: bool = False) -> Optimizer:
    """Bias-corrected Adam; lr a float or a schedule.

    ``reference_epsilon=True`` puts epsilon inside the root,
    ``m_hat / sqrt(v_hat + eps)`` (the reference framework's form); False
    is the canonical ``m_hat / (sqrt(v_hat) + eps)``. Bias correction uses
    the count after the increment; a schedule reads the count before it.
    """
    return _adam(learning_rate, beta1, beta2, epsilon, reference_epsilon)


def adamw(learning_rate, beta1: float = 0.9, beta2: float = 0.999,
          epsilon: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    """Adam with decoupled weight decay (JAX :116-128): the update is
    ``adam_update - lr * weight_decay * p`` with the pre-update ``p`` and
    the lr at the count before the increment, for every parameter (biases
    and norms included, as in JAX)."""
    return _adam(learning_rate, beta1, beta2, epsilon, False, weight_decay)


def _factored_dims(shape, min_dim_size_to_factor):
    """(second-largest axis, largest axis) when both are at least
    ``min_dim_size_to_factor``, ties in argsort order (JAX :145-153)."""
    if len(shape) < 2:
        return None
    sorted_dims = sorted((s, i) for i, s in enumerate(shape))
    if sorted_dims[-2][0] < min_dim_size_to_factor:
        return None
    return sorted_dims[-2][1], sorted_dims[-1][1]


def adafactor(learning_rate, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, epsilon: float = 1e-30,
              clipping_threshold: float | None = 1.0,
              multiply_by_parameter_scale: bool = True,
              epsilon_scale: float = 1e-3) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018), momentum-free, JAX :131-222: a
    parameter whose two largest axes are both at least
    ``min_dim_size_to_factor`` keeps its second moment as a row EMA and a
    column EMA (fp32); others keep it whole. The state is ``(count,
    {name: {"v_row", "v_col"} or {"v"}})``: JAX's tuple of leaves, keyed
    here by parameter name."""

    def init(params):
        factors = {}
        for k, p in params.items():
            f = _factored_dims(p.shape, min_dim_size_to_factor)
            if f is None:
                factors[k] = {"v": torch.zeros_like(p, dtype=torch.float32)}
                continue
            d1, d0 = f
            row = [s for i, s in enumerate(p.shape) if i != d0]
            col = [s for i, s in enumerate(p.shape) if i != d1]
            factors[k] = {
                "v_row": torch.zeros(row, dtype=torch.float32,
                                     device=p.device),
                "v_col": torch.zeros(col, dtype=torch.float32,
                                     device=p.device)}
        return (_count0(params), factors)

    def one(g, p, s, lr, decay):
        """A tensor's update (fp32); its factors ``s`` in place."""
        g32 = g.float()
        gsq = g32.square() + epsilon
        f = _factored_dims(g.shape, min_dim_size_to_factor)
        if f is not None:
            d1, d0 = f
            v_row = s["v_row"].mul_(decay).add_((1 - decay) * gsq.mean(d0))
            v_col = s["v_col"].mul_(decay).add_((1 - decay) * gsq.mean(d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_mean = v_row.mean(reduced_d1, keepdim=True)
            row_factor = (v_row / row_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = g32 * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        else:
            v = s["v"].mul_(decay).add_((1 - decay) * gsq)
            u = g32 * v ** -0.5
        if clipping_threshold is not None:
            rms_u = u.square().mean().sqrt()
            u = u / torch.clamp(rms_u / clipping_threshold, min=1.0)
        scale = lr
        if multiply_by_parameter_scale:
            if p is None:
                raise ValueError("adafactor(multiply_by_parameter_scale="
                                 "True) needs params in update()")
            pscale = torch.clamp(p.float().square().mean().sqrt(),
                                 min=epsilon_scale)
            scale = scale * pscale
        return -scale * u

    def update_(grads, state, params=None):
        count, factors = state
        count.add_(1)
        lr = _lr_at(learning_rate, count - 1)
        decay = 1.0 - count.float() ** (-decay_rate)
        for k, g in grads.items():
            p = params[k] if params is not None else None
            g.copy_(one(g, p, factors[k], lr, decay))
        return grads, state

    return _optimizer(init, update_)


def lion(learning_rate, beta1: float = 0.9, beta2: float = 0.99,
         weight_decay: float = 0.0) -> Optimizer:
    """Lion (Chen et al. 2023), JAX :225-258:
    ``u = -lr * (sign(b1 * m + (1 - b1) * g) + wd * p)``, then
    ``m = b2 * m + (1 - b2) * g``. State ``(count, mu)``."""

    def init(params):
        return (_count0(params),
                {k: torch.zeros_like(p) for k, p in params.items()})

    def update_(grads, state, params=None):
        if weight_decay and params is None:
            raise ValueError("lion(weight_decay>0) needs params")
        count, mu = state
        neg_lr = -_lr_at(learning_rate, count)
        for k, g in grads.items():
            u = torch.sign(beta1 * mu[k] + (1 - beta1) * g)
            if weight_decay:
                u = u + weight_decay * params[k]
            mu[k].mul_(beta2).add_(g * (1 - beta2))
            g.copy_(u.mul_(neg_lr))
        count.add_(1)
        return grads, state

    return _optimizer(init, update_)


def _newton_schulz(m, steps: int = 5):
    """Quintic Newton-Schulz orthogonalization (Muon's core, JAX :261-274):
    ``X <- aX + (b XXt + c (XXt)^2) X`` on the Frobenius-normalized matrix,
    in fp32, with plain ``torch.matmul`` (JAX computes it outside any Pallas
    kernel)."""
    a, b, c = 3.4445, -4.7750, 2.0315
    x = m.float()
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.norm(x) + 1e-7)
    for _ in range(steps):
        xxt = x @ x.T
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    return (x.T if transposed else x).to(m.dtype)


def muon(learning_rate, beta: float = 0.95, ns_steps: int = 5,
         adam_lr: float | None = None, beta1: float = 0.9,
         beta2: float = 0.999, epsilon: float = 1e-8,
         nesterov: bool = True,
         exclude: str = r".*(embedding|lm_head|pos_embed|table).*"
         ) -> Optimizer:
    """Muon (JAX :277-343): matrix parameters (ndim >= 2, flattened to
    [dim0, rest]) whose JAX path (the name with ``/`` for ``.``) does not
    match ``exclude`` get ``-lr * sqrt(max(1, rows / cols)) * NS5(momentum)``
    (Nesterov by default); the others run Adam at ``adam_lr`` (default
    ``learning_rate``). State ``(count, mu, nu)``, ``nu`` a 0-d placeholder
    for the Muon group."""
    adam_rate = adam_lr if adam_lr is not None else learning_rate
    pat = re.compile(exclude)

    def is_muon(name, p):
        return p.dim() >= 2 and not pat.match(name.replace(".", "/"))

    def init(params):
        mu = {k: torch.zeros_like(p) for k, p in params.items()}
        nu = {k: (torch.zeros((), dtype=torch.float32, device=p.device)
                  if is_muon(k, p) else torch.zeros_like(p))
              for k, p in params.items()}
        return (_count0(params), mu, nu)

    def update_(grads, state, params=None):
        del params
        count, mu, nu = state
        t = (count + 1).float()
        lr = _lr_at(learning_rate, count)
        neg_a_lr = -_lr_at(adam_rate, count)
        bc1, bc2 = 1 - beta1 ** t, 1 - beta2 ** t
        for k, g in grads.items():
            if is_muon(k, g):
                m2 = mu[k].mul_(beta).add_(g)
                eff = beta * m2 + g if nesterov else m2
                two_d = eff.reshape(eff.shape[0], -1)
                o = _newton_schulz(two_d, ns_steps).reshape(eff.shape)
                scale = math.sqrt(max(1.0, two_d.shape[0] / two_d.shape[1]))
                g.copy_(-lr * scale * o)
                continue
            m2 = mu[k].mul_(beta1).add_(g * (1 - beta1))
            v2 = nu[k].mul_(beta2).add_(g.square().mul_(1 - beta2))
            g.copy_(m2).div_(bc1).mul_(neg_a_lr).div_(
                _adam_denom(v2, bc2, epsilon, False))
        count.add_(1)
        return grads, state

    return _optimizer(init, update_)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """Scales every gradient by ``min(1, max_norm / max(norm, 1e-12))``,
    ``norm = sqrt(sum over tensors of sum(g^2))`` in fp32 (JAX :346-360);
    the scale stays a device tensor."""

    def init(params):
        del params
        return ()

    def update_(grads, state, params=None):
        del params
        norm = torch.stack([g.float().square().sum()
                            for g in grads.values()]).sum().sqrt()
        # A true division (``scalar / tensor`` would multiply by a
        # reciprocal).
        scale = torch.clamp(torch.full_like(norm, max_norm)
                            / torch.clamp(norm, min=1e-12), max=1.0)
        for g in grads.values():
            g.mul_(scale)
        return grads, state

    return _optimizer(init, update_)


def chain(*transforms: Optimizer) -> Optimizer:
    """Compose transforms left to right, each one's output feeding the next
    (JAX :363-376)."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update_(grads, state, params=None):
        for t, s in zip(transforms, state):
            grads, _ = t.update_(grads, s, params)
        return grads, state

    return _optimizer(init, update_)


def skip_nonfinite(inner: Optimizer) -> Optimizer:
    """Skips a step whose gradients hold a NaN or an Inf (JAX :379-407):
    its updates are zero and the inner state stays as it was. State
    ``(skipped_count, inner_state)``. Finiteness is one device reduction
    and the choice a ``torch.where``: no host read. The inner update runs on
    ``nan_to_num`` gradients. A copy of the inner state is kept through the
    step to restore it from (the extra peak is the inner state's size)."""

    def init(params):
        return (torch.zeros((), dtype=torch.int32,
                            device=next(iter(params.values())).device),
                inner.init(params))

    def update_(grads, state, params=None):
        skipped, inner_state = state
        finite = torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
        old = [t.clone() for t in _tensors(inner_state)]
        for g in grads.values():
            torch.nan_to_num(g, out=g)
        inner.update_(grads, inner_state, params)
        for new, was in zip(_tensors(inner_state), old, strict=True):
            new.copy_(torch.where(finite, new, was))
        for g in grads.values():
            g.masked_fill_(~finite, 0)
        skipped.add_((~finite).to(torch.int32))
        return grads, state

    return _optimizer(init, update_)


class EmaState(NamedTuple):
    count: torch.Tensor
    ema: dict


@torch.no_grad()
def update_ema_(state: EmaState, params: dict, decay: float) -> EmaState:
    """``ema_params``' update, donated: ``state``'s tensors in place."""
    for k, e in state.ema.items():
        e.mul_(decay).add_((1 - decay) * params[k])
    state.count.add_(1)
    return state


def ema_params(decay: float = 0.999, debias: bool = True):
    """Exponential moving average of the parameters (JAX :410-442): not an
    optimizer, it tracks params. Returns JAX's ``(init, update, value)``:
    ``state = init(params)``; after each step ``state = update(state,
    params)`` (or, in place, ``update_ema_(state, params, decay)``); read
    ``value(state)``, debiased by ``1 - decay ** count`` like Adam with
    ``debias``."""

    def init(params):
        return EmaState(_count0(params),
                        {k: torch.zeros_like(p) for k, p in params.items()})

    def update(state, params):
        return update_ema_(_clone(state), params, decay)

    @torch.no_grad()
    def value(state):
        if not debias:
            return state.ema
        bc = torch.clamp(1 - decay ** state.count.float(), min=1e-12)
        return {k: e / bc for k, e in state.ema.items()}

    return init, update, value
