"""LoRA: low-rank adapter fine-tuning (Hu et al. 2021).

Counterpart of np_modeling_tpu/training/lora.py. Each matched weight ``W
[in, ...out]`` gets a pair ``A [in, r]``, ``B [r, ...out]`` with ``B = 0``
at init, and the effective weight is ``W + (alpha / r) * A @ B``. An
adapter tree is ``{path: {"a": A, "b": B}}`` keyed by JAX's parameter path
(``layer_0/self_attention/wq``: the port's parameter name with ``/`` for
``.``), fp32 tensors on the model's device; ``utils.convert`` carries JAX
adapter trees across as numpy.

The port's models own their weights, so a merge returns the merged tensors
of the adapted parameters, ``{parameter name: tensor}``, and a model runs
with them inside ``nn.module.swapped``. The rank-r product has its backward
written by hand (``_LoraMerge``: dA = s dW Bᵀ, dB = s Aᵀ dW, s = alpha / r).
The fine-tune step (``make_lora_train_step``) differentiates the adapters
only: it runs ``GPT.loss`` with every base parameter detached and the
adapted ones merged, so the base gets no gradient and stays bit-unchanged.
"""

from __future__ import annotations

import copy
import math
import re

import torch

from np_modeling_tpu_torch.nn.module import swapped
from np_modeling_tpu_torch.training.optimizers import apply_updates

# Attention projections, the standard LoRA target set for transformers.
ATTENTION_TARGETS = r".*/w[qkvo]$"
# Attention and every FFN matmul (mlp dense1/dense2 and swiglu/geglu
# w_gate/w_up/w_down).
ALL_LINEAR_TARGETS = (
    r".*(/w[qkvo]|dense1/linear/w|dense2/w|swiglu/w_(gate|up|down))$")


def _path(name: str) -> str:
    return name.replace(".", "/")


def _name(path: str) -> str:
    return path.replace("/", ".")


def lora_init(generator: torch.Generator, model: torch.nn.Module, rank: int,
              match: str = ATTENTION_TARGETS) -> dict:
    """The adapter tree of every parameter whose path matches ``match``
    (>= 2-D): ``A`` drawn from ``generator`` (on the model's device) as
    N(0, 1/rank), ``B`` zeros, so the merged model first equals the base.
    Paths are taken in sorted order; the draws are torch's, not JAX's."""
    pat = re.compile(match)
    leaves = sorted((_path(n), p) for n, p in model.named_parameters()
                    if pat.match(_path(n)) and p.dim() >= 2)
    if not leaves:
        raise ValueError(f"no params match {match!r}")
    adapters = {}
    for path, p in leaves:
        a = torch.randn((p.shape[0], rank), generator=generator,
                        dtype=torch.float32, device=p.device)
        adapters[path] = {
            "a": a / math.sqrt(rank),
            "b": torch.zeros((rank, *p.shape[1:]), dtype=torch.float32,
                             device=p.device)}
    return adapters


class _LoraMerge(torch.autograd.Function):
    """``w + s * (a @ b)`` over b's trailing dims (JAX's ``tensordot(a, b,
    axes=1)``, in fp32, cast to w's dtype before the add)."""

    @staticmethod
    def forward(ctx, w, a, b, scale):
        ctx.save_for_backward(a, b)
        ctx.scale = scale
        delta = (a @ b.reshape(b.shape[0], -1)).reshape(w.shape)
        return w + (scale * delta).to(w.dtype)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        s = ctx.scale
        g = grad.reshape(a.shape[0], -1).to(a.dtype)       # [in, out]
        da = db = None
        if ctx.needs_input_grad[1]:
            da = s * (g @ b.reshape(b.shape[0], -1).t())
        if ctx.needs_input_grad[2]:
            db = (s * (a.t() @ g)).reshape(b.shape)
        return (grad if ctx.needs_input_grad[0] else None), da, db, None


def lora_merge(model: torch.nn.Module, adapters: dict,
               alpha: float | None = None, params: dict | None = None) -> dict:
    """``{parameter name: W + (alpha / r) * A @ B}`` for every adapted
    parameter (run the model with them inside ``nn.module.swapped``).
    Differentiable in the adapters (the fine-tune path) and in ``W`` where
    it requires a gradient. ``params`` ({name: tensor}) stands in for the
    model's own parameters."""
    params = dict(model.named_parameters()) if params is None else params
    out = {}
    for path, ad in adapters.items():
        name = _name(path)
        if name not in params:
            raise KeyError(f"adapter {path!r} names no parameter")
        r = ad["a"].shape[1]
        scale = (alpha if alpha is not None else r) / r
        out[name] = _LoraMerge.apply(params[name], ad["a"], ad["b"], scale)
    return out


@torch.no_grad()
def lora_finalize(model: torch.nn.Module, adapters: dict,
                  alpha: float | None = None) -> torch.nn.Module:
    """A copy of ``model`` with the adapters baked into its weights (deploy
    without LoRA code); ``model`` is left as it was."""
    baked = copy.deepcopy(model)
    params = dict(baked.named_parameters())
    for name, t in lora_merge(model, adapters, alpha).items():
        params[name].copy_(t)
    return baked


def lora_params(adapters: dict) -> dict:
    """The adapter tree as the optimizers' flat ``{"path/a": A, "path/b":
    B}`` (the same tensors)."""
    return {f"{path}/{k}": ad[k] for path, ad in sorted(adapters.items())
            for k in ("a", "b")}


def lora_value_and_grad(model, adapters: dict, tokens,
                        alpha: float | None = None, **loss_kw):
    """(loss, gradient tree ``{path: {"a": dA, "b": dB}}``) of
    ``model.loss(tokens, **loss_kw)`` over the merged weights, as JAX's
    ``value_and_grad`` over the adapter tree. Every base parameter runs
    detached: the loss depends on the base only as a constant."""
    flat = lora_params(adapters)
    leaves = [t.detach().requires_grad_(True) for t in flat.values()]
    tree = {}
    for key, t in zip(flat, leaves):
        path, _, k = key.rpartition("/")
        tree.setdefault(path, {})[k] = t
    frozen = {n: p.detach() for n, p in model.named_parameters()}
    merged = lora_merge(model, tree, alpha, params=frozen)
    with swapped(model, {**frozen, **merged}):
        loss = model.loss(tokens, **loss_kw)
    grads = torch.autograd.grad(loss, leaves)
    out = {}
    for key, g in zip(flat, grads):
        path, _, k = key.rpartition("/")
        out.setdefault(path, {})[k] = g
    return loss.detach(), out


def make_lora_train_step(model, optimizer, alpha: float | None = None):
    """``step(adapters, opt_state, tokens, rng=None) -> (adapters,
    opt_state, loss)``: one optimizer step on the adapters alone (``rng``,
    a dropout stream, turns training on). The adapters' tensors are
    updated in place; ``opt_state`` comes from
    ``optimizer.init(lora_params(adapters))`` and is donated (updated in
    place, ``optimizer.update_``). The base model is never written."""

    def step(adapters, opt_state, tokens, rng=None):
        kw = {} if rng is None else {"training": True,
                                     "rngs": {"dropout": rng}}
        loss, grads = lora_value_and_grad(model, adapters, tokens, alpha,
                                          **kw)
        flat = lora_params(adapters)
        updates, opt_state = optimizer.update_(lora_params(grads), opt_state,
                                               flat)
        apply_updates(flat, updates)
        return adapters, opt_state, loss

    return step
