"""Mixture-of-experts FFN: router, top-k dispatch, expert FFNs, combine.

Counterpart of np_modeling_tpu/nn/moe.py ``MoE``, forward and backward. The
fields, their defaults and checks are JAX's; the parameters sit at JAX's
leaf names, so ``utils.convert`` maps them by path: ``router`` [d, E]
(``router_b`` [E] with ``router_bias``, ``router_sb`` [E] with
``router_select_bias``); gated experts ``w_gate`` / ``w_up`` [E, d, ff] and
``w_down`` [E, ff, d] (``b_gate`` / ``b_up`` [E, ff] and ``b_down`` [E, d]
for ``glu_clamp``), or ``mlp`` experts ``w1`` [E, d, ff], ``b1``, ``w2``
[E, ff, d], ``b2``; and the always-on shared experts under
``shared/{w_gate,w_up,w_down}``.

Routing (``_route``, JAX :200-248): softmax or sigmoid scores of fp32
router logits (JAX's ``xt @ router`` promotes a bf16 ``xt`` to fp32, so a
bf16 model routes on fp32 logits), the select bias, DeepSeek's
group-limited routing (``max`` or ``top2sum`` group scores) and the weight
rules ``default`` / ``softmax`` / ``softmax_norm`` / ``topk_softmax``.
Every top-k is ``_top_k``: a stable descending sort, so that among equal
values the lower index wins, as in ``jax.lax.top_k`` (``torch.topk``
promises no order for ties).

Dispatch: no-drop (``capacity_factor=None``, JAX's ``ragged_dot`` path:
each token reaches its k experts, routed experts in the input's dtype),
``sorted`` (per-expert capacity buffers) and ``dense`` (the [T, E, C]
routing tensor), both with GShard's slotting and JAX's dtype promotion
(fp32 experts under fp32 weights). No Pallas kernel runs in JAX's module,
so the expert products here are plain torch products: a no-drop call of at
most ``GATHER_MAX`` assignments gathers the chosen experts' weights and
runs one batched product (no host sync); a larger one sorts the
assignments by expert, reads the counts to the host once and loops over
the experts that received tokens. Each token's k contributions are summed
in a fixed order (rank 0 first) after the inverse permutation, never by an
atomic scatter, so the result does not move from run to run; it differs
from JAX's expert-ordered scatter only in fp32 rounding.

The forward runs inside a ``torch.autograd.Function`` whose backward
(``MoE._backward``) is written by hand: no autograd formula carries a
gradient through the routing or the dispatch. It saves x and the chosen
experts, recomputes the router and each expert's FFN, and gives the
gradient ``jax.grad`` of JAX's ``apply_with_aux`` gives: through the
combine weights and the aux to the gates and the router (the indices
carry none; the select bias gets zeros, as its winners' weights are
re-read from the unbiased gates); dropped assignments get no routed
gradient; ``jnp.minimum`` / ``jnp.clip``'s half gradient at a limit
(``glu_clamp``, the weight rules' 1e-9 floor). Both no-drop routes take
their backward over the experts in the sorted layout: an expert's weight
gradient is one product over its rows, in x's dtype rounded to it and
widened to fp32 as JAX's ``w.astype(x.dtype)`` gives; a token's gradient
sums its assignments rank 0 first, as the combine does.
``apply_override`` (JAX's expert-parallel shard_map path) is not ported:
any value but None raises NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn import initializers
from np_modeling_tpu_torch.nn.module import swapped
from np_modeling_tpu_torch.ops.activations import activation_grad

# No-drop calls of at most this many (token, expert) assignments take the
# gathered batched product; larger ones loop over the experts. At
# DeepSeek-V2-Lite's decode (8 tokens x top 6) the gathered step took 0.45x
# the loop's time on an H100 (chip_smoke (B), PERF.md section 5).
GATHER_MAX = 64

# The leaves JAX's init fills with zeros (the biases).
_ZERO_INIT = frozenset(("b1", "b2", "b_gate", "b_up", "b_down", "router_b",
                        "router_sb"))


def _top_k(x, k):
    """``jax.lax.top_k`` along the last axis: the k largest, largest first,
    the lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n):
    """``jax.nn.one_hot`` in fp32: an index outside [0, n) gives a zero
    row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _promote(*ts):
    """The tensors in JAX's (and torch's) promoted dtype: bf16 with fp32
    computes in fp32."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _mm(a, b):
    a, b = _promote(a, b)
    return a @ b


def _ein(spec, a, b):
    a, b = _promote(a, b)
    return torch.einsum(spec, a, b)


def _glu_clamp(gate, up, limit=7.0, alpha=1.702):
    """gpt-oss's expert nonlinearity (JAX :172-178)."""
    gate = torch.clamp(gate, max=limit)
    up = torch.clamp(up, -limit, limit)
    return (up + 1.0) * (gate * torch.sigmoid(alpha * gate))


def _clip_grad(x, lo=-math.inf, hi=math.inf):
    """The derivative of JAX's ``jnp.clip(x, lo, hi)`` (and of
    ``jnp.minimum`` / ``jnp.maximum``): 1 inside, 0 outside, and half at a
    limit, where JAX splits the gradient between the two equal operands
    (``torch.clamp`` gives 1 there)."""
    return torch.where((x > lo) & (x < hi), 1.0,
                       torch.where((x == lo) | (x == hi), 0.5, 0.0))


def _glu_clamp_grad(gate, up, dh, limit=7.0, alpha=1.702):
    """The gradients of ``gate`` and ``up`` under ``dh``, by JAX's rule at
    the limits (``_clip_grad``)."""
    gc = torch.clamp(gate, max=limit)
    s = torch.sigmoid(alpha * gc)
    glu = gc * s
    dgc = dh * (torch.clamp(up, -limit, limit) + 1.0) \
        * (s + alpha * glu * (1.0 - s))
    return (dgc * _clip_grad(gate, hi=limit),
            dh * glu * _clip_grad(up, -limit, limit))


def _unsort(v, order):
    """``v`` (rows in sorted order) back in rank-major order."""
    out = torch.empty_like(v)
    out[order] = v
    return out


class _MoEForward(torch.autograd.Function):
    """The MoE's forward, and its backward written by hand
    (``MoE._backward``)."""

    @staticmethod
    def forward(ctx, moe, x, *params):
        out, aux, stats, i_k = moe._forward(x)
        ctx.moe = moe
        # The backward reads the parameters saved here (autograd raises if
        # one changes in place before it).
        ctx.save_for_backward(x, i_k, *params)
        ctx.mark_non_differentiable(*stats)
        return (out, aux, *stats)

    @staticmethod
    def backward(ctx, dout, daux, *_):
        x, i_k, *params = ctx.saved_tensors
        moe = ctx.moe
        names = [n for n, _ in moe.named_parameters()]
        # The backward reads the tensors the forward saved, not whatever
        # the module holds when the backward runs.
        with swapped(moe, dict(zip(names, params))):
            dx, grads = moe._backward(x, i_k, dout, daux)
        # Every parameter gets a gradient, zeros where none flows (the
        # select bias): JAX's tree.
        return (None, dx, *(grads[n] if n in grads else torch.zeros_like(p)
                            for n, p in zip(names, params)))


class MoE(nn.Module):
    """Top-k routed FFN (JAX :51-125): router linear -> dispatch ->
    per-expert FFN -> weighted combine (+ shared experts). ``features`` is
    the model width d, the only argument JAX takes from ``x`` at init."""

    def __init__(self, features: int, num_experts: int, hidden_units: int,
                 capacity_factor: Optional[float] = 1.25,
                 router_top_k: int = 2, router_weights: str = "default",
                 router_bias: bool = False, router_score: str = "softmax",
                 router_select_bias: bool = False,
                 routed_scaling: float = 1.0, router_groups=None,
                 router_group_metric: str = "max",
                 shared_experts_units: int = 0, activation: str = "relu",
                 ffn: str = "mlp",
                 kernel_init: Callable = initializers.lecun_normal,
                 dispatch_impl: str = "auto",
                 apply_override: Optional[Callable] = None, device=None):
        super().__init__()
        if apply_override is not None:
            raise NotImplementedError(
                "MoE.apply_override (the expert-parallel shard_map path) is "
                "not ported yet (ROADMAP.md Queue 1 item 9)")
        checks = (
            (router_top_k >= 1, "router_top_k >= 1"),
            (router_weights in ("default", "softmax", "softmax_norm",
                                "topk_softmax"), "router_weights"),
            (router_score in ("softmax", "sigmoid"), "router_score"),
            (router_group_metric in ("max", "top2sum"),
             "router_group_metric"),
            (router_score != "sigmoid"
             or router_weights in ("softmax", "softmax_norm"),
             "sigmoid scoring takes raw ('softmax') or renormalized "
             "('softmax_norm') kept weights"),
            (router_weights != "default" or router_top_k in (1, 2),
             "k > 2 needs an explicit weight rule: router_weights="
             "'softmax' (DeepSeek) or 'softmax_norm'"),
            (dispatch_impl in ("auto", "dense", "sorted"), "dispatch_impl"),
            (ffn in ("mlp", "swiglu", "geglu", "glu_clamp"), f"ffn {ffn!r}"),
            (not shared_experts_units or ffn not in ("mlp", "glu_clamp"),
             "shared experts are plain-gated-FFN only"),
        )
        bad = [msg for ok, msg in checks if not ok]
        if bad:
            raise ValueError(f"MoE: {bad[0]} (JAX asserts)")
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.router_top_k, self.router_weights = router_top_k, router_weights
        self.router_score = router_score
        self.routed_scaling = routed_scaling
        self.router_groups = router_groups
        self.router_group_metric = router_group_metric
        self.activation, self.ffn = activation, ffn
        self.kernel_init, self.dispatch_impl = kernel_init, dispatch_impl
        d, e, f = features, num_experts, hidden_units

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                            device=device))

        self.router = param(d, e)
        if ffn == "mlp":
            self.w1, self.b1 = param(e, d, f), param(e, f)
            self.w2, self.b2 = param(e, f, d), param(e, d)
        else:
            self.w_gate, self.w_up = param(e, d, f), param(e, d, f)
            self.w_down = param(e, f, d)
        self.router_b = param(e) if router_bias and ffn != "mlp" else None
        self.router_sb = param(e) if router_select_bias else None
        if ffn == "glu_clamp":
            self.b_gate, self.b_up = param(e, f), param(e, f)
            self.b_down = param(e, d)
        self.shared = None
        if shared_experts_units:
            sf = shared_experts_units
            self.shared = nn.ParameterDict({
                "w_gate": param(d, sf), "w_up": param(d, sf),
                "w_down": param(sf, d)})

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """JAX's distributions (JAX :126-163): ``kernel_init`` for the
        router, expert and shared weights (3-D fans: in axis -2 times the
        expert axis), zeros for every bias."""
        for name, p in self.named_parameters():
            if name.rpartition(".")[2] in _ZERO_INIT:
                p.zero_()
            else:
                p.copy_(self.kernel_init(generator, p.shape))
        return self

    def _gate_act(self):
        return ops.silu if self.ffn == "swiglu" else ops.gelu

    def _act_name(self):
        """The activation of the expert FFN (and shared experts), by name."""
        if self.ffn == "mlp":
            return self.activation
        return "silu" if self.ffn == "swiglu" else "gelu"

    def _capacity(self, tokens):
        """ceil(k * T / E * factor), at least 4, a multiple of 4."""
        c = int(self.router_top_k * tokens / self.num_experts
                * self.capacity_factor)
        c = max(c, 4)
        return -(-c // 4) * 4

    def _impl(self):
        if self.capacity_factor is None:
            return "nodrop"
        if self.dispatch_impl == "auto":
            return "sorted" if self.num_experts > 8 else "dense"
        return self.dispatch_impl

    # ---- routing ----------------------------------------------------------

    def _logits(self, xt):
        logits = _mm(xt, self.router)                   # [T, E], fp32
        if self.router_b is not None:
            logits = logits + self.router_b
        return logits

    def _scores(self, logits):
        return (torch.sigmoid(logits) if self.router_score == "sigmoid"
                else torch.softmax(logits, dim=-1))

    def _pool(self, gates):
        """The selection pool (scores plus the select bias; with group-limited
        routing, the experts outside the kept groups zeroed) and each
        expert's keep factor [T, E] (None without groups)."""
        pool = gates + self.router_sb if self.router_sb is not None else gates
        if self.router_groups is None:
            return pool, None
        n_group, topk_group = self.router_groups
        e = self.num_experts
        if e % n_group:
            raise ValueError(f"{e} experts in {n_group} groups")
        gg = pool.reshape(-1, n_group, e // n_group)
        if self.router_group_metric == "top2sum":
            best = _top_k(gg, 2)[0].sum(dim=-1)
        else:
            best = gg.amax(dim=-1)                      # [T, G]
        _, gi = _top_k(best, topk_group)
        keep = _one_hot(gi, n_group).sum(dim=1)         # [T, G]
        return ((gg * keep[:, :, None]).reshape(-1, e),
                keep.repeat_interleave(e // n_group, dim=1))

    def _kept(self, gates, i):
        """The chosen experts' values before the weight rule, and their keep
        factors (None: 1). Under the select bias they are the unbiased gates
        (JAX :235-237), so no gradient reaches ``router_sb``."""
        if self.router_sb is not None:
            return torch.gather(gates, 1, i), None
        pool, keep = self._pool(gates)
        return (torch.gather(pool, 1, i),
                None if keep is None else torch.gather(keep, 1, i))

    def _weights(self, logits, gates, i):
        """The combine weights [T, k] of the chosen experts ``i``."""
        k = i.shape[1]
        if self.router_weights == "topk_softmax":
            w = torch.softmax(torch.gather(logits, 1, i), dim=-1)
        else:
            g = self._kept(gates, i)[0]
            if self.router_weights == "softmax_norm":
                w = g / torch.clamp(g.sum(dim=1, keepdim=True), min=1e-9)
            elif self.router_weights == "default" and k == 2:   # GShard
                denom = torch.clamp(g[:, 0] + g[:, 1], min=1e-9)
                w = torch.stack([g[:, 0] / denom, g[:, 1] / denom], dim=1)
            else:
                w = g
        if self.routed_scaling != 1.0:
            w = w * self.routed_scaling
        return w

    def _route(self, xt):
        """Per-token top-k choice: (gates [T, E], idx [T, k], w [T, k])."""
        k = self.router_top_k
        logits = self._logits(xt)
        gates = self._scores(logits)
        pool = (logits if self.router_weights == "topk_softmax"
                else self._pool(gates)[0])
        i = _top_k(pool, k)[1]
        return gates, i, self._weights(logits, gates, i)

    def _route_grad(self, xt, logits, i, dw, daux):
        """The router's backward: from the combine weights' gradient ``dw``
        [T, k] and the aux's ``daux``, the gradients of the router's leaves
        and xt's share (fp32). The chosen indices carry none."""
        t, e = xt.shape[0], self.num_experts
        gates = self._scores(logits)
        if self.routed_scaling != 1.0:
            dw = dw * self.routed_scaling
        # aux = E * sum_e mean_t(gates) * mean_t(top1).
        dgates = (daux * e / t * _one_hot(i[:, 0], e).mean(dim=0)).expand(
            t, e)
        dlogits = torch.zeros_like(logits)
        if self.router_weights == "topk_softmax":
            w0 = torch.softmax(torch.gather(logits, 1, i), dim=-1)
            dg = w0 * (dw - (dw * w0).sum(dim=1, keepdim=True))
            dlogits.scatter_(1, i, dg)
        else:
            g, keep = self._kept(gates, i)
            dg = dw
            if self.router_weights == "softmax_norm" or (
                    self.router_weights == "default" and i.shape[1] == 2):
                s = g.sum(dim=1, keepdim=True)
                c = torch.clamp(s, min=1e-9)
                dg = dw / c - ((dw * g).sum(dim=1, keepdim=True) / (c * c)
                               * _clip_grad(s, lo=1e-9))
            if keep is not None:
                dg = dg * keep
            dgates = dgates + torch.zeros_like(gates).scatter_(1, i, dg)
        if self.router_score == "sigmoid":
            dlogits = dlogits + dgates * gates * (1.0 - gates)
        else:
            dlogits = dlogits + gates * (
                dgates - (dgates * gates).sum(dim=-1, keepdim=True))
        grads = {"router": xt.float().t() @ dlogits}
        if self.router_b is not None:
            grads["router_b"] = dlogits.sum(dim=0)
        return dlogits @ self.router.t(), grads

    @staticmethod
    def _aux(gates, idx):
        e = gates.shape[-1]
        top1 = _one_hot(idx[:, 0], e)
        return e * torch.sum(gates.mean(dim=0) * top1.mean(dim=0))

    # ---- the expert FFN ---------------------------------------------------

    def _ffn(self, x, prod, bias):
        """The expert FFN (JAX :327-346, :398-430) on ``x``: ``prod(a,
        name)`` is ``a``'s product with the leaf ``name`` and ``bias(name)``
        that bias as x's rows see it."""
        if self.ffn == "glu_clamp":
            g = prod(x, "w_gate") + bias("b_gate")
            u = prod(x, "w_up") + bias("b_up")
            return prod(_glu_clamp(g, u), "w_down") + bias("b_down")
        if self.ffn != "mlp":
            g = self._gate_act()(prod(x, "w_gate"))
            return prod(g * prod(x, "w_up"), "w_down")
        act = ops.get_activation(self.activation)
        h = act(prod(x, "w1") + bias("b1"))
        return prod(h, "w2") + bias("b2")

    def _ffn_grad(self, x, dy, prod, prod_grad, bias, bias_sum):
        """``_ffn``'s backward, recomputed from its input ``x``: (y, dx in
        fp32, {leaf: gradient}). ``dy`` is y's gradient in fp32 (cast to
        y's dtype here, as the promotion that consumed y transposes);
        ``prod_grad(a, name, g)`` gives (da, the leaf's gradient) of
        ``prod(a, name)`` for its output gradient g, ``bias_sum(g)`` a
        bias's gradient."""
        grads = {}

        def back(a, name, g):
            da, grads[name] = prod_grad(a, name, g)
            return da.float()

        act = self._act_name()
        if self.ffn == "glu_clamp":
            g = prod(x, "w_gate") + bias("b_gate")
            u = prod(x, "w_up") + bias("b_up")
            h = _glu_clamp(g, u)
            y = prod(h, "w_down") + bias("b_down")
            dy = dy.to(y.dtype)
            grads["b_down"] = bias_sum(dy)
            dg, du = _glu_clamp_grad(g, u, back(h, "w_down", dy))
            grads["b_gate"], grads["b_up"] = bias_sum(dg), bias_sum(du)
            return y, back(x, "w_gate", dg) + back(x, "w_up", du), grads
        if self.ffn != "mlp":
            a = prod(x, "w_gate")
            gate = self._gate_act()(a)
            up = prod(x, "w_up")
            h = gate * up
            y = prod(h, "w_down")
            # dh stays in y's dtype: the gate's product ran in it.
            dh, grads["w_down"] = prod_grad(h, "w_down", dy.to(y.dtype))
            da = activation_grad(act, a, dh * up)
            return y, back(x, "w_gate", da) + back(x, "w_up", dh * gate), \
                grads
        a = prod(x, "w1") + bias("b1")
        h = ops.get_activation(self.activation)(a)
        y = prod(h, "w2") + bias("b2")
        dy = dy.to(y.dtype)
        grads["b2"] = bias_sum(dy)
        da = activation_grad(act, a, back(h, "w2", dy))
        grads["b1"] = bias_sum(da)
        return y, back(x, "w1", da), grads

    def _batched(self):
        """``_ffn``'s operands for the capacity buffers [E, C, d]: products
        in JAX's promoted dtype (fp32 under fp32 weights), biases [E, 1, .]."""
        def prod(a, name):
            return _ein("eci,eio->eco", a, getattr(self, name))

        def prod_grad(a, name, g):
            a, w = _promote(a, getattr(self, name))
            g = g.to(a.dtype)
            return (torch.einsum("eco,eio->eci", g, w),
                    torch.einsum("eci,eco->eio", a, g).float())

        return (prod, prod_grad, lambda name: getattr(self, name)[:, None],
                lambda g: g.sum(dim=1))

    def _rows(self, dt, weights):
        """``_ffn``'s operands for no-drop rows in x's dtype ``dt`` (JAX's
        ``ragged_dot`` of ``w.astype(x.dtype)``): ``weights(name)`` is each
        row's weight [n, ., .] (gathered) or one expert's [., .], and its
        bias rows. A weight's gradient is a product in ``dt``, rounded to
        ``dt``, then widened to fp32, as JAX's."""
        def prod(a, name):
            w = weights(name).to(dt)
            a = a.to(dt)
            if w.dim() == 3:
                return torch.bmm(a[:, None, :], w)[:, 0]
            return a @ w

        def prod_grad(a, name, g):
            a, g, w = a.to(dt), g.to(dt), weights(name).to(dt)
            return g @ w.t(), (a.t() @ g).float()

        return prod, prod_grad, weights, lambda g: g.sum(dim=0)

    def _shared_ops(self):
        """``_ffn``'s operands for the shared experts, fp32 by promotion (JAX
        :277-281)."""
        sp = self.shared

        def prod(a, name):
            return _mm(a, sp[name])

        def prod_grad(a, name, g):
            a, w = _promote(a, sp[name])
            g = g.to(a.dtype)
            return g @ w.t(), (a.t() @ g).float()

        return prod, prod_grad, None, None

    # ---- the forward and the backward -------------------------------------

    def forward(self, x, training: bool = False, rngs=None):
        """JAX ``apply``: the output alone."""
        del training, rngs
        return self.apply_with_aux(x)[0]

    def apply_with_aux(self, x, training: bool = False, rngs=None,
                       collect_stats: bool = False):
        """(out, load-balancing aux) (JAX :255-287); ``collect_stats=True``
        adds {``dropped_fraction`` of the k * T assignments,
        ``expert_load``: the share of tokens whose first choice is each
        expert}."""
        del training, rngs
        out, aux, dropped, load = _MoEForward.apply(
            self, x, *self.parameters())
        if collect_stats:
            return out, aux, {"dropped_fraction": dropped,
                              "expert_load": load}
        return out, aux

    def _forward(self, x):
        """(out, aux, (dropped fraction, expert load), the chosen experts)."""
        orig = x.shape
        xt = x.reshape(-1, orig[-1])
        gates, i_k, w_k = self._route(xt)
        apply = {"dense": self._apply_dense, "sorted": self._apply_sorted,
                 "nodrop": self._apply_nodrop}[self._impl()]
        out, dropped = apply(xt, i_k, w_k)
        if self.shared is not None:
            out = out + self._ffn(xt, *self._shared_ops()[::2]).to(out.dtype)
        load = _one_hot(i_k[:, 0], self.num_experts).mean(dim=0)
        return out.reshape(orig), self._aux(gates, i_k), (dropped, load), i_k

    def _backward(self, x, i_k, dout, daux):
        """The gradients of x and of the leaves (by name) for the cotangents
        ``dout`` and ``daux``, the routing recomputed from x and the chosen
        experts ``i_k``. Each path mirrors its forward; every sum over a
        token's assignments runs in a fixed order, none by atomics."""
        xt = x.reshape(-1, x.shape[-1])
        dy = dout.reshape(xt.shape).float()
        logits = self._logits(xt)
        w_k = self._weights(logits, self._scores(logits), i_k)
        grad = {"dense": self._dense_grad, "sorted": self._sorted_grad,
                "nodrop": self._nodrop_grad}[self._impl()]
        dx, dw_k, grads = grad(xt, i_k, w_k, dy)
        if self.shared is not None:
            _, dxs, gs = self._ffn_grad(xt, dy, *self._shared_ops())
            dx = dx + dxs
            grads.update({f"shared.{n}": g for n, g in gs.items()})
        dxr, gr = self._route_grad(xt, logits, i_k, dw_k, daux.float())
        grads.update(gr)
        return (dx + dxr).to(x.dtype).reshape(x.shape), grads

    @staticmethod
    def _combine(contrib, order, k, t):
        """Sum each token's k contributions ``contrib`` [kT, d] (in the
        sorted order ``order``; None: already rank-major) in fp32, rank 0
        first: the inverse permutation, then k adds."""
        if order is not None:
            contrib = _unsort(contrib, order)
        contrib = contrib.reshape(k, t, -1)
        out = contrib[0].float()
        for r in range(1, k):
            out = out + contrib[r]
        return out

    def _expert_grads(self):
        """Zeroed fp32 gradients of the routed experts' leaves."""
        names = (("w1", "b1", "w2", "b2") if self.ffn == "mlp" else
                 ("w_gate", "w_up", "w_down")
                 + (("b_gate", "b_up", "b_down")
                    if self.ffn == "glu_clamp" else ()))
        return {n: torch.zeros_like(getattr(self, n), dtype=torch.float32)
                for n in names}

    # ---- dense [T, E, C] dispatch -----------------------------------------

    def _dense_routing(self, i_k, w_k, cap):
        """GShard's [T, E, C] combine tensor, the kept count, and each rank's
        (keep [T, E], slot [T, C]): rank-r choices slot after every rank-(r -
        1) choice."""
        t, k = i_k.shape
        e = self.num_experts
        combine = torch.zeros((t, e, cap), dtype=torch.float32,
                              device=i_k.device)
        kept = torch.zeros((), dtype=torch.float32, device=i_k.device)
        count_prev = torch.zeros((1, e), dtype=torch.float32,
                                 device=i_k.device)
        ranks = []
        for r in range(k):
            mask_r = _one_hot(i_k[:, r], e)                       # [T, E]
            pos_r = (torch.cumsum(mask_r, dim=0) - 1.0 + count_prev) * mask_r
            keep_r = mask_r * (pos_r < cap)
            slot = _one_hot(pos_r.sum(dim=1).to(torch.int32), cap)
            combine = combine + (keep_r[:, :, None] * slot[:, None, :]
                                 * w_k[:, r, None, None])
            kept = kept + keep_r.sum()
            count_prev = count_prev + mask_r.sum(dim=0, keepdim=True)
            ranks.append((keep_r, slot))
        return combine, kept, ranks

    def _apply_dense(self, xt, i_k, w_k):
        t, k = i_k.shape
        combine, kept, _ = self._dense_routing(i_k, w_k, self._capacity(t))
        dispatch = (combine > 0.0).to(xt.dtype)
        expert_in = torch.einsum("tec,td->ecd", dispatch.float(),
                                 xt.float()).to(xt.dtype)
        expert_out = self._ffn(expert_in, *self._batched()[::2])
        out = torch.einsum("tec,ecd->td", combine.to(xt.dtype).float(),
                           expert_out.float()).to(xt.dtype)
        return out, 1.0 - kept / (k * t)

    def _dense_grad(self, xt, i_k, w_k, dy):
        t = xt.shape[0]
        combine, _, ranks = self._dense_routing(i_k, w_k, self._capacity(t))
        dispatch = (combine > 0.0).float()
        expert_in = torch.einsum("tec,td->ecd", dispatch,
                                 xt.float()).to(xt.dtype)
        y, dxe, grads = self._ffn_grad(
            expert_in, torch.einsum("tec,td->ecd",
                                    combine.to(xt.dtype).float(), dy),
            *self._batched())
        # combine reached the product as combine.to(x's dtype).
        dcomb = torch.einsum("td,ecd->tec", dy, y.float()).to(
            xt.dtype).float()
        dw_k = torch.stack([(dcomb * keep[:, :, None] * slot[:, None, :]).sum(
            dim=(1, 2)) for keep, slot in ranks], dim=1)
        dx = torch.einsum("tec,ecd->td", dispatch, dxe.to(xt.dtype).float())
        return dx, dw_k, grads

    # ---- sorted dispatch --------------------------------------------------

    def _sort(self, i_k, w_k):
        """The assignments in GShard slot order, sorted by (expert, rank,
        token) (JAX :350-371): (order, tok_s, exp_s, wgt_s, pos_s, counts);
        ``order`` maps sorted places to rank-major ones."""
        t, k = i_k.shape
        dev = i_k.device
        tok = torch.arange(t, device=dev).repeat(k)         # [kT]
        exp = i_k.t().reshape(-1)                           # rank-major
        wgt = w_k.t().reshape(-1)
        rank = torch.arange(k, device=dev).repeat_interleave(t)
        key = exp * (k * t) + rank * t + tok                # unique
        order = torch.argsort(key)
        tok_s, exp_s, wgt_s = tok[order], exp[order], wgt[order]
        counts = torch.bincount(exp_s, minlength=self.num_experts)
        starts = torch.cumsum(counts, dim=0) - counts
        pos_s = torch.arange(k * t, device=dev) - starts[exp_s]
        return order, tok_s, exp_s, wgt_s, pos_s, counts

    def _slots(self, xt, i_k, w_k):
        """The sorted assignments, their capacity slots (the dump slot E * C
        for a dropped one) and the capacity buffers [E, C, d] of x."""
        t, d = xt.shape
        e, cap = self.num_experts, self._capacity(t)
        order, tok_s, exp_s, wgt_s, pos_s, _ = self._sort(i_k, w_k)
        keep = pos_s < cap
        slot = torch.where(keep, exp_s * cap + pos_s, e * cap)
        buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=xt.device)
        buf[slot] = xt[tok_s]
        return order, tok_s, wgt_s, keep, slot, buf[:-1].reshape(e, cap, d)

    def _apply_sorted(self, xt, i_k, w_k):
        t, d = xt.shape
        k = i_k.shape[1]
        order, _, wgt_s, keep, slot, expert_in = self._slots(xt, i_k, w_k)
        expert_out = self._ffn(expert_in, *self._batched()[::2])
        out_pad = torch.cat([expert_out.reshape(-1, d),
                             expert_out.new_zeros((1, d))])
        contrib = (wgt_s * keep)[:, None] * out_pad[slot]
        out = self._combine(contrib, order, k, t)
        return out.to(xt.dtype), 1.0 - keep.sum() / keep.shape[0]

    def _sorted_grad(self, xt, i_k, w_k, dy):
        t, d = xt.shape
        k = i_k.shape[1]
        order, tok_s, wgt_s, keep, slot, expert_in = self._slots(xt, i_k, w_k)
        dyc = dy[tok_s]
        # Each kept slot holds one assignment; the dropped ones write zeros
        # to the dump slot, which no expert reads.
        dout_pad = torch.zeros((self.num_experts * expert_in.shape[1] + 1, d),
                               dtype=torch.float32, device=xt.device)
        dout_pad[slot] = dyc * (wgt_s * keep)[:, None]
        y, dxe, grads = self._ffn_grad(
            expert_in, dout_pad[:-1].reshape(expert_in.shape),
            *self._batched())
        y_pad = torch.cat([y.reshape(-1, d), y.new_zeros((1, d))])
        dwgt_s = (dyc * y_pad[slot].float()).sum(dim=-1) * keep
        dx_pad = torch.cat([dxe.to(xt.dtype).reshape(-1, d),
                            dxe.new_zeros((1, d), dtype=xt.dtype)])
        dx = self._combine(dx_pad[slot], order, k, t)
        return dx, _unsort(dwgt_s, order).reshape(k, t).t(), grads

    # ---- no-drop dispatch -------------------------------------------------

    def _apply_nodrop(self, xt, i_k, w_k):
        t, d = xt.shape
        k = i_k.shape[1]
        zero = torch.zeros((), dtype=torch.float32, device=xt.device)
        if k * t <= GATHER_MAX:
            exp = i_k.t().reshape(-1)                       # rank-major
            y = self._ffn(xt.repeat(k, 1), *self._rows(
                xt.dtype, lambda name: getattr(self, name).index_select(
                    0, exp))[::2])
            contrib = w_k.t().reshape(-1)[:, None] * y
            return self._combine(contrib, None, k, t).to(xt.dtype), zero
        order, tok_s, _, wgt_s, _, counts = self._sort(i_k, w_k)
        x_s = xt[tok_s]
        y = None
        start = 0
        for ex, n in enumerate(counts.tolist()):
            if n == 0:
                continue
            rows = slice(start, start + n)
            part = self._ffn(x_s[rows], *self._rows(
                xt.dtype, lambda name, ex=ex: getattr(self, name)[ex])[::2])
            if y is None:
                y = part.new_empty((k * t, d))
            y[rows] = part
            start += n
        out = self._combine(wgt_s[:, None] * y, order, k, t)
        return out.to(xt.dtype), zero

    def _nodrop_grad(self, xt, i_k, w_k, dy):
        """Both no-drop routes' backward, over the experts in the sorted
        layout: an expert's weight gradient is one product over its rows
        (the gathered route's too: no [kT, d, f] weights, no scatter)."""
        t, d = xt.shape
        k = i_k.shape[1]
        order, tok_s, _, wgt_s, _, counts = self._sort(i_k, w_k)
        grads = self._expert_grads()
        dx_s = xt.new_empty((k * t, d), dtype=torch.float32)
        dwgt_s = torch.empty_like(wgt_s)
        start = 0
        for ex, n in enumerate(counts.tolist()):
            if n == 0:
                continue
            rows = slice(start, start + n)
            tok = tok_s[rows]
            dyc = dy[tok]
            y, dx_s[rows], gr = self._ffn_grad(
                xt[tok], dyc * wgt_s[rows, None], *self._rows(
                    xt.dtype, lambda name, ex=ex: getattr(self, name)[ex]))
            dwgt_s[rows] = (dyc * y.float()).sum(dim=-1)
            for name, g in gr.items():
                grads[name][ex] = g
            start += n
        dx = self._combine(dx_s, order, k, t)
        return dx, _unsort(dwgt_s, order).reshape(k, t).t(), grads

    def load_balancing_loss(self, x):
        """GShard's aux loss (JAX :439-450): E * sum_e mean(gate_e) *
        mean(route1_e), softmax gates, first choice by argmax."""
        xt = x.reshape(-1, x.shape[-1])
        gates = torch.softmax(self._logits(xt), dim=-1)
        top1 = _one_hot(torch.argmax(gates, dim=-1), self.num_experts)
        return self.num_experts * torch.sum(gates.mean(dim=0)
                                            * top1.mean(dim=0))
