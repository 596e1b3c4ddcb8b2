"""Mixture-of-experts FFN: router, top-k dispatch, expert FFNs, combine.

Counterpart of np_modeling_tpu/nn/moe.py ``MoE`` (forward only). The fields,
their defaults and checks are JAX's; the parameters sit at JAX's leaf names,
so ``utils.convert`` maps them by path: ``router`` [d, E] (``router_b``
[E] with ``router_bias``, ``router_sb`` [E] with ``router_select_bias``);
gated experts ``w_gate`` / ``w_up`` [E, d, ff] and ``w_down`` [E, ff, d]
(``b_gate`` / ``b_up`` [E, ff] and ``b_down`` [E, d] for ``glu_clamp``),
or ``mlp`` experts ``w1`` [E, d, ff], ``b1``, ``w2`` [E, ff, d], ``b2``;
and the always-on shared experts under ``shared/{w_gate,w_up,w_down}``.

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
raises NotImplementedError: MoE training (the hand-written backward and
the aux loss's gradient) is ROADMAP.md Queue 1 item 0's next step, and no
gradient that autograd would derive on its own is used meanwhile.
``apply_override`` (JAX's expert-parallel shard_map path) is not ported:
any value but None raises NotImplementedError.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn import initializers

BACKWARD_LATER = ("the MoE's backward is not ported yet: MoE training (the "
                  "hand-written backward and the aux loss's gradient) is "
                  "ROADMAP.md Queue 1 item 0")

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


class _MoEForward(torch.autograd.Function):
    """The MoE's forward; its backward is a later slice."""

    @staticmethod
    def forward(ctx, moe, x, *params):
        del params         # inputs only so that autograd reaches backward
        out, aux, dropped, load = moe._forward(x)
        ctx.mark_non_differentiable(dropped, load)
        return out, aux, dropped, load

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(BACKWARD_LATER)


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

    def _route(self, xt):
        """Per-token top-k choice: (gates [T, E], idx [T, k], w [T, k])."""
        k = self.router_top_k
        logits = self._logits(xt)
        gates = (torch.sigmoid(logits) if self.router_score == "sigmoid"
                 else torch.softmax(logits, dim=-1))
        if self.router_weights == "topk_softmax":
            g, i = _top_k(logits, k)
            w = torch.softmax(g, dim=-1)
            if self.routed_scaling != 1.0:
                w = w * self.routed_scaling
            return gates, i, w
        pool = gates + self.router_sb if self.router_sb is not None else gates
        if self.router_groups is not None:
            n_group, topk_group = self.router_groups
            e = self.num_experts
            if e % n_group:
                raise ValueError(f"{e} experts in {n_group} groups")
            gg = pool.reshape(-1, n_group, e // n_group)
            if self.router_group_metric == "top2sum":
                best = _top_k(gg, 2)[0].sum(dim=-1)
            else:
                best = gg.amax(dim=-1)                  # [T, G]
            _, gi = _top_k(best, topk_group)
            keep = _one_hot(gi, n_group).sum(dim=1)     # [T, G]
            pool = (gg * keep[:, :, None]).reshape(-1, e)
        g, i = _top_k(pool, k)
        if self.router_sb is not None:
            g = torch.gather(gates, 1, i)               # unbiased winners
        if self.router_weights == "softmax":
            w = g
        elif self.router_weights == "softmax_norm":
            w = g / torch.clamp(g.sum(dim=1, keepdim=True), min=1e-9)
        elif k == 2:                                    # GShard
            denom = torch.clamp(g[:, 0] + g[:, 1], min=1e-9)
            w = torch.stack([g[:, 0] / denom, g[:, 1] / denom], dim=1)
        else:
            w = g
        if self.routed_scaling != 1.0:
            w = w * self.routed_scaling
        return gates, i, w

    @staticmethod
    def _aux(gates, idx):
        e = gates.shape[-1]
        top1 = _one_hot(idx[:, 0], e)
        return e * torch.sum(gates.mean(dim=0) * top1.mean(dim=0))

    def _stats(self, i_k, dropped):
        return dropped, _one_hot(i_k[:, 0], self.num_experts).mean(dim=0)

    # ---- the forward ------------------------------------------------------

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
        orig = x.shape
        xt = x.reshape(-1, orig[-1])
        impl = self._impl()
        if impl == "dense":
            out, aux, stats = self._apply_dense(xt)
        elif impl == "sorted":
            out, aux, stats = self._apply_sorted(xt)
        else:
            out, aux, stats = self._apply_nodrop(xt)
        if self.shared is not None:
            sp = self.shared
            g = self._gate_act()(_mm(xt, sp["w_gate"]))
            out = out + _mm(g * _mm(xt, sp["w_up"]), sp["w_down"]).to(
                out.dtype)
        return (out.reshape(orig), aux, *stats)

    @staticmethod
    def _combine(contrib, order, k, t):
        """Sum each token's k contributions ``contrib`` [kT, d] (in the
        sorted order ``order``; None: already rank-major) in fp32, rank 0
        first: the inverse permutation, then k adds."""
        if order is not None:
            unsorted = torch.empty_like(contrib)
            unsorted[order] = contrib
            contrib = unsorted
        contrib = contrib.reshape(k, t, -1)
        out = contrib[0].float()
        for r in range(1, k):
            out = out + contrib[r]
        return out

    # ---- dense [T, E, C] dispatch -----------------------------------------

    def _apply_dense(self, xt):
        t = xt.shape[0]
        e, k = self.num_experts, self.router_top_k
        cap = self._capacity(t)
        gates, i_k, w_k = self._route(xt)
        combine = torch.zeros((t, e, cap), dtype=torch.float32,
                              device=xt.device)
        kept = torch.zeros((), dtype=torch.float32, device=xt.device)
        count_prev = torch.zeros((1, e), dtype=torch.float32,
                                 device=xt.device)
        # Rank-r choices slot after every rank-(r - 1) choice (GShard).
        for r in range(k):
            mask_r = _one_hot(i_k[:, r], e)                       # [T, E]
            pos_r = (torch.cumsum(mask_r, dim=0) - 1.0 + count_prev) * mask_r
            keep_r = mask_r * (pos_r < cap)
            slot = _one_hot(pos_r.sum(dim=1).to(torch.int32), cap)
            combine = combine + (keep_r[:, :, None] * slot[:, None, :]
                                 * w_k[:, r, None, None])
            kept = kept + keep_r.sum()
            count_prev = count_prev + mask_r.sum(dim=0, keepdim=True)
        dispatch = (combine > 0.0).to(xt.dtype)
        expert_in = torch.einsum("tec,td->ecd", dispatch.float(),
                                 xt.float()).to(xt.dtype)
        expert_out = self._expert_ffn(expert_in)
        out = torch.einsum("tec,ecd->td", combine.to(xt.dtype).float(),
                           expert_out.float()).to(xt.dtype)
        stats = self._stats(i_k, 1.0 - kept / (k * t))
        return out, self._aux(gates, i_k), stats

    def _expert_ffn(self, expert_in):
        """[E, C, d] -> [E, C, d], the batched experts in JAX's promoted
        dtype (JAX :327-346)."""
        if self.ffn == "glu_clamp":
            g = _ein("ecd,edf->ecf", expert_in, self.w_gate) \
                + self.b_gate[:, None]
            u = _ein("ecd,edf->ecf", expert_in, self.w_up) \
                + self.b_up[:, None]
            return _ein("ecf,efd->ecd", _glu_clamp(g, u), self.w_down) \
                + self.b_down[:, None]
        if self.ffn != "mlp":
            g = self._gate_act()(_ein("ecd,edf->ecf", expert_in, self.w_gate))
            h = g * _ein("ecd,edf->ecf", expert_in, self.w_up)
            return _ein("ecf,efd->ecd", h, self.w_down)
        act = ops.get_activation(self.activation)
        h = act(_ein("ecd,edf->ecf", expert_in, self.w1)
                + self.b1[:, None, :])
        return _ein("ecf,efd->ecd", h, self.w2) + self.b2[:, None, :]

    # ---- sorted dispatch --------------------------------------------------

    def _assignments(self, xt):
        """The assignments in GShard slot order, sorted by (expert, rank,
        token) (JAX :350-371): (gates, i_k, (order, tok_s, exp_s, wgt_s,
        pos_s, counts)); ``order`` maps sorted places to rank-major
        ones."""
        t = xt.shape[0]
        k = self.router_top_k
        gates, i_k, w_k = self._route(xt)
        ar = torch.arange(t, device=xt.device)
        tok = ar.repeat(k)                                  # [kT]
        exp = i_k.t().reshape(-1)                           # rank-major
        wgt = w_k.t().reshape(-1)
        rank = torch.arange(k, device=xt.device).repeat_interleave(t)
        key = exp * (k * t) + rank * t + tok                # unique
        order = torch.argsort(key)
        tok_s, exp_s, wgt_s = tok[order], exp[order], wgt[order]
        counts = torch.bincount(exp_s, minlength=self.num_experts)
        starts = torch.cumsum(counts, dim=0) - counts
        pos_s = torch.arange(k * t, device=xt.device) - starts[exp_s]
        return gates, i_k, (order, tok_s, exp_s, wgt_s, pos_s, counts)

    def _apply_sorted(self, xt):
        t, d = xt.shape
        e, k = self.num_experts, self.router_top_k
        cap = self._capacity(t)
        gates, i_k, (order, tok_s, exp_s, wgt_s, pos_s, _) = \
            self._assignments(xt)
        keep = pos_s < cap
        slot = torch.where(keep, exp_s * cap + pos_s, e * cap)   # dump slot
        buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=xt.device)
        buf[slot] = xt[tok_s]
        expert_out = self._expert_ffn(buf[:-1].reshape(e, cap, d))
        out_pad = torch.cat([expert_out.reshape(e * cap, d),
                             expert_out.new_zeros((1, d))])
        contrib = (wgt_s * keep)[:, None] * out_pad[slot]
        out = self._combine(contrib, order, k, t)
        stats = self._stats(i_k, 1.0 - keep.sum() / keep.shape[0])
        return out.to(xt.dtype), self._aux(gates, i_k), stats

    # ---- no-drop dispatch -------------------------------------------------

    def _expert_rows(self, x_s, weights):
        """The no-drop experts on rows ``x_s`` [n, d] (JAX :398-430, its
        ``ragged_dot`` products): ``weights(name)`` gives each row's
        expert weight of that name, [n, ., .] (gathered) or [., .] (one
        expert), and its bias rows. The routed products run in x's dtype;
        the biases and glu_clamp's nonlinearity promote to fp32, as in
        JAX."""
        dt = x_s.dtype

        def prod(a, name):
            w = weights(name).to(dt)
            a = a.to(dt)
            if w.dim() == 3:
                return torch.bmm(a[:, None, :], w)[:, 0]
            return a @ w

        if self.ffn == "glu_clamp":
            g = prod(x_s, "w_gate") + weights("b_gate")
            u = prod(x_s, "w_up") + weights("b_up")
            return prod(_glu_clamp(g, u), "w_down") + weights("b_down")
        if self.ffn != "mlp":
            g = self._gate_act()(prod(x_s, "w_gate"))
            return prod(g * prod(x_s, "w_up"), "w_down")
        act = ops.get_activation(self.activation)
        h = act(prod(x_s, "w1") + weights("b1"))
        return prod(h, "w2") + weights("b2")

    def _apply_nodrop(self, xt):
        t, d = xt.shape
        k = self.router_top_k
        if k * t <= GATHER_MAX:
            gates, i_k, w_k = self._route(xt)
            exp = i_k.t().reshape(-1)                       # rank-major
            y = self._expert_rows(
                xt.repeat(k, 1),
                lambda name: getattr(self, name).index_select(0, exp))
            contrib = w_k.t().reshape(-1)[:, None] * y
            out = self._combine(contrib, None, k, t)
        else:
            gates, i_k, (order, tok_s, exp_s, wgt_s, _, counts) = \
                self._assignments(xt)
            x_s = xt[tok_s]
            y = None
            start = 0
            for ex, n in enumerate(counts.tolist()):
                if n == 0:
                    continue
                rows = slice(start, start + n)
                part = self._expert_rows(
                    x_s[rows], lambda name, ex=ex: getattr(self, name)[ex])
                if y is None:
                    y = part.new_empty((k * t, d))
                y[rows] = part
                start += n
            out = self._combine(wgt_s[:, None] * y, order, k, t)
        zero = torch.zeros((), dtype=torch.float32, device=xt.device)
        return (out.to(xt.dtype), self._aux(gates, i_k),
                self._stats(i_k, zero))

    def load_balancing_loss(self, x):
        """GShard's aux loss (JAX :439-450): E * sum_e mean(gate_e) *
        mean(route1_e), softmax gates, first choice by argmax."""
        xt = x.reshape(-1, x.shape[-1])
        gates = torch.softmax(self._logits(xt), dim=-1)
        top1 = _one_hot(torch.argmax(gates, dim=-1), self.num_experts)
        return self.num_experts * torch.sum(gates.mean(dim=0)
                                            * top1.mean(dim=0))
