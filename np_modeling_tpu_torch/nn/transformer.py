"""Transformer blocks and stacks.

Counterpart of np_modeling_tpu/nn/transformer.py ``TransformerEncoderBlock``
(sequential form, pre-norm or with ``norm_first=False`` post-norm):
``norm1``, ``self_attention``, ``norm2`` and the FFN. ``norm`` is ``"layer"`` (LayerNorm) or ``"rms"`` (RMSNorm, with
``rms_offset`` Gemma's ``gamma + 1`` gain). ``ffn="mlp"`` is
``dense2(dense1(y))`` (``dense1`` carries the activation); ``"swiglu"`` /
``"geglu"`` is the gated FFN ``w_down(act(y w_gate) * (y w_up))``, biasless,
with silu or tanh-gelu (JAX :189-197), its weights under ``swiglu``.
``sandwich_norm`` (Gemma-2) adds ``post_norm1``/``post_norm2`` on each
sublayer's output before its residual add (JAX :255-278). ``mla`` (a dict
of ``MLAttention`` dims: kv_lora_rank, q_lora_rank, qk_nope_head_dim,
qk_rope_head_dim, v_head_dim, and the GPT's rope_base / rope_scaling)
replaces the attention by DeepSeek-V2's latent attention, which composes
with no window, softcap, qk_norm or sandwich norm (JAX :82-90).
``moe_experts`` > 0 puts the routed ``moe`` (``nn.MoE``, from the ``moe_*``
fields: ``ffn`` is its expert form, ``moe_hidden_units`` its expert width)
in the FFN's place (JAX :131-145). ``forward`` is
the dense path, in JAX's order of dropout (salt 1 before ``norm1``, salt 2
before ``norm2``), norm, sublayer and residual; the serving engine's
``_block_step`` composes the same modules around paged attention.

``TransformerDecoderBlock`` (self-attention, cross-attention over an
encoder memory, FFN; JAX :293-390), ``TransformerEncoder`` and
``TransformerDecoder`` (stacks keyed ``layer_{i}``, each layer's rngs
with its index folded in; JAX :393-472) are the JAX stacks that
``models.Seq2Seq`` pairs. Their ``mask`` / ``self_mask`` / ``cross_mask``
run K1's mask option on the card in the forward; with gradients the flash
kernels raise (the mask's backward, ROADMAP.md Queue 2 A).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn import initializers
from np_modeling_tpu_torch.nn.attention import MultiHeadAttention
from np_modeling_tpu_torch.nn.linear import (Dense, Dropout, LayerNorm,
                                             Linear, RMSNorm)
from np_modeling_tpu_torch.nn.mla import MLAttention
from np_modeling_tpu_torch.nn.moe import MoE
from np_modeling_tpu_torch.nn.module import maybe_cast, split_rngs


class GatedFFN(nn.Module):
    """The gated FFN's weights, at JAX's paths ``swiglu/w_gate`` [d, h],
    ``swiglu/w_up`` [d, h] and ``swiglu/w_down`` [h, d]."""

    def __init__(self, features: int, hidden_units: int, device=None):
        super().__init__()
        for name, shape in (("w_gate", (features, hidden_units)),
                            ("w_up", (features, hidden_units)),
                            ("w_down", (hidden_units, features))):
            setattr(self, name, nn.Parameter(torch.empty(
                shape, dtype=torch.float32, device=device)))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        for w in (self.w_gate, self.w_up, self.w_down):
            w.copy_(initializers.lecun_normal(generator, w.shape))
        return self


class TransformerEncoderBlock(nn.Module):
    def __init__(self, features: int, num_heads: int, hidden_units: int,
                 num_kv_heads: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None,
                 activation: str = "relu", ln_eps: float = 1e-3,
                 use_bias: bool = True, qkv_bias: Optional[bool] = None,
                 head_dim: Optional[int] = None, causal: bool = False,
                 drop_rate: float = 0.0, norm: str = "layer",
                 rms_offset: bool = False, ffn: str = "mlp",
                 sandwich_norm: bool = False, rope: bool = False,
                 rope_base: float = 10000.0, rope_dim: Optional[int] = None,
                 window: Optional[int] = None,
                 attn_scale: Optional[float] = None,
                 attn_softcap: Optional[float] = None,
                 norm_first: bool = True, mla: Optional[dict] = None,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: Optional[float] = 1.25,
                 moe_router_weights: str = "default",
                 moe_routed_scaling: float = 1.0, moe_shared_units: int = 0,
                 moe_router_groups=None, moe_router_score: str = "softmax",
                 moe_router_select_bias: bool = False,
                 moe_group_metric: str = "max",
                 moe_hidden_units: Optional[int] = None,
                 moe_router_bias: bool = False, device=None):
        super().__init__()
        if ffn not in ("mlp", "swiglu", "geglu") and not (
                moe_experts and ffn == "glu_clamp"):
            raise NotImplementedError(f"ffn {ffn!r} is not ported")
        if sandwich_norm and not norm_first:
            raise ValueError("sandwich_norm is a pre-norm form (JAX asserts)")
        self.dtype, self.ffn, self.sandwich_norm = dtype, ffn, sandwich_norm
        self.norm_first = norm_first
        if mla is not None:
            if window is not None or attn_softcap is not None \
                    or sandwich_norm:
                raise ValueError("MLA composes with none of: sliding "
                                 "windows, softcap, qk_norm, sandwich_norm "
                                 "(they would be silently dropped; JAX "
                                 "asserts)")
            self.self_attention = MLAttention(
                features, num_heads, causal=causal, dtype=dtype,
                ln_eps=ln_eps, device=device, **mla)
        else:
            self.self_attention = MultiHeadAttention(
                features, num_heads, num_kv_heads, head_dim=head_dim,
                use_bias=use_bias, qkv_bias=qkv_bias, causal=causal,
                dtype=dtype, rope=rope, rope_base=rope_base,
                rope_dim=rope_dim, window=window, attn_scale=attn_scale,
                attn_softcap=attn_softcap, device=device)
        self.drop = Dropout(drop_rate)

        def make_norm():
            if norm == "rms":
                return RMSNorm(features, ln_eps, rms_offset, device)
            return LayerNorm(features, ln_eps, device)

        self.norm1, self.norm2 = make_norm(), make_norm()
        if sandwich_norm:
            self.post_norm1, self.post_norm2 = make_norm(), make_norm()
        self.moe_experts = moe_experts
        if moe_experts:
            self.moe = MoE(features, moe_experts,
                           moe_hidden_units or hidden_units,
                           capacity_factor=moe_capacity_factor,
                           router_top_k=moe_top_k, activation=activation,
                           ffn=ffn, router_weights=moe_router_weights,
                           routed_scaling=moe_routed_scaling,
                           shared_experts_units=moe_shared_units,
                           router_groups=moe_router_groups,
                           router_bias=moe_router_bias,
                           router_score=moe_router_score,
                           router_select_bias=moe_router_select_bias,
                           router_group_metric=moe_group_metric,
                           device=device)
        elif ffn == "mlp":
            self.dense1 = Dense(features, hidden_units, activation, use_bias,
                                dtype, device)
            self.dense2 = Linear(hidden_units, features, use_bias, dtype,
                                 device)
        else:
            self.swiglu = GatedFFN(features, hidden_units, device)
            self._act = ops.silu if ffn == "swiglu" else ops.gelu

    def init(self, generator: torch.Generator):
        for m in self.children():
            m.init(generator)
        return self

    def _ffn(self, y):
        if self.ffn == "mlp":
            return self.dense2(self.dense1(y))
        w = self.swiglu
        yc = maybe_cast(y, self.dtype)
        gate = self._act(ops.linear(yc, maybe_cast(w.w_gate, self.dtype)))
        up = ops.linear(yc, maybe_cast(w.w_up, self.dtype))
        return ops.linear(gate * up, maybe_cast(w.w_down, self.dtype))

    def init_cache(self, batch, max_len, features, dtype=torch.float32):
        return self.self_attention.init_cache(batch, max_len, features,
                                              dtype)

    def forward(self, x, training: bool = False, rngs=None,
                segment_ids=None, positions=None, cache=None, decode=False,
                collect_kv=False, mask=None, collect_aux=False):
        """``segment_ids`` [b, s]: packed documents, each attending only
        within itself (JAX :255-257); ``positions`` ([s] or [b, s]): the
        RoPE positions (default ``arange(s)``); ``mask`` [b|1, h|1, s, s]
        (True = attend). ``decode=True`` attends through ``cache`` and
        returns ``(out, cache)``; ``collect_kv=True`` returns ``(out, (k,
        v))`` (``MultiHeadAttention.forward``); else ``collect_aux=True``
        returns ``(out, aux)``, the MoE's load-balancing aux (fp32 0 for a
        dense block)."""
        pre = self.norm_first
        skip = x            # the residual skips the dropout
        if pre:
            x = self.norm1(self.drop(x, training, rngs, salt=1))
        y = self.self_attention(x, mask=mask, segment_ids=segment_ids,
                                positions=positions, cache=cache,
                                decode=decode, collect_kv=collect_kv)
        extra = None
        if decode or collect_kv:
            y, extra = y
        if self.sandwich_norm:
            y = self.post_norm1(y)
        y = y + skip
        if not pre:
            y = self.norm1(self.drop(y, training, rngs, salt=1))
        skip = y
        if pre:
            y = self.norm2(self.drop(y, training, rngs, salt=2))
        aux = None
        if self.moe_experts:
            y, aux = self.moe.apply_with_aux(y)
        else:
            y = self._ffn(y)
        if self.sandwich_norm:
            y = self.post_norm2(y)
        y = y + skip
        if not pre:
            y = self.norm2(self.drop(y, training, rngs, salt=2))
        if extra is not None:
            return y, extra
        if collect_aux:
            if aux is None:
                aux = torch.zeros((), dtype=torch.float32, device=y.device)
            return y, aux
        return y


class TransformerDecoderBlock(nn.Module):
    """JAX :293-390: ``self_attention`` (causal if asked), then
    ``cross_attention`` over the encoder memory, then the FFN ``dense1`` (a
    relu Dense) and ``dense2``, each with its LayerNorm (``norm1..3``, eps
    1e-3) and residual, pre-norm or post-norm, dropout salts 1, 2, 3."""

    def __init__(self, features: int, num_heads: int, hidden_units: int,
                 norm_first: bool = True, drop_rate: float = 0.0,
                 causal: bool = False, device=None):
        super().__init__()
        self.norm_first = norm_first
        self.self_attention = MultiHeadAttention(features, num_heads,
                                                 causal=causal, device=device)
        self.cross_attention = MultiHeadAttention(features, num_heads,
                                                  device=device)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(features,
                                                        device=device)
                                              for _ in range(3))
        self.dense1 = Dense(features, hidden_units, device=device)
        self.dense2 = Linear(hidden_units, features, device=device)
        self.drop = Dropout(drop_rate)

    def init(self, generator: torch.Generator):
        for m in self.children():
            m.init(generator)
        return self

    def forward(self, q, kv, self_mask=None, cross_mask=None,
                training: bool = False, rngs=None, cache=None, decode=False,
                cross_segment_ids=None):
        """``q`` [b, s, d] over the memory ``kv`` [b, skv, d];
        ``cross_segment_ids``: (q_seg [b, s], kv_seg [b, skv]), e.g. (ones,
        src_valid) to mask a padded memory inside the flash kernels.
        ``decode=True`` runs the self-attention through ``cache`` and
        returns ``(out, cache)``."""
        pre = self.norm_first

        def sub(y, salt, norm, fn):
            skip = y
            if pre:
                y = norm(self.drop(y, training, rngs, salt=salt))
            y = fn(y) + skip
            if not pre:
                y = norm(self.drop(y, training, rngs, salt=salt))
            return y

        new_cache = []

        def attend(y):
            out = self.self_attention(y, mask=self_mask, cache=cache,
                                      decode=decode)
            if decode:
                out, c = out
                new_cache.append(c)
            return out

        y = sub(q, 1, self.norm1, attend)
        y = sub(y, 2, self.norm2, lambda y: self.cross_attention(
            y, kv, mask=cross_mask, segment_ids=cross_segment_ids))
        y = sub(y, 3, self.norm3, lambda y: self.dense2(self.dense1(y)))
        if decode:
            return y, new_cache[0]
        return y

    def init_cache(self, batch, max_len, features, dtype=torch.float32):
        return self.self_attention.init_cache(batch, max_len, features,
                                              dtype)


class TransformerEncoder(nn.Module):
    """JAX :393-433: ``num_layers`` blocks ``layer_{i}`` (relu MLP FFN,
    biased, LayerNorm eps 1e-3), layer i with ``split_rngs(rngs, i)``."""

    def __init__(self, features: int, num_layers: int, num_heads: int,
                 hidden_units: int, norm_first: bool = True,
                 drop_rate: float = 0.0, causal: bool = False, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderBlock(
                features, num_heads, hidden_units, causal=causal,
                drop_rate=drop_rate, norm_first=norm_first, device=device))

    def init(self, generator: torch.Generator):
        for m in self.children():
            m.init(generator)
        return self

    def forward(self, x, mask=None, training: bool = False, rngs=None,
                caches=None, decode=False, segment_ids=None):
        new_caches = [] if decode else None
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            r = split_rngs(rngs, i)
            if decode:
                x, c = layer(x, training, r, cache=caches[i], decode=True,
                             mask=mask)
                new_caches.append(c)
            else:
                x = layer(x, training, r, segment_ids=segment_ids, mask=mask)
        return (x, new_caches) if decode else x

    def init_cache(self, batch, max_len, features, dtype=torch.float32):
        return [getattr(self, f"layer_{i}").init_cache(batch, max_len,
                                                       features, dtype)
                for i in range(self.num_layers)]


class TransformerDecoder(nn.Module):
    """JAX :436-472: ``num_layers`` decoder blocks ``layer_{i}`` (causal
    self-attention by default), layer i with ``split_rngs(rngs, i)``."""

    def __init__(self, features: int, num_layers: int, num_heads: int,
                 hidden_units: int, norm_first: bool = True,
                 drop_rate: float = 0.0, causal: bool = True, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerDecoderBlock(
                features, num_heads, hidden_units, norm_first, drop_rate,
                causal, device))

    def init(self, generator: torch.Generator):
        for m in self.children():
            m.init(generator)
        return self

    def forward(self, q, kv, self_mask=None, cross_mask=None,
                training: bool = False, rngs=None, caches=None,
                decode=False, cross_segment_ids=None):
        new_caches = [] if decode else None
        for i in range(self.num_layers):
            out = getattr(self, f"layer_{i}")(
                q, kv, self_mask, cross_mask, training, split_rngs(rngs, i),
                cache=caches[i] if decode else None, decode=decode,
                cross_segment_ids=cross_segment_ids)
            if decode:
                q, c = out
                new_caches.append(c)
            else:
                q = out
        return (q, new_caches) if decode else q

    def init_cache(self, batch, max_len, features, dtype=torch.float32):
        return [getattr(self, f"layer_{i}").init_cache(batch, max_len,
                                                       features, dtype)
                for i in range(self.num_layers)]
