"""Transformer block, pre-norm.

Counterpart of np_modeling_tpu/nn/transformer.py ``TransformerEncoderBlock``
(pre-norm, sequential form): ``norm1``, ``self_attention``, ``norm2`` and
the FFN. ``norm`` is ``"layer"`` (LayerNorm) or ``"rms"`` (RMSNorm, with
``rms_offset`` Gemma's ``gamma + 1`` gain). ``ffn="mlp"`` is
``dense2(dense1(y))`` (``dense1`` carries the activation); ``"swiglu"`` /
``"geglu"`` is the gated FFN ``w_down(act(y w_gate) * (y w_up))``, biasless,
with silu or tanh-gelu (JAX :189-197), its weights under ``swiglu``.
``sandwich_norm`` (Gemma-2) adds ``post_norm1``/``post_norm2`` on each
sublayer's output before its residual add (JAX :255-278). ``forward`` is
the dense path, in JAX's order of dropout (salt 1 before ``norm1``, salt 2
before ``norm2``), norm, sublayer and residual; the serving engine's
``_block_step`` composes the same modules around paged attention.
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
from np_modeling_tpu_torch.nn.module import maybe_cast


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
                 attn_softcap: Optional[float] = None, device=None):
        super().__init__()
        if ffn not in ("mlp", "swiglu", "geglu"):
            raise NotImplementedError(f"ffn {ffn!r} is not ported")
        self.dtype, self.ffn, self.sandwich_norm = dtype, ffn, sandwich_norm
        self.self_attention = MultiHeadAttention(
            features, num_heads, num_kv_heads, head_dim=head_dim,
            use_bias=use_bias, qkv_bias=qkv_bias, causal=causal, dtype=dtype,
            rope=rope, rope_base=rope_base, rope_dim=rope_dim, window=window,
            attn_scale=attn_scale, attn_softcap=attn_softcap, device=device)
        self.drop = Dropout(drop_rate)

        def make_norm():
            if norm == "rms":
                return RMSNorm(features, ln_eps, rms_offset, device)
            return LayerNorm(features, ln_eps, device)

        self.norm1, self.norm2 = make_norm(), make_norm()
        if sandwich_norm:
            self.post_norm1, self.post_norm2 = make_norm(), make_norm()
        if ffn == "mlp":
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

    def forward(self, x, training: bool = False, rngs=None,
                segment_ids=None, positions=None):
        """``segment_ids`` [b, s]: packed documents, each attending only
        within itself (JAX :255-257); ``positions`` ([s] or [b, s]): the
        RoPE positions (default ``arange(s)``)."""
        skip = x            # the residual skips the dropout
        y = self.self_attention(self.norm1(self.drop(x, training, rngs,
                                                     salt=1)),
                                segment_ids=segment_ids, positions=positions)
        if self.sandwich_norm:
            y = self.post_norm1(y)
        y = y + skip
        skip = y
        y = self._ffn(self.norm2(self.drop(y, training, rngs, salt=2)))
        if self.sandwich_norm:
            y = self.post_norm2(y)
        return y + skip
