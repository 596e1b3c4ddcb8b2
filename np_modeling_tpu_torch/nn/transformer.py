"""Transformer block, pre-norm, MLP FFN.

Counterpart of np_modeling_tpu/nn/transformer.py ``TransformerEncoderBlock``
(pre-norm form): ``norm1``, ``self_attention``, ``norm2`` and the ``mlp``
FFN ``dense2(dense1(y))`` (``dense1`` carries the activation). ``forward``
is the dense path, in JAX's order of dropout (salt 1 before ``norm1``, salt
2 before ``norm2``), norm, sublayer and residual (JAX :243-278); the
serving engine's ``_block_step`` composes the same modules around paged
attention.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from np_modeling_tpu_torch.nn.attention import MultiHeadAttention
from np_modeling_tpu_torch.nn.linear import Dense, Dropout, LayerNorm, Linear


class TransformerEncoderBlock(nn.Module):
    def __init__(self, features: int, num_heads: int, hidden_units: int,
                 num_kv_heads: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None,
                 activation: str = "relu", ln_eps: float = 1e-3,
                 use_bias: bool = True, qkv_bias: Optional[bool] = None,
                 head_dim: Optional[int] = None, causal: bool = False,
                 drop_rate: float = 0.0, device=None):
        super().__init__()
        self.dtype = dtype
        self.self_attention = MultiHeadAttention(
            features, num_heads, num_kv_heads, head_dim=head_dim,
            use_bias=use_bias, qkv_bias=qkv_bias, causal=causal, dtype=dtype,
            device=device)
        self.drop = Dropout(drop_rate)
        self.norm1 = LayerNorm(features, ln_eps, device)
        self.norm2 = LayerNorm(features, ln_eps, device)
        self.dense1 = Dense(features, hidden_units, activation, use_bias,
                            dtype, device)
        self.dense2 = Linear(hidden_units, features, use_bias, dtype, device)

    def init(self, generator: torch.Generator):
        for m in (self.self_attention, self.norm1, self.norm2, self.dense1,
                  self.dense2):
            m.init(generator)
        return self

    def _ffn(self, y):
        return self.dense2(self.dense1(y))

    def forward(self, x, training: bool = False, rngs=None,
                segment_ids=None):
        """``segment_ids`` [b, s]: packed documents, each attending only
        within itself (JAX :255-257)."""
        skip = x            # the residual skips the dropout
        y = self.self_attention(self.norm1(self.drop(x, training, rngs,
                                                     salt=1)),
                                segment_ids=segment_ids) + skip
        skip = y
        y = self._ffn(self.norm2(self.drop(y, training, rngs, salt=2)))
        return y + skip
