"""Multi-head attention parameters and projections (MHA and GQA).

Counterpart of np_modeling_tpu/nn/attention.py ``MultiHeadAttention`` with
its parameter layout: wq [d, hq, dk], wk/wv [d, hkv, dk], wo [hq, dk, d],
bq [hq, dk], bk/bv [hkv, dk], bo [d]. The serving engine uses ``_dims``,
``_project`` and ``_rope`` around paged attention; ``forward`` is the dense
self-attention path of the JAX ``apply`` (no cache, no ``attn_impl``), over
``ops.flash_attention``. The score options are JAX's: ``rope`` (with
``rope_base``, ``rope_dim``) rotates q and k, ``window`` slides a causal
window, ``attn_scale`` replaces 1/sqrt(dk) and ``attn_softcap`` caps the
scaled scores.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn import initializers
from np_modeling_tpu_torch.nn.module import maybe_cast


class MultiHeadAttention(nn.Module):
    def __init__(self, features: int, num_heads: int,
                 num_kv_heads: Optional[int] = None,
                 head_dim: Optional[int] = None, use_bias: bool = True,
                 qkv_bias: Optional[bool] = None, causal: bool = False,
                 dtype: Optional[torch.dtype] = None, rope: bool = False,
                 rope_base: float = 10000.0, rope_dim: Optional[int] = None,
                 window: Optional[int] = None,
                 attn_scale: Optional[float] = None,
                 attn_softcap: Optional[float] = None, device=None):
        super().__init__()
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim, self.dtype, self.causal = head_dim, dtype, causal
        self.rope, self.rope_base, self.rope_dim = rope, rope_base, rope_dim
        self.window, self.attn_scale = window, attn_scale
        self.attn_softcap = attn_softcap
        hq, hkv, dk = self._dims(features)
        shapes = {"wq": (features, hq, dk), "wk": (features, hkv, dk),
                  "wv": (features, hkv, dk), "wo": (hq, dk, features)}
        if use_bias if qkv_bias is None else qkv_bias:
            shapes.update(bq=(hq, dk), bk=(hkv, dk), bv=(hkv, dk))
        if use_bias:
            shapes["bo"] = (features,)
        for name in ("bq", "bk", "bv", "bo"):
            setattr(self, name, None)
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(
                shape, dtype=torch.float32, device=device)))

    def _dims(self, features):
        hq = self.num_heads
        hkv = self.num_kv_heads or hq
        dk = self.head_dim or features // hq
        if hq % hkv:
            raise ValueError(f"{hq} q heads do not group over {hkv} kv heads")
        return hq, hkv, dk

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        for name in ("wq", "wk", "wv", "wo"):
            w = getattr(self, name)
            w.copy_(initializers.lecun_normal(generator, w.shape))
        for name in ("bq", "bk", "bv", "bo"):
            b = getattr(self, name)
            if b is not None:
                b.copy_(initializers.zeros(generator, b.shape))
        return self

    def _project(self, x, w, b):
        """[b, s, d] @ [d, h, dk] -> [b, h, s, dk] (a view of the product)."""
        x, w, b = (maybe_cast(a, self.dtype) for a in (x, w, b))
        d, h, dk = w.shape
        y = ops.linear(x, w.reshape(d, h * dk),
                       b.reshape(h * dk) if b is not None else None)
        return y.reshape(*x.shape[:-1], h, dk).transpose(-3, -2)

    def _rope(self, t, positions):
        """RoPE on [b, h, s, dk] at ``positions`` ([s] or [b, s]), if the
        module rotates."""
        if not self.rope:
            return t
        return ops.apply_rope(t, positions, self.rope_base, self.rope_dim)

    def forward(self, x, segment_ids=None, positions=None):
        """Dense self-attention over [b, s, d]: projections, RoPE at
        ``positions`` (default ``arange(s)``), flash attention (causal if
        the module is; with ``segment_ids`` [b, s] a position attends only
        within its segment), output projection."""
        q = self._project(x, self.wq, self.bq)
        k = self._project(x, self.wk, self.bk)
        v = self._project(x, self.wv, self.bv)
        if self.rope and positions is None:
            positions = torch.arange(q.shape[2], device=q.device)
        q, k = self._rope(q, positions), self._rope(k, positions)
        o = ops.flash_attention(q, k, v, segment_ids=segment_ids,
                                causal=self.causal, window=self.window,
                                scale=self.attn_scale,
                                softcap=self.attn_softcap)
        wo, bo = maybe_cast(self.wo, self.dtype), maybe_cast(self.bo,
                                                             self.dtype)
        hq, dk, d_out = wo.shape
        o = o.transpose(-3, -2)
        o = o.reshape(*o.shape[:-2], hq * dk)
        return ops.linear(o, wo.reshape(hq * dk, d_out), bo)
