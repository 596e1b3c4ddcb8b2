"""Multi-head attention parameters and projections (MHA and GQA).

Counterpart of np_modeling_tpu/nn/attention.py ``MultiHeadAttention`` with
its parameter layout: wq [d, hq, dk], wk/wv [d, hkv, dk], wo [hq, dk, d],
bq [hq, dk], bk/bv [hkv, dk], bo [d]; ``kv_features`` (default
``features``) sizes wk/wv for cross-attention over a memory of another
width. The serving engine uses ``_dims``, ``_project`` and ``_rope`` around
paged attention; ``forward`` is the JAX ``apply`` (no ``attn_impl``) over
``ops.flash_attention``: self- or cross-attention (``key``/``value``), with
a boolean ``mask``, an additive score ``bias`` (T5's relative positions;
the bias option of the flash kernels on the card) and segment ids (one
[b, s] array, or a (q, kv) pair), dense or (``decode=True``) through a
dense KV cache from ``init_cache``, whose written slots reach the kernel as
a mask (K1's mask option on the card), or over ``precomputed_kv``. The
score options are JAX's: ``rope`` (with ``rope_base``, ``rope_dim`` and
``rope_scaling``, YaRN's tuple or None) rotates q and k, ``window`` slides a
causal window, ``attn_scale`` replaces 1/sqrt(dk), ``attn_softcap`` caps
the scaled scores and ``attn_sinks`` (gpt-oss) adds ``sinks`` [hq], fp32,
zero-initialised: a per-q-head logit that joins each row's softmax as a key
with no value (JAX :116-117).
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
                 attn_softcap: Optional[float] = None,
                 kv_features: Optional[int] = None,
                 rope_scaling: Optional[tuple] = None,
                 attn_sinks: bool = False, device=None):
        super().__init__()
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim, self.dtype, self.causal = head_dim, dtype, causal
        self.rope, self.rope_base, self.rope_dim = rope, rope_base, rope_dim
        self.rope_scaling = rope_scaling
        self.window, self.attn_scale = window, attn_scale
        self.attn_softcap = attn_softcap
        hq, hkv, dk = self._dims(features)
        d_kv = kv_features or features
        shapes = {"wq": (features, hq, dk), "wk": (d_kv, hkv, dk),
                  "wv": (d_kv, hkv, dk), "wo": (hq, dk, features)}
        if use_bias if qkv_bias is None else qkv_bias:
            shapes.update(bq=(hq, dk), bk=(hkv, dk), bv=(hkv, dk))
        if use_bias:
            shapes["bo"] = (features,)
        if attn_sinks:
            shapes["sinks"] = (hq,)
        for name in ("bq", "bk", "bv", "bo", "sinks"):
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
        for name in ("bq", "bk", "bv", "bo", "sinks"):
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
        return ops.apply_rope(t, positions, self.rope_base, self.rope_dim,
                              self.rope_scaling)

    def forward(self, x, key=None, value=None, mask=None, segment_ids=None,
                positions=None, cache=None, decode=False, collect_kv=False,
                bias=None, precomputed_kv=None):
        """Attention of ``x`` [b, s, d] over ``key`` (default ``x``) and
        ``value`` (default ``key``): projections, RoPE, flash attention,
        output projection (JAX :160-260). Dense (the default): RoPE at
        ``positions`` (default ``arange(s)``), causal if the module is,
        ``mask`` [b|1, h|1, s, skv] (True = attend), ``bias`` [b|1, h|1, s,
        skv] added to the scores, and ``segment_ids`` ([b, s], or a (q_seg,
        kv_seg) pair for cross-attention): a position attends only within
        its segment. ``decode=True`` (JAX :212-236): RoPE at the cache's
        write positions, k and v written into ``cache`` at its ``index``,
        and non-causal attention over the whole cache under the mask of the
        written slots (and the window), which replaces ``mask`` as in JAX,
        with ``bias`` [.., s, L] over the cache's slots; returns ``(out,
        cache)`` with the index advanced. ``collect_kv=True`` returns
        ``(out, (k, v))``, k and v [b, hkv, s, dk] after RoPE (serving
        prefill seeds pages with them). ``precomputed_kv``: (k, v) already
        projected, [b, hkv, skv, dk] (an encoder memory's, projected once
        for every decode step, JAX :178-199); q is projected without RoPE,
        as JAX does."""
        if key is None:
            key = x
        if value is None:
            value = key
        q = self._project(x, self.wq, self.bq)
        if precomputed_kv is not None:
            if cache is not None or collect_kv:
                raise ValueError("precomputed_kv takes no cache or collect_kv")
            k, v = precomputed_kv
            o = ops.flash_attention(q, k, v, mask=mask, bias=bias,
                                    segment_ids=segment_ids,
                                    causal=self.causal, window=self.window,
                                    scale=self.attn_scale,
                                    softcap=self.attn_softcap,
                                    sinks=self.sinks)
            return self._out(o)
        k = self._project(key, self.wk, self.bk)
        v = self._project(value, self.wv, self.bv)
        if decode:
            if cache is None:
                raise ValueError("decode=True requires a cache; build one "
                                 "with init_cache()")
            if self.rope:
                positions = cache_positions(cache["index"], q.shape[2],
                                            q.device)
        elif self.rope and positions is None:
            positions = torch.arange(q.shape[2], device=q.device)
        q, k = self._rope(q, positions), self._rope(k, positions)
        if decode:
            k, v, mask, cache = self._update_cache(cache, k, v)
            # Mixed dtypes promote, as JAX's einsums do (a bf16 model over
            # an fp32 cache attends in fp32); o returns in q's dtype.
            dt = torch.promote_types(q.dtype, k.dtype)
            o = ops.flash_attention(q.to(dt), k.to(dt), v.to(dt), mask=mask,
                                    bias=bias, causal=False,
                                    scale=self.attn_scale,
                                    softcap=self.attn_softcap,
                                    sinks=self.sinks).to(q.dtype)
        else:
            o = ops.flash_attention(q, k, v, mask=mask, bias=bias,
                                    segment_ids=segment_ids,
                                    causal=self.causal, window=self.window,
                                    scale=self.attn_scale,
                                    softcap=self.attn_softcap,
                                    sinks=self.sinks)
        out = self._out(o)
        if decode:
            return out, cache
        if collect_kv:
            return out, (k, v)
        return out

    def _out(self, o):
        """The output projection of o [b, hq, s, dk]."""
        wo, bo = maybe_cast(self.wo, self.dtype), maybe_cast(self.bo,
                                                             self.dtype)
        hq, dk, d_out = wo.shape
        o = o.transpose(-3, -2)
        o = o.reshape(*o.shape[:-2], hq * dk)
        return ops.linear(o, wo.reshape(hq * dk, d_out), bo)

    # ---- the dense KV cache (JAX :270-311) ------------------------------

    def init_cache(self, batch, max_len, features, dtype=torch.float32):
        """Zeroed k/v [batch, hkv, max_len, dk] on the weights' device and
        write index 0 (a Python int; a [batch] int tensor there gives each
        row its own)."""
        _, hkv, dk = self._dims(features)
        shape = (batch, hkv, max_len, dk)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.wq.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.wq.device),
                "index": 0}

    def _update_cache(self, cache, k_new, v_new):
        """Write the step's k/v at ``cache['index']`` (in place) and build
        the mask of the slots each query position sees: slots <= its own,
        and with a window the last ``window`` of them. The index is a scalar
        (every row writes at one position: [1, 1, s, L] mask) or per row,
        a [b] tensor ([b, 1, s, L] mask). As JAX's dynamic_update_slice, a
        write that would run past the cache starts at ``L - s``; the mask
        follows the index as given. Returns (k, v, mask, new cache)."""
        idx = cache["index"]
        ck, cv = cache["k"], cache["v"]
        s_new, max_len = k_new.shape[2], ck.shape[2]
        dev = ck.device
        kv_pos = torch.arange(max_len, device=dev)
        q_iota = torch.arange(s_new, device=dev)
        if not (torch.is_tensor(idx) and idx.dim() == 1):
            i = int(idx)
            start = min(max(i, 0), max_len - s_new)
            ck[:, :, start:start + s_new] = k_new.to(ck.dtype)
            cv[:, :, start:start + s_new] = v_new.to(cv.dtype)
            q_pos = (i + q_iota)[:, None]                    # [s, 1]
            keep = kv_pos[None] <= q_pos
            if self.window is not None:
                keep = keep & (kv_pos[None] > q_pos - self.window)
            mask = keep[None, None]                          # [1, 1, s, L]
        else:
            idx = idx.to(device=dev, dtype=torch.long)
            start = idx.clamp(0, max_len - s_new)
            rows = torch.arange(ck.shape[0], device=dev)[:, None]
            cols = start[:, None] + q_iota                   # [b, s]
            ck[rows, :, cols] = k_new.transpose(1, 2).to(ck.dtype)
            cv[rows, :, cols] = v_new.transpose(1, 2).to(cv.dtype)
            q_pos = (idx[:, None] + q_iota)[:, :, None]      # [b, s, 1]
            keep = kv_pos[None, None] <= q_pos
            if self.window is not None:
                keep = keep & (kv_pos[None, None] > q_pos - self.window)
            mask = keep[:, None]                             # [b, 1, s, L]
        new_cache = {"k": ck, "v": cv, "index": cache["index"] + s_new}
        return ck, cv, mask, new_cache


def cache_positions(idx, s, device):
    """The positions of ``s`` tokens written at a cache index: [s] for a
    scalar index (an int or a 0-d tensor), [b, s] for a [b] one."""
    if torch.is_tensor(idx) and idx.dim() == 1:
        return idx.to(device=device, dtype=torch.long)[:, None] \
            + torch.arange(s, device=device)
    i = int(idx)
    return torch.arange(i, i + s, device=device)
