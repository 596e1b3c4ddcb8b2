"""MLA: multi-head latent attention (DeepSeek-V2) with an absorbed,
latent-cache decode path.

Counterpart of np_modeling_tpu/nn/mla.py ``MLAttention``, with its
parameter layout (all biasless): ``wq`` [d, hq, nope + rope] (no
``q_lora_rank``), or ``q_a`` [d, q_rank] + ``q_a_norm.gamma`` + ``q_b``
[q_rank, hq, nope + rope]; ``kv_a`` [d, rank + rope], ``kv_a_norm.gamma``
[rank]; ``kv_b`` [rank, hq, nope + v]; ``wo`` [hq, v, d]. Per token the
cache holds ``kv_lora_rank + qk_rope_head_dim`` numbers: the RMSNorm'd
latent c_kv and one rope key shared by every head.

``forward`` (JAX ``apply``) is one flash-attention call over concatenated
features, concat(q_nope, q_pe) . concat(k_nope, k_pe), with v zero-padded
to the qk head dim (:175-194). ``decode=True`` runs the absorbed form over
a latent cache from ``init_cache`` (:198-241): q_nope goes through kv_b's
k half (q_abs . c_kv == q_nope . k_nope), the latent row is both key and
value, and the latent output expands through kv_b's v half. The scale is
``qk_head_dim ** -0.5`` in both, although the absorbed dot is rank + rope
wide. The casts are JAX's: ``maybe_cast`` on x and the weights, the
latent's RMSNorm in fp32.

On the card the dense form runs the flash kernels at head dim nope + rope
(192 for DeepSeek-V2: K1 or K12 forward, K2 or K5 backward). The absorbed
decode runs the paged kernel's latent option (K3 at rank + rope = 576, one
row as key and value), as the serving engine does (``serving/engine.py``):
the dense cache is viewed, without a copy, as pages of one sequence's rows
(``init_cache`` pads a sequence's rows to a multiple of 8 for that), with
causal rows from the write index. On the CPU the same call runs K3's plain
version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn import initializers
from np_modeling_tpu_torch.nn.attention import cache_positions
from np_modeling_tpu_torch.nn.linear import RMSNorm
from np_modeling_tpu_torch.nn.module import maybe_cast

# A sequence's rows in the latent cache are padded to a multiple of ROW_ALIGN,
# the smallest page size the paged kernel takes.
ROW_ALIGN = 8


def _padded_rows(max_len):
    return -(-max_len // ROW_ALIGN) * ROW_ALIGN


def latent_pages(k):
    """The latent cache ``k`` [b, 1, max_len, w] as pages of the paged
    kernel, without a copy: (pages [1, b * rows / ps, ps, w], the page
    table [b, rows / ps] int32, so that sequence i's rows are its pages in
    order), where each sequence's rows lie ``rows`` (a multiple of 8 and
    at least max_len) apart and ps is the largest power of two up to 128
    that divides rows; or None where ``k``'s layout does not allow it."""
    b, _, max_len, w = k.shape
    rows = k.stride(0) // w if b > 1 else _padded_rows(max_len)
    if k.stride(3) != 1 or k.stride(2) != w or rows % ROW_ALIGN \
            or rows < max_len or (b > 1 and k.stride(0) != rows * w) \
            or k.storage_offset() + b * rows * w > (
                k.untyped_storage().nbytes() // k.element_size()):
        return None
    ps = 128
    while rows % ps:
        ps //= 2
    pages = k.as_strided((1, b * rows // ps, ps, w), (b * rows * w, ps * w,
                                                       w, 1))
    table = torch.arange(b * rows // ps, dtype=torch.int32,
                         device=k.device).reshape(b, rows // ps)
    return pages, table


def _latent_cache(b, max_len, w, dtype, device):
    """A zeroed cache [b, 1, max_len, w] whose sequences' rows are padded to
    a multiple of ROW_ALIGN (a view of the padded buffer)."""
    return torch.zeros((b, 1, _padded_rows(max_len), w), dtype=dtype,
                       device=device)[:, :, :max_len]


class MLAttention(nn.Module):
    def __init__(self, features: int, num_heads: int,
                 kv_lora_rank: int = 512, q_lora_rank: Optional[int] = None,
                 qk_nope_head_dim: int = 128, qk_rope_head_dim: int = 64,
                 v_head_dim: int = 128, rope_base: float = 10000.0,
                 rope_scaling: Optional[tuple] = None, ln_eps: float = 1e-6,
                 causal: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.num_heads, self.kv_lora_rank = num_heads, kv_lora_rank
        self.q_lora_rank = q_lora_rank
        self.qk_nope_head_dim = qk_nope_head_dim
        self.qk_rope_head_dim = qk_rope_head_dim
        self.v_head_dim = v_head_dim
        self.rope_base, self.rope_scaling = rope_base, rope_scaling
        self.ln_eps, self.causal, self.dtype = ln_eps, causal, dtype
        hq, dk = num_heads, self.qk_head_dim

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                            device=device))

        self.kv_a = param(features, kv_lora_rank + qk_rope_head_dim)
        self.kv_a_norm = RMSNorm(kv_lora_rank, ln_eps, device=device)
        self.kv_b = param(kv_lora_rank, hq, qk_nope_head_dim + v_head_dim)
        self.wo = param(hq, v_head_dim, features)
        if q_lora_rank is None:
            self.wq = param(features, hq, dk)
        else:
            self.q_a = param(features, q_lora_rank)
            self.q_a_norm = RMSNorm(q_lora_rank, ln_eps, device=device)
            self.q_b = param(q_lora_rank, hq, dk)

    @property
    def qk_head_dim(self):
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_width(self):
        """Numbers a token's cache row holds: rank + rope."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        names = ["kv_a", "kv_b", "wo"] + (
            ["wq"] if self.q_lora_rank is None else ["q_a", "q_b"])
        for name in names:
            w = getattr(self, name)
            w.copy_(initializers.lecun_normal(generator, w.shape))
        self.kv_a_norm.init(generator)
        if self.q_lora_rank is not None:
            self.q_a_norm.init(generator)
        return self

    # ---- shared projections (JAX :112-159) ---------------------------------

    def _q_heads(self, x):
        """x [b, s, d] -> q [b, hq, s, nope + rope]."""
        xc = maybe_cast(x, self.dtype)
        if self.q_lora_rank is None:
            w = maybe_cast(self.wq, self.dtype)
            d, hq, dk = w.shape
            y = ops.linear(xc, w.reshape(d, hq * dk))
        else:
            a = ops.linear(xc, maybe_cast(self.q_a, self.dtype))
            a = ops.rms_norm(a.float(), self.q_a_norm.gamma, self.ln_eps)
            w = maybe_cast(self.q_b, self.dtype)
            qr, hq, dk = w.shape
            y = ops.linear(maybe_cast(a, self.dtype), w.reshape(qr, hq * dk))
        y = y.reshape(*x.shape[:-1], self.num_heads, self.qk_head_dim)
        return y.transpose(-3, -2)

    def _split_q(self, q):
        return q[..., :self.qk_nope_head_dim], q[..., self.qk_nope_head_dim:]

    def _latent(self, x):
        """x -> (c_kv [b, 1, s, rank] RMSNorm'd in fp32, k_pe [b, 1, s,
        rope] raw)."""
        y = ops.linear(maybe_cast(x, self.dtype),
                       maybe_cast(self.kv_a, self.dtype))
        c, k_pe = y[..., :self.kv_lora_rank], y[..., self.kv_lora_rank:]
        c = ops.rms_norm(c.float(), self.kv_a_norm.gamma, self.ln_eps)
        c = maybe_cast(c, self.dtype)
        return c[:, None], k_pe[:, None]          # the hkv = 1 head axis

    def _expand_kv(self, c):
        """c [b, 1, s, rank] -> (k_nope, v), each [b, hq, s, .]."""
        w = maybe_cast(self.kv_b, self.dtype)
        kv = torch.einsum("bosr,rhd->bhsd", c, w)
        return kv[..., :self.qk_nope_head_dim], kv[..., self.qk_nope_head_dim:]

    def _out(self, o):
        """o [b, hq, s, v] -> [b, s, d] through wo."""
        o = o.transpose(-3, -2)
        wo = maybe_cast(self.wo, self.dtype)
        hq, v, d = wo.shape
        o = o.reshape(*o.shape[:-2], hq * v)
        return ops.linear(o, wo.reshape(hq * v, d))

    def _rope(self, t, positions):
        return ops.apply_rope(t, positions, self.rope_base, None,
                              self.rope_scaling)

    # ---- forward (JAX :163-196) ---------------------------------------------

    def forward(self, x, mask=None, segment_ids=None, positions=None,
                cache=None, decode=False, collect_kv=False):
        """Self-attention of ``x`` [b, s, d]: causal if the module is, under
        ``mask`` and ``segment_ids``, RoPE at ``positions`` (default
        ``arange(s)``). ``decode=True`` writes the tokens' latent rows into
        ``cache`` at its index and attends through it (absorbed); returns
        ``(out, cache)``."""
        if collect_kv:
            raise ValueError("MLA caches latents, not per-head K/V: the "
                             "serving engine appends them itself")
        scale = 1.0 / math.sqrt(self.qk_head_dim)
        q_nope, q_pe = self._split_q(self._q_heads(x))
        c, k_pe = self._latent(x)
        if decode:
            return self._decode(q_nope, q_pe, c, k_pe, cache, scale)
        if positions is None:
            positions = torch.arange(x.shape[-2], device=x.device)
        q_pe, k_pe = self._rope(q_pe, positions), self._rope(k_pe, positions)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k_nope, v = self._expand_kv(c)
        k_full = torch.cat([k_nope, k_pe.expand(*k_nope.shape[:-1],
                                                self.qk_rope_head_dim)],
                           dim=-1)
        # v zero-padded to the qk head dim: one kernel serves both
        # products, and the padded output columns are exactly zero.
        v_pad = nn.functional.pad(v, (0, self.qk_head_dim - self.v_head_dim))
        o = ops.flash_attention(q, k_full, v_pad, mask=mask,
                                segment_ids=segment_ids, causal=self.causal,
                                scale=scale)
        return self._out(o[..., :self.v_head_dim])

    # ---- the absorbed latent-cache decode (JAX :198-241) --------------------

    def init_cache(self, batch, max_len, features, dtype=torch.float32):
        """A zeroed latent cache [batch, 1, max_len, rank + rope] on the
        weights' device, write index 0; a sequence's rows are padded to a
        multiple of 8 in its buffer, so that the decode reads it as pages
        (``latent_pages``)."""
        del features
        return {"k": _latent_cache(batch, max_len, self.latent_width, dtype,
                                   self.kv_a.device),
                "index": 0}

    def _decode(self, q_nope, q_pe, c, k_pe, cache, scale):
        if cache is None:
            raise ValueError("decode=True requires a cache; build one with "
                             "init_cache()")
        idx = cache["index"]
        s_new = q_pe.shape[2]
        positions = cache_positions(idx, s_new, q_pe.device)
        q_pe, k_pe = self._rope(q_pe, positions), self._rope(k_pe, positions)
        k_new = torch.cat([c, k_pe], dim=-1)            # [b, 1, s, r + rope]
        k = cache["k"]
        if latent_pages(k) is None:
            # A cache laid out otherwise (not from init_cache, or gathered
            # by beam search) moves into a padded one, once: the returned
            # cache is that one.
            k = _latent_cache(k.shape[0], k.shape[2], k.shape[3], k.dtype,
                              k.device).copy_(k)
        max_len = k.shape[2]
        i = int(idx)
        start = min(max(i, 0), max_len - s_new)          # JAX's clamp
        k[:, :, start:start + s_new] = k_new.to(k.dtype)
        new_cache = {"k": k, "index": idx + s_new}
        # q_nope absorbed through kv_b's k half: q_abs . c_kv == q_nope .
        # k_nope.
        wk = maybe_cast(self.kv_b[:, :, :self.qk_nope_head_dim], self.dtype)
        q_abs = torch.einsum("bhsn,rhn->bhsr", q_nope, wk)
        q_eff = torch.cat([q_abs, q_pe], dim=-1)        # [b, hq, s, r + rope]
        # MQA over the latent: v IS the cache row, whose first rank columns
        # of p @ row are p @ c_kv, the latent attention output. Mixed dtypes
        # promote, as JAX's einsums do (the pages keep theirs: the kernel
        # reads them into fp32 exactly).
        dt = torch.promote_types(q_eff.dtype, k.dtype)
        o = _latent_attention(q_eff.to(dt), k, i, scale)
        o_lat = o[..., :self.kv_lora_rank]
        wv = maybe_cast(self.kv_b[:, :, self.qk_nope_head_dim:], self.dtype)
        o_heads = torch.einsum("bhsr,rhv->bhsv", o_lat.to(wv.dtype), wv)
        return self._out(o_heads), new_cache


def _latent_attention(q, k, idx, scale):
    """q [b, hq, s, w] attending over the latent cache ``k`` [b, 1, max_len,
    w] (written at rows idx..idx + s - 1; a layout ``latent_pages`` takes)
    through the paged kernel's latent option, the row as key and value;
    returns [b, hq, s, w] in q's dtype. Row t sees keys 0..idx + t, JAX's
    mask (np_modeling_tpu/nn/mla.py:226-228), as the paged kernel's causal
    rows of a sequence of length idx + s do. Past the end of the cache JAX
    clamps the write (:215) but not the mask: row t then sees keys
    0..min(idx + t, max_len - 1), so each row goes as a sequence of its own
    with that length."""
    b, hq, s, w = q.shape
    max_len = k.shape[2]
    pages, table = latent_pages(k)
    rows = q.transpose(1, 2).contiguous()                # [b, s, hq, w]
    if idx + s <= max_len:
        lengths = torch.full((b,), idx + s, dtype=torch.int32, device=q.device)
        o = ops.paged_attention(rows, pages, pages, lengths, table,
                                scale=scale)
    else:
        seen = torch.clamp(idx + torch.arange(s, device=q.device),
                           max=max_len - 1) + 1
        o = ops.paged_attention(
            rows.reshape(b * s, hq, w), pages, pages,
            seen.to(torch.int32).repeat(b),
            table.repeat_interleave(s, dim=0), scale=scale).reshape(b, s, hq,
                                                                    w)
    return o.transpose(1, 2)
