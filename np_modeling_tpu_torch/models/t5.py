"""T5 encoder-decoder (relative-position-bias transformer).

Counterpart of np_modeling_tpu/models/t5.py: T5's pre-RMSNorm blocks,
unscaled attention scores (scale 1.0), the bucketed relative-position bias
(one [buckets, heads] table a stack, ``enc_relpos`` / ``dec_relpos``) added
to the scores inside the flash kernels (their bias option on the card) with
dbias flowing back into the table through ``ops.embedding_lookup``'s
scatter-add, biasless projections, and the relu (v1.0) or gated-gelu (v1.1)
FFN. ``T5`` owns its parameters under the JAX paths (``embedding.table``,
``enc_relpos``, ``enc_{i}.self_attention.wq``, ``enc_{i}.ffn.wi``,
``dec_{i}.cross_attention.wk``, ``enc_norm.gamma``, ``lm_head.w`` when
untied, ...). The encoder masks a padded source (``src_valid``) through
segment ids, the decoder's cross-attention through a (ones, src_valid)
pair. ``greedy_decode`` and ``beam_decode`` decode through dense KV caches
(fp32, as JAX's), the decoder's bias row rebuilt each step for its query
position against the whole cache: K1's mask and bias options at sq = 1 on
the card. Dropout runs through ``ops.dropout`` (K7 on the card) with the
port's own bits, each site's salt folded into the call's seed.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from np_modeling_tpu_torch import ops, rng as _rng
from np_modeling_tpu_torch.nn import Embedding, RMSNorm, initializers
from np_modeling_tpu_torch.nn.attention import MultiHeadAttention
from np_modeling_tpu_torch.nn.module import maybe_cast, resolve_rngs


@dataclasses.dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64                 # per-head dim, decoupled from d_model
    num_heads: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    d_ff: int = 2048
    relpos_buckets: int = 32
    relpos_max_distance: int = 128
    gated_act: bool = False        # False: relu FFN (v1.0); True: gated-gelu
    tie_embeddings: bool = True    # tied head rescales hidden by d^-0.5
    drop_rate: float = 0.0
    ln_eps: float = 1e-6
    dtype: object = None           # compute dtype; params/stats stay fp32


def relative_position_bucket(rel, *, bidirectional: bool, num_buckets: int,
                             max_distance: int):
    """The bucket of ``rel = memory_pos - query_pos`` (an integer tensor),
    JAX's integers exactly (HF's bucketing): half the buckets (all of them
    for the causal decoder) hold exact small distances, the rest grow
    logarithmically up to ``max_distance``, in fp32 as JAX computes them."""
    rel = rel.long()
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).long() * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    scale = (num_buckets - max_exact) / torch.log(
        torch.tensor(max_distance / max_exact, dtype=torch.float32))
    large = max_exact + (torch.log(rel.clamp(min=1).float() / max_exact)
                         * scale.to(rel.device)).to(torch.int32).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(is_small, rel, large)


class T5FFN(nn.Module):
    """The FFN's weights at JAX's paths: ``wi`` [d, d_ff] and ``wo`` [d_ff,
    d], or gated ``wi_0``, ``wi_1`` and ``wo``."""

    def __init__(self, d: int, d_ff: int, gated: bool, device=None):
        super().__init__()
        names = ("wi_0", "wi_1", "wo") if gated else ("wi", "wo")
        for name in names:
            shape = (d_ff, d) if name == "wo" else (d, d_ff)
            setattr(self, name, nn.Parameter(torch.empty(
                shape, dtype=torch.float32, device=device)))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        for _, w in self.named_parameters():
            w.copy_(initializers.lecun_normal(generator, w.shape))
        return self


class _Layer(nn.Module):
    """A block's modules under its JAX key (``enc_{i}`` / ``dec_{i}``)."""

    def __init__(self, **modules):
        super().__init__()
        for name, m in modules.items():
            self.add_module(name, m)

    def init(self, generator: torch.Generator):
        for m in self.children():
            m.init(generator)
        return self


class T5(nn.Module):
    """The model on ``device`` (the card unless the caller names another, as
    ``GPT``); parameters uninitialised until ``init(generator)`` or
    ``utils.load_params``."""

    def __init__(self, config: T5Config, device=None):
        super().__init__()
        device = torch.device("cuda") if device is None else device
        c = self.config = config
        self.embedding = Embedding(c.vocab_size, c.d_model, device)
        self.enc_relpos = nn.Parameter(torch.empty(
            (c.relpos_buckets, c.num_heads), dtype=torch.float32,
            device=device))
        self.dec_relpos = nn.Parameter(torch.empty_like(self.enc_relpos))

        def mha(causal=False):
            return MultiHeadAttention(c.d_model, c.num_heads, head_dim=c.d_kv,
                                      use_bias=False, attn_scale=1.0,
                                      causal=causal, dtype=c.dtype,
                                      device=device)

        def norm():
            return RMSNorm(c.d_model, c.ln_eps, device=device)

        def ffn():
            return T5FFN(c.d_model, c.d_ff, c.gated_act, device)

        for i in range(c.num_encoder_layers):
            self.add_module(f"enc_{i}", _Layer(
                self_attention=mha(), norm1=norm(), norm2=norm(), ffn=ffn()))
        for i in range(c.num_decoder_layers):
            self.add_module(f"dec_{i}", _Layer(
                self_attention=mha(causal=True), cross_attention=mha(),
                norm1=norm(), norm2=norm(), norm3=norm(), ffn=ffn()))
        self.enc_norm, self.dec_norm = norm(), norm()
        if not c.tie_embeddings:
            self.lm_head = _Layer()
            self.lm_head.w = nn.Parameter(torch.empty(
                (c.d_model, c.vocab_size), dtype=torch.float32,
                device=device))

    def _layer(self, name: str, i: int) -> _Layer:
        return getattr(self, f"{name}_{i}")

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Every parameter from ``generator`` (JAX's distributions: the
        embedding N(0, 0.02), the relpos tables N(0, 0.02), projections and
        FFN lecun-normal, norms ones)."""
        c = self.config
        self.embedding.init(generator)
        for t in (self.enc_relpos, self.dec_relpos):
            t.copy_(initializers.normal(generator, t.shape))
        for i in range(c.num_encoder_layers):
            self._layer("enc", i).init(generator)
        for i in range(c.num_decoder_layers):
            self._layer("dec", i).init(generator)
        self.enc_norm.init(generator)
        self.dec_norm.init(generator)
        if not c.tie_embeddings:
            self.lm_head.w.copy_(initializers.lecun_normal(
                generator, self.lm_head.w.shape))
        return self

    # ---- pieces ----------------------------------------------------------

    def _relpos_bias(self, table, qpos, kpos, bidirectional):
        """[1, h, q, k] score bias from the bucketed relative positions
        (rel = kpos - qpos): a gather of the [buckets, h] table whose
        backward adds dbias into it (``ops.embedding_lookup``). Made
        contiguous once here, so that each layer's flash kernels read the
        bias along keys at unit stride (the gather's [q, k, h] seen as
        [h, q, k] lies h floats apart along keys)."""
        c = self.config
        bucket = relative_position_bucket(
            kpos[None, :] - qpos[:, None], bidirectional=bidirectional,
            num_buckets=c.relpos_buckets, max_distance=c.relpos_max_distance)
        return ops.embedding_lookup(table, bucket).permute(
            2, 0, 1).contiguous()[None]

    def _ffn(self, fp: T5FFN, y):
        c = self.config
        y = maybe_cast(y, c.dtype)
        if c.gated_act:
            g = ops.gelu(ops.linear(y, maybe_cast(fp.wi_0, c.dtype)))
            h = g * ops.linear(y, maybe_cast(fp.wi_1, c.dtype))
        else:
            h = ops.relu(ops.linear(y, maybe_cast(fp.wi, c.dtype)))
        return ops.linear(h, maybe_cast(fp.wo, c.dtype))

    def _drop(self, x, training, rngs, salt):
        """Inverted dropout at the site ``salt`` (JAX folds it into the
        key; here into the call's seed), through ``ops.dropout``."""
        rate = self.config.drop_rate
        if not training or rate == 0.0 or rngs is None:
            return x
        return ops.dropout(x, _rng.fold_seed(rngs["dropout"], salt), rate)

    # ---- stacks ------------------------------------------------------------

    def encode(self, src, training=False, rngs=None, src_valid=None):
        """The encoder's final-norm states [b, s, d] (compute dtype)."""
        c = self.config
        rngs = resolve_rngs(rngs) if training else None
        x = maybe_cast(self.embedding(src), c.dtype)
        pos = torch.arange(src.shape[-1], device=src.device)
        bias = self._relpos_bias(self.enc_relpos, pos, pos, True)
        seg = src_valid.to(torch.int32) if src_valid is not None else None
        for i in range(c.num_encoder_layers):
            lp = self._layer("enc", i)
            h = lp.self_attention(lp.norm1(x), bias=bias, segment_ids=seg)
            x = x + self._drop(h, training, rngs, 2 * i)
            h = self._ffn(lp.ffn, lp.norm2(x))
            x = x + self._drop(h, training, rngs, 2 * i + 1)
        return self.enc_norm(x)

    def _decoder_stack(self, y, memory, bias, training, rngs, cross_segs,
                       caches=None, decode=False):
        c = self.config
        new_caches = [] if decode else None
        for i in range(c.num_decoder_layers):
            lp = self._layer("dec", i)
            h = lp.norm1(y)
            if decode:
                h, cache = lp.self_attention(h, cache=caches[i], decode=True,
                                             bias=bias)
                new_caches.append(cache)
            else:
                h = lp.self_attention(h, bias=bias)
            y = y + self._drop(h, training, rngs, 1000 + 3 * i)
            h = lp.cross_attention(lp.norm2(y), memory,
                                   segment_ids=cross_segs)
            y = y + self._drop(h, training, rngs, 1000 + 3 * i + 1)
            h = self._ffn(lp.ffn, lp.norm3(y))
            y = y + self._drop(h, training, rngs, 1000 + 3 * i + 2)
        y = self.dec_norm(y)
        return (y, new_caches) if decode else y

    def _head(self, y):
        """fp32 logits: tied, the hidden states times d^-0.5 (in their
        dtype) against the table, the product accumulated in fp32 (JAX's
        preferred_element_type); untied, ``lm_head`` through ``ops.linear``
        then fp32."""
        c = self.config
        if c.tie_embeddings:
            y = y * torch.tensor(c.d_model ** -0.5, dtype=y.dtype)
            table = maybe_cast(self.embedding.table, c.dtype)
            return torch.matmul(maybe_cast(y, c.dtype).float(),
                                table.float().t())
        return ops.linear(maybe_cast(y, c.dtype),
                          maybe_cast(self.lm_head.w, c.dtype)).float()

    @staticmethod
    def _cross_segs(b, tgt_len, src_valid):
        if src_valid is None:
            return None
        return (torch.ones((b, tgt_len), dtype=torch.int32,
                           device=src_valid.device),
                src_valid.to(torch.int32))

    def _dec_caches(self, b, max_len):
        return [self._layer("dec", i).self_attention.init_cache(
            b, max_len, self.config.d_model)
            for i in range(self.config.num_decoder_layers)]

    # ---- public API --------------------------------------------------------

    def apply(self, src, tgt, training=False, rngs=None, src_valid=None):
        """Teacher-forced logits [b, s_tgt, vocab] (fp32). ``rngs`` as in
        ``GPT.apply`` (one seed drawn a call, shared by both stacks)."""
        c = self.config
        rngs = resolve_rngs(rngs) if training else None
        memory = self.encode(src, training, rngs, src_valid)
        y = maybe_cast(self.embedding(tgt), c.dtype)
        pos = torch.arange(tgt.shape[-1], device=tgt.device)
        bias = self._relpos_bias(self.dec_relpos, pos, pos, False)
        y = self._decoder_stack(y, memory, bias, training, rngs,
                                self._cross_segs(src.shape[0], tgt.shape[-1],
                                                 src_valid))
        return self._head(y)

    def loss(self, src, tgt, training=False, rngs=None, src_valid=None,
             tgt_valid=None):
        """Mean CE of ``tgt[..., 1:]`` given ``tgt[..., :-1]`` (over the
        valid targets with ``tgt_valid``)."""
        logits = self.apply(src, tgt[..., :-1], training, rngs,
                            src_valid=src_valid)
        ce = ops.softmax_cross_entropy_with_integer_labels(logits,
                                                           tgt[..., 1:])
        if tgt_valid is not None:
            v = tgt_valid[..., 1:].to(ce.dtype)
            return (ce * v).sum() / v.sum().clamp(min=1.0)
        return ce.mean()

    @torch.no_grad()
    def greedy_decode(self, src, bos_token: int, steps: int, src_valid=None):
        """KV-cached greedy decode: ``steps`` tokens [b, steps] after
        ``bos_token``, the decoder's bias row for query position i rebuilt
        each step against the whole cache (JAX's scan as a loop)."""
        c = self.config
        b = src.shape[0]
        memory = self.encode(src, src_valid=src_valid)
        caches = self._dec_caches(b, steps + 1)
        tok = torch.full((b, 1), bos_token, dtype=torch.long,
                         device=src.device)
        cross_segs = self._cross_segs(b, 1, src_valid)
        kpos = torch.arange(steps + 1, device=src.device)
        out = []
        for i in range(steps):
            y = maybe_cast(self.embedding(tok), c.dtype)
            bias = self._relpos_bias(self.dec_relpos, kpos[i:i + 1], kpos,
                                     False)
            y, caches = self._decoder_stack(y, memory, bias, False, None,
                                            cross_segs, caches, decode=True)
            tok = torch.argmax(self._head(y)[:, -1:], dim=-1)
            out.append(tok)
        return torch.cat(out, dim=1)

    @torch.no_grad()
    def beam_decode(self, src, bos_token: int, steps: int, beam_size: int,
                    eos_id: int | None = None, alpha: float = 0.0,
                    src_valid=None):
        """Beam search conditioned on the encoded ``src``
        (``models.beam.encdec_beam_search``: the encoder memory rides the
        gather-exempt aux cache). Returns ``(tokens [b, beam, steps],
        scores [b, beam])`` best-first."""
        from np_modeling_tpu_torch.models.beam import encdec_beam_search

        c = self.config
        memory = self.encode(src, src_valid=src_valid)
        kv_seg = (src_valid.to(torch.int32) if src_valid is not None
                  else None)

        def decode_step(tokens, dec, aux):
            cs = ((torch.ones(tokens.shape, dtype=torch.int32,
                              device=tokens.device), aux["kv_seg"])
                  if "kv_seg" in aux else None)
            qpos = dec[0]["index"] + torch.arange(tokens.shape[-1],
                                                  device=tokens.device)
            bias = self._relpos_bias(
                self.dec_relpos, qpos,
                torch.arange(dec[0]["k"].shape[2], device=tokens.device),
                False)
            y = maybe_cast(self.embedding(tokens), c.dtype)
            y, dec = self._decoder_stack(y, aux["mem"], bias, False, None,
                                         cs, caches=dec, decode=True)
            return self._head(y), dec

        return encdec_beam_search(self._dec_caches, decode_step,
                                  src.shape[0], bos_token, steps, beam_size,
                                  memory, kv_seg=kv_seg, eos_id=eos_id,
                                  alpha=alpha)
