"""Encoder-decoder (seq2seq) transformer with learned positions.

Counterpart of np_modeling_tpu/models/seq2seq.py: shared-vocabulary token
and position embeddings, ``TransformerEncoder`` and a causal
``TransformerDecoder`` with cross-attention (nn/transformer.py), a final
LayerNorm and the tied head (fp32 products, the result in the hidden
states' dtype, as JAX's ``Embedding.attend``). A padded source
(``src_valid``) is masked through segment ids in the encoder and a (ones,
src_valid) pair in the cross-attention, inside the flash kernels.
``greedy_decode`` and ``beam_decode`` run the decoder through dense KV
caches. Parameters sit under the JAX paths (``embedding.table``,
``pos_embedding.table``, ``encoder.layer_{i}...``,
``decoder.layer_{i}.cross_attention.wq``, ``final_norm.gamma``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn import Embedding, LayerNorm
from np_modeling_tpu_torch.nn.module import resolve_rngs
from np_modeling_tpu_torch.nn.transformer import (TransformerDecoder,
                                                  TransformerEncoder)


@dataclasses.dataclass
class Seq2SeqConfig:
    vocab_size: int = 32000
    d_model: int = 512
    num_heads: int = 8
    num_encoder_layers: int = 4
    num_decoder_layers: int = 4
    hidden_units: int = 2048
    max_len: int = 512
    drop_rate: float = 0.0
    norm_first: bool = True


class Seq2SeqTransformer(nn.Module):
    """The model on ``device`` (the card unless the caller names another);
    parameters uninitialised until ``init(generator)`` or
    ``utils.load_params``."""

    def __init__(self, config: Seq2SeqConfig, device=None):
        super().__init__()
        device = torch.device("cuda") if device is None else device
        c = self.config = config
        self.embedding = Embedding(c.vocab_size, c.d_model, device)
        self.pos_embedding = Embedding(c.max_len, c.d_model, device)
        self.encoder = TransformerEncoder(
            c.d_model, c.num_encoder_layers, c.num_heads, c.hidden_units,
            c.norm_first, c.drop_rate, device=device)
        self.decoder = TransformerDecoder(
            c.d_model, c.num_decoder_layers, c.num_heads, c.hidden_units,
            c.norm_first, c.drop_rate, causal=True, device=device)
        self.final_norm = LayerNorm(c.d_model, device=device)

    def init(self, generator: torch.Generator):
        for m in self.children():
            m.init(generator)
        return self

    def _embed(self, tokens, offset=0):
        pos = offset + torch.arange(tokens.shape[-1], device=tokens.device)
        return self.embedding(tokens) + self.pos_embedding(pos)

    def _attend(self, y):
        """Tied logits ``y @ table^T``, fp32 products, in y's dtype."""
        return torch.matmul(y.float(), self.embedding.table.float().t()).to(
            y.dtype)

    @staticmethod
    def _cross_segs(tgt_len, src_valid):
        """(q_seg, kv_seg) so that every target position attends only the
        valid source positions."""
        if src_valid is None:
            return None
        return (torch.ones((src_valid.shape[0], tgt_len), dtype=torch.int32,
                           device=src_valid.device),
                src_valid.to(torch.int32))

    def encode(self, src, training=False, rngs=None, src_valid=None):
        """``src_valid`` [b, s_src] (1 = token, 0 = padding)."""
        rngs = resolve_rngs(rngs) if training else None
        seg = src_valid.to(torch.int32) if src_valid is not None else None
        return self.encoder(self._embed(src), training=training, rngs=rngs,
                            segment_ids=seg)

    def apply(self, src, tgt, training=False, rngs=None, src_valid=None):
        """Teacher-forced logits [b, s_tgt, vocab] (fp32)."""
        rngs = resolve_rngs(rngs) if training else None
        memory = self.encode(src, training, rngs, src_valid)
        y = self.decoder(self._embed(tgt), memory, training=training,
                         rngs=rngs,
                         cross_segment_ids=self._cross_segs(tgt.shape[-1],
                                                            src_valid))
        return self._attend(self.final_norm(y)).float()

    def loss(self, src, tgt, training=False, rngs=None, src_valid=None,
             tgt_valid=None):
        logits = self.apply(src, tgt[..., :-1], training, rngs,
                            src_valid=src_valid)
        ce = ops.softmax_cross_entropy_with_integer_labels(logits,
                                                           tgt[..., 1:])
        if tgt_valid is not None:
            v = tgt_valid[..., 1:].to(ce.dtype)
            return (ce * v).sum() / v.sum().clamp(min=1.0)
        return ce.mean()

    def _step(self, tokens, memory, caches, cross_segs):
        """One decode step's logits (in the states' dtype) and caches."""
        y = self._embed(tokens, offset=caches[0]["index"])
        y, caches = self.decoder(y, memory, caches=caches, decode=True,
                                 cross_segment_ids=cross_segs)
        return self._attend(self.final_norm(y)), caches

    @torch.no_grad()
    def greedy_decode(self, src, bos_token: int, steps: int, src_valid=None):
        """KV-cached greedy decode conditioned on the encoded ``src``:
        [b, steps] tokens after ``bos_token``."""
        b = src.shape[0]
        memory = self.encode(src, src_valid=src_valid)
        caches = self.decoder.init_cache(b, steps + 1, self.config.d_model)
        tok = torch.full((b, 1), bos_token, dtype=torch.long,
                         device=src.device)
        cross_segs = self._cross_segs(1, src_valid)
        out = []
        for _ in range(steps):
            logits, caches = self._step(tok, memory, caches, cross_segs)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            out.append(tok)
        return torch.cat(out, dim=1)

    @torch.no_grad()
    def beam_decode(self, src, bos_token: int, steps: int, beam_size: int,
                    eos_id: int | None = None, alpha: float = 0.0,
                    src_valid=None):
        """Beam search conditioned on the encoded ``src``
        (``models.beam.encdec_beam_search``). Returns ``(tokens [b, beam,
        steps], scores [b, beam])`` best-first."""
        from np_modeling_tpu_torch.models.beam import encdec_beam_search

        memory = self.encode(src, src_valid=src_valid)
        kv_seg = (src_valid.to(torch.int32) if src_valid is not None
                  else None)

        def init_dec_cache(b, max_len):
            return self.decoder.init_cache(b, max_len, self.config.d_model)

        def decode_step(tokens, dec, aux):
            cs = ((torch.ones(tokens.shape, dtype=torch.int32,
                              device=tokens.device), aux["kv_seg"])
                  if "kv_seg" in aux else None)
            logits, dec = self._step(tokens, aux["mem"], dec, cs)
            return logits.float(), dec

        return encdec_beam_search(init_dec_cache, decode_step, src.shape[0],
                                  bos_token, steps, beam_size, memory,
                                  kv_seg=kv_seg, eos_id=eos_id, alpha=alpha)
