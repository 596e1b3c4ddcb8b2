"""BERT-style bidirectional encoder.

Counterpart of np_modeling_tpu/models/bert.py: token + position (+ token
type) embeddings, an embedding LayerNorm and dropout, a stack of
``TransformerEncoderBlock``s (post-norm by default, non-causal), the [CLS]
tanh pooler and the classifier, and the masked-LM head (a Linear, the tanh
``ops.gelu`` whatever ``activation`` says, as JAX :133, a LayerNorm, and the
tied decoder: an fp32 product with the token table plus ``mlm_bias``).
Parameters sit under the JAX paths (``embedding.table``,
``pos_embedding.table``, ``type_embedding.table``, ``embed_norm.gamma``,
``layer_{i}.self_attention.wq``, ``layer_{i}.dense1.linear.w``,
``pooler.w``, ``classifier.b``, ``mlm_transform.w``, ``mlm_norm.beta``,
``mlm_bias``).

Two attention surfaces, as in JAX: ``attention_mask`` [b, s] (1 = token, 0
= padding) becomes segment ids, so padding is masked inside the flash
kernels from O(s) operands; ``mask`` [b|1, h|1, s, s] is any boolean mask
(True = attend), which runs K1's mask option forward and K2's (or K5's)
backward on the card at head_dim 64. ``mlm_mask_tokens`` draws BERT's
80/10/10 corruption from a ``torch.Generator``: the same seed does not give
JAX's positions.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn import Dropout, Embedding, LayerNorm, Linear
from np_modeling_tpu_torch.nn.module import resolve_rngs, split_rngs
from np_modeling_tpu_torch.nn.transformer import TransformerEncoderBlock


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 4
    hidden_units: int = 2048
    max_len: int = 512
    drop_rate: float = 0.0
    norm_first: bool = False    # classic BERT is post-norm
    num_classes: int = 2
    mlm_head: bool = False      # the masked-LM pretraining head
    activation: object = "relu"  # FFN activation (HF BERT: "gelu_exact")
    ln_eps: float = 1e-3        # LayerNorm epsilon (HF BERT: 1e-12)
    type_vocab_size: int = 0    # > 0: token-type (segment) embeddings


class BertEncoder(nn.Module):
    """The model on ``device`` (the card unless the caller names another);
    parameters uninitialised until ``init(generator)`` or
    ``utils.load_params``."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        device = torch.device("cuda") if device is None else device
        c = self.config = config
        self.embedding = Embedding(c.vocab_size, c.d_model, device)
        self.pos_embedding = Embedding(c.max_len, c.d_model, device)
        if c.type_vocab_size:
            self.type_embedding = Embedding(c.type_vocab_size, c.d_model,
                                            device)
        self.embed_norm = LayerNorm(c.d_model, c.ln_eps, device)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderBlock(
                c.d_model, c.num_heads, c.hidden_units,
                activation=c.activation, ln_eps=c.ln_eps,
                drop_rate=c.drop_rate, norm_first=c.norm_first,
                device=device))
        self.pooler = Linear(c.d_model, c.d_model, device=device)
        self.classifier = Linear(c.d_model, c.num_classes, device=device)
        self.drop = Dropout(c.drop_rate)
        if c.mlm_head:
            self.mlm_transform = Linear(c.d_model, c.d_model, device=device)
            self.mlm_norm = LayerNorm(c.d_model, c.ln_eps, device)
            self.mlm_bias = nn.Parameter(torch.empty(
                (c.vocab_size,), dtype=torch.float32, device=device))

    def init(self, generator: torch.Generator):
        for m in self.children():
            m.init(generator)
        if self.config.mlm_head:
            with torch.no_grad():
                self.mlm_bias.zero_()
        return self

    def encode(self, tokens, mask=None, training=False, rngs=None,
               attention_mask=None, token_type_ids=None):
        """Hidden states [b, s, d]. ``attention_mask`` [b, s]: 1 = token, 0
        = padding, as segment ids (padding forms its own segment);
        ``mask``: a boolean [b|1, h|1, s, s]; ``token_type_ids`` [b, s]
        (needs ``type_vocab_size > 0``; default zeros)."""
        c = self.config
        rngs = resolve_rngs(rngs) if training else None
        segment_ids = None
        if attention_mask is not None:
            if tuple(attention_mask.shape) != tuple(tokens.shape):
                raise ValueError(f"attention_mask "
                                 f"{tuple(attention_mask.shape)} and tokens "
                                 f"{tuple(tokens.shape)} differ")
            segment_ids = attention_mask.to(torch.int32)
        positions = torch.arange(tokens.shape[-1], device=tokens.device)
        x = self.embedding(tokens) + self.pos_embedding(positions)
        if c.type_vocab_size:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(tokens)
            x = x + self.type_embedding(token_type_ids)
        elif token_type_ids is not None:
            raise ValueError("token_type_ids needs BertConfig("
                             "type_vocab_size>0)")
        x = self.embed_norm(x)
        x = self.drop(x, training, rngs, salt=1000)
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(
                x, training=training, rngs=split_rngs(rngs, i),
                segment_ids=segment_ids, mask=mask)
        return x

    def forward(self, tokens, mask=None, training=False, rngs=None,
                attention_mask=None, token_type_ids=None):
        """Classifier logits [b, num_classes] from the [CLS] position through
        the tanh pooler."""
        x = self.encode(tokens, mask, training, rngs,
                        attention_mask=attention_mask,
                        token_type_ids=token_type_ids)
        return self.classifier(torch.tanh(self.pooler(x[:, 0])))

    apply = forward

    # ---- masked-LM pretraining (BERT objective) --------------------------

    def mlm_logits(self, tokens, training=False, rngs=None,
                   attention_mask=None):
        """Per-position vocab logits [b, s, vocab] (fp32): hidden -> Linear
        + tanh gelu + LayerNorm -> the tied token table (an fp32 product)
        plus ``mlm_bias``."""
        if not self.config.mlm_head:
            raise ValueError("build with BertConfig(mlm_head=True)")
        x = self.encode(tokens, training=training, rngs=rngs,
                        attention_mask=attention_mask)
        x = self.mlm_norm(ops.gelu(self.mlm_transform(x)))
        return torch.matmul(x.float(), self.embedding.table.float().t()) \
            + self.mlm_bias

    def mlm_loss(self, tokens, labels, weights, training=False, rngs=None,
                 attention_mask=None):
        """Mean CE over the selected positions (``weights`` 1 = predict);
        ``tokens`` the corrupted inputs, ``labels`` the original ids."""
        logits = self.mlm_logits(tokens, training, rngs,
                                 attention_mask=attention_mask)
        ce = ops.softmax_cross_entropy_with_integer_labels(logits, labels)
        w = weights.to(torch.float32)
        return (ce * w).sum() / w.sum().clamp(min=1.0)


def mlm_mask_tokens(generator: torch.Generator, tokens, vocab_size: int,
                    mask_token: int, mask_rate: float = 0.15,
                    special_tokens=()):
    """BERT's 80/10/10 corruption: select ``mask_rate`` of the positions
    (never one of ``special_tokens``); replace 80% of them with
    ``mask_token``, 10% with a random id in [0, vocab_size), keep 10%.
    Returns ``(inputs, labels, weights)``, ``weights`` 1 (int32) at the
    selected positions. The draws come from ``generator`` on its own
    device."""
    shape, dev = tokens.shape, generator.device
    selectable = torch.ones(shape, dtype=torch.bool, device=tokens.device)
    for t in special_tokens:
        selectable &= tokens != t
    sel = (torch.rand(shape, generator=generator, device=dev)
           .to(tokens.device) < mask_rate) & selectable
    u = torch.rand(shape, generator=generator, device=dev).to(tokens.device)
    rand_ids = torch.randint(0, vocab_size, shape, generator=generator,
                             device=dev).to(tokens.device, tokens.dtype)
    corrupted = torch.where(u < 0.8, torch.full_like(tokens, mask_token),
                            torch.where(u < 0.9, rand_ids, tokens))
    return torch.where(sel, corrupted, tokens), tokens, sel.to(torch.int32)
