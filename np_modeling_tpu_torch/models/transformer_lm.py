"""GPT-style causal decoder-only language model.

Counterpart of np_modeling_tpu/models/transformer_lm.py. ``GPTConfig`` has
the JAX config's fields and defaults (``dtype`` is a torch dtype here). The
port builds the GPT-2 family: learned positions, LayerNorm, pre-norm blocks
with an MLP FFN (relu or tanh-gelu), biases optional, tied embeddings; a
config outside it raises NotImplementedError. ``GPT`` owns its parameters
under the JAX parameter paths (``embedding.table``, ``layer_{i}.
self_attention.wq``, ``layer_{i}.dense1.linear.w``, ...). ``GPT.apply``
is the dense forward over flash attention and ``GPT.loss`` the next-token
loss that training differentiates; the serving engine runs the same modules
over paged attention.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn import Dropout, Embedding, LayerNorm
from np_modeling_tpu_torch.nn.module import (maybe_cast, resolve_rngs,
                                             split_rngs)
from np_modeling_tpu_torch.nn.transformer import TransformerEncoderBlock


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 32000
    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int | None = None      # GQA
    num_layers: int = 4
    hidden_units: int = 2048
    max_len: int = 1024
    drop_rate: float = 0.0
    norm_first: bool = True
    tie_embeddings: bool = True
    dtype: object = None          # compute dtype, e.g. torch.bfloat16
    scan_layers: bool = False
    remat: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_aux_weight: float = 0.01
    moe_capacity_factor: float | None = 1.25
    moe_router_weights: str = "default"
    moe_routed_scaling: float = 1.0
    moe_shared_units: int = 0
    moe_router_groups: tuple | None = None
    moe_router_score: str = "softmax"
    moe_router_select_bias: bool = False
    moe_group_metric: str = "max"
    moe_hidden_units: int | None = None
    moe_first_dense: int = 0
    positional: str = "learned"   # "learned" | "rope"
    activation: str = "relu"      # "gelu" is the tanh form = HF "gelu_new"
    ln_eps: float = 1e-3          # GPT-2 needs 1e-5, set explicitly
    norm: str = "layer"
    rms_offset: bool = False
    ffn: str = "mlp"
    head_dim: int | None = None
    embed_scale: bool = False
    use_bias: bool = True
    qkv_bias: bool | None = None
    rope_base: float = 10000.0
    rope_dim: int | None = None
    rope_scaling: tuple | None = None
    parallel_residual: bool = False
    parallel_shared_norm: bool = False
    lm_head_bias: bool = False
    attention_window: int | None = None
    window_pattern: int = 1
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    query_pre_attn_scalar: float | None = None
    sandwich_norm: bool = False
    qk_norm: bool = False
    attn_sinks: bool = False
    moe_router_bias: bool = False
    mla: dict | None = None
    fused_loss: bool = False


# Config values the port builds; anything else is a later slice.
_PORTED = {"positional": ("learned",), "norm": ("layer",), "ffn": ("mlp",),
           "activation": ("relu", "gelu"), "norm_first": (True,),
           "tie_embeddings": (True,), "scan_layers": (False,),
           "moe_experts": (0,), "mla": (None,), "attention_window": (None,),
           "attn_logit_softcap": (None,), "final_logit_softcap": (None,),
           "query_pre_attn_scalar": (None,), "attn_sinks": (False,),
           "qk_norm": (False,), "parallel_residual": (False,),
           "sandwich_norm": (False,), "embed_scale": (False,)}


def check_ported(config: GPTConfig) -> None:
    """Raise NotImplementedError for a config feature outside GPT-2."""
    bad = {k: getattr(config, k) for k, ok in _PORTED.items()
           if getattr(config, k) not in ok}
    if bad:
        raise NotImplementedError(
            f"GPTConfig features not ported yet: {bad} (ROADMAP.md Queue 1)")


class GPT(nn.Module):
    """The model's modules and parameters, on ``device``: the card
    (``cuda``) unless the caller names another, as JAX places arrays on its
    default backend; without a card that raises, as torch does. Parameters
    are allocated uninitialised: call ``init(generator)`` or load weights
    (``utils.convert.params_from_numpy``)."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        check_ported(config)
        device = torch.device("cuda") if device is None else device
        c = self.config = config
        self.embedding = Embedding(c.vocab_size, c.d_model, device)
        self.pos_embedding = Embedding(c.max_len, c.d_model, device)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderBlock(
                c.d_model, c.num_heads, c.hidden_units,
                num_kv_heads=c.num_kv_heads, dtype=c.dtype,
                activation=c.activation, ln_eps=c.ln_eps,
                use_bias=c.use_bias, qkv_bias=c.qkv_bias,
                head_dim=c.head_dim, causal=True, drop_rate=c.drop_rate,
                device=device))
        self.final_norm = LayerNorm(c.d_model, c.ln_eps, device)
        self.drop = Dropout(c.drop_rate)

    def _block_for(self, i: int) -> TransformerEncoderBlock:
        return getattr(self, f"layer_{i}")

    def init(self, generator: torch.Generator):
        """Fill every parameter from ``generator`` (the JAX distributions)."""
        self.embedding.init(generator)
        self.pos_embedding.init(generator)
        for i in range(self.config.num_layers):
            self._block_for(i).init(generator)
        self.final_norm.init(generator)
        return self

    def apply(self, tokens, training=False, rngs=None, return_hidden=False,
              logits_dtype=None, segment_ids=None, positions=None):
        """Dense forward (JAX :221-333): token embedding plus learned
        positions, cast to the compute dtype, dropout (salt 1000), the
        blocks (layer ``i`` with ``split_rngs(rngs, i)``), the final norm.
        ``segment_ids`` [b, s]: packed documents, masked from each other
        inside the flash kernels; ``positions`` ([s] or [b, s]) index the
        position table in place of ``arange(s)``, so that positions can
        restart at each document. In training, ``rngs={"dropout": g}`` with
        ``g`` a CPU generator (one seed drawn from it a call) or an integer
        seed. Returns the final-norm hidden states with
        ``return_hidden=True``, else the tied-head logits, fp32 unless
        ``logits_dtype`` says otherwise."""
        c = self.config
        if positions is None:
            if tokens.shape[-1] > c.max_len:
                raise ValueError(f"{tokens.shape[-1]} tokens: the position "
                                 f"table holds max_len {c.max_len}")
            positions = torch.arange(tokens.shape[-1], device=tokens.device)
        x = self.embedding(tokens)
        x = x + self.pos_embedding(positions)
        rngs = resolve_rngs(rngs) if training else None
        x = self.drop(maybe_cast(x, c.dtype), training, rngs, salt=1000)
        for i in range(c.num_layers):
            x = self._block_for(i)(x, training=training,
                                   rngs=split_rngs(rngs, i),
                                   segment_ids=segment_ids)
        x = self.final_norm(x)
        if return_hidden:
            return x
        # The tied head's product accumulates in fp32 (JAX:
        # preferred_element_type), here as the product of the exact fp32
        # copies of the compute-dtype operands.
        table = maybe_cast(self.embedding.table, c.dtype)
        logits = torch.matmul(x.float(), table.float().t())
        return logits.to(logits_dtype or torch.float32)

    def loss(self, tokens, training=False, rngs=None, segment_ids=None,
             positions=None):
        """Mean next-token CE (JAX :381-448). Up to ``max_len`` tokens the
        model runs at full length: the targets are the tokens rolled by
        one, and ``valid`` masks the last position (whose rolled target is
        the first token). Longer, it runs on ``tokens[..., :-1]`` against
        ``tokens[..., 1:]``, ``segment_ids`` and ``positions`` cut with
        them. With ``segment_ids``, a position whose next token lies in
        another document is not a target either. ``rngs`` as in
        ``apply``."""
        c = self.config
        valid = None
        if tokens.shape[-1] <= c.max_len:
            inputs, seg, pos = tokens, segment_ids, positions
            targets = torch.roll(tokens, -1, dims=-1)
            valid = torch.ones_like(tokens, dtype=torch.float32)
            valid[..., -1] = 0.0
        else:
            inputs, targets = tokens[..., :-1], tokens[..., 1:]
            seg = segment_ids[..., :-1] if segment_ids is not None else None
            pos = positions[..., :-1] if positions is not None else None
        if segment_ids is not None:
            same = (segment_ids[..., 1:] == segment_ids[..., :-1]).float()
            if valid is None:
                valid = same
            else:
                valid[..., :-1] *= same
        out = self.apply(inputs, training=training, rngs=rngs,
                         return_hidden=c.fused_loss, logits_dtype=c.dtype,
                         segment_ids=seg, positions=pos)
        if c.fused_loss:
            return ops.fused_lm_head_loss(out, self.embedding.table, targets,
                                          valid=valid)
        ce = ops.softmax_cross_entropy_with_integer_labels(out, targets)
        if valid is None:
            return ce.mean()
        return (ce * valid).sum() / valid.sum().clamp(min=1.0)
