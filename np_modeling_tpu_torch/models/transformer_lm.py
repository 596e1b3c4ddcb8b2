"""GPT-style causal decoder-only language model.

Counterpart of np_modeling_tpu/models/transformer_lm.py. ``GPTConfig`` has
the JAX config's fields and defaults (``dtype`` is a torch dtype here). The
port builds the GPT-2 family: learned positions, LayerNorm, pre-norm blocks
with an MLP FFN (relu or tanh-gelu), biases optional, tied embeddings; a
config outside it raises NotImplementedError. ``GPT`` owns its parameters
under the JAX parameter paths (``embedding.table``, ``layer_{i}.
self_attention.wq``, ``layer_{i}.dense1.linear.w``, ...). ``GPT.apply``
(dense forward over flash attention) comes with the training slice; the
serving engine runs the model.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from np_modeling_tpu_torch.nn import Embedding, LayerNorm
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
    """The model's modules and parameters, on ``device``. Parameters are
    allocated uninitialised: call ``init(generator)`` or load weights
    (``utils.convert.params_from_numpy``)."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        check_ported(config)
        c = self.config = config
        self.embedding = Embedding(c.vocab_size, c.d_model, device)
        self.pos_embedding = Embedding(c.max_len, c.d_model, device)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderBlock(
                c.d_model, c.num_heads, c.hidden_units,
                num_kv_heads=c.num_kv_heads, dtype=c.dtype,
                activation=c.activation, ln_eps=c.ln_eps,
                use_bias=c.use_bias, qkv_bias=c.qkv_bias,
                head_dim=c.head_dim, device=device))
        self.final_norm = LayerNorm(c.d_model, c.ln_eps, device)

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
