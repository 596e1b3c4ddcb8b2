"""Modules of the PyTorch port (``torch.nn.Module``s owning fp32 params)."""

from np_modeling_tpu_torch.nn import initializers
from np_modeling_tpu_torch.nn.attention import MultiHeadAttention
from np_modeling_tpu_torch.nn.embedding import Embedding
from np_modeling_tpu_torch.nn.linear import (Dense, Dropout, Int8Weight,
                                             LayerNorm, Linear, RMSNorm)
from np_modeling_tpu_torch.nn.module import (Sequential, maybe_cast,
                                             resolve_rngs, split_rngs)
from np_modeling_tpu_torch.nn.transformer import TransformerEncoderBlock

__all__ = ["Dense", "Dropout", "Embedding", "Int8Weight", "LayerNorm",
           "Linear", "MultiHeadAttention", "RMSNorm", "Sequential",
           "TransformerEncoderBlock", "initializers", "maybe_cast",
           "resolve_rngs", "split_rngs"]
