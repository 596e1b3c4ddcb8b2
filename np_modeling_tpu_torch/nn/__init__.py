"""Modules of the PyTorch port (``torch.nn.Module``s owning fp32 params)."""

from np_modeling_tpu_torch.nn import initializers
from np_modeling_tpu_torch.nn.attention import MultiHeadAttention
from np_modeling_tpu_torch.nn.embedding import Embedding
from np_modeling_tpu_torch.nn.linear import Dense, LayerNorm, Linear
from np_modeling_tpu_torch.nn.module import maybe_cast
from np_modeling_tpu_torch.nn.transformer import TransformerEncoderBlock

__all__ = ["Dense", "Embedding", "LayerNorm", "Linear", "MultiHeadAttention",
           "TransformerEncoderBlock", "initializers", "maybe_cast"]
