"""Ops of the PyTorch port: plain functions on tensors, and the wrappers of
the hand-written CUDA kernels (``ops.dispatch`` says which runs)."""

from np_modeling_tpu_torch.ops import dispatch
from np_modeling_tpu_torch.ops.activations import gelu, get_activation, relu
from np_modeling_tpu_torch.ops.embedding import embedding_lookup
from np_modeling_tpu_torch.ops.linear import linear
from np_modeling_tpu_torch.ops.normalization import layer_norm
from np_modeling_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference)

__all__ = ["dispatch", "embedding_lookup", "gelu", "get_activation",
           "layer_norm", "linear", "paged_attention",
           "paged_attention_reference", "relu"]
