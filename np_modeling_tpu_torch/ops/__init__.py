"""Ops of the PyTorch port: plain functions on tensors with hand-written
backwards, and the wrappers of the hand-written CUDA kernels
(``ops.dispatch`` says which runs)."""

from np_modeling_tpu_torch.ops import dispatch
from np_modeling_tpu_torch.ops.activations import gelu, get_activation, relu
from np_modeling_tpu_torch.ops.attention import (attention_reference,
                                                 flash_attention)
from np_modeling_tpu_torch.ops.embedding import embedding_lookup
from np_modeling_tpu_torch.ops.linear import linear
from np_modeling_tpu_torch.ops.losses import (
    fused_lm_head_loss, softmax_cross_entropy_with_integer_labels)
from np_modeling_tpu_torch.ops.normalization import layer_norm
from np_modeling_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference)

__all__ = ["attention_reference", "dispatch", "embedding_lookup",
           "flash_attention", "fused_lm_head_loss", "gelu", "get_activation",
           "layer_norm", "linear", "paged_attention",
           "paged_attention_reference", "relu",
           "softmax_cross_entropy_with_integer_labels"]
