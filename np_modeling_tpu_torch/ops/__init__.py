"""Ops of the PyTorch port: plain functions on tensors with hand-written
backwards, and the wrappers of the hand-written CUDA kernels
(``ops.dispatch`` says which runs)."""

from np_modeling_tpu_torch.ops import dispatch, fused
from np_modeling_tpu_torch.ops.activations import gelu, get_activation, relu
from np_modeling_tpu_torch.ops.attention import (attention_reference,
                                                 flash_attention)
from np_modeling_tpu_torch.ops.embedding import embedding_lookup
from np_modeling_tpu_torch.ops.linear import linear
from np_modeling_tpu_torch.ops.losses import (
    cross_entropy_probs, fused_lm_head_loss, mse, softmax_cross_entropy,
    softmax_cross_entropy_with_integer_labels)
from np_modeling_tpu_torch.ops.normalization import (dropout,
                                                     dropout_with_mask,
                                                     layer_norm,
                                                     make_dropout_mask)
from np_modeling_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference)

__all__ = ["attention_reference", "cross_entropy_probs", "dispatch",
           "dropout", "dropout_with_mask", "embedding_lookup",
           "flash_attention", "fused", "fused_lm_head_loss", "gelu",
           "get_activation", "layer_norm", "linear", "make_dropout_mask",
           "mse", "paged_attention", "paged_attention_reference", "relu",
           "softmax_cross_entropy",
           "softmax_cross_entropy_with_integer_labels"]
