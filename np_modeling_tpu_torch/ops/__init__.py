"""Ops of the PyTorch port: plain functions on tensors with hand-written
backwards, and the wrappers of the hand-written CUDA kernels
(``ops.dispatch`` says which runs)."""

from np_modeling_tpu_torch.ops import dispatch, fused
from np_modeling_tpu_torch.ops.fused import (
    softmax_cross_entropy_fused, softmax_cross_entropy_fused_reference)
from np_modeling_tpu_torch.ops.activations import (gelu, gelu_exact,
                                                   get_activation, relu, silu)
from np_modeling_tpu_torch.ops.attention import (attention_reference,
                                                 flash_attention)
from np_modeling_tpu_torch.ops.embedding import embedding_lookup
from np_modeling_tpu_torch.ops.linear import linear
from np_modeling_tpu_torch.ops.matmul import matmul, matmul_reference
from np_modeling_tpu_torch.ops.losses import (
    cross_entropy_probs, fused_lm_head_loss, mse, softmax_cross_entropy,
    softmax_cross_entropy_with_integer_labels)
from np_modeling_tpu_torch.ops.normalization import (dropout,
                                                     dropout_with_mask,
                                                     layer_norm,
                                                     make_dropout_mask,
                                                     rms_norm)
from np_modeling_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference,
    paged_attention_split_reference)
from np_modeling_tpu_torch.ops.rope import apply_rope
from np_modeling_tpu_torch.ops.quantization import (
    WEIGHT_QUANT_TARGETS, QuantizedTensor, dequantize_int8, dequantize_params,
    int8_matmul, int8_matmul_reference, quantize_int8,
    quantize_int8_stochastic, quantize_params_int4, quantize_params_int8,
    stochastic_round_int8)

__all__ = ["QuantizedTensor", "WEIGHT_QUANT_TARGETS", "apply_rope",
           "attention_reference",
           "cross_entropy_probs", "dequantize_int8", "dequantize_params",
           "dispatch", "dropout", "dropout_with_mask", "embedding_lookup",
           "flash_attention", "fused", "fused_lm_head_loss", "gelu",
           "gelu_exact", "get_activation", "int8_matmul",
           "int8_matmul_reference", "layer_norm", "linear",
           "make_dropout_mask", "matmul",
           "matmul_reference", "mse", "paged_attention",
           "paged_attention_reference", "paged_attention_split_reference",
           "quantize_int8",
           "quantize_int8_stochastic", "quantize_params_int4",
           "quantize_params_int8", "relu", "rms_norm", "silu",
           "softmax_cross_entropy",
           "softmax_cross_entropy_fused",
           "softmax_cross_entropy_fused_reference",
           "softmax_cross_entropy_with_integer_labels",
           "stochastic_round_int8"]
