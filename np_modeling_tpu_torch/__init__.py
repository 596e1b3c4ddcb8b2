"""np_modeling_tpu_torch: the PyTorch and CUDA port of np_modeling_tpu.

It mirrors the JAX package's layout (ops, nn, models, serving, utils) and
imports no JAX. Kernels are written by hand for Hopper (``csrc/``), built at
first use, and launched on CUDA tensors; on CPU tensors every op runs its
plain PyTorch version. This slice is the serving path (GPT-2 family,
greedy, chunked prefill over paged attention).
"""

from np_modeling_tpu_torch import models, nn, ops, serving, utils

__all__ = ["models", "nn", "ops", "serving", "utils"]
