"""np_modeling_tpu_torch: the PyTorch and CUDA port of np_modeling_tpu.

It mirrors the JAX package's layout (ops, nn, models, training, serving,
utils) and imports no JAX. Kernels are written by hand for Hopper
(``csrc/``), built at first use, and launched on CUDA tensors; on CPU
tensors every op runs its plain PyTorch version. Ported so far: the serving
path (GPT-2 family, greedy, chunked prefill over paged attention) and the
GPT training step (``GPT.loss`` with hand-written backwards over flash
attention, and Adam).
"""

from np_modeling_tpu_torch import models, nn, ops, serving, training, utils

__all__ = ["models", "nn", "ops", "serving", "training", "utils"]
