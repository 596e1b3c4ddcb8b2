"""Serving of the PyTorch port: paged KV cache, generation engine and the
sampling processors."""

from np_modeling_tpu_torch.serving.engine import GenerationEngine
from np_modeling_tpu_torch.serving.kv_cache import (OutOfPagesError,
                                                    PagedKVCache)
from np_modeling_tpu_torch.serving.sampling import SamplingParams

__all__ = ["GenerationEngine", "OutOfPagesError", "PagedKVCache",
           "SamplingParams"]
