"""Serving of the PyTorch port: paged KV cache and generation engine."""

from np_modeling_tpu_torch.serving.engine import GenerationEngine
from np_modeling_tpu_torch.serving.kv_cache import (OutOfPagesError,
                                                    PagedKVCache)

__all__ = ["GenerationEngine", "OutOfPagesError", "PagedKVCache"]
