"""Serving of the PyTorch port: paged KV cache, the GPT generation engine,
the encoder-decoder (T5) engine and the sampling processors."""

from np_modeling_tpu_torch.serving.engine import GenerationEngine
from np_modeling_tpu_torch.serving.kv_cache import (OutOfPagesError,
                                                    PagedKVCache)
from np_modeling_tpu_torch.serving.sampling import SamplingParams
from np_modeling_tpu_torch.serving.seq2seq_engine import Seq2SeqEngine

__all__ = ["GenerationEngine", "OutOfPagesError", "PagedKVCache",
           "SamplingParams", "Seq2SeqEngine"]
