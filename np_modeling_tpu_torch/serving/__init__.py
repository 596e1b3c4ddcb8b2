"""Serving of the PyTorch port: paged KV cache, the GPT generation engine,
the encoder-decoder (T5) engine, the sampling processors and the grammar
constraints."""

from np_modeling_tpu_torch.serving.constrain import (TokenDFA,
                                                     dfa_from_choices,
                                                     dfa_from_json_schema,
                                                     dfa_from_regex)
from np_modeling_tpu_torch.serving.engine import GenerationEngine
from np_modeling_tpu_torch.serving.kv_cache import (OutOfPagesError,
                                                    PagedKVCache)
from np_modeling_tpu_torch.serving.sampling import SamplingParams
from np_modeling_tpu_torch.serving.seq2seq_engine import Seq2SeqEngine

__all__ = ["GenerationEngine", "OutOfPagesError", "PagedKVCache",
           "SamplingParams", "Seq2SeqEngine", "TokenDFA", "dfa_from_choices",
           "dfa_from_json_schema", "dfa_from_regex"]
