"""Models of the PyTorch port."""

from np_modeling_tpu_torch.models.beam import beam_search
from np_modeling_tpu_torch.models.bert import (BertConfig, BertEncoder,
                                               mlm_mask_tokens)
from np_modeling_tpu_torch.models.seq2seq import (Seq2SeqConfig,
                                                  Seq2SeqTransformer)
from np_modeling_tpu_torch.models.speculative import speculative_generate
from np_modeling_tpu_torch.models.t5 import T5, T5Config
from np_modeling_tpu_torch.models.transformer_lm import (GPT, GPTConfig,
                                                         check_ported)

__all__ = ["BertConfig", "BertEncoder", "GPT", "GPTConfig", "Seq2SeqConfig",
           "Seq2SeqTransformer", "T5", "T5Config", "beam_search",
           "check_ported", "mlm_mask_tokens", "speculative_generate"]
