"""Models of the PyTorch port."""

from np_modeling_tpu_torch.models.transformer_lm import (GPT, GPTConfig,
                                                         check_ported)

__all__ = ["GPT", "GPTConfig", "check_ported"]
