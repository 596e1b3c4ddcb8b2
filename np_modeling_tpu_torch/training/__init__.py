"""Training of the PyTorch port: optimizers as gradient transformations
(functional and donated), schedules, the Trainer, the data iterators and
checkpoints, and LoRA adapters."""

from np_modeling_tpu_torch.training import data, schedules
from np_modeling_tpu_torch.training.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
from np_modeling_tpu_torch.training.lora import (ALL_LINEAR_TARGETS,
                                                 ATTENTION_TARGETS,
                                                 lora_finalize, lora_init,
                                                 lora_merge,
                                                 make_lora_train_step)
from np_modeling_tpu_torch.training.optimizers import (AdamState, EmaState,
                                                       Optimizer, adafactor,
                                                       adam, adamw,
                                                       apply_updates, chain,
                                                       clip_by_global_norm,
                                                       ema_params, lion,
                                                       momentum, muon, sgd,
                                                       skip_nonfinite,
                                                       update_ema_)
from np_modeling_tpu_torch.training.trainer import (Trainer, make_eval_step,
                                                    make_train_step,
                                                    resolve_loss)

__all__ = ["ALL_LINEAR_TARGETS", "ATTENTION_TARGETS", "AdamState",
           "EmaState", "Optimizer", "Trainer", "adafactor",
           "adam", "adamw", "apply_updates", "chain", "clip_by_global_norm",
           "data", "ema_params", "lion", "load_checkpoint",
           "lora_finalize", "lora_init", "lora_merge", "make_lora_train_step",
           "make_eval_step", "make_train_step", "momentum", "muon",
           "resolve_loss", "save_checkpoint", "schedules", "sgd",
           "skip_nonfinite", "update_ema_"]
