"""Training of the PyTorch port: optimizers as gradient transformations,
schedules, the Trainer and the data iterators."""

from np_modeling_tpu_torch.training import data, schedules
from np_modeling_tpu_torch.training.optimizers import (AdamState, Optimizer,
                                                       adam, adamw,
                                                       apply_updates, chain,
                                                       clip_by_global_norm,
                                                       sgd)
from np_modeling_tpu_torch.training.trainer import (Trainer, make_eval_step,
                                                    make_train_step,
                                                    resolve_loss)

__all__ = ["AdamState", "Optimizer", "Trainer", "adam", "adamw",
           "apply_updates", "chain", "clip_by_global_norm", "data",
           "make_eval_step", "make_train_step", "resolve_loss", "schedules",
           "sgd"]
