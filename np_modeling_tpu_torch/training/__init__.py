"""Training of the PyTorch port: optimizers as gradient transformations."""

from np_modeling_tpu_torch.training.optimizers import (AdamState, Optimizer,
                                                       adam, apply_updates,
                                                       sgd)

__all__ = ["AdamState", "Optimizer", "adam", "apply_updates", "sgd"]
