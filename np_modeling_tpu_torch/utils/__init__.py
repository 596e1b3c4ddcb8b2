"""Utilities of the PyTorch port."""

from np_modeling_tpu_torch.utils.convert import params_from_numpy

__all__ = ["params_from_numpy"]
