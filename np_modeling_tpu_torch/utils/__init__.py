"""Utilities of the PyTorch port."""

from np_modeling_tpu_torch.utils.convert import (adapters_from_numpy,
                                                 adapters_to_numpy,
                                                 load_params,
                                                 params_from_numpy,
                                                 params_to_numpy,
                                                 tree_to_numpy)

__all__ = ["adapters_from_numpy", "adapters_to_numpy", "load_params",
           "params_from_numpy", "params_to_numpy", "tree_to_numpy"]
