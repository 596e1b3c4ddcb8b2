"""Utilities of the PyTorch port."""

from np_modeling_tpu_torch.utils.convert import (load_params,
                                                 params_from_numpy,
                                                 params_to_numpy,
                                                 tree_to_numpy)

__all__ = ["load_params", "params_from_numpy", "params_to_numpy",
           "tree_to_numpy"]
