"""LayerNorm forward: statistics in fp32, output in the input's dtype.

Counterpart of np_modeling_tpu/ops/normalization.py ``_layer_norm_impl``
(the LayerNorm Pallas kernel there is opt-in and off the serving path).
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-3) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    yhat = (xf - mean) * torch.rsqrt(var + eps)
    return (gamma.float() * yhat + beta.float()).to(x.dtype)
