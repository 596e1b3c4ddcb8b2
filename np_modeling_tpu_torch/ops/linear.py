"""Affine op ``y = x @ w (+ b)`` over the last axis, fp32 accumulate.

Counterpart of np_modeling_tpu/ops/linear.py with ops/matmul.py's default
path (dot_general with an fp32 result, bias added in fp32, cast to x's
dtype). That product runs outside any Pallas kernel in JAX, so here it is
``torch.matmul``, which accumulates in fp32 for fp32 and bf16 inputs alike
(with TF32 off, the caller's setting). One difference in bf16: the product
is rounded to bf16 before the fp32 bias add, where JAX rounds once after.
"""

from __future__ import annotations

from typing import Optional

import torch


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x, w.to(x.dtype))
    if b is None:
        return y
    return (y.float() + b.float()).to(x.dtype)
