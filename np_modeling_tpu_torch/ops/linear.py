"""Affine op ``y = x @ w (+ b)`` over the last axis, with a hand-written
backward.

Counterpart of np_modeling_tpu/ops/linear.py: the forward and both
gradient products go through ``ops.matmul`` exactly as JAX calls its
``matmul`` (JAX :24-44), the transposes as ``trans_a``/``trans_b`` flags on
the stored tensors. By default those products are library products (cuBLAS
on the card; one fp32 accumulation, the bias added in fp32, one rounding to
x's dtype); under ``dispatch.force_kernels()`` on the card they launch K11,
the backward's two within the scopes the forward ran in.
The backward: ``db = sum(dy)`` and ``dw = x^T dy`` in w's dtype, ``dx = dy
w^T`` in x's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from np_modeling_tpu_torch.ops import dispatch
from np_modeling_tpu_torch.ops.matmul import matmul


class _Linear(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b):
        x2 = x.reshape(-1, x.shape[-1])
        y = matmul(x2, w, b, out_dtype=x.dtype)
        ctx.save_for_backward(x, w)
        ctx.has_b = b is not None
        ctx.scopes = dispatch.scopes()
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        dy2 = dy.reshape(-1, dy.shape[-1])
        db = dy2.float().sum(dim=0).to(w.dtype) if ctx.has_b else None
        with dispatch.within(ctx.scopes):       # the forward's scopes
            dw = matmul(x2, dy2, trans_a=True, out_dtype=w.dtype) \
                if ctx.needs_input_grad[1] else None
            dx = matmul(dy2, w, trans_b=True, out_dtype=x.dtype) \
                .reshape(x.shape) if ctx.needs_input_grad[0] else None
        return dx, dw, db


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = x @ w (+ b)``; leading dims of x are batch. w [in, out], b [out]."""
    return _Linear.apply(x, w, b)
