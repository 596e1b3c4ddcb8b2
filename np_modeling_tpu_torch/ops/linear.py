"""Affine op ``y = x @ w (+ b)`` over the last axis, with a hand-written
backward.

Counterpart of np_modeling_tpu/ops/linear.py with ops/matmul.py's default
path: one fp32 accumulation of the product, the bias added in fp32, one
rounding to x's dtype. The backward (JAX :31-47): ``db = sum(dy)`` and
``dw = x^T dy`` in w's dtype, ``dx = dy w^T`` in x's dtype. These products
run outside any Pallas kernel in JAX, so here they are library matrix
products (cuBLAS on the card, with TF32 left to the caller's setting).
"""

from __future__ import annotations

from typing import Optional

import torch


def mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """2-D ``a @ b`` accumulated in fp32 and rounded once to ``out_dtype``.

    On CUDA a bf16 product with an fp32 result is ``aten::mm.dtype``; the
    CPU build has no such kernel, and there the product of the fp32 copies
    is exact for bf16 operands."""
    if a.device.type == "cuda":
        if a.dtype == out_dtype:
            return torch.mm(a, b)
        return torch.mm(a, b, out_dtype=out_dtype)
    return torch.mm(a.float(), b.float()).to(out_dtype)


class _Linear(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b):
        x2 = x.reshape(-1, x.shape[-1])
        y = mm(x2, w.to(x.dtype), torch.float32)
        if b is not None:
            y = y + b.float()
        ctx.save_for_backward(x, w)
        ctx.has_b = b is not None
        return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        dy2 = dy.reshape(-1, dy.shape[-1]).to(x.dtype)
        db = dy2.float().sum(dim=0).to(w.dtype) if ctx.has_b else None
        dw = mm(x2.t(), dy2, w.dtype) if ctx.needs_input_grad[1] else None
        dx = mm(dy2, w.to(x.dtype).t(), x.dtype).reshape(x.shape) \
            if ctx.needs_input_grad[0] else None
        return dx, dw, db


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = x @ w (+ b)``; leading dims of x are batch. w [in, out], b [out]."""
    return _Linear.apply(x, w, b)
