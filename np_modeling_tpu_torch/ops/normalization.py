"""LayerNorm and dropout, each with a hand-written backward.

Counterpart of np_modeling_tpu/ops/normalization.py.

``layer_norm``: statistics in fp32, output in the input's dtype. On a CUDA
tensor the forward and the backward are the hand-written kernels K8
(``ops.fused``, csrc/fused.cu); on the CPU, or under
``dispatch.force_plain()``, their plain versions. The residual is (x,
gamma); the backward recomputes the statistics and uses the fused
two-reduction form
    dx = rstd * (dyhat - mean(dyhat) - yhat * mean(dyhat * yhat)),
returning dgamma/dbeta in gamma's dtype (JAX :63-83).

``dropout``: inverted dropout from a seed (JAX :122-171). On a CUDA tensor
it is kernel K7 (``ops.fused.dropout_prng``: the mask is drawn in the
kernel and drawn again in the backward, never stored). Elsewhere it is the
explicit-mask path, ``dropout_with_mask(x, make_dropout_mask(...))``, whose
mask is the plain twin of the kernel's bits, so both paths drop the same
elements.
"""

from __future__ import annotations

import torch

from np_modeling_tpu_torch import rng
from np_modeling_tpu_torch.ops import dispatch, fused


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.kernel = dispatch.use_kernel(x)
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        if ctx.kernel:
            return fused.layer_norm_fwd_cuda(x, gamma, beta, eps)
        return fused.layer_norm_fwd_plain(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dz):
        x, gamma = ctx.saved_tensors
        if ctx.kernel:
            dx, dgamma, dbeta = fused.layer_norm_bwd_cuda(x, gamma, dz,
                                                          ctx.eps)
        else:
            dx, dgamma, dbeta = fused.layer_norm_bwd_plain(x, gamma, dz,
                                                           ctx.eps)
        return dx, dgamma, dbeta, None


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-3) -> torch.Tensor:
    """Last-axis LayerNorm (default eps 1e-3, the reference framework's)."""
    return _LayerNorm.apply(x, gamma, beta, eps)


def make_dropout_mask(seed: int, shape, rate: float, device=None):
    """Keep-mask (True = keep) with keep probability 1 - rate: the bits the
    dropout kernel draws for ``seed`` (``fused.philox_keep_mask``)."""
    return fused.philox_keep_mask(seed, shape, rate, device)


class _DropoutWithMask(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mask, rate):
        ctx.save_for_backward(mask)
        ctx.rate = rate
        return torch.where(mask, fused.dropout_scale(x, rate), 0.0)

    @staticmethod
    def backward(ctx, dy):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, fused.dropout_scale(dy, ctx.rate), 0.0), \
            None, None


def dropout_with_mask(x: torch.Tensor, mask: torch.Tensor,
                      rate: float) -> torch.Tensor:
    """Inverted dropout given an explicit keep-mask: kept units divided by
    the keep probability in x's dtype, as JAX's ``x / keep`` does; the
    backward reuses the mask."""
    return _DropoutWithMask.apply(x, mask, rate)


def dropout(x: torch.Tensor, seed, rate: float,
            training: bool = True) -> torch.Tensor:
    """Functional inverted dropout. ``seed``: a 64-bit integer, or a CPU
    ``torch.Generator`` to draw one from. ``training=False`` or ``rate ==
    0`` is the identity and launches nothing."""
    if not training or rate == 0.0:
        return x
    if seed is None:
        raise ValueError("dropout(training=True, rate>0) requires a seed")
    seed = rng.seed_of(seed)
    if dispatch.use_kernel(x):
        return fused.dropout_prng(x, seed, rate)
    return dropout_with_mask(x, make_dropout_mask(seed, x.shape, rate,
                                                  x.device), rate)


# Kernel launches since import (or since a caller reset them to 0): a run
# shows with them that its LayerNorms and dropouts went through K8 and K7.
layer_norm.launches_fwd = 0
layer_norm.launches_bwd = 0
dropout.launches = 0
