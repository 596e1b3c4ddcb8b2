"""LayerNorm with a hand-written backward: statistics in fp32, output in the
input's dtype.

Counterpart of np_modeling_tpu/ops/normalization.py ``layer_norm`` (the
LayerNorm Pallas kernel K8 there is opt-in and off the training path). The
residual is (x, gamma); the backward recomputes the statistics and uses the
fused two-reduction form
    dx = rstd * (dyhat - mean(dyhat) - yhat * mean(dyhat * yhat)),
returning dgamma/dbeta in gamma's dtype (JAX :63-83).
"""

from __future__ import annotations

import torch


def _stats(x, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf - mean) * rstd, rstd


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        yhat, _ = _stats(x, eps)
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return (gamma.float() * yhat + beta.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, dz):
        x, gamma = ctx.saved_tensors
        yhat, rstd = _stats(x, ctx.eps)
        dzf = dz.float()
        batch = tuple(range(dz.dim() - 1))
        dbeta = dzf.sum(dim=batch).to(gamma.dtype)
        dgamma = (dzf * yhat).sum(dim=batch).to(gamma.dtype)
        dyhat = dzf * gamma.float()
        m1 = dyhat.mean(dim=-1, keepdim=True)
        m2 = (dyhat * yhat).mean(dim=-1, keepdim=True)
        dx = (rstd * (dyhat - m1 - yhat * m2)).to(dz.dtype)
        return dx, dgamma, dbeta, None


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-3) -> torch.Tensor:
    """Last-axis LayerNorm (default eps 1e-3, the reference framework's)."""
    return _LayerNorm.apply(x, gamma, beta, eps)
