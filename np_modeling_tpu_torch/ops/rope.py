"""Rotary position embeddings (RoPE) with a hand-written backward.

Counterpart of np_modeling_tpu/ops/rope.py. Interleaved feature pairs (2i,
2i+1) rotate by ``position * base ** (-2i / d)`` (not HF's half split);
angles, cos and sin are fp32 and the output is rounded once to x's dtype.
The rotation is orthogonal, so the backward is the inverse rotation of the
cotangent and keeps nothing but the positions (JAX :111-121). YaRN
(DeepSeek-V2's long-context rule, JAX :15-46, :82-86) mixes interpolated
and extrapolated frequencies by a linear ramp between its beta correction
dims and multiplies cos and sin by its ``mscale``: a scaled rotation, whose
backward is the inverse rotation times the same mscale.
"""

from __future__ import annotations

import math

import torch


def _yarn_inv_freq(inv_freq, scaling, base, d):
    """JAX ``_scale_inv_freq``'s ("yarn", factor, beta_fast, beta_slow,
    original_max, mscale) rule on the fp32 frequencies [d / 2]."""
    _, factor, beta_fast, beta_slow, orig, _ = scaling

    def corr_dim(n_rot):          # the dim whose wavelength is orig / n_rot
        return (d * math.log(orig / (n_rot * 2.0 * math.pi))
                / (2.0 * math.log(base)))

    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), d - 1)
    if low == high:
        high = high + 0.001       # HF's singularity guard, as JAX
    ramp = torch.clamp((torch.arange(d // 2, dtype=torch.float32,
                                     device=inv_freq.device) - low)
                       / (high - low), 0.0, 1.0)
    extrap = 1.0 - ramp
    return inv_freq / factor * (1.0 - extrap) + inv_freq * extrap


def _rotate(x, positions, base, sign, rope_dim, scaling=None):
    """x [b, h, s, d]; positions [s] or [b, s]; sign +1 forward, -1 the
    inverse. ``rope_dim``: rotate only the first rope_dim features.
    ``scaling``: None or the yarn tuple."""
    rest = None
    if rope_dim is not None and rope_dim < x.shape[-1]:
        x, rest = x[..., :rope_dim], x[..., rope_dim:]
    d = x.shape[-1]
    inv_freq = torch.pow(torch.tensor(base, dtype=torch.float32),
                         -torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    if scaling is not None:
        inv_freq = _yarn_inv_freq(inv_freq, scaling, base, d)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] \
        * inv_freq * sign
    ang = ang[None, None] if ang.dim() == 2 else ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if scaling is not None and scaling[5] != 1.0:
        cos, sin = cos * scaling[5], sin * scaling[5]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)
    return out if rest is None else torch.cat([out, rest], dim=-1)


class _Rope(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, positions, base, rope_dim, scaling):
        ctx.save_for_backward(positions)
        ctx.base, ctx.rope_dim, ctx.scaling = base, rope_dim, scaling
        return _rotate(x, positions, base, 1.0, rope_dim, scaling)

    @staticmethod
    def backward(ctx, dy):
        (positions,) = ctx.saved_tensors
        return _rotate(dy, positions, ctx.base, -1.0, ctx.rope_dim,
                       ctx.scaling), None, None, None, None


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0, rope_dim: int | None = None,
               scaling: tuple | None = None) -> torch.Tensor:
    """Rotate interleaved (even, odd) feature pairs of x [b, h, s, d] by
    position-dependent angles; positions [s] or [b, s] (integers).
    ``rope_dim``: partial rotary, the first rope_dim features only.
    ``scaling``: ("yarn", factor, beta_fast, beta_slow, original_max,
    mscale); "linear" and "llama3" are not ported yet."""
    if scaling is not None and scaling[0] != "yarn":
        raise NotImplementedError(
            f"RoPE scaling {scaling[0]!r} is not ported yet (ROADMAP.md "
            "Queue 1)")
    if x.shape[-1] % 2 or (rope_dim is not None and rope_dim % 2):
        raise ValueError(f"RoPE rotates pairs: head_dim {x.shape[-1]}, "
                         f"rope_dim {rope_dim}")
    return _Rope.apply(x, positions, float(base), rope_dim, scaling)
