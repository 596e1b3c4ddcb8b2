"""Rotary position embeddings (RoPE) with a hand-written backward.

Counterpart of np_modeling_tpu/ops/rope.py. Interleaved feature pairs (2i,
2i+1) rotate by ``position * base ** (-2i / d)`` (not HF's half split);
angles, cos and sin are fp32 and the output is rounded once to x's dtype.
The rotation is orthogonal, so the backward is the inverse rotation of the
cotangent and keeps nothing but the positions (JAX :111-121).
"""

from __future__ import annotations

import torch


def _rotate(x, positions, base, sign, rope_dim):
    """x [b, h, s, d]; positions [s] or [b, s]; sign +1 forward, -1 the
    inverse. ``rope_dim``: rotate only the first rope_dim features."""
    rest = None
    if rope_dim is not None and rope_dim < x.shape[-1]:
        x, rest = x[..., :rope_dim], x[..., rope_dim:]
    d = x.shape[-1]
    inv_freq = torch.pow(torch.tensor(base, dtype=torch.float32),
                         -torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] \
        * inv_freq * sign
    ang = ang[None, None] if ang.dim() == 2 else ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)
    return out if rest is None else torch.cat([out, rest], dim=-1)


class _Rope(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, positions, base, rope_dim):
        ctx.save_for_backward(positions)
        ctx.base, ctx.rope_dim = base, rope_dim
        return _rotate(x, positions, base, 1.0, rope_dim)

    @staticmethod
    def backward(ctx, dy):
        (positions,) = ctx.saved_tensors
        return _rotate(dy, positions, ctx.base, -1.0, ctx.rope_dim), None, \
            None, None


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0, rope_dim: int | None = None,
               scaling: tuple | None = None) -> torch.Tensor:
    """Rotate interleaved (even, odd) feature pairs of x [b, h, s, d] by
    position-dependent angles; positions [s] or [b, s] (integers).
    ``rope_dim``: partial rotary, the first rope_dim features only.
    ``scaling`` (long-context frequency rules) is not ported: no
    configuration the port builds uses it."""
    if scaling is not None:
        raise NotImplementedError(
            f"RoPE scaling {scaling[0]!r} is not ported yet (ROADMAP.md "
            "Queue 1)")
    if x.shape[-1] % 2 or (rope_dim is not None and rope_dim % 2):
        raise ValueError(f"RoPE rotates pairs: head_dim {x.shape[-1]}, "
                         f"rope_dim {rope_dim}")
    return _Rope.apply(x, positions, float(base), rope_dim)
