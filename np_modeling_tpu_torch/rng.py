"""Dropout seeds (host integers, never read from a device tensor) and the
categorical draw of sampling.

JAX threads a key and folds a layer index or a site's salt into it with
``jax.random.fold_in``. The port's counterpart is a 64-bit integer seed:
``seed_of`` draws one 63-bit integer from a CPU ``torch.Generator`` (or
passes an integer through), and ``fold_seed`` mixes a salt into a seed with
splitmix64. The dropout kernel and its plain twin (``ops.fused``) take the
resulting integer.

``categorical`` is the draw of ``jax.random.categorical`` (Gumbel-max: the
argmax of the logits plus Gumbel noise) from a ``torch.Generator`` on the
logits' device. Its bits are torch's, not JAX's: the same seed draws the
same tokens in the port, and other tokens than JAX's.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """The splitmix64 finaliser (a bijection of 64-bit integers)."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_seed(seed: int, salt: int) -> int:
    """A seed for the stream ``salt`` of ``seed`` (the port's ``fold_in``)."""
    return _mix64(seed ^ _mix64(salt & _MASK64))


def seed_of(rng) -> int:
    """A 64-bit seed: an int as it is, or one 63-bit draw from a CPU
    ``torch.Generator`` (which advances it)."""
    if isinstance(rng, torch.Generator):
        if rng.device.type != "cpu":
            raise ValueError("dropout seeds come from a CPU torch.Generator "
                             f"(reading one from {rng.device} would sync)")
        return int(torch.randint(2 ** 63 - 1, (1,), generator=rng))
    if isinstance(rng, bool) or not isinstance(rng, int) \
            or not 0 <= rng <= _MASK64:
        raise TypeError(f"a dropout rng is a torch.Generator or a 64-bit "
                        f"integer seed, not {rng!r}")
    return rng


def categorical(logits: torch.Tensor, generator: torch.Generator):
    """One draw a row of ``softmax(logits)`` over the last axis (-inf logits
    are never drawn), as int64: argmax(logits + Gumbel noise), the noise
    from ``generator`` (on the logits' device)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)
