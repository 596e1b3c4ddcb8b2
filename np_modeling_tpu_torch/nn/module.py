"""Compute-dtype handling (mixed precision).

Counterpart of np_modeling_tpu/nn/module.py ``maybe_cast``. The port's
modules are ``torch.nn.Module``s that own their parameters; parameters stay
fp32 and each module casts them to its compute ``dtype`` at use.
"""

from __future__ import annotations


def maybe_cast(x, dtype):
    """Cast to a compute dtype; None (for either) keeps ``x`` as it is."""
    if x is None or dtype is None:
        return x
    return x.to(dtype)
