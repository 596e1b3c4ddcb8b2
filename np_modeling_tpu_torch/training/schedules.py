"""Learning-rate schedules as ``step -> lr`` functions.

Counterpart of np_modeling_tpu/training/schedules.py (:18-47). ``step`` is
the optimizer's count, an int32 tensor on the parameters' device; a
schedule returns an fp32 tensor on that device and never syncs the host.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable


def constant(value: float) -> Schedule:
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=step.device)


def linear_warmup(peak: float, warmup_steps: int) -> Schedule:
    def fn(step):
        frac = torch.clamp(step.float() / max(warmup_steps, 1), max=1.0)
        return peak * frac
    return fn


def cosine_decay(peak: float, decay_steps: int,
                 alpha: float = 0.0) -> Schedule:
    def fn(step):
        frac = torch.clamp(step.float() / decay_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return peak * ((1 - alpha) * cos + alpha)
    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  end_value: float = 0.0) -> Schedule:
    """Linear warmup then cosine decay to ``end_value``: lr 0 at step 0."""
    alpha = end_value / peak if peak else 0.0
    decay = cosine_decay(peak, max(total_steps - warmup_steps, 1), alpha)

    def fn(step):
        step = step.float()
        warm = peak * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           decay(step - warmup_steps))
    return fn
