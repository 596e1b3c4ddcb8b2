"""Embedding lookup (forward only). Counterpart of
np_modeling_tpu/ops/embedding.py ``embedding_lookup``."""

from __future__ import annotations

import torch


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: [vocab, d]; ids: integer tensor; returns ids.shape + (d,)."""
    return table[ids.long()]
