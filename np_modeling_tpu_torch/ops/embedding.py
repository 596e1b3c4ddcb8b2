"""Embedding lookup with a hand-written backward (scatter-add gradient).

Counterpart of np_modeling_tpu/ops/embedding.py ``embedding_lookup``: the
gradient of the gather is a scatter-add of dy into a zero table (JAX
:43-56), in the table's dtype.
"""

from __future__ import annotations

import torch


class _EmbeddingLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, ids):
        ids = ids.long()
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        return table[ids]

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        vocab, d = ctx.table_shape
        dtable = torch.zeros((vocab, d), dtype=dy.dtype, device=dy.device)
        dtable.index_add_(0, ids.reshape(-1), dy.reshape(-1, d))
        return dtable, None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: [vocab, d]; ids: integer tensor; returns ids.shape + (d,)."""
    return _EmbeddingLookup.apply(table, ids)
