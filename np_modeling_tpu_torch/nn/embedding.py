"""Token / positional embedding. Counterpart of
np_modeling_tpu/nn/embedding.py (parameter ``table`` [vocab, d], N(0, 0.02)
init)."""

from __future__ import annotations

import torch
from torch import nn

from np_modeling_tpu_torch.nn import initializers
from np_modeling_tpu_torch.ops.embedding import embedding_lookup


class Embedding(nn.Module):
    def __init__(self, vocab_size: int, features: int, device=None):
        super().__init__()
        self.table = nn.Parameter(torch.empty(
            (vocab_size, features), dtype=torch.float32, device=device))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.table.copy_(initializers.normal(generator, self.table.shape))
        return self

    def forward(self, ids):
        return embedding_lookup(self.table, ids)
