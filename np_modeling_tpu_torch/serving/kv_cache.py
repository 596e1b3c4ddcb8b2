"""Paged KV cache: fixed-size pages on the device, a host free list.

Counterpart of np_modeling_tpu/serving/kv_cache.py. Pages are
[num_kv_heads, total_pages, page_size, head_dim] tensors; each sequence owns
an ordered list of page indices (its page table). Appends write the pages
in place. Pairs with ops.paged_attention. ``quantize=True`` stores int8
pages with fp32 per-token scales [num_kv_heads, total_pages, page_size, 1]
(``ops.quantize_int8`` on each appended token), half the bytes of bf16
pages; ``attention_kwargs()`` hands the scales to ops.paged_attention.
Pages keep the head_dim they are given (JAX's layout): under 64,
ops.paged_attention pads them for each call on the card, where the serving
engine stores its own pages 64 wide instead.
"""

from __future__ import annotations

import dataclasses

import torch

from np_modeling_tpu_torch.ops.quantization import quantize_int8


class OutOfPagesError(RuntimeError):
    pass


@dataclasses.dataclass
class PagedKVCache:
    num_kv_heads: int
    head_dim: int
    total_pages: int
    page_size: int
    max_seqs: int
    dtype: torch.dtype = torch.float32   # fp32 or bf16 (unquantized pages)
    device: object = None
    quantize: bool = False

    def __post_init__(self):
        shape = (self.num_kv_heads, self.total_pages, self.page_size,
                 self.head_dim)
        store = torch.int8 if self.quantize else self.dtype
        self.k_pages = torch.zeros(shape, dtype=store, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=store, device=self.device)
        self.k_scales = self.v_scales = None
        if self.quantize:
            sshape = shape[:-1] + (1,)
            self.k_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=self.device)
            self.v_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=self.device)
        self._free = list(range(self.total_pages - 1, -1, -1))
        self._tables: dict[int, list[int]] = {}
        self._lengths: dict[int, int] = {}

    # ---- control plane (host) ------------------------------------------

    def allocate(self, seq_id: int) -> None:
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        self._tables[seq_id] = []
        self._lengths[seq_id] = 0

    def free(self, seq_id: int) -> None:
        self._free.extend(self._tables.pop(seq_id))
        del self._lengths[seq_id]

    def length(self, seq_id: int) -> int:
        return self._lengths[seq_id]

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def _page_for_append(self, seq_id: int, n_new: int) -> None:
        """Grow the sequence's page table to cover n_new more tokens."""
        need = -(-(self._lengths[seq_id] + n_new) // self.page_size)
        while len(self._tables[seq_id]) < need:
            if not self._free:
                raise OutOfPagesError(
                    f"out of KV pages ({self.total_pages} total)")
            self._tables[seq_id].append(self._free.pop())

    # ---- data plane (device) -------------------------------------------

    def append(self, seq_id: int, k_new: torch.Tensor,
               v_new: torch.Tensor) -> None:
        """Append tokens. k_new/v_new: [num_kv_heads, n_new, head_dim]."""
        n_new = k_new.shape[1]
        self._page_for_append(seq_id, n_new)
        pos = self._lengths[seq_id]
        table = self._tables[seq_id]
        writes = [(self.k_pages, k_new), (self.v_pages, v_new)]
        if self.quantize:
            kq, vq = quantize_int8(k_new), quantize_int8(v_new)
            writes = [(self.k_pages, kq.values), (self.v_pages, vq.values),
                      (self.k_scales, kq.scales), (self.v_scales, vq.scales)]
        start = 0
        while start < n_new:        # one copy per run within a page
            tok = pos + start
            page = table[tok // self.page_size]
            slot = tok % self.page_size
            run = min(n_new - start, self.page_size - slot)
            for buf, new in writes:
                buf[:, page, slot:slot + run] = new[:, start:start + run]
            start += run
        self._lengths[seq_id] = pos + n_new

    def attention_kwargs(self):
        """Extra kwargs for ops.paged_attention (scales when quantized)."""
        if self.quantize:
            return {"k_scales": self.k_scales, "v_scales": self.v_scales}
        return {}

    def batch_views(self, seq_ids):
        """(lengths [B], page_indices [B, max_pages]) int32 on the device."""
        max_pages = max((len(self._tables[s]) for s in seq_ids), default=1)
        max_pages = max(max_pages, 1)
        tables = torch.zeros((len(seq_ids), max_pages), dtype=torch.int32)
        lengths = torch.zeros(len(seq_ids), dtype=torch.int32)
        for i, s in enumerate(seq_ids):
            t = self._tables[s]
            tables[i, :len(t)] = torch.tensor(t, dtype=torch.int32)
            lengths[i] = self._lengths[s]
        return lengths.to(self.device), tables.to(self.device)
