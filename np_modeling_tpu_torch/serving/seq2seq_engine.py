"""Encoder-decoder (T5) serving: continuous batching on a paged KV cache.

Counterpart of np_modeling_tpu/serving/seq2seq_engine.py ``Seq2SeqEngine``,
over the port's ``models.T5``:

- Admission encodes one source, padded to ``max_src_len`` and masked by
  its length (``T5.encode(src_valid=)``: K1 with the bias and segment ids
  on the card), and projects every decoder layer's CROSS K/V from the
  memory once into the slot's buffers [max_seqs, h, max_src_len, d_kv]
  (fp32). The memory itself is not kept.
- A decode step runs every slot at once: the decoder's SELF-attention K/V
  is appended in place to shared fp32 pages (the GPT engine's page table
  and trash page), and T5's relative-position bias reaches paged attention
  as an additive bias over absolute cache positions
  (``ops.paged_attention(bias=)``: K3's bias option on the card), gathered
  from a [h, n_pos] by-distance table with ``query_pos - position``. The
  gather's [h, S, n_pos] result is handed over as its [S, h, n_pos] view,
  unit stride along positions, which the kernel reads by its strides.
  Cross-attention is a dense fp32 masked softmax against the slot's
  projected K/V (plain torch, as JAX leaves it to XLA).
- There is no decoder prompt: decoding starts from ``start_token``, so
  there is no prefill, and ``add_request`` returns no token.

T5's attention is unscaled (scale 1.0) and its projections have no bias.
Differences from the JAX engine: the model owns its weights, so there is
no ``params`` field; state tensors live on the model's device and are
updated in place instead of donated; the by-distance table is built once
at construction (the weights do not change while serving); ``step_many(n)``
is a Python loop of device steps that reads the tokens back once; sampled
tokens come from a ``torch.Generator`` seeded with ``seed``: the same seed
gives the same tokens, not JAX's ``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.models.t5 import relative_position_bucket
from np_modeling_tpu_torch.models.transformer_lm import GPT
from np_modeling_tpu_torch.nn.module import maybe_cast
from np_modeling_tpu_torch.serving.kv_cache import OutOfPagesError


@dataclasses.dataclass
class Seq2SeqEngine:
    """Continuous-batching decode for a :class:`models.T5`.

    ``max_src_len``: a slot's encoder budget (sources are padded to it).
    ``max_tgt_len``: decode capacity a sequence (the page table's width).
    ``start_token``: T5's decoder_start_token_id (0 = pad for HF
    checkpoints)."""

    model: object                # models.T5, on the serving device
    max_src_len: int = 128
    max_tgt_len: int = 128
    total_pages: int = 128
    page_size: int = 16
    max_seqs: int = 8
    start_token: int = 0
    temperature: float = 0.0     # 0: greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0                # the draws' torch.Generator

    def __post_init__(self):
        c = self.model.config
        h, dkv = c.num_heads, c.d_kv
        L, S = c.num_decoder_layers, self.max_seqs
        self.device = dev = self.model.embedding.table.device
        self.max_pages = -(-self.max_tgt_len // self.page_size)
        shape = (h, self.total_pages, self.page_size, dkv)
        cross = (S, h, self.max_src_len, dkv)

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._state = {
            "k_pages": [zeros(shape) for _ in range(L)],
            "v_pages": [zeros(shape) for _ in range(L)],
            "ck": [zeros(cross) for _ in range(L)],
            "cv": [zeros(cross) for _ in range(L)],
            "table": zeros((S, self.max_pages), torch.int32),
            "lengths": zeros((S,), torch.int32),
            "last_tok": torch.full((S,), self.start_token, dtype=torch.int32,
                                   device=dev),
            "active": zeros((S,), torch.bool),
            "src_len": zeros((S,), torch.int32),
        }
        # The last page is the trash page: inactive slots' appends land
        # there, so a step needs no masking of its writes.
        self._trash = self.total_pages - 1
        self._free = list(range(self.total_pages - 2, -1, -1))
        self._slots: dict[int, int] = {}         # seq_id -> slot
        self._host_len: dict[int, int] = {}      # authoritative lengths
        self._seq_pages: dict[int, list[int]] = {}
        self._gen = torch.Generator(device=dev).manual_seed(self.seed)
        self._by_dist = self._relpos_bias_rows()

    # ---- request lifecycle ------------------------------------------------

    @property
    def live(self):
        return sorted(self._slots)

    def capacity(self, seq_id: int) -> int:
        return self.max_tgt_len - self._host_len[seq_id]

    @torch.no_grad()
    def add_request(self, seq_id: int, src_tokens) -> None:
        """Encode a source and seed a decode slot. Decoding starts from
        ``start_token`` on the next :meth:`step`."""
        if seq_id in self._slots:
            raise ValueError(f"sequence {seq_id} already live")
        used = set(self._slots.values())
        free_slots = [s for s in range(self.max_seqs) if s not in used]
        if not free_slots:
            raise RuntimeError(f"all {self.max_seqs} slots busy")
        slot = free_slots[0]
        src = np.asarray(src_tokens)
        n = int(src.shape[0])
        if n > self.max_src_len:
            raise ValueError(f"source length {n} > max_src_len="
                             f"{self.max_src_len}")
        padded = np.zeros((self.max_src_len,), np.int64)
        padded[:n] = src
        self._admit_device(torch.from_numpy(padded).to(self.device), n, slot)
        self._slots[seq_id] = slot
        self._host_len[seq_id] = 0
        self._seq_pages[seq_id] = []

    def _admit_device(self, src, src_len: int, slot: int) -> None:
        """Encode (length-masked), project every decoder layer's cross K/V
        into the slot, reset the slot's decode bookkeeping."""
        m, st = self.model, self._state
        valid = torch.arange(self.max_src_len, device=self.device) < src_len
        memory = m.encode(src[None], src_valid=valid[None])
        for i in range(m.config.num_decoder_layers):
            ca = m._layer("dec", i).cross_attention
            st["ck"][i][slot] = ca._project(memory, ca.wk, None)[0].float()
            st["cv"][i][slot] = ca._project(memory, ca.wv, None)[0].float()
        st["table"][slot] = self._trash
        st["lengths"][slot] = 0
        st["last_tok"][slot] = self.start_token
        st["active"][slot] = True
        st["src_len"][slot] = src_len

    def finish(self, seq_id: int) -> None:
        slot = self._slots.pop(seq_id)
        del self._host_len[seq_id]
        self._free.extend(self._seq_pages.pop(seq_id))
        self._state["active"][slot] = False
        self._state["lengths"][slot] = 0

    # ---- page growth (host control plane) ----------------------------------

    def _grow_tables(self, n: int):
        """Cover ``n`` more tokens of every live sequence; all or nothing."""
        needs = []                            # (seq_id, slot, n_new_pages)
        for seq_id, slot in self._slots.items():
            if self._host_len[seq_id] + n > self.max_tgt_len:
                raise OutOfPagesError(
                    f"sequence {seq_id} would exceed the "
                    f"{self.max_tgt_len}-token capacity (max_tgt_len)")
            extra = -(-(self._host_len[seq_id] + n) // self.page_size) \
                - len(self._seq_pages[seq_id])
            if extra > 0:
                needs.append((seq_id, slot, extra))
        total = sum(e for *_, e in needs)
        if len(self._free) < total:
            raise OutOfPagesError(
                f"out of KV pages ({self.total_pages} total; need {total}, "
                f"free {len(self._free)})")
        upd = []                              # (slot, page_pos, new_page)
        for seq_id, slot, extra in needs:
            for _ in range(extra):
                self._seq_pages[seq_id].append(self._free.pop())
                upd.append((slot, len(self._seq_pages[seq_id]) - 1,
                            self._seq_pages[seq_id][-1]))
        if upd:
            slots, poss, pgs = (torch.tensor(u, dtype=torch.long)
                                for u in zip(*upd))
            table = self._state["table"]
            table[slots.to(self.device), poss.to(self.device)] = pgs.to(table)
        return self._state

    # ---- decode -------------------------------------------------------------

    @torch.no_grad()
    def step(self) -> dict:
        """Decode one token for every live sequence; {seq_id: token}."""
        if not self._slots:
            return {}
        st = self._grow_tables(1)
        self._state, toks = self._device_step(st)
        toks_np = toks.cpu().numpy()
        out = {}
        for seq_id, slot in sorted(self._slots.items()):
            self._host_len[seq_id] += 1
            out[seq_id] = int(toks_np[slot])
        return out

    @torch.no_grad()
    def step_many(self, n: int) -> dict:
        """Decode ``n`` tokens for every live sequence; {seq_id: [tokens]}.
        The host grows every page table for ``n`` tokens, runs ``n`` device
        steps and reads the tokens back once, after the loop."""
        if not self._slots:
            return {}
        st = self._grow_tables(n)
        toks = []
        for _ in range(n):
            st, t = self._device_step(st)
            toks.append(t)
        self._state = st
        toks_np = torch.stack(toks).cpu().numpy()          # [n, max_seqs]
        out = {}
        for seq_id, slot in sorted(self._slots.items()):
            self._host_len[seq_id] += n
            out[seq_id] = [int(t) for t in toks_np[:, slot]]
        return out

    # ---- the device step ----------------------------------------------------

    @torch.no_grad()
    def _relpos_bias_rows(self):
        """[h, n_pos] bias by DISTANCE: column d is the bias a query gives
        the key ``d`` positions behind it (rel = -d, causal bucketing), from
        the decoder's relpos table."""
        c = self.model.config
        dist = torch.arange(self.max_pages * self.page_size,
                            device=self.device)
        bucket = relative_position_bucket(
            -dist, bidirectional=False, num_buckets=c.relpos_buckets,
            max_distance=c.relpos_max_distance)
        return self.model.dec_relpos[bucket].t().float()

    @torch.no_grad()
    def _device_step(self, state, return_logits=False):
        """One token for every slot; no read back to the host. Returns
        (state, tokens [S], -1 for inactive slots) and, with
        ``return_logits``, the fp32 logits [S, vocab]."""
        m = self.model
        c = m.config
        active, lengths = state["active"], state["lengths"]
        n_pos = self.max_pages * self.page_size

        y = maybe_cast(m.embedding(state["last_tok"][:, None]), c.dtype)

        # The bias over absolute cache positions: the query sits at position
        # `lengths`, position j gets by_dist[lengths - j]; [h, S, n_pos] seen
        # as [S, h, n_pos], unit stride along positions.
        pos = torch.arange(n_pos, device=lengths.device)
        dist = (lengths[:, None].long() - pos).clamp(0, n_pos - 1)
        bias = self._by_dist[:, dist].movedim(1, 0)

        # Page and offset of the appended token (the query token itself);
        # inactive slots write the trash page.
        page_pos = (lengths // self.page_size).long()
        pages = torch.gather(state["table"], 1, page_pos[:, None])[:, 0].long()
        pages = torch.where(active, pages, self._trash)
        offs = (lengths % self.page_size).long()
        att_len = torch.where(active, lengths + 1, 0).to(torch.int32)
        src_mask = (torch.arange(self.max_src_len, device=lengths.device)[None]
                    < state["src_len"][:, None])            # [S, src]

        for i in range(c.num_decoder_layers):
            lp = m._layer("dec", i)
            # paged causal self-attention with the relpos bias
            h_in = lp.norm1(y)
            ap = lp.self_attention
            q = ap._project(h_in, ap.wq, None)              # [S, h, 1, dk]
            k = ap._project(h_in, ap.wk, None)
            v = ap._project(h_in, ap.wv, None)
            state["k_pages"][i][:, pages, offs] = \
                k[:, :, 0].transpose(0, 1).float()
            state["v_pages"][i][:, pages, offs] = \
                v[:, :, 0].transpose(0, 1).float()
            o = ops.paged_attention(q.transpose(1, 2),      # [S, 1, h, dk]
                                    state["k_pages"][i], state["v_pages"][i],
                                    att_len, state["table"], scale=1.0,
                                    bias=bias)
            y = y + self._out_proj(ap, o.to(y.dtype))

            # dense cross-attention against the slot's projected K/V
            h_in = lp.norm2(y)
            ca = lp.cross_attention
            qc = ca._project(h_in, ca.wq, None)             # [S, h, 1, dk]
            s = torch.einsum("shtd,shkd->shtk", qc.float(),
                             state["ck"][i])                # unscaled (T5)
            s = torch.where(src_mask[:, None, None], s, -1e30)
            p = torch.softmax(s, dim=-1)
            oc = torch.einsum("shtk,shkd->sthd", p, state["cv"][i])
            y = y + self._out_proj(ca, oc.to(y.dtype))

            # FFN
            y = y + m._ffn(lp.ffn, lp.norm3(y)).to(y.dtype)

        logits = m._head(m.dec_norm(y))[:, 0].float()
        new_tok = self._sample(logits)
        state["last_tok"] = torch.where(active, new_tok, state["last_tok"])
        state["lengths"] = lengths + active.to(torch.int32)
        out = torch.where(active, new_tok, -1)
        if return_logits:
            return state, out, logits
        return state, out

    def _out_proj(self, ap, o):
        """[S, t, h, dk] attention output through wo [h, dk, d] (one
        rounding, ``ops.linear``)."""
        h, dk, d = ap.wo.shape
        wo = maybe_cast(ap.wo, self.model.config.dtype).reshape(h * dk, d)
        return ops.linear(o.reshape(o.shape[0], o.shape[1], h * dk), wo)

    def _sample(self, logits):
        """Greedy, or temperature / top-k / top-p (``GPT._sample``) from
        the engine's generator; int32 tokens."""
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return GPT._sample(logits, self._gen, self.temperature, 0,
                           self.top_k, self.top_p).to(torch.int32)
