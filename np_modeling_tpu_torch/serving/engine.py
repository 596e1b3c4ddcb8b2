"""Generation engine: continuous-batching GPT serving on a paged KV cache.

Counterpart of np_modeling_tpu/serving/engine.py ``GenerationEngine``, for
one lane, greedy decoding and chunked prefill. The host keeps the control
plane (page free list, seq-id -> slot map, page-table growth); the device
runs the data plane, one step for all slots: embedding, per-layer page
append (in place), paged attention over the shared page table, MLP, argmax.
Prompts stream through the same paged path in fixed chunks
(``prefill_chunk_size``), so both prefill and decode attend through
``ops.paged_attention``.

Differences from the JAX engine: ``gpt`` owns its weights, so there is no
``params`` field; state tensors are updated in place instead of donated;
``step_many(n)`` is a Python loop of device steps that reads the tokens
back once, after the loop. The engine's options that are not ported yet
raise NotImplementedError.

Quantized serving: ``quantize_kv=True`` stores int8 pages with fp32
per-token scales (``ops.quantize_int8`` at each append) that paged
attention dequantizes; a GPT whose FFN weights were loaded as int8
(``utils.params_from_numpy`` of an ``ops.quantize_params_int8`` tree) runs
its FFN through ``ops.int8_matmul`` with no change here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.ops.quantization import quantize_int8
from np_modeling_tpu_torch.serving.kv_cache import OutOfPagesError

_LATER = "is not ported yet (ROADMAP.md Queue 1, serving)"


@dataclasses.dataclass
class GenerationEngine:
    gpt: object                  # models.GPT, on the serving device
    total_pages: int = 256
    page_size: int = 16
    max_seqs: int = 16
    kv_dtype: object = None      # page dtype; None = fp32
    prefill_chunk_size: Optional[int] = 256
    quantize_kv: bool = False    # int8 pages + fp32 per-token scales
    # The JAX engine's options below are not ported yet: any value but the
    # default raises NotImplementedError.
    temperature: float = 0.0
    sampling: Optional[object] = None
    per_request_sampling: bool = False
    constraints: Optional[dict] = None
    enable_prefix_cache: bool = False
    draft_gpt: object = None
    lora_adapters: Optional[dict] = None
    mesh: Optional[object] = None

    def __post_init__(self):
        later = {"temperature > 0": self.temperature != 0.0,
                 "sampling": self.sampling is not None,
                 "per_request_sampling": self.per_request_sampling,
                 "constraints": self.constraints is not None,
                 "enable_prefix_cache": self.enable_prefix_cache,
                 "draft_gpt": self.draft_gpt is not None,
                 "lora_adapters": self.lora_adapters is not None,
                 "mesh": self.mesh is not None,
                 "prefill_chunk_size=None (dense prefill needs GPT.apply)":
                     self.prefill_chunk_size is None}
        later = [k for k, v in later.items() if v]
        if later:
            raise NotImplementedError(f"GenerationEngine option(s) {later} "
                                      + _LATER)
        c = self.gpt.config
        self.device = self.gpt.embedding.table.device
        self._dims = self.gpt._block_for(0).self_attention._dims(c.d_model)
        self.max_pages = -(-c.max_len // self.page_size)
        self._max_tokens = min(self.max_pages * self.page_size, c.max_len)
        self._state = self._make_lane_state(self.gpt, self.total_pages)
        # The last page is the trash page: inactive slots' appends land
        # there, so a step needs no masking of its writes.
        self._trash = self.total_pages - 1
        self._free = list(range(self.total_pages - 2, -1, -1))
        self._slots: dict[int, int] = {}        # seq_id -> slot
        self._host_len: dict[int, int] = {}     # authoritative lengths
        self._seq_pages: dict[int, list[int]] = {}

    def _make_lane_state(self, gpt, total_pages):
        c = gpt.config
        _, hkv, dk = self._dims
        shape = (hkv, total_pages, self.page_size, dk)
        store = (torch.int8 if self.quantize_kv
                 else self.kv_dtype or torch.float32)
        dev = self.device
        state = {
            "k_pages": [torch.zeros(shape, dtype=store, device=dev)
                        for _ in range(c.num_layers)],
            "v_pages": [torch.zeros(shape, dtype=store, device=dev)
                        for _ in range(c.num_layers)],
            "table": torch.zeros((self.max_seqs, self.max_pages),
                                 dtype=torch.int32, device=dev),
            "lengths": torch.zeros((self.max_seqs,), dtype=torch.int32,
                                   device=dev),
            "last_tok": torch.zeros((self.max_seqs,), dtype=torch.int32,
                                    device=dev),
            "active": torch.zeros((self.max_seqs,), dtype=torch.bool,
                                  device=dev),
        }
        if self.quantize_kv:
            sshape = shape[:-1] + (1,)
            for key in ("k_scales", "v_scales"):
                state[key] = [torch.zeros(sshape, dtype=torch.float32,
                                          device=dev)
                              for _ in range(c.num_layers)]
        return state

    # ---- request lifecycle ----------------------------------------------

    @property
    def live(self):
        return sorted(self._slots)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def capacity(self, seq_id: int) -> int:
        """Decode steps this sequence can still take before hitting the
        per-sequence token bound (model max_len / page-table rows)."""
        return self._max_tokens - self._host_len[seq_id]

    def _alloc(self, n: int) -> list[int]:
        if len(self._free) < n:
            raise OutOfPagesError(
                f"out of KV pages ({self.total_pages} total)")
        return [self._free.pop() for _ in range(n)]

    def _release(self, pages) -> None:
        # Pages are never shared until fork / the prefix cache are ported,
        # so each has one owner and no refcount.
        self._free.extend(pages)

    def _free_slots(self):
        used = set(self._slots.values())
        return [s for s in range(self.max_seqs) if s not in used]

    def _check_prompt(self, seq_id, toks) -> tuple:
        if seq_id in self._slots:
            raise ValueError(f"sequence {seq_id} already live")
        arr = np.asarray(toks, dtype=np.int64).reshape(-1)
        if len(arr) >= self._max_tokens:
            raise OutOfPagesError(
                f"prompt length {len(arr)} >= the {self._max_tokens}-token "
                "per-sequence capacity (model max_len / page table)")
        return arr, len(arr)

    def add_request(self, seq_id: int, prompt_tokens, adapter=None,
                    sampling=None, constraint=None) -> int:
        """Prefill a prompt; returns the first generated token."""
        if adapter is not None or sampling is not None \
                or constraint is not None:
            raise NotImplementedError("per-request adapter/sampling/"
                                      "constraint " + _LATER)
        return self.add_requests({seq_id: prompt_tokens})[seq_id]

    def add_requests(self, prompts: dict, adapters=None, sampling=None,
                     constraints=None) -> dict:
        """Prefill several prompts in batched chunks; returns {seq_id: first
        token}."""
        if adapters or sampling or constraints:
            raise NotImplementedError("per-request adapter/sampling/"
                                      "constraint " + _LATER)
        items = sorted(prompts.items())
        free_slots = self._free_slots()
        if len(free_slots) < len(items):
            raise RuntimeError(
                f"{len(items)} requests but only {len(free_slots)} of "
                f"{self.max_seqs} slots free")
        reqs = []
        for (sid, toks), slot in zip(items, free_slots):
            arr, plen = self._check_prompt(sid, toks)
            reqs.append((sid, slot, arr, plen))
        return self._add_requests_chunked(reqs)

    @torch.no_grad()
    def _add_requests_chunked(self, reqs) -> dict:
        """Paged chunked prefill for a batch of prompts: chunk index ci runs
        as one [B, chunk] forward over all new sequences. A row whose prompt
        is exhausted goes inactive (its appends land on the trash page); the
        per-row causal mask makes a padded final chunk exact.

        ``reqs``: list of (seq_id, slot, prompt [plen], plen)."""
        chunk = self.prefill_chunk_size
        B = len(reqs)
        ps = self.page_size
        total = sum(-(-plen // ps) for *_, plen in reqs)
        if len(self._free) < total:          # all-or-nothing across rows
            raise OutOfPagesError("out of KV pages for chunked prefill")
        st = self._state
        for seq_id, slot, _, plen in reqs:
            n_pages = -(-plen // ps)
            pages = self._alloc(n_pages)
            self._seq_pages[seq_id] = pages
            # Tail entries -> trash: a padded final chunk's appends beyond
            # the allocated pages must not land on a live page.
            row = np.full((self.max_pages,), self._trash, np.int32)
            row[:n_pages] = pages
            st["table"][slot] = torch.from_numpy(row).to(self.device)
        for seq_id, slot, _, plen in reqs:
            self._slots[seq_id] = slot
            self._host_len[seq_id] = plen

        plens = np.asarray([plen for *_, plen in reqs])
        slots = torch.tensor([slot for _, slot, _, _ in reqs],
                             dtype=torch.long, device=self.device)
        n_chunks = int(-(-plens.max() // chunk))
        padded = np.zeros((B, n_chunks * chunk), np.int64)
        for i, (_, _, prompt, plen) in enumerate(reqs):
            padded[i, :plen] = prompt
        padded = torch.from_numpy(padded).to(self.device)
        final_ci = (plens - 1) // chunk        # row i's last chunk index
        row_logits = [None] * B
        for ci in range(n_chunks):
            n_valid = np.clip(plens - ci * chunk, 0, chunk)
            lg = self._prefill_chunk(
                st, padded[:, ci * chunk:(ci + 1) * chunk], slots,
                torch.full((B,), ci * chunk, dtype=torch.int32,
                           device=self.device),
                torch.from_numpy(n_valid.astype(np.int32)).to(self.device))
            for i in np.nonzero(final_ci == ci)[0]:
                row_logits[int(i)] = lg[i]
        toks = torch.argmax(torch.stack(row_logits), dim=-1).to(torch.int32)
        st["lengths"][slots] = torch.from_numpy(
            plens.astype(np.int32)).to(self.device)
        st["last_tok"][slots] = toks
        st["active"][slots] = True
        return {seq_id: int(t) for (seq_id, *_), t in zip(reqs, toks.tolist())}

    def _prefill_chunk(self, state, toks, slots, base_len, n_valid):
        """One chunk forward over a batch-B view of the lane (port of the
        JAX ``_make_prefill_chunk`` body). Returns last-position logits of
        each row's valid tokens, [B, vocab] fp32."""
        chunk = toks.shape[1]
        view = dict(state)         # page tensors are shared and written
        view["table"] = state["table"][slots]
        view["lengths"] = base_len
        view["active"] = n_valid > 0
        view, hidden = self._forward_tokens(view, toks, return_hidden=True)
        pos = (n_valid.long() - 1).clamp(0, chunk - 1)
        last = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                      pos]
        return self._lm_head(last[:, None])[:, 0]

    def finish(self, seq_id: int) -> None:
        slot = self._slots.pop(seq_id)
        del self._host_len[seq_id]
        self._release(self._seq_pages.pop(seq_id))
        self._state["active"][slot] = False
        self._state["lengths"][slot] = 0

    # ---- decode step (host: page growth, then one device step) ----------

    def _grow_tables(self, n: int):
        """Ensure every live sequence's page table covers ``n`` more tokens.
        All-or-nothing: needs are computed first, and the free list, host
        bookkeeping and device table change only once the growth fits."""
        needs = []                            # (seq_id, slot, n_new_pages)
        for seq_id, slot in self._slots.items():
            ln_len = self._host_len[seq_id]
            if ln_len + n > self._max_tokens:
                raise OutOfPagesError(
                    f"sequence {seq_id} would exceed the "
                    f"{self._max_tokens}-token capacity (model max_len)")
            extra = -(-(ln_len + n) // self.page_size) \
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
            for pg in self._alloc(extra):
                self._seq_pages[seq_id].append(pg)
                upd.append((slot, len(self._seq_pages[seq_id]) - 1, pg))
        if upd:
            slots, poss, pgs = (torch.tensor(u, dtype=torch.long)
                                for u in zip(*upd))
            self._state["table"][slots.to(self.device),
                                 poss.to(self.device)] = \
                pgs.to(self._state["table"])
        return self._state

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
        The host pre-grows every page table for ``n`` tokens, runs ``n``
        device steps and reads the tokens back once, after the loop."""
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

    # ---- the device step --------------------------------------------------

    def _forward_tokens(self, state, tokens, return_hidden=False):
        """Run the model over ``tokens`` [S, t], appending their K/V to the
        pages. Returns (state, logits [S, t, vocab] fp32), or the final-norm
        hidden states with ``return_hidden=True``. Leaves lengths/last_tok
        to the caller."""
        gpt = self.gpt
        c = gpt.config
        t = tokens.shape[1]
        lengths = state["lengths"]
        x = gpt.embedding(tokens)
        if c.embed_scale:
            x = x * torch.tensor(c.d_model ** 0.5, dtype=x.dtype)
        if c.positional == "learned":
            pos = (lengths[:, None].long()
                   + torch.arange(t, device=tokens.device)).clamp(
                       0, c.max_len - 1)
            x = x + gpt.pos_embedding(pos)
        if c.dtype is not None:
            x = x.to(c.dtype)
        for li in range(c.num_layers):
            x, state = self._block_step(gpt._block_for(li), x, li, state)
        x = gpt.final_norm(x)
        if return_hidden:
            return state, x
        return state, self._lm_head(x)

    def _lm_head(self, x):
        """Tied LM head, fp32 logits: the product of x and the table cast to
        x's dtype, accumulated in fp32 (JAX: preferred_element_type), then
        the final softcap."""
        table = self.gpt.embedding.table
        logits = torch.matmul(x.float(), table.to(x.dtype).float().T)
        cap = self.gpt.config.final_logit_softcap
        if cap is not None:
            logits = cap * torch.tanh(logits / cap)
        return logits

    @torch.no_grad()
    def _device_step(self, state, return_logits=False):
        active = state["active"]
        state, logits = self._forward_tokens(state, state["last_tok"][:, None])
        new_tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        state["last_tok"] = torch.where(active, new_tok, state["last_tok"])
        state["lengths"] = state["lengths"] + active.to(torch.int32)
        out = torch.where(active, new_tok, -1)
        if return_logits:
            return state, out, logits[:, 0]
        return state, out

    def _append(self, state, li, pages, offs, k_new, v_new):
        """Write [hkv, N, dk] new K/V into layer li's pages at (pages[n],
        offs[n]), in place (index_put_); with ``quantize_kv`` the int8
        values into the pages and their scales at the same (pages, offs).
        Duplicate targets occur only on the trash page."""
        writes = [("k_pages", k_new), ("v_pages", v_new)]
        if self.quantize_kv:
            kq, vq = quantize_int8(k_new), quantize_int8(v_new)
            writes = [("k_pages", kq.values), ("v_pages", vq.values),
                      ("k_scales", kq.scales), ("v_scales", vq.scales)]
        for key, new in writes:
            buf = state[key][li]
            buf[:, pages, offs] = new.to(buf.dtype)
        return state

    def _block_step(self, bp, x, li, state):
        """One pre-norm block on the [S, t, d] slice: page append, paged
        attention, FFN. Mirrors the JAX engine's ``_block_step``."""
        attn = bp.self_attention
        active, lengths = state["active"], state["lengths"]
        S, t = x.shape[:2]

        skip = x
        y = bp.norm1(x)
        q = attn._project(y, attn.wq, attn.bq)            # [S, hq, t, dk]
        k = attn._project(y, attn.wk, attn.bk)
        v = attn._project(y, attn.wv, attn.bv)
        tok_pos = lengths[:, None].long() + torch.arange(t, device=x.device)
        q, k = attn._rope(q, tok_pos), attn._rope(k, tok_pos)

        # Slot n's token i writes (page_of(lengths[n] + i), (lengths[n] + i)
        # % ps); inactive slots, and positions past the page table (which
        # JAX's out-of-bounds scatter drops), write the trash page.
        page_pos = tok_pos // self.page_size
        slot_off = (tok_pos % self.page_size).reshape(-1)
        in_table = page_pos < self.max_pages
        pages = torch.gather(state["table"], 1,
                             page_pos.clamp(max=self.max_pages - 1)).long()
        pages = torch.where(active[:, None] & in_table, pages,
                            self._trash).reshape(-1)
        hkv, dk = k.shape[1], k.shape[-1]
        k_flat = k.transpose(0, 1).reshape(hkv, -1, dk)     # [hkv, S*t, dk]
        v_flat = v.transpose(0, 1).reshape(hkv, -1, dk)
        state = self._append(state, li, pages, slot_off, k_flat, v_flat)

        att_len = torch.where(active, lengths + t, 0).to(torch.int32)
        kwargs = {}
        if self.quantize_kv:
            kwargs = {"k_scales": state["k_scales"][li],
                      "v_scales": state["v_scales"][li]}
        # [S, t, hq, dk]; a copy only where RoPE left q in [S, hq, t, dk]
        o = ops.paged_attention(q.transpose(1, 2).contiguous(),
                                state["k_pages"][li], state["v_pages"][li],
                                att_len, state["table"],
                                scale=attn.attn_scale,
                                window=attn.window,
                                softcap=attn.attn_softcap, **kwargs)
        hq, dk, d_out = attn.wo.shape
        o = o.to(x.dtype).reshape(S, t, hq * dk)
        bo = attn.bo.to(x.dtype) if attn.bo is not None else None
        y = ops.linear(o, attn.wo.reshape(hq * dk, d_out).to(x.dtype), bo)
        if bp.sandwich_norm:
            y = bp.post_norm1(y)
        y = y + skip

        skip = y
        z = bp._ffn(bp.norm2(y)).to(x.dtype)
        if bp.sandwich_norm:
            z = bp.post_norm2(z)
        return z + skip, state
