"""Generation engine: continuous-batching GPT serving on a paged KV cache.

Counterpart of np_modeling_tpu/serving/engine.py ``GenerationEngine``, for
one lane. The host keeps the control plane (page free list and refcounts,
seq-id -> slot map, page-table growth, the prefix cache's index); the
device runs the data plane, one step for all slots: embedding, per-layer
page append (in place), paged attention over the shared page table, MLP,
the sampling processors and the draw. Prompts stream through the same
paged path in fixed chunks (``prefill_chunk_size``), so both prefill and
decode attend through ``ops.paged_attention``; ``prefill_chunk_size=None``
prefills each prompt densely (``GPT.apply(collect_kv=True)``, flash
attention) and scatters its k/v into pages.

Sampling (JAX's fields and ``serving.sampling``): ``temperature`` /
``top_k`` / ``top_p``, or an engine-wide ``sampling=SamplingParams``
(penalties over per-slot ``counts`` / ``prompt_mask`` device tables,
``min_p``, logit bias, banned tokens), or ``per_request_sampling=True``
with a SamplingParams per ``add_request`` (a [max_seqs, 7] row table and a
[max_seqs, vocab] bias table). Draws come from a ``torch.Generator`` on
the engine's device seeded with ``seed``: the same seed gives the same
tokens, and other tokens than JAX's ``jax.random`` draws; everything
before the draw equals JAX's.

Pages are refcounted: ``fork`` shares a sequence's full pages with a
child (and copies its tail page), ``enable_prefix_cache`` shares the full
pages of earlier prompts that a new prompt starts with (content hashes of
each full page's tokens, LRU-evicted when the free list runs short), and
a sliding-window model's pages that fall out of every layer's window go
back to the free list as decode goes on. A page is freed when its last
owner leaves.

Differences from the JAX engine: ``gpt`` owns its weights, so there is no
``params`` field; state tensors are updated in place instead of donated;
``step_many(n)`` is a Python loop of device steps that reads the tokens
back once, after the loop. ``constraints``, ``lora_adapters``,
``draft_gpt`` (``step_speculative``), ``step_lookup`` and ``mesh`` are not
ported yet and raise NotImplementedError.

Quantized serving: ``quantize_kv=True`` stores int8 pages with fp32
per-token scales (``ops.quantize_int8`` at each append) that paged
attention dequantizes; a GPT whose FFN weights were loaded as int8
(``utils.params_from_numpy`` of an ``ops.quantize_params_int8`` tree) runs
its FFN through ``ops.int8_matmul`` with no change here.

MLA models (``GPTConfig.mla``, DeepSeek-V2) are served on latent pages (JAX
:150-203, :408-427, :1739-1817): one shared "kv head" of ``kv_lora_rank +
qk_rope_head_dim`` numbers a token, no ``v_pages`` and, with
``quantize_kv``, one scale set; a step runs the absorbed form, q_nope
through kv_b's k half, paged attention with the page array as both k and v
(the paged kernel's latent option on the card), and the first kv_lora_rank
output columns through kv_b's v half. MLA needs chunked prefill.

MoE models (``GPTConfig.moe_experts``) run each block's routed ``moe`` in
the FFN's place. No-drop routing (``moe_capacity_factor=None``) is per
token, so chunked prefill is exact; capacity-limited routing depends on
the token population and takes the dense prefill, and refuses the prefix
cache and MLA, as JAX asserts (JAX :402-418, :785-791).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
from typing import Optional

import numpy as np
import torch

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.ops.quantization import quantize_int8
from np_modeling_tpu_torch.serving import sampling as _sampling
from np_modeling_tpu_torch.serving.kv_cache import OutOfPagesError

_LATER = "is not ported yet (ROADMAP.md Queue 1 item 3, serving)"


@dataclasses.dataclass
class GenerationEngine:
    gpt: object                  # models.GPT, on the serving device
    total_pages: int = 256
    page_size: int = 16
    max_seqs: int = 16
    kv_dtype: object = None      # page dtype; None = fp32
    prefill_chunk_size: Optional[int] = 256   # None: dense prefill
    quantize_kv: bool = False    # int8 pages + fp32 per-token scales
    temperature: float = 0.0     # 0: greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    sampling: Optional[object] = None   # serving.SamplingParams: overrides
                                        # the three fields above
    per_request_sampling: bool = False  # a SamplingParams per add_request
    enable_prefix_cache: bool = False   # share earlier prompts' full pages
    seed: int = 0                # the draws' torch.Generator
    # The JAX engine's options below are not ported yet: any value but the
    # default raises NotImplementedError.
    constraints: Optional[dict] = None
    draft_gpt: object = None
    lora_adapters: Optional[dict] = None
    mesh: Optional[object] = None

    def __post_init__(self):
        later = {"constraints": self.constraints is not None,
                 "draft_gpt": self.draft_gpt is not None,
                 "lora_adapters": self.lora_adapters is not None,
                 "mesh": self.mesh is not None}
        later = [k for k, v in later.items() if v]
        if later:
            raise NotImplementedError(f"GenerationEngine option(s) {later} "
                                      + _LATER)
        c = self.gpt.config
        self.device = self.gpt.embedding.table.device
        # ---- sampling (JAX :447-480): a SamplingParams overrides the
        # plain fields, which follow it.
        self._sp = self.sampling
        self._sp_bias = None
        self._sp_stats = False
        if self.per_request_sampling:
            if self.sampling is not None:
                raise ValueError(
                    "per_request_sampling takes SamplingParams per "
                    "add_request; the plain temperature/top_k/top_p fields "
                    "set the default for requests without one: drop the "
                    "engine-level sampling=")
            self._default_row = _sampling.params_row(_sampling.SamplingParams(
                temperature=self.temperature, top_k=self.top_k,
                top_p=self.top_p))
        if self._sp is not None:
            self.temperature = self._sp.temperature
            self.top_k = self._sp.top_k
            self.top_p = self._sp.top_p
            self._sp_bias = _sampling.static_bias(self._sp, c.vocab_size,
                                                  self.device)
            self._sp_stats = self._sp.needs_token_stats
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        # ---- automatic prefix caching: chain hash -> page, LRU order.
        self._prefix_cache = None
        self._cache_hit_tokens = 0
        self._cache_lookup_tokens = 0
        # Capacity-limited MoE takes the dense prefill (module docstring).
        capacity_moe = (bool(c.moe_experts)
                        and c.moe_capacity_factor is not None)
        self._chunked = (self.prefill_chunk_size is not None
                         and not capacity_moe)
        if self.enable_prefix_cache:
            if not self._chunked:
                raise ValueError("the prefix cache prefills suffixes "
                                 "through the chunked path: "
                                 "prefill_chunk_size=None and capacity-"
                                 "limited MoE (dense prefill) cannot use it "
                                 "(JAX asserts)")
            self._prefix_cache = collections.OrderedDict()
        self._mla = c.mla is not None
        if self._mla:
            if self.prefill_chunk_size is None:
                raise ValueError("MLA serving requires chunked prefill (the "
                                 "dense path collects per-head K/V, which MLA "
                                 "never materializes; JAX asserts)")
            if capacity_moe:
                raise ValueError("MLA + capacity-limited MoE would fall back "
                                 "to the dense prefill; use no-drop routing "
                                 "(moe_capacity_factor=None; JAX asserts)")
            attn = self.gpt._block_for(0).self_attention
            self._dims = (c.num_heads, 1, attn.latent_width)
        else:
            self._dims = self.gpt._block_for(0).self_attention._dims(
                c.d_model)
        self.max_pages = -(-c.max_len // self.page_size)
        self._max_tokens = min(self.max_pages * self.page_size, c.max_len)
        self._state = self._make_lane_state(self.gpt, self.total_pages)
        # The last page is the trash page: inactive slots' appends land
        # there, so a step needs no masking of its writes.
        self._trash = self.total_pages - 1
        self._free = list(range(self.total_pages - 2, -1, -1))
        self._refs: dict[int, int] = {}          # page -> owners
        self._reclaim_mark: dict[int, int] = {}  # window-reclaim watermark
        self._slots: dict[int, int] = {}         # seq_id -> slot
        self._host_len: dict[int, int] = {}      # authoritative lengths
        self._seq_pages: dict[int, list[int]] = {}

    def _make_lane_state(self, gpt, total_pages):
        c = gpt.config
        _, hkv, dk = self._dims
        shape = (hkv, total_pages, self.page_size, dk)
        store = (torch.int8 if self.quantize_kv
                 else self.kv_dtype or torch.float32)
        dev = self.device
        S, V = self.max_seqs, c.vocab_size
        # Latent pages (MLA): the row doubles as v, so no v_pages and one
        # scale set.
        kinds = ("k",) if self._mla else ("k", "v")
        state = {
            **{f"{kind}_pages": [torch.zeros(shape, dtype=store, device=dev)
                                 for _ in range(c.num_layers)]
               for kind in kinds},
            "table": torch.zeros((S, self.max_pages), dtype=torch.int32,
                                 device=dev),
            "lengths": torch.zeros((S,), dtype=torch.int32, device=dev),
            "last_tok": torch.zeros((S,), dtype=torch.int32, device=dev),
            "active": torch.zeros((S,), dtype=torch.bool, device=dev),
        }
        if self._sp_stats or self.per_request_sampling:
            # Penalty statistics: generated-token counts and prompt
            # membership, a [vocab] row a slot.
            state["counts"] = torch.zeros((S, V), dtype=torch.int32,
                                          device=dev)
            state["prompt_mask"] = torch.zeros((S, V), dtype=torch.bool,
                                               device=dev)
        if self.per_request_sampling:
            state["samp"] = torch.from_numpy(
                np.tile(self._default_row[None], (S, 1))).to(dev)
            state["samp_bias"] = torch.zeros((S, V), dtype=torch.float32,
                                             device=dev)
        if self.quantize_kv:
            sshape = shape[:-1] + (1,)
            for kind in kinds:
                state[f"{kind}_scales"] = [
                    torch.zeros(sshape, dtype=torch.float32, device=dev)
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

    def _prefix_hashes(self, prompt, plen: int) -> list:
        """Chained content hashes of the prompt's full pages: entry i names
        tokens [0, (i + 1) * page_size), so equal prefixes hash equal and a
        walk of the cache finds the longest cached page prefix (JAX :542;
        adapter 0, the only one the port serves)."""
        ps = self.page_size
        toks = np.asarray(prompt, np.int32)
        run = hashlib.sha1(repr((0, ps)).encode())
        out = []
        for i in range(plen // ps):
            run.update(toks[i * ps:(i + 1) * ps].tobytes())
            out.append(run.hexdigest())
        return out

    def _evict_for(self, n: int) -> None:
        """Evict prefix-cache entries, least recently used first, until the
        free list holds ``n`` pages. Dropping the cache's reference frees a
        page only when no live sequence shares it; the cache shrinks either
        way, so this ends."""
        while self._prefix_cache and len(self._free) < n:
            _, pg = self._prefix_cache.popitem(last=False)
            self._release([pg])

    @property
    def prefix_cache_stats(self) -> dict:
        """{entries, hit_tokens, lookup_tokens}: hit_tokens counts prompt
        tokens whose k/v came from the cache instead of a prefill pass."""
        return {"entries": len(self._prefix_cache or ()),
                "hit_tokens": self._cache_hit_tokens,
                "lookup_tokens": self._cache_lookup_tokens}

    def _alloc(self, n: int) -> list[int]:
        self._evict_for(n)
        if len(self._free) < n:
            raise OutOfPagesError(
                f"out of KV pages ({self.total_pages} total)")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def _release(self, pages) -> None:
        for p in pages:
            if p not in self._refs:
                continue   # the trash page (a window-reclaimed position)
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)

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

    # ---- sampling state ---------------------------------------------------

    def _seed_stats(self, rows) -> None:
        """Prompt membership and zeroed counts of newly prefilled slots
        (``rows``: [(slot, prompt)])."""
        if "counts" not in self._state:
            return
        V = self.gpt.config.vocab_size
        st = self._state
        for slot, prompt in rows:
            st["prompt_mask"][slot] = _sampling.token_histogram(
                prompt, V, self.device) > 0
            st["counts"][slot] = 0

    def _stat_rows(self, slots):
        """The slots' rows of counts, prompt_mask, samp and samp_bias (None
        for tables the engine does not carry)."""
        return tuple(self._state[k][slots] if k in self._state else None
                     for k in ("counts", "prompt_mask", "samp", "samp_bias"))

    def _count_first(self, slots, toks) -> None:
        """Count the first tokens (drawn at prefill) into the slots' rows."""
        if "counts" in self._state:
            self._state["counts"].index_put_(
                (slots, toks.long()),
                torch.ones(toks.shape, dtype=torch.int32,
                           device=self.device), accumulate=True)

    def _set_request_sampling(self, slot: int, sp) -> None:
        """A slot's knob row and bias row (the engine default for None)."""
        st = self._state
        row = self._default_row if sp is None else _sampling.params_row(sp)
        st["samp"][slot] = torch.from_numpy(row).to(self.device)
        bias = None if sp is None else _sampling.static_bias(
            sp, self.gpt.config.vocab_size, self.device)
        st["samp_bias"][slot] = 0.0 if bias is None else bias

    def _sample(self, logits, counts=None, prompt_mask=None, samp=None,
                bias=None):
        """JAX :1687-1708: per-request rows (``sample_batch``), the
        engine-wide SamplingParams (``sample``), greedy, or temperature /
        top-k / top-p (``GPT._sample``); int32 tokens."""
        if self.per_request_sampling:
            return _sampling.sample_batch(logits, self._gen, samp, counts,
                                          prompt_mask, bias)
        if self._sp is not None:
            return _sampling.sample(logits, self._gen, self._sp, counts,
                                    prompt_mask, self._sp_bias)
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return self.gpt._sample(logits, self._gen, self.temperature, 0,
                                self.top_k, self.top_p).to(torch.int32)

    # ---- admission ----------------------------------------------------------

    def add_request(self, seq_id: int, prompt_tokens, adapter=None,
                    sampling=None, constraint=None) -> int:
        """Prefill a prompt; returns the first generated token.
        ``sampling``: this request's SamplingParams (per_request_sampling
        engines only)."""
        return self.add_requests({seq_id: prompt_tokens},
                                 {seq_id: adapter} if adapter else None,
                                 {seq_id: sampling} if sampling else None,
                                 {seq_id: constraint} if constraint
                                 else None)[seq_id]

    def add_requests(self, prompts: dict, adapters=None, sampling=None,
                     constraints=None) -> dict:
        """Prefill several prompts; returns {seq_id: first token}. Chunked
        prefill batches them into [B, chunk] forwards; dense prefill
        (``prefill_chunk_size=None``) runs them one by one. ``sampling``:
        {seq_id: SamplingParams} (per_request_sampling engines only)."""
        if adapters or constraints:
            raise NotImplementedError("per-request adapters and "
                                      "constraints " + _LATER)
        sampling = sampling or {}
        if sampling and not self.per_request_sampling:
            raise ValueError("construct the engine with per_request_"
                             "sampling=True to pass per-request "
                             "SamplingParams")
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
        if self.per_request_sampling:
            for sid, slot, _, _ in reqs:
                self._set_request_sampling(slot, sampling.get(sid))
        if not self._chunked:
            return {sid: self._add_request_dense(sid, slot, arr, plen)
                    for sid, slot, arr, plen in reqs}
        return self._add_requests_chunked(reqs)

    @torch.no_grad()
    def _add_request_dense(self, seq_id, slot, prompt, plen) -> int:
        """Dense prefill (JAX :778-838): one ``GPT.apply(collect_kv=True,
        logits_last_only=True)`` over the prompt, the first token drawn
        from its last logits, and every layer's k/v scattered into fresh
        pages (``_pad_kvs`` / ``_make_prefill``)."""
        ps = self.page_size
        toks = torch.from_numpy(prompt).to(self.device)[None]
        logits, kvs = self.gpt.apply(toks, collect_kv=True,
                                     logits_last_only=True)
        n_pages = -(-plen // ps)
        pages = self._alloc(n_pages)
        self._seed_stats([(slot, prompt)])
        slots = torch.tensor([slot], device=self.device)
        tok = self._sample(logits[:, -1].float(), *self._stat_rows(slots))
        self._count_first(slots, tok)
        st = self._state
        pos = torch.arange(n_pages * ps, device=self.device)
        pages_t = torch.tensor(pages, dtype=torch.long, device=self.device)
        p_idx = torch.where(pos < plen, pages_t[pos // ps], self._trash)
        for li, (k, v) in enumerate(kvs):
            self._append(st, li, p_idx, pos % ps, *self._pad_kvs(k, v, pos))
        row = np.full((self.max_pages,), self._trash, np.int32)
        row[:n_pages] = pages
        st["table"][slot] = torch.from_numpy(row).to(self.device)
        st["lengths"][slot] = plen
        st["last_tok"][slot] = tok[0]
        st["active"][slot] = True
        self._slots[seq_id] = slot
        self._host_len[seq_id] = plen
        self._seq_pages[seq_id] = pages
        return int(tok[0])

    @staticmethod
    def _pad_kvs(k, v, pos):
        """A layer's collected k/v [1, hkv, plen, dk] as [hkv, n, dk] over
        whole pages (``pos``: n positions; the padding lands on the trash
        page)."""
        pad = pos.shape[0] - k.shape[2]
        return tuple(torch.nn.functional.pad(x[0], (0, 0, 0, pad))
                     for x in (k, v))

    @torch.no_grad()
    def _add_requests_chunked(self, reqs) -> dict:
        """Paged chunked prefill for a batch of prompts: chunk index ci runs
        as one [B, chunk] forward over all new sequences. A row whose prompt
        is exhausted goes inactive (its appends land on the trash page); the
        per-row causal mask makes a padded final chunk exact.

        With ``enable_prefix_cache`` each row first takes the longest
        page-aligned prefix of its prompt that the cache holds (at most
        ``plen - 1`` tokens, so one token always runs and gives the first
        logits): those pages are shared, and only the suffix streams
        through the chunks, each row from its own base (JAX :903-1052).

        ``reqs``: list of (seq_id, slot, prompt [plen], plen)."""
        chunk = self.prefill_chunk_size
        B = len(reqs)
        ps = self.page_size
        matches = {sid: [] for sid, *_ in reqs}
        if self._prefix_cache is not None:
            for sid, _, prompt, plen in reqs:
                for h in self._prefix_hashes(prompt, plen)[:(plen - 1) // ps]:
                    pg = self._prefix_cache.get(h)
                    if pg is None:
                        break
                    self._prefix_cache.move_to_end(h)      # LRU touch
                    matches[sid].append(pg)
                self._cache_lookup_tokens += plen
                self._cache_hit_tokens += len(matches[sid]) * ps
            # The rows own their matched pages before any eviction below,
            # so that no eviction frees a page this batch just matched.
            for pages in matches.values():
                for pg in pages:
                    self._refs[pg] += 1
        bases = np.asarray([len(matches[sid]) * ps for sid, *_ in reqs])
        total = sum(-(-plen // ps) - len(matches[sid])
                    for sid, _, _, plen in reqs)
        self._evict_for(total)
        if len(self._free) < total:          # all-or-nothing across rows
            for pages in matches.values():
                self._release(pages)
            raise OutOfPagesError("out of KV pages for chunked prefill")
        st = self._state
        for sid, slot, _, plen in reqs:
            n_pages = -(-plen // ps)
            pages = matches[sid] + self._alloc(n_pages - len(matches[sid]))
            self._seq_pages[sid] = pages
            # Tail entries -> trash: a padded final chunk's appends beyond
            # the allocated pages must not land on a live page.
            row = np.full((self.max_pages,), self._trash, np.int32)
            row[:n_pages] = pages
            st["table"][slot] = torch.from_numpy(row).to(self.device)
        for sid, slot, _, plen in reqs:
            self._slots[sid] = slot
            self._host_len[sid] = plen

        plens = np.asarray([plen for *_, plen in reqs])
        suffix = plens - bases
        slots = torch.tensor([slot for _, slot, _, _ in reqs],
                             dtype=torch.long, device=self.device)
        n_chunks = int(-(-suffix.max() // chunk))
        padded = np.zeros((B, n_chunks * chunk), np.int64)
        for i, (_, _, prompt, plen) in enumerate(reqs):
            padded[i, :suffix[i]] = prompt[bases[i]:]
        padded = torch.from_numpy(padded).to(self.device)
        final_ci = (suffix - 1) // chunk       # row i's last chunk index
        row_logits = [None] * B
        for ci in range(n_chunks):
            n_valid = np.clip(suffix - ci * chunk, 0, chunk)
            lg = self._prefill_chunk(
                st, padded[:, ci * chunk:(ci + 1) * chunk], slots,
                torch.from_numpy((bases + ci * chunk).astype(np.int32)).to(
                    self.device),
                torch.from_numpy(n_valid.astype(np.int32)).to(self.device))
            for i in np.nonzero(final_ci == ci)[0]:
                row_logits[int(i)] = lg[i]

        # Every full prompt page is now content-addressed; the cache holds
        # a reference of its own, so entries outlive finish() until evicted.
        if self._prefix_cache is not None:
            for sid, _, prompt, plen in reqs:
                pages = self._seq_pages[sid]
                for i, h in enumerate(self._prefix_hashes(prompt, plen)):
                    if h not in self._prefix_cache:
                        self._prefix_cache[h] = pages[i]
                        self._refs[pages[i]] += 1

        self._seed_stats([(slot, prompt) for _, slot, prompt, _ in reqs])
        toks = self._sample(torch.stack(row_logits), *self._stat_rows(slots))
        st["lengths"][slots] = torch.from_numpy(
            plens.astype(np.int32)).to(self.device)
        st["last_tok"][slots] = toks
        st["active"][slots] = True
        self._count_first(slots, toks)
        return {sid: int(t) for (sid, *_), t in zip(reqs, toks.tolist())}

    def _prefill_chunk(self, state, toks, slots, base_len, n_valid):
        """One chunk forward over a batch-B view of the lane (port of the
        JAX ``_make_prefill_chunk`` body; ``base_len`` [B] per row). Returns
        last-position logits of each row's valid tokens, [B, vocab] fp32."""
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
        self._reclaim_mark.pop(seq_id, None)
        self._release(self._seq_pages.pop(seq_id))
        st = self._state
        st["active"][slot] = False
        st["lengths"][slot] = 0
        if "counts" in st:     # a reused slot inherits no penalties
            st["counts"][slot] = 0
            st["prompt_mask"][slot] = False
        if "samp" in st:       # ...and no knobs
            st["samp"][slot] = torch.from_numpy(self._default_row).to(
                self.device)
            st["samp_bias"][slot] = 0.0

    # ---- fork: refcounted page sharing ----------------------------------

    @torch.no_grad()
    def fork(self, parent_id: int, new_id: int) -> None:
        """Clone a live sequence (JAX :1137-1225). The child shares the
        parent's full pages (refcounted; pages are append-only, so none is
        ever copied on write) and copies the partial tail page; it inherits
        the parent's last token, sampling rows and counts. Both then decode
        on their own; ``finish`` frees a page when its last owner leaves."""
        if new_id in self._slots:
            raise ValueError(f"sequence {new_id} already live")
        pslot = self._slots[parent_id]
        free_slots = self._free_slots()
        if not free_slots:
            raise RuntimeError(f"all {self.max_seqs} slots busy")
        slot = free_slots[0]
        plen = self._host_len[parent_id]
        full, partial = divmod(plen, self.page_size)
        parent_pages = self._seq_pages[parent_id]
        child = list(parent_pages[:full])
        dst = self._alloc(1)[0] if partial else None   # raises before sharing
        for p in child:
            if p in self._refs:   # reclaimed positions hold the trash page
                self._refs[p] += 1
        st = self._state
        if partial:
            src = parent_pages[full]
            child.append(dst)
            for key in ("k_pages", "v_pages", "k_scales", "v_scales"):
                for buf in st.get(key, ()):
                    buf[:, dst] = buf[:, src]
        row = np.full((self.max_pages,), self._trash, np.int32)
        row[:len(child)] = child
        st["table"][slot] = torch.from_numpy(row).to(self.device)
        st["lengths"][slot] = plen
        st["active"][slot] = True
        for key in ("last_tok", "counts", "prompt_mask", "samp",
                    "samp_bias"):
            if key in st:
                st[key][slot] = st[key][pslot]
        self._seq_pages[new_id] = child
        # The child's page list shares the parent's trash placeholders below
        # the parent's watermark, so it inherits the watermark too.
        if parent_id in self._reclaim_mark:
            self._reclaim_mark[new_id] = self._reclaim_mark[parent_id]
        self._slots[new_id] = slot
        self._host_len[new_id] = plen

    # ---- sliding-window page reclamation ------------------------------------

    def _reclaim_window_pages(self) -> None:
        """Free the pages that fell out of a sliding-window model's span
        (positions < length - window) (JAX :1228-1267): per-sequence KV
        memory stays near ``window`` tokens however long it decodes. Paged
        attention never reads such positions (it masks below the band), so
        a reclaimed and reused page is at worst loaded and discarded. Their
        table entries point at the trash page; shared pages are freed when
        their last owner lets them go. Models whose layers alternate
        local and global windows keep every page: the global layers read
        them."""
        c = self.gpt.config
        w = c.attention_window
        if w is None or c.window_pattern > 1:
            return
        upd = []                                   # (slot, page position)
        for seq_id, slot in self._slots.items():
            expired = (self._host_len[seq_id] - w) // self.page_size
            pages = self._seq_pages[seq_id]
            start = self._reclaim_mark.get(seq_id, 0)
            for pos in range(start, min(expired, len(pages))):
                if pages[pos] == self._trash:
                    continue            # reclaimed already (a fork's share)
                self._release([pages[pos]])
                pages[pos] = self._trash
                upd.append((slot, pos))
            self._reclaim_mark[seq_id] = max(start, min(expired, len(pages)))
        if upd:
            slots, poss = (torch.tensor(u, dtype=torch.long,
                                        device=self.device)
                           for u in zip(*upd))
            self._state["table"][slots, poss] = self._trash

    # ---- not ported yet ---------------------------------------------------

    def step_speculative(self, gamma: int = 4) -> dict:
        raise NotImplementedError("step_speculative needs draft_gpt, which "
                                  + _LATER)

    def step_speculative_many(self, rounds: int, gamma: int = 4) -> dict:
        raise NotImplementedError("step_speculative_many needs draft_gpt, "
                                  "which " + _LATER)

    def step_lookup(self, gamma: int = 4, ngram: int = 3) -> dict:
        raise NotImplementedError("step_lookup " + _LATER)

    # ---- decode step (host: page growth, then one device step) ----------

    def _grow_tables(self, n: int):
        """Ensure every live sequence's page table covers ``n`` more tokens.
        Window reclamation runs first (it can only free pages). The growth
        is all-or-nothing: needs are computed first, and the free list, host
        bookkeeping and device table change only once the growth fits."""
        self._reclaim_window_pages()
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
        self._evict_for(total)
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
        """The LM head, fp32 logits (JAX :1640-1651): ``GPT.head`` (x is in
        the compute dtype), then the final softcap."""
        logits = self.gpt.head(x).float()
        cap = self.gpt.config.final_logit_softcap
        if cap is not None:
            logits = cap * torch.tanh(logits / cap)
        return logits

    @torch.no_grad()
    def _device_step(self, state, return_logits=False):
        active = state["active"]
        state, logits = self._forward_tokens(state, state["last_tok"][:, None])
        new_tok = self._sample(logits[:, 0], state.get("counts"),
                               state.get("prompt_mask"), state.get("samp"),
                               state.get("samp_bias"))
        if "counts" in state:
            state["counts"].index_put_(
                (torch.arange(new_tok.shape[0], device=new_tok.device),
                 new_tok.long()), active.to(torch.int32), accumulate=True)
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
        Duplicate targets occur only on the trash page. ``v_new`` None (MLA's
        latent rows): k only."""
        writes = [("k", k_new)] + ([] if v_new is None else [("v", v_new)])
        if self.quantize_kv:
            quant = [(kind, quantize_int8(new)) for kind, new in writes]
            writes = [(f"{kind}_pages", q.values) for kind, q in quant] + [
                (f"{kind}_scales", q.scales) for kind, q in quant]
        else:
            writes = [(f"{kind}_pages", new) for kind, new in writes]
        for key, new in writes:
            buf = state[key][li]
            buf[:, pages, offs] = new.to(buf.dtype)
        return state

    def _write_slots(self, state, tok_pos):
        """(pages [S * t], offsets [S * t]) where the tokens at ``tok_pos``
        [S, t] land: slot n's token i writes (page_of(lengths[n] + i),
        (lengths[n] + i) % ps); inactive slots, and positions past the page
        table (which JAX's out-of-bounds scatter drops), write the trash
        page."""
        page_pos = tok_pos // self.page_size
        slot_off = (tok_pos % self.page_size).reshape(-1)
        in_table = page_pos < self.max_pages
        pages = torch.gather(state["table"], 1,
                             page_pos.clamp(max=self.max_pages - 1)).long()
        pages = torch.where(state["active"][:, None] & in_table, pages,
                            self._trash).reshape(-1)
        return pages, slot_off

    def _block_step(self, bp, x, li, state):
        """One pre-norm block on the [S, t, d] slice: page append, paged
        attention, FFN. Mirrors the JAX engine's ``_block_step``."""
        if self._mla:
            return self._block_step_mla(bp, x, li, state)
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
        pages, slot_off = self._write_slots(state, tok_pos)
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
        z = self._ffn_step(bp, bp.norm2(y), x.dtype)
        if bp.sandwich_norm:
            z = bp.post_norm2(z)
        return z + skip, state

    @staticmethod
    def _ffn_step(bp, y, dtype):
        """The block's FFN on the step's rows: its routed ``moe`` (JAX
        :1804-1807, :1909-1913) or its dense FFN in ``dtype``."""
        if bp.moe_experts:
            return bp.moe(y)
        return bp._ffn(y).to(dtype)

    def _block_step_mla(self, bp, x, li, state):
        """One MLA block on the [S, t, d] slice (JAX :1739-1817, with its
        casts): the tokens' latent rows concat(c_kv, k_pe) appended to the
        pages, then the absorbed paged attention, the page array as both k
        and v (one scale set with int8 pages), and the first kv_lora_rank
        output columns through kv_b's v half in fp32. The einsums are plain
        torch, as JAX computes them outside any Pallas kernel."""
        attn = bp.self_attention
        active, lengths = state["active"], state["lengths"]
        S, t = x.shape[:2]
        nope = attn.qk_nope_head_dim

        skip = x
        y = bp.norm1(x)
        q_nope, q_pe = attn._split_q(attn._q_heads(y))     # [S, hq, t, .]
        c_lat, k_pe = attn._latent(y)                       # [S, 1, t, .]
        tok_pos = lengths[:, None].long() + torch.arange(t, device=x.device)
        q_pe, k_pe = attn._rope(q_pe, tok_pos), attn._rope(k_pe, tok_pos)
        k_new = torch.cat([c_lat, k_pe], dim=-1)            # [S, 1, t, w]
        pages, slot_off = self._write_slots(state, tok_pos)
        width = k_new.shape[-1]
        state = self._append(state, li, pages, slot_off,
                             k_new.transpose(0, 1).reshape(1, -1, width), None)

        att_len = torch.where(active, lengths + t, 0).to(torch.int32)
        kwargs = {}
        if self.quantize_kv:
            sc = state["k_scales"][li]
            kwargs = {"k_scales": sc, "v_scales": sc}
        wk = attn.kv_b[:, :, :nope]                         # [rank, hq, n]
        q_abs = torch.einsum("bhtn,rhn->bhtr", q_nope, wk.to(q_nope.dtype))
        q_eff = torch.cat([q_abs, q_pe], dim=-1)            # [S, hq, t, w]
        kp = state["k_pages"][li]
        o = ops.paged_attention(q_eff.transpose(1, 2).contiguous(), kp, kp,
                                att_len, state["table"],
                                scale=1.0 / math.sqrt(attn.qk_head_dim),
                                **kwargs)
        o_lat = o[..., :attn.kv_lora_rank]                  # [S, t, hq, r]
        wv = attn.kv_b[:, :, nope:]                         # [rank, hq, v]
        o_heads = torch.einsum("bthr,rhv->bthv", o_lat.float(), wv.float())
        hq, vd = o_heads.shape[2], o_heads.shape[3]
        wo = attn.wo.to(x.dtype)
        y = ops.linear(o_heads.reshape(S, t, hq * vd).to(x.dtype),
                       wo.reshape(hq * vd, -1))
        y = y + skip

        skip = y
        z = self._ffn_step(bp, bp.norm2(y), x.dtype)
        return z + skip, state
