"""Generation engine: continuous-batching GPT serving on a paged KV cache.

Counterpart of np_modeling_tpu/serving/engine.py ``GenerationEngine``. The
host keeps the control plane (page free lists and refcounts, seq-id ->
slot map, page-table growth, the prefix cache's index); the device runs the
data plane, one step for all slots: embedding, per-layer page append (in
place), paged attention over the shared page table, MLP, the sampling
processors and the draw. Prompts stream through the same paged path in
fixed chunks (``prefill_chunk_size``), so both prefill and decode attend
through ``ops.paged_attention``; ``prefill_chunk_size=None`` prefills each
prompt densely (``GPT.apply(collect_kv=True)``, flash attention) and
scatters its k/v into pages.

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
each full page's tokens and the adapter, LRU-evicted when the free list
runs short), and a sliding-window model's pages that fall out of every
layer's window go back to the free list as decode goes on. A page is freed
when its last owner leaves. A head_dim under 64 is stored in pages 64 wide,
its k and v zero-padded (the paged kernel's narrowest width, JAX pads to
128): four times the page bytes at head_dim 16, the same page counts.

Grammar constraints (``constraints={name: serving.TokenDFA}``,
``add_request(constraint=)``): a stacked [n + 1, states, vocab] int32
transition table on the device (row 0 unconstrained) and a DFA id and state
a slot; the first token and every decode step are drawn from logits
masked to -inf where the slot's state forbids a token, and the state
advances on the drawn token. ``register_constraint`` adds one at run time.

Multi-LoRA serving (``lora_adapters={name: adapter tree}``, attention
targets, ``add_request(adapter=)``): the adapters stacked behind a zero
adapter at index 0, and every slot's factored delta ``x A[i] B[i] alpha/r``
(fp32) added to its q/k/v and output projections in the same step as the
other slots'. A dense prefill runs the adapter's merged weights (cached per
adapter, ``training.lora.lora_merge``) instead.

Speculative decoding (``draft_gpt=``, ``step_speculative`` /
``step_speculative_many``): the draft lane keeps its own pages, tables,
free list and refcounts, filled at every admission; a round runs gamma
draft steps and one more (caching the last proposal's k/v), the target's
verify of gamma + 1 tokens in one paged forward, and commits the accepted
prefix plus one target token, greedy (token for token ``step()``'s) or by
the accept/reject rule (``models.speculative``). A rollback only shortens
the lengths: k/v past a length are never read. ``step_lookup`` verifies
n-gram proposals from each sequence's own history, with no draft.

Differences from the JAX engine: ``gpt`` (and ``draft_gpt``) own their
weights, so there is no ``params`` field; state tensors are updated in
place instead of donated; ``step_many(n)`` and ``step_speculative_many``
are Python loops of device steps that read the tokens back once, after the
loop; JAX's asserts raise ValueError. ``mesh`` is not ported yet and
raises NotImplementedError.

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

Models with attention sinks (``GPTConfig.attn_sinks``, gpt-oss) hand each
layer's ``sinks`` to paged attention (K3's sinks option on the card); the
dense prefill runs them through flash attention's rescale.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
import re
from typing import Optional

import numpy as np
import torch

from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.models.speculative import (
    accept_greedy, speculative_accept_logits)
from np_modeling_tpu_torch.nn.module import swapped
from np_modeling_tpu_torch.ops.paged_attention import MIN_KERNEL_D
from np_modeling_tpu_torch.ops.quantization import quantize_int8
from np_modeling_tpu_torch.serving import sampling as _sampling
from np_modeling_tpu_torch.serving.kv_cache import OutOfPagesError

_LATER = "is not ported yet (ROADMAP.md Queue 1 item 3, serving)"
_LORA_PATH = re.compile(r"^layer_\d+/self_attention/w[qkvo]$")


class _Lane:
    """One model lane (the target's or the draft's): its device state and
    its page management."""

    def __init__(self, gpt, total_pages, is_target):
        self.gpt, self.is_target = gpt, is_target
        self.total_pages = total_pages
        self.state: dict = {}                   # the lane's device tensors
        # The last page is the trash page: inactive slots' appends land
        # there, so a step needs no masking of its writes.
        self.trash = total_pages - 1
        self.free = list(range(total_pages - 2, -1, -1))
        self.refs: dict[int, int] = {}          # page -> owners
        self.seq_pages: dict[int, list[int]] = {}
        self.marks: dict[int, int] = {}         # window-reclaim watermark


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
    constraints: Optional[dict] = None  # {name: serving.TokenDFA}
    enable_prefix_cache: bool = False   # share earlier prompts' full pages
    seed: int = 0                # the draws' torch.Generator
    draft_gpt: object = None     # models.GPT proposing for step_speculative
    lora_adapters: Optional[dict] = None   # {name: adapter tree}
    lora_alpha: Optional[float] = None     # LoRA scale alpha/r (default r)
    draft_total_pages: Optional[int] = None   # default: total_pages
    mesh: Optional[object] = None  # not ported yet: NotImplementedError

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError("GenerationEngine option 'mesh' "
                                      + _LATER)
        c = self.gpt.config
        if c.scan_layers:
            raise ValueError("engine requires scan_layers=False (JAX "
                             "asserts)")
        self.device = self.gpt.embedding.table.device
        # ---- sampling (JAX :342-380): a SamplingParams overrides the
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
            if self.draft_gpt is not None:
                raise ValueError(
                    "speculative decoding needs one static sampling config "
                    "for the accept/reject ratio: per-request knobs don't "
                    "compose (JAX asserts)")
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
            if self.draft_gpt is not None and (
                    self._sp_stats or self._sp.min_p is not None
                    or self._sp_bias is not None):
                raise ValueError(
                    "speculative decoding composes with temperature/top_k/"
                    "top_p only: penalties/min_p/logit_bias would change the "
                    "target distribution the draft never saw (JAX asserts)")
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        # ---- grammar constraints (JAX :381-391)
        self._dfa_trans = None
        self._dfa_ids: dict = {}
        if self.constraints is not None:
            if self.draft_gpt is not None:
                raise ValueError(
                    "constrained decoding + the draft lane is not wired: the "
                    "speculative verify's argmax would bypass the DFA masks "
                    "(JAX asserts)")
            # Stable ids: the initial names sorted, registrations appended.
            self._dfa_names = sorted(self.constraints)
            self._rebuild_dfa_table()
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
            if self.draft_gpt is not None:
                raise ValueError(
                    "prefix cache + draft lane is not wired: the draft lane "
                    "would need its own content-addressed cache (JAX "
                    "asserts)")
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
            if self.lora_adapters is not None:
                raise ValueError("multi-LoRA serving of an MLA model is not "
                                 "wired (JAX asserts)")
        self.max_pages = -(-c.max_len // self.page_size)
        self._max_tokens = min(self.max_pages * self.page_size, c.max_len)
        target = _Lane(self.gpt, self.total_pages, is_target=True)
        target.state = self._make_lane_state(target)
        self._lane_list = [target]
        self._slots: dict[int, int] = {}         # seq_id -> slot
        self._host_len: dict[int, int] = {}      # authoritative lengths
        self._history: dict[int, list] = {}      # prompt + emitted tokens
        # ---- multi-LoRA serving (JAX :462-470)
        self._adapter_ids: dict = {}
        self._merged_cache: dict = {}   # adapter name -> merged tensors
        self._lora = None
        if self.lora_adapters:
            self._adapter_ids = {name: i + 1 for i, name in
                                 enumerate(sorted(self.lora_adapters))}
            self._lora = self._stack_adapters()
        # ---- the draft lane (JAX :480-504)
        if self.draft_gpt is not None:
            dc = self.draft_gpt.config
            if dc.vocab_size != c.vocab_size:
                raise ValueError("the draft must share the target's vocab")
            if dc.scan_layers:
                raise ValueError("the draft requires scan_layers=False")
            # Both lanes must hold the same token count.
            self._max_tokens = min(self._max_tokens, dc.max_len)
            lane = _Lane(self.draft_gpt,
                         self.draft_total_pages or self.total_pages,
                         is_target=False)
            lane.state = self._make_lane_state(lane)
            self._lane_list.append(lane)

    @property
    def _state(self) -> dict:
        """The target lane's device tensors."""
        return self._lane_list[0].state

    @_state.setter
    def _state(self, state):
        self._lane_list[0].state = state

    def _lane_dims(self, gpt):
        """(hq, hkv, head_dim, page width) of ``gpt``'s pages: latent rows
        for MLA, else head_dim padded to MIN_KERNEL_D."""
        c = gpt.config
        if c.mla is not None:
            width = gpt._block_for(0).self_attention.latent_width
            return c.num_heads, 1, width, width
        hq, hkv, dk = gpt._block_for(0).self_attention._dims(c.d_model)
        return hq, hkv, dk, max(dk, MIN_KERNEL_D)

    def _make_lane_state(self, lane):
        c = lane.gpt.config
        _, hkv, _, width = self._lane_dims(lane.gpt)
        shape = (hkv, lane.total_pages, self.page_size, width)
        store = (torch.int8 if self.quantize_kv
                 else self.kv_dtype or torch.float32)
        dev = self.device
        S, V = self.max_seqs, c.vocab_size
        # Latent pages (MLA): the row doubles as v, so no v_pages and one
        # scale set.
        kinds = ("k",) if c.mla is not None else ("k", "v")
        state = {
            **{f"{kind}_pages": [torch.zeros(shape, dtype=store, device=dev)
                                 for _ in range(c.num_layers)]
               for kind in kinds},
            "table": torch.zeros((S, self.max_pages), dtype=torch.int32,
                                 device=dev),
            "lengths": torch.zeros((S,), dtype=torch.int32, device=dev),
            "last_tok": torch.zeros((S,), dtype=torch.int32, device=dev),
            "active": torch.zeros((S,), dtype=torch.bool, device=dev),
            "adapter": torch.zeros((S,), dtype=torch.int32, device=dev),
        }
        if lane.is_target and (self._sp_stats or self.per_request_sampling):
            # Penalty statistics: generated-token counts and prompt
            # membership, a [vocab] row a slot (the target lane only).
            state["counts"] = torch.zeros((S, V), dtype=torch.int32,
                                          device=dev)
            state["prompt_mask"] = torch.zeros((S, V), dtype=torch.bool,
                                               device=dev)
        if lane.is_target and self.constraints is not None:
            state["dfa_id"] = torch.zeros((S,), dtype=torch.int32, device=dev)
            state["dfa_state"] = torch.zeros((S,), dtype=torch.int32,
                                             device=dev)
        if lane.is_target and self.per_request_sampling:
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

    # ---- multi-LoRA (JAX :277-340) ------------------------------------------

    def _stack_adapters(self):
        """Every adapter's A and B stacked along a new leading axis behind a
        zero adapter at index 0 (the base model), fp32 on the device."""
        names = sorted(self.lora_adapters)
        paths = sorted(self.lora_adapters[names[0]])
        for p in paths:
            if not _LORA_PATH.match(p):
                raise ValueError(
                    "engine multi-LoRA serves attention targets only "
                    f"(training.lora.ATTENTION_TARGETS); got {p!r}")
        stack = {}
        for p in paths:
            a_list, b_list = [], []
            for n in names:
                ad = self.lora_adapters[n]
                if sorted(ad) != paths:
                    raise ValueError(f"adapter {n!r} targets differ from "
                                     f"{names[0]!r}")
                a_list.append(torch.as_tensor(ad[p]["a"]))
                b_list.append(torch.as_tensor(ad[p]["b"]))
            stack[p] = {
                k: torch.stack([torch.zeros_like(xs[0])] + xs).to(
                    device=self.device, dtype=torch.float32)
                for k, xs in (("a", a_list), ("b", b_list))}
        ranks = {s["a"].shape[-1] for s in stack.values()}
        if len(ranks) != 1:
            raise ValueError(f"adapters must share one rank, got {ranks}")
        return stack

    def _lora_scale(self, rank):
        return (self.lora_alpha if self.lora_alpha is not None
                else rank) / rank

    def _lora_qkv_delta(self, li, name, y, idx):
        """Per-slot factored delta of a [d, h, dk] projection: [S, h, t, dk]
        fp32 to add to the projected q/k/v, or None."""
        ent = self._lora.get(f"layer_{li}/self_attention/{name}")
        if ent is None:
            return None
        a, b = ent["a"][idx], ent["b"][idx]     # [S, d, r], [S, r, h, dk]
        xa = torch.einsum("std,sdr->str", y.float(), a)
        out = torch.einsum("str,srhk->sthk", xa, b) * self._lora_scale(
            a.shape[-1])
        return out.transpose(1, 2)

    def _lora_o_delta(self, li, o4, idx):
        """Per-slot delta of the output projection wo [hq, dk, d], whose
        factors contract the head axis (A [hq, r], B [r, dk, d]); ``o4``:
        [S, t, hq, dk]. Returns [S, t, d] fp32, or None."""
        ent = self._lora.get(f"layer_{li}/self_attention/wo")
        if ent is None:
            return None
        a, b = ent["a"][idx], ent["b"][idx]     # [S, hq, r], [S, r, dk, d]
        z = torch.einsum("sthk,shr->strk", o4.float(), a)
        return torch.einsum("strk,srkd->std", z, b) * self._lora_scale(
            a.shape[-1])

    def _merged(self, adapter_name):
        """The adapter's merged weights {name: tensor} (dense prefill only),
        cached per adapter."""
        if adapter_name not in self._merged_cache:
            from np_modeling_tpu_torch.training.lora import lora_merge
            with torch.no_grad():
                self._merged_cache[adapter_name] = lora_merge(
                    self.gpt, self.lora_adapters[adapter_name],
                    self.lora_alpha)
        return self._merged_cache[adapter_name]

    # ---- grammar constraints (JAX :612-740) -------------------------------

    def _rebuild_dfa_table(self) -> None:
        """The stacked [n + 1, NS, vocab] transition table of the constraints
        in ``self._dfa_names`` order (row 0 unconstrained: all-zero
        transitions, the state pinned at 0; padding states forbid all)."""
        V = self.gpt.config.vocab_size
        names = self._dfa_names
        NS = max((self.constraints[n].n_states for n in names), default=1)
        tab = np.zeros((len(names) + 1, NS, V), np.int32)
        starts = [0]
        for i, n in enumerate(names):
            d = self.constraints[n]
            t = np.asarray(d.trans, np.int32)
            if t.shape[1] != V:
                raise ValueError(f"constraint {n!r} vocab {t.shape[1]} != "
                                 f"engine vocab {V}")
            tab[i + 1, :t.shape[0]] = t
            tab[i + 1, t.shape[0]:] = -1
            starts.append(d.start)
        self._dfa_ids = {n: i + 1 for i, n in enumerate(names)}
        self._dfa_starts = np.asarray(starts, np.int32)
        self._dfa_trans = torch.from_numpy(tab).to(self.device)

    def register_constraint(self, name: str, dfa) -> None:
        """Register (or replace) a named ``TokenDFA`` at run time. Needs an
        engine constructed with ``constraints=`` (``{}`` enables it); a
        constraint that live sequences may be using cannot be replaced."""
        if self.constraints is None:
            raise ValueError("construct the engine with constraints={} "
                             "(or a dict) to enable runtime registration")
        if name in self._dfa_ids:
            if self._slots:
                raise ValueError(
                    f"cannot replace constraint {name!r} while sequences "
                    "are live (their DFA states index the old table)")
        else:
            self._dfa_names.append(name)
        self.constraints[name] = dfa
        self._rebuild_dfa_table()

    def _constrain_logits(self, logits, dfa_id, dfa_state):
        """``logits`` [rows, V] at -inf where each row's DFA state forbids
        the token (row 0 of the table lets every token through)."""
        allowed = self._dfa_trans[dfa_id.long(), dfa_state.long()] >= 0
        return torch.where(allowed, logits, -torch.inf)

    def _dfa_advance(self, dfa_id, dfa_state, toks):
        return self._dfa_trans[dfa_id.long(), dfa_state.long(),
                               toks.long()].clamp_min(0)

    def _set_request_constraint(self, slot: int, name) -> None:
        """A slot's DFA id and start state (None: unconstrained)."""
        cid = self._dfa_ids.get(name, 0)
        self._state["dfa_id"][slot] = cid
        self._state["dfa_state"][slot] = int(self._dfa_starts[cid])

    # ---- request lifecycle ----------------------------------------------

    @property
    def live(self):
        return sorted(self._slots)

    @property
    def free_pages(self) -> int:
        return len(self._lane_list[0].free)

    def capacity(self, seq_id: int) -> int:
        """Decode steps this sequence can still take before hitting the
        per-sequence token bound (model max_len / page-table rows)."""
        return self._max_tokens - self._host_len[seq_id]

    def _prefix_hashes(self, aid: int, prompt, plen: int) -> list:
        """Chained content hashes of the prompt's full pages: entry i names
        tokens [0, (i + 1) * page_size) under adapter ``aid``, so equal
        prefixes hash equal and a walk of the cache finds the longest cached
        page prefix (JAX :542)."""
        ps = self.page_size
        toks = np.asarray(prompt, np.int32)
        run = hashlib.sha1(repr((aid, ps)).encode())
        out = []
        for i in range(plen // ps):
            run.update(toks[i * ps:(i + 1) * ps].tobytes())
            out.append(run.hexdigest())
        return out

    def _evict_for(self, n: int) -> None:
        """Evict prefix-cache entries, least recently used first, until the
        target lane's free list holds ``n`` pages. Dropping the cache's
        reference frees a page only when no live sequence shares it; the
        cache shrinks either way, so this ends."""
        lane = self._lane_list[0]
        while self._prefix_cache and len(lane.free) < n:
            _, pg = self._prefix_cache.popitem(last=False)
            self._release([pg], lane)

    @property
    def prefix_cache_stats(self) -> dict:
        """{entries, hit_tokens, lookup_tokens}: hit_tokens counts prompt
        tokens whose k/v came from the cache instead of a prefill pass."""
        return {"entries": len(self._prefix_cache or ()),
                "hit_tokens": self._cache_hit_tokens,
                "lookup_tokens": self._cache_lookup_tokens}

    def _alloc(self, n: int, lane=None) -> list[int]:
        lane = lane or self._lane_list[0]
        if lane.is_target:
            self._evict_for(n)
        if len(lane.free) < n:
            raise OutOfPagesError(
                f"out of KV pages ({lane.total_pages} total)")
        pages = [lane.free.pop() for _ in range(n)]
        for p in pages:
            lane.refs[p] = 1
        return pages

    def _release(self, pages, lane=None) -> None:
        lane = lane or self._lane_list[0]
        for p in pages:
            if p not in lane.refs:
                continue   # the trash page (a window-reclaimed position)
            lane.refs[p] -= 1
            if lane.refs[p] == 0:
                del lane.refs[p]
                lane.free.append(p)

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

    def _table_row(self, pages, lane):
        row = np.full((self.max_pages,), lane.trash, np.int32)
        row[:len(pages)] = pages
        return torch.from_numpy(row).to(self.device)

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

    def _first_tokens(self, logits, slots, prompts):
        """The first tokens of newly prefilled slots, drawn from their last
        logits [B, V] masked by their DFA starts, and the bookkeeping that
        follows the draw (penalty statistics, the DFA's first step)."""
        self._seed_stats(list(zip(slots.tolist(), prompts)))
        if self._dfa_trans is not None:
            logits = self._constrain_logits(logits,
                                            self._state["dfa_id"][slots],
                                            self._state["dfa_state"][slots])
        toks = self._sample(logits, *self._stat_rows(slots))
        self._count_first(slots, toks)
        if self._dfa_trans is not None:
            st = self._state
            st["dfa_state"][slots] = self._dfa_advance(
                st["dfa_id"][slots], st["dfa_state"][slots], toks)
        return toks

    # ---- admission ----------------------------------------------------------

    def add_request(self, seq_id: int, prompt_tokens, adapter=None,
                    sampling=None, constraint=None) -> int:
        """Prefill a prompt; returns the first generated token.
        ``adapter``: a name of ``lora_adapters``; ``sampling``: this
        request's SamplingParams (per_request_sampling engines only);
        ``constraint``: a name of ``constraints``."""
        return self.add_requests({seq_id: prompt_tokens},
                                 {seq_id: adapter} if adapter else None,
                                 {seq_id: sampling} if sampling else None,
                                 {seq_id: constraint} if constraint
                                 else None)[seq_id]

    def add_requests(self, prompts: dict, adapters=None, sampling=None,
                     constraints=None) -> dict:
        """Prefill several prompts; returns {seq_id: first token}. Chunked
        prefill batches them into [B, chunk] forwards on every lane; dense
        prefill (``prefill_chunk_size=None``) runs them one by one.
        ``adapters``: {seq_id: adapter name}; ``sampling``: {seq_id:
        SamplingParams} (per_request_sampling engines only);
        ``constraints``: {seq_id: constraint name}."""
        adapters = adapters or {}
        sampling = sampling or {}
        constraints = constraints or {}
        if sampling and not self.per_request_sampling:
            raise ValueError("construct the engine with per_request_"
                             "sampling=True to pass per-request "
                             "SamplingParams")
        if constraints and self._dfa_trans is None:
            raise ValueError("construct the engine with constraints="
                             "{name: TokenDFA} to pass constraint=")
        for name in adapters.values():
            if name is not None and name not in self._adapter_ids:
                raise ValueError(f"unknown adapter {name!r}; engine has "
                                 f"{sorted(self._adapter_ids)}")
        for name in constraints.values():
            if name is not None and name not in self._dfa_ids:
                raise ValueError(f"unknown constraint {name!r}; engine has "
                                 f"{sorted(self._dfa_ids)}")
        items = sorted(prompts.items())
        free_slots = self._free_slots()
        if len(free_slots) < len(items):
            raise RuntimeError(
                f"{len(items)} requests but only {len(free_slots)} of "
                f"{self.max_seqs} slots free")
        reqs = []
        for (sid, toks), slot in zip(items, free_slots):
            arr, plen = self._check_prompt(sid, toks)
            reqs.append((sid, slot, arr, plen,
                         self._adapter_ids.get(adapters.get(sid), 0)))
        for sid, slot, _, _, aid in reqs:
            self._state["adapter"][slot] = aid
            if self.per_request_sampling:
                self._set_request_sampling(slot, sampling.get(sid))
            if self._dfa_trans is not None:
                self._set_request_constraint(slot, constraints.get(sid))
        if not self._chunked:
            return {sid: self._add_request_dense(sid, slot, arr, plen,
                                                 adapters.get(sid))
                    for sid, slot, arr, plen, _ in reqs}
        return self._add_requests_chunked(reqs)

    @torch.no_grad()
    def _add_request_dense(self, seq_id, slot, prompt, plen,
                           adapter=None) -> int:
        """Dense prefill (JAX :778-838): one ``GPT.apply(collect_kv=True,
        logits_last_only=True)`` over the prompt a lane (the target with
        the adapter's merged weights), the first token drawn from the
        target's last logits, and every layer's k/v scattered into fresh
        pages of its lane (``_pad_kvs`` / ``_make_prefill``)."""
        ps = self.page_size
        toks = torch.from_numpy(prompt).to(self.device)[None]
        n_pages = -(-plen // ps)
        # Atomic across lanes: every allocation is checked before any.
        for lane in self._lane_list:
            if lane.is_target:
                self._evict_for(n_pages)
            if len(lane.free) < n_pages:
                raise OutOfPagesError(
                    f"out of KV pages ({lane.total_pages} total)")
        with swapped(self.gpt, self._merged(adapter) if adapter else {}):
            logits, kvs = self.gpt.apply(toks, collect_kv=True,
                                         logits_last_only=True)
        slots = torch.tensor([slot], device=self.device)
        tok = self._first_tokens(logits[:, -1].float(), slots, [prompt])
        pos = torch.arange(n_pages * ps, device=self.device)
        for lane in self._lane_list:
            if not lane.is_target:
                _, kvs = lane.gpt.apply(toks, collect_kv=True,
                                        logits_last_only=True)
            st = lane.state
            pages = self._alloc(n_pages, lane)
            pages_t = torch.tensor(pages, dtype=torch.long,
                                   device=self.device)
            p_idx = torch.where(pos < plen, pages_t[pos // ps], lane.trash)
            for li, (k, v) in enumerate(kvs):
                self._append(st, li, p_idx, pos % ps,
                             *self._pad_kvs(k, v, pos))
            st["table"][slot] = self._table_row(pages, lane)
            st["lengths"][slot] = plen
            st["last_tok"][slot] = tok[0]
            st["active"][slot] = True
            lane.seq_pages[seq_id] = pages
        self._slots[seq_id] = slot
        self._host_len[seq_id] = plen
        self._history[seq_id] = prompt.tolist() + [int(tok[0])]
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
        as one [B, chunk] forward over all new sequences, on each lane. A
        row whose prompt is exhausted goes inactive (its appends land on the
        trash page); the per-row causal mask makes a padded final chunk
        exact.

        With ``enable_prefix_cache`` each row first takes the longest
        page-aligned prefix of its prompt that the cache holds (at most
        ``plen - 1`` tokens, so one token always runs and gives the first
        logits): those pages are shared, and only the suffix streams
        through the chunks, each row from its own base (JAX :903-1052).

        ``reqs``: list of (seq_id, slot, prompt [plen], plen, adapter id)."""
        chunk = self.prefill_chunk_size
        B = len(reqs)
        ps = self.page_size
        target = self._lane_list[0]
        matches = {sid: [] for sid, *_ in reqs}
        if self._prefix_cache is not None:
            for sid, _, prompt, plen, aid in reqs:
                chain = self._prefix_hashes(aid, prompt, plen)
                for h in chain[:(plen - 1) // ps]:
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
                    target.refs[pg] += 1
        bases = np.asarray([len(matches[sid]) * ps for sid, *_ in reqs])
        total = sum(-(-plen // ps) - len(matches[sid])
                    for sid, _, _, plen, _ in reqs)
        for lane in self._lane_list:     # all-or-nothing across rows, lanes
            if lane.is_target:
                self._evict_for(total)
            if len(lane.free) < total:
                for pages in matches.values():
                    self._release(pages, target)
                raise OutOfPagesError("out of KV pages for chunked prefill")
        for lane in self._lane_list:
            st = lane.state
            for sid, slot, _, plen, _ in reqs:
                n_pages = -(-plen // ps)
                shared = matches[sid] if lane.is_target else []
                pages = shared + self._alloc(n_pages - len(shared), lane)
                lane.seq_pages[sid] = pages
                # Tail entries -> trash: a padded final chunk's appends
                # beyond the allocated pages must not land on a live page.
                st["table"][slot] = self._table_row(pages, lane)
        for sid, slot, _, plen, _ in reqs:
            self._slots[sid] = slot
            self._host_len[sid] = plen

        plens = np.asarray([plen for _, _, _, plen, _ in reqs])
        suffix = plens - bases
        slots = torch.tensor([slot for _, slot, *_ in reqs],
                             dtype=torch.long, device=self.device)
        n_chunks = int(-(-suffix.max() // chunk))
        padded = np.zeros((B, n_chunks * chunk), np.int64)
        for i, (_, _, prompt, plen, _) in enumerate(reqs):
            padded[i, :suffix[i]] = prompt[bases[i]:]
        padded = torch.from_numpy(padded).to(self.device)
        final_ci = (suffix - 1) // chunk       # row i's last chunk index
        row_logits = [None] * B
        for lane in self._lane_list:
            st = lane.state
            for ci in range(n_chunks):
                n_valid = np.clip(suffix - ci * chunk, 0, chunk)
                lg = self._prefill_chunk(
                    st, padded[:, ci * chunk:(ci + 1) * chunk], slots,
                    torch.from_numpy((bases + ci * chunk).astype(np.int32)).to(
                        self.device),
                    torch.from_numpy(n_valid.astype(np.int32)).to(
                        self.device), lane)
                if lane.is_target:
                    for i in np.nonzero(final_ci == ci)[0]:
                        row_logits[int(i)] = lg[i]

        # Every full prompt page is now content-addressed; the cache holds
        # a reference of its own, so entries outlive finish() until evicted.
        if self._prefix_cache is not None:
            for sid, _, prompt, plen, aid in reqs:
                pages = target.seq_pages[sid]
                for i, h in enumerate(self._prefix_hashes(aid, prompt, plen)):
                    if h not in self._prefix_cache:
                        self._prefix_cache[h] = pages[i]
                        target.refs[pages[i]] += 1

        toks = self._first_tokens(torch.stack(row_logits), slots,
                                  [prompt for _, _, prompt, _, _ in reqs])
        lens = torch.from_numpy(plens.astype(np.int32)).to(self.device)
        for lane in self._lane_list:
            st = lane.state
            st["lengths"][slots] = lens
            st["last_tok"][slots] = toks
            st["active"][slots] = True
        out = {sid: int(t) for (sid, *_), t in zip(reqs, toks.tolist())}
        for sid, _, prompt, _, _ in reqs:
            self._history[sid] = prompt.tolist() + [out[sid]]
        return out

    def _prefill_chunk(self, state, toks, slots, base_len, n_valid,
                       lane=None):
        """One chunk forward over a batch-B view of a lane (port of the JAX
        ``_make_prefill_chunk`` body; ``base_len`` [B] per row). Returns
        last-position logits of each row's valid tokens, [B, vocab] fp32."""
        chunk = toks.shape[1]
        view = dict(state)         # page tensors are shared and written
        view["table"] = state["table"][slots]
        view["lengths"] = base_len
        view["active"] = n_valid > 0
        view["adapter"] = state["adapter"][slots]
        view, hidden = self._forward_tokens(view, toks, lane,
                                            return_hidden=True)
        pos = (n_valid.long() - 1).clamp(0, chunk - 1)
        last = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                      pos]
        return self._lane_head(last[:, None], lane)[:, 0]

    def finish(self, seq_id: int) -> None:
        slot = self._slots.pop(seq_id)
        del self._host_len[seq_id]
        self._history.pop(seq_id, None)
        for lane in self._lane_list:
            lane.marks.pop(seq_id, None)
            self._release(lane.seq_pages.pop(seq_id), lane)
            st = lane.state
            st["active"][slot] = False
            st["lengths"][slot] = 0
            st["adapter"][slot] = 0
            if "counts" in st:     # a reused slot inherits no penalties
                st["counts"][slot] = 0
                st["prompt_mask"][slot] = False
            if "samp" in st:       # ...no knobs
                st["samp"][slot] = torch.from_numpy(self._default_row).to(
                    self.device)
                st["samp_bias"][slot] = 0.0
            if "dfa_id" in st:     # ...and no grammar
                st["dfa_id"][slot] = 0
                st["dfa_state"][slot] = 0

    # ---- fork: refcounted page sharing ----------------------------------

    @torch.no_grad()
    def fork(self, parent_id: int, new_id: int) -> None:
        """Clone a live sequence (JAX :1137-1225), on every lane. The child
        shares the parent's full pages (refcounted; pages are append-only,
        so none is ever copied on write) and copies the partial tail page;
        it inherits the parent's last token, adapter, sampling rows, counts
        and DFA state. Both then decode on their own; ``finish`` frees a
        page when its last owner leaves."""
        if new_id in self._slots:
            raise ValueError(f"sequence {new_id} already live")
        pslot = self._slots[parent_id]
        free_slots = self._free_slots()
        if not free_slots:
            raise RuntimeError(f"all {self.max_seqs} slots busy")
        slot = free_slots[0]
        plen = self._host_len[parent_id]
        full, partial = divmod(plen, self.page_size)
        need = 1 if partial else 0
        self._evict_for(need)
        if any(len(lane.free) < need for lane in self._lane_list):
            raise OutOfPagesError("out of KV pages for fork")
        for lane in self._lane_list:
            parent_pages = lane.seq_pages[parent_id]
            child = list(parent_pages[:full])
            for p in child:
                if p in lane.refs:   # reclaimed positions hold the trash page
                    lane.refs[p] += 1
            st = lane.state
            if partial:
                dst = self._alloc(1, lane)[0]
                src = parent_pages[full]
                child.append(dst)
                for key in ("k_pages", "v_pages", "k_scales", "v_scales"):
                    for buf in st.get(key, ()):
                        buf[:, dst] = buf[:, src]
            st["table"][slot] = self._table_row(child, lane)
            st["lengths"][slot] = plen
            st["active"][slot] = True
            for key in ("last_tok", "adapter", "counts", "prompt_mask",
                        "samp", "samp_bias", "dfa_id", "dfa_state"):
                if key in st:
                    st[key][slot] = st[key][pslot]
            lane.seq_pages[new_id] = child
            # The child's page list shares the parent's trash placeholders
            # below the parent's watermark, so it inherits the watermark too.
            if parent_id in lane.marks:
                lane.marks[new_id] = lane.marks[parent_id]
        self._slots[new_id] = slot
        self._host_len[new_id] = plen
        self._history[new_id] = list(self._history[parent_id])

    # ---- sliding-window page reclamation ------------------------------------

    def _reclaim_window_pages(self) -> None:
        """Free the pages that fell out of a sliding-window model's span
        (positions < length - window) on each lane (JAX :1228-1267):
        per-sequence KV memory stays near ``window`` tokens however long it
        decodes. Paged attention never reads such positions (it masks below
        the band), so a reclaimed and reused page is at worst loaded and
        discarded. Their table entries point at the trash page; shared pages
        are freed when their last owner lets them go. Models whose layers
        alternate local and global windows keep every page: the global
        layers read them."""
        for lane in self._lane_list:
            c = lane.gpt.config
            w = c.attention_window
            if w is None or c.window_pattern > 1:
                continue
            upd = []                               # (slot, page position)
            for seq_id, slot in self._slots.items():
                expired = (self._host_len[seq_id] - w) // self.page_size
                pages = lane.seq_pages[seq_id]
                start = lane.marks.get(seq_id, 0)
                for pos in range(start, min(expired, len(pages))):
                    if pages[pos] == lane.trash:
                        continue        # reclaimed already (a fork's share)
                    self._release([pages[pos]], lane)
                    pages[pos] = lane.trash
                    upd.append((slot, pos))
                lane.marks[seq_id] = max(start, min(expired, len(pages)))
            if upd:
                slots, poss = (torch.tensor(u, dtype=torch.long,
                                            device=self.device)
                               for u in zip(*upd))
                lane.state["table"][slots, poss] = lane.trash

    # ---- decode step (host: page growth, then one device step) ----------

    def _grow_tables(self, n: int):
        """Ensure every live sequence's page tables (each lane's) cover
        ``n`` more tokens. Window reclamation runs first (it can only free
        pages). The growth is all-or-nothing: needs are computed first, and
        the free lists, host bookkeeping and device tables change only once
        the growth fits on every lane."""
        self._reclaim_window_pages()
        plans = []
        for lane in self._lane_list:
            needs = []                        # (seq_id, slot, n_new_pages)
            for seq_id, slot in self._slots.items():
                ln_len = self._host_len[seq_id]
                if ln_len + n > self._max_tokens:
                    raise OutOfPagesError(
                        f"sequence {seq_id} would exceed the "
                        f"{self._max_tokens}-token capacity (model max_len)")
                extra = -(-(ln_len + n) // self.page_size) \
                    - len(lane.seq_pages[seq_id])
                if extra > 0:
                    needs.append((seq_id, slot, extra))
            total = sum(e for *_, e in needs)
            if lane.is_target:
                self._evict_for(total)
            if len(lane.free) < total:
                raise OutOfPagesError(
                    f"out of KV pages ({lane.total_pages} total; need "
                    f"{total}, free {len(lane.free)})")
            plans.append((lane, needs))
        for lane, needs in plans:
            upd = []                          # (slot, page_pos, new_page)
            for seq_id, slot, extra in needs:
                for pg in self._alloc(extra, lane):
                    lane.seq_pages[seq_id].append(pg)
                    upd.append((slot, len(lane.seq_pages[seq_id]) - 1, pg))
            if upd:
                slots, poss, pgs = (torch.tensor(u, dtype=torch.long)
                                    for u in zip(*upd))
                table = lane.state["table"]
                table[slots.to(self.device), poss.to(self.device)] = \
                    pgs.to(table)
        return self._state

    def _emit(self, out):
        """Record emitted tokens {seq_id: [tokens]} in the host lengths and
        histories; returns ``out``."""
        for seq_id, toks in out.items():
            self._host_len[seq_id] += len(toks)
            self._history[seq_id].extend(toks)
        return out

    @torch.no_grad()
    def step(self) -> dict:
        """Decode one token for every live sequence; {seq_id: token}."""
        if not self._slots:
            return {}
        st = self._grow_tables(1)
        self._state, toks = self._device_step(st)
        toks_np = toks.cpu().numpy()
        out = {seq_id: int(toks_np[slot])
               for seq_id, slot in sorted(self._slots.items())}
        self._emit({sid: [t] for sid, t in out.items()})
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
        return self._emit({seq_id: [int(t) for t in toks_np[:, slot]]
                           for seq_id, slot in sorted(self._slots.items())})

    # ---- speculative decoding (the draft lane) ----------------------------

    def _ragged(self, emitted, produced):
        """{seq_id: tokens} from a round's (or rounds') emitted [..., S,
        gamma+1] and produced [..., S] read back to the host."""
        emitted = emitted.cpu().numpy().reshape(-1, *emitted.shape[-2:])
        produced = produced.cpu().numpy().reshape(-1, produced.shape[-1])
        return self._emit({
            seq_id: [int(t) for r in range(len(produced))
                     for t in emitted[r, slot, :produced[r, slot]]]
            for seq_id, slot in sorted(self._slots.items())})

    def _check_draft(self):
        if self.draft_gpt is None:
            raise ValueError("construct the engine with draft_gpt= to use "
                             "speculative decoding")

    @torch.no_grad()
    def step_speculative(self, gamma: int = 4) -> dict:
        """One speculative round (JAX :1367-1409): the draft proposes
        ``gamma`` tokens a live sequence, the target verifies all of them in
        one multi-token paged forward, and each sequence commits its
        accepted prefix plus one target token: 1 to ``gamma + 1`` tokens.
        ``temperature == 0``: greedy, token for token ``step()``'s;
        otherwise speculative sampling (``models.speculative``), whose
        output distribution is target-only sampling's (top-k / top-p
        filter both sides alike). Returns {seq_id: [tokens]} (ragged)."""
        self._check_draft()
        if not self._slots:
            return {}
        self._grow_tables(gamma + 1)   # worst case: all gamma+1 committed
        return self._ragged(*self._spec_device_step(gamma))

    @torch.no_grad()
    def step_speculative_many(self, rounds: int, gamma: int = 4) -> dict:
        """``rounds`` speculative rounds (JAX :1411-1452), a Python loop of
        device rounds whose tokens are read back once, after it. Returns
        {seq_id: [tokens]} (ragged)."""
        self._check_draft()
        if not self._slots:
            return {}
        self._grow_tables(rounds * (gamma + 1))
        outs = [self._spec_device_step(gamma) for _ in range(rounds)]
        return self._ragged(torch.stack([e for e, _ in outs]),
                            torch.stack([p for _, p in outs]))

    def _commit(self, state, drafts, n_acc, nxt):
        """Emitted tokens [S, g + 1] (-1 past each row's count, and on
        inactive rows) and produced counts [S] of a verify; the lane's
        lengths and last tokens advance by them (the rollback: k/v past
        the new lengths stay unread)."""
        active, cur = state["active"], state["last_tok"]
        S, gamma = drafts.shape
        produced = torch.where(active, n_acc + 1, 0).to(torch.int32)
        i = torch.arange(gamma + 1, device=drafts.device)[None]
        drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], 1)
        emitted = torch.where(i < n_acc[:, None], drafts_pad,
                              torch.where(i == n_acc[:, None], nxt[:, None],
                                          -1))
        emitted = torch.where(active[:, None], emitted, -1)
        state["lengths"] = state["lengths"] + produced
        state["last_tok"] = torch.where(active, nxt, cur)
        return emitted, produced

    def _spec_device_step(self, gamma: int):
        """One round on both lanes (JAX :1546-1606); returns (emitted [S,
        gamma + 1], produced [S])."""
        target, draft = self._lane_list
        state, dstate = target.state, draft.state
        cur, base_d = state["last_tok"], dstate["lengths"]
        # 1. The draft proposes gamma tokens (its logits kept for the
        # sampled accept ratio).
        drafts, d_logits = [], []
        for _ in range(gamma):
            dstate, _, lg = self._device_step(dstate, return_logits=True,
                                              lane=draft)
            drafts.append(dstate["last_tok"])
            d_logits.append(lg)
        drafts = torch.stack(drafts, dim=1)                 # [S, gamma]
        # One more draft step caches d_gamma's k/v, so a fully accepted
        # round leaves the draft cache complete (its token and bookkeeping
        # are overwritten below).
        dstate, _ = self._device_step(dstate, lane=draft)
        # 2. The target verifies all gamma + 1 positions in one forward.
        block = torch.cat([cur[:, None], drafts], dim=1)
        state, logits = self._forward_tokens(state, block, target)
        # 3. Accept a prefix; commit one target token.
        if self.temperature == 0.0:
            n_acc, nxt = accept_greedy(logits, drafts)
        else:
            n_acc, nxt = speculative_accept_logits(
                logits, torch.stack(d_logits, dim=1), drafts, self._gen,
                self.temperature, self.top_k, self.top_p)
        emitted, produced = self._commit(state, drafts, n_acc, nxt)
        # 4. The draft lane commits the same counts from its own base.
        dstate["lengths"] = base_d + produced
        dstate["last_tok"] = torch.where(dstate["active"], nxt,
                                         dstate["last_tok"])
        target.state, draft.state = state, dstate
        return emitted, produced

    # ---- prompt-lookup decoding (no draft model) -----------------------------

    @torch.no_grad()
    def step_lookup(self, gamma: int = 4, ngram: int = 3) -> dict:
        """Draft-free speculative decoding (JAX :1456-1501): each live
        sequence's next ``gamma`` tokens are proposed from the rightmost
        match of its last ``ngram`` tokens in its own history (prompt and
        emitted tokens), then the target verifies all ``gamma + 1``
        positions in one multi-token paged forward and commits the accepted
        prefix plus one target token, token for token greedy ``step()``'s.
        Greedy engines only, without a draft lane or constraints. Returns
        {seq_id: [tokens]} (ragged)."""
        if self.temperature != 0.0 or self._sp is not None \
                or self.per_request_sampling:
            raise ValueError("prompt-lookup decoding verifies with a plain "
                             "greedy argmax: sampling configs would break "
                             "its token exactness (JAX asserts)")
        if self.draft_gpt is not None:
            raise ValueError("step_lookup on a draft-lane engine would "
                             "desync the draft cache lengths; use "
                             "step_speculative (JAX asserts)")
        if self._dfa_trans is not None:
            raise ValueError("step_lookup's verify argmax bypasses the "
                             "constraint masks: use step() with constrained "
                             "engines (JAX asserts)")
        if not self._slots:
            return {}
        self._grow_tables(gamma + 1)
        drafts = np.zeros((self.max_seqs, gamma), np.int32)
        for seq_id, slot in self._slots.items():
            drafts[slot] = self._propose_lookup(self._history[seq_id],
                                                gamma, ngram)
        return self._ragged(*self._lookup_device_step(
            torch.from_numpy(drafts).to(self.device)))

    @staticmethod
    def _propose_lookup(hist, gamma: int, ngram: int):
        """Rightmost-match n-gram continuation from ``hist`` (host numpy,
        JAX :1503-1518): shorter grams are tried down to 1, so fresh
        sequences still propose; no match proposes zeros (they reject)."""
        h = np.asarray(hist, np.int32)
        for n in range(min(ngram, len(h) - 1), 0, -1):
            pat = h[len(h) - n:]
            win = np.lib.stride_tricks.sliding_window_view(h, n)
            hits = np.nonzero((win == pat).all(axis=1))[0]
            hits = hits[hits < len(h) - n]      # not the pattern itself
            if len(hits):
                j = int(hits[-1]) + n
                prop = h[j:j + gamma]
                return np.pad(prop, (0, gamma - len(prop)))
        return np.zeros((gamma,), np.int32)

    def _lookup_device_step(self, drafts):
        """Verify proposals [S, gamma] in one forward and commit the greedily
        accepted prefix + 1 (JAX :1520-1544)."""
        state = self._state
        block = torch.cat([state["last_tok"][:, None], drafts], dim=1)
        state, logits = self._forward_tokens(state, block,
                                             self._lane_list[0])
        emitted, produced = self._commit(state, drafts,
                                         *accept_greedy(logits, drafts))
        self._state = state
        return emitted, produced

    # ---- the device step --------------------------------------------------

    def _forward_tokens(self, state, tokens, lane=None, return_hidden=False):
        """Run the lane's model over ``tokens`` [S, t], appending their K/V
        to the lane's pages. Returns (state, logits [S, t, vocab] fp32), or
        the final-norm hidden states with ``return_hidden=True``. Leaves
        lengths/last_tok to the caller."""
        lane = lane or self._lane_list[0]
        gpt = lane.gpt
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
            x, state = self._block_step(gpt._block_for(li), x, li, state,
                                        lane)
        x = gpt.final_norm(x)
        if return_hidden:
            return state, x
        return state, self._lane_head(x, lane)

    def _lane_head(self, x, lane):
        """The LM head of the lane's model (the target's is ``_lm_head``)."""
        if lane is None or lane.is_target:
            return self._lm_head(x)
        return self._head(x, lane.gpt)

    def _lm_head(self, x):
        """The target's LM head."""
        return self._head(x, self.gpt)

    @staticmethod
    def _head(x, gpt):
        """The LM head, fp32 logits (JAX :1640-1651): ``GPT.head`` (x is in
        the compute dtype), then the final softcap."""
        logits = gpt.head(x).float()
        cap = gpt.config.final_logit_softcap
        if cap is not None:
            logits = cap * torch.tanh(logits / cap)
        return logits

    @torch.no_grad()
    def _device_step(self, state, return_logits=False, lane=None):
        active = state["active"]
        state, logits = self._forward_tokens(state,
                                             state["last_tok"][:, None], lane)
        step_logits = logits[:, 0]
        if "dfa_state" in state:
            step_logits = self._constrain_logits(
                step_logits, state["dfa_id"], state["dfa_state"])
        new_tok = self._sample(step_logits, state.get("counts"),
                               state.get("prompt_mask"), state.get("samp"),
                               state.get("samp_bias"))
        if "dfa_state" in state:
            state["dfa_state"] = torch.where(
                active, self._dfa_advance(state["dfa_id"],
                                          state["dfa_state"], new_tok),
                state["dfa_state"])
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
        offs[n]), in place (index_put_), zero-padded to the pages' width;
        with ``quantize_kv`` the int8 values into the pages and their
        scales at the same (pages, offs) (a zero column leaves the absmax
        scale as it is). Duplicate targets occur only on the trash page.
        ``v_new`` None (MLA's latent rows): k only."""
        writes = [("k", k_new)] + ([] if v_new is None else [("v", v_new)])
        width = state["k_pages"][li].shape[-1]
        writes = [(kind, torch.nn.functional.pad(new, (0, width
                                                       - new.shape[-1])))
                  for kind, new in writes]
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

    def _write_slots(self, state, tok_pos, trash):
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
                            trash).reshape(-1)
        return pages, slot_off

    def _block_step(self, bp, x, li, state, lane=None):
        """One pre-norm block on the [S, t, d] slice (t = 1 to decode, gamma
        + 1 to verify, a chunk to prefill): page append, paged attention,
        FFN. Mirrors the JAX engine's ``_block_step``; on the target lane of
        a multi-LoRA engine each slot's adapter delta joins q/k/v and the
        output projection."""
        lane = lane or self._lane_list[0]
        if lane.gpt.config.mla is not None:
            return self._block_step_mla(bp, x, li, state, lane)
        attn = bp.self_attention
        active, lengths = state["active"], state["lengths"]
        S, t = x.shape[:2]

        skip = x
        y = bp.norm1(x)
        q = attn._project(y, attn.wq, attn.bq)            # [S, hq, t, dk]
        k = attn._project(y, attn.wk, attn.bk)
        v = attn._project(y, attn.wv, attn.bv)
        lora = self._lora if lane.is_target else None
        if lora is not None:
            aidx = state["adapter"].long()

            def adapt(t_, name):
                d_ = self._lora_qkv_delta(li, name, y, aidx)
                return t_ if d_ is None else t_ + d_.to(t_.dtype)

            q, k, v = adapt(q, "wq"), adapt(k, "wk"), adapt(v, "wv")
        tok_pos = lengths[:, None].long() + torch.arange(t, device=x.device)
        q, k = attn._rope(q, tok_pos), attn._rope(k, tok_pos)
        pages, slot_off = self._write_slots(state, tok_pos, lane.trash)
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
                                softcap=attn.attn_softcap, sinks=attn.sinks,
                                **kwargs)
        hq, dk, d_out = attn.wo.shape
        o4 = o.to(x.dtype)                                  # [S, t, hq, dk]
        bo = attn.bo.to(x.dtype) if attn.bo is not None else None
        y = ops.linear(o4.reshape(S, t, hq * dk),
                       attn.wo.reshape(hq * dk, d_out).to(x.dtype), bo)
        if lora is not None:
            d_ = self._lora_o_delta(li, o4, aidx)
            if d_ is not None:
                y = y + d_.to(y.dtype)
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

    def _block_step_mla(self, bp, x, li, state, lane):
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
        pages, slot_off = self._write_slots(state, tok_pos, lane.trash)
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
