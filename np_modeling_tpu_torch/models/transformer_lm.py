"""GPT-style causal decoder-only language model.

Counterpart of np_modeling_tpu/models/transformer_lm.py. ``GPTConfig`` has
the JAX config's fields and defaults (``dtype`` is a torch dtype here). The
port builds the GPT-2 family (learned positions, LayerNorm, pre-norm blocks
with an MLP FFN, relu or tanh-gelu, biases optional, tied embeddings) and
Gemma-2's features: RoPE, RMSNorm (with the ``gamma + 1`` offset), gated
FFNs (swiglu, geglu), sandwich norms, the embedding scale, a sliding window
that alternates by layer (``window_pattern``), the attention and final
logit softcaps and ``query_pre_attn_scalar``; DeepSeek-V2's latent
attention (``mla``, JAX nn/mla.py) with YaRN RoPE scaling and an untied LM
head (``lm_head.w`` [d, vocab], no bias); and routed MoE FFNs
(``moe_experts``, ``nn.MoE``: every routing rule, no-drop and capacity
dispatch, shared experts, the first ``moe_first_dense`` layers dense; the
forward only, its backward raises). A config outside those raises
NotImplementedError. ``GPT`` owns its parameters under the JAX parameter
paths (``embedding.table``, ``layer_{i}.self_attention.wq``,
``layer_{i}.dense1.linear.w`` or ``layer_{i}.swiglu.w_gate``, ...).
``GPT.apply`` is the dense forward over flash attention (or, with
``caches`` from ``GPT.init_cache`` and ``decode=True``, the dense KV-cache
step), ``GPT.generate`` the autoregressive decode over it, greedy or
sampled through ``filter_logits``, and ``GPT.loss`` the next-token loss
that training differentiates; the serving engine runs the same modules over
paged attention.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from np_modeling_tpu_torch import ops, rng as _rng
from np_modeling_tpu_torch.nn import (Dropout, Embedding, LayerNorm, Linear,
                                      RMSNorm)
from np_modeling_tpu_torch.nn.module import (maybe_cast, resolve_rngs,
                                             split_rngs)
from np_modeling_tpu_torch.nn.attention import cache_positions
from np_modeling_tpu_torch.nn.transformer import TransformerEncoderBlock


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 32000
    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int | None = None      # GQA
    num_layers: int = 4
    hidden_units: int = 2048
    max_len: int = 1024
    drop_rate: float = 0.0
    norm_first: bool = True
    tie_embeddings: bool = True
    dtype: object = None          # compute dtype, e.g. torch.bfloat16
    scan_layers: bool = False
    remat: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_aux_weight: float = 0.01
    moe_capacity_factor: float | None = 1.25
    moe_router_weights: str = "default"
    moe_routed_scaling: float = 1.0
    moe_shared_units: int = 0
    moe_router_groups: tuple | None = None
    moe_router_score: str = "softmax"
    moe_router_select_bias: bool = False
    moe_group_metric: str = "max"
    moe_hidden_units: int | None = None
    moe_first_dense: int = 0
    positional: str = "learned"   # "learned" | "rope"
    activation: str = "relu"      # "gelu" is the tanh form = HF "gelu_new"
    ln_eps: float = 1e-3          # GPT-2 needs 1e-5, set explicitly
    norm: str = "layer"
    rms_offset: bool = False
    ffn: str = "mlp"
    head_dim: int | None = None
    embed_scale: bool = False
    use_bias: bool = True
    qkv_bias: bool | None = None
    rope_base: float = 10000.0
    rope_dim: int | None = None
    rope_scaling: tuple | None = None
    parallel_residual: bool = False
    parallel_shared_norm: bool = False
    lm_head_bias: bool = False
    attention_window: int | None = None
    window_pattern: int = 1
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    query_pre_attn_scalar: float | None = None
    sandwich_norm: bool = False
    qk_norm: bool = False
    attn_sinks: bool = False
    moe_router_bias: bool = False
    mla: dict | None = None
    fused_loss: bool = False


# Config values the port builds; anything else is a later slice. The
# window, both softcaps, query_pre_attn_scalar and the mla dims take any
# value; rope_scaling is None or a ("yarn", ...) tuple.
_PORTED = {"positional": ("learned", "rope"), "norm": ("layer", "rms"),
           "ffn": ("mlp", "swiglu", "geglu", "glu_clamp"),
           "activation": ("relu", "gelu"), "norm_first": (True,),
           "tie_embeddings": (True, False), "lm_head_bias": (False,),
           "scan_layers": (False,),
           "attn_sinks": (False,), "qk_norm": (False,),
           "parallel_residual": (False,), "sandwich_norm": (False, True),
           "embed_scale": (False, True)}


def check_ported(config: GPTConfig) -> None:
    """Raise NotImplementedError for a config feature the port does not
    build (ValueError for a window pattern without a window, as JAX
    asserts)."""
    bad = {k: getattr(config, k) for k, ok in _PORTED.items()
           if getattr(config, k) not in ok}
    scaling = config.rope_scaling
    if scaling is not None and (scaling[0] != "yarn" or len(scaling) != 6):
        bad["rope_scaling"] = scaling
    if bad:
        raise NotImplementedError(
            f"GPTConfig features not ported yet: {bad} (ROADMAP.md Queue 1)")
    if config.window_pattern > 1 and config.attention_window is None:
        raise ValueError("window_pattern > 1 needs an attention_window")
    if config.moe_first_dense > 0:
        if not config.moe_experts:
            raise ValueError("moe_first_dense keeps the first layers dense "
                             "in an MoE model: it needs moe_experts (JAX "
                             "asserts)")
        if config.window_pattern != 1:
            raise ValueError("window_pattern and moe_first_dense both fork "
                             "the block; composing them is not wired (JAX "
                             "asserts)")


def moe_fields(config: GPTConfig, dense: bool = False) -> dict:
    """The block's ``moe_*`` arguments; ``dense``: a first layer kept dense
    (``moe_first_dense``, DeepSeek's first_k_dense_replace)."""
    c = config
    return dict(moe_experts=0 if dense else c.moe_experts,
                moe_top_k=c.moe_top_k,
                moe_capacity_factor=c.moe_capacity_factor,
                moe_router_weights=c.moe_router_weights,
                moe_routed_scaling=c.moe_routed_scaling,
                moe_shared_units=c.moe_shared_units,
                moe_router_groups=c.moe_router_groups,
                moe_router_score=c.moe_router_score,
                moe_router_select_bias=c.moe_router_select_bias,
                moe_group_metric=c.moe_group_metric,
                moe_hidden_units=c.moe_hidden_units,
                moe_router_bias=c.moe_router_bias)


def window_for(config: GPTConfig, i: int):
    """Layer i's sliding window, None for global attention: with
    ``window_pattern > 1`` the layers ``i % pattern != 0`` attend globally
    (Gemma-2's alternation, JAX ``_block_for`` :190-198)."""
    if config.window_pattern > 1 and i % config.window_pattern != 0:
        return None
    return config.attention_window


class GPT(nn.Module):
    """The model's modules and parameters, on ``device``: the card
    (``cuda``) unless the caller names another, as JAX places arrays on its
    default backend; without a card that raises, as torch does. Parameters
    are allocated uninitialised: call ``init(generator)`` or load weights
    (``utils.convert.params_from_numpy``)."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        check_ported(config)
        device = torch.device("cuda") if device is None else device
        c = self.config = config
        self.embedding = Embedding(c.vocab_size, c.d_model, device)
        if c.positional == "learned":
            self.pos_embedding = Embedding(c.max_len, c.d_model, device)
        attn_scale = (c.query_pre_attn_scalar ** -0.5
                      if c.query_pre_attn_scalar is not None else None)
        mla = None
        if c.mla is not None:
            mla = dict(c.mla)
            if c.positional == "rope":   # JAX sets them on the block's attn
                mla.update(rope_base=c.rope_base, rope_scaling=c.rope_scaling)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderBlock(
                c.d_model, c.num_heads, c.hidden_units,
                num_kv_heads=c.num_kv_heads, dtype=c.dtype,
                activation=c.activation, ln_eps=c.ln_eps,
                use_bias=c.use_bias, qkv_bias=c.qkv_bias,
                head_dim=c.head_dim, causal=True, drop_rate=c.drop_rate,
                norm=c.norm, rms_offset=c.rms_offset, ffn=c.ffn,
                sandwich_norm=c.sandwich_norm,
                rope=c.positional == "rope", rope_base=c.rope_base,
                rope_dim=c.rope_dim, window=window_for(c, i),
                attn_scale=attn_scale, attn_softcap=c.attn_logit_softcap,
                mla=mla, device=device,
                **moe_fields(c, dense=i < c.moe_first_dense)))
        self.final_norm = (RMSNorm(c.d_model, c.ln_eps, c.rms_offset, device)
                           if c.norm == "rms"
                           else LayerNorm(c.d_model, c.ln_eps, device))
        self.drop = Dropout(c.drop_rate)
        if not c.tie_embeddings:
            self.lm_head = Linear(c.d_model, c.vocab_size, use_bias=False,
                                  dtype=c.dtype, device=device)

    def _block_for(self, i: int) -> TransformerEncoderBlock:
        return getattr(self, f"layer_{i}")

    def init(self, generator: torch.Generator):
        """Fill every parameter from ``generator`` (the JAX distributions)."""
        self.embedding.init(generator)
        if self.config.positional == "learned":
            self.pos_embedding.init(generator)
        for i in range(self.config.num_layers):
            self._block_for(i).init(generator)
        self.final_norm.init(generator)
        if not self.config.tie_embeddings:
            self.lm_head.init(generator)
        return self

    def apply(self, tokens, training=False, rngs=None, return_hidden=False,
              logits_dtype=None, segment_ids=None, positions=None,
              caches=None, decode=False, collect_kv=False,
              logits_last_only=False, collect_aux=False):
        """Dense forward (JAX :221-333): token embedding (times
        sqrt(d_model) in its own dtype with ``embed_scale``) plus learned
        positions, cast to the compute dtype, dropout (salt 1000), the
        blocks (layer ``i`` with ``split_rngs(rngs, i)``), the final norm.
        ``segment_ids`` [b, s]: packed documents, masked from each other
        inside the flash kernels; ``positions`` ([s] or [b, s]) index the
        position table (or, under RoPE, rotate q and k) in place of
        ``arange(s)``, so that positions can restart at each document. In
        training, ``rngs={"dropout": g}`` with ``g`` a CPU generator (one
        seed drawn from it a call) or an integer seed. Returns the
        final-norm hidden states with ``return_hidden=True``, else the
        logits (``head``), fp32 unless ``logits_dtype`` says otherwise, and
        capped by ``final_logit_softcap``. ``decode=True`` runs the tokens
        through ``caches`` (one a layer, from ``init_cache``) at their
        write index, which also gives the learned positions, and returns
        ``(logits, caches)``; ``collect_kv=True`` returns ``(logits,
        [(k, v) a layer])``; else ``collect_aux=True`` returns ``(logits,
        aux)`` (or ``(hidden, aux)``), the sum of the MoE layers'
        load-balancing aux, fp32; ``logits_last_only=True`` computes the
        head on the last position only (JAX :222-333, the unscanned
        branch)."""
        c = self.config
        x = self.embedding(tokens)
        if c.embed_scale:
            x = x * torch.tensor(c.d_model ** 0.5, dtype=x.dtype)
        if c.positional == "learned":
            if positions is None and decode:
                # Past the table a position reads its last row, as JAX's
                # clamping gather does (a decode may outrun max_len).
                positions = cache_positions(
                    caches[0]["index"], tokens.shape[-1],
                    tokens.device).clamp(max=c.max_len - 1)
            if positions is None:
                if tokens.shape[-1] > c.max_len:
                    raise ValueError(f"{tokens.shape[-1]} tokens: the "
                                     f"position table holds max_len "
                                     f"{c.max_len}")
                positions = torch.arange(tokens.shape[-1],
                                         device=tokens.device)
            x = x + self.pos_embedding(positions)
        block_positions = positions if c.positional == "rope" else None
        rngs = resolve_rngs(rngs) if training else None
        x = self.drop(maybe_cast(x, c.dtype), training, rngs, salt=1000)
        extras = [] if decode or collect_kv else None
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device) \
            if collect_aux else None
        for i in range(c.num_layers):
            x = self._block_for(i)(x, training=training,
                                   rngs=split_rngs(rngs, i),
                                   segment_ids=segment_ids,
                                   positions=block_positions,
                                   cache=caches[i] if decode else None,
                                   decode=decode, collect_kv=collect_kv,
                                   collect_aux=collect_aux)
            if extras is not None:
                x, extra = x
                extras.append(extra)
            elif collect_aux:
                x, aux = x
                aux_total = aux_total + aux
        x = self.final_norm(x)
        if return_hidden:
            if aux_total is not None and extras is None:
                return x, aux_total
            return x
        if logits_last_only:
            x = x[..., -1:, :]
        logits = self.head(x).to(logits_dtype or torch.float32)
        if c.final_logit_softcap is not None:
            cap = torch.tensor(c.final_logit_softcap, dtype=logits.dtype)
            logits = cap * torch.tanh(logits / cap)
        if extras is not None:
            return logits, extras
        if aux_total is not None:
            return logits, aux_total
        return logits

    def head(self, x):
        """The LM head before the final softcap. Tied: its product
        accumulates in fp32 (JAX: preferred_element_type), here as the
        product of the exact fp32 copies of the compute-dtype operands;
        untied: ``lm_head``, a Linear in the compute dtype (JAX :311-323)."""
        if not self.config.tie_embeddings:
            return self.lm_head(x)
        table = maybe_cast(self.embedding.table, self.config.dtype)
        return torch.matmul(x.float(), table.float().t())

    def init_cache(self, batch, max_len=None, dtype=torch.float32):
        """One dense KV cache a layer (JAX :450), of ``max_len`` (default
        the config's) positions, on the model's device."""
        c = self.config
        max_len = max_len or c.max_len
        return [self._block_for(i).init_cache(batch, max_len, c.d_model,
                                              dtype)
                for i in range(c.num_layers)]

    @torch.no_grad()
    def generate(self, prompt_tokens, steps: int, generator=None,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None):
        """Autoregressive decode through dense KV caches (JAX :461-495):
        the prompt [b, plen] in one decode step (its head on the last
        position only), then ``steps - 1`` one-token steps; returns the
        ``steps`` new tokens [b, steps]. ``temperature=0`` (or no
        ``generator``) is greedy; otherwise each step draws from
        ``softmax(filter_logits(logits / temperature, top_k, top_p))`` with
        ``generator`` (a ``torch.Generator`` on the model's device: the same
        seed gives the same tokens; the bits are not JAX's). The caches are
        fp32, as JAX's: a bf16 model attends over them in fp32."""
        b, plen = prompt_tokens.shape
        caches = self.init_cache(b, plen + steps)
        logits, caches = self.apply(prompt_tokens, caches=caches,
                                    decode=True, logits_last_only=True)
        tok = self._sample(logits[:, -1], generator, temperature, 0, top_k,
                           top_p)
        out = [tok]
        for i in range(1, steps):
            logits, caches = self.apply(tok[:, None], caches=caches,
                                        decode=True)
            tok = self._sample(logits[:, -1], generator, temperature, i,
                               top_k, top_p)
            out.append(tok)
        return torch.stack(out, dim=1)

    @staticmethod
    def _sample(logits, generator, temperature, salt, top_k=None,
                top_p=None):
        """JAX :497: the argmax, or a draw from the filtered, tempered
        logits. ``salt`` (JAX folds it into the key) is unused: the port's
        generator advances from draw to draw."""
        del salt
        if temperature == 0.0 or generator is None:
            return torch.argmax(logits, dim=-1)
        lg = filter_logits(logits / temperature, top_k, top_p)
        return _rng.categorical(lg, generator)

    def loss(self, tokens, training=False, rngs=None, segment_ids=None,
             positions=None):
        """Mean next-token CE (JAX :381-448). Up to ``max_len`` tokens the
        model runs at full length: the targets are the tokens rolled by
        one, and ``valid`` masks the last position (whose rolled target is
        the first token). Longer, it runs on ``tokens[..., :-1]`` against
        ``tokens[..., 1:]``, ``segment_ids`` and ``positions`` cut with
        them. With ``segment_ids``, a position whose next token lies in
        another document is not a target either. An MoE model adds
        ``moe_aux_weight`` times the summed load-balancing aux; its
        backward raises (``nn.moe``). ``rngs`` as in ``apply``."""
        c = self.config
        if c.fused_loss and c.final_logit_softcap is not None:
            raise ValueError("fused_loss never materializes logits, so the "
                             "final logit softcap cannot be applied: "
                             "disable one (JAX :420-422)")
        valid = None
        if tokens.shape[-1] <= c.max_len:
            inputs, seg, pos = tokens, segment_ids, positions
            targets = torch.roll(tokens, -1, dims=-1)
            valid = torch.ones_like(tokens, dtype=torch.float32)
            valid[..., -1] = 0.0
        else:
            inputs, targets = tokens[..., :-1], tokens[..., 1:]
            seg = segment_ids[..., :-1] if segment_ids is not None else None
            pos = positions[..., :-1] if positions is not None else None
        if segment_ids is not None:
            same = (segment_ids[..., 1:] == segment_ids[..., :-1]).float()
            if valid is None:
                valid = same
            else:
                valid[..., :-1] *= same
        out = self.apply(inputs, training=training, rngs=rngs,
                         return_hidden=c.fused_loss, logits_dtype=c.dtype,
                         segment_ids=seg, positions=pos,
                         collect_aux=bool(c.moe_experts))
        if c.moe_experts:
            out, aux = out
        if c.fused_loss and c.tie_embeddings:
            loss = ops.fused_lm_head_loss(out, self.embedding.table, targets,
                                          valid=valid)
        elif c.fused_loss:
            loss = ops.fused_lm_head_loss(out, self.lm_head.w, targets,
                                          valid=valid, table_layout="dv")
        else:
            ce = ops.softmax_cross_entropy_with_integer_labels(out, targets)
            loss = (ce.mean() if valid is None else
                    (ce * valid).sum() / valid.sum().clamp(min=1.0))
        if c.moe_experts:     # the load-balancing aux (JAX :443-448)
            loss = loss + c.moe_aux_weight * aux
        return loss


def filter_logits(lg, top_k=None, top_p=None):
    """Top-k and/or nucleus (top-p) filtering (JAX :505-): logits outside
    the keep-set become -inf. ``softmax(filter_logits(logits / T))`` is the
    distribution ``GPT._sample`` draws from. Top-k keeps every logit at
    least the k-th largest (ties included); top-p keeps the smallest prefix
    of the sorted distribution whose mass reaches ``top_p`` (the top token
    always), cut at its smallest logit."""
    if top_k is not None:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, -torch.inf, lg)
    if top_p is not None:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lg, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < top_p
        cutoff = torch.where(keep_sorted, sorted_lg, torch.inf).amin(
            dim=-1, keepdim=True)
        lg = torch.where(lg < cutoff, -torch.inf, lg)
    return lg
