"""Sampling parameters and logits processors for serving.

Counterpart of np_modeling_tpu/serving/sampling.py (:38-212). The
decode-time controls beside ``temperature`` / ``top_k`` / ``top_p``:
``repetition_penalty`` (HF: the logit of every token seen, prompt or
generated, divided by the penalty when positive, multiplied when not),
``presence_penalty`` / ``frequency_penalty`` (OpenAI: subtract ``p *
[count > 0] + f * count`` over generated tokens), ``min_p`` (keep tokens
whose probability after temperature is at least ``min_p`` times the top
token's), ``logit_bias`` (token id -> additive bias) and
``banned_tokens`` (-inf). Each is a [..., vocab] -> [..., vocab] torch
transform, so the engine runs it on the device inside its step; the
per-slot statistics (int32 counts of generated tokens, a bool prompt
membership) are device tables of the engine's state.

Everything before the draw equals JAX's function on the same inputs. The
draw itself (``rng.categorical``) takes torch's random bits from a
``torch.Generator``: the same seed draws the same tokens in the port, and
other tokens than ``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from np_modeling_tpu_torch.rng import categorical


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """An engine's (or a request's) decode-time sampling configuration.

    ``temperature=0`` is greedy: the argmax of the processed logits (the
    penalties and bias still apply)."""

    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    logit_bias: Optional[dict] = None
    banned_tokens: Optional[tuple] = None

    @property
    def needs_token_stats(self) -> bool:
        """True when sampling reads per-sequence token statistics."""
        return (self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)


def static_bias(params: SamplingParams, vocab_size: int, device=None):
    """``logit_bias`` and ``banned_tokens`` as one fp32 [vocab] additive
    vector (banned: -inf), or None without either."""
    if not params.logit_bias and not params.banned_tokens:
        return None
    bias = torch.zeros((vocab_size,), dtype=torch.float32, device=device)
    if params.logit_bias:
        ids = sorted(params.logit_bias)
        bias.index_add_(0, torch.tensor(ids, device=device),
                        torch.tensor([float(params.logit_bias[int(i)])
                                      for i in ids], dtype=torch.float32,
                                     device=device))
    if params.banned_tokens:
        bias[torch.tensor(params.banned_tokens, device=device)] = -torch.inf
    return bias


def process_logits(logits, params: SamplingParams, counts=None,
                   prompt_mask=None, bias=None):
    """Penalties and bias on raw logits [..., vocab], in fp32. ``counts``
    int [..., vocab]: generated-token counts; ``prompt_mask`` bool [...,
    vocab]: prompt membership; ``bias``: ``static_bias``'s vector."""
    lg = logits.float()
    if bias is not None:
        lg = lg + bias
    if params.repetition_penalty != 1.0:
        if counts is None or prompt_mask is None:
            raise ValueError("repetition_penalty needs counts and "
                             "prompt_mask")
        seen = prompt_mask | (counts > 0)
        g = torch.tensor(params.repetition_penalty, dtype=torch.float32)
        lg = torch.where(seen, torch.where(lg > 0, lg / g, lg * g), lg)
    if params.presence_penalty != 0.0:
        lg = lg - params.presence_penalty * (counts > 0)
    if params.frequency_penalty != 0.0:
        lg = lg - params.frequency_penalty * counts.float()
    return lg


def min_p_filter(lg, min_p: float):
    """-inf below ``min_p`` times the top token's probability: on logits, a
    cut at ``max + log(min_p)``."""
    cutoff = lg.amax(dim=-1, keepdim=True) + torch.log(
        torch.tensor(min_p, dtype=torch.float32))
    return torch.where(lg < cutoff, -torch.inf, lg)


def sample(logits, generator, params: SamplingParams, counts=None,
           prompt_mask=None, bias=None):
    """Penalties -> temperature -> top-k / top-p / min-p -> a draw from
    ``generator``. Greedy (``temperature=0`` or no generator) still applies
    the processors. int32 token ids [...]."""
    from np_modeling_tpu_torch.models.transformer_lm import filter_logits
    lg = process_logits(logits, params, counts, prompt_mask, bias)
    if params.temperature == 0.0 or generator is None:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    lg = filter_logits(lg / params.temperature, params.top_k, params.top_p)
    if params.min_p is not None:
        lg = min_p_filter(lg, params.min_p)   # after temperature (HF order)
    return categorical(lg, generator).to(torch.int32)


def token_histogram(tokens, vocab_size: int, device=None):
    """int tokens [n] -> int32 counts [vocab]."""
    t = torch.as_tensor(np.asarray(tokens), device=device).long()
    return torch.zeros((vocab_size,), dtype=torch.int32,
                       device=device).index_add_(
        0, t, torch.ones(t.shape, dtype=torch.int32, device=device))


# ---- per-request sampling -------------------------------------------------
#
# The engine's per-request mode keeps one [S, 7] fp32 table in its state, a
# row a slot, columns PARAM_COLS, so each live sequence decodes with its own
# controls in one step; logit_bias / banned_tokens go to a [S, vocab] table.

PARAM_COLS = ("temperature", "top_k", "top_p", "min_p",
              "repetition_penalty", "presence_penalty", "frequency_penalty")
# The value of each column that turns its control off (such a row is greedy).
_OFF = {"temperature": 0.0, "top_k": 0.0, "top_p": 1.0, "min_p": 0.0,
        "repetition_penalty": 1.0, "presence_penalty": 0.0,
        "frequency_penalty": 0.0}


def params_row(sp: Optional[SamplingParams]):
    """One SamplingParams as a length-7 fp32 numpy row (None = greedy)."""
    if sp is None:
        return np.asarray([_OFF[c] for c in PARAM_COLS], np.float32)
    vals = [sp.temperature, sp.top_k, sp.top_p, sp.min_p,
            sp.repetition_penalty, sp.presence_penalty, sp.frequency_penalty]
    return np.asarray([_OFF[c] if v is None else float(v)
                       for c, v in zip(PARAM_COLS, vals)], np.float32)


def sample_batch(logits, generator, table, counts=None, prompt_mask=None,
                 bias=None):
    """The processors and the draw row by row: logits [S, V], ``table`` [S,
    7] (``PARAM_COLS``), optional counts / prompt_mask / bias [S, V]. A row
    with temperature 0 takes the processed argmax; the others draw from
    their own temperature / top-k / top-p / min-p distribution (top-k
    applied before the nucleus, as ``filter_logits`` does)."""
    lg = logits.float()
    V = lg.shape[-1]
    if bias is not None:
        lg = lg + bias
    rep = table[:, 4:5]
    if counts is not None:
        seen = prompt_mask | (counts > 0)
        pen = torch.where(lg > 0, lg / rep, lg * rep)
        lg = torch.where(seen & (rep != 1.0), pen, lg)
        lg = lg - table[:, 5:6] * (counts > 0)
        lg = lg - table[:, 6:7] * counts.float()
    greedy_tok = torch.argmax(lg, dim=-1).to(torch.int32)
    if generator is None:
        return greedy_tok

    t = table[:, 0:1]
    lgt = lg / torch.where(t > 0, t, 1.0)
    srt = torch.sort(lgt, dim=-1, descending=True).values
    k = torch.where(table[:, 1] > 0, table[:, 1], float(V)).long()
    kth = torch.gather(srt, 1, (k - 1).clamp(0, V - 1)[:, None])
    keep = lgt >= kth
    srt = torch.where(torch.arange(V, device=lg.device)[None, :] < k[:, None],
                      srt, -torch.inf)
    probs = torch.softmax(srt, dim=-1)
    nucleus = torch.cumsum(probs, dim=-1) - probs < table[:, 2:3]
    cutoff_p = torch.where(nucleus, srt, torch.inf).amin(dim=-1, keepdim=True)
    keep &= lgt >= cutoff_p
    cutoff_m = lgt.amax(dim=-1, keepdim=True) + torch.log(table[:, 3:4])
    keep &= lgt >= cutoff_m
    lgt = torch.where(keep, lgt, -torch.inf)
    drawn = categorical(lgt, generator).to(torch.int32)
    return torch.where(table[:, 0] == 0.0, greedy_tok, drawn)
