"""Beam-search decoding over the KV-cache decode path.

Counterpart of np_modeling_tpu/models/beam.py. The beam dimension is folded
into the batch (``[b * beam]`` rows decode in one step), beams are
reordered by gathering cache rows along the batch axis, and the search runs
a fixed number of steps (JAX's ``lax.scan`` as a loop). With ``eos_id``,
finished hypotheses may only extend with EOS at zero cost; ``alpha > 0``
ranks by the GNMT length penalty ``((5 + len) / 6) ** alpha``. The top-k
takes the lower index among equal scores, as XLA's ``top_k`` does.

The port's models hold their parameters, so the searches take no
``params``: ``beam_search(model, prompt, ...)`` needs ``model.init_cache(b,
max_len)`` and ``model.apply(tokens, caches=, decode=True,
logits_last_only=)``, as ``GPT`` has them; ``encdec_beam_search`` wraps an
encoder-decoder's ``decode_step(tokens, dec_caches, aux)``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tile_cache(caches, beam, batch_axis=0):
    """Every cache tensor beam-tiled along the batch axis (row r becomes
    rows r * beam .. r * beam + beam - 1); leaves with no batch axis (a
    Python int or 0-d index) are left alone."""
    return _tree_map(
        lambda a: (a.repeat_interleave(beam, dim=batch_axis)
                   if torch.is_tensor(a) and a.dim() > batch_axis else a),
        caches)


def _gather_cache(caches, rows, batch_axis=0):
    """Cache rows reordered by global row indices (beam reassignment). A
    top-level ``"aux"`` key is gather-exempt: encoder-decoder adapters keep
    beam-invariant conditioning there (encoder memory, source segment ids),
    identical across a batch row's beams, which a gather would only copy."""
    if isinstance(caches, dict) and "aux" in caches:
        out = _gather_cache({k: v for k, v in caches.items() if k != "aux"},
                            rows, batch_axis)
        out["aux"] = caches["aux"]
        return out
    return _tree_map(
        lambda a: (a.index_select(batch_axis, rows)
                   if torch.is_tensor(a) and a.dim() > batch_axis else a),
        caches)


def _top_k(x, k):
    """The k largest of the last axis, best first, the lower index first
    among equal values (a stable descending sort)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search(model, prompt_tokens, steps: int, beam_size: int,
                eos_id: int | None = None, alpha: float = 0.0):
    """High-likelihood continuations of ``prompt_tokens`` [b, plen]:
    ``(tokens [b, beam, steps], scores [b, beam])`` best-first. Scores are
    total log-probabilities; with ``alpha > 0`` the ranking (not the
    search) divides by the length penalty of each hypothesis'
    EOS-terminated length."""
    b, plen = prompt_tokens.shape
    beam = beam_size
    caches = model.init_cache(b, plen + steps)
    logits, caches = model.apply(prompt_tokens, caches=caches, decode=True,
                                 logits_last_only=True)
    logp = torch.log_softmax(logits[:, -1].float(), dim=-1)     # [b, V]
    vocab = logp.shape[-1]
    dev = logp.device

    # First expansion: the top beam distinct first tokens of each row; with
    # beam > vocab, dead hypotheses at NEG_INF fill the rest.
    k0 = min(beam, vocab)
    scores, first = _top_k(logp, k0)
    if k0 < beam:
        pad = beam - k0
        scores = torch.cat([scores, torch.full((b, pad), NEG_INF,
                                               device=dev)], dim=1)
        first = torch.cat([first, torch.zeros((b, pad), dtype=first.dtype,
                                              device=dev)], dim=1)
    caches = _tile_cache(caches, beam)

    seqs = torch.zeros((b, beam, steps), dtype=torch.long, device=dev)
    seqs[:, :, 0] = first
    finished = (first == eos_id) if eos_id is not None else torch.zeros(
        (b, beam), dtype=torch.bool, device=dev)
    lengths = torch.where(finished, 1, steps)
    batch_base = torch.arange(b, device=dev)[:, None] * beam       # [b, 1]
    if eos_id is not None:
        frozen = torch.full((vocab,), NEG_INF, device=dev)
        frozen[eos_id] = 0.0

    for t in range(1, steps):
        last = seqs[:, :, t - 1]
        logits, new_caches = model.apply(last.reshape(b * beam, 1),
                                         caches=caches, decode=True)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(
            b, beam, vocab)
        if eos_id is not None:
            # Finished beams: only EOS continues, at no cost.
            logp = torch.where(finished[:, :, None], frozen, logp)
        total = scores[:, :, None] + logp                     # [b, beam, V]
        scores, idx = _top_k(total.reshape(b, beam * vocab), beam)
        parent, token = idx // vocab, idx % vocab
        rows = (batch_base + parent).reshape(-1)              # [b * beam]
        caches = _gather_cache(new_caches, rows)
        seqs = torch.take_along_dim(seqs, parent[:, :, None], dim=1)
        seqs[:, :, t] = token
        finished = torch.take_along_dim(finished, parent, dim=1)
        lengths = torch.take_along_dim(lengths, parent, dim=1)
        if eos_id is not None:
            just_done = ~finished & (token == eos_id)
            lengths = torch.where(just_done, t + 1, lengths)
            finished = finished | just_done

    ranking = scores
    if alpha > 0.0:
        ranking = scores / (((5.0 + lengths.float()) / 6.0) ** alpha)
    order = torch.sort(-ranking, dim=1, stable=True).indices
    seqs = torch.take_along_dim(seqs, order[:, :, None], dim=1)
    scores = torch.take_along_dim(scores, order, dim=1)
    return seqs, scores


def encdec_beam_search(init_dec_cache, decode_step, batch, bos_token: int,
                       steps: int, beam_size: int, memory, kv_seg=None,
                       eos_id=None, alpha: float = 0.0):
    """Beam search for encoder-decoder models (T5, Seq2SeqTransformer):
    ``beam_search`` with the encoder ``memory`` (and the source segment ids
    ``kv_seg``) under the gather-exempt ``"aux"`` cache key, so every
    hypothesis stays paired with its batch row's conditioning.
    ``init_dec_cache(b, max_len)``: the decoder's self-attention caches;
    ``decode_step(tokens, dec_caches, aux) -> (logits, dec_caches)`` runs
    the decoder stack on a chunk (aux = {"mem", optional "kv_seg"}).
    Returns ``(tokens [b, beam, steps], scores [b, beam])`` best-first."""

    class _DecoderLM:
        def init_cache(self, b, max_len):
            aux = {"mem": memory}
            if kv_seg is not None:
                aux["kv_seg"] = kv_seg
            return {"dec": init_dec_cache(b, max_len), "aux": aux}

        def apply(self, tokens, caches=None, decode=True,
                  logits_last_only=False):
            del decode
            logits, dec = decode_step(tokens, caches["dec"], caches["aux"])
            if logits_last_only:
                logits = logits[:, -1:]
            return logits, {"dec": dec, "aux": caches["aux"]}

    prompt = torch.full((batch, 1), bos_token, dtype=torch.long,
                        device=memory.device)
    return beam_search(_DecoderLM(), prompt, steps, beam_size, eos_id=eos_id,
                       alpha=alpha)
