"""Speculative decoding: a small draft model proposes, the target verifies.

Counterpart of np_modeling_tpu/models/speculative.py (Leviathan et al. 2023
/ Chen et al. 2023):

- the draft autoregressively proposes ``gamma`` tokens,
- the target scores all ``gamma + 1`` positions in one forward,
- greedy mode accepts the longest prefix whose tokens match the target's
  argmax: the output equals the target's own greedy decode, token for token;
- sampling mode accepts draft token ``d`` with probability
  ``min(1, p_t(d) / p_d(d))`` and resamples a reject from
  ``norm(max(0, p_t - p_d))``, so that the output distribution is the
  target's.

KV-cache rollback: both models keep dense caches (``GPT.init_cache``) with
per-row ``[b]`` write indices; a rejected suffix is dropped by moving a
row's index back: k/v past the index are masked from every query and
overwritten by later writes (nn/attention.py ``_update_cache``). Under
``scan_layers`` the port's stacked cache keeps one index that every layer
shares (JAX stacks ``[L]`` of them; ROADMAP.md Queue 3), so ``_reset_index``
and ``_per_row_index`` set that one. Draws come from a ``torch.Generator``
on the models' device (``rng.categorical`` and ``torch.rand``): the same
seed draws the same tokens, not JAX's. The rounds are a Python loop that
reads the rows' counts back once a round.
"""

from __future__ import annotations

import torch

from np_modeling_tpu_torch.models.transformer_lm import filter_logits
from np_modeling_tpu_torch.rng import categorical


def speculative_accept(p_t, p_d, drafts, generator):
    """Batched accept/resample core of speculative sampling (JAX :34-62).

    ``p_t [..., gamma+1, V]``: target probabilities (position i predicts the
    token after input i); ``p_d [..., gamma, V]``: the draft's, position i
    the distribution ``drafts[..., i]`` was drawn from; ``drafts [...,
    gamma]``. Returns ``(n_acc [...], nxt [...])``, int32: the accepted
    prefix length and the token that follows it (the residual's draw at the
    first reject, ``p_t[..., -1, :]``'s after a full acceptance)."""
    gamma = drafts.shape[-1]
    idx = drafts.long()[..., None]
    pt_d = torch.gather(p_t[..., :gamma, :], -1, idx)[..., 0]
    pd_d = torch.gather(p_d, -1, idx)[..., 0]
    u = torch.rand(drafts.shape, generator=generator, device=p_t.device)
    ok = u < torch.clamp(pt_d / pd_d.clamp_min(1e-20), max=1.0)
    n_acc = torch.cumprod(ok.to(torch.int32), dim=-1).sum(dim=-1)
    j = n_acc.clamp(max=gamma - 1).long()[..., None, None]
    pt_j = torch.gather(p_t, -2, j.expand(*j.shape[:-1], p_t.shape[-1]))
    pd_j = torch.gather(p_d, -2, j.expand(*j.shape[:-1], p_d.shape[-1]))
    resid = (pt_j[..., 0, :] - pd_j[..., 0, :]).clamp_min(0.0)
    resid = resid / resid.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    dist = torch.where((n_acc < gamma)[..., None], resid, p_t[..., -1, :])
    nxt = categorical(torch.log(dist + 1e-30), generator)
    return n_acc.to(torch.int32), nxt.to(torch.int32)


def accept_greedy(logits, drafts):
    """(n_acc, nxt) of a greedy verify: the longest prefix of ``drafts``
    [..., gamma] that equals the target's argmax of ``logits`` [..., gamma
    + 1, V], and the argmax after it (in ``drafts``' dtype)."""
    t_hat = torch.argmax(logits, dim=-1).to(drafts.dtype)
    ok = (drafts == t_hat[..., :-1]).to(torch.int32)
    n_acc = torch.cumprod(ok, dim=-1).sum(dim=-1)
    return n_acc, torch.gather(t_hat, -1, n_acc[..., None].long())[..., 0]


def speculative_accept_logits(t_logits, d_logits, drafts, generator,
                              temperature, top_k=None, top_p=None):
    """``speculative_accept`` on raw logits: both sides go through the same
    temperature and ``filter_logits`` (``GPT._sample``'s distribution),
    which keeps filtered speculative sampling exact in distribution."""
    p_t = torch.softmax(filter_logits(t_logits.float() / temperature, top_k,
                                      top_p), dim=-1)
    p_d = torch.softmax(filter_logits(d_logits.float() / temperature, top_k,
                                      top_p), dim=-1)
    return speculative_accept(p_t, p_d, drafts, generator)


def _reset_index(model, caches, new_index):
    """The caches with their write positions set to ``new_index`` ([b]):
    every layer's of the list layout, or the one shared index of a
    ``scan_layers`` model's stacked cache."""
    if model.config.scan_layers:
        return dict(caches, index=new_index)
    return [dict(c, index=new_index) for c in caches]


def _per_row_index(model, caches, batch, device):
    """The caches' shared write position as per-row ``[b]`` indices (rows
    then commit different lengths a round)."""
    index = torch.full((batch,), int(_cache_index(model, caches)),
                       dtype=torch.long, device=device)
    return _reset_index(model, caches, index)


def _cache_index(model, caches):
    """Current write positions of a GPT's caches (either layout)."""
    if model.config.scan_layers:
        return caches["index"]
    return caches[0]["index"]


@torch.no_grad()
def speculative_generate(target, draft, prompt_tokens, steps: int,
                         gamma: int = 4, generator=None,
                         temperature: float = 0.0, top_k=None, top_p=None,
                         return_stats: bool = False):
    """Decode ``steps`` tokens from ``target`` with ``draft`` proposals (JAX
    :103-222). The two GPTs share a vocab and hold their own weights.
    ``temperature=0`` or no ``generator`` is greedy (the target's greedy
    ``generate`` token for token, every row); otherwise speculative
    sampling from ``generator`` (on the models' device). Rows accept
    different draft lengths a round, tracked with per-row cache indices;
    a row that reaches ``steps`` idles until the slowest row finishes.
    Returns ``[b, steps]`` tokens, and with ``return_stats`` also the
    accepted drafts and the rounds, summed."""
    b, plen = prompt_tokens.shape
    greedy = temperature == 0.0 or generator is None
    max_len = plen + steps + gamma + 1
    t_caches = target.init_cache(b, max_len)
    d_caches = draft.init_cache(b, max_len)

    # Before each round both caches hold exactly the tokens before cur for
    # every row (after the prefill: the prompt).
    t_logits, t_caches = target.apply(prompt_tokens, caches=t_caches,
                                      decode=True, logits_last_only=True)
    _, d_caches = draft.apply(prompt_tokens, caches=d_caches, decode=True,
                              logits_last_only=True)
    dev = prompt_tokens.device
    t_caches = _per_row_index(target, t_caches, b, dev)
    d_caches = _per_row_index(draft, d_caches, b, dev)

    def sample(logits):
        if greedy:
            return torch.argmax(logits, dim=-1)
        return categorical(filter_logits(logits / temperature, top_k, top_p),
                           generator)

    cur = sample(t_logits[:, -1])
    # gamma + 1 slack: the last round's fixed-width write stays in bounds.
    out = torch.zeros((b, steps + gamma + 1), dtype=torch.long, device=dev)
    n = torch.zeros((b,), dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    cols = torch.arange(gamma + 1, device=dev)
    acc_total, rounds = torch.zeros((), dtype=torch.long, device=dev), 0
    while int(n.min()) < steps:
        done = n >= steps
        # The draft proposes gamma tokens.
        tok, drafts, d_logits = cur, [], []
        for _ in range(gamma):
            lg, d_caches = draft.apply(tok[:, None], caches=d_caches,
                                       decode=True)
            tok = sample(lg[:, -1])
            drafts.append(tok)
            d_logits.append(lg[:, -1])
        drafts = torch.stack(drafts, dim=1)                 # [b, gamma]
        # The last proposal's k/v too: a fully accepted round leaves the
        # draft cache complete.
        _, d_caches = draft.apply(drafts[:, -1:], caches=d_caches,
                                  decode=True)
        # The target verifies all gamma + 1 positions in one pass.
        block = torch.cat([cur[:, None], drafts], dim=1)    # [b, gamma+1]
        t_logits, t_caches = target.apply(block, caches=t_caches,
                                          decode=True)
        if greedy:
            n_acc, nxt = accept_greedy(t_logits, drafts)
        else:
            n_acc, nxt = speculative_accept_logits(
                t_logits, torch.stack(d_logits, dim=1), drafts, generator,
                temperature, top_k, top_p)
            n_acc, nxt = n_acc.long(), nxt.long()
        # Commit: each live row writes its block at its own offset; the
        # rejected suffix rolls back by the caches' indices.
        live = (~done)[:, None].expand(b, gamma + 1)
        pos = (n[:, None] + cols)
        out[rows.expand_as(pos)[live], pos[live]] = block[live]
        produced = torch.where(done, 0, n_acc.long() + 1)
        base_t = _cache_index(target, t_caches) - (gamma + 1)
        base_d = _cache_index(draft, d_caches) - (gamma + 1)
        t_caches = _reset_index(target, t_caches, base_t + produced)
        d_caches = _reset_index(draft, d_caches, base_d + produced)
        cur = torch.where(done, cur, nxt.long())
        acc_total += torch.where(done, 0, n_acc.long()).sum()
        rounds += 1
        n = n + produced
    tokens = out[:, :steps]
    if return_stats:
        return tokens, (int(acc_total), rounds)
    return tokens
