"""Speculative and prompt-lookup decoding of the PyTorch port against the JAX
package, on the CPU.

The JAX engine tests' tiny GPTs (tests/test_engine_speculative.py,
tests/test_lookup_decode.py) with the port's seeded weights carried to both
packages: ``speculative_generate`` over dense caches, the engine's greedy
``step_speculative`` / ``step_speculative_many`` / ``step_lookup``, token
for token JAX's and the plain ``step()``'s; a self-draft accepting every
proposal; ``step()`` between rounds; both lanes' pages coming home; the
sampled accept/reject rule's first token against the top-k-filtered target
distribution by a chi-square test; and the serving example at its head dim
16 with its speculative section. fp32 throughout; JAX runs compiled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from np_modeling_tpu import models as jmodels
from np_modeling_tpu.models.speculative import \
    speculative_generate as jax_speculative_generate
from np_modeling_tpu.serving import GenerationEngine as JaxEngine
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import serve_gpt
from np_modeling_tpu_torch.models.speculative import (
    speculative_accept_logits, speculative_generate)
from np_modeling_tpu_torch.models.transformer_lm import filter_logits
from np_modeling_tpu_torch.serving import GenerationEngine
from np_modeling_tpu_torch.utils import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

V = 64
TARGET = dict(vocab_size=V, d_model=32, num_heads=4, num_kv_heads=2,
              num_layers=2, hidden_units=64, max_len=96)
DRAFT = dict(vocab_size=V, d_model=16, num_heads=2, num_layers=1,
             hidden_units=32, max_len=96)
ENGINE = dict(total_pages=64, page_size=8)


def _pair(cfg, seed):
    """(JAX GPT, its params, the port's GPT) holding the port's seeded
    weights."""
    tree = params_to_numpy(tmodels.GPT(tmodels.GPTConfig(**cfg),
                                       device="cpu").init(
        torch.Generator().manual_seed(seed)))
    return (jmodels.GPT(jmodels.GPTConfig(**cfg)),
            jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, tmodels.GPTConfig(**cfg), device="cpu"))


@pytest.fixture(scope="module")
def stack():
    return _pair(TARGET, 0), _pair(DRAFT, 9)


def _plain_stream(tgpt, prompt, n):
    eng = GenerationEngine(tgpt, **ENGINE)
    return [eng.add_request(0, prompt)] + eng.step_many(n - 1)[0]


def test_speculative_generate_vs_jax(stack):
    (jgpt, jparams, tgpt), (jdraft, jdparams, tdraft) = stack
    prompt = np.random.default_rng(1).integers(0, V, (2, 7))
    want, (j_acc, j_rounds) = jax.jit(
        lambda p, dp, x: jax_speculative_generate(
            jgpt, p, jdraft, dp, x, 12, gamma=3, return_stats=True))(
        jparams, jdparams, jnp.asarray(prompt))
    got, (acc, rounds) = speculative_generate(
        tgpt, tdraft, torch.tensor(prompt), 12, gamma=3, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (acc, rounds) == (int(j_acc), int(j_rounds))
    np.testing.assert_array_equal(
        got.numpy(), tgpt.generate(torch.tensor(prompt), 12).numpy())
    # A self-draft accepts every proposal: ceil(12 / 4) rounds.
    _, (acc, rounds) = speculative_generate(
        tgpt, tgpt, torch.tensor(prompt), 12, gamma=3, return_stats=True)
    assert rounds == 3 and acc == 2 * 3 * 3


def test_engine_speculative_vs_jax_and_step(stack):
    """Two sequences, one joining mid-stream, through step_speculative and
    step_speculative_many on both engines: the same ragged tokens, and each
    stream the plain engine's greedy one."""
    (jgpt, jparams, tgpt), (jdraft, jdparams, tdraft) = stack
    rng = np.random.default_rng(2)
    p1, p2 = rng.integers(0, V, 9), rng.integers(0, V, 5)
    jeng = JaxEngine(jgpt, jparams, max_seqs=4, draft_gpt=jdraft,
                     draft_params=jdparams, **ENGINE)
    teng = GenerationEngine(tgpt, max_seqs=4, draft_gpt=tdraft, **ENGINE)
    got = {0: [teng.add_request(0, p1)]}
    assert got[0][0] == jeng.add_request(0, jnp.asarray(p1))
    out = teng.step_speculative(2)
    assert out == jeng.step_speculative(2)
    got[0] += out[0]
    got[1] = [teng.add_request(1, p2)]
    assert got[1][0] == jeng.add_request(1, jnp.asarray(p2))
    for _ in range(3):
        out = teng.step_speculative(3)
        assert out == jeng.step_speculative(3)
        for sid in (0, 1):
            got[sid] += out[sid]
    out = teng.step_speculative_many(2, gamma=3)
    assert out == jeng.step_speculative_many(2, gamma=3)
    for sid, p in ((0, p1), (1, p2)):
        got[sid] += out[sid]
        assert got[sid] == _plain_stream(tgpt, p, len(got[sid])), sid
    assert teng.free_pages == jeng.free_pages
    assert len(teng._lane_list[1].free) == len(jeng._dfree)


def test_partial_accepts_roll_back_both_lanes(stack):
    """The target verifying its own copy under seeded weight noise: rounds
    accept part of a block, so both lanes roll back mid-block; the ragged
    tokens equal JAX's engine's over the same draft, and each stream the
    plain engine's greedy one."""
    (jgpt, jparams, tgpt), _ = stack
    gen = torch.Generator().manual_seed(11)
    noisy = jax.tree_util.tree_map(
        lambda w: (w + 0.1 * w.std() * torch.randn(
            w.shape, generator=gen, dtype=torch.float64).numpy()).astype(
                w.dtype), params_to_numpy(tgpt))
    tdraft = params_from_numpy(noisy, tgpt.config, device="cpu")
    jdparams = jax.tree_util.tree_map(jnp.asarray, noisy)
    rng = np.random.default_rng(12)
    prompts = {sid: rng.integers(0, V, n) for sid, n in enumerate((9, 5, 13))}
    jeng = JaxEngine(jgpt, jparams, max_seqs=4, draft_gpt=jgpt,
                     draft_params=jdparams, **ENGINE)
    teng = GenerationEngine(tgpt, max_seqs=4, draft_gpt=tdraft, **ENGINE)
    got = {}
    for sid, p in prompts.items():
        got[sid] = [teng.add_request(sid, p)]
        assert got[sid][0] == jeng.add_request(sid, jnp.asarray(p))
    accepted = set()
    for _ in range(5):
        out = teng.step_speculative(4)
        assert out == jeng.step_speculative(4)
        for sid, toks in out.items():
            accepted.add(len(toks) - 1)
            got[sid] += toks
    assert accepted & {1, 2, 3}, accepted
    for sid, p in prompts.items():
        assert got[sid] == _plain_stream(tgpt, p, len(got[sid])), sid


def test_self_draft_accepts_everything(stack):
    (_, _, tgpt), _ = stack
    prompt = np.random.default_rng(3).integers(0, V, 6)
    spec = GenerationEngine(tgpt, draft_gpt=tgpt, **ENGINE)
    first = spec.add_request(0, prompt)
    out = spec.step_speculative(gamma=4)[0]
    assert len(out) == 5
    assert [first] + out == _plain_stream(tgpt, prompt, 6)
    out = spec.step_speculative_many(3, gamma=4)[0]
    assert len(out) == 15


def test_mixing_plain_and_speculative_steps_stays_exact(stack):
    (_, _, tgpt), (_, _, tdraft) = stack
    prompt = np.random.default_rng(4).integers(0, V, 7)
    spec = GenerationEngine(tgpt, draft_gpt=tdraft, **ENGINE)
    got = [spec.add_request(0, prompt)]
    got += spec.step_speculative(2)[0]
    got.append(spec.step()[0])                   # a plain step between
    got += spec.step_many(2)[0]
    while len(got) < 20:
        got += spec.step_speculative(3)[0]
    assert got == _plain_stream(tgpt, prompt, len(got))


def test_finish_reclaims_both_lanes(stack):
    (_, _, tgpt), (_, _, tdraft) = stack
    spec = GenerationEngine(tgpt, draft_gpt=tdraft, draft_total_pages=40,
                            **ENGINE)
    draft_lane = spec._lane_list[1]
    f0, d0 = spec.free_pages, len(draft_lane.free)
    assert d0 == 40 - 1
    spec.add_request(0, np.random.default_rng(5).integers(0, V, 9))
    spec.fork(0, 1)
    spec.step_speculative(3)
    assert spec.free_pages < f0 and len(draft_lane.free) < d0
    for sid in (0, 1):
        spec.finish(sid)
    assert spec.free_pages == f0 and len(draft_lane.free) == d0


def test_lookup_vs_jax_and_step(stack):
    """step_lookup's rounds equal JAX's, and the stream the plain engine's;
    a repeating greedy stream accepts more than one token in some round."""
    (jgpt, jparams, tgpt), _ = stack
    rng = np.random.default_rng(6)
    prompts = {0: rng.integers(0, V, 7), 1: rng.integers(0, V, 12)}
    jeng = JaxEngine(jgpt, jparams, max_seqs=4, **ENGINE)
    teng = GenerationEngine(tgpt, max_seqs=4, **ENGINE)
    first = teng.add_requests(prompts)
    assert first == jeng.add_requests(
        {k: jnp.asarray(v) for k, v in prompts.items()})
    got = {sid: [t] for sid, t in first.items()}
    longest = 1
    while min(len(g) for g in got.values()) < 24:
        out = teng.step_lookup(gamma=4, ngram=3)
        assert out == jeng.step_lookup(gamma=4, ngram=3)
        for sid, toks in out.items():
            got[sid] += toks
            longest = max(longest, len(toks))
    assert longest > 1
    for sid, p in prompts.items():
        assert got[sid] == _plain_stream(tgpt, p, len(got[sid])), sid


def test_sampled_acceptance_matches_filtered_target():
    """Speculative sampling's first emitted token (the draft's when it is
    accepted, else the residual's draw) is distributed as the top-k-filtered
    target distribution: a chi-square test over 40,000 rows (p > 1e-3) on
    one fixed generator seed. The draft's distribution differs from the
    target's and gives mass outside the target's top k."""
    vocab, gamma, n, top_k, temp = 12, 3, 40_000, 6, 0.8
    g = torch.Generator().manual_seed(0)
    t_logits = torch.randn((gamma + 1, vocab), generator=g) * 2.0
    d_logits = torch.randn((gamma, vocab), generator=g) * 2.0
    p_d = torch.softmax(filter_logits(d_logits / temp, top_k), dim=-1)
    drafts = torch.multinomial(p_d, n, replacement=True, generator=g).t()
    n_acc, nxt = speculative_accept_logits(
        t_logits.expand(n, -1, -1), d_logits.expand(n, -1, -1), drafts, g,
        temp, top_k)
    first = torch.where(n_acc > 0, drafts[:, 0], nxt)
    p_t = torch.softmax(filter_logits(t_logits[0] / temp, top_k), dim=-1)
    counts = torch.bincount(first.long(), minlength=vocab).numpy()
    support = p_t.numpy() > 0
    assert counts[~support].sum() == 0
    assert 0 < int((n_acc > 0).sum()) < n       # both branches ran
    want = p_t.double().numpy()[support]
    _, p = stats.chisquare(counts[support], n * want / want.sum())
    assert p > 1e-3, p


def test_sampled_engine_speculative_runs(stack):
    """A sampling engine (temperature 0.8, top-k 50) with a draft: every
    round commits 1..gamma + 1 tokens of the vocabulary; one seed twice
    gives the same tokens."""
    (_, _, tgpt), (_, _, tdraft) = stack
    prompts = {0: np.arange(5), 1: np.arange(9) % 7}

    def run():
        eng = GenerationEngine(tgpt, draft_gpt=tdraft, temperature=0.8,
                               top_k=50, seed=3, **ENGINE)
        first = eng.add_requests(prompts)
        rounds = [eng.step_speculative(3) for _ in range(4)]
        return first, rounds

    first, rounds = run()
    assert (first, rounds) == run()
    for out in rounds:
        for toks in out.values():
            assert 1 <= len(toks) <= 4
            assert all(0 <= t < V for t in toks)


def test_serve_gpt_example_at_head_dim_16(monkeypatch):
    """The serving example whole on the CPU: the JAX example's model (heads
    of 16, pages 64 wide) and its closing speculative section, 3 rounds of
    gamma 4 giving 3..15 tokens."""
    from np_modeling_tpu_torch.serving import engine as engine_mod
    dims, inner = set(), engine_mod.ops.paged_attention

    def recording(q, k_pages, *args, **kw):
        dims.add((q.shape[-1], k_pages.shape[-1]))
        return inner(q, k_pages, *args, **kw)

    monkeypatch.setattr(engine_mod.ops, "paged_attention", recording)
    lines = []
    out = serve_gpt.main(["--device", "cpu"], log=lines.append)
    assert dims == {(16, 64)}
    assert 3 <= len(out["speculative"]) <= 15
    assert all(0 <= t < 512 for t in out["speculative"])
    assert any(x.startswith("speculative decode") for x in lines)
