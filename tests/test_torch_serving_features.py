"""The port's serving features against the JAX package's, on the CPU.

The sampling processors (``filter_logits``, ``process_logits``,
``min_p_filter``, ``static_bias``, ``token_histogram``, ``params_row``, and
the greedy rows of ``sample`` / ``sample_batch``) bit for bit on seeded
inputs; the draws, which take torch's random bits and not JAX's, within
the keep-set and within a seeded chi-square bound of
``softmax(filter_logits(logits / T))``; and the engine's contracts of
tests/test_engine.py, test_sampling.py and test_prefix_cache.py mirrored
against the JAX engine on the same weights: dense prefill, fork, the
prefix cache with its stats, window reclamation with fork, and greedy
penalties (engine-wide and per request) token for token, free pages
included; int8 KV pages (``quantize_kv=True``) under dense prefill, fork
and the prefix cache. fp32, a 2-layer GPT of width 64 and vocabulary 128; the JAX side
runs under ``jax.jit`` (its engine jits its own steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu.models.transformer_lm import filter_logits as jfilter
from np_modeling_tpu.serving import GenerationEngine as JaxEngine
from np_modeling_tpu.serving import SamplingParams as JaxParams
from np_modeling_tpu.serving import sampling as jsampling
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import serve_gpt
from np_modeling_tpu_torch.models.transformer_lm import filter_logits
from np_modeling_tpu_torch.serving import GenerationEngine, SamplingParams
from np_modeling_tpu_torch.serving import sampling
from np_modeling_tpu_torch.utils import params_to_numpy

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

V = 128
CFG = dict(vocab_size=V, d_model=64, num_heads=4, num_kv_heads=2,
           num_layers=2, hidden_units=128, max_len=96, activation="gelu",
           ln_eps=1e-5)
rng = np.random.default_rng(0)


def _logits(*shape, scale=3.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---- the processors, bit for bit -------------------------------------------

@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.8), (20, 0.9),
                                         (1, 0.5), (None, None)])
def test_filter_logits_bit_equal(top_k, top_p):
    lg = _logits(6, V)
    want = np.asarray(jax.jit(lambda x: jfilter(x, top_k, top_p))(lg))
    got = filter_logits(torch.from_numpy(lg), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)


_PARAMS = [dict(repetition_penalty=1.7),
           dict(presence_penalty=0.4, frequency_penalty=0.3),
           dict(repetition_penalty=0.8, frequency_penalty=1.5,
                logit_bias={3: 2.5, 9: -1.0}, banned_tokens=(4, 7)),
           dict(logit_bias={0: 1e4})]


@pytest.mark.parametrize("kw", _PARAMS)
def test_processors_bit_equal(kw):
    """process_logits (with static_bias), min_p_filter, the greedy
    ``sample`` and ``sample_batch`` rows, params_row: equal to JAX's."""
    lg = _logits(4, V)
    counts = rng.integers(0, 3, (4, V)).astype(np.int32)
    pmask = rng.random((4, V)) < 0.2
    jp, tp = JaxParams(**kw), SamplingParams(**kw)
    jb = jsampling.static_bias(jp, V)
    tb = sampling.static_bias(tp, V)
    if jb is None:
        assert tb is None
    else:
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    args = (counts, pmask)
    want = jsampling.process_logits(jnp.asarray(lg), jp,
                                    *map(jnp.asarray, args), jb)
    got = sampling.process_logits(torch.from_numpy(lg), tp,
                                  *map(torch.from_numpy, args), tb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        sampling.min_p_filter(got, 0.1).numpy(),
        np.asarray(jsampling.min_p_filter(want, 0.1)))
    np.testing.assert_array_equal(
        sampling.sample(torch.from_numpy(lg), None, tp,
                        *map(torch.from_numpy, args), tb).numpy(),
        np.asarray(jsampling.sample(jnp.asarray(lg), None, jp,
                                    *map(jnp.asarray, args), jb)))
    row = sampling.params_row(tp)
    np.testing.assert_array_equal(row, jsampling.params_row(jp))
    table = np.tile(row[None], (4, 1))
    bias = np.zeros((4, V), np.float32) if tb is None else \
        np.tile(tb.numpy()[None], (4, 1))
    want_b = jsampling.sample_batch(jnp.asarray(lg), jax.random.PRNGKey(0),
                                    jnp.asarray(table),
                                    *map(jnp.asarray, args),
                                    jnp.asarray(bias))
    got_b = sampling.sample_batch(torch.from_numpy(lg),
                                  torch.Generator().manual_seed(0),
                                  torch.from_numpy(table),
                                  *map(torch.from_numpy, args),
                                  torch.from_numpy(bias))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


def test_token_histogram_and_default_row_bit_equal():
    toks = rng.integers(0, V, 50)
    np.testing.assert_array_equal(
        sampling.token_histogram(toks, V).numpy(),
        np.asarray(jsampling.token_histogram(toks, V)))
    np.testing.assert_array_equal(sampling.params_row(None),
                                  jsampling.params_row(None))
    assert sampling.PARAM_COLS == jsampling.PARAM_COLS


# ---- the draws ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(temperature=0.8, top_k=12),
                                dict(temperature=1.3, top_p=0.7),
                                dict(temperature=0.9, top_k=20, top_p=0.9,
                                     min_p=0.05)])
def test_draws_in_keep_set_and_chi_square(kw):
    """20,000 draws of one row (seeded generator): every token inside the
    keep-set of ``filter_logits`` (and min_p), and the frequencies within
    a chi-square bound of the filtered softmax (the 0.999 quantile, cells
    of expected count < 5 pooled); ``sample_batch`` with the same row
    likewise. The same seed repeats the draws."""
    from scipy.stats import chi2
    lg = _logits(1, V, scale=2.0)
    sp = SamplingParams(**kw)
    n = 20000
    rows = torch.from_numpy(np.repeat(lg, n, axis=0))
    lf = filter_logits(torch.from_numpy(lg) / sp.temperature, sp.top_k,
                       sp.top_p)
    if sp.min_p is not None:
        lf = sampling.min_p_filter(lf, sp.min_p)
    probs = torch.softmax(lf, dim=-1)[0].double().numpy()
    table = torch.from_numpy(np.tile(sampling.params_row(sp)[None], (n, 1)))
    for draw in (lambda g: sampling.sample(rows, g, sp),
                 lambda g: sampling.sample_batch(rows, g, table)):
        toks = draw(torch.Generator().manual_seed(5)).numpy()
        assert np.array_equal(toks, draw(torch.Generator().manual_seed(5))
                              .numpy())
        assert (probs[toks] > 0).all()
        obs = np.bincount(toks, minlength=V).astype(np.float64)
        exp = probs * n
        big = exp >= 5
        o = np.append(obs[big], obs[~big].sum())
        e = np.append(exp[big], exp[~big].sum())
        keep = e > 0
        stat = ((o[keep] - e[keep]) ** 2 / e[keep]).sum()
        assert stat < chi2.ppf(0.999, keep.sum() - 1), stat


# ---- the engine against JAX's ---------------------------------------------

def _weights(cfg=CFG, seed=0):
    """The JAX GPT, its params and the port's GPT on the same seeded weights,
    from the port's init (JAX's distributions; a JAX init compiles)."""
    tgpt = tmodels.GPT(tmodels.GPTConfig(**cfg), device="cpu").init(
        torch.Generator().manual_seed(seed))
    params = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tgpt))
    return jmodels.GPT(jmodels.GPTConfig(**cfg)), params, tgpt


def _engines(weights, sp=None, **kw):
    """A JAX engine and a port engine on the same weights and options
    (``sp``: SamplingParams keywords for ``sampling=``)."""
    jgpt, params, tgpt = weights
    base = dict(total_pages=64, page_size=4, max_seqs=4)
    base.update(kw)
    jkw, tkw = dict(base), dict(base)
    if sp is not None:
        jkw["sampling"], tkw["sampling"] = JaxParams(**sp), SamplingParams(**sp)
    return JaxEngine(jgpt, params, **jkw), GenerationEngine(tgpt, **tkw)


@pytest.fixture(scope="module")
def weights():
    return _weights()


def test_dense_prefill_vs_jax(weights):
    """prefill_chunk_size=None: the first tokens, steps and free pages of a
    batch of prompts equal JAX's dense prefill, and equal the chunked
    engine's tokens (paged decode token-exact against dense prefill)."""
    jeng, teng = _engines(weights, prefill_chunk_size=None)
    _, chunked = _engines(weights, prefill_chunk_size=8)
    prompts = {i: rng.integers(0, V, n) for i, n in enumerate((13, 5, 21))}
    want = jeng.add_requests({i: jnp.asarray(p) for i, p in prompts.items()})
    assert teng.add_requests(prompts) == want == chunked.add_requests(prompts)
    assert teng.free_pages == jeng.free_pages
    want = jeng.step_many(6)
    assert teng.step_many(6) == want == chunked.step_many(6)
    teng.finish(1)
    jeng.finish(1)
    assert teng.step() == jeng.step()
    assert teng.free_pages == jeng.free_pages


def test_fork_vs_jax(weights):
    """fork shares full pages and copies the tail page: greedy twins equal
    the parent and JAX's, and every page comes home after finish."""
    jeng, teng = _engines(weights)
    free0 = teng.free_pages
    prompt = rng.integers(0, V, 22)
    assert teng.add_request(0, prompt) == jeng.add_request(
        0, jnp.asarray(prompt))
    teng.step()
    jeng.step()
    for child in (1, 2):
        teng.fork(0, child)
        jeng.fork(0, child)
        assert teng.free_pages == jeng.free_pages
    got, want = teng.step_many(9), jeng.step_many(9)
    assert got == want and got[0] == got[1] == got[2]
    for sid in (0, 2, 1):
        teng.finish(sid)
        jeng.finish(sid)
        assert teng.free_pages == jeng.free_pages
    assert teng.free_pages == free0


def test_prefix_cache_vs_jax(weights):
    """Requests sharing a prefix, one at a time and batched, with finishes
    between: tokens equal JAX's and the cache-off engine's, and
    prefix_cache_stats and free pages equal JAX's at every turn (LRU
    eviction under a short free list included)."""
    jeng, teng = _engines(weights, total_pages=24, prefill_chunk_size=4,
                          enable_prefix_cache=True)
    _, off = _engines(weights, total_pages=24, prefill_chunk_size=4)
    shared = rng.integers(0, V, 12)
    prompts = [np.concatenate([shared[:n], rng.integers(0, V, m)])
               for n, m in ((12, 5), (8, 7), (12, 1), (0, 9))]
    for i, p in enumerate(prompts):
        got = [teng.add_request(i, p)] + teng.step_many(3)[i]
        want = [jeng.add_request(i, jnp.asarray(p))] + jeng.step_many(3)[i]
        ref = [off.add_request(i, p)] + off.step_many(3)[i]
        assert got == want == ref
        assert teng.prefix_cache_stats == jeng.prefix_cache_stats
        assert teng.free_pages == jeng.free_pages
        for e in (teng, jeng, off):
            e.finish(i)
    batch = {10 + i: p for i, p in enumerate(prompts[:3])}
    got = teng.add_requests(batch)
    assert got == jeng.add_requests({k: jnp.asarray(v)
                                     for k, v in batch.items()})
    assert teng.step_many(2) == jeng.step_many(2)
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats
    assert teng.prefix_cache_stats["hit_tokens"] > 0
    assert teng.free_pages == jeng.free_pages


# ---- int8 KV pages (quantize_kv=True) under the serving features ------------

def test_quantized_kv_dense_prefill_vs_jax(weights):
    """quantize_kv=True with dense prefill: first tokens, steps and free
    pages equal JAX's (the int8 pages and their scales scattered from the
    collected k/v)."""
    jeng, teng = _engines(weights, prefill_chunk_size=None, quantize_kv=True)
    prompts = {i: rng.integers(0, V, n) for i, n in enumerate((13, 5, 21))}
    want = jeng.add_requests({i: jnp.asarray(p) for i, p in prompts.items()})
    assert teng.add_requests(prompts) == want
    assert teng.step_many(6) == jeng.step_many(6)
    assert teng.free_pages == jeng.free_pages


def test_quantized_kv_fork_vs_jax(weights):
    """quantize_kv=True with fork: the child copies the tail page's int8
    rows and scales; greedy twins equal the parent and JAX's."""
    jeng, teng = _engines(weights, quantize_kv=True)
    free0 = teng.free_pages
    prompt = rng.integers(0, V, 22)
    assert teng.add_request(0, prompt) == jeng.add_request(
        0, jnp.asarray(prompt))
    teng.fork(0, 1)
    jeng.fork(0, 1)
    got, want = teng.step_many(8), jeng.step_many(8)
    assert got == want and got[0] == got[1]
    for sid in (0, 1):
        teng.finish(sid)
        jeng.finish(sid)
    assert teng.free_pages == jeng.free_pages == free0


def test_quantized_kv_prefix_cache_vs_jax(weights):
    """quantize_kv=True with the prefix cache: shared int8 pages, tokens,
    stats and free pages equal JAX's."""
    jeng, teng = _engines(weights, total_pages=24, prefill_chunk_size=4,
                          enable_prefix_cache=True, quantize_kv=True)
    shared = rng.integers(0, V, 12)
    prompts = [np.concatenate([shared[:n], rng.integers(0, V, m)])
               for n, m in ((12, 5), (8, 7), (12, 1))]
    for i, p in enumerate(prompts):
        got = [teng.add_request(i, p)] + teng.step_many(3)[i]
        want = [jeng.add_request(i, jnp.asarray(p))] + jeng.step_many(3)[i]
        assert got == want
        assert teng.prefix_cache_stats == jeng.prefix_cache_stats
        assert teng.free_pages == jeng.free_pages
        teng.finish(i)
        jeng.finish(i)
    assert teng.prefix_cache_stats["hit_tokens"] > 0


def test_window_reclamation_with_fork_vs_jax():
    """test_engine.py's TestWindowReclamation mirrored: a window-8 model
    forked at 20 tokens decodes 30 greedy twins; pages expire behind the
    window, shared ones are freed by their last owner, and all come home
    after finish; tokens and free pages equal JAX's at every step."""
    cfg = dict(CFG, num_layers=1, max_len=256, attention_window=8)
    jeng, teng = _engines(_weights(cfg, seed=1), page_size=8)
    free0 = teng.free_pages
    prompt = rng.integers(0, V, 20)
    t = teng.add_request(0, prompt)
    assert t == jeng.add_request(0, jnp.asarray(prompt))
    teng.fork(0, 1)
    jeng.fork(0, 1)
    peak = 0
    for _ in range(30):
        got = teng.step()
        assert got == jeng.step() and got[0] == got[1]
        assert teng.free_pages == jeng.free_pages
        peak = max(peak, free0 - teng.free_pages)
    assert peak <= 7        # 50 tokens each, twice, would need 14 pages
    teng.finish(0)
    teng.finish(1)
    assert teng.free_pages == free0


@pytest.mark.parametrize("chunk", [4, None], ids=["chunked", "dense"])
def test_engine_greedy_penalties_vs_jax(weights, chunk):
    """An engine-wide SamplingParams with every greedy processor: tokens
    equal JAX's, prefill and steps."""
    sp = dict(repetition_penalty=1.8, presence_penalty=0.3,
              frequency_penalty=0.2, logit_bias={5: 1.5}, banned_tokens=(2,))
    jeng, teng = _engines(weights, sp, prefill_chunk_size=chunk)
    # The lengths of test_dense_prefill_vs_jax's prompts: JAX's dense
    # prefill runs GPT.apply eagerly, compiling each op once a length.
    prompts = {0: rng.integers(0, V, 13), 1: rng.integers(0, V, 5)}
    assert teng.add_requests(prompts) == jeng.add_requests(
        {k: jnp.asarray(v) for k, v in prompts.items()})
    assert teng.step_many(8) == jeng.step_many(8)
    assert teng.step() == jeng.step()


def test_per_request_greedy_penalties_vs_jax(weights):
    """per_request_sampling: two greedy slots with their own penalties, one
    with the engine default, and a fork of a penalized slot (which
    inherits its rows and counts): token for token against JAX, and the
    same tokens on a second port engine."""
    sps = {0: dict(repetition_penalty=2.0),
           1: dict(frequency_penalty=1.0, logit_bias={3: 4.0})}
    prompts = {i: rng.integers(0, V, n) for i, n in enumerate((7, 5, 9))}
    jeng, _ = _engines(weights, per_request_sampling=True)
    want = [jeng.add_requests(
        {k: jnp.asarray(v) for k, v in prompts.items()},
        sampling={k: JaxParams(**v) for k, v in sps.items()})]
    jeng.fork(0, 3)
    want.append(jeng.step_many(6))
    for _ in range(2):
        _, teng = _engines(weights, per_request_sampling=True)
        got = [teng.add_requests(
            prompts, sampling={k: SamplingParams(**v)
                               for k, v in sps.items()})]
        teng.fork(0, 3)
        got.append(teng.step_many(6))
        assert got == want and got[1][0] == got[1][3]


def test_sampled_engine_repeats_with_its_seed(weights):
    """temperature 0.8 / top-k 50 / top-p 0.95 on the engine: the same seed
    draws the same tokens, another seed other ones, and a per-request
    engine whose rows all carry those knobs runs too."""
    _, _, tgpt = weights
    prompts = {0: rng.integers(0, V, 9), 1: rng.integers(0, V, 14)}

    def run(seed, **kw):
        eng = GenerationEngine(tgpt, total_pages=64, page_size=4,
                               max_seqs=4, seed=seed, **kw)
        first = eng.add_requests(prompts)
        return first, eng.step_many(12)

    kw = dict(temperature=0.8, top_k=50, top_p=0.95)
    assert run(3, **kw) == run(3, **kw) != run(4, **kw)
    sp = SamplingParams(**kw)
    assert run(3, sampling=sp) == run(3, sampling=sp)


def test_engine_option_errors():
    tgpt = tmodels.GPT(tmodels.GPTConfig(**dict(CFG, num_layers=1)),
                       device="cpu").init(torch.Generator())
    eng = GenerationEngine(tgpt, total_pages=16, page_size=4)
    with pytest.raises(ValueError, match="per_request_sampling"):
        eng.add_request(0, [1, 2], sampling=SamplingParams(min_p=0.1))
    with pytest.raises(ValueError, match="prefix cache"):
        GenerationEngine(tgpt, prefill_chunk_size=None,
                         enable_prefix_cache=True)
    with pytest.raises(ValueError, match="draft_gpt"):
        eng.step_speculative()
    sampled = GenerationEngine(tgpt, total_pages=16, page_size=4,
                               temperature=0.8)
    with pytest.raises(ValueError, match="greedy"):
        sampled.step_lookup()


def test_serve_gpt_main_on_the_cpu():
    """The serving example's flow up to its speculative section: joins and
    leaves, every page home after them, three greedy fork twins."""
    lines = []
    out = serve_gpt.main(["--device", "cpu"], log=lines.append)
    assert [len(t) for t in out["outputs"].values()] == [9, 9]
    assert out["free_pages"] == 255        # 256 less the trash page
    a, b, c = out["forked"].values()
    assert a == b == c and len(a) == 7
    assert any(x.startswith("forked continuations") for x in lines)
