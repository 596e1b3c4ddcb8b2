"""MLA's training path and its dense-cache decode in the port against the
JAX package, on the CPU.

At the JAX MLA tests' tiny size (rank 16, q_rank 24 or None, nope 8, rope 4,
v 8, 4 heads, d_model 32, YaRN, an untied head): the absorbed decode
through the route the card takes (``ops.paged_attention``'s latent option
over the dense cache viewed as pages, K3's plain version here) against
JAX's ``_decode`` over a prompt step, single steps and the overflow past
the cache's end (JAX clamps the write but not the mask), at cache lengths
that no page size of 8..128 divides and that 8 and 16 do, with both q
paths, and from a cache laid out otherwise; ``GPT.loss`` with packed rows
(segment ids and positions) and every gradient; three steps of the
training entry point's recipe (``train_gpt.train``) against JAX's
``make_train_step``: each loss and every parameter after them; and
``GPT.generate`` past and within its cache. The weights come from the
port's ``init``; the JAX side runs under ``jax.jit``. fp32 at rtol 1e-5 /
atol 2e-5 (BASELINE.md:16), gradients at atol 5e-5 (the flash tests').
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu import training as jtraining
from np_modeling_tpu.nn.mla import MLAttention as JMLA
from np_modeling_tpu.training import data as jdata
from np_modeling_tpu.training import schedules as jschedules
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import ops, train_gpt
from np_modeling_tpu_torch.nn import MLAttention
from np_modeling_tpu_torch.nn import mla as tmla
from np_modeling_tpu_torch.utils import params_to_numpy, tree_to_numpy

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-5, atol=5e-5)
DIMS = dict(kv_lora_rank=16, q_lora_rank=24, qk_nope_head_dim=8,
            qk_rope_head_dim=4, v_head_dim=8)
YARN = ("yarn", 4.0, 32.0, 1.0, 16.0, 1.0)
GPT_CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2,
               hidden_units=48, max_len=32, positional="rope", norm="rms",
               ffn="swiglu", use_bias=False, tie_embeddings=False,
               ln_eps=1e-6, rope_scaling=YARN, mla=dict(**DIMS))
V = GPT_CFG["vocab_size"]
rng = np.random.default_rng(19)


def _tree(module):
    return jax.tree_util.tree_map(jnp.asarray, params_to_numpy(module))


def _close(got, want, tol=TOL):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **tol),
        got, want)


def _layer(q_lora_rank, seed):
    mla = MLAttention(32, 4, **{**DIMS, "q_lora_rank": q_lora_rank},
                      rope_scaling=YARN, device="cpu").init(
        torch.Generator().manual_seed(seed))
    jmla = JMLA(num_heads=4, **{**DIMS, "q_lora_rank": q_lora_rank},
                rope_scaling=YARN)
    return mla, jmla, _tree(mla)


@pytest.fixture
def latent_calls(monkeypatch):
    """Counts the calls of ops.paged_attention with one array as k and v
    (the latent option) and of ops.flash_attention in a test."""
    calls = {"latent": 0, "flash": 0}
    paged, flash = ops.paged_attention, ops.flash_attention

    def counted_paged(q, k_pages, v_pages, *args, **kw):
        calls["latent"] += k_pages is v_pages
        return paged(q, k_pages, v_pages, *args, **kw)

    def counted_flash(*args, **kw):
        calls["flash"] += 1
        return flash(*args, **kw)

    monkeypatch.setattr(ops, "paged_attention", counted_paged)
    monkeypatch.setattr(ops, "flash_attention", counted_flash)
    return calls


# (cache length, steps as (lo, hi) slices of the tokens): a prompt step,
# single steps, a step of 5 that runs past the end (row 0 sees a prefix of
# the cache, rows 1..4 all of it) and single steps past the end.
DECODE_CASES = {
    "len13": (13, ((0, 5), (5, 6), (6, 11), (11, 16), (16, 17), (17, 18))),
    "len12": (12, ((0, 7), (7, 8), (8, 9), (9, 12), (12, 13))),
    "len16": (16, ((0, 9), (9, 10), (10, 16), (16, 17))),
    "len100": (100, ((0, 30), (30, 31), (31, 32))),
}


@pytest.mark.parametrize("q_lora_rank", [24, None], ids=["q_lora", "wq"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_absorbed_decode_through_the_latent_pages_vs_jax(case, q_lora_rank,
                                                         latent_calls):
    """Each step's output and the whole cache equal JAX's; every step runs
    one latent paged call and no flash call; the cache stays the padded
    buffer init_cache made (no copy a step) and views as pages."""
    max_len, steps = DECODE_CASES[case]
    mla, jmla, params = _layer(q_lora_rank, seed=max_len)
    b = 2
    x = rng.standard_normal((b, steps[-1][1], 32)).astype(np.float32)
    step = jax.jit(lambda p, t, c: jmla.apply(p, t, cache=c, decode=True))
    jcache = jmla.init_cache(b, max_len, 32)
    cache = mla.init_cache(b, max_len, 32)
    assert cache["k"].shape == (b, 1, max_len, 20)
    pages, table = tmla.latent_pages(cache["k"])
    assert pages.shape[2] in (8, 16, 32, 64, 128) and table.shape[0] == b
    ptr = cache["k"].data_ptr()
    with torch.no_grad():
        for n, (lo, hi) in enumerate(steps, 1):
            want, jcache = step(params, jnp.asarray(x[:, lo:hi]), jcache)
            got, cache = mla(torch.tensor(x[:, lo:hi]), cache=cache,
                             decode=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(cache["k"].numpy(),
                                       np.asarray(jcache["k"]), **TOL)
            assert cache["index"] == int(jcache["index"]) == hi
            assert cache["k"].data_ptr() == ptr
            assert latent_calls == {"latent": n, "flash": 0}


def test_absorbed_decode_from_a_cache_laid_out_otherwise_vs_jax():
    """A contiguous cache of 13 rows a sequence (no padding to view as
    pages) moves into a padded one on the first step, which the step
    returns; outputs and cache equal JAX's."""
    mla, jmla, params = _layer(None, seed=7)
    x = rng.standard_normal((3, 8, 32)).astype(np.float32)
    step = jax.jit(lambda p, t, c: jmla.apply(p, t, cache=c, decode=True))
    jcache = jmla.init_cache(3, 13, 32)
    cache = {"k": torch.zeros(3, 1, 13, 20), "index": 0}
    assert tmla.latent_pages(cache["k"]) is None
    with torch.no_grad():
        for lo, hi in ((0, 6), (6, 7), (7, 8)):
            want, jcache = step(params, jnp.asarray(x[:, lo:hi]), jcache)
            got, cache = mla(torch.tensor(x[:, lo:hi]), cache=cache,
                             decode=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(cache["k"].numpy(),
                                       np.asarray(jcache["k"]), **TOL)
            assert tmla.latent_pages(cache["k"]) is not None


@pytest.mark.parametrize("b,max_len,rows,page", [
    (1, 13, 16, 16), (3, 13, 16, 16), (2, 12, 16, 16), (2, 24, 24, 8),
    (2, 100, 104, 8), (4, 2048, 2048, 128), (1, 4112, 4112, 16)])
def test_latent_pages_view_the_cache(b, max_len, rows, page):
    """The padded rows and the page size (the largest power of two up to
    128 dividing them); the pages share the cache's storage and sequence
    i's rows are its table's pages in order."""
    k = tmla._latent_cache(b, max_len, 20, torch.float32, "cpu")
    k.copy_(torch.tensor(rng.standard_normal(k.shape), dtype=torch.float32))
    pages, table = tmla.latent_pages(k)
    assert pages.shape == (1, b * rows // page, page, 20)
    assert pages.data_ptr() == k.data_ptr()
    assert table.dtype == torch.int32 and table.shape == (b, rows // page)
    seq = pages[0, table.long()].reshape(b, rows, 20)[:, :max_len]
    assert torch.equal(seq, k[:, 0])


# ---- the GPT --------------------------------------------------------------------

def _gpt(seed, cfg=GPT_CFG):
    tgpt = tmodels.GPT(tmodels.GPTConfig(**cfg), device="cpu").init(
        torch.Generator().manual_seed(seed))
    return jmodels.GPT(jmodels.GPTConfig(**cfg)), tgpt


def _packed(b, s, mean_len=6):
    """Rows of documents back to back: tokens, segment ids and positions
    restarting at 0 in each document."""
    tokens = rng.integers(0, V, (b, s)).astype(np.int32)
    seg = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    for r in range(b):
        start = doc = 0
        while start < s:
            n = min(int(rng.integers(1, 2 * mean_len)), s - start)
            seg[r, start:start + n] = doc
            pos[r, start:start + n] = np.arange(n)
            start, doc = start + n, doc + 1
    return tokens, seg, pos


@pytest.mark.parametrize("q_lora_rank", [24, None], ids=["q_lora", "wq"])
def test_gpt_loss_packed_rows_and_every_gradient_vs_jax(q_lora_rank):
    """GPT.loss over packed rows (segment ids through MLAttention's flash
    call, positions through its RoPE): the loss and every gradient."""
    cfg = {**GPT_CFG, "mla": {**DIMS, "q_lora_rank": q_lora_rank}}
    jgpt, tgpt = _gpt(11, cfg)
    tokens, seg, pos = _packed(3, 32)
    loss = jax.jit(jax.value_and_grad(
        lambda p, t, s, q: jgpt.loss(p, t, segment_ids=s, positions=q)))
    want, jgrads = loss(_tree(tgpt), *map(jnp.asarray, (tokens, seg, pos)))
    got = tgpt.loss(torch.tensor(tokens), segment_ids=torch.tensor(seg),
                    positions=torch.tensor(pos))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    grads = tree_to_numpy({n: p.grad for n, p in tgpt.named_parameters()})
    assert "lm_head" in grads and jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(jgrads)
    _close(grads, jgrads, GRAD_TOL)


def test_train_gpt_recipe_three_steps_vs_jax():
    """The training slice as a whole: three steps of the entry point's
    recipe (``train_gpt.train``: data.epochs batches of 2 x 32 tokens,
    make_train_step over GPT.loss(training=True), chain(clip_by_global_norm
    (1.0), adamw(warmup_cosine(3e-4, 10, 3)))) on an MLA GPT against JAX's
    make_train_step over its GPT.loss with the same chain, on the same
    weights and corpus: each step's loss and every parameter after the
    third."""
    jgpt, tgpt = _gpt(12)
    params = _tree(tgpt)
    corpus = rng.integers(0, V, (8, 32))
    steps = 3
    jopt = jtraining.chain(jtraining.clip_by_global_norm(1.0),
                           jtraining.adamw(jschedules.warmup_cosine(
                               3e-4, warmup_steps=10, total_steps=steps)))
    jstep = jtraining.make_train_step(jgpt.loss, lambda loss, _: loss, jopt,
                                      donate=False)
    jstate, jl = jopt.init(params), []
    for (batch,), _ in zip(jdata.epochs([corpus], 2, num_epochs=100),
                           range(steps)):
        params, jstate, loss = jstep(params, jstate, jnp.asarray(batch), None,
                                     jax.random.PRNGKey(1))
        jl.append(float(loss))
    # After JAX's steps: the port updates its weights in place, and JAX's
    # first params may share their memory.
    losses, _ = train_gpt.train(tgpt, corpus, steps, batch=2, device="cpu",
                                log=None)
    np.testing.assert_allclose(losses.numpy(), jl, **TOL)
    _close(params_to_numpy(tgpt), params)


@pytest.mark.parametrize("plen,steps", [(5, 4), (9, 23)],
                         ids=["short", "to_max_len"])
def test_generate_vs_jax(plen, steps, latent_calls):
    """Greedy GPT.generate through the latent caches (cache length plen +
    steps, 9 + 23 = 32 = max_len: no page size divides 5 + 4 = 9), token for
    token; one latent paged call a layer a step and no flash call."""
    jgpt, tgpt = _gpt(13)
    prompt = rng.integers(0, V, (2, plen))
    gen = jax.jit(lambda p, t: jgpt.generate(p, t, steps=steps))
    want = np.asarray(gen(_tree(tgpt), jnp.asarray(prompt)))
    got = tgpt.generate(torch.tensor(prompt), steps=steps).numpy()
    np.testing.assert_array_equal(got, want)
    assert latent_calls == {"latent": GPT_CFG["num_layers"] * steps,
                            "flash": 0}
