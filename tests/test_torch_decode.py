"""Dense KV-cache decode of the PyTorch port against the JAX package's.

On the CPU: the mask path of ``flash_attention`` (what K1's mask option
computes on the card) against JAX's ``flash_attention`` on its jnp path and,
at sq 128, the Pallas kernel in interpret mode; ``MultiHeadAttention``'s
cache with a scalar and a per-row index; ``GPT.apply`` with caches,
``collect_kv`` and ``logits_last_only``; ``GPT.generate`` token-exact for a
GPT-2-style and a Gemma-2-style config (RoPE, alternating window, both
softcaps, GQA, sandwich norms); and the training entry point's closing
sample. Inputs and weights are seeded numpy arrays fed to both (the GPTs'
from the port's init, carried across by ``utils.params_from_numpy``); the
JAX side runs under ``jax.jit``. fp32 at
rtol 1e-5 / atol 2e-5 (the JAX package's kernel tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu import nn as jnn
from np_modeling_tpu import ops as jops
from np_modeling_tpu.ops import dispatch as jdispatch
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import nn as tnn
from np_modeling_tpu_torch import ops, train_gpt
from np_modeling_tpu_torch.utils import params_from_numpy, params_to_numpy

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)

GPT2 = dict(vocab_size=128, d_model=64, num_heads=4, num_layers=2,
            hidden_units=128, max_len=64, activation="gelu", ln_eps=1e-5)
GEMMA2 = dict(GPT2, num_kv_heads=2, positional="rope", norm="rms",
              rms_offset=True, ffn="geglu", attention_window=8,
              window_pattern=2, attn_logit_softcap=20.0,
              final_logit_softcap=30.0, sandwich_norm=True, embed_scale=True,
              query_pre_attn_scalar=16.0, use_bias=False)


def _pair(cfg, seed=0):
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg))
    tree = params_to_numpy(tmodels.GPT(tmodels.GPTConfig(**cfg),
                                       device="cpu").init(
        torch.Generator().manual_seed(seed)))
    tgpt = params_from_numpy(tree, tmodels.GPTConfig(**cfg), device="cpu")
    return jgpt, jax.tree_util.tree_map(jnp.asarray, tree), tgpt


def _mask_case(rng, b, hq, hkv, sq, skv, d, per_row, keyless=True):
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    v = v + 2.0          # a row with no key takes the mean of v, ~2
    mask = rng.random((b if per_row else 1, 1, sq, skv)) < 0.7
    if keyless:
        mask[0, 0, sq // 2] = False              # a row with no key
    return q, k, v, mask


@pytest.mark.parametrize("opts", [{}, dict(softcap=5.0),
                                  dict(causal=True, window=40)],
                         ids=["plain", "softcap", "causal-window"])
@pytest.mark.parametrize("per_row", [False, True], ids=["1-1-s-L", "b-1-s-L"])
@pytest.mark.parametrize("sq,skv,hkv", [(1, 37, 2), (1, 300, 1), (5, 70, 2),
                                        (33, 131, 1)])
def test_mask_path_vs_jax(sq, skv, hkv, per_row, opts):
    """The plain mask path (K1's twin) against JAX's jnp path: o at fp32
    rtol 1e-5 / atol 2e-5, GQA 4/2 and 4/1, a broadcast [1, 1, s, L] and a
    per-row [b, 1, s, L] mask with one row left without a key (its o the
    mean of v over all keys, under causal + window too)."""
    rng = np.random.default_rng(sq * 1000 + skv)
    q, k, v, mask = _mask_case(rng, 2, 4, hkv, sq, skv, 64, per_row)
    want = jax.jit(lambda q, k, v, m: jops.flash_attention(
        q, k, v, mask=m, **opts))(q, k, v, mask)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              mask=torch.from_numpy(mask), **opts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    keyless = got[0, :, sq // 2].numpy()
    np.testing.assert_allclose(
        keyless, np.repeat(v[0].mean(axis=1), 4 // hkv, axis=0), **TOL)


@pytest.mark.parametrize("opts", [dict(causal=True, window=40),
                                  dict(softcap=5.0)], ids=["window", "cap"])
def test_mask_path_vs_jax_pallas_interpret(opts):
    """At sq 128 JAX runs its Pallas kernel with the mask tile (interpret
    mode, as the JAX package's own tests do): the plain path agrees. Every
    row keeps a key: the Pallas kernel averages a keyless row over the
    columns its band visits (ROADMAP Queue 3, P6), the port over all keys,
    as JAX's jnp path does (held above)."""
    rng = np.random.default_rng(7)
    q, k, v, mask = _mask_case(rng, 1, 4, 2, 128, 160, 64, True,
                               keyless=False)
    mask[..., np.arange(128), np.arange(128)] = True    # the diagonal
    with jdispatch.force_pallas(True, interpret=True):
        want = jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                    mask=jnp.asarray(mask), **opts)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              mask=torch.from_numpy(mask), **opts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _mha_pair(window, rope, seed=0):
    kw = dict(num_heads=4, num_kv_heads=2, causal=True, window=window,
              rope=rope)
    jm = jnn.MultiHeadAttention(**kw)
    x0 = jnp.zeros((2, 3, 32), jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), x0)
    tm = tnn.MultiHeadAttention(32, **kw, device="cpu")
    with torch.no_grad():
        for name, val in params.items():
            getattr(tm, name).copy_(torch.from_numpy(np.asarray(val)))
    return jm, params, tm


@pytest.mark.parametrize("window,rope", [(None, False), (3, True)],
                         ids=["dense", "rope-window"])
@pytest.mark.parametrize("index", ["scalar", "per_row"])
def test_mha_decode_vs_jax(index, window, rope):
    """Three decode calls (a 4-token prefill, then one token twice) through
    a 12-slot cache: outputs and the cache's k/v equal JAX's; the per-row
    index starts the two rows at 0 and 3."""
    jm, params, tm = _mha_pair(window, rope)
    rng = np.random.default_rng(1)
    jc = jm.init_cache(2, 12, 32)
    tc = tm.init_cache(2, 12, 32)
    if index == "per_row":
        jc["index"] = jnp.asarray([0, 3], jnp.int32)
        tc["index"] = torch.tensor([0, 3])
    step = jax.jit(lambda p, x, c: jm.apply(p, x, cache=c, decode=True))
    for s in (4, 1, 1):
        x = rng.standard_normal((2, s, 32)).astype(np.float32)
        jo, jc = step(params, jnp.asarray(x), jc)
        with torch.no_grad():
            to, tc = tm(torch.from_numpy(x), cache=tc, decode=True)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **TOL)
        np.testing.assert_array_equal(np.asarray(tc["index"]),
                                      np.asarray(jc["index"]))


@pytest.mark.parametrize("cfg", [GPT2, GEMMA2], ids=["gpt2", "gemma2"])
def test_generate_token_exact_vs_jax(cfg):
    """Greedy ``GPT.generate`` of 24 tokens after 11 (past the window of 8)
    equals JAX's token for token, for two rows."""
    jgpt, params, tgpt = _pair(cfg)
    prompt = np.random.default_rng(0).integers(0, 128, (2, 11))
    want = jax.jit(lambda p, x: jgpt.generate(p, x, steps=24))(
        params, jnp.asarray(prompt))
    got = tgpt.generate(torch.from_numpy(prompt), 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cfg", [GPT2, GEMMA2], ids=["gpt2", "gemma2"])
def test_apply_decode_and_collect_kv_vs_jax(cfg):
    """``apply(caches=, decode=True, logits_last_only=True)`` of a prompt,
    then one step, and ``apply(collect_kv=True)``: logits and every layer's
    k/v ([b, hkv, s, dk], after RoPE) equal JAX's."""
    jgpt, params, tgpt = _pair(cfg, seed=1)
    toks = np.random.default_rng(2).integers(0, 128, (2, 9))
    nxt = np.random.default_rng(3).integers(0, 128, (2, 1))

    @jax.jit
    def jrun(p, x, y):
        c = jgpt.init_cache(2, 16)
        l1, c = jgpt.apply(p, x, caches=c, decode=True, logits_last_only=True)
        l2, c = jgpt.apply(p, y, caches=c, decode=True)
        lc, kvs = jgpt.apply(p, x, collect_kv=True, logits_last_only=True)
        return l1, l2, lc, kvs

    jl1, jl2, jlc, jkvs = jrun(params, jnp.asarray(toks), jnp.asarray(nxt))
    with torch.no_grad():
        caches = tgpt.init_cache(2, 16)
        l1, caches = tgpt.apply(torch.from_numpy(toks), caches=caches,
                                decode=True, logits_last_only=True)
        l2, caches = tgpt.apply(torch.from_numpy(nxt), caches=caches,
                                decode=True)
        lc, kvs = tgpt.apply(torch.from_numpy(toks), collect_kv=True,
                             logits_last_only=True)
    assert l1.shape == (2, 1, 128) and caches[0]["index"] == 10
    for got, want in ((l1, jl1), (l2, jl2), (lc, jlc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for (k, v), (jk, jv) in zip(kvs, jkvs):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def test_generate_sampled_repeats_with_the_seed():
    """Sampled ``generate`` (temperature 0.8, top-k 20, top-p 0.9): the same
    generator seed draws the same tokens, another seed other ones."""
    _, _, tgpt = _pair(GPT2)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, 128,
                                                                (2, 5)))

    def run(seed):
        return tgpt.generate(prompt, 16, torch.Generator().manual_seed(seed),
                             temperature=0.8, top_k=20, top_p=0.9)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_generate_on_cpu_runs_no_kernel():
    _, _, tgpt = _pair(GPT2)
    before = ops.flash_attention.launches_fwd_mask
    tgpt.generate(torch.zeros((1, 3), dtype=torch.long), 4)
    assert ops.flash_attention.launches_fwd_mask == before


def test_train_gpt_prints_the_closing_sample(capsys):
    """The entry point ends with the example's greedy 16-token sample
    (examples/train_gpt.py:86-87)."""
    train_gpt.main(["--steps", "1", "--batch", "2", "--seq", "32",
                    "--d-model", "32", "--layers", "1", "--heads", "4",
                    "--vocab", "64", "--device", "cpu"])
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("sample continuation:")]
    assert len(line) == 1
    toks = line[0].split("[", 1)[1].rstrip("]").split()
    assert len(toks) == 16 and all(0 <= int(t) < 64 for t in toks)
