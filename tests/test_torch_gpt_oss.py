"""gpt-oss in the port against the JAX package, on the CPU.

The port's parts of gpt-oss's path, at tiny sizes against the JAX
package on the same numpy inputs and weights (the JAX side under
``jax.jit``), fp32 at rtol 1e-5 / atol 2e-5 (BASELINE.md:16):

- YaRN on ordinary attention (the repair: ``MultiHeadAttention`` once
  dropped ``rope_scaling``): a GQA YaRN GPT's ``apply``, its dense-cache
  decode steps, ``generate`` and the paged engine (chunked and dense
  prefill), with mscale 1 and gpt-oss's 1.3466;
- ``paged_attention_reference`` and ``paged_attention_split_reference``
  with sinks against JAX's reference (and JAX's Pallas kernel in
  interpret mode): window or none, GQA 8, int8 pages, a length-0 row,
  sinks far above and below the scores;
- ``MultiHeadAttention`` with sinks against JAX's ``apply`` (dense and
  through the decode cache) and its gradients, ``dsinks`` included;
- JAX's own tiny gpt-oss (tests/test_hf_compat.py's ``GptOssConfig``,
  a ``GptOssForCausalLM`` built offline) through ``import_gpt_oss`` and
  ``params_from_numpy``: ``apply``, ``generate``, and the engine (chunked
  and dense prefill, ``step_many``, bf16 pages, ``fork`` on int8 pages,
  the prefix cache) token for token against JAX's engine; bf16 compute
  within BF16_TOL; the weights' round trip with the sinks leaf;
- chip_smoke's gpt-oss-20b configuration against ``llama_config`` of the
  published config with ``import_gpt_oss``'s fields, and its parameter
  counts (HF's and the port's, on the meta device).

The CUDA kernel (K3's sinks option) runs only on the card
(tests/test_torch_cuda.py).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu import ops as jops
from np_modeling_tpu.nn.attention import MultiHeadAttention as JMHA
from np_modeling_tpu.ops import dispatch as jdispatch
from np_modeling_tpu.serving import GenerationEngine as JaxEngine
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn import MultiHeadAttention
from np_modeling_tpu_torch.nn import moe as moe_mod
from np_modeling_tpu_torch.serving import GenerationEngine
from np_modeling_tpu_torch.utils import (load_params, params_from_numpy,
                                         params_to_numpy, tree_to_numpy)

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)
# bf16 compute (chip_smoke's rule): the port's bf16 logits no further from
# JAX's fp32 logits than 1.25 x JAX's own bf16 logits are, plus BF16_SLACK x
# max(1, max |logit|), at the positions whose routing is decided: where a
# token's k-th and (k + 1)-th router logits lie within ROUTE_TIE (bf16's
# rounding, 2 ** -8) in some MoE layer, bf16 may pick the other expert.
BF16_SLACK, ROUTE_TIE = 1e-2, 2.0 ** -8
rng = np.random.default_rng(81)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jax_config(tcfg):
    """The JAX GPTConfig with the port config's fields (dtype None)."""
    fields = {f.name: getattr(tcfg, f.name)
              for f in dataclasses.fields(tmodels.GPTConfig)}
    fields["dtype"] = None
    return jmodels.GPTConfig(**fields)


def _port_config(jcfg, **over):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tmodels.GPTConfig)}
    fields.update(dtype=None, **over)
    return tmodels.GPTConfig(**fields)


def _joins_and_leaves(eng, p1, p2, wrap):
    """1 joins, a step, 2 joins, three steps, 2 leaves, step_many(2)."""
    g1, g2 = [eng.add_request(1, wrap(p1))], []
    g1.append(eng.step()[1])
    g2.append(eng.add_request(2, wrap(p2)))
    for _ in range(3):
        out = eng.step()
        g1.append(out[1])
        g2.append(out[2])
    eng.finish(2)
    g1 += eng.step_many(2)[1]
    return g1, g2


# ---- the repair: YaRN on ordinary attention -------------------------------

YARN_GPT = dict(vocab_size=61, d_model=32, num_heads=4, num_kv_heads=2,
                num_layers=2, hidden_units=48, max_len=64, positional="rope",
                norm="rms", ffn="swiglu", use_bias=False, ln_eps=1e-6)
# mscale 1 and gpt-oss's 0.1 ln 32 + 1 (YaRN's attention factor at 32x).
MSCALES = (1.0, 0.1 * math.log(32.0) + 1.0)


@pytest.fixture(scope="module", params=MSCALES, ids=["mscale1", "mscale1.35"])
def yarn_gpt(request):
    """A 2-layer GQA (4 / 2 heads) RMS / swiglu GPT with YaRN ("yarn", 4,
    32, 1, 8, mscale) from the port's seeded init; its JAX twin and tree."""
    cfg = tmodels.GPTConfig(**YARN_GPT, rope_scaling=(
        "yarn", 4.0, 32.0, 1.0, 8.0, request.param))
    t = tmodels.GPT(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    return t, jmodels.GPT(_jax_config(cfg)), _jtree(params_to_numpy(t))


def test_yarn_gpt_apply_decode_generate_vs_jax(yarn_gpt):
    """``apply`` logits, each dense-cache decode step's logits and greedy
    ``generate`` against JAX: each rotation takes the scaled frequencies and
    the mscale (before the repair the port rotated without them)."""
    t, j, params = yarn_gpt
    toks = rng.integers(0, 61, (2, 14))
    want = jax.jit(j.apply)(params, jnp.asarray(toks))
    with torch.no_grad():
        got = t.apply(torch.tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    step = jax.jit(lambda p, x, c: j.apply(p, x, caches=c, decode=True))
    jc, tc = j.init_cache(2, 24), t.init_cache(2, 24)
    with torch.no_grad():
        for lo, hi in ((0, 9), (9, 10), (10, 11), (11, 14)):
            want, jc = step(params, jnp.asarray(toks[:, lo:hi]), jc)
            got, tc = t.apply(torch.tensor(toks[:, lo:hi]), caches=tc,
                              decode=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    prompt = rng.integers(0, 61, (2, 9))
    gen = jax.jit(lambda p, x: j.generate(p, x, steps=8))
    np.testing.assert_array_equal(
        t.generate(torch.tensor(prompt), steps=8).numpy(),
        np.asarray(gen(params, jnp.asarray(prompt))))


@pytest.mark.parametrize("chunk", [4, None], ids=["chunked", "dense"])
def test_yarn_gpt_engine_vs_jax(yarn_gpt, chunk):
    """The paged engine rotates through the module (``attn._rope``): joins
    and leaves, chunked or dense prefill, token for token with JAX's."""
    t, j, params = yarn_gpt
    kw = dict(total_pages=32, page_size=8, max_seqs=4,
              prefill_chunk_size=chunk)
    p1, p2 = rng.integers(0, 61, 13), rng.integers(0, 61, 13)
    got = _joins_and_leaves(GenerationEngine(t, **kw), p1, p2, lambda a: a)
    assert got == _joins_and_leaves(JaxEngine(j, params, **kw), p1, p2,
                                    jnp.asarray)


# ---- paged attention with sinks --------------------------------------------

def _paged_case(sq, int8, seed):
    """q [4, (sq,) 16, 16] over 2 kv heads (GQA 8), pages [2, 24, 8, 16], a
    scrambled table of 4 pages a sequence, lengths with a 0 (and, for a
    chunk, one shorter than sq); sinks N(0, 1) with one 30 above and one 30
    below every score. Int8 pages with their scales, dequantized for the
    references that take float pages."""
    r = np.random.default_rng(seed)
    b, hq, hkv, d, ps, pps, total = 4, 16, 2, 16, 8, 4, 24
    q = r.standard_normal((b, hq, d) if sq is None else (b, sq, hq, d))
    k, v = (r.standard_normal((hkv, total, ps, d)) for _ in range(2))
    q, k, v = (x.astype(np.float32) for x in (q, k, v))
    table = r.permutation(total)[:b * pps].reshape(b, pps).astype(np.int32)
    lengths = np.array([0, 3 if sq else 1, 17, 32], np.int32)
    top = float(np.abs(q).sum(-1).max() * np.abs(k).max() / math.sqrt(d))
    sinks = r.standard_normal(hq).astype(np.float32)
    sinks[3], sinks[12] = top + 30.0, -top - 30.0
    scales = None
    if int8:
        kq, vq = (ops.quantize_int8(torch.tensor(x)) for x in (k, v))
        scales = (kq.scales, vq.scales)
        k8, v8 = kq.values, vq.values
        k = (k8.float() * kq.scales).numpy()
        v = (v8.float() * vq.scales).numpy()
    else:
        k8, v8 = torch.tensor(k), torch.tensor(v)
    return q, k, v, k8, v8, scales, lengths, table, sinks


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [None, 6], ids=["global", "window6"])
@pytest.mark.parametrize("sq", [None, 5], ids=["decode", "chunk5"])
def test_paged_sinks_references_vs_jax(sq, window, int8):
    """The port's paged_attention (plain on the CPU) and the split schedule's
    plain twin at 8, 16 and 24 keys a range (the sink joins once, after the
    merge) against JAX's reference on the same inputs, with its rows that see
    no key (0 everywhere: the sink outweighs every masked key)."""
    q, k, v, k8, v8, scales, lengths, table, sinks = _paged_case(
        sq, int8, 3 + (sq or 0) + 2 * int8)
    jwant = np.asarray(jax.jit(
        lambda *a: jops.paged_attention_reference(*a[:5], window=window,
                                                  sinks=a[5]))(
        *(jnp.asarray(a) for a in (q, k, v, lengths, table, sinks))))
    kw = {} if scales is None else dict(k_scales=scales[0],
                                        v_scales=scales[1])
    got = ops.paged_attention(torch.tensor(q), k8, v8, torch.tensor(lengths),
                              torch.tensor(table), window=window,
                              sinks=torch.tensor(sinks), **kw)
    np.testing.assert_allclose(got.numpy(), jwant, **TOL)
    assert np.all(jwant[0] == 0) and np.all(got.numpy()[0] == 0)
    for split_keys in (8, 16, 24):
        split = ops.paged_attention_split_reference(
            *(torch.tensor(a) for a in (q, k, v, lengths, table)),
            -(-32 // split_keys), split_keys, window=window,
            sinks=torch.tensor(sinks))
        np.testing.assert_allclose(split.numpy(), jwant, **TOL)


@pytest.mark.parametrize("sq,window", [(None, None), (4, 6)],
                         ids=["decode", "chunk4_window6"])
def test_paged_sinks_plain_vs_jax_pallas_interpret(sq, window):
    """The plain version against JAX's Pallas kernel (interpret mode) with
    sinks, over rows that each see a key (the kernel's e^(sink - m) is not
    the oracle's where none is seen)."""
    q, k, v, _, _, _, lengths, table, sinks = _paged_case(sq, False, 9)
    lengths = np.maximum(lengths, sq or 1)
    sinks = np.clip(sinks, -4.0, 4.0)
    with jdispatch.force_pallas(True, interpret=True):
        want = jax.jit(lambda *a: jops.paged_attention(
            *a[:5], pages_per_block=2, window=window, sinks=a[5]))(
            *(jnp.asarray(a) for a in (q, k, v, lengths, table, sinks)))
    got = ops.paged_attention(*(torch.tensor(a) for a in (
        q, k, v, lengths, table)), window=window, sinks=torch.tensor(sinks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---- MultiHeadAttention with sinks -----------------------------------------

MHA_FIELDS = dict(num_heads=4, num_kv_heads=2, causal=True, rope=True,
                  attn_sinks=True,
                  rope_scaling=("yarn", 4.0, 32.0, 1.0, 8.0, MSCALES[1]))


@pytest.mark.parametrize("window", [None, 5], ids=["global", "window5"])
def test_mha_sinks_dense_decode_and_grads_vs_jax(window):
    """``apply`` (dense), each decode-cache step, and the gradients of a
    random projection of the dense output with respect to every weight and
    the sinks, against JAX's ``apply`` and ``jax.grad``."""
    t = MultiHeadAttention(32, window=window, device="cpu", **MHA_FIELDS
                           ).init(torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        t.sinks.copy_(torch.tensor([0.8, -1.2, 2.5, 0.1]))
        for b in (t.bq, t.bk, t.bv, t.bo):
            b.normal_(0.0, 0.1, generator=g)
    j = JMHA(window=window, **MHA_FIELDS)
    params = _jtree(tree_to_numpy(dict(t.named_parameters())))
    x = rng.standard_normal((2, 11, 32)).astype(np.float32)
    w = rng.standard_normal((2, 11, 32)).astype(np.float32)

    def jloss(p, x):
        out = j.apply(p, x)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, jnp.asarray(x))
    out = t(torch.tensor(x))
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    got = tree_to_numpy({n: p.grad for n, p in t.named_parameters()})
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), **TOL), got, jg)
    assert np.abs(got["sinks"]).min() > 1e-4
    step = jax.jit(lambda p, x, c: j.apply(p, x, cache=c, decode=True))
    jc, tc = j.init_cache(2, 16, 32), t.init_cache(2, 16, 32)
    with torch.no_grad():
        for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 11)):
            want, jc = step(params, jnp.asarray(x[:, lo:hi]), jc)
            out, tc = t(torch.tensor(x[:, lo:hi]), cache=tc, decode=True)
            np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


# ---- JAX's tiny gpt-oss -----------------------------------------------------

V = 89


def _tiny_gpt_oss_model(seed=71):
    """tests/test_hf_compat.py's tiny gpt-oss (HF, random weights)."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.GptOssConfig(
        vocab_size=V, hidden_size=32, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=16, num_local_experts=4, num_experts_per_tok=2,
        sliding_window=8, max_position_embeddings=64, rms_norm_eps=1e-6,
        attention_dropout=0.0, tie_word_embeddings=False,
        rope_theta=10000.0, attention_bias=True,
        layer_types=["sliding_attention", "full_attention"] * 2,
        rope_scaling={"rope_type": "yarn", "factor": 4.0,
                      "original_max_position_embeddings": 16,
                      "beta_fast": 32.0, "beta_slow": 1.0},
        attn_implementation="eager")
    torch.manual_seed(seed)
    return transformers.GptOssForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def gpt_oss():
    """(port GPT, JAX GPT, JAX tree) of the tiny gpt-oss through JAX's
    ``import_gpt_oss`` and the port's ``params_from_numpy``."""
    from np_modeling_tpu.utils import hf_compat
    jcfg, params = hf_compat.import_gpt_oss(_tiny_gpt_oss_model())
    t = params_from_numpy(params, _port_config(jcfg), device="cpu")
    return t, jmodels.GPT(jcfg), _jtree(params)


def test_gpt_oss_structure_and_round_trip(gpt_oss):
    """Sinks on every layer, windows on the even ones, biased projections and
    glu_clamp experts; JAX's tree in (``layer_{i}/self_attention/sinks``
    included), the same tree out."""
    t, j, params = gpt_oss
    c = t.config
    assert c.attn_sinks and c.window_pattern == 2 and c.ffn == "glu_clamp"
    for i in range(c.num_layers):
        attn = t._block_for(i).self_attention
        assert attn.sinks.shape == (4,) and attn.sinks.dtype == torch.float32
        assert attn.window == (8 if i % 2 == 0 else None)
        assert attn.rope_scaling == c.rope_scaling and attn.bq is not None
    tree = params_to_numpy(t)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree,
                           jax.tree_util.tree_map(np.asarray, params))
    fresh = tmodels.GPT(c, device="cpu").init(torch.Generator().manual_seed(0))
    assert not fresh.layer_0.self_attention.sinks.any()   # zeros, as JAX
    load_params(fresh, tree)
    assert torch.equal(fresh.layer_3.self_attention.sinks,
                       t.layer_3.self_attention.sinks)


def _route_gaps(t, toks, monkeypatch):
    """The least gap, over the MoE layers of the port's fp32 forward, between
    each token's k-th and (k + 1)-th router logits, [b, s]."""
    gaps, logits = [], moe_mod.MoE._logits

    def spy(self, xt):
        lg = logits(self, xt)
        top = lg.float().topk(self.router_top_k + 1, dim=-1).values
        gaps.append(top[:, -2] - top[:, -1])
        return lg

    monkeypatch.setattr(moe_mod.MoE, "_logits", spy)
    with torch.no_grad():
        t.apply(torch.tensor(toks))
    monkeypatch.undo()
    return torch.stack(gaps).amin(0).reshape(toks.shape).numpy()


def test_gpt_oss_apply_generate_vs_jax(gpt_oss, monkeypatch):
    """``apply`` logits in fp32, greedy ``generate`` (dense prefill through
    flash attention's sink rescale, then the decode cache) token for token,
    and bf16 compute's logits by the rule of BF16_SLACK."""
    t, j, params = gpt_oss
    toks = rng.integers(0, V, (2, 13))
    want = np.asarray(jax.jit(j.apply)(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = t.apply(torch.tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    prompt = rng.integers(0, V, (2, 9))
    gen = jax.jit(lambda p, x: j.generate(p, x, steps=10))
    gtoks = t.generate(torch.tensor(prompt), steps=10).numpy()
    np.testing.assert_array_equal(gtoks, np.asarray(gen(params,
                                                        jnp.asarray(prompt))))
    assert len(set(gtoks.ravel().tolist())) > 3
    jc16 = dataclasses.replace(j.config, dtype=jnp.bfloat16)
    want16 = np.asarray(jax.jit(jmodels.GPT(jc16).apply)(
        params, jnp.asarray(toks)), np.float32)
    t16 = tmodels.GPT(dataclasses.replace(t.config, dtype=torch.bfloat16),
                      device="meta")
    t16.load_state_dict(t.state_dict(), assign=True)
    with torch.no_grad():
        got16 = t16.apply(torch.tensor(toks)).float().numpy()
    held = _route_gaps(t, toks, monkeypatch) >= ROUTE_TIE
    assert held.mean() > 0.5
    err_t = np.abs(got16 - want)[held].max()
    err_j = np.abs(want16 - want)[held].max()
    assert err_t <= 1.25 * err_j + BF16_SLACK * max(1.0, np.abs(want).max())


ENGINE_CASES = {
    "chunk4": dict(prefill_chunk_size=4),
    "chunk256_bf16_pages": dict(prefill_chunk_size=256, kv_dtype="bf16"),
    "dense_prefill": dict(prefill_chunk_size=None),
}


def _engines(gpt_oss, **kw):
    t, j, params = gpt_oss
    base = dict(total_pages=40, page_size=4, max_seqs=4)
    jkw, tkw = dict(base, **kw), dict(base, **kw)
    if kw.get("kv_dtype"):
        jkw["kv_dtype"], tkw["kv_dtype"] = jnp.bfloat16, torch.bfloat16
    return JaxEngine(j, params, **jkw), GenerationEngine(t, **tkw)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_gpt_oss_engine_vs_jax(gpt_oss, case):
    """Joins and leaves past the window of 8 (prompts of 13), chunked or
    dense prefill, fp32 or bf16 pages: token for token with JAX's engine;
    every page home after finish. fp32 chunks: equal to the port's own
    ``generate`` too."""
    jeng, teng = _engines(gpt_oss, **ENGINE_CASES[case])
    free0 = teng.free_pages
    p1, p2 = rng.integers(0, V, 13), rng.integers(0, V, 13)
    got = _joins_and_leaves(teng, p1, p2, lambda a: a)
    assert got == _joins_and_leaves(jeng, p1, p2, jnp.asarray)
    if case == "chunk4":
        gen = gpt_oss[0].generate(torch.tensor(p1)[None], steps=7)
        assert got[0] == gen[0].tolist()
    teng.finish(1)
    assert teng.free_pages == free0


def test_gpt_oss_engine_fork_int8_pages_vs_jax(gpt_oss):
    """An MoE model with sinks under ``fork`` on int8 pages: the children
    share the full pages and copy the tail (values and scales); greedy twins
    equal the parent and JAX's; every page home."""
    jeng, teng = _engines(gpt_oss, prefill_chunk_size=4, quantize_kv=True)
    free0 = teng.free_pages
    prompt = rng.integers(0, V, 14)
    assert teng.add_request(0, prompt) == jeng.add_request(
        0, jnp.asarray(prompt))
    assert teng.step_many(2) == jeng.step_many(2)
    for child in (1, 2):
        teng.fork(0, child)
        jeng.fork(0, child)
        assert teng.free_pages == jeng.free_pages
    got, want = teng.step_many(5), jeng.step_many(5)
    assert got == want and got[0] == got[1] == got[2]
    for sid in (0, 2, 1):
        teng.finish(sid)
        jeng.finish(sid)
    assert teng.free_pages == jeng.free_pages == free0


def test_gpt_oss_engine_prefix_cache_vs_jax(gpt_oss):
    """An MoE model with sinks and windows under the prefix cache: prompts
    sharing 16 or 8 tokens, tokens, ``prefix_cache_stats`` and free pages
    equal JAX's at every turn."""
    jeng, teng = _engines(gpt_oss, prefill_chunk_size=4,
                          enable_prefix_cache=True)
    shared = rng.integers(0, V, 16)
    prompts = [np.concatenate([shared[:n], rng.integers(0, V, m)])
               for n, m in ((16, 3), (8, 5), (16, 1))]
    for i, p in enumerate(prompts):
        got = [teng.add_request(i, p)] + teng.step_many(3)[i]
        want = [jeng.add_request(i, jnp.asarray(p))] + jeng.step_many(3)[i]
        assert got == want
        assert teng.prefix_cache_stats == jeng.prefix_cache_stats
        assert teng.free_pages == jeng.free_pages
        teng.finish(i)
        jeng.finish(i)
    assert teng.prefix_cache_stats["hit_tokens"] > 0


# ---- chip_smoke's gpt-oss-20b configuration ----------------------------------

# openai/gpt-oss-20b's config.json (https://huggingface.co/openai/gpt-oss-20b),
# the fields transformers.GptOssConfig takes.
GPT_OSS_20B_HF = dict(
    vocab_size=201088, hidden_size=2880, num_hidden_layers=24,
    num_attention_heads=64, num_key_value_heads=8, head_dim=64,
    intermediate_size=2880, num_local_experts=32, num_experts_per_tok=4,
    sliding_window=128, max_position_embeddings=131072, rms_norm_eps=1e-5,
    rope_theta=150000.0, tie_word_embeddings=False, attention_bias=True,
    layer_types=["sliding_attention", "full_attention"] * 12,
    rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                  "beta_slow": 1.0, "truncate": False,
                  "original_max_position_embeddings": 4096})


def test_gpt_oss_20b_config_and_counts(monkeypatch):
    """chip_smoke's (D) config equals what ``import_gpt_oss`` maps from
    gpt-oss-20b's published config.json, apart from its two cuts (16 of 24
    layers, a table of 2048 positions); HF's model and the port's hold the
    same parameter count on the meta device, 20,914,757,184 at 24 layers
    and 14,329,261,376 at 16."""
    transformers = pytest.importorskip("transformers")
    import chip_smoke
    from np_modeling_tpu.utils import hf_compat
    fields = GPT_OSS_20B_HF
    hc = transformers.GptOssConfig(**fields)

    class Stop(Exception):
        pass

    class Model:          # import_gpt_oss maps the config, then the weights
        config = hc

        def state_dict(self):
            raise Stop

    mapped = []
    real = hf_compat.llama_config
    monkeypatch.setattr(hf_compat, "llama_config",
                        lambda *a, **kw: mapped.append(real(*a, **kw))
                        or mapped[-1])
    with pytest.raises(Stop):
        hf_compat.import_gpt_oss(Model())
    want = _port_config(mapped[0], num_layers=chip_smoke.GPT_OSS_LAYERS,
                        max_len=chip_smoke.GPT_OSS_MAX_LEN)
    got = chip_smoke.gpt_oss_20b_config()
    assert got == want
    assert mapped[0].num_layers == 24 and mapped[0].max_len == 131072
    assert got.rope_scaling == ("yarn", 32.0, 32.0, 1.0, 4096.0, MSCALES[1])
    for layers, count in ((24, 20_914_757_184),
                          (chip_smoke.GPT_OSS_LAYERS,
                           chip_smoke.GPT_OSS_PARAMS)):
        port = tmodels.GPT(chip_smoke.gpt_oss_20b_config(layers=layers),
                           device="meta")
        assert sum(p.numel() for p in port.parameters()) == count
    assert chip_smoke.GPT_OSS_PARAMS == 14_329_261_376
    cut = dict(fields, num_hidden_layers=16,
               layer_types=fields["layer_types"][:16])
    with torch.device("meta"):
        hf = transformers.GptOssForCausalLM(transformers.GptOssConfig(**cut))
    assert sum(p.numel() for p in hf.parameters()) == \
        chip_smoke.GPT_OSS_PARAMS
