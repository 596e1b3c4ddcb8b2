"""MLA (DeepSeek-V2's latent attention) in the port against the JAX package,
on the CPU.

At the JAX tests' tiny size (tests/test_mla.py: rank 16, q_rank 24 or None,
nope 8, rope 4, v 8, 4 heads, d_model 32): YaRN ``apply_rope`` forward and
gradient (mscale 1 and not); ``MLAttention`` outputs and every gradient with
both q paths, and its absorbed latent-cache decode over several steps; an
MLA GPT with YaRN and an untied head (logits, loss, every gradient,
``generate``); the weights' round trip; ``paged_attention``'s plain version
with one page array as k and v (float, and int8 with one scale set) against
JAX's; the latent split plan; and the serving engine on latent pages
against JAX's engine token for token: test_mla.py's cases (chunk 256 and 4,
continuous batching, the chunked-prefill requirement), bf16 and int8 latent
pages, fork and the prefix cache. Then chip_smoke's DeepSeek-V2-Lite
configs against the JAX package's own mapping of its published config:
phase (B)'s with its MoE layers, and (C)'s with every layer dense. The weights
come from the port's ``init``; the JAX side runs under ``jax.jit``. fp32 at
rtol 1e-5 / atol 2e-5 (BASELINE.md:16), gradients at atol 5e-5 (the flash
tests').
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu import ops as jops
from np_modeling_tpu.nn.mla import MLAttention as JMLA
from np_modeling_tpu.ops.quantization import quantize_int8 as jquantize_int8
from np_modeling_tpu.serving import GenerationEngine as JaxEngine
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn import MLAttention
from np_modeling_tpu_torch.serving import GenerationEngine
from np_modeling_tpu_torch.utils import (params_from_numpy, params_to_numpy,
                                         tree_to_numpy)

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
rng = np.random.default_rng(51)


def _tree(module):
    return jax.tree_util.tree_map(jnp.asarray, params_to_numpy(module))


def _grads(module):
    return tree_to_numpy({n: p.grad for n, p in module.named_parameters()})


def _close(got, want, tol=TOL):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **tol),
        got, want)


# ---- YaRN RoPE ---------------------------------------------------------------

@pytest.mark.parametrize("scaling", [YARN, ("yarn", 40.0, 32.0, 1.0, 64.0,
                                             0.707)],
                         ids=["mscale1", "mscale0.707"])
def test_yarn_apply_rope_and_gradient_vs_jax(scaling):
    """The yarn frequencies, mscale on cos/sin, and the hand-written
    backward (the inverse rotation times mscale) at positions past the
    original window, [s] and [b, s] positions."""
    x = rng.standard_normal((2, 3, 40, 8)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    for pos in (np.arange(40) * 3, rng.integers(0, 500, (2, 40))):
        want, vjp = jax.vjp(lambda t: jops.apply_rope(
            t, jnp.asarray(pos), 10000.0, None, scaling), jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        got = ops.apply_rope(xt, torch.tensor(pos), 10000.0, None, scaling)
        got.backward(torch.tensor(dy))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        np.testing.assert_allclose(xt.grad.numpy(),
                                   np.asarray(vjp(jnp.asarray(dy))[0]), **TOL)


def test_unported_rope_scaling_still_raises():
    x = torch.zeros(1, 1, 2, 4)
    with pytest.raises(NotImplementedError, match="llama3"):
        ops.apply_rope(x, torch.arange(2), scaling=("llama3", 8.0, 1.0, 4.0,
                                                    16.0))


# ---- MLAttention ---------------------------------------------------------------

def _layer(q_lora_rank, seed=0):
    mla = MLAttention(32, 4, **{**DIMS, "q_lora_rank": q_lora_rank},
                      rope_scaling=YARN, device="cpu").init(
        torch.Generator().manual_seed(seed))
    jmla = JMLA(num_heads=4, **{**DIMS, "q_lora_rank": q_lora_rank},
                rope_scaling=YARN)
    return mla, jmla, _tree(mla)


@pytest.mark.parametrize("q_lora_rank", [24, None])
def test_mla_forward_and_every_gradient_vs_jax(q_lora_rank):
    """JAX's concatenated-features flash call (v zero-padded), outputs and
    the gradients of every parameter and of x."""
    mla, jmla, params = _layer(q_lora_rank)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    loss = jax.jit(jax.value_and_grad(
        lambda p, t: jnp.sum(jnp.sin(jmla.apply(p, t))), argnums=(0, 1)))
    want, (gp, gx) = loss(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = torch.sum(torch.sin(mla(xt)))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    grads = _grads(mla)
    assert set(grads) == set(gp)
    _close(grads, gp, GRAD_TOL)


@pytest.mark.parametrize("q_lora_rank", [24, None])
def test_mla_absorbed_decode_vs_jax(q_lora_rank):
    """The latent cache: a prefill of 5 tokens then one token a step, the
    outputs and the cache equal to JAX's at every step."""
    mla, jmla, params = _layer(q_lora_rank, seed=1)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    step = jax.jit(lambda p, t, c: jmla.apply(p, t, cache=c, decode=True))
    jcache = jmla.init_cache(2, 12, 32)
    cache = mla.init_cache(2, 12, 32)
    assert cache["k"].shape == (2, 1, 12, 20) and set(cache) == {"k", "index"}
    with torch.no_grad():
        for lo, hi in ((0, 5), (5, 6), (6, 7), (7, 9)):
            want, jcache = step(params, jnp.asarray(x[:, lo:hi]), jcache)
            got, cache = mla(torch.tensor(x[:, lo:hi]), cache=cache,
                             decode=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(cache["k"].numpy(),
                                       np.asarray(jcache["k"]), **TOL)
            assert cache["index"] == int(jcache["index"]) == hi


# ---- the GPT -------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """The JAX GPT, its params and the port's GPT on the same seeded weights
    (GPT_CFG: MLA, YaRN, an untied head)."""
    tgpt = tmodels.GPT(tmodels.GPTConfig(**GPT_CFG), device="cpu").init(
        torch.Generator().manual_seed(3))
    return jmodels.GPT(jmodels.GPTConfig(**GPT_CFG)), _tree(tgpt), tgpt


def test_gpt_apply_loss_grads_and_generate_vs_jax(weights):
    """GPT.apply's logits, GPT.loss and every gradient (lm_head's included),
    and greedy GPT.generate through the latent caches, token for token."""
    jgpt, params, tgpt = weights
    toks = rng.integers(0, V, (2, 16))
    jt = jnp.asarray(toks)
    want = jax.jit(jgpt.apply)(params, jt)
    np.testing.assert_allclose(tgpt.apply(torch.tensor(toks)).detach().numpy(),
                               np.asarray(want), **TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(jgpt.loss))(params, jt)
    tgpt.zero_grad()
    loss = tgpt.loss(torch.tensor(toks))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = _grads(tgpt)
    assert "lm_head" in grads and set(grads) == set(jgrads)
    _close(grads, jgrads, GRAD_TOL)
    prompt = rng.integers(0, V, (1, 9))
    gen = jax.jit(lambda p, t: jgpt.generate(p, t, steps=6))
    want = np.asarray(gen(params, jnp.asarray(prompt)))
    got = tgpt.generate(torch.tensor(prompt), steps=6).numpy()
    np.testing.assert_array_equal(got, want)


def test_gpt_fused_loss_untied_head_vs_jax():
    """fused_loss with the untied head: the chunked loss over lm_head.w
    ("dv" layout) and its gradient against JAX's."""
    cfg = dict(GPT_CFG, fused_loss=True)
    tgpt = tmodels.GPT(tmodels.GPTConfig(**cfg), device="cpu").init(
        torch.Generator().manual_seed(5))
    jgpt, params = jmodels.GPT(jmodels.GPTConfig(**cfg)), _tree(tgpt)
    toks = rng.integers(0, V, (2, 16))
    jloss, jgrads = jax.jit(jax.value_and_grad(jgpt.loss))(
        params, jnp.asarray(toks))
    loss = tgpt.loss(torch.tensor(toks))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _close(_grads(tgpt), jgrads, GRAD_TOL)


@pytest.mark.parametrize("q_lora_rank", [24, None])
def test_params_round_trip(q_lora_rank):
    """Both q paths and the untied head: JAX's tree in, the same tree out,
    every MLA leaf at its JAX path."""
    cfg = tmodels.GPTConfig(**{**GPT_CFG, "mla": {**DIMS,
                                                  "q_lora_rank": q_lora_rank}})
    tgpt = tmodels.GPT(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    tree = params_to_numpy(tgpt)
    q = {"wq"} if q_lora_rank is None else {"q_a", "q_a_norm", "q_b"}
    assert set(tree["layer_0"]["self_attention"]) == q | {
        "kv_a", "kv_a_norm", "kv_b", "wo"}
    assert set(tree["lm_head"]) == {"w"}
    jcfg = jmodels.GPTConfig(**{**GPT_CFG, "mla": {**DIMS,
                                                   "q_lora_rank": q_lora_rank}})
    jtree = jax.eval_shape(lambda: jmodels.GPT(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    assert jax.tree_util.tree_structure(jtree) == \
        jax.tree_util.tree_structure(tree)
    back = params_to_numpy(params_from_numpy(tree, cfg, device="cpu"))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)


def test_unported_neighbours_still_raise():
    """MLA asserts JAX's compositions; lm_head_bias and llama3 scaling are
    later slices."""
    with pytest.raises(ValueError, match="MLA composes"):
        tmodels.GPT(tmodels.GPTConfig(**{**GPT_CFG, "attention_window": 8}),
                    device="cpu")
    for bad in (dict(lm_head_bias=True),
                dict(rope_scaling=("llama3", 8.0, 1.0, 4.0, 16.0))):
        with pytest.raises(NotImplementedError):
            tmodels.GPT(tmodels.GPTConfig(**{**GPT_CFG, **bad}), device="cpu")


# ---- paged attention with one page array as k and v -------------------------

def _latent_case(b, sq, hq=4, width=20, psize=8, pps=4, total=12, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, hq, width) if sq is None
                          else (b, sq, hq, width)).astype(np.float32)
    pages = r.standard_normal((1, total, psize, width)).astype(np.float32)
    table = r.permutation(total)[:b * pps].reshape(b, pps).astype(np.int32)
    lengths = r.integers(max(sq or 1, 1), pps * psize + 1, b).astype(np.int32)
    return q, pages, lengths, table


@pytest.mark.parametrize("sq", [None, 1, 5])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_paged_attention_one_array_as_k_and_v_vs_jax(sq, int8):
    """``paged_attention(q, P, P, ...)`` (the engine's latent call, scale
    1/sqrt(12) over a 20-wide dot) against JAX's, fp32 pages and int8 pages
    with one scale set as both scales; and the split-KV plain schedule."""
    q, pages, lengths, table = _latent_case(3, sq)
    kw, tkw = {}, {}
    if int8:
        quant = jquantize_int8(jnp.asarray(pages))
        pages = np.asarray(quant.values)
        sc = np.asarray(quant.scales)
        kw = dict(k_scales=jnp.asarray(sc), v_scales=jnp.asarray(sc))
        tkw = dict(k_scales=torch.tensor(sc), v_scales=torch.tensor(sc))
    run = jax.jit(lambda q, p, ln, t, **k: jops.paged_attention(
        q, p, p, ln, t, scale=12 ** -0.5, **k))
    want = run(*(jnp.asarray(a) for a in (q, pages, lengths, table)), **kw)
    tp = torch.tensor(pages)
    got = ops.paged_attention(torch.tensor(q), tp, tp, torch.tensor(lengths),
                              torch.tensor(table), scale=12 ** -0.5, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not int8:
        split = ops.paged_attention_split_reference(
            torch.tensor(q), tp, tp, torch.tensor(lengths),
            torch.tensor(table), 2, 16, scale=12 ** -0.5)
        np.testing.assert_allclose(split.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,rows,pps,want_splits,want_keys", [
    (8, 16, 128, 16, 128),      # MLA decode: 8 sequences of 16 heads
    (8, 4096, 128, 1, 2048),    # its prefill chunk: 256 tokens x 16 heads
    (4, 128, 128, 16, 128),     # DeepSeek-V2's 128 heads at decode
    (8, 16, 8, 1, 128),         # a table of 128 positions
])
def test_latent_split_plan(b, rows, pps, want_splits, want_keys):
    """The latent option's split plan from shapes alone: tiles of 16 rows
    (32 past 16), ranges of at least LATENT_MIN_SPLIT_KEYS keys."""
    pa = importlib.import_module("np_modeling_tpu_torch.ops.paged_attention")
    assert pa.split_plan(b, 1, rows, pa.LATENT_DIM, pps, 16, 132) == (
        want_splits, want_keys)


# ---- the serving engine on latent pages, against JAX's ---------------------

def _engines(weights, **kw):
    jgpt, params, tgpt = weights
    base = dict(total_pages=32, page_size=8)
    base.update(kw)
    jkw, tkw = dict(base), dict(base)
    if "kv_dtype" in kw:
        jkw["kv_dtype"] = jnp.bfloat16
    return JaxEngine(jgpt, params, **jkw), GenerationEngine(tgpt, **tkw)


def _run(eng, prompt, steps, as_jax=False):
    p = jnp.asarray(prompt) if as_jax else prompt
    return [eng.add_request(0, p)] + [eng.step()[0] for _ in range(steps)]


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk_size=256), dict(prefill_chunk_size=4),
    dict(kv_dtype=torch.bfloat16), dict(quantize_kv=True)],
    ids=["chunk256", "chunk4", "bf16_pages", "int8_pages"])
def test_engine_latent_pages_vs_jax(weights, kw):
    """Latent pages: one shared head of rank + rope, no v_pages (one scale
    set with int8 pages); tokens equal JAX's engine's (and, fp32, the port's
    own generate) for 8 steps; every page home after finish."""
    jeng, teng = _engines(weights, **kw)
    st = teng._state
    assert st["k_pages"][0].shape == (1, 32, 8, 20) and "v_pages" not in st
    assert ("k_scales" in st) == bool(kw.get("quantize_kv"))
    assert "v_scales" not in st
    free0 = teng.free_pages
    prompt = rng.integers(0, V, 11)
    got = _run(teng, prompt, 7)
    assert got == _run(jeng, prompt, 7, as_jax=True)
    if len(kw) == 1 and "prefill_chunk_size" in kw:
        gen = weights[2].generate(torch.tensor(prompt)[None], steps=8)
        assert got == gen[0].tolist()
    teng.finish(0)
    assert teng.free_pages == free0


def _joins_and_leaves(eng, p1, p2, wrap):
    """test_mla.py's traffic: 1 joins, steps, 2 joins, three steps, 2
    leaves, a step. Returns the two token streams."""
    g1, g2 = [eng.add_request(1, wrap(p1))], []
    g1.append(eng.step()[1])
    g2.append(eng.add_request(2, wrap(p2)))
    for _ in range(3):
        out = eng.step()
        g1.append(out[1])
        g2.append(out[2])
    eng.finish(2)
    g1.append(eng.step()[1])
    return g1, g2


def test_engine_continuous_batching_vs_jax(weights):
    """Sequences join and leave between steps: per-slot latent isolation,
    tokens equal to JAX's engine's and to each prompt's own generate."""
    jeng, teng = _engines(weights)
    p1, p2 = rng.integers(0, V, 9), rng.integers(0, V, 5)
    got = _joins_and_leaves(teng, p1, p2, lambda a: a)
    assert got == _joins_and_leaves(jeng, p1, p2, jnp.asarray)
    tgpt = weights[2]
    assert got[0] == tgpt.generate(torch.tensor(p1)[None], steps=6)[0].tolist()
    assert got[1] == tgpt.generate(torch.tensor(p2)[None], steps=4)[0].tolist()


def test_engine_requires_chunked_prefill(weights):
    with pytest.raises(ValueError, match="chunked"):
        GenerationEngine(weights[2], total_pages=8, page_size=4,
                         prefill_chunk_size=None)


def test_engine_fork_vs_jax(weights):
    """fork on latent pages: the child shares the full pages and copies the
    tail page (k_pages only); greedy twins equal the parent and JAX's, and
    every page comes home."""
    jeng, teng = _engines(weights, max_seqs=4)
    free0 = teng.free_pages
    prompt = rng.integers(0, V, 13)
    assert teng.add_request(0, prompt) == jeng.add_request(
        0, jnp.asarray(prompt))
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


def test_engine_prefix_cache_vs_jax(weights):
    """Prompts sharing a prefix on latent pages: tokens, prefix_cache_stats
    and free pages equal JAX's at every turn."""
    jeng, teng = _engines(weights, prefill_chunk_size=4,
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


# ---- phase (B)'s configuration against the JAX package's mapping -----------

# deepseek-ai/DeepSeek-V2-Lite's config.json (its architecture fields).
V2_LITE_HF = dict(vocab_size=102400, hidden_size=2048, intermediate_size=10944,
                  moe_intermediate_size=1408, num_hidden_layers=27,
                  num_attention_heads=16, num_key_value_heads=16,
                  n_shared_experts=2, n_routed_experts=64,
                  routed_scaling_factor=1.0, kv_lora_rank=512,
                  q_lora_rank=None, qk_rope_head_dim=64, v_head_dim=128,
                  qk_nope_head_dim=128, topk_method="greedy",
                  num_experts_per_tok=6, norm_topk_prob=False,
                  max_position_embeddings=163840, rms_norm_eps=1e-6,
                  rope_theta=10000.0, tie_word_embeddings=False,
                  rope_scaling={"type": "yarn", "factor": 40,
                                "beta_fast": 32, "beta_slow": 1,
                                "mscale": 0.707, "mscale_all_dim": 0.707,
                                "original_max_position_embeddings": 4096})


def _v2_lite_jax_config(first_k_dense_replace, moe):
    """What the JAX package's hf_compat (llama_config, _rope_scaling_tuple,
    import_deepseek_v2's MLA fields, and with ``moe`` its MoE fields,
    hf_compat.py:1486-1497) makes of the published config."""
    transformers = pytest.importorskip("transformers")
    from np_modeling_tpu.utils import hf_compat
    hc = transformers.DeepseekV2Config(
        **V2_LITE_HF, first_k_dense_replace=first_k_dense_replace)
    kw = dict(ffn="swiglu", tie_embeddings=bool(hc.tie_word_embeddings),
              mla=dict(kv_lora_rank=hc.kv_lora_rank,
                       q_lora_rank=hc.q_lora_rank,
                       qk_nope_head_dim=hc.qk_nope_head_dim,
                       qk_rope_head_dim=hc.qk_rope_head_dim,
                       v_head_dim=hc.v_head_dim))
    if moe:
        kw.update(moe_experts=hc.n_routed_experts,
                  moe_top_k=hc.num_experts_per_tok, moe_capacity_factor=None,
                  moe_router_weights="softmax",
                  moe_routed_scaling=float(hc.routed_scaling_factor),
                  moe_shared_units=(hc.moe_intermediate_size
                                    * (hc.n_shared_experts or 0)),
                  moe_hidden_units=hc.moe_intermediate_size,
                  moe_first_dense=hc.first_k_dense_replace,
                  moe_router_groups=None)
    jcfg = hf_compat.llama_config(hc, **kw)
    assert jcfg.rope_scaling == ("yarn", 40.0, 32.0, 1.0, 4096.0, 1.0)
    return hc, jcfg


def _differ(tcfg, jcfg):
    want, got = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert set(got) == set(want)
    return {k: (got[k], want[k]) for k in got if got[k] != want[k]}


def test_phase_b_config_is_the_jax_mapping_of_v2_lite():
    """chip_smoke's dense-cut DeepSeek-V2-Lite config, phase (C)'s, equals
    what the JAX package's hf_compat makes of the published config with
    every layer dense (first_k_dense_replace=27), except the cuts it states:
    no MoE fields (every layer is the dense first-layer FFN) and max_len."""
    import chip_smoke
    hc, jcfg = _v2_lite_jax_config(27, moe=False)
    assert hc.first_k_dense_replace == jcfg.num_layers == 27
    tcfg = chip_smoke.deepseek_v2_lite_dense_config()
    differ = _differ(tcfg, jcfg)
    assert set(differ) == {"max_len"}, differ
    assert tcfg.max_len == chip_smoke.DSV2_MAX_LEN < jcfg.max_len
    big = tmodels.GPT(tcfg, device="meta")
    n = sum(p.numel() for p in big.parameters())
    assert 2.60e9 < n < 2.62e9


def test_phase_b_moe_config_is_the_jax_mapping_of_v2_lite():
    """Phase (B)'s DeepSeek-V2-Lite config equals import_deepseek_v2's
    mapping of the published config (first_k_dense_replace=1, the MoE
    fields through llama_config) except max_len, and has
    chip_smoke.DSV2_PARAMS = 15,706,484,224 parameters, counted on the
    meta device."""
    import chip_smoke
    hc, jcfg = _v2_lite_jax_config(1, moe=True)
    tcfg = chip_smoke.deepseek_v2_lite_config()
    differ = _differ(tcfg, jcfg)
    assert set(differ) == {"max_len"}, differ
    assert tcfg.max_len == chip_smoke.DSV2_MAX_LEN < jcfg.max_len
    assert (tcfg.moe_experts, tcfg.moe_top_k, tcfg.moe_first_dense) == (
        64, 6, 1)
    big = tmodels.GPT(tcfg, device="meta")
    assert not big.layer_0.moe_experts and big.layer_26.moe_experts == 64
    n = sum(p.numel() for p in big.parameters())
    assert n == chip_smoke.DSV2_PARAMS == 15_706_484_224
