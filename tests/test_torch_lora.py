"""LoRA adapters of the PyTorch port against the JAX package, on the CPU:
``training.lora`` (init shapes, merge and finalize, the fine-tune step's
adapter gradients against ``jax.grad`` and three adam steps) and the
engine's multi-LoRA serving (two adapters and the base in one dispatch,
chunked against dense prefill, fork and slot reuse, speculative decoding
with adapters), token for token JAX's engine.

The JAX LoRA tests' tiny GPTs (tests/test_lora.py, tests/test_engine_lora.py)
hold the port's seeded weights in both packages; adapters are the port's
``lora_init`` with B drawn nonzero, carried to JAX by
``utils.adapters_to_numpy``. fp32 throughout: logits, merged weights and
gradients at rtol 1e-5 / atol 2e-5, tokens equal; JAX runs compiled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu import training as jtraining
from np_modeling_tpu.serving import GenerationEngine as JaxEngine
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import training
from np_modeling_tpu_torch.serving import GenerationEngine
from np_modeling_tpu_torch.training.lora import (ALL_LINEAR_TARGETS,
                                                 ATTENTION_TARGETS,
                                                 lora_finalize, lora_init,
                                                 lora_merge, lora_params,
                                                 lora_value_and_grad,
                                                 make_lora_train_step)
from np_modeling_tpu_torch.utils import (adapters_from_numpy,
                                         adapters_to_numpy, params_from_numpy,
                                         params_to_numpy)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-5)

LORA_CFG = dict(vocab_size=67, d_model=32, num_heads=4, num_layers=2,
                hidden_units=64, max_len=32)
ENGINE_CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2,
                  hidden_units=64, max_len=128)
ENGINE = dict(total_pages=96, page_size=8)


def _pair(cfg, seed=0):
    tree = params_to_numpy(tmodels.GPT(tmodels.GPTConfig(**cfg),
                                       device="cpu").init(
        torch.Generator().manual_seed(seed)))
    return (jmodels.GPT(jmodels.GPTConfig(**cfg)),
            jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, tmodels.GPTConfig(**cfg), device="cpu"))


def _adapter(gpt, seed, rank=4, match=ATTENTION_TARGETS, b_scale=0.3):
    """lora_init's adapters with B drawn nonzero (an identity adapter would
    test nothing)."""
    g = torch.Generator().manual_seed(seed)
    ad = lora_init(g, gpt, rank, match)
    for pair in ad.values():
        pair["b"] = b_scale * torch.randn(pair["b"].shape, generator=g)
    return ad


def _jax_adapter(ad):
    return jax.tree_util.tree_map(jnp.asarray, adapters_to_numpy(ad))


@pytest.fixture(scope="module")
def lora_models():
    return _pair(LORA_CFG)


@pytest.fixture(scope="module")
def engine_models():
    jgpt, jparams, tgpt = _pair(ENGINE_CFG)
    adapters = {"alpha": _adapter(tgpt, 1), "beta": _adapter(tgpt, 2)}
    return jgpt, jparams, tgpt, adapters


def test_adapter_tree_shapes(lora_models):
    _, _, tgpt = lora_models
    ad = lora_init(torch.Generator(), tgpt, 4)
    assert len(ad) == 8 and all(k.endswith(("wq", "wk", "wv", "wo"))
                                for k in ad)
    wq = ad["layer_0/self_attention/wq"]
    assert wq["a"].shape == (32, 4) and wq["b"].shape == (4, 4, 8)
    assert not wq["b"].any()
    assert len(lora_init(torch.Generator(), tgpt, 2,
                         ALL_LINEAR_TARGETS)) == 12
    swiglu = tmodels.GPT(tmodels.GPTConfig(
        **LORA_CFG, ffn="swiglu", norm="rms", use_bias=False,
        positional="rope"), device="cpu")
    big = lora_init(torch.Generator(), swiglu, 2, ALL_LINEAR_TARGETS)
    assert len(big) == 14 and "layer_1/swiglu/w_down" in big
    a = torch.cat([p["a"].reshape(-1) for p in ad.values()])
    assert abs(float(a.std()) - 0.5) < 0.1      # N(0, 1/rank)


def test_merge_and_finalize_vs_jax(lora_models):
    jgpt, jparams, tgpt = lora_models
    ad = _adapter(tgpt, 4, match=ALL_LINEAR_TARGETS)
    jad = _jax_adapter(ad)
    want = jax.jit(lambda p, a: jtraining.lora_merge(p, a, alpha=8.0))(
        jparams, jad)
    got = lora_merge(tgpt, ad, alpha=8.0)
    assert len(got) == len(ad)
    for name, t in got.items():
        leaf = want
        for k in name.split("."):
            leaf = leaf[k]
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(leaf),
                                   **TOL)
    toks = np.random.default_rng(0).integers(0, 67, (4, 16))
    baked = lora_finalize(tgpt, ad, alpha=8.0)
    jwant = jax.jit(jgpt.apply)(jtraining.lora_finalize(jparams, jad, 8.0),
                                jnp.asarray(toks))
    with torch.no_grad():
        logits = baked.apply(torch.tensor(toks))
        base = tgpt.apply(torch.tensor(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jwant), **TOL)
    assert not np.allclose(logits.numpy(), base.numpy(), atol=1e-4)
    # An identity adapter leaves the model as it was.
    zero = lora_init(torch.Generator(), tgpt, 4)
    for name, t in lora_merge(tgpt, zero).items():
        assert torch.equal(t, dict(tgpt.named_parameters())[name])


def test_finetune_grads_and_steps_vs_jax(lora_models):
    """The adapters' loss and gradients against jax.value_and_grad of
    gpt.loss(lora_merge(base, lora)), then three adam steps on each side;
    the base weights stay bit-unchanged and get no gradient."""
    jgpt, jparams, tgpt = lora_models
    ad = _adapter(tgpt, 5, rank=8, match=ALL_LINEAR_TARGETS, b_scale=0.05)
    jad = _jax_adapter(ad)
    toks = np.random.default_rng(1).integers(0, 67, (4, 16))
    base = {n: p.detach().clone() for n, p in tgpt.named_parameters()}

    def jloss(lo, p):
        return jgpt.loss(jtraining.lora_merge(p, lo, alpha=16.0),
                         jnp.asarray(toks))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jad, jparams)
    loss, grads = lora_value_and_grad(tgpt, ad, torch.tensor(toks),
                                      alpha=16.0)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    for path, pair in grads.items():
        for k, g in pair.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(want[path][k]),
                                       **TOL, err_msg=f"{path}/{k}")

    opt, jopt = training.adam(5e-3), jtraining.adam(5e-3)
    state, jstate = opt.init(lora_params(ad)), jopt.init(jad)

    @jax.jit
    def jstep(lo, st):
        lval, g = jax.value_and_grad(jloss)(lo, jparams)
        upd, st = jopt.update(g, st, lo)
        return jtraining.apply_updates(lo, upd), st, lval

    step = make_lora_train_step(tgpt, opt, alpha=16.0)
    for _ in range(3):
        ad, state, loss = step(ad, state, torch.tensor(toks))
        jad, jstate, jl = jstep(jad, jstate)
        np.testing.assert_allclose(float(loss), float(jl), **TOL)
    for path, pair in adapters_to_numpy(ad).items():
        for k, v in pair.items():
            np.testing.assert_allclose(v, np.asarray(jad[path][k]), **TOL)
    for n, p in tgpt.named_parameters():
        assert torch.equal(p, base[n]) and p.grad is None, n


def test_finetune_with_dropout_lowers_the_loss(lora_models):
    """Ten steps at dropout 0.1 through the training flag: the loss falls
    and the base is untouched."""
    _, _, tgpt = lora_models
    gpt = tmodels.GPT(tmodels.GPTConfig(**LORA_CFG, drop_rate=0.1),
                      device="cpu")
    gpt.load_state_dict(tgpt.state_dict())
    ad = lora_init(torch.Generator().manual_seed(3), gpt, 8,
                   ALL_LINEAR_TARGETS)
    opt = training.adam(1e-2)
    state = opt.init(lora_params(ad))
    step = make_lora_train_step(gpt, opt)
    toks = torch.tensor(np.random.default_rng(2).integers(0, 67, (4, 16)))
    gen = torch.Generator().manual_seed(7)
    losses = [float(step(ad, state, toks, gen)[2]) for _ in range(10)]
    assert losses[-1] < losses[0] - 0.1, losses
    for (n, p), q in zip(gpt.named_parameters(), tgpt.parameters()):
        assert torch.equal(p, q), n


def test_adapter_round_trip(engine_models):
    _, _, _, adapters = engine_models
    ad = adapters["alpha"]
    back = adapters_from_numpy(adapters_to_numpy(ad), device="cpu")
    assert sorted(back) == sorted(ad)
    for path in ad:
        for k in ("a", "b"):
            assert torch.equal(back[path][k], ad[path][k])


def _jax_engine(jgpt, jparams, adapters, **kw):
    return JaxEngine(jgpt, jparams, lora_adapters={
        n: _jax_adapter(a) for n, a in adapters.items()}, **{**ENGINE, **kw})


def _plain_stream(gpt, prompt, n):
    eng = GenerationEngine(gpt, **ENGINE)
    return [eng.add_request(0, prompt)] + eng.step_many(n - 1)[0]


def test_two_adapters_one_dispatch_vs_jax(engine_models):
    """Two adapters and the base in one batch: each step's tokens equal the
    JAX engine's, and each stream a plain engine's over the adapter's
    baked weights."""
    jgpt, jparams, tgpt, adapters = engine_models
    rng = np.random.default_rng(11)
    prompts = {0: rng.integers(0, 64, 11), 1: rng.integers(0, 64, 17),
               2: rng.integers(0, 64, 9)}
    which = {0: "alpha", 1: "beta"}
    jeng = _jax_engine(jgpt, jparams, adapters)
    teng = GenerationEngine(tgpt, lora_adapters=adapters, **ENGINE)
    first = teng.add_requests(prompts, adapters=which)
    assert first == jeng.add_requests(
        {k: jnp.asarray(v) for k, v in prompts.items()}, adapters=which)
    got = {sid: [t] for sid, t in first.items()}
    for _ in range(3):
        out = teng.step()
        assert out == jeng.step()
        for sid, t in out.items():
            got[sid].append(t)
    out = teng.step_many(5)
    assert out == jeng.step_many(5)
    for sid, toks in out.items():
        got[sid] += toks
    for sid, p in prompts.items():
        model = (lora_finalize(tgpt, adapters[which[sid]]) if sid in which
                 else tgpt)
        assert got[sid] == _plain_stream(model, p, 9), sid


def test_adapter_chunked_prefill_matches_dense(engine_models):
    """Dense prefill over the merged weights and chunked prefill over the
    factored deltas give the same streams, on both packages."""
    jgpt, jparams, tgpt, adapters = engine_models
    prompt = np.random.default_rng(12).integers(0, 64, 19)
    streams = []
    for chunk in (None, 8):
        teng = GenerationEngine(tgpt, lora_adapters=adapters,
                                **{**ENGINE, "prefill_chunk_size": chunk})
        jeng = _jax_engine(jgpt, jparams, adapters, prefill_chunk_size=chunk)
        got = [teng.add_request(0, prompt, adapter="alpha")]
        assert got == [jeng.add_request(0, jnp.asarray(prompt),
                                        adapter="alpha")]
        out = teng.step_many(6)
        assert out == jeng.step_many(6)
        streams.append(got + out[0])
    assert streams[0] == streams[1]


def test_fork_inherits_and_reuse_resets_adapter(engine_models):
    jgpt, jparams, tgpt, adapters = engine_models
    rng = np.random.default_rng(13)
    p1, p2 = rng.integers(0, 64, 13), rng.integers(0, 64, 9)
    jeng = _jax_engine(jgpt, jparams, adapters)
    teng = GenerationEngine(tgpt, lora_adapters=adapters, **ENGINE)
    got = [teng.add_request(0, p1, adapter="beta")]
    assert got == [jeng.add_request(0, jnp.asarray(p1), adapter="beta")]
    out = teng.step_many(3)
    assert out == jeng.step_many(3)
    got += out[0]
    teng.fork(0, 1)
    jeng.fork(0, 1)
    out = teng.step_many(6)
    assert out == jeng.step_many(6) and out[0] == out[1]
    got += out[0]
    assert got == _plain_stream(lora_finalize(tgpt, adapters["beta"]), p1,
                                10)
    for eng in (teng, jeng):
        eng.finish(0)
        eng.finish(1)
    first = teng.add_request(2, p2)          # reuses slot 0, no adapter
    assert first == jeng.add_request(2, jnp.asarray(p2))
    out = teng.step_many(5)
    assert out == jeng.step_many(5)
    assert [first] + out[2] == _plain_stream(tgpt, p2, 6)


def test_speculative_with_adapters_vs_jax(engine_models):
    """The adapted target verifies an unadapted draft's proposals: the
    rounds equal JAX's and the stream the baked model's greedy one."""
    jgpt, jparams, tgpt, adapters = engine_models
    dcfg = dict(vocab_size=64, d_model=16, num_heads=2, num_layers=1,
                hidden_units=32, max_len=128)
    jdraft, jdparams, tdraft = _pair(dcfg, 5)
    prompt = np.random.default_rng(14).integers(0, 64, 10)
    jeng = _jax_engine(jgpt, jparams, adapters, draft_gpt=jdraft,
                       draft_params=jdparams)
    teng = GenerationEngine(tgpt, lora_adapters=adapters, draft_gpt=tdraft,
                            **ENGINE)
    got = [teng.add_request(0, prompt, adapter="alpha")]
    assert got == [jeng.add_request(0, jnp.asarray(prompt), adapter="alpha")]
    while len(got) < 11:
        out = teng.step_speculative(2)
        assert out == jeng.step_speculative(2)
        got += out[0]
    assert got == _plain_stream(lora_finalize(tgpt, adapters["alpha"]),
                                prompt, len(got))
