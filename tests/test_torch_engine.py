"""The PyTorch port's GenerationEngine against the JAX engine, on the CPU.

Same weights (carried across by utils.convert.params_from_numpy), same
traffic: batched chunked prefill of ragged prompts longer than one chunk,
step, step_many, a mid-stream join and a finish. fp32 throughout: greedy
tokens must be identical and the last step's logits agree to atol 1e-4
(the two frameworks sum in different orders).
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu.serving import GenerationEngine as JaxEngine
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch.serving import GenerationEngine, OutOfPagesError
from np_modeling_tpu_torch.utils import params_from_numpy

CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2,
           num_layers=2, hidden_units=64, max_len=64, activation="gelu",
           ln_eps=1e-5)
ENGINE = dict(total_pages=64, page_size=4, max_seqs=4, prefill_chunk_size=8)


def _pair(seed=0):
    jgpt = jmodels.GPT(jmodels.GPTConfig(**CFG))
    params = jgpt.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tgpt = params_from_numpy(tree, tmodels.GPTConfig(**CFG), device="cpu")
    return (JaxEngine(jgpt, params, **ENGINE),
            GenerationEngine(tgpt, **ENGINE))


def test_engine_matches_jax_engine():
    rng = np.random.default_rng(0)
    prompts = {sid: rng.integers(0, 64, n).astype(np.int32)
               for sid, n in ((0, 11), (1, 19), (2, 5))}
    jeng, teng = _pair()

    assert teng.add_requests(prompts) == jeng.add_requests(
        {k: jnp.asarray(v) for k, v in prompts.items()})
    assert teng.free_pages == jeng.free_pages
    assert teng.step() == jeng.step()
    assert teng.step_many(3) == jeng.step_many(3)
    late = rng.integers(0, 64, 13).astype(np.int32)
    assert teng.add_request(3, late) == jeng.add_request(3, jnp.asarray(late))
    assert teng.step() == jeng.step()
    teng.finish(1)
    jeng.finish(1)
    assert teng.live == jeng.live == [0, 2, 3]
    assert teng.free_pages == jeng.free_pages
    assert teng.step_many(2) == jeng.step_many(2)
    assert teng.capacity(3) == jeng.capacity(3)

    _, t_tok, t_logits = teng._device_step(teng._state, return_logits=True)
    _, j_tok, j_logits = jeng._device_step(
        jeng._state, jeng._serve_params, jax.random.PRNGKey(0),
        return_logits=True)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    active = np.asarray(jeng._state["active"])
    np.testing.assert_allclose(t_logits.numpy()[active],
                               np.asarray(j_logits)[active], rtol=0,
                               atol=1e-4)

    for sid in teng.live:
        teng.finish(sid)
    assert teng.free_pages == ENGINE["total_pages"] - 1 and teng.live == []


def test_out_of_pages_is_all_or_nothing():
    gpt = tmodels.GPT(tmodels.GPTConfig(**CFG)).init(torch.Generator())
    teng = GenerationEngine(gpt, **{**ENGINE, "total_pages": 24})
    free0 = teng.free_pages                     # 23: room for 92 tokens
    with pytest.raises(OutOfPagesError):
        teng.add_requests({i: np.zeros(30, np.int32) for i in range(4)})
    assert teng.free_pages == free0 and teng.live == []
    teng.add_requests({0: np.zeros(30, np.int32)})
    with pytest.raises(OutOfPagesError):        # needs 16 pages, 15 free
        teng.add_requests({1: np.zeros(62, np.int32)})
    assert teng.free_pages == free0 - 8 and teng.live == [0]


@pytest.mark.parametrize("option", [
    dict(temperature=0.7), dict(enable_prefix_cache=True),
    dict(quantize_kv=True), dict(prefill_chunk_size=None),
    dict(constraints={}), dict(lora_adapters={})])
def test_unported_engine_options_raise(option):
    gpt = tmodels.GPT(tmodels.GPTConfig(**CFG))
    with pytest.raises(NotImplementedError):
        GenerationEngine(gpt, **{**ENGINE, **option})


@pytest.mark.parametrize("feature", [
    dict(positional="rope"), dict(norm="rms"), dict(ffn="swiglu"),
    dict(moe_experts=4), dict(attention_window=8),
    dict(attn_logit_softcap=30.0), dict(attn_sinks=True),
    dict(qk_norm=True), dict(parallel_residual=True),
    dict(sandwich_norm=True), dict(scan_layers=True)])
def test_unported_config_features_raise(feature):
    with pytest.raises(NotImplementedError):
        tmodels.GPT(tmodels.GPTConfig(**{**CFG, **feature}))


def test_import_leaves_no_jax():
    code = ("import sys, np_modeling_tpu_torch; "
            "assert not [m for m in sys.modules if m in ('jax', "
            "'np_modeling_tpu') or m.startswith(('jax.', 'jaxlib', "
            "'np_modeling_tpu.'))], sorted(sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
