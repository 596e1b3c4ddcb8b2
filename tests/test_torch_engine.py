"""The PyTorch port's GenerationEngine against the JAX engine, on the CPU.

Same weights (carried across by utils.convert.params_from_numpy), same
traffic: batched chunked prefill of ragged prompts longer than one chunk,
step, step_many, a mid-stream join and a finish. fp32 throughout: greedy
tokens must be identical and the last step's logits agree to atol 1e-4
(the two frameworks sum in different orders). The weights come from the
port's ``init`` (eager JAX init traced the model op by op), and the JAX
engine's step with its logits runs compiled (``_jax_logits_step``).
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
from np_modeling_tpu_torch.utils import params_from_numpy, params_to_numpy

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2,
           num_layers=2, hidden_units=64, max_len=64, activation="gelu",
           ln_eps=1e-5)
ENGINE = dict(total_pages=64, page_size=4, max_seqs=4, prefill_chunk_size=8)


def _tree(cfg, seed=0):
    """Seeded weights of a GPT of ``cfg`` as the JAX tree (numpy), from the
    port's init (JAX's distributions)."""
    return params_to_numpy(tmodels.GPT(tmodels.GPTConfig(**cfg),
                                       device="cpu").init(
        torch.Generator().manual_seed(seed)))


def _jax_logits_step(jeng):
    """The JAX engine's device step with its logits, compiled (eagerly it
    traces the whole model op by op). Its new state becomes the engine's,
    as the eager call's writes into the state dict make it."""
    step = jax.jit(jeng._device_step, static_argnames="return_logits")
    jeng._state, tok, logits = step(jeng._state, jeng._serve_params,
                                    jax.random.PRNGKey(0), return_logits=True)
    return jeng._state, tok, logits


def _pair(seed=0):
    jgpt = jmodels.GPT(jmodels.GPTConfig(**CFG))
    tree = _tree(CFG, seed)
    tgpt = params_from_numpy(tree, tmodels.GPTConfig(**CFG), device="cpu")
    return (JaxEngine(jgpt, jax.tree_util.tree_map(jnp.asarray, tree),
                      **ENGINE),
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
    _, j_tok, j_logits = _jax_logits_step(jeng)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    active = np.asarray(jeng._state["active"])
    np.testing.assert_allclose(t_logits.numpy()[active],
                               np.asarray(j_logits)[active], rtol=0,
                               atol=1e-4)

    for sid in teng.live:
        teng.finish(sid)
    assert teng.free_pages == ENGINE["total_pages"] - 1 and teng.live == []


def test_out_of_pages_is_all_or_nothing():
    gpt = tmodels.GPT(tmodels.GPTConfig(**CFG), device="cpu").init(
        torch.Generator())
    teng = GenerationEngine(gpt, **{**ENGINE, "total_pages": 24})
    free0 = teng.free_pages                     # 23: room for 92 tokens
    with pytest.raises(OutOfPagesError):
        teng.add_requests({i: np.zeros(30, np.int32) for i in range(4)})
    assert teng.free_pages == free0 and teng.live == []
    teng.add_requests({0: np.zeros(30, np.int32)})
    with pytest.raises(OutOfPagesError):        # needs 16 pages, 15 free
        teng.add_requests({1: np.zeros(62, np.int32)})
    assert teng.free_pages == free0 - 8 and teng.live == [0]


def _refusals():
    """(engine options, a call on the engine or None, the error): ``mesh``,
    the one option not ported, and the JAX engine's own refusals."""
    from np_modeling_tpu_torch.serving.constrain import dfa_from_choices
    dfa = dfa_from_choices([[1, 2]], CFG["vocab_size"], 0)
    return [
        (dict(mesh=object()), None, NotImplementedError),
        (dict(constraints={"c": dfa}, draft="self"), None, ValueError),
        (dict(enable_prefix_cache=True, draft="self"), None, ValueError),
        (dict(per_request_sampling=True, draft="self"), None, ValueError),
        (dict(lora_adapters={"a": "lora"}),
         lambda eng: eng.add_request(0, [1, 2, 3], adapter="b"), ValueError),
        (dict(constraints={"c": dfa}),
         lambda eng: eng.add_request(0, [1, 2, 3], constraint="d"),
         ValueError)]


@pytest.mark.parametrize("case", range(6))
def test_unported_engine_options_raise(case):
    """``mesh`` raises NotImplementedError; the JAX engine's asserts raise
    ValueError: constraints, the prefix cache or per-request sampling with
    a draft lane, an unknown adapter, an unknown constraint."""
    from np_modeling_tpu_torch.training.lora import lora_init
    option, call, error = _refusals()[case]
    gpt = tmodels.GPT(tmodels.GPTConfig(**CFG), device="cpu").init(
        torch.Generator())
    if option.pop("draft", None):
        option["draft_gpt"] = gpt
    if option.get("lora_adapters"):
        option["lora_adapters"] = {"a": lora_init(torch.Generator(), gpt, 2)}
    with pytest.raises(error, match=None if call is None else "unknown"):
        eng = GenerationEngine(gpt, **{**ENGINE, **option})
        call(eng)


@pytest.mark.parametrize("feature", [
    dict(norm_first=False), dict(lm_head_bias=True), dict(qk_norm=True),
    dict(parallel_residual=True), dict(activation="silu"),
    dict(rope_scaling=("linear", 2.0))])
def test_unported_config_features_raise(feature):
    with pytest.raises(NotImplementedError):
        tmodels.GPT(tmodels.GPTConfig(**{**CFG, **feature}), device="cpu")


@pytest.mark.parametrize("feature", [
    dict(positional="rope"), dict(norm="rms"), dict(ffn="swiglu"),
    dict(attention_window=8), dict(attn_logit_softcap=30.0),
    dict(sandwich_norm=True)])
def test_ported_config_features_match_jax(feature):
    """Each feature Gemma-2 brought, alone on the GPT-2-shaped CFG: the
    port builds it and its GPT.apply logits equal JAX's on the same weights
    (fp32, rtol 1e-5 / atol 2e-5) over 24 tokens, past the window of 8."""
    cfg = {**CFG, **feature}
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg))
    tree = _tree(cfg, 1)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tgpt = params_from_numpy(tree, tmodels.GPTConfig(**cfg), device="cpu")
    toks = np.random.default_rng(1).integers(0, 64, (2, 24))
    want = jax.jit(jgpt.apply)(params, jnp.asarray(toks))
    with torch.no_grad():
        got = tgpt.apply(torch.tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("entry", ["GPT", "params_from_numpy",
                                   "prefetch_to_device"])
def test_entry_points_default_to_the_card(entry):
    """With ``device=None`` the port's entry points place their tensors on
    the card, as JAX places arrays on its default backend. Without a card
    that fails loudly, as torch's own CUDA allocation does (AssertionError
    on a CPU-only build, RuntimeError where no card is usable); nothing
    falls back to the CPU."""
    from np_modeling_tpu_torch.training import data
    from np_modeling_tpu_torch.utils import params_to_numpy
    cfg = tmodels.GPTConfig(**CFG)
    tree = params_to_numpy(tmodels.GPT(cfg, device="cpu").init(
        torch.Generator()))
    make = {"GPT": lambda: next(tmodels.GPT(cfg).parameters()),
            "params_from_numpy": lambda: next(
                params_from_numpy(tree, cfg).parameters()),
            "prefetch_to_device": lambda: next(data.prefetch_to_device(
                iter([np.zeros(3, np.int64)])))}[entry]
    if torch.cuda.is_available():
        assert make().is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()


def test_import_leaves_no_jax():
    code = ("import sys, np_modeling_tpu_torch, chip_smoke; "
            "assert not [m for m in sys.modules if m in ('jax', "
            "'np_modeling_tpu') or m.startswith(('jax.', 'jaxlib', "
            "'np_modeling_tpu.'))], sorted(sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parents[1])


# ---- quantized serving: int8 FFN weights, int8 KV pages ------------------------

QCFG = dict(vocab_size=128, d_model=64, num_heads=4, num_layers=2,
            hidden_units=256, max_len=64, activation="gelu", ln_eps=1e-5)
FFN = r".*(dense1/linear/w|dense2/w)$"


def _quantized_pair(dtype):
    """JAX and port engines with quantize_kv=True over one int8-FFN tree."""
    from np_modeling_tpu.ops import quantize_params_int8
    jgpt = jmodels.GPT(jmodels.GPTConfig(**QCFG, dtype=getattr(jnp, dtype)))
    params = jax.tree_util.tree_map(jnp.asarray, _tree(QCFG, 1))
    tree = jax.tree_util.tree_map(
        np.asarray, quantize_params_int8(params, match=FFN))
    tgpt = params_from_numpy(
        tree, tmodels.GPTConfig(**QCFG, dtype=getattr(torch, dtype)),
        device="cpu")
    return (JaxEngine(jgpt, jax.tree_util.tree_map(jnp.asarray, tree),
                      quantize_kv=True, **ENGINE),
            GenerationEngine(tgpt, quantize_kv=True, **ENGINE), tree)


def _traffic(eng, prompts, late, jax_side):
    wrap = (lambda a: jnp.asarray(a)) if jax_side else (lambda a: a)
    out = [eng.add_requests({k: wrap(v) for k, v in prompts.items()}),
           eng.step(), eng.step_many(3), eng.add_request(3, wrap(late)),
           eng.step()]
    eng.finish(1)
    out += [eng.step_many(2), eng.live, eng.free_pages]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_engine_matches_jax_engine(dtype):
    rng = np.random.default_rng(4)
    prompts = {sid: rng.integers(0, 128, n).astype(np.int32)
               for sid, n in ((0, 11), (1, 19), (2, 5))}
    late = rng.integers(0, 128, 13).astype(np.int32)
    jeng, teng, _ = _quantized_pair(dtype)
    assert teng._state["k_pages"][0].dtype == torch.int8
    assert _traffic(teng, prompts, late, False) == _traffic(
        jeng, prompts, late, True)
    _, t_tok, t_logits = teng._device_step(teng._state, return_logits=True)
    _, j_tok, j_logits = _jax_logits_step(jeng)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    if dtype == "float32":      # bf16: the two round K at other places
        for key in ("k_scales", "v_scales"):
            np.testing.assert_allclose(teng._state[key][1].numpy(),
                                       np.asarray(jeng._state[key][1]),
                                       rtol=1e-5, atol=1e-7)
        active = np.asarray(jeng._state["active"])
        np.testing.assert_allclose(t_logits.numpy()[active],
                                   np.asarray(j_logits)[active], rtol=1e-5,
                                   atol=1e-4)


def test_int8_ffn_engine_equals_dequantized_weights():
    """The port's counterpart of tests/test_int8_matmul.py's decode test:
    int8 FFN weights through ops.int8_matmul give the greedy tokens of the
    same engine with dequantize_params-restored (bf16-valued) weights."""
    from np_modeling_tpu_torch.ops import dequantize_params
    _, teng, tree = _quantized_pair("float32")
    deq = jax.tree_util.tree_map(
        lambda t: np.asarray(t.float()) if isinstance(t, torch.Tensor) else t,
        dequantize_params(tree))
    deng = GenerationEngine(
        params_from_numpy(deq, tmodels.GPTConfig(**QCFG), device="cpu"),
        quantize_kv=True, **ENGINE)
    rng = np.random.default_rng(5)
    prompts = {sid: rng.integers(0, 128, n).astype(np.int32)
               for sid, n in ((0, 9), (1, 17))}
    assert teng.add_requests(prompts) == deng.add_requests(prompts)
    assert teng.step_many(6) == deng.step_many(6)


def test_quantized_attention_leaf_raises():
    from np_modeling_tpu_torch.ops import quantize_params_int8
    from np_modeling_tpu_torch.utils import params_to_numpy
    gpt = tmodels.GPT(tmodels.GPTConfig(**QCFG), device="cpu").init(
        torch.Generator())
    tree = quantize_params_int8(params_to_numpy(gpt))   # wq/wk/wv/wo too
    with pytest.raises(NotImplementedError, match="F4"):
        params_from_numpy(tree, tmodels.GPTConfig(**QCFG), device="cpu")
