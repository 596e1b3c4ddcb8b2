"""Gemma-2 in the port against the JAX package, on the CPU.

Gemma-2 needs RMSNorm with the ``gamma + 1`` offset, RoPE on interleaved
pairs, a gelu-gated FFN, sandwich norms, the embedding scale, sliding
windows that alternate by layer, the attention and final logit softcaps
and ``query_pre_attn_scalar``. Each op (forward and hand-written backward),
one block (local and global), ``GPT.apply``/``GPT.loss`` with every
gradient, three steps of the training entry point's recipe and the serving
engine's greedy tokens and logits go through both
packages on the same numpy inputs and weights (``params_from_numpy``), on a
small Gemma-2-shaped config: vocab 256, d 64, 4 layers, 4 heads over 2 kv
heads of 32, FFN 128, window 8 on even layers, caps 2.0 and 3.0 (they bite
at this width; 50/30, Gemma-2's own, in a second case) and
``query_pre_attn_scalar`` 24 (not head_dim, so that the scale shows).
fp32 at rtol 1e-5 / atol 2e-5, the lone block's weight gradients at atol
5e-5 (on unit-size random inputs a post-norm rescales its sublayer's small
output to unit size, and its rounding with it); bf16 at the bound each test
states.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu import nn as jnn
from np_modeling_tpu import ops as jops
from np_modeling_tpu import training as jtraining
from np_modeling_tpu.serving import GenerationEngine as JaxEngine
from np_modeling_tpu.training import data as jdata
from np_modeling_tpu.training import schedules as jschedules
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import nn as tnn
from np_modeling_tpu_torch import ops, train_gpt
from np_modeling_tpu_torch.serving import GenerationEngine
from np_modeling_tpu_torch.utils import (params_from_numpy, params_to_numpy,
                                         tree_to_numpy)

TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-5, atol=5e-5)
CFG = dict(vocab_size=256, d_model=64, num_layers=4, num_heads=4,
           num_kv_heads=2, head_dim=32, hidden_units=128, max_len=64,
           positional="rope", norm="rms", ln_eps=1e-6, rms_offset=True,
           ffn="geglu", use_bias=False, embed_scale=True, sandwich_norm=True,
           attention_window=8, window_pattern=2, attn_logit_softcap=2.0,
           final_logit_softcap=3.0, query_pre_attn_scalar=24.0)
# google/gemma-2-2b's config.json as import_gemma2 maps it.
GEMMA2_2B = dict(vocab_size=256000, d_model=2304, num_layers=26, num_heads=8,
                 num_kv_heads=4, head_dim=256, hidden_units=9216,
                 max_len=8192, rope_base=10000.0, **{
                     k: CFG[k] for k in (
                         "positional", "norm", "ln_eps", "rms_offset", "ffn",
                         "use_bias", "embed_scale", "sandwich_norm",
                         "window_pattern")},
                 attention_window=4096, attn_logit_softcap=50.0,
                 final_logit_softcap=30.0, query_pre_attn_scalar=256.0)
SEQ = 40
rng = np.random.default_rng(0)


def _randn(*shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _vjp(f, args, ct):
    """``f(*args)`` and its vjp of ``ct``, as one compiled JAX function
    (eager JAX would trace the model op by op)."""
    def run(args, ct):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(ct)
    return jax.jit(run)(args, ct)


def _bf16_bound(got, want, bound):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= bound, err


# ---- the ops: rms_norm, apply_rope, silu -----------------------------------------

@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("shape", [(7, 64), (2, 5, 48)])
def test_rms_norm_vs_jax(shape, offset):
    """Forward and both gradients in fp32; the offset is the RMSNorm
    module's ``gamma + 1``."""
    x, gamma, dz = _randn(*shape), _randn(shape[-1], scale=0.3), _randn(*shape)
    jmod, params = jnn.RMSNorm(epsilon=1e-6, offset=offset), {"gamma": gamma}
    want, (dgamma, dx) = _vjp(jmod.apply, (params, jnp.asarray(x)),
                              jnp.asarray(dz))
    tmod = tnn.RMSNorm(shape[-1], 1e-6, offset)
    with torch.no_grad():
        tmod.gamma.copy_(torch.tensor(gamma))
    xt = torch.tensor(x, requires_grad=True)
    got = tmod(xt)
    got.backward(torch.tensor(dz))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **TOL)
    np.testing.assert_allclose(tmod.gamma.grad.numpy(),
                               np.asarray(dgamma["gamma"]), **TOL)


def test_rms_norm_bf16_vs_jax():
    """A bf16 x: statistics in bf16, the fp32 gamma promotes the output to
    fp32 in both packages; within 1e-2 of max(1, max |JAX|) (bf16's
    rsqrt and products round at other places)."""
    x, gamma = _randn(6, 64), 1 + _randn(64, scale=0.1)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = jops.rms_norm(xj, jnp.asarray(gamma), 1e-6)
    got = ops.rms_norm(torch.tensor(x).to(torch.bfloat16),
                       torch.tensor(gamma), 1e-6)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _bf16_bound(got, want, 1e-2)


@pytest.mark.parametrize("positions", ["row", "batch"])
@pytest.mark.parametrize("rope_dim", [None, 16])
def test_apply_rope_vs_jax(positions, rope_dim):
    """fp32 forward and the backward (the inverse rotation), positions [s]
    and [b, s], full and partial rotary."""
    x, dy = _randn(2, 3, 9, 32), _randn(2, 3, 9, 32)
    pos = (np.arange(9) + 5 if positions == "row"
           else rng.integers(0, 60, (2, 9))).astype(np.int32)
    want, (dx,) = _vjp(lambda x: jops.apply_rope(x, jnp.asarray(pos),
                                                 10000.0, rope_dim),
                       (jnp.asarray(x),), jnp.asarray(dy))
    xt = torch.tensor(x, requires_grad=True)
    got = ops.apply_rope(xt, torch.tensor(pos), 10000.0, rope_dim)
    got.backward(torch.tensor(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **TOL)


def test_apply_rope_bf16_rounds_once_and_scaling_raises():
    """bf16 x: fp32 angles, one rounding to bf16 in each package, so the
    two agree to one bf16 ulp (2^-7 relative). RoPE scaling raises."""
    x = _randn(1, 2, 16, 64)
    pos = np.arange(16, dtype=np.int32)
    want = jops.apply_rope(jnp.asarray(x).astype(jnp.bfloat16),
                           jnp.asarray(pos), 10000.0)
    got = ops.apply_rope(torch.tensor(x).to(torch.bfloat16),
                         torch.tensor(pos), 10000.0)
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    assert (np.abs(got.float().numpy() - w) <= 2.0 ** -7 * np.abs(w)
            + 1e-6).all()
    with pytest.raises(NotImplementedError):
        ops.apply_rope(torch.tensor(x), torch.tensor(pos),
                       scaling=("linear", 2.0))


def test_silu_vs_jax():
    x, dy = _randn(5, 33), _randn(5, 33)
    want, (dx,) = _vjp(jops.silu, (jnp.asarray(x),), jnp.asarray(dy))
    xt = torch.tensor(x, requires_grad=True)
    got = ops.silu(xt)
    got.backward(torch.tensor(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **TOL)


# ---- the model ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _base_tree():
    """JAX's init of CFG with every norm gain moved off its init value (a
    zero offset gamma would hide a wrong offset). The caps, the compute
    dtype and the loss form leave the parameters as they are, so every
    test's config shares them."""
    jgpt = jmodels.GPT(jmodels.GPTConfig(**CFG))
    params = jax.jit(lambda k: jgpt.init(k, jnp.zeros((1, 8), jnp.int32)))(
        jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.2 * r.standard_normal(a.shape).astype(
            np.float32) if a.ndim == 1 else 0.0), params)


def _tree(cfg):
    return jmodels.GPT(jmodels.GPTConfig(**cfg)), _base_tree()


def _pair(cfg):
    jgpt, tree = _tree(cfg)
    return jgpt, tree, params_from_numpy(tree, tmodels.GPTConfig(**cfg),
                                         device="cpu")


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("layer", [0, 1], ids=["local", "global"])
def test_block_vs_jax(layer):
    """One block, dense causal over 20 tokens (window 8 on the local
    layer), RoPE at positions 3..22, forward and every gradient."""
    jgpt, tree, tgpt = _pair(CFG)
    x, dy = _randn(2, 20, 64), _randn(2, 20, 64)
    pos = np.arange(3, 23, dtype=np.int32)
    blk = jgpt._block_for(layer)
    assert blk.window == (8 if layer == 0 else None)
    want, (dparams, dx) = _vjp(
        lambda p, x: blk.apply(p, x, positions=jnp.asarray(pos)),
        (_jtree(tree[f"layer_{layer}"]), jnp.asarray(x)), jnp.asarray(dy))
    tblk = getattr(tgpt, f"layer_{layer}")
    xt = torch.tensor(x, requires_grad=True)
    got = tblk(xt, positions=torch.tensor(pos))
    got.backward(torch.tensor(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **TOL)
    grads = tree_to_numpy({n: p.grad for n, p in tblk.named_parameters()})
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w),
                                                **GRAD_TOL),
        grads, jax.tree_util.tree_map(np.asarray, dparams))


@pytest.mark.parametrize("caps", [(2.0, 3.0), (50.0, 30.0)],
                         ids=["caps_bite", "gemma2_caps"])
def test_gpt_apply_and_loss_vs_jax(caps):
    """GPT.apply logits and GPT.loss with every gradient against
    jax.value_and_grad, 40 tokens (windows of 8 cut), fp32."""
    cfg = {**CFG, "attn_logit_softcap": caps[0],
           "final_logit_softcap": caps[1]}
    jgpt, tree, tgpt = _pair(cfg)
    toks = rng.integers(0, 256, (2, SEQ))
    jp = _jtree(tree)
    want = jax.jit(jgpt.apply)(jp, jnp.asarray(toks))
    got = tgpt.apply(torch.tensor(toks))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert np.abs(np.asarray(want)).max() <= caps[1]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgpt.loss(p, jnp.asarray(toks))))(jp)
    loss = tgpt.loss(torch.tensor(toks))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    grads = tree_to_numpy({n: p.grad for n, p in tgpt.named_parameters()})
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **TOL),
        grads, jax.tree_util.tree_map(np.asarray, jgrads))


def test_train_gpt_recipe_three_steps_vs_jax():
    """The training slice as a whole: three steps of the entry point's
    recipe (``train_gpt.train``: data.epochs batches of 2 x 40 tokens,
    windows of 8 cutting, make_train_step over GPT.loss(training=True),
    chain(clip_by_global_norm(1.0), adamw(warmup_cosine(3e-4, 10, 3))))
    against JAX's make_train_step over its GPT.loss with the same chain, on
    the same weights and corpus: each step's loss and every parameter after
    the third, fp32."""
    jgpt, tree, tgpt = _pair(CFG)
    corpus = rng.integers(0, 256, (8, SEQ))
    steps = 3
    losses, _ = train_gpt.train(tgpt, corpus, steps, batch=2, device="cpu",
                                log=None)
    jopt = jtraining.chain(jtraining.clip_by_global_norm(1.0),
                           jtraining.adamw(jschedules.warmup_cosine(
                               3e-4, warmup_steps=10, total_steps=steps)))
    jstep = jtraining.make_train_step(jgpt.loss, lambda loss, _: loss, jopt,
                                      donate=False)
    params = _jtree(tree)
    jstate, jl = jopt.init(params), []
    for (batch,), _ in zip(jdata.epochs([corpus], 2, num_epochs=100),
                           range(steps)):
        params, jstate, loss = jstep(params, jstate, jnp.asarray(batch), None,
                                     jax.random.PRNGKey(1))
        jl.append(float(loss))
    np.testing.assert_allclose(losses.numpy(), jl, **TOL)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **TOL),
        params_to_numpy(tgpt), params)


def test_gpt_apply_bf16_vs_jax():
    """bf16 compute, fp32 master weights: the residual stream turns fp32
    after block 0's post-norm in both packages; logits within 2e-2 of
    max(1, max |JAX|)."""
    cfg = {**CFG, "dtype": jnp.bfloat16}
    jgpt, tree = _tree(cfg)
    tgpt = params_from_numpy(tree, tmodels.GPTConfig(
        **{**cfg, "dtype": torch.bfloat16}), device="cpu")
    toks = rng.integers(0, 256, (2, SEQ))
    want = jax.jit(jgpt.apply)(_jtree(tree), jnp.asarray(toks))
    with torch.no_grad():
        got = tgpt.apply(torch.tensor(toks))
    _bf16_bound(got, want, 2e-2)


def test_fused_loss_refuses_the_final_softcap():
    jgpt, tree, tgpt = _pair({**CFG, "fused_loss": True})
    toks = jnp.zeros((1, 8), jnp.int32)
    with pytest.raises(AssertionError):
        jgpt.loss(_jtree(tree), toks)
    with pytest.raises(ValueError, match="softcap"):
        tgpt.loss(torch.zeros((1, 8), dtype=torch.long))


def test_params_round_trip_and_gemma2_2b_builds():
    """The JAX tree loads and comes back leaf for leaf: RMSNorm gamma,
    swiglu, post_norm1/2, no pos_embedding. Int8 swiglu leaves raise.
    Gemma-2 2B itself builds (on the meta device: no memory) with its
    published parameter count."""
    _, tree, tgpt = _pair(CFG)
    back = params_to_numpy(tgpt)
    assert "pos_embedding" not in back and set(back) == set(tree)
    assert set(back["layer_0"]) == {"self_attention", "norm1", "norm2",
                                    "post_norm1", "post_norm2", "swiglu"}
    assert set(back["layer_0"]["swiglu"]) == {"w_gate", "w_up", "w_down"}
    assert set(back["final_norm"]) == {"gamma"}
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    qtree = jops.quantize_params_int8(_jtree(tree), match=r".*swiglu/w_up$")
    with pytest.raises(NotImplementedError):
        params_from_numpy(jax.tree_util.tree_map(np.asarray, qtree),
                          tmodels.GPTConfig(**CFG), device="cpu")
    big = tmodels.GPT(tmodels.GPTConfig(**GEMMA2_2B), device="meta")
    assert sum(p.numel() for p in big.parameters()) == 2_614_341_888
    assert [getattr(big, f"layer_{i}").self_attention.window
            for i in range(4)] == [4096, None, 4096, None]
    assert big.layer_0.self_attention.attn_scale == 256.0 ** -0.5


# ---- serving --------------------------------------------------------------------

def test_engine_matches_jax_engine():
    """Greedy tokens and the last step's logits, fp32: prompts of 9..35
    tokens (past the window of 8) through chunks of 16 on pages of 8, then
    decode steps; the paged kernel's plain version carries window, scale
    and softcap."""
    jgpt, tree, tgpt = _pair(CFG)
    eng = dict(total_pages=64, page_size=8, max_seqs=4, prefill_chunk_size=16)
    jeng, teng = JaxEngine(jgpt, _jtree(tree), **eng), GenerationEngine(
        tgpt, **eng)
    prompts = {sid: rng.integers(0, 256, n).astype(np.int32)
               for sid, n in ((0, 21), (1, 35), (2, 9))}
    assert teng.add_requests(prompts) == jeng.add_requests(
        {k: jnp.asarray(v) for k, v in prompts.items()})
    assert teng.step_many(4) == jeng.step_many(4)
    assert teng.step() == jeng.step()
    _, t_tok, t_logits = teng._device_step(teng._state, return_logits=True)
    _, j_tok, j_logits = jeng._device_step(
        jeng._state, jeng._serve_params, jax.random.PRNGKey(0),
        return_logits=True)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    active = np.asarray(jeng._state["active"])
    np.testing.assert_allclose(t_logits.numpy()[active],
                               np.asarray(j_logits)[active], **TOL)
