"""MoE training in the port against the JAX package, on the CPU: the MoE's
hand-written backward, GPT.loss through it, the training entry point's
``--moe``, and the flash wrapper's head-dim padding.

``MoE.apply_with_aux``'s gradients (x and every leaf) under random
cotangents of ``out`` plus 0.01 x ``aux`` against ``jax.grad`` of JAX's,
over tests/test_torch_moe.py's CASES (every router rule and expert form,
no-drop by both product routes, sorted and dense dispatch with drops,
shared experts, the router bias, the select bias whose gradient is zero),
fp32 and bf16; the tied routers of its TIE_CASES; ``glu_clamp`` with gate
and up values exactly at its limits (JAX's half gradient there). Then
``GPT.loss``'s gradients with the aux for an MLA + MoE GPT and a
capacity-limited swiglu MoE GPT, three steps of ``train_gpt.train``'s
recipe on a tiny ``--moe`` GPT against JAX's ``make_train_step``, and
``train_gpt.main(["--moe", ...])``. fp32 at rtol 1e-5 / atol 2e-5
(BASELINE.md:16); bf16 within BF16_TOL x max(1, max |JAX's|) a leaf (the
routed products round in bf16 on both sides, in other orders). The JAX
side runs under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu import training as jtraining
from np_modeling_tpu.training import data as jdata
from np_modeling_tpu.training import schedules as jschedules
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import train_gpt
from np_modeling_tpu_torch.nn import moe as moe_mod
from np_modeling_tpu_torch.ops import attention
from np_modeling_tpu_torch.utils import params_to_numpy, tree_to_numpy
from test_torch_moe import (BF16_TOL, CASES, D, MLA_MOE, SWIGLU_MOE,
                            TIE_CASES, TOL, _gpt, _moe)

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

rng = np.random.default_rng(67)
AUX_W = 0.01


def _flat(tree, pre=""):
    """A nested gradient tree as {dotted leaf name: fp32 numpy}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = np.asarray(jnp.asarray(v).astype(jnp.float32))
    return out


def _grads(m, jm, tree, x, ct, dtype):
    """(port's, JAX's) gradients of x and every leaf of sum(out * ct) + 0.01
    aux, by leaf name."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xt = torch.tensor(x).to(dtype).requires_grad_()
    ctt = torch.tensor(ct).to(dtype)

    def objective(p, x):
        out, aux = jm.apply_with_aux(p, x)
        return jnp.sum(out.astype(jnp.float32)
                       * jnp.asarray(ctt.float().numpy())) + AUX_W * aux

    gp, gx = jax.jit(jax.grad(objective, argnums=(0, 1)))(
        tree, jnp.asarray(xt.detach().float().numpy()).astype(jdt))
    out, aux = m.apply_with_aux(xt)
    ((out.float() * ctt.float()).sum() + AUX_W * aux).backward()
    got = {n: p.grad.float().numpy() for n, p in m.named_parameters()}
    assert xt.grad.dtype == dtype
    got["x"] = xt.grad.float().numpy()
    want = _flat(gp)
    want["x"] = np.asarray(gx.astype(jnp.float32))
    assert set(got) == set(want)
    return got, want


def _hold(got, want, dtype):
    for name in want:
        if dtype == torch.float32:
            np.testing.assert_allclose(got[name], want[name], **TOL,
                                       err_msg=name)
        else:
            err = np.abs(got[name] - want[name]).max() / max(
                1.0, np.abs(want[name]).max())
            assert err <= BF16_TOL, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_grads_vs_jax(case, dtype):
    """Every gradient against jax.grad's; the select bias's is zero on both
    sides (its winners' weights are re-read from the unbiased gates)."""
    _, fields, t = case
    m, jm, tree = _moe(fields)
    x = rng.standard_normal((2, t // 2, D)).astype(np.float32)
    ct = rng.standard_normal((2, t // 2, D)).astype(np.float32)
    got, want = _grads(m, jm, tree, x, ct, dtype)
    _hold(got, want, dtype)
    if "router_sb" in want:
        assert not got["router_sb"].any() and not want["router_sb"].any()
    assert np.abs(got["router"]).max() > 0.0


@pytest.mark.parametrize("case", TIE_CASES, ids=[c[0] for c in TIE_CASES])
def test_tied_router_grads_reach_jax_expert(case):
    """test_torch_moe's constructed ties (a duplicated router column, equal
    groups): every gradient equals JAX's, so it reaches the expert JAX
    picked (the lower index); with one choice a token the copy gets none."""
    _, fields, how, first = case
    m, jm, _ = _moe(fields, seed=7)
    x = rng.standard_normal((2, 6, D)).astype(np.float32)
    x[..., 0] = 3.0
    with torch.no_grad():
        r = m.router
        if how == "dup":
            r[0, 2] = 2.0
            r[:, 5] = r[:, 2]
        else:
            per = fields["num_experts"] // fields["router_groups"][0]
            r[0, :per] = 3.0
            r[:, 2 * per:3 * per] = r[:, :per]
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  tree_to_numpy(dict(m.named_parameters())))
    ct = rng.standard_normal(x.shape).astype(np.float32)
    got, want = _grads(m, jm, tree, x, ct, torch.float32)
    _hold(got, want, torch.float32)
    lead = "w1" if fields.get("ffn", "mlp") == "mlp" else "w_gate"
    if how == "dup":
        assert np.abs(got[lead][first]).max() > 0.0
        if fields["router_top_k"] == 1:
            assert not got[lead][5].any()


def test_glu_clamp_half_gradient_at_the_limits():
    """Gate and up values exactly at +-7 (one-hot token rows: a product is
    then one weight): JAX's minimum and clip give half the gradient there,
    torch.clamp all of it; the backward follows JAX."""
    assert float(jax.grad(lambda v: jnp.minimum(v, 7.0))(7.0)) == 0.5
    assert float(jax.grad(lambda v: jnp.clip(v, -7.0, 7.0))(-7.0)) == 0.5
    np.testing.assert_array_equal(
        moe_mod._clip_grad(torch.tensor([-7.5, -7.0, 0.0, 7.0, 7.5]),
                           -7.0, 7.0).numpy(), [0.0, 0.5, 1.0, 0.5, 0.0])
    fields = dict(num_experts=8, hidden_units=16, ffn="glu_clamp",
                  capacity_factor=None, router_top_k=2,
                  router_weights="topk_softmax", router_bias=True)
    m, jm, _ = _moe(fields, seed=11)
    with torch.no_grad():
        m.b_gate.zero_()
        m.b_up.zero_()
        m.w_gate[:, 0, :4] = torch.tensor([7.0, 7.0, 6.5, 7.5])
        m.w_up[:, 0, :4] = torch.tensor([7.0, -7.0, -7.5, 7.5])
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  tree_to_numpy(dict(m.named_parameters())))
    x = rng.standard_normal((1, 12, D)).astype(np.float32)
    x[0, :6] = 0.0
    x[0, :6, 0] = 1.0                       # gate and up = the row-0 weights
    ct = rng.standard_normal(x.shape).astype(np.float32)
    got, want = _grads(m, jm, tree, x, ct, torch.float32)
    _hold(got, want, torch.float32)
    # The limit columns carry gradient (half of torch.clamp's), the columns
    # past it none from the one-hot rows.
    assert np.abs(got["b_gate"][:, :2]).max() > 0.0


# ---- GPT.loss and the training entry point ----------------------------------

CAPACITY_SWIGLU = dict(SWIGLU_MOE, moe_capacity_factor=1.0,
                       moe_aux_weight=0.05)


@pytest.mark.parametrize("cfg", [MLA_MOE, CAPACITY_SWIGLU],
                         ids=["mla_moe", "capacity_swiglu"])
def test_gpt_loss_grads_vs_jax(cfg, monkeypatch):
    """GPT.loss with moe_aux_weight x the summed aux: the loss and every
    gradient against jax.grad of JAX's GPT.loss; the capacity-limited GPT
    drops tokens (dense dispatch, 8 experts)."""
    t, j, params = _gpt(cfg, 9)
    toks = rng.integers(0, 64, (2, 16))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: j.loss(p, jnp.asarray(toks))))(params)
    dropped, dense = [], moe_mod.MoE._apply_dense

    def spy(self, *args):
        out, frac = dense(self, *args)
        dropped.append(float(frac))
        return out, frac

    monkeypatch.setattr(moe_mod.MoE, "_apply_dense", spy)
    loss = t.loss(torch.tensor(toks))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    grads = tree_to_numpy({n: p.grad for n, p in t.named_parameters()})
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **TOL),
        grads, jax.tree_util.tree_map(np.asarray, jgrads))
    if cfg is CAPACITY_SWIGLU:
        assert len(dropped) == 2 and max(dropped) > 0.0, dropped


MOE_GPT = dict(vocab_size=64, d_model=D, num_heads=4, num_layers=2,
               hidden_units=4 * D, max_len=64, moe_experts=8)
SEQ = 40


def test_train_gpt_recipe_three_steps_vs_jax():
    """Three steps of the entry point's recipe (``train_gpt.train``) on the
    GPT that ``--moe 8`` builds (relu experts of 4 x d, top 2, capacity
    1.25: dense dispatch; aux weight 0.01), dropout 0, against JAX's
    make_train_step over its GPT.loss with the same chain, weights and
    batches: each step's loss and every parameter after the third, fp32."""
    t, j, _ = _gpt(MOE_GPT, 13)
    with torch.no_grad():
        t.embedding.table.div_(50.0)        # _gpt scales it for decoding
    # Copies: train_gpt.train updates the port's weights in place.
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a.copy()),
                                    params_to_numpy(t))
    corpus = rng.integers(0, 64, (8, SEQ))
    steps = 3
    losses, _ = train_gpt.train(t, corpus, steps, batch=2, device="cpu",
                                log=None)
    jopt = jtraining.chain(jtraining.clip_by_global_norm(1.0),
                           jtraining.adamw(jschedules.warmup_cosine(
                               3e-4, warmup_steps=10, total_steps=steps)))
    jstep = jtraining.make_train_step(j.loss, lambda loss, _: loss, jopt,
                                      donate=False)
    jstate, jl = jopt.init(params), []
    for (batch,), _ in zip(jdata.epochs([corpus], 2, num_epochs=100),
                           range(steps)):
        params, jstate, loss = jstep(params, jstate, jnp.asarray(batch), None,
                                     jax.random.PRNGKey(1))
        jl.append(float(loss))
    np.testing.assert_allclose(losses.numpy(), jl, **TOL)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **TOL),
        params_to_numpy(t), params)


def test_train_gpt_main_moe_runs():
    """``--moe 8`` at tiny sizes on the CPU: an MoE GPT, the aux in its
    loss, the closing sample; the loss falls."""
    args = ["--moe", "8", "--device", "cpu", "--steps", "12", "--batch", "2",
            "--seq", "32", "--d-model", "32", "--layers", "2", "--heads", "2",
            "--vocab", "16"]
    assert train_gpt.parse_args(args).moe == 8
    losses = train_gpt.main(args)
    assert losses.shape == (12,) and bool(torch.isfinite(losses).all())
    assert float(losses[-3:].mean()) < float(losses[:3].mean())


# ---- head dims under 64 through the flash wrapper's padding -----------------

@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_head_dim_padding_is_exact(d, causal):
    """The kernels take head dims of 64 and up; a narrower one runs on
    zero-padded copies at 64 (``_fwd_padded``/``_bwd_padded``). Through the
    plain version, the padded computation equals the unpadded one: o, lse,
    dq, dk, dv, GQA 2, the scale 1/sqrt(d) of the true width."""
    g = torch.Generator().manual_seed(d)
    q = torch.randn(2, 4, 24, d, generator=g)
    k, v = (torch.randn(2, 2, 24, d, generator=g) for _ in range(2))
    do = torch.randn(2, 4, 24, d, generator=g)
    scale = d ** -0.5
    args = (None, None, causal, None, scale)
    o, lse = attention._attn_fwd_plain(q, k, v, *args)
    po, plse = attention._fwd_padded(attention._attn_fwd_plain, q, k, v,
                                     *args)
    assert po.shape == o.shape
    np.testing.assert_allclose(po.numpy(), o.numpy(), **TOL)
    np.testing.assert_allclose(plse.numpy(), lse.numpy(), **TOL)
    want = attention._attn_bwd_plain(q, k, v, o, lse, do, *args)
    got = attention._bwd_padded(attention._attn_bwd_plain, q, k, v, o, lse,
                                do, *args)
    for w, x in zip(want[:3], got[:3]):
        assert x.shape == w.shape
        np.testing.assert_allclose(x.numpy(), w.numpy(), **TOL)
    ref = attention.attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(o.numpy(), ref.numpy(), **TOL)
