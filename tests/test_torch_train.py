"""The port's training path against the JAX package: losses, optimizers, and
a small GPT's loss, gradients and Adam trajectory.

Inputs and weights come from seeded numpy arrays (the GPT's from the port's
init, carried across by utils.convert) and go through both packages; the
GPT's JAX side runs compiled. fp32 at rtol 1e-5 / atol
2e-5 (BASELINE.md), gradients at atol 5e-5 as the JAX package's own
attention tests hold them, unless a case states otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu import ops as jops
from np_modeling_tpu import training as jtraining
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import nn as tnn
from np_modeling_tpu_torch import ops, training
from np_modeling_tpu_torch.utils import (params_from_numpy, params_to_numpy,
                                         tree_to_numpy)

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-5, atol=5e-5)
rng = np.random.default_rng(0)


def _randn(*shape):
    return rng.standard_normal(shape).astype(np.float32)


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(g, np.asarray(flat_want[path]), **tol,
                                   err_msg=jax.tree_util.keystr(path))


# ---- losses -----------------------------------------------------------------

@pytest.mark.parametrize("layout,bias", [("vd", False), ("dv", False),
                                         ("dv", True)])
def test_fused_lm_head_loss_vs_jax(layout, bias):
    """Ragged last chunk (100 rows, chunk 32) and a valid mask."""
    x, v = _randn(4, 25, 16), 40
    table = _randn(v, 16) if layout == "vd" else _randn(16, v)
    b = _randn(v) if bias else None
    labels = rng.integers(0, v, (4, 25)).astype(np.int32)
    valid = (rng.random((4, 25)) > 0.2).astype(np.float32)

    def jloss(x, table, b):
        return jops.fused_lm_head_loss(x, table, jnp.asarray(labels), chunk=32,
                                       valid=jnp.asarray(valid),
                                       table_layout=layout, bias=b)

    want, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(table),
        jnp.asarray(b) if bias else None)
    tx, tt = torch.tensor(x, requires_grad=True), torch.tensor(table,
                                                               requires_grad=True)
    tb = torch.tensor(b, requires_grad=True) if bias else None
    got = ops.fused_lm_head_loss(tx, tt, torch.tensor(labels), chunk=32,
                                 valid=torch.tensor(valid), table_layout=layout,
                                 bias=tb)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for t, g in zip((tx, tt, tb), jgrads):
        if t is not None:
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       **GRAD_TOL)


def test_softmax_cross_entropy_with_integer_labels_vs_jax():
    logits = _randn(3, 7, 11) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, 0], labels[1, 2] = -1, 11          # out of range: ce = lse
    g = _randn(3, 7)
    want, vjp = jax.vjp(
        lambda l: jops.softmax_cross_entropy_with_integer_labels(
            l, jnp.asarray(labels)), jnp.asarray(logits))
    (dwant,) = vjp(jnp.asarray(g))
    tl = torch.tensor(logits, requires_grad=True)
    got = ops.softmax_cross_entropy_with_integer_labels(tl,
                                                        torch.tensor(labels))
    got.backward(torch.tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(dwant), **GRAD_TOL)


# ---- optimizers ---------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.adam(1e-2),
    lambda m: m.adam(3e-3, beta1=0.8, reference_epsilon=True, epsilon=1e-7),
    lambda m: m.adam(lambda count: 1e-2 / (1.0 + count)),
    lambda m: m.sgd(0.1),
], ids=["adam", "adam_reference_eps", "adam_schedule", "sgd"])
def test_optimizer_three_steps_vs_jax(make):
    """Identical numpy gradients through both: Adam turns g into about
    -lr * sign(g), so only equal gradients can be held this tight."""
    params = {"a": _randn(5, 3), "b.c": _randn(7)}
    grads = [{k: _randn(*p.shape) for k, p in params.items()}
             for _ in range(3)]
    jopt, topt = make(jtraining), make(training)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = jtraining.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        tp = training.apply_updates(tp, tu)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


def test_apply_updates_is_in_place_and_keeps_leaves():
    p = torch.nn.Parameter(torch.ones(3))
    params = {"p": p}
    out = training.apply_updates(params, {"p": torch.full((3,), 0.5)})
    assert out["p"] is p and p.is_leaf and p.requires_grad
    np.testing.assert_array_equal(p.detach().numpy(), [1.5, 1.5, 1.5])


# ---- the GPT ------------------------------------------------------------------

def _gpt_pair(hkv, fused):
    cfg = dict(vocab_size=128, d_model=64, num_heads=4, num_kv_heads=hkv,
               num_layers=2, hidden_units=128, max_len=64, fused_loss=fused)
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg))
    tokens = rng.integers(0, 128, (2, 64)).astype(np.int32)
    tree = params_to_numpy(tmodels.GPT(tmodels.GPTConfig(**cfg),
                                       device="cpu").init(
        torch.Generator().manual_seed(3)))
    tgpt = params_from_numpy(tree, tmodels.GPTConfig(**cfg), device="cpu")
    return jgpt, jax.tree_util.tree_map(jnp.asarray, tree), tgpt, tokens


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("hkv", [4, 2])
def test_gpt_loss_and_grads_vs_jax(hkv, fused):
    jgpt, params, tgpt, tokens = _gpt_pair(hkv, fused)
    want, jgrads = jax.jit(jax.value_and_grad(jgpt.loss))(
        params, jnp.asarray(tokens))
    got = tgpt.loss(torch.tensor(tokens))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    grads = tree_to_numpy({n: p.grad for n, p in tgpt.named_parameters()})
    _assert_trees_close(grads, jgrads, **GRAD_TOL)


def test_gpt_apply_logits_and_hidden_vs_jax():
    jgpt, params, tgpt, tokens = _gpt_pair(2, False)
    with torch.no_grad():
        logits = tgpt.apply(torch.tensor(tokens))
        hidden = tgpt.apply(torch.tensor(tokens), return_hidden=True)
    assert logits.dtype == torch.float32 and logits.shape == (2, 64, 128)
    japply = jax.jit(jgpt.apply, static_argnames="return_hidden")
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(japply(params, jnp.asarray(tokens))),
        **TOL)
    np.testing.assert_allclose(
        hidden.numpy(),
        np.asarray(japply(params, jnp.asarray(tokens), return_hidden=True)),
        **TOL)


def test_gpt_adam_trajectory_vs_jax():
    """Three Adam steps on one batch: the loss trajectories agree."""
    jgpt, params, tgpt, tokens = _gpt_pair(2, True)
    jopt, topt = jtraining.adam(1e-3), training.adam(1e-3)
    jstate = jopt.init(params)
    tparams = dict(tgpt.named_parameters())
    tstate = topt.init(tparams)
    jt, tt = jnp.asarray(tokens), torch.tensor(tokens)

    @jax.jit
    def jax_step(p, state):
        loss, grads = jax.value_and_grad(jgpt.loss)(p, jt)
        updates, state = jopt.update(grads, state, p)
        return jtraining.apply_updates(p, updates), state, loss

    jl, tl = [], []
    for _ in range(3):
        params, jstate, loss = jax_step(params, jstate)
        jl.append(float(loss))
        tgpt.zero_grad()
        loss = tgpt.loss(tt)
        loss.backward()
        updates, tstate = topt.update(
            {n: p.grad for n, p in tparams.items()}, tstate, tparams)
        training.apply_updates(tparams, updates)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[2] < tl[0]


def test_params_to_numpy_round_trip():
    _, params, tgpt, _ = _gpt_pair(4, True)
    _assert_trees_close(params_to_numpy(tgpt), params, rtol=0, atol=0)


def test_dropout_identity_and_unported_rate():
    """Rate 0 and eval are the identity; a rate above 0 in training without
    rngs["dropout"] raises JAX's ValueError (JAX nn/linear.py:126-128)."""
    x = torch.randn(3, 4)
    assert tnn.Dropout(0.5)(x) is x
    assert tnn.Dropout(0.0)(x, training=True) is x
    with pytest.raises(ValueError):
        tnn.Dropout(0.1)(x, training=True)
    with pytest.raises(ValueError):
        tnn.Dropout(0.1)(x, training=True, rngs={"other": 0})
