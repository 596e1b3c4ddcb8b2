"""The port's training entry point against the JAX package: a GPT with
dropout, the schedules, adamw / clip_by_global_norm / chain, the losses the
Trainer resolves, the Trainer and make_train_step, and the data iterators.

Inputs and weights are seeded numpy arrays fed to both packages. fp32 at
rtol 1e-5 / atol 2e-5 (BASELINE.md), gradients at atol 5e-5, optimizer
states at rtol 1e-6, unless a case states otherwise. Dropout masks: the
port draws them (its plain twin of kernel K7's bits); a spy records them in
call order and JAX is handed the same masks in the same order, by
monkeypatching ``np_modeling_tpu.ops.normalization.make_dropout_mask``
within the test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu import nn as jnn
from np_modeling_tpu import training as jtraining
from np_modeling_tpu.ops import normalization as jnorm
from np_modeling_tpu.training import data as jdata
from np_modeling_tpu.training import schedules as jschedules
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import nn as tnn
from np_modeling_tpu_torch import ops, train_gpt, training
from np_modeling_tpu_torch.ops import normalization as tnorm
from np_modeling_tpu_torch.rng import fold_seed
from np_modeling_tpu_torch.training import data, schedules
from np_modeling_tpu_torch.utils import (load_params, params_from_numpy,
                                         tree_to_numpy)

TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-5, atol=5e-5)
rng = np.random.default_rng(5)


def _randn(*shape):
    return rng.standard_normal(shape).astype(np.float32)


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(g, np.asarray(flat_want[path]), **tol,
                                   err_msg=jax.tree_util.keystr(path))


class _SharedMasks:
    """Records the port's dropout masks and replays them to JAX in order."""

    def __init__(self, monkeypatch):
        self.masks = []
        draw = tnorm.make_dropout_mask

        def spy(seed, shape, rate, device=None):
            mask = draw(seed, shape, rate, device)
            self.masks.append(mask)
            return mask

        def replay(key, shape, rate):
            del key, rate
            mask = self.masks.pop(0)
            assert tuple(mask.shape) == tuple(shape)
            return jnp.asarray(mask.numpy())

        monkeypatch.setattr(tnorm, "make_dropout_mask", spy)
        monkeypatch.setattr(jnorm, "make_dropout_mask", replay)


# ---- a GPT with dropout ------------------------------------------------------------

def _gpt_pair(fused_loss):
    cfg = dict(vocab_size=128, d_model=64, num_heads=4, num_layers=2,
               hidden_units=128, max_len=64, drop_rate=0.1,
               fused_loss=fused_loss)
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg))
    tokens = rng.integers(0, 128, (2, 64)).astype(np.int32)
    params = jgpt.init(jax.random.PRNGKey(3), jnp.asarray(tokens))
    tgpt = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             tmodels.GPTConfig(**cfg), device="cpu")
    return jgpt, params, tgpt, tokens


@pytest.mark.parametrize("fused_loss", [False, True])
def test_gpt_dropout_loss_and_grads_vs_jax(monkeypatch, fused_loss):
    shared = _SharedMasks(monkeypatch)
    jgpt, params, tgpt, tokens = _gpt_pair(fused_loss)
    got = tgpt.loss(torch.tensor(tokens), training=True,
                    rngs={"dropout": torch.Generator().manual_seed(0)})
    got.backward()
    # embedding, then (before norm1, before norm2) for each of 2 layers
    assert len(shared.masks) == 5
    want, jgrads = jax.value_and_grad(
        lambda p: jgpt.loss(p, jnp.asarray(tokens), training=True,
                            rngs={"dropout": jax.random.PRNGKey(0)}))(params)
    assert not shared.masks
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    grads = tree_to_numpy({n: p.grad for n, p in tgpt.named_parameters()})
    _assert_trees_close(grads, jgrads, **GRAD_TOL)
    with torch.no_grad():                       # dropout changed the loss
        assert abs(tgpt.loss(torch.tensor(tokens)).item() - got.item()) > 1e-4


def test_gpt_dropout_streams_one_draw_a_call():
    """One seed is drawn from the generator a call: the same generator state
    gives the same loss, the next draw another; eval needs no rngs."""
    _, _, tgpt, tokens = _gpt_pair(True)
    t = torch.tensor(tokens)
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        a = tgpt.loss(t, training=True, rngs={"dropout": g}).item()
        b = tgpt.loss(t, training=True, rngs={"dropout": g}).item()
        again = tgpt.loss(t, training=True, rngs={
            "dropout": torch.Generator().manual_seed(11)}).item()
        with pytest.raises(ValueError):
            tgpt.loss(t, training=True)
        tgpt.loss(t)
    assert a == again and a != b


# ---- schedules, optimizers, losses ----------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.constant(3e-4),
    lambda m: m.linear_warmup(1e-3, 7),
    lambda m: m.cosine_decay(1e-3, 20, alpha=0.1),
    lambda m: m.warmup_cosine(3e-4, 10, 25),
    lambda m: m.warmup_cosine(3e-4, 10, 25, end_value=3e-5),
], ids=["constant", "linear_warmup", "cosine_decay", "warmup_cosine",
        "warmup_cosine_end"])
def test_schedules_vs_jax(make):
    jfn, tfn = make(jschedules), make(schedules)
    for step in range(31):
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(
            got.item(), float(jfn(jnp.asarray(step, jnp.int32))),
            rtol=1e-6, atol=1e-12, err_msg=f"step {step}")


@pytest.mark.parametrize("make", [
    lambda m: m.adamw(1e-2),
    lambda m: m.adamw(m.schedules.warmup_cosine(1e-2, 1, 3),
                      weight_decay=0.1),
    lambda m: m.clip_by_global_norm(1.0),
    lambda m: m.clip_by_global_norm(100.0),
    lambda m: m.chain(m.clip_by_global_norm(1.0),
                      m.adamw(m.schedules.warmup_cosine(3e-2, 1, 3))),
], ids=["adamw", "adamw_schedule", "clip", "clip_inactive", "chain"])
def test_optimizer_three_steps_vs_jax(make):
    """Identical numpy gradients (norm ~5, so clip at 1 scales them and at
    100 does not) through both; the parameters after each step agree."""
    jopt, topt = make(jtraining), make(training)
    params = {"a": _randn(5, 3), "b.c": _randn(7)}
    grads = [{k: _randn(*p.shape) for k, p in params.items()}
             for _ in range(3)]
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


def test_clip_keeps_the_scale_on_the_device():
    g = {"w": torch.full((4,), 3.0)}
    out, _ = training.clip_by_global_norm(1.0).update(g, ())
    assert isinstance(out["w"], torch.Tensor)
    np.testing.assert_allclose(out["w"].numpy(), [0.5] * 4, rtol=1e-6)


@pytest.mark.parametrize("name", ["mse", "cross_entropy",
                                  "softmax_cross_entropy"])
def test_trainer_losses_vs_jax(name):
    y = _randn(6, 5)
    if name == "cross_entropy":
        y = np.abs(y) + 0.1
        y = y / y.sum(-1, keepdims=True)
    t = np.abs(_randn(6, 5))
    t = t / t.sum(-1, keepdims=True)
    want, jgrads = jax.value_and_grad(
        jtraining.trainer.resolve_loss(name), argnums=(0, 1))(
            jnp.asarray(y), jnp.asarray(t))
    ty, tt = (torch.tensor(a, requires_grad=True) for a in (y, t))
    got = training.resolve_loss(name)(ty, tt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for a, b in zip((ty, tt), jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GRAD_TOL)


# ---- Trainer and make_train_step ----------------------------------------------------

def _mlp_pair(x):
    jmodel = jnn.Sequential([jnn.Dense(32), jnn.Linear(4)])
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tmodel = tnn.Sequential([tnn.Dense(x.shape[-1], 32), tnn.Linear(32, 4)])
    load_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


def test_trainer_fit_loss_history_vs_jax():
    x, t = _randn(32, 16), _randn(32, 4)
    jmodel, params, tmodel = _mlp_pair(x)
    jtr = jtraining.Trainer(jmodel, "mse", jtraining.sgd(0.1), seed=0)
    _, _, jl = jtr.fit(params, jnp.asarray(x), jnp.asarray(t), steps=8)
    ttr = training.Trainer(tmodel, "mse", training.sgd(0.1), seed=0)
    tparams = dict(tmodel.named_parameters())
    tx, ttgt = torch.tensor(x), torch.tensor(t)
    loss0 = ttr.evaluate(tparams, tx, ttgt).item()
    _, _, tl = ttr.fit(tparams, tx, ttgt, steps=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    assert tl[-1].item() < loss0
    assert ttr.evaluate(tparams, tx, ttgt).item() < tl[-1].item()


def test_make_train_step_grad_accum_vs_jax():
    x, t = _randn(8, 16), _randn(8, 4)
    jmodel, params, tmodel = _mlp_pair(x)
    jstep = jtraining.make_train_step(jmodel.apply, "mse",
                                      jtraining.adam(1e-2), donate=False,
                                      grad_accum=2)
    jparams, _, jloss = jstep(params, jtraining.adam(1e-2).init(params),
                              jnp.asarray(x), jnp.asarray(t),
                              jax.random.PRNGKey(0))
    opt = training.adam(1e-2)
    tparams = dict(tmodel.named_parameters())
    step = training.make_train_step(tmodel, "mse", opt, grad_accum=2)
    tparams, _, tloss = step(tparams, opt.init(tparams), torch.tensor(x),
                             torch.tensor(t), 0)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    _assert_trees_close(tree_to_numpy(tparams),
                        jax.tree_util.tree_map(np.asarray, jparams),
                        rtol=1e-6, atol=1e-7)


def test_grad_accum_folds_the_microbatch_into_the_dropout_stream(monkeypatch):
    seeds = []
    draw = tnorm.make_dropout_mask

    def spy(seed, shape, rate, device=None):
        seeds.append(seed)
        return draw(seed, shape, rate, device)

    monkeypatch.setattr(tnorm, "make_dropout_mask", spy)
    model = tnn.Sequential([tnn.Dense(16, 16), tnn.Dropout(0.5),
                            tnn.Linear(16, 4)])
    model.init(torch.Generator().manual_seed(0))
    opt = training.sgd(0.1)
    params = dict(model.named_parameters())
    step = training.make_train_step(model, "mse", opt, grad_accum=2)
    step(params, opt.init(params), torch.randn(4, 16), torch.randn(4, 4), 77)
    assert seeds == [fold_seed(fold_seed(fold_seed(77, i), 1), 0)
                     for i in (0, 1)]


# ---- data ---------------------------------------------------------------------

def test_batches_and_epochs_vs_jax():
    a, b = np.arange(50 * 3).reshape(50, 3), np.arange(50)
    for kw in (dict(shuffle=False), dict(seed=4),
               dict(seed=1, drop_remainder=False)):
        for got, want in zip(data.batches([a, b], 8, **kw),
                             jdata.batches([a, b], 8, **kw), strict=True):
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(g, w)
    got = list(data.epochs([a], 16, 3, seed=2))
    want = list(jdata.epochs([a], 16, 3, seed=2))
    assert len(got) == len(want) == 9
    for (g,), (w,) in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_to_device_yields_every_batch_as_tensors(size):
    a = np.arange(12 * 4).reshape(12, 4)
    want = list(data.batches([a], 3, seed=9))
    got = list(data.prefetch_to_device(data.batches([a], 3, seed=9),
                                       size=size, device="cpu"))
    assert len(got) == len(want) == 4
    for (g,), (w,) in zip(got, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)


# ---- the training entry point ---------------------------------------------------------

def test_train_gpt_recipe_three_steps_vs_jax(monkeypatch):
    """The example's recipe (dropout 0.1, clip + adamw + warmup-cosine,
    data.epochs batches) for 3 steps on both packages, from the same
    weights, with the same masks: the loss trajectories agree."""
    shared = _SharedMasks(monkeypatch)
    cfg = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2,
               hidden_units=128, max_len=16, drop_rate=0.1)
    corpus = np.random.default_rng(0).integers(0, 64, (32, 16))
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg))
    params = jgpt.init(jax.random.PRNGKey(0), jnp.asarray(corpus[:4]))
    tgpt = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             tmodels.GPTConfig(**cfg), device="cpu")
    steps = 3
    tl, _ = train_gpt.train(tgpt, corpus, steps, batch=4, device="cpu",
                            log=None)
    masks = list(shared.masks)
    assert len(masks) == 5 * steps
    jopt = jtraining.chain(jtraining.clip_by_global_norm(1.0),
                           jtraining.adamw(jschedules.warmup_cosine(
                               3e-4, warmup_steps=10, total_steps=steps)))
    jstate = jopt.init(params)
    jl = []
    for (batch,), _ in zip(jdata.epochs([corpus], 4, num_epochs=100),
                           range(steps)):
        loss, grads = jax.value_and_grad(
            lambda p: jgpt.loss(p, jnp.asarray(batch), training=True,
                                rngs={"dropout": jax.random.PRNGKey(1)}))(
                                    params)
        updates, jstate = jopt.update(grads, jstate, params)
        params = jtraining.apply_updates(params, updates)
        jl.append(float(loss))
    assert not shared.masks
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5)
    assert len(set(m.numpy().tobytes() for m in masks)) == len(masks)


def test_train_gpt_main_runs():
    losses = train_gpt.main(["--steps", "2", "--batch", "2", "--seq", "16",
                             "--d-model", "32", "--layers", "1", "--heads",
                             "4", "--vocab", "64", "--device", "cpu"])
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    assert ops.dropout.launches == 0 or torch.cuda.is_available()


def test_train_gpt_runs_on_the_card_unless_asked_for_the_cpu():
    assert train_gpt.parse_args([]).device == "cuda"
    assert train_gpt.parse_args(["--device", "cpu"]).device == "cpu"
