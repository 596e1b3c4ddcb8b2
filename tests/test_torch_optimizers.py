"""Every optimizer and transform of the port's training/optimizers.py
against the JAX package's, in both of the port's forms.

Each case runs 3 steps from the same seeded numpy parameters and gradients
through JAX's ``update`` (under ``jax.jit``), the port's functional
``update`` and its donated ``update_`` (the state's tensors and the
gradients turned into updates in place). The parameters agree with JAX's at
rtol 1e-6 / atol 1e-7 (the tolerance the port's Adam is held to in
tests/test_torch_train.py); the donated form equals the functional one bit
for bit, updates and state, and returns the caller's own gradient and state
objects; the functional form leaves its arguments as they were; neither
reads anything back to the host (a host read raises inside the update). The leaves are named as a GPT's
(``layer_0.self_attention.wq``), so that muon's ``exclude`` rule sees JAX's
paths; one leaf is 3-D (an MoE expert stack) and one large enough for
adafactor's default factoring.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import training as jtraining
from np_modeling_tpu.training import schedules as jschedules
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import training
from np_modeling_tpu_torch.training import schedules
from np_modeling_tpu_torch.training.optimizers import _clone, _tensors
from np_modeling_tpu_torch.utils import tree_to_numpy

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"embedding.table": (40, 12),
          "layer_0.self_attention.wq": (12, 16),
          "layer_0.moe.w_up": (3, 12, 8),
          "layer_0.dense1.linear.w": (130, 136),
          "layer_0.norm1.gamma": (12,),
          "final_norm.beta": (12,)}
STEPS = 3


def _sched(count):
    return 1e-2 / (1.0 + count)


# (name, make(package, schedules module)); each makes the same optimizer in
# either package.
CASES = [
    ("sgd", lambda m, s: m.sgd(0.1)),
    ("sgd_schedule", lambda m, s: m.sgd(_sched)),
    ("momentum", lambda m, s: m.momentum(0.05, beta=0.8)),
    ("adam", lambda m, s: m.adam(1e-2)),
    ("adam_reference_eps", lambda m, s: m.adam(3e-3, beta1=0.8,
                                               reference_epsilon=True,
                                               epsilon=1e-7)),
    ("adam_schedule", lambda m, s: m.adam(_sched)),
    ("adamw", lambda m, s: m.adamw(1e-2, weight_decay=0.1)),
    ("adamw_warmup_cosine", lambda m, s: m.adamw(
        s.warmup_cosine(3e-2, warmup_steps=2, total_steps=STEPS))),
    ("adafactor", lambda m, s: m.adafactor(1e-2)),
    ("adafactor_factor_8", lambda m, s: m.adafactor(
        1e-2, min_dim_size_to_factor=8)),
    ("adafactor_plain", lambda m, s: m.adafactor(
        _sched, min_dim_size_to_factor=8, clipping_threshold=None,
        multiply_by_parameter_scale=False)),
    ("lion", lambda m, s: m.lion(1e-3)),
    ("lion_decay", lambda m, s: m.lion(_sched, weight_decay=0.1)),
    ("muon", lambda m, s: m.muon(1e-2)),
    ("muon_plain", lambda m, s: m.muon(1e-2, adam_lr=1e-3, nesterov=False,
                                       ns_steps=3)),
    ("clip_adamw", lambda m, s: m.chain(
        m.clip_by_global_norm(1.0),
        m.adamw(s.warmup_cosine(3e-4, warmup_steps=10, total_steps=STEPS)))),
    ("clip_sgd_unclipped", lambda m, s: m.chain(
        m.clip_by_global_norm(1e6), m.sgd(0.1))),
    ("skip_nonfinite_adam", lambda m, s: m.skip_nonfinite(m.adam(1e-2))),
    ("skip_nonfinite_chain", lambda m, s: m.skip_nonfinite(m.chain(
        m.clip_by_global_norm(1.0), m.adamw(1e-2)))),
]


def _nested(flat):
    """``{"a.b": x}`` -> ``{"a": {"b": jnp}}``: JAX's tree of the leaves."""
    return jax.tree_util.tree_map(jnp.asarray, tree_to_numpy(
        {k: torch.as_tensor(v) for k, v in flat.items()}))


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(p.key) for p in path)] = np.asarray(leaf)
    return out


def _data(seed, nonfinite=False):
    """Seeded parameters and STEPS gradients (numpy); with ``nonfinite``
    the second step's gradients hold an inf and a NaN."""
    r = np.random.default_rng(seed)
    params = {k: r.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (r.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    if nonfinite:
        grads[1]["layer_0.self_attention.wq"][3, 4] = np.inf
        grads[1]["final_norm.beta"][2] = np.nan
    return params, grads


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Any read of a tensor's value to the host raises in the scope."""
    def refuse(*_, **__):
        raise AssertionError("the update read a device value to the host")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "__float__", "__int__"):
            m.setattr(torch.Tensor, name, refuse)
        yield


def _run_port(opt, params, grads, donate, monkeypatch):
    """STEPS steps of ``opt``; returns (params, [updates a step], state)."""
    tp = {k: torch.tensor(v) for k, v in params.items()}
    state = opt.init(tp)
    update = opt.update_ if donate else opt.update
    seen = []
    for g in grads:
        tg = {k: torch.tensor(v) for k, v in g.items()}
        held = list(_tensors(state))
        was = _clone((tg, state))
        with _no_host_reads(monkeypatch):
            updates, new_state = update(tg, state, tp)
        if donate:
            # The caller's own objects come back, updated in place.
            assert new_state is state
            assert all(updates[k] is tg[k] for k in tg)
            assert all(a is b for a, b in
                       zip(_tensors(new_state), held, strict=True))
        else:
            # The caller's gradients and state are left as they were.
            assert not any(a is b for a, b in zip(
                _tensors((updates, new_state)), _tensors((tg, state))))
            assert all(torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)
                       for a, b in zip(_tensors((tg, state)), _tensors(was),
                                       strict=True))
        seen.append({k: u.clone() for k, u in updates.items()})
        state = new_state
        training.apply_updates(tp, updates)
    return tp, seen, state


@pytest.mark.parametrize("name,make", CASES, ids=[c[0] for c in CASES])
def test_optimizer_three_steps_vs_jax_donated_and_functional(
        monkeypatch, name, make):
    params, grads = _data(1, nonfinite=name.startswith("skip"))
    jopt = make(jtraining, jschedules)
    jp = _nested(params)
    js = jopt.init(jp)
    jstep = jax.jit(lambda g, s, p: jopt.update(g, s, p))
    for g in grads:
        ju, js = jstep(_nested(g), js, jp)
        jp = jtraining.apply_updates(jp, ju)
    want = _flat(jp)

    opt = make(training, schedules)
    fun_p, fun_u, fun_s = _run_port(opt, params, grads, False, monkeypatch)
    don_p, don_u, don_s = _run_port(opt, params, grads, True, monkeypatch)
    for k in SHAPES:
        np.testing.assert_allclose(fun_p[k].numpy(), want[k], **TOL,
                                   err_msg=k)
        assert np.isfinite(fun_p[k].numpy()).all(), k
    for step, (a, b) in enumerate(zip(don_u, fun_u)):
        for k in SHAPES:
            assert torch.equal(a[k], b[k]), (step, k)
    for a, b in zip(_tensors(don_s), _tensors(fun_s), strict=True):
        assert torch.equal(a, b)
    if name.startswith("skip"):
        # The bad step was skipped in both packages: counted, no update.
        assert int(fun_s[0]) == int(don_s[0]) == int(js[0]) == 1
        assert all(torch.equal(u, torch.zeros_like(u))
                   for u in fun_u[1].values())


def test_muon_groups_follow_jax_paths():
    """muon's state: a 0-d second moment for the orthogonalized matrices,
    a full one for the embedding (excluded by name) and the vectors, as
    JAX's partition over the same tree."""
    params, _ = _data(2)
    _, mu, nu = training.muon(1e-2).init(
        {k: torch.tensor(v) for k, v in params.items()})
    _, _, jnu = jtraining.muon(1e-2).init(_nested(params))
    jnu = _flat(jnu)
    for k in SHAPES:
        assert tuple(nu[k].shape) == jnu[k].shape, k
        assert mu[k].shape == SHAPES[k]
    assert nu["layer_0.self_attention.wq"].shape == ()
    assert nu["embedding.table"].shape == SHAPES["embedding.table"]


def test_newton_schulz_vs_jax():
    """The quintic iteration alone, a wide and a tall matrix: JAX's result
    within 1e-5 (the matmuls' sums run in other orders)."""
    from np_modeling_tpu.training.optimizers import _newton_schulz as jns
    from np_modeling_tpu_torch.training.optimizers import _newton_schulz
    r = np.random.default_rng(3)
    for shape in ((12, 20), (30, 8)):
        m = r.standard_normal(shape).astype(np.float32)
        np.testing.assert_allclose(_newton_schulz(torch.tensor(m)).numpy(),
                                   np.asarray(jax.jit(jns)(jnp.asarray(m))),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("debias", [True, False])
def test_ema_params_vs_jax(debias):
    """ema_params over 3 parameter updates: ``value`` against JAX's, the
    donated ``update_ema_`` equal to the functional ``update`` bit for bit;
    ``ema_params`` is JAX's ``(init, update, value)``."""
    params, grads = _data(4)
    jinit, jupdate, jvalue = jtraining.ema_params(0.9, debias=debias)
    init, update, value = training.ema_params(0.9, debias=debias)
    jp = _nested(params)
    js = jinit(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    fun, don = init(tp), init(tp)
    for g in grads:
        jp = jax.tree_util.tree_map(lambda p, x: p - 0.1 * x, jp, _nested(g))
        js = jax.jit(jupdate)(js, jp)
        for k in tp:
            tp[k] = tp[k] - 0.1 * torch.tensor(g[k])
        was = _clone(fun)
        fun2 = update(fun, tp)
        assert all(torch.equal(a, b) for a, b in
                   zip(_tensors(fun), _tensors(was), strict=True))
        fun = fun2
        assert training.update_ema_(don, tp, 0.9) is don
    want = _flat(jax.jit(jvalue)(js))
    got = value(fun)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL, err_msg=k)
        assert torch.equal(value(don)[k], got[k])
    assert int(fun.count) == int(don.count) == 3


def _gpt(seed=0):
    cfg = tmodels.GPTConfig(vocab_size=64, d_model=32, num_heads=4,
                            num_layers=2, hidden_units=64, max_len=16,
                            drop_rate=0.1)
    return tmodels.GPT(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_make_train_step_donated_equals_functional(grad_accum):
    """``make_train_step(donate=True)`` (the default, as JAX's) against
    ``donate=False`` on the train_gpt recipe, dropout on, 3 steps: the
    losses and parameters bit for bit. Donated, the state is consumed: the
    step returns the caller's object, its tensors changed in place;
    functional, the caller's state is left as it was."""
    from np_modeling_tpu_torch import train_gpt
    tokens = torch.tensor(np.random.default_rng(5).integers(0, 64, (4, 16)))
    runs = {}
    for donate in (True, False):
        gpt = _gpt()
        opt = train_gpt.recipe(STEPS)
        params = dict(gpt.named_parameters())
        state = opt.init(params)
        step = training.make_train_step(gpt.loss, lambda loss, _: loss, opt,
                                        donate=donate, grad_accum=grad_accum)
        losses = []
        for i in range(STEPS):
            first = [t.clone() for t in _tensors(state)]
            params, new_state, loss = step(params, state, tokens, tokens, i)
            assert (new_state is state) == donate
            unchanged = all(torch.equal(a, b) for a, b in
                            zip(_tensors(state), first))
            assert unchanged != donate
            state = new_state
            losses.append(loss)
        runs[donate] = (torch.stack(losses), params)
    assert torch.equal(runs[True][0], runs[False][0])
    for k, p in runs[True][1].items():
        assert torch.equal(p, runs[False][1][k]), k
