"""T5, Seq2SeqTransformer, beam search and the flash bias in the port
against the JAX package, on the CPU.

The same numpy weights and inputs go through both packages: T5 at 2 + 2
layers, d 64, 4 heads of 16, d_ff 128, vocab 128, 8 relative buckets over
distances to 20 (the relu / tied, gated / untied and gated / tied
variants, the relpos tables scaled to N(0, 1) so that the bias moves the
scores), sources padded at their tails (``src_valid``);
Seq2SeqTransformer at 2 + 2 layers, d 32, 4 heads, FFN 64; a GPT of
vocab 7 for ``beam_search``. Covered: ``relative_position_bucket`` (exact),
``flash_attention`` with a bias against JAX's jnp path (o and every
gradient, dbias included, for [1, h], [b, 1] and [b, h] biases, a scale of
0.3 and a softcap), T5 logits, loss and every gradient (the relpos tables
get theirs through dbias and the gather's scatter-add), the relpos bias
itself (exact, contiguous, its gradient), greedy and beam decode (tokens
equal, scores, beam 1 = greedy), three steps of ``make_train_step`` with
the entry point's optimizer, Seq2Seq's logits, loss, gradients, greedy
decode and beam 1, the decoder stack's self/cross masks in both norm
orders, and the weights' round trip. The weights come from the port's
``init`` (no JAX init runs); the JAX side runs under ``jax.jit``, one
compiled function a model shared by the cases. fp32 at rtol 1e-5 / atol 2e-5 (BASELINE.md:16),
gradients at atol 5e-5 (the flash tests'), beam scores at 1e-4 (sums of
steps' log-probabilities); bf16 logits within 3e-2 of max(1, max |JAX|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu import nn as jnn
from np_modeling_tpu import ops as jops
from np_modeling_tpu import training as jtraining
from np_modeling_tpu.models.beam import beam_search as jbeam_search
from np_modeling_tpu.models.t5 import relative_position_bucket as jbucket
from np_modeling_tpu.training import schedules as jschedules
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import nn as tnn
from np_modeling_tpu_torch import ops, train_gpt, training
from np_modeling_tpu_torch.models.t5 import relative_position_bucket
from np_modeling_tpu_torch.utils import (load_params, params_from_numpy,
                                         params_to_numpy, tree_to_numpy)

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-5, atol=5e-5)
T5_CFG = dict(vocab_size=128, d_model=64, d_kv=16, num_heads=4,
              num_encoder_layers=2, num_decoder_layers=2, d_ff=128,
              relpos_buckets=8, relpos_max_distance=20)
VARIANTS = {"relu_tied": dict(gated_act=False, tie_embeddings=True),
            "gated_untied": dict(gated_act=True, tie_embeddings=False),
            "gated_tied": dict(gated_act=True, tie_embeddings=True)}
S2S_CFG = dict(vocab_size=50, d_model=32, num_heads=4, num_encoder_layers=2,
               num_decoder_layers=2, hidden_units=64, max_len=24)
B, S_SRC, S_TGT = 2, 11, 9
rng = np.random.default_rng(0)


def _randn(*shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _weights(model):
    """A port model's seeded weights as the JAX tree (numpy)."""
    return params_to_numpy(model.init(torch.Generator().manual_seed(1)))


def _check_tree(got, want, tol):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(_np(want))
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **tol),
        got, want)


def _batch():
    src = rng.integers(1, 128, (B, S_SRC))
    valid = np.ones((B, S_SRC), np.int32)
    valid[0, 7:] = 0
    valid[1, 4:] = 0
    tgt = rng.integers(0, 128, (B, S_TGT + 1))
    return src, valid, tgt


class _T5Pair:
    """A variant's JAX model, its numpy tree, the port's model on those
    weights and the jitted JAX functions the cases share."""

    def __init__(self, variant, dtype=None):
        cfg = dict(T5_CFG, **VARIANTS[variant])
        self.jt5 = jmodels.T5(jmodels.T5Config(**cfg, dtype=dtype))
        tdtype = torch.bfloat16 if dtype is not None else None
        tree = _weights(tmodels.T5(tmodels.T5Config(**cfg, dtype=tdtype),
                                   device="cpu"))
        for name in ("enc_relpos", "dec_relpos"):  # N(0, 1): a bias that bites
            tree[name] = tree[name] * 50.0
        self.tree = tree
        self.tt5 = params_from_numpy(tree, tmodels.T5Config(
            **cfg, dtype=tdtype), device="cpu")
        jt5 = self.jt5
        self.apply = jax.jit(lambda p, s, t, v: jt5.apply(p, s, t,
                                                          src_valid=v))
        # loss and its gradients, and the logits, in one compiled function
        self.loss_grad = jax.jit(jax.value_and_grad(
            lambda p, s, t, v: (jt5.loss(p, s, t, src_valid=v),
                                jt5.apply(p, s, t[:, :-1], src_valid=v)),
            has_aux=True))
        self.greedy = jax.jit(
            lambda p, s, v: jt5.greedy_decode(p, s, 0, 6, src_valid=v))
        self.beam = jax.jit(
            lambda p, s, v: jt5.beam_decode(p, s, 0, 5, 3, src_valid=v))


_pairs = {}


def _pair(variant, dtype=None):
    key = (variant, dtype)
    if key not in _pairs:
        _pairs[key] = _T5Pair(variant, dtype)
    return _pairs[key]


# ---- relative_position_bucket and the flash bias ----------------------------

@pytest.mark.parametrize("bidirectional,buckets,max_distance", [
    (True, 32, 128), (False, 32, 128), (True, 8, 20), (False, 8, 20)])
def test_relative_position_bucket_exact(bidirectional, buckets,
                                        max_distance):
    """Every relative position in [-1100, 1100] (t5-base's 32 buckets to 128
    and the tiny config's) to the same bucket as JAX's."""
    rel = np.arange(-1100, 1101)[None]
    want = np.asarray(jbucket(jnp.asarray(rel), bidirectional=bidirectional,
                              num_buckets=buckets, max_distance=max_distance))
    got = relative_position_bucket(torch.tensor(rel),
                                   bidirectional=bidirectional,
                                   num_buckets=buckets,
                                   max_distance=max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bias_shape,kw", [
    ("1h", dict(causal=True)),
    ("b1", dict(scale=0.3, softcap=2.0)),
    ("bh", dict(scale=0.3, causal=True, softcap=2.0)),
    ("1h", dict(segments=True)),
], ids=["1h_causal", "b1_scale_softcap", "bh_causal_scale_softcap",
        "1h_segments"])
def test_flash_bias_vs_jax(bias_shape, kw):
    """The plain path the CPU runs (the kernels' twin) against JAX's jnp
    path: o, dq, dk, dv and dbias summed over the bias's broadcast dims;
    GQA 4/2, sq 12 over skv 17."""
    b, hq, hkv, sq, skv, d = 2, 4, 2, 12, 17, 16
    q, k, v, do = (_randn(b, hq, sq, d), _randn(b, hkv, skv, d),
                   _randn(b, hkv, skv, d), _randn(b, hq, sq, d))
    shape = {"1h": (1, hq), "b1": (b, 1), "bh": (b, hq)}[bias_shape]
    bias = _randn(*shape, sq, skv)
    kw = dict(kw)
    seg = None
    if kw.pop("segments", False):
        kv_seg = np.sort(rng.integers(0, 3, (b, skv)), axis=1)
        seg = (kv_seg[:, :sq].astype(np.int32), kv_seg.astype(np.int32))

    def jf(q, k, v, bias):
        return jops.flash_attention(
            q, k, v, bias=bias, segment_ids=None if seg is None else tuple(
                jnp.asarray(x) for x in seg), **kw)

    want, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v, bias)))
    want_grads = vjp(jnp.asarray(do))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v, bias)]
    got = ops.flash_attention(*leaves[:3], bias=leaves[3],
                              segment_ids=None if seg is None else tuple(
                                  torch.tensor(x) for x in seg), **kw)
    got.backward(torch.tensor(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for leaf, w in zip(leaves, want_grads):
        assert leaf.grad.shape == w.shape
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   **GRAD_TOL)


def test_mha_cross_attention_bias_decode_and_precomputed_kv_vs_jax():
    """MultiHeadAttention.forward against JAX's apply: cross-attention over
    a memory of another width with a (q, kv) segment pair, a mask and a
    bias; precomputed k/v; a decode step through the cache with a bias over
    its slots (the cache's mask replaces the given one, as in JAX)."""
    d, dm, hq = 32, 24, 4
    jm = jnn.MultiHeadAttention(hq, head_dim=8)
    x, mem = _randn(2, 5, d), _randn(2, 7, dm)
    tm = tnn.MultiHeadAttention(d, hq, head_dim=8, kv_features=dm,
                                device="cpu")
    params = _weights(tm)
    params["bk"] = _randn(hq, 8)                 # biases that show
    params["bv"] = _randn(hq, 8)
    load_params(tm, params)
    mask = rng.random((2, 1, 5, 7)) > 0.3
    mask[..., 0] = True
    bias = _randn(1, hq, 5, 7)
    seg = (np.ones((2, 5), np.int32),
           np.array([[1] * 7, [1] * 4 + [0] * 3], np.int32))
    jp = _jtree(params)
    want = jax.jit(lambda p, *a: jm.apply(p, a[0], a[1], mask=a[2], bias=a[3],
                                          segment_ids=a[4:]))(
        jp, *(jnp.asarray(a) for a in (x, mem, mask, bias, *seg)))
    with torch.no_grad():
        got = tm(torch.tensor(x), torch.tensor(mem), mask=torch.tensor(mask),
                 bias=torch.tensor(bias),
                 segment_ids=tuple(torch.tensor(s) for s in seg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        kv = (tm._project(torch.tensor(mem), tm.wk, tm.bk),
              tm._project(torch.tensor(mem), tm.wv, tm.bv))
        got = tm(torch.tensor(x), precomputed_kv=kv, bias=torch.tensor(bias))
    want = jax.jit(lambda p, x, b, k, v: jm.apply(p, x, bias=b,
                                                  precomputed_kv=(k, v)))(
        jp, jnp.asarray(x), jnp.asarray(bias), *(jnp.asarray(t.numpy())
                                                 for t in kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jself = jnn.MultiHeadAttention(hq, head_dim=8, causal=True)
    tself = tnn.MultiHeadAttention(d, hq, head_dim=8, causal=True,
                                   device="cpu")
    sp = _weights(tself)
    jc = jself.init_cache(2, 6, d)
    tc = tself.init_cache(2, 6, d)
    dbias = _randn(1, hq, 1, 6)
    jdecode = jax.jit(lambda p, x, c, b: jself.apply(
        p, x, cache=c, decode=True, bias=b,
        mask=jnp.zeros((1, 1, 1, 6), bool)))
    for i in range(3):
        xi = _randn(2, 1, d)
        want, jc = jdecode(_jtree(sp), jnp.asarray(xi), jc,
                           jnp.asarray(dbias))
        with torch.no_grad():
            got, tc = tself(torch.tensor(xi), cache=tc, decode=True,
                            bias=torch.tensor(dbias),
                            mask=torch.zeros((1, 1, 1, 6), dtype=torch.bool))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---- T5 ---------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["relu_tied", "gated_untied"])
def test_t5_logits_loss_and_grads_vs_jax(variant):
    """Padded sources: logits, loss and every parameter's gradient, the
    relpos tables' included (nonzero: dbias reaches them)."""
    pair = _pair(variant)
    src, valid, tgt = _batch()
    jp = _jtree(pair.tree)
    (jloss, want), jgrads = pair.loss_grad(
        jp, jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid))
    t5 = pair.tt5
    t5.zero_grad(set_to_none=True)
    with torch.no_grad():
        got = t5.apply(torch.tensor(src), torch.tensor(tgt[:, :-1]),
                       src_valid=torch.tensor(valid))
    loss = t5.loss(torch.tensor(src), torch.tensor(tgt),
                   src_valid=torch.tensor(valid))
    loss.backward()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    grads = tree_to_numpy({n: p.grad for n, p in t5.named_parameters()})
    _check_tree(grads, jgrads, GRAD_TOL)
    for name in ("enc_relpos", "dec_relpos"):
        assert np.abs(grads[name]).sum() > 0


def test_t5_bf16_logits_vs_jax():
    """bf16 compute, fp32 master weights (gated, tied, the third variant):
    logits within 3e-2
    of max(1, max |JAX|) (bf16 rounds at other places in the two
    packages)."""
    pair = _pair("gated_tied", jnp.bfloat16)
    src, valid, tgt = _batch()
    want = np.asarray(pair.apply(_jtree(pair.tree), jnp.asarray(src),
                                 jnp.asarray(tgt[:, :-1]), jnp.asarray(valid)))
    with torch.no_grad():
        got = pair.tt5.apply(torch.tensor(src), torch.tensor(tgt[:, :-1]),
                             src_valid=torch.tensor(valid)).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) <= 3e-2


def test_t5_greedy_and_beam_decode_vs_jax():
    """Gated, untied: greedy decode of 6 tokens equal to JAX's (padded
    sources); beam 1 equals greedy (tests/test_t5.py:132's identity); beam
    3 of 5 steps: tokens equal to JAX's, scores within 1e-4."""
    pair = _pair("gated_untied")
    src, valid, _ = _batch()
    jp = _jtree(pair.tree)
    want = np.asarray(pair.greedy(jp, jnp.asarray(src), jnp.asarray(valid)))
    ts, tv = torch.tensor(src), torch.tensor(valid)
    got = pair.tt5.greedy_decode(ts, 0, 6, src_valid=tv)
    np.testing.assert_array_equal(got.numpy(), want)
    toks, scores = pair.tt5.beam_decode(ts, 0, 6, 1, src_valid=tv)
    np.testing.assert_array_equal(toks[:, 0].numpy(), want)
    assert torch.isfinite(scores).all()
    jtoks, jscores = pair.beam(jp, jnp.asarray(src), jnp.asarray(valid))
    toks, scores = pair.tt5.beam_decode(ts, 0, 5, 3, src_valid=tv)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-4, atol=1e-4)


def test_t5_three_train_steps_vs_jax():
    """make_train_step over T5.loss with the entry point's optimizer
    (chain(clip_by_global_norm(1.0), adamw(warmup_cosine(3e-4, 10, 3))))
    against JAX's make_train_step, three steps on the same batches: each
    step's loss and every parameter after the third (a model of its own on
    the variant's weights). Dropout 0: JAX's T5
    draws its masks from jax.random, the port from its own Philox bits."""
    pair = _pair("relu_tied")
    t5 = params_from_numpy(pair.tree, tmodels.T5Config(
        **T5_CFG, **VARIANTS["relu_tied"]), device="cpu")
    batches = [_batch() for _ in range(3)]
    opt = train_gpt.recipe(3)
    params = dict(t5.named_parameters())
    state = opt.init(params)
    step = training.make_train_step(
        lambda x, training, rngs: t5.loss(x["src"], x["tgt"], training, rngs,
                                          src_valid=x["valid"]),
        lambda loss, _: loss, opt)
    jopt = jtraining.chain(jtraining.clip_by_global_norm(1.0),
                           jtraining.adamw(jschedules.warmup_cosine(
                               3e-4, warmup_steps=10, total_steps=3)))
    jstep = jtraining.make_train_step(
        lambda p, x, training, rngs: pair.jt5.loss(
            p, x["src"], x["tgt"], training, rngs, src_valid=x["valid"]),
        lambda loss, _: loss, jopt, donate=False)
    jp = _jtree(pair.tree)
    jstate = jopt.init(jp)
    for src, valid, tgt in batches:
        params, state, loss = step(
            params, state, {"src": torch.tensor(src), "tgt": torch.tensor(tgt),
                            "valid": torch.tensor(valid)}, None, 1)
        jp, jstate, jloss = jstep(
            jp, jstate, {"src": jnp.asarray(src), "tgt": jnp.asarray(tgt),
                         "valid": jnp.asarray(valid)}, None,
            jax.random.PRNGKey(1))
        np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    _check_tree(params_to_numpy(t5), jp, TOL)


def test_t5_params_round_trip():
    """The JAX tree (untied: lm_head) loads and comes back leaf for leaf;
    a tree with a leaf missing raises."""
    pair = _pair("gated_untied")
    back = params_to_numpy(pair.tt5)
    assert set(back["dec_0"]) == {"self_attention", "cross_attention",
                                  "norm1", "norm2", "norm3", "ffn"}
    assert set(back["dec_0"]["ffn"]) == {"wi_0", "wi_1", "wo"}
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, pair.tree)
    tree = dict(pair.tree)
    del tree["lm_head"]
    with pytest.raises(KeyError):
        params_from_numpy(tree, tmodels.T5Config(
            **T5_CFG, **VARIANTS["gated_untied"]), device="cpu")


@pytest.mark.parametrize("bidirectional", [True, False])
def test_t5_relpos_bias_contiguous_vs_jax(bidirectional):
    """``_relpos_bias`` equals JAX's [1, h, q, k] bias exactly and is
    contiguous (the flash kernels then read it along keys at unit stride),
    for the full square and a decode row; its gradient reaches the table as
    the sum of dbias over each bucket."""
    pair = _pair("relu_tied")
    name = "enc_relpos" if bidirectional else "dec_relpos"
    table = getattr(pair.tt5, name)
    pos = torch.arange(S_SRC)
    jbias = jax.jit(pair.jt5._relpos_bias, static_argnums=3)
    for qpos in (pos, pos[5:6]):
        got = pair.tt5._relpos_bias(table, qpos, pos, bidirectional)
        want = jbias(jnp.asarray(pair.tree[name]), jnp.asarray(qpos.numpy()),
                     jnp.asarray(pos.numpy()), bidirectional)
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    dbias = torch.tensor(_randn(1, T5_CFG["num_heads"], S_SRC, S_SRC))
    grad, = torch.autograd.grad(
        pair.tt5._relpos_bias(table, pos, pos, bidirectional), table, dbias)
    bucket = relative_position_bucket(
        pos[None, :] - pos[:, None], bidirectional=bidirectional,
        num_buckets=T5_CFG["relpos_buckets"],
        max_distance=T5_CFG["relpos_max_distance"])
    want = torch.zeros_like(table).index_add_(
        0, bucket.reshape(-1), dbias[0].permute(1, 2, 0).reshape(
            -1, T5_CFG["num_heads"]))
    np.testing.assert_allclose(grad.numpy(), want.numpy(), **TOL)


# ---- beam_search (GPT) ------------------------------------------------------

def test_gpt_beam_search_vs_jax():
    """beam_search over GPT's dense decode: beam 4 over a vocab of 7 for 5
    steps, with EOS 2 (finished beams frozen) and a length penalty of 0.8:
    tokens equal to JAX's, scores within 1e-4."""
    cfg = dict(vocab_size=7, d_model=16, num_heads=2, num_layers=1,
               hidden_units=32, max_len=32)
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg))
    tree = _weights(tmodels.GPT(tmodels.GPTConfig(**cfg), device="cpu"))
    tree["embedding"]["table"] = tree["embedding"]["table"] * 50.0
    tgpt = params_from_numpy(tree, tmodels.GPTConfig(**cfg), device="cpu")
    prompt = rng.integers(0, 7, (2, 4))
    want = jax.jit(lambda p, x: jbeam_search(jgpt, p, x, 5, 4, eos_id=2,
                                             alpha=0.8))(
        _jtree(tree), jnp.asarray(prompt))
    got = tmodels.beam_search(tgpt, torch.tensor(prompt), 5, 4, eos_id=2,
                              alpha=0.8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-4, atol=1e-4)


# ---- Seq2SeqTransformer and the decoder stack -------------------------------

@pytest.fixture(scope="module")
def s2s():
    jm = jmodels.Seq2SeqTransformer(jmodels.Seq2SeqConfig(**S2S_CFG))
    tree = _weights(tmodels.Seq2SeqTransformer(
        tmodels.Seq2SeqConfig(**S2S_CFG), device="cpu"))
    tm = params_from_numpy(tree, tmodels.Seq2SeqConfig(**S2S_CFG),
                           device="cpu")
    return jm, tree, tm


def test_seq2seq_logits_loss_grads_and_decode_vs_jax(s2s):
    """Padded sources: logits, loss, every gradient; greedy decode of 6
    tokens equal to JAX's, and beam 1 equal to it (the beam search itself
    is held to JAX's through T5's); the round trip."""
    jm, tree, tm = s2s
    src = rng.integers(0, 50, (B, 10))
    tgt = rng.integers(0, 50, (B, 9))
    valid = np.ones((B, 10), np.int32)
    valid[1, 6:] = 0
    jp = _jtree(tree)
    js, jt, jv = (jnp.asarray(x) for x in (src, tgt, valid))
    ts, tt, tv = (torch.tensor(x) for x in (src, tgt, valid))
    (jloss, want), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (jm.loss(p, js, jt, src_valid=jv),
                   jm.apply(p, js, jt[:, :-1], src_valid=jv)),
        has_aux=True))(jp)
    tm.zero_grad(set_to_none=True)
    with torch.no_grad():
        got = tm.apply(ts, tt[:, :-1], src_valid=tv)
    loss = tm.loss(ts, tt, src_valid=tv)
    loss.backward()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    _check_tree(tree_to_numpy({n: p.grad for n, p in tm.named_parameters()}),
                jgrads, GRAD_TOL)
    want = jax.jit(lambda p: jm.greedy_decode(p, js, 1, 6, src_valid=jv))(jp)
    np.testing.assert_array_equal(
        tm.greedy_decode(ts, 1, 6, src_valid=tv).numpy(), np.asarray(want))
    toks, scores = tm.beam_decode(ts, 1, 6, 1, src_valid=tv)
    np.testing.assert_array_equal(toks[:, 0].numpy(), np.asarray(want))
    assert torch.isfinite(scores).all()
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_numpy(tm), tree)


@pytest.mark.parametrize("norm_first", [True, False],
                         ids=["pre_norm", "post_norm"])
def test_decoder_stack_masks_vs_jax(norm_first):
    """TransformerDecoder with a self mask and a cross mask (the forward of
    K1's mask option on the card) and TransformerEncoder with a mask, in
    both norm orders, against JAX's stacks."""
    d = 32
    jdec = jnn.TransformerDecoder(2, 4, 64, norm_first)
    jenc = jnn.TransformerEncoder(2, 4, 64, norm_first)
    q, kv = _randn(2, 6, d), _randn(2, 9, d)
    tdec = tnn.TransformerDecoder(d, 2, 4, 64, norm_first, device="cpu")
    tenc = tnn.TransformerEncoder(d, 2, 4, 64, norm_first, device="cpu")
    dtree, etree = _weights(tdec), _weights(tenc)
    self_mask = rng.random((2, 1, 6, 6)) > 0.3
    cross_mask = rng.random((2, 1, 6, 9)) > 0.3
    enc_mask = rng.random((1, 1, 9, 9)) > 0.3
    for m in (self_mask, cross_mask, enc_mask):
        m[..., 0] = True
    want = jax.jit(lambda p, *a: jdec.apply(p, a[0], a[1], self_mask=a[2],
                                            cross_mask=a[3]))(
        _jtree(dtree), *(jnp.asarray(a) for a in (q, kv, self_mask,
                                                   cross_mask)))
    wenc = jax.jit(lambda p, x, m: jenc.apply(p, x, mask=m))(
        _jtree(etree), jnp.asarray(kv), jnp.asarray(enc_mask))
    with torch.no_grad():
        got = tdec(torch.tensor(q), torch.tensor(kv),
                   self_mask=torch.tensor(self_mask),
                   cross_mask=torch.tensor(cross_mask))
        genc = tenc(torch.tensor(kv), mask=torch.tensor(enc_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(genc.numpy(), np.asarray(wenc), **TOL)
