"""BERT, ``gelu_exact`` and the mask's backward in the port against the JAX
package, on the CPU.

The same numpy weights and inputs go through both packages: BERT at 2
layers, d 32, 4 heads of 8, FFN 64, vocab 50, 16 positions, with the MLM
head, in three forms (post-norm with ``gelu_exact``, LayerNorm eps 1e-12
and two token types, HF's; pre-norm with relu; post-norm with the tanh
gelu and no token types), each under four attention surfaces:
``attention_mask`` alone (padded tails, as segment ids), ``mask=`` alone
([b, 1, s, s]), ``mask=`` per head ([1, h, s, s]) with a row that no key
sees, and both together. Covered: ``encode``, ``apply``, ``mlm_logits``,
``mlm_loss`` and every gradient leaf of ``apply``'s mean CE and of
``mlm_loss``; the weights' round trip; HF's ``BertModel`` through the JAX
package's ``import_bert`` and ``params_from_numpy`` (its
``last_hidden_state``); ``gelu_exact`` and its gradient; a GPT with
``gelu_exact`` (GPT-NeoX's form) against JAX's; the plain flash backward
on a row that the mask leaves without a key (p = 1 at every key, as JAX's
jnp path); the card's refusals, as plain Python; ``mlm_mask_tokens`` by
its statistics. The weights come from the port's ``init``; the JAX side
runs under ``jax.jit``, one compiled function a form shared by its cases.
fp32 at rtol 1e-5 / atol 2e-5 (BASELINE.md), gradients at rtol 2e-5 /
atol 5e-5 (the flash tests').
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu import ops as jops
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.ops import attention
from np_modeling_tpu_torch.utils import (params_from_numpy, params_to_numpy,
                                         tree_to_numpy)

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-5, atol=5e-5)
B, S, VOCAB, HEADS = 2, 10, 50, 4
BASE = dict(vocab_size=VOCAB, d_model=32, num_heads=HEADS, num_layers=2,
            hidden_units=64, max_len=16, mlm_head=True)
FORMS = {
    "post_gelu_exact_types": dict(activation="gelu_exact", ln_eps=1e-12,
                                  type_vocab_size=2),
    "pre_relu": dict(activation="relu", norm_first=True),
    "post_gelu": dict(activation="gelu", ln_eps=1e-5),
}
SURFACES = ("attention_mask", "mask", "mask_keyless", "both")
rng = np.random.default_rng(0)


def _randn(*shape):
    return rng.standard_normal(shape).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _check_grads(model, jgrads):
    """Every leaf the port's backward reached within GRAD_TOL of JAX's; the
    leaves it did not reach (the other head's) zero in JAX."""
    got = _flat(tree_to_numpy({n: p.grad for n, p in model.named_parameters()
                               if p.grad is not None}))
    want = _flat(jgrads)
    for name, w in want.items():
        if name in got:
            np.testing.assert_allclose(got[name], w, **GRAD_TOL,
                                       err_msg=name)
        else:
            assert not np.any(w), f"{name}: JAX gradient nonzero, port none"
    assert set(got) <= set(want)


@functools.lru_cache(maxsize=None)
def _form(name):
    """(the port's model, its weights as the JAX tree, JAX's compiled run)
    of a form: one model and one jitted function shared by its cases."""
    cfg = {**BASE, **FORMS[name]}
    tm = tmodels.BertEncoder(tmodels.BertConfig(**cfg), device="cpu").init(
        torch.Generator().manual_seed(1))
    tree = params_to_numpy(tm)
    jm = jmodels.BertEncoder(jmodels.BertConfig(**cfg))

    def run(p, toks, tt, mask, am, labels, mlm_toks, mlm_labels, mlm_w):
        enc = jm.encode(p, toks, mask=mask, attention_mask=am,
                        token_type_ids=tt)

        def cls(p):
            logits = jm.apply(p, toks, mask=mask, attention_mask=am,
                              token_type_ids=tt)
            ce = jops.softmax_cross_entropy_with_integer_labels(logits,
                                                                labels)
            return ce.mean(), logits

        (lc, logits), gc = jax.value_and_grad(cls, has_aux=True)(p)
        lm, gm = jax.value_and_grad(lambda p: jm.mlm_loss(
            p, mlm_toks, mlm_labels, mlm_w, attention_mask=am))(p)
        ml = jm.mlm_logits(p, mlm_toks, attention_mask=am)
        return enc, logits, lc, gc, ml, lm, gm

    return tm, tree, jax.jit(run)


def _surface(kind):
    """(mask or None, attention_mask or None) of a case."""
    am = np.ones((B, S), np.int32)
    am[1, 6:] = 0
    if kind == "attention_mask":
        return None, am
    shape = (1, HEADS, S, S) if kind == "mask_keyless" else (B, 1, S, S)
    mask = rng.random(shape) < 0.7
    mask[..., np.arange(S), np.arange(S)] = True
    if kind == "mask_keyless":
        mask[0, 2, 3] = False       # head 2's row 3 sees no key
    return mask, (am if kind == "both" else None)


@pytest.mark.parametrize("surface", SURFACES)
@pytest.mark.parametrize("form", list(FORMS))
def test_bert_vs_jax(form, surface):
    """encode, apply, mlm_logits, mlm_loss and every gradient of apply's
    mean CE and of mlm_loss against JAX's, in one form under one attention
    surface."""
    tm, tree, jrun = _form(form)
    toks = rng.integers(0, VOCAB, (B, S))
    tt = (rng.integers(0, 2, (B, S)) if FORMS[form].get("type_vocab_size")
          else None)
    mask, am = _surface(surface)
    labels = rng.integers(0, 2, (B,))
    mlm_toks, mlm_labels, mlm_w = tmodels.mlm_mask_tokens(
        torch.Generator().manual_seed(2), torch.tensor(toks), VOCAB, 3, 0.3)
    mlm_w[0, 0] = 1             # at least one position to predict
    args = (toks, tt, mask, am, labels, mlm_toks.numpy(),
            mlm_labels.numpy(), mlm_w.numpy())
    want = jrun(jax.tree_util.tree_map(jnp.asarray, tree),
                *(None if a is None else jnp.asarray(a) for a in args))
    enc, logits, lc, gc, ml, lm, gm = want
    t = [None if a is None else torch.tensor(a) for a in args]
    kw = dict(mask=t[2], attention_mask=t[3], token_type_ids=t[1])
    with torch.no_grad():
        np.testing.assert_allclose(tm.encode(t[0], **kw).numpy(),
                                   np.asarray(enc), **TOL)
        np.testing.assert_allclose(tm.mlm_logits(t[5], attention_mask=t[3])
                                   .numpy(), np.asarray(ml), **TOL)
    tm.zero_grad(set_to_none=True)
    got = tm.apply(t[0], **kw)
    loss = ops.softmax_cross_entropy_with_integer_labels(got, t[4]).mean()
    loss.backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               **TOL)
    np.testing.assert_allclose(loss.item(), float(lc), **TOL)
    _check_grads(tm, gc)
    tm.zero_grad(set_to_none=True)
    loss = tm.mlm_loss(t[5], t[6], t[7], attention_mask=t[3])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lm), **TOL)
    _check_grads(tm, gm)


def test_bert_params_round_trip_and_surface():
    """params_from_numpy gives back a BertEncoder holding the tree's weights
    (and params_to_numpy the tree); the JAX refusals hold."""
    tm, tree, _ = _form("post_gelu_exact_types")
    cfg = tmodels.BertConfig(**{**BASE, **FORMS["post_gelu_exact_types"]})
    back = params_from_numpy(tree, cfg, device="cpu")
    assert isinstance(back, tmodels.BertEncoder)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_numpy(back), tree)
    assert sorted(tree) == sorted(
        ["embedding", "pos_embedding", "type_embedding", "embed_norm",
         "layer_0", "layer_1", "pooler", "classifier", "mlm_transform",
         "mlm_norm", "mlm_bias"])
    plain = tmodels.BertEncoder(
        tmodels.BertConfig(**{**BASE, "mlm_head": False}), device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="mlm_head"):
        plain.mlm_logits(toks)
    with pytest.raises(ValueError, match="type_vocab_size"):
        plain.encode(toks, token_type_ids=toks)
    with pytest.raises(ValueError, match="attention_mask"):
        plain.encode(toks, attention_mask=torch.ones(1, 3))


def test_bert_dropout_trains_with_seeded_rngs():
    """With dropout, training draws its masks from the rngs: the same seed
    gives the same logits, another seed others; eval is the identity."""
    cfg = tmodels.BertConfig(**{**BASE, "drop_rate": 0.1})
    tm = tmodels.BertEncoder(cfg, device="cpu").init(
        torch.Generator().manual_seed(4))
    toks = torch.tensor(rng.integers(0, VOCAB, (B, S)))
    with torch.no_grad():
        a = tm.apply(toks, training=True, rngs={"dropout": 7})
        b = tm.apply(toks, training=True, rngs={"dropout": 7})
        c = tm.apply(toks, training=True, rngs={"dropout": 8})
        e = tm.apply(toks)
        f = tm.apply(toks, training=False, rngs={"dropout": 7})
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(e, f) and not torch.equal(a, e)


def test_bert_import_of_hf_model_matches_hf():
    """A local random transformers.BertModel through the JAX package's
    import_bert and params_from_numpy: the port's encode equals HF's
    last_hidden_state at tests/test_hf_bert.py's TOL, padded rows on their
    real positions."""
    transformers = pytest.importorskip("transformers")
    from np_modeling_tpu.utils import hf_compat
    hf_tol = dict(rtol=1e-4, atol=2e-5)
    torch.manual_seed(0)
    model = transformers.BertModel(transformers.BertConfig(
        vocab_size=113, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        hidden_act="gelu"))
    model.eval()
    jcfg, params = hf_compat.import_bert(model)
    cfg = tmodels.BertConfig(**dataclasses.asdict(jcfg))
    assert cfg.activation == "gelu_exact" and cfg.ln_eps == 1e-12
    bert = params_from_numpy(params, cfg, device="cpu")
    toks = torch.tensor(rng.integers(0, 113, (2, 10)))
    tt = torch.tensor(rng.integers(0, 2, (2, 10)))
    am = torch.ones((2, 10), dtype=torch.long)
    am[1, 7:] = 0
    with torch.no_grad():
        want = model(toks, token_type_ids=tt).last_hidden_state
        got = bert.encode(toks, token_type_ids=tt)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **hf_tol)
        want = model(toks, attention_mask=am).last_hidden_state
        got = bert.encode(toks, attention_mask=am)
    for r, n in enumerate(am.sum(1).tolist()):
        np.testing.assert_allclose(got[r, :n].numpy(), want[r, :n].numpy(),
                                   **hf_tol)


@pytest.mark.parametrize("shape", [(7,), (3, 5, 16)])
def test_gelu_exact_and_gradient_vs_jax(shape):
    """ops.gelu_exact (erf form) and its hand-written backward, Phi(x) +
    x phi(x), against JAX's op and vjp; get_activation knows it."""
    x, dy = _randn(*shape) * 3, _randn(*shape)
    want, vjp = jax.vjp(jops.gelu_exact, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(dy))
    tx = torch.tensor(x, requires_grad=True)
    got = ops.get_activation("gelu_exact")(tx)
    got.backward(torch.tensor(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), **TOL)
    assert ops.get_activation("gelu_exact") is ops.gelu_exact


def test_gpt_gelu_exact_vs_jax():
    """A GPT with activation="gelu_exact" (GPT-NeoX's FFN form) is built
    (check_ported admits it) and its logits, loss and gradients equal
    JAX's."""
    cfg = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2,
               hidden_units=64, max_len=16, activation="gelu_exact",
               ln_eps=1e-5)
    tree = params_to_numpy(tmodels.GPT(tmodels.GPTConfig(**cfg),
                                       device="cpu").init(
        torch.Generator().manual_seed(5)))
    tgpt = params_from_numpy(tree, tmodels.GPTConfig(**cfg), device="cpu")
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg))
    tokens = rng.integers(0, 64, (2, 16)).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    want, jgrads = jax.jit(jax.value_and_grad(jgpt.loss))(
        jp, jnp.asarray(tokens))
    logits = jax.jit(jgpt.apply)(jp, jnp.asarray(tokens))
    with torch.no_grad():
        np.testing.assert_allclose(tgpt.apply(torch.tensor(tokens)).numpy(),
                                   np.asarray(logits), **TOL)
    got = tgpt.loss(torch.tensor(tokens))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    _check_grads(tgpt, jgrads)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_mask_keyless_row_backward_vs_jax(causal):
    """A row that the mask leaves without a key: its lse is the mask value
    (mask + log(skv) rounds to it in fp32), so the backward's p is 1 at
    every key, not 1/skv: with do on that row alone, dv = do at every key
    and dq is nonzero, in the port's plain path as in JAX's jnp path; o,
    dq, dk, dv equal JAX's, causal or not."""
    q, k, v = _randn(1, 1, 4, 8), _randn(1, 1, 6, 8), _randn(1, 1, 6, 8)
    mask = rng.random((1, 1, 4, 6)) < 0.7
    mask[0, 0, :, 0] = True
    mask[0, 0, 1] = False
    do = np.zeros((1, 1, 4, 8), np.float32)
    do[0, 0, 1] = 1.0
    do[0, 0, 3] = _randn(8)
    kw = dict(causal=causal)
    want, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(
        q, k, v, mask=jnp.asarray(mask), **kw), *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = ops.flash_attention(*leaves, mask=torch.tensor(mask), **kw)
    got.backward(torch.tensor(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for t, w in zip(leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)
    # The keyless row alone: dv = do there at every key, dq nonzero.
    do1 = torch.zeros_like(leaves[0])
    do1[0, 0, 1] = 1.0
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = ops.flash_attention(*leaves, mask=torch.tensor(mask), **kw)
    o.backward(do1)
    np.testing.assert_allclose(leaves[2].grad[0, 0].numpy(),
                               np.ones((6, 8), np.float32), **TOL)
    assert leaves[0].grad[0, 0, 1].abs().max() > 1e-3


@pytest.mark.parametrize("case,why", [
    (dict(d=64), None),
    (dict(d=64, window=8), "a mask with a window"),
    (dict(d=64, softcap=5.0), "a mask with a softcap"),
    (dict(d=64, bias=True), "a mask with a bias"),
    (dict(d=128), "a mask at head_dim 128"),
    (dict(d=256, window=8, softcap=5.0),
     "a mask with a window or a softcap"),
], ids=["built", "window", "softcap", "bias", "d128", "d256_both"])
def test_flash_mask_backward_built_combinations(case, why):
    """The backwards take the mask alone at head_dim 64: the wrapper's
    guard names every other combination (it raises on the card, naming
    ROADMAP.md Queue 2 A, before any launch)."""
    got = attention._mask_bwd_unbuilt(case["d"], case.get("window"),
                                      case.get("softcap"), case.get("bias"))
    assert got == why


def test_mlm_mask_tokens_statistics():
    """BERT's corruption over 64 x 512 tokens at 15%: the share selected
    within 5 sigma of the binomial; among the selected, [MASK] / another
    id / kept within a chi-square bound of 13.82 (2 degrees of freedom, p
    = 0.001) of 0.8 / 0.1 / 0.1 (a random id that lands on [MASK] or on
    the token itself counted where it lands); special tokens never picked;
    labels the tokens; unselected positions unchanged; the same seed the
    same draw."""
    vocab, mask_token, special = 30522, 103, (0, 101, 102)
    toks = torch.tensor(rng.integers(1000, vocab, (64, 512)))
    toks[:, 0], toks[:, 255], toks[:, 511] = 101, 102, 102
    toks[::4, 400:511] = 0                              # padding
    gen = torch.Generator().manual_seed(9)
    inputs, labels, weights = tmodels.mlm_mask_tokens(
        gen, toks, vocab, mask_token, 0.15, special)
    again = tmodels.mlm_mask_tokens(torch.Generator().manual_seed(9), toks,
                                    vocab, mask_token, 0.15, special)
    assert all(torch.equal(a, b) for a, b in zip((inputs, labels, weights),
                                                 again))
    assert torch.equal(labels, toks) and weights.dtype == torch.int32
    sel = weights.bool()
    specials = torch.isin(toks, torch.tensor(special))
    assert not (sel & specials).any()
    assert torch.equal(inputs[~sel], toks[~sel])
    n, k = int((~specials).sum()), int(sel.sum())
    sigma = (n * 0.15 * 0.85) ** 0.5
    assert abs(k - 0.15 * n) < 5 * sigma, (k, n)
    got = inputs[sel]
    is_mask = got == mask_token
    kept = got == toks[sel]
    counts = np.array([int(is_mask.sum()), int((~is_mask & ~kept).sum()),
                       int(kept.sum())])
    probs = np.array([0.8 + 0.1 / vocab, 0.1 - 0.2 / vocab,
                      0.1 + 0.1 / vocab])
    chi2 = float(((counts - k * probs) ** 2 / (k * probs)).sum())
    assert chi2 < 13.82, (counts, chi2)
    assert int(got.min()) >= 0 and int(got.max()) < vocab
