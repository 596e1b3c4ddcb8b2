"""Packed-document training in the port against the JAX package.

A packed row holds several documents back to back: ``segment_ids`` number
them and keep each from attending to the others (inside the flash
kernels), and ``positions`` restart at 0 in each. ``GPT.apply`` logits and
``GPT.loss`` with its gradients go through both packages on the same
seeded weights and batches (2 layers, d 32, 4 heads, vocab 64, max_len 32),
fused and unfused loss, at full length and at ``max_len + 1`` tokens, where
both cut the last input. The batches reach the device through
``prefetch_to_device`` as dicts and namedtuples. fp32 at rtol 1e-5 / atol
2e-5; gradients at atol 5e-5, and at 1e-4 for the ``max_len + 1`` case.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu.training import data as jdata
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch.training import data
from np_modeling_tpu_torch.utils import params_from_numpy, tree_to_numpy

TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-5, atol=5e-5)
SLICED_GRAD_TOL = dict(rtol=1e-5, atol=1e-4)
VOCAB, MAX_LEN = 64, 32
rng = np.random.default_rng(0)


def _gpt_pair(fused):
    cfg = dict(vocab_size=VOCAB, d_model=32, num_heads=4, num_layers=2,
               hidden_units=64, max_len=MAX_LEN, fused_loss=fused)
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg))
    params = jgpt.init(jax.random.PRNGKey(5),
                       jnp.zeros((1, MAX_LEN), jnp.int32))
    tgpt = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             tmodels.GPTConfig(**cfg), device="cpu")
    return jgpt, params, tgpt


def _packed(b, s, mean_len=8):
    """Rows of documents packed in order: tokens, segment ids (the
    documents of a row numbered from 0) and positions (0 at each
    document's start); the last document of a row is cut at its end."""
    tokens = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    seg = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    for r in range(b):
        start, doc = 0, 0
        while start < s:
            n = min(int(rng.integers(1, 2 * mean_len)), s - start)
            seg[r, start:start + n] = doc
            pos[r, start:start + n] = np.arange(n)
            start, doc = start + n, doc + 1
    return tokens, seg, pos


def _assert_grads_close(tgpt, jgrads, **tol):
    got = tree_to_numpy({n: p.grad for n, p in tgpt.named_parameters()})
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(g, np.asarray(flat_want[path]), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def _loss_vs_jax(fused, tokens, seg, pos, grad_tol):
    jgpt, params, tgpt = _gpt_pair(fused)
    jkw = {k: None if x is None else jnp.asarray(x)
           for k, x in (("segment_ids", seg), ("positions", pos))}
    want, jgrads = jax.value_and_grad(
        lambda p: jgpt.loss(p, jnp.asarray(tokens), **jkw))(params)
    tkw = {k: None if x is None else torch.tensor(x)
           for k, x in (("segment_ids", seg), ("positions", pos))}
    got = tgpt.loss(torch.tensor(tokens), **tkw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    _assert_grads_close(tgpt, jgrads, **grad_tol)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_packed_loss_and_grads_vs_jax(fused):
    tokens, seg, pos = _packed(3, MAX_LEN)
    _loss_vs_jax(fused, tokens, seg, pos, GRAD_TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("packed", [True, False], ids=["segments", "plain"])
def test_loss_at_max_len_plus_one_vs_jax(packed, fused):
    """S = max_len + 1: both run S - 1 inputs against tokens[..., 1:], with
    segment ids and positions cut alike (JAX transformer_lm.py:409-418)."""
    tokens, seg, pos = _packed(2, MAX_LEN + 1)
    if not packed:
        seg = pos = None
    _loss_vs_jax(fused, tokens, seg, pos, SLICED_GRAD_TOL)


@pytest.mark.parametrize("per_row", [True, False],
                         ids=["positions_b_s", "positions_s"])
def test_packed_apply_logits_vs_jax(per_row):
    jgpt, params, tgpt = _gpt_pair(False)
    tokens, seg, pos = _packed(2, MAX_LEN)
    if not per_row:
        pos = pos[0]
    want = jgpt.apply(params, jnp.asarray(tokens),
                      segment_ids=jnp.asarray(seg), positions=jnp.asarray(pos))
    with torch.no_grad():
        got = tgpt.apply(torch.tensor(tokens), segment_ids=torch.tensor(seg),
                         positions=torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_packed_documents_are_isolated():
    """Each document's logits inside a packed row equal those of the same
    document run alone at positions 0..len-1."""
    _, _, tgpt = _gpt_pair(False)
    tokens, seg, pos = _packed(2, MAX_LEN)
    with torch.no_grad():
        packed = tgpt.apply(torch.tensor(tokens), segment_ids=torch.tensor(seg),
                            positions=torch.tensor(pos))
        n_docs = 0
        for r in range(tokens.shape[0]):
            for doc in np.unique(seg[r]):
                cols = np.flatnonzero(seg[r] == doc)
                alone = tgpt.apply(torch.tensor(tokens[r:r + 1, cols]))
                np.testing.assert_allclose(packed[r, cols].numpy(),
                                           alone[0].numpy(), **TOL)
                n_docs += 1
    assert n_docs > 2 * tokens.shape[0]


Batch = collections.namedtuple("Batch", ["tokens", "segment_ids"])


def test_prefetch_to_device_dicts_and_namedtuples_vs_jax():
    """Dict and namedtuple batches keep their structure, dtypes and values,
    as JAX's prefetch_to_device (tree_map of device_put) keeps them. The
    arrays are 32-bit: JAX without x64 would narrow 64-bit ones."""
    batches = [[{"tokens": rng.integers(0, 9, (2, 4)).astype(np.int32)}],
               Batch(rng.integers(0, 9, (2, 4)).astype(np.int32),
                     np.zeros((2, 4), np.int32)),
               {"tokens": rng.integers(0, 9, (2, 4)).astype(np.int32),
                "pair": (np.ones(3, np.float32),
                         [np.arange(2, dtype=np.int32)])}]
    got = list(data.prefetch_to_device(iter(batches), size=2, device="cpu"))
    want = list(jdata.prefetch_to_device(iter(batches), size=2))
    assert len(got) == len(want) == len(batches)
    for g, w in zip(got, want):
        g_leaves, g_def = jax.tree_util.tree_flatten(
            g, is_leaf=lambda x: isinstance(x, torch.Tensor))
        w_leaves, w_def = jax.tree_util.tree_flatten(w)
        assert g_def == w_def and type(g) is type(w)
        for gl, wl in zip(g_leaves, w_leaves):
            assert isinstance(gl, torch.Tensor) and gl.device.type == "cpu"
            assert gl.numpy().dtype == np.asarray(wl).dtype
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
