"""The port's ops and modules against their JAX counterparts.

Inputs come from a seeded numpy generator and go through both; weights are
carried across by utils.convert.params_from_numpy. fp32 at rtol 1e-5 /
atol 2e-5 (BASELINE.md) unless a case states otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu import ops as jops
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.nn import initializers
from np_modeling_tpu_torch.serving import GenerationEngine
from np_modeling_tpu_torch.utils import params_from_numpy

TOL = dict(rtol=1e-5, atol=2e-5)
rng = np.random.default_rng(0)


def _randn(*shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(7,), (3, 5, 16)])
def test_gelu_and_relu(shape):
    x = _randn(*shape) * 3
    np.testing.assert_allclose(ops.gelu(torch.tensor(x)).numpy(),
                               np.asarray(jops.gelu(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(ops.relu(torch.tensor(x)).numpy(),
                               np.asarray(jops.relu(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("eps", [1e-3, 1e-5])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_layer_norm(eps, dtype):
    x, g, b = _randn(4, 6, 32) * 2 + 1, _randn(32), _randn(32)
    want = jops.layer_norm(jnp.asarray(x, dtype), jnp.asarray(g),
                           jnp.asarray(b), eps)
    tx = torch.tensor(x).to(torch.bfloat16 if dtype is jnp.bfloat16
                            else torch.float32)
    got = ops.layer_norm(tx, torch.tensor(g), torch.tensor(b), eps)
    assert got.dtype == tx.dtype
    # bf16 output: one rounding of the same fp32 value, at most 1 ulp apart.
    tol = TOL if dtype is np.float32 else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    x, w, b = _randn(2, 5, 24), _randn(24, 40), _randn(40)
    want = jops.linear(jnp.asarray(x), jnp.asarray(w),
                       jnp.asarray(b) if bias else None)
    got = ops.linear(torch.tensor(x), torch.tensor(w),
                     torch.tensor(b) if bias else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embedding():
    table = _randn(50, 16)
    ids = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = jops.embedding_lookup(jnp.asarray(table), jnp.asarray(ids))
    got = ops.embedding_lookup(torch.tensor(table), torch.tensor(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lecun_normal_distribution():
    g = torch.Generator().manual_seed(0)
    w = initializers.lecun_normal(g, (256, 4, 64))        # fan_in 1024
    std = 1 / np.sqrt(1024)
    assert abs(w.std().item() - std) < 0.02 * std
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7


@pytest.mark.parametrize("hkv", [4, 2])
def test_block_step_vs_jax_block(hkv):
    """One TransformerEncoderBlock over a fresh paged cache (the engine's
    block step, t tokens at length 0) equals the JAX block's dense causal
    apply on the same input and weights."""
    cfg = dict(vocab_size=32, d_model=32, num_heads=4, num_kv_heads=hkv,
               num_layers=1, hidden_units=64, max_len=16, activation="gelu",
               ln_eps=1e-5)
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg))
    params = jgpt.init(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))
    tgpt = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             tmodels.GPTConfig(**cfg), device="cpu")
    x = _randn(2, 6, 32)
    want = jgpt.block.apply(params["layer_0"], jnp.asarray(x))

    eng = GenerationEngine(tgpt, total_pages=9, page_size=4, max_seqs=2,
                           prefill_chunk_size=8)
    st = eng._state
    st["table"][:] = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    st["active"][:] = True
    with torch.no_grad():
        got, st = eng._block_step(tgpt.layer_0, torch.tensor(x), 0, st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
