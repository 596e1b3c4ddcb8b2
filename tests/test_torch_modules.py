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
from np_modeling_tpu_torch.utils import params_from_numpy, params_to_numpy

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

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


def test_linear_bf16_rounds_once_like_jax():
    """Integer-valued bf16 x and w with quarter-integer b: every fp32 sum is
    exact, so the one rounding of JAX's ``(x @ w + b) -> bf16`` must be
    matched bit for bit (a product rounded to bf16 before the bias add is
    not)."""
    x = rng.integers(-8, 9, (64, 32)).astype(np.float32)
    w = rng.integers(-8, 9, (32, 48)).astype(np.float32)
    b = rng.integers(-16, 17, (48,)).astype(np.float32) / 4
    want = jops.linear(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(w, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16))
    got = ops.linear(torch.tensor(x).bfloat16(), torch.tensor(w).bfloat16(),
                     torch.tensor(b).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("bias", [True, False])
def test_linear_backward_vs_jax_vjp(bias):
    x, w, b, dy = _randn(2, 5, 24), _randn(24, 40), _randn(40), _randn(2, 5, 40)
    args = (x, w, b) if bias else (x, w)
    _, vjp = jax.vjp(lambda *a: jops.linear(*a), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    ops.linear(*leaves).backward(torch.tensor(dy))
    for t, g in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("name", ["relu", "gelu"])
def test_activation_backward_vs_jax_vjp(name):
    x, dy = _randn(3, 5, 16) * 3, _randn(3, 5, 16)
    x[0, 0, :4] = 0.0                 # relu passes the gradient at x == 0
    _, vjp = jax.vjp(getattr(jops, name), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    tx = torch.tensor(x, requires_grad=True)
    getattr(ops, name)(tx).backward(torch.tensor(dy))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **TOL)


def test_layer_norm_backward_vs_jax_vjp():
    x, g, b = _randn(4, 6, 32) * 2 + 1, _randn(32), _randn(32)
    dz = _randn(4, 6, 32)
    _, vjp = jax.vjp(lambda x, g, b: jops.layer_norm(x, g, b, 1e-3),
                     *map(jnp.asarray, (x, g, b)))
    want = vjp(jnp.asarray(dz))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, g, b)]
    ops.layer_norm(*leaves, 1e-3).backward(torch.tensor(dz))
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=5e-5)


def test_embedding_backward_vs_jax_vjp():
    table = _randn(20, 8)
    ids = rng.integers(0, 20, (4, 9)).astype(np.int32)   # with repeats
    dy = _randn(4, 9, 8)
    _, vjp = jax.vjp(lambda t: jops.embedding_lookup(t, jnp.asarray(ids)),
                     jnp.asarray(table))
    (want,) = vjp(jnp.asarray(dy))
    tt = torch.tensor(table, requires_grad=True)
    ops.embedding_lookup(tt, torch.tensor(ids)).backward(torch.tensor(dy))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), **TOL)


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
    # the port's seeded init and a compiled JAX block (eager JAX traces op
    # by op)
    tree = params_to_numpy(tmodels.GPT(tmodels.GPTConfig(**cfg),
                                       device="cpu").init(
        torch.Generator().manual_seed(1)))
    tgpt = params_from_numpy(tree, tmodels.GPTConfig(**cfg), device="cpu")
    x = _randn(2, 6, 32)
    want = jax.jit(jgpt.block.apply)(
        jax.tree_util.tree_map(jnp.asarray, tree["layer_0"]), jnp.asarray(x))

    eng = GenerationEngine(tgpt, total_pages=9, page_size=4, max_seqs=2,
                           prefill_chunk_size=8)
    st = eng._state
    st["table"][:] = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    st["active"][:] = True
    with torch.no_grad():
        got, st = eng._block_step(tgpt.layer_0, torch.tensor(x), 0, st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
