"""The port's ``ops.matmul`` (K11's wrapper) and ``ops.linear`` against the
JAX package's, on the CPU.

JAX runs its Pallas kernel K11 in interpret mode (``force_pallas(True,
interpret=True)`` with 128-blocks, as tests/test_matmul.py runs it); the port
runs its CPU path three ways: the default ``matmul``, ``matmul`` inside
``force_kernels()`` (still the plain version on CPU tensors) and
``matmul_reference`` (K11's plain version). Tolerances are JAX's own for the
kernel, rtol 1e-5 and atol 1e-4; ``ops.linear`` and its three gradients at
rtol 1e-5 / atol 2e-5 (BASELINE.md:16). The CUDA kernel runs only on the card
(tests/test_torch_cuda.py).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import ops as jops
from np_modeling_tpu.ops import dispatch as jdispatch
from np_modeling_tpu.ops.matmul import matmul as jmatmul
from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.ops import dispatch

TOL = dict(rtol=1e-5, atol=1e-4)
BLOCKS = dict(block_m=128, block_n=128, block_k=128)
rng = np.random.default_rng(31)


def _randn(*shape):
    return rng.standard_normal(shape).astype(np.float32)


def _port(path, *args, **kw):
    if path == "forced":
        with dispatch.force_kernels():
            return ops.matmul(*args, **kw)
    fn = ops.matmul if path == "default" else ops.matmul_reference
    return fn(*args, **kw)


def _jax_kernel(*args, **kw):
    with jdispatch.force_pallas(True, interpret=True):
        return jmatmul(*args, **kw, **BLOCKS)


PATHS = ["default", "forced", "reference"]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 512, 384),
                                   (100, 70, 50), (8, 1024, 8)])
def test_matmul_vs_jax_kernel(m, k, n, path):
    a, b = _randn(m, k), _randn(k, n)
    want = _jax_kernel(jnp.asarray(a), jnp.asarray(b))
    got = _port(path, torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_matmul_transposes_vs_jax_kernel(trans_a, trans_b, path):
    m, k, n = 128, 256, 96
    a = _randn(*((k, m) if trans_a else (m, k)))
    b = _randn(*((n, k) if trans_b else (k, n)))
    kw = dict(trans_a=trans_a, trans_b=trans_b)
    want = _jax_kernel(jnp.asarray(a), jnp.asarray(b), **kw)
    got = _port(path, torch.tensor(a), torch.tensor(b), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_matmul_bias_epilogue_vs_jax_kernel(out_dtype, path):
    """The bias joins the fp32 sum before the one rounding: bf16 out agrees
    within one bf16 ulp (the fp32 sums may differ in order)."""
    a, b, bias = _randn(130, 70), _randn(70, 50), _randn(50)
    want = _jax_kernel(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
                       out_dtype=out_dtype and getattr(jnp, out_dtype))
    got = _port(path, torch.tensor(a), torch.tensor(b), torch.tensor(bias),
                out_dtype=out_dtype and getattr(torch, out_dtype))
    want = np.asarray(want.astype(jnp.float32))
    if out_dtype is None:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                      - 7)
        assert (np.abs(got - want) <= ulp + TOL["atol"]).all()


@pytest.mark.parametrize("path", PATHS)
def test_matmul_bf16_inputs_fp32_accumulation(path):
    a = jnp.asarray(_randn(128, 256)).astype(jnp.bfloat16)
    b = jnp.asarray(_randn(256, 128)).astype(jnp.bfloat16)
    want = _jax_kernel(a, b, out_dtype=jnp.float32)
    ta = torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16()
    tb = torch.tensor(np.asarray(b.astype(jnp.float32))).bfloat16()
    got = _port(path, ta, tb, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # bf16 operands give a bf16 result by default, as in JAX.
    assert _port(path, ta, tb).dtype == torch.bfloat16


@pytest.mark.parametrize("path", PATHS)
def test_matmul_mixed_operands_promote_like_jax(path):
    """bf16 x fp32 promotes to fp32 (JAX's dot_general; the default path)."""
    a = jnp.asarray(_randn(33, 64)).astype(jnp.bfloat16)
    b = _randn(64, 40)
    with jdispatch.force_pallas(False):
        want = jmatmul(a, jnp.asarray(b))
    got = _port(path, torch.tensor(np.asarray(a.astype(jnp.float32)))
                .bfloat16(), torch.tensor(b))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_matmul_rejects_what_jax_asserts():
    with pytest.raises(ValueError, match="contraction"):
        ops.matmul(torch.ones(3, 4), torch.ones(5, 6))
    with pytest.raises(ValueError, match="2-D"):
        ops.matmul(torch.ones(2, 3, 4), torch.ones(4, 6))


def test_matmul_block_sizes_change_nothing_and_cpu_launches_nothing():
    a, b = torch.tensor(_randn(50, 60)), torch.tensor(_randn(60, 70))
    before = ops.matmul.launches
    with dispatch.force_kernels():
        got = ops.matmul(a, b, block_m=8, block_n=1024, block_k=16)
    assert torch.equal(got, ops.matmul(a, b))
    assert ops.matmul.launches == before


# ---- force_kernels() --------------------------------------------------------

def test_force_kernels_scopes_nest_and_restore():
    assert not dispatch.kernels_forced()
    with dispatch.force_kernels():
        assert dispatch.kernels_forced()
        with dispatch.force_kernels():
            assert dispatch.kernels_forced()
        assert dispatch.kernels_forced()
        with dispatch.force_plain():             # plain wins over forced
            assert dispatch.kernels_forced() and dispatch.plain_forced()
            assert not dispatch.use_kernel(torch.ones(1))
        assert not dispatch.plain_forced()
    assert not dispatch.kernels_forced()


def test_force_kernels_restores_on_exceptions():
    with pytest.raises(RuntimeError):
        with dispatch.force_kernels():
            with dispatch.force_plain():
                raise RuntimeError("inside")
    assert not dispatch.kernels_forced() and not dispatch.plain_forced()


def test_force_kernels_leaves_cpu_tensors_on_the_plain_versions():
    with dispatch.force_kernels():
        assert not dispatch.use_kernel(torch.ones(1))


def test_within_carries_the_scopes_to_another_thread():
    import threading
    seen = []
    with dispatch.force_kernels():
        saved = dispatch.scopes()

    def worker():
        seen.append(dispatch.kernels_forced())
        with dispatch.within(saved):
            seen.append(dispatch.scopes())
        seen.append(dispatch.kernels_forced())

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert seen == [False, (True, False), False]


def test_linear_backward_runs_in_the_forwards_scopes(monkeypatch):
    """Autograd runs a CUDA backward on its own thread, outside the caller's
    scopes: the backward's products see the scopes the forward saw."""
    import importlib
    tlinear = importlib.import_module("np_modeling_tpu_torch.ops.linear")
    seen = []

    def spy(*args, **kw):
        seen.append(dispatch.kernels_forced())
        return ops.matmul(*args, **kw)

    monkeypatch.setattr(tlinear, "matmul", spy)
    x = torch.tensor(_randn(4, 8), requires_grad=True)
    w = torch.tensor(_randn(8, 3), requires_grad=True)
    with dispatch.force_kernels():
        y = ops.linear(x, w)
    y.sum().backward()                  # outside the scope
    assert seen == [True, True, True]


# ---- ops.linear --------------------------------------------------------------

@pytest.mark.parametrize("forced", [False, True], ids=["default", "forced"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(2, 5, 24, 40), (130, 70, 50)])
def test_linear_and_grads_vs_jax_kernel(shape, bias, forced):
    """Forward and dx, dw, db against JAX's ``ops.linear`` whose three
    products run K11 in interpret mode."""
    *lead, d_in, d_out = shape
    x, w, b = _randn(*lead, d_in), _randn(d_in, d_out), _randn(d_out)
    dy = _randn(*lead, d_out)
    args = (x, w, b) if bias else (x, w)
    with jdispatch.force_pallas(True, interpret=True):
        want, vjp = jax.vjp(lambda *a: jops.linear(*a),
                            *map(jnp.asarray, args))
        jgrads = vjp(jnp.asarray(dy))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    with dispatch.force_kernels() if forced else contextlib.nullcontext():
        got = ops.linear(*leaves)
        got.backward(torch.tensor(dy))
    tol = dict(rtol=1e-5, atol=2e-5 * max(1.0, (max(lead[-1], d_in) / 64)
                                          ** 0.5))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    for t, g in zip(leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **tol)
