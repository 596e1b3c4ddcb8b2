"""The port's int8 quantization against the JAX package's, on the CPU.

``quantize_int8``, ``quantize_params_int8``, ``quantize_params_int4`` and
``dequantize_params`` equal JAX's bit for bit on the same fp32 arrays (all-
zero rows and ties at half a step included). ``int8_matmul``'s plain version
is held against JAX's off-TPU path (fp32 out rtol 1e-5 / atol 2e-5, bf16 out
within one bf16 ulp) and against JAX's Pallas kernel in interpret mode with
bf16 x (the TPU path casts fp32 x to bf16 and rounds twice with a bias, so
fp32 out without bias within 1e-5 relative; bf16 out with bias within one
bf16 ulp of the result plus one of the product that the TPU path rounds
before it adds the bias). Two summation orders of k fp32 terms differ by
~eps * sqrt(k) times the terms, so atol 2e-5 holds at k 64 and is scaled by
sqrt(k / 64) (at most 3.2x, k 640); a bf16 value near 0 that comes out of a
cancelling sum is held to that fp32 tolerance where it exceeds its ulp. The
CUDA kernels run only on the card (tests/test_torch_cuda.py).

``quantize_int8_stochastic`` (K10's plain twin on the CPU): its scales equal
JAX's bit for bit; ``stochastic_round_int8`` equals a numpy transcription of
the TPU kernel's arithmetic (np_modeling_tpu/ops/quantization.py:50-62) for
given uniforms, bit for bit; its Philox words are checked against a Random123
answer vector; its rounding is unbiased over seeds. JAX off the TPU rounds to
nearest (its generator has no CPU emulation), so the values are held to be
floor or floor + 1 of JAX's ``x / scale``, not equal to its values.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import ops as jops
from np_modeling_tpu.nn.linear import Linear as JLinear
from np_modeling_tpu.ops import dispatch as jdispatch
from np_modeling_tpu.ops import quantization as jq
from np_modeling_tpu_torch import models, ops
from np_modeling_tpu_torch.nn import Int8Weight, Linear
from np_modeling_tpu_torch.utils import (load_params, params_from_numpy,
                                         params_to_numpy)

FFN = r".*(dense1/linear/w|dense2/w)$"


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rows_with_ties(rng, n=6, d=40):
    """Random rows, an all-zero row, and rows whose absmax is 127 so that
    x / scale lands exactly on half steps (round-half-even ties)."""
    x = rng.standard_normal((n, d)).astype(np.float32) * 3
    x[1] = 0.0
    x[2, :8] = [127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -127]
    x[3, :4] = [-127, 4.5, -2.5, 5.5]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bit_for_bit(dtype):
    x = _rows_with_ties(np.random.default_rng(0)).reshape(2, 3, 40)
    want = jq.quantize_int8(jnp.asarray(x).astype(dtype))
    got = ops.quantize_int8(torch.tensor(x).to(getattr(torch, dtype)))
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    back = ops.dequantize_int8(got, torch.bfloat16)
    np.testing.assert_array_equal(back.float().numpy(),
                                  _f32(jq.dequantize_int8(want, jnp.bfloat16)))


def _tree(rng):
    """A GPT-shaped tree: 3-D attention projections, FFN, biases, a table;
    dense1's first column is all zero, dense2 has ties."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    layer = {"self_attention": {"wq": a(32, 4, 8), "wk": a(32, 4, 8),
                                "wv": a(32, 4, 8), "wo": a(4, 8, 32),
                                "bq": a(4, 8)},
             "dense1": {"linear": {"w": a(32, 128), "b": a(128)}},
             "dense2": {"w": _rows_with_ties(rng, 32, 128).T.copy(),
                        "b": a(32)},
             "norm1": {"gamma": a(32), "beta": a(32)}}
    layer["dense1"]["linear"]["w"][:, 0] = 0.0
    return {"embedding": {"table": a(64, 32)}, "layer_0": layer}


def _leaves(tree, path=""):
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if isinstance(v, dict) and set(v) not in ({"int8", "scale"},
                                                  {"int4", "scale"}):
            yield from _leaves(v, p)
        else:
            yield p, v


@pytest.mark.parametrize("match", [None, FFN])
def test_quantize_params_int8_bit_for_bit(match):
    tree = _tree(np.random.default_rng(1))
    kw = {} if match is None else {"match": match}
    want = dict(_leaves(jq.quantize_params_int8(tree, **kw)))
    got = dict(_leaves(ops.quantize_params_int8(tree, **kw)))
    assert set(got) == set(want)
    quantized = {p for p, v in got.items() if isinstance(v, dict)}
    assert quantized == {p for p, v in want.items() if isinstance(v, dict)}
    expect = {"layer_0/dense1/linear/w", "layer_0/dense2/w"}
    if match is None:
        expect |= {f"layer_0/self_attention/w{c}" for c in "qkvo"}
    assert quantized == expect
    for p in quantized:
        assert got[p]["int8"].dtype == np.int8
        np.testing.assert_array_equal(got[p]["int8"],
                                      np.asarray(want[p]["int8"]))
        np.testing.assert_array_equal(got[p]["scale"],
                                      np.asarray(want[p]["scale"]))
    for p in set(got) - quantized:
        np.testing.assert_array_equal(got[p], np.asarray(want[p]))
    assert ops.WEIGHT_QUANT_TARGETS == jq.WEIGHT_QUANT_TARGETS
    deq_t = dict(_leaves(ops.dequantize_params(
        ops.quantize_params_int8(tree, **kw))))
    deq_j = dict(_leaves(jq.dequantize_params(
        jq.quantize_params_int8(tree, **kw))))
    for p in quantized:
        assert deq_t[p].dtype == torch.bfloat16
        np.testing.assert_array_equal(deq_t[p].float().numpy(),
                                      _f32(deq_j[p]))


@pytest.mark.parametrize("group", [64, 32, 48])
def test_quantize_params_int4_bit_for_bit(group):
    tree = _tree(np.random.default_rng(2))
    want = dict(_leaves(jq.quantize_params_int4(tree, group=group)))
    got = dict(_leaves(ops.quantize_params_int4(tree, group=group)))
    assert set(got) == set(want)
    for p, w in want.items():
        if isinstance(w, dict):
            assert got[p]["int4"].dtype == np.int8
            np.testing.assert_array_equal(got[p]["int4"],
                                          np.asarray(w["int4"]))
            np.testing.assert_array_equal(got[p]["scale"],
                                          np.asarray(w["scale"]))
        else:              # unmatched, or axis 0 not a multiple of group
            assert not isinstance(got[p], dict)
    deq_t = dict(_leaves(ops.dequantize_params(
        ops.quantize_params_int4(tree, group=group), torch.float32)))
    deq_j = dict(_leaves(jq.dequantize_params(
        jq.quantize_params_int4(tree, group=group), jnp.float32)))
    for p in deq_j:
        np.testing.assert_array_equal(np.asarray(deq_t[p]), _f32(deq_j[p]))


def _bf16_ulp(a):
    a = np.maximum(np.abs(a.astype(np.float32)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _mm_case(m, k, n, lead, seed=21):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 0] = 0.0
    x = rng.standard_normal((*lead, m, k)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    q = jq.quantize_params_int8({"dense2": {"w": w}})["dense2"]["w"]
    return x, np.asarray(q["int8"]), np.asarray(q["scale"]), b


SHAPES = [(5, 96, 200), (16, 512, 512), (1, 64, 640), (33, 384, 128)]
DTYPES = [("bfloat16", "bfloat16"), ("bfloat16", "float32"),
          ("float32", "float32")]


def _atol(k):
    return 2e-5 * max(1.0, (k / 64) ** 0.5)


def _within_bf16_ulp(got, want, k, extra=0.0):
    """|got - want| within one bf16 ulp (of either) plus ``extra``, or the
    fp32 tolerance where a sum cancelled to near 0."""
    bound = np.maximum(np.maximum(_bf16_ulp(got), _bf16_ulp(want)) + extra,
                       1e-5 * np.abs(want) + _atol(k))
    assert (np.abs(got - want) <= bound).all()


def _close(got, want, out_dtype, k):
    got = got.float().numpy()
    want = _f32(want)
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=_atol(k))
    else:
        _within_bf16_ulp(got, want, k)


@pytest.mark.parametrize("lead", [(), (2, 3)])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("x_dtype,out_dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_plain_vs_jax(m, k, n, x_dtype, out_dtype, bias, lead):
    x, wq, scale, b = _mm_case(m, k, n, lead)
    b = b if bias else None
    with jdispatch.force_pallas(False):
        want = jops.int8_matmul(
            jnp.asarray(x).astype(x_dtype), jnp.asarray(wq),
            jnp.asarray(scale), None if b is None else jnp.asarray(b),
            out_dtype=getattr(jnp, out_dtype))
    got = ops.int8_matmul(
        torch.tensor(x).to(getattr(torch, x_dtype)), torch.tensor(wq),
        torch.tensor(scale), None if b is None else torch.tensor(b),
        out_dtype=getattr(torch, out_dtype))
    assert got.shape == want.shape and got.dtype == getattr(torch, out_dtype)
    _close(got, want, out_dtype, k)


@pytest.mark.parametrize("out_dtype,bias", [("float32", False),
                                            ("bfloat16", True)])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_plain_vs_jax_pallas_kernel_interpret(m, k, n, out_dtype,
                                                          bias):
    x, wq, scale, b = _mm_case(m, k, n, ())
    b = b if bias else None
    with jdispatch.force_pallas(True, interpret=True):
        want = jops.int8_matmul(
            jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wq),
            jnp.asarray(scale), None if b is None else jnp.asarray(b),
            out_dtype=getattr(jnp, out_dtype))
    got = ops.int8_matmul(
        torch.tensor(x).to(torch.bfloat16), torch.tensor(wq),
        torch.tensor(scale), None if b is None else torch.tensor(b),
        out_dtype=getattr(torch, out_dtype))
    got, want = got.float().numpy(), _f32(want)
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
    else:      # the TPU path rounds the product, then the sum with the bias
        product = ops.int8_matmul(torch.tensor(x).to(torch.bfloat16),
                                  torch.tensor(wq), torch.tensor(scale),
                                  out_dtype=torch.float32).numpy()
        _within_bf16_ulp(got, want, k, extra=_bf16_ulp(product))


def test_int8_matmul_cpu_dispatch_is_plain():
    x, wq, scale, b = _mm_case(4, 64, 96, ())
    args = [torch.tensor(a) for a in (x, wq, scale, b)]
    before = ops.int8_matmul.launches
    with ops.dispatch.force_plain():
        forced = ops.int8_matmul(*args)
    torch.testing.assert_close(ops.int8_matmul(*args), forced, rtol=0, atol=0)
    torch.testing.assert_close(ops.int8_matmul_reference(*args), forced,
                               rtol=0, atol=0)
    assert ops.int8_matmul.launches == before


def _quantized_linear(seed=3):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    b = rng.standard_normal((48,)).astype(np.float32)
    q = ops.quantize_params_int8({"dense2": {"w": w}})["dense2"]["w"]
    lin = Linear(32, 48)
    load_params(lin, {"w": q, "b": b})
    deq = Linear(32, 48)
    load_params(deq, {"w": ops.dequantize_params(q).float().numpy(), "b": b})
    x = torch.tensor(rng.standard_normal((2, 4, 32)).astype(np.float32))
    return lin, deq, x, q, b


def test_linear_with_int8_weight_equals_dequantized_linear():
    lin, deq, x, q, b = _quantized_linear()
    assert isinstance(lin.w, Int8Weight)
    assert sorted(n for n, _ in lin.named_buffers()) == ["w.int8", "w.scale"]
    assert [n for n, _ in lin.named_parameters()] == ["b"]
    with torch.no_grad():
        got, want = lin(x), deq(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)
    # ... and JAX's Linear on the same quantized leaf.
    jwant = JLinear(48).apply({"w": {k: jnp.asarray(v) for k, v in q.items()},
                               "b": jnp.asarray(b)}, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=2e-5)


def test_linear_with_int8_weight_raises_under_autograd():
    lin, _, x, _, _ = _quantized_linear()
    with pytest.raises(RuntimeError, match="inference only"):
        lin(x)                                   # the bias requires grad
    with pytest.raises(RuntimeError, match="inference only"):
        lin(x.requires_grad_())


def test_int8_tree_loads_and_comes_back_unchanged():
    cfg = models.GPTConfig(vocab_size=64, d_model=32, num_heads=4,
                           num_layers=2, hidden_units=64, max_len=16)
    gpt = models.GPT(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tree = ops.quantize_params_int8(params_to_numpy(gpt), match=FFN)
    back = dict(_leaves(params_to_numpy(params_from_numpy(tree, cfg,
                                                          device="cpu"))))
    want = dict(_leaves(tree))
    assert set(back) == set(want)
    for p, v in want.items():
        if isinstance(v, dict):
            assert back[p]["int8"].dtype == np.int8
            np.testing.assert_array_equal(back[p]["int8"], v["int8"])
            np.testing.assert_array_equal(back[p]["scale"], v["scale"])
        else:
            np.testing.assert_array_equal(back[p], v)
    assert re.compile(FFN).match("layer_1/dense1/linear/w")


@pytest.mark.parametrize("match", [None, r".*/wo$"])
def test_int8_attention_weights_raise(match):
    cfg = models.GPTConfig(vocab_size=64, d_model=32, num_heads=4,
                           num_layers=1, hidden_units=64, max_len=16)
    gpt = models.GPT(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    kw = {} if match is None else {"match": match}
    tree = ops.quantize_params_int8(params_to_numpy(gpt), **kw)
    with pytest.raises(NotImplementedError, match="F4"):
        params_from_numpy(tree, cfg, device="cpu")


# ---- stochastic rounding (K10's plain twin) --------------------------------------

def _sq_numpy(x, u):
    """np_modeling_tpu/ops/quantization.py:50-62 in numpy (fp32 throughout)."""
    x = np.asarray(x, np.float32)
    absmax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = np.where(absmax == 0, np.float32(1.0),
                     absmax / np.float32(127.0)).astype(np.float32)
    scaled = x / scale
    fl = np.floor(scaled)
    rounded = fl + (u < (scaled - fl)).astype(np.float32)
    return np.clip(rounded, -127, 127).astype(np.int8), scale


@pytest.mark.parametrize("shape", [(6, 40), (2, 3, 40), (4, 8)])
def test_stochastic_round_int8_is_the_tpu_kernels_arithmetic(shape):
    r = np.random.default_rng(11)
    x = _rows_with_ties(r, n=int(np.prod(shape[:-1])), d=shape[-1])
    x = x.reshape(shape)
    u = r.random(shape).astype(np.float32)
    u.reshape(-1)[:4] = [0.0, 0.5, 0.999999, 0.25]
    want_v, want_s = _sq_numpy(x, u)
    got = ops.stochastic_round_int8(torch.tensor(x), torch.tensor(u))
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), want_v)
    np.testing.assert_array_equal(got.scales.numpy(), want_s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_stochastic_scales_bit_for_bit_with_jax(dtype):
    x = _rows_with_ties(np.random.default_rng(12), n=8, d=64).reshape(2, 4, 64)
    jx = jnp.asarray(x).astype(dtype)
    want = jq.quantize_int8_stochastic(jx, jnp.asarray([1], jnp.int32))
    got = ops.quantize_int8_stochastic(
        torch.tensor(x).to(getattr(torch, dtype)), 1)
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(
        got.scales.numpy(), np.asarray(jq.quantize_int8(jx).scales))
    # JAX rounds to nearest here; the port's values are floor or floor + 1.
    s = _f32(jx) / np.asarray(want.scales)
    fl = np.clip(np.floor(s), -127, 127)
    v = got.values.numpy().astype(np.float32)
    assert ((v == fl) | (v == np.clip(fl + 1, -127, 127))).all()
    assert (np.abs(v - np.asarray(want.values, np.float32)) <= 1).all()


def test_quantize_int8_stochastic_draws_philox_uniforms():
    """Element i's uniform is the top 24 bits of Philox4x32-10's word i % 4
    at counter i // 4 keyed by the seed, over 2**24. Seed 0, counter 0 is
    Random123's all-zeros answer vector."""
    words = (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)
    u = ops.quantization.philox_uniforms(0, (2, 5))
    assert u.dtype == torch.float32
    assert [float(v) for v in u.reshape(-1)[:4]] == [
        (w >> 8) / 2 ** 24 for w in words]
    x = torch.tensor(_randn_np(2, 5))
    want = ops.stochastic_round_int8(x, u)
    got = ops.quantize_int8_stochastic(x, 0)
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.scales, want.scales)
    # A 1-element CPU tensor is the same seed (JAX passes an int32 array).
    again = ops.quantize_int8_stochastic(x, torch.tensor([0], dtype=torch.int32))
    assert torch.equal(again.values, got.values)


def _randn_np(*shape, seed=13):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("seed", [-1, 2 ** 64, 1.5, True])
def test_quantize_int8_stochastic_refuses_bad_seeds(seed):
    with pytest.raises(TypeError):
        ops.quantize_int8_stochastic(torch.ones(2, 4), seed)


def test_quantize_int8_stochastic_is_unbiased_over_seeds():
    """The mean over 256 seeds of (dequantized - x) / scale has expectation
    0 and variance f (1 - f) / 256 (f = frac(x / scale)); its mean over all
    elements lies within 5 sigma."""
    x = torch.tensor(_randn_np(16, 64))
    total = torch.zeros_like(x)
    for seed in range(256):
        qt = ops.quantize_int8_stochastic(x, seed)
        total += (qt.values.float() * qt.scales - x) / qt.scales
    s = x / qt.scales
    f = s - torch.floor(s)
    sigma = ((f * (1 - f)).sum() / 256).sqrt() / x.numel()
    assert abs(float(total.mean() / 256)) <= 5 * float(sigma)
    assert ((total / 256).abs() <= 1).all()


def test_quantize_int8_stochastic_zero_rows_and_other_seeds():
    x = torch.tensor(_randn_np(6, 96))
    x[2] = 0.0
    a = ops.quantize_int8_stochastic(x, 5)
    b = ops.quantize_int8_stochastic(x, 6)
    assert a.scales[2].item() == 1.0 and bool((a.values[2] == 0).all())
    share = (a.values != b.values).float().mean().item()
    assert 0.15 < share < 0.5            # expected ~2 E[f (1 - f)] = 1/3
    assert ops.quantize_int8_stochastic.launches == 0
