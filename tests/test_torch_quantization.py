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
from np_modeling_tpu_torch.ops import quantization as tq
from np_modeling_tpu_torch.utils import (load_params, params_from_numpy,
                                         params_to_numpy)

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

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


# ---- K4's schedule plan (plain Python, shapes alone) ------------------------


@pytest.mark.parametrize("m,want", [(1, "skinny"), (64, "skinny"),
                                    (65, "wide"), (1792, "wide")])
def test_plan_schedule_boundary_at_64_rows(m, want):
    assert tq.plan(m, 3072, 768, 132).schedule == want
    assert tq.plan(m, 768, 3072, 132).schedule == want


@pytest.mark.parametrize("m,n,k", [(8, 3072, 768), (1792, 768, 3072),
                                   (7, 30, 100), (300, 1000, 770)])
def test_plan_fp32_x_is_always_simple(m, n, k):
    assert tq.plan(m, n, k, 132, x_bf16=False) == ("simple", 64, 1, 1)


@pytest.mark.parametrize("m,n,k,aligned", [
    (65, 768, 100, True),      # k not a multiple of 8: TMA cannot read x
    (300, 1000, 768, True),    # n not a multiple of 16: nor the weight
    (300, 1000, 770, True),
    (1792, 3072, 768, False),  # x not 16-byte aligned
    (8, 768, 0, True), (1792, 768, 0, True), (0, 768, 768, True)])
def test_plan_takes_simple_where_skinny_and_wide_cannot(m, n, k, aligned):
    assert tq.plan(m, n, k, 132, aligned=aligned).schedule == "simple"


@pytest.mark.parametrize("n,k", [(3072, 768), (768, 3072)])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_plan_decode_grid_covers_one_and_a_half_waves(m, n, k):
    """GPT-2 small's decode products on 132 SMs: n tiles x splits blocks
    >= SKINNY_WAVES waves (about one and a half: 192 blocks, 1.45 waves, at
    [3072, 768]), each split whole 64-row blocks of k, none empty, and one
    cluster of the splits (at most 16 blocks)."""
    p = tq.plan(m, n, k, sms=132)
    assert p.schedule == "skinny" and p.n_tile in (32, 64, 128)
    assert -(-n // p.n_tile) * p.splits >= tq.SKINNY_WAVES * 132 >= 1.4 * 132
    rows = tq.skinny_split(k, p.splits)[0]
    assert rows % 64 == 0 and (p.splits - 1) * rows < k <= p.splits * rows
    assert p.cluster == p.splits <= 16
    assert rows <= tq.SKINNY_MAX_ROWS


@pytest.mark.parametrize("n,k,tile,splits", [(3072, 768, 128, 12),
                                              (768, 3072, 64, 16)])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_plan_picks_the_sweeps_fastest_decode_grid(m, n, k, tile, splits):
    """On 132 SMs the plan takes the (n tile, splits) that
    exp_torch_k4_k8.py's sweep timed fastest on the H100 at GPT-2 small's
    two decode products: 128 x 12 (288 blocks) and 64 x 16 (192)."""
    assert tq.plan(m, n, k, 132) == ("skinny", tile, splits, splits)


@pytest.mark.parametrize("k", [1, 63, 64, 100, 768, 3072, 4104, 8192])
@pytest.mark.parametrize("asked", [1, 2, 4, 8, 16])
def test_skinny_split_gives_whole_nonempty_row_blocks(k, asked):
    rows, splits = tq.skinny_split(k, asked)
    assert rows % 64 == 0 and 1 <= splits <= asked
    assert (splits - 1) * rows < k <= splits * rows


@pytest.mark.parametrize("m,n,k", [(8, 30, 100), (1, 640, 64),
                                   (64, 16, 40000), (5, 200, 96)])
def test_plan_small_or_deep_skinny_shapes(m, n, k):
    """Where no grid reaches SKINNY_WAVES waves, the most blocks; a k
    too deep for 16 splits of SKINNY_MAX_ROWS rows is not skinny."""
    p = tq.plan(m, n, k, sms=132)
    if k > 16 * tq.SKINNY_MAX_ROWS:
        assert p.schedule == "simple"
        return
    assert p.schedule == "skinny"
    best = max(-(-n // t) * tq.skinny_split(k, s)[1]
               for s in tq.SKINNY_SPLITS for t in tq.SKINNY_TILES
               if tq.skinny_split(k, s)[0] <= tq.SKINNY_MAX_ROWS)
    blocks = -(-n // p.n_tile) * p.splits
    assert blocks >= tq.SKINNY_WAVES * 132 or blocks == best


@pytest.mark.parametrize("m,n,k,splits", [
    (1792, 3072, 768, 1),      # 336 tiles fill the card
    (1792, 768, 3072, 1),      # 84 tiles: 132 // 84 = 1
    (65, 208, 5000, 4),        # 2 tiles, k holds 4 splits of 16 slices
    (128, 128, 1 << 20, 132)])
def test_plan_wide_splits_k_only_where_tiles_leave_sms_idle(m, n, k, splits):
    p = tq.plan(m, n, k, sms=132)
    assert p == ("wide", 128, splits, 1)


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


def test_a_vector_of_four_is_one_philox_draw():
    """With d % 4 == 0 the four elements (row, 4 j .. 4 j + 3) are the words
    of Philox draw row * d / 4 + j, so K10's rows and block_row schedules
    draw once a vector (8 bf16: draws 2 j' and 2 j' + 1)."""
    from np_modeling_tpu_torch.ops.fused import philox4x32_10
    n, d, seed = 3, 24, 0x1_2345_6789
    bits = tq.philox_bits(seed, (n, d)).reshape(n, d // 4, 4)
    q = torch.arange(n * d // 4, dtype=torch.int64)
    zero = torch.zeros_like(q)
    words = philox4x32_10(q & 0xFFFFFFFF, q >> 32, zero, zero,
                          (seed & 0xFFFFFFFF, seed >> 32))
    assert torch.equal(bits, torch.stack(words, -1).reshape(n, d // 4, 4))


# ---- K10's schedule plan (plain Python, shapes alone) -----------------------

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("n,d,dtype,schedule,vec", [
    (8192, 768, F32, "rows", 4), (8192, 768, BF16, "rows", 8),
    (21504, 64, BF16, "rows", 8), (8192, 2304, BF16, "block_row", 8),
    (1024, 16384, F32, "block_row", 4), (8192, 1001, F32, "simple", 1)])
def test_quantize_plan_at_the_design_shapes(n, d, dtype, schedule, vec):
    p = tq.quantize_plan(n, d, dtype, True, 132)
    assert (p.schedule, p.vec) == (schedule, vec)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("n,d", [(1, 4), (3, 64), (21504, 64), (5, 768),
                                 (8192, 768), (7, 772), (8192, 2304),
                                 (2, 4096), (1024, 16384), (3, 16380)])
def test_quantize_plan_covers_each_row_and_every_row(n, d, dtype):
    """The vectors a row's threads hold cover its d elements, at the
    fewest compiled vectors a thread that do; the grid covers each row
    once."""
    p = tq.quantize_plan(n, d, dtype, True, 132)
    assert p.schedule in ("rows", "block_row")
    assert d % p.vec == 0
    assert p.lanes * p.per_lane * p.vec >= d
    if p.schedule == "rows":
        widths = tq.ROWS_PER_LANE
        assert p.lanes in (1, 2, 4, 8, 16, 32) and 1 <= p.warps <= 16
        assert p.grid * (p.warps * 32 // p.lanes) >= n
    else:
        widths = tq.BLOCK_ROW_PER_LANE
        assert p.lanes == 32 * p.warps <= tq.BLOCK_ROW_MAX_THREADS
        assert p.grid == n
    assert p.per_lane in widths
    assert all(p.lanes * w * p.vec < d for w in widths if w < p.per_lane)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [1, 2, 3, 6, 33, 770, 1001])
def test_quantize_plan_ragged_d_is_simple(d, dtype):
    """d % 4 != 0: a Philox draw's four words straddle two rows."""
    assert tq.quantize_vec(d, dtype) == 0
    assert tq.quantize_plan(64, d, dtype, True, 132).schedule == "simple"
    with pytest.raises(ValueError):
        tq.schedule_plan("rows", 64, d, dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [64, 768, 16384])
def test_quantize_plan_misaligned_x_is_simple(d, dtype):
    assert tq.quantize_plan(64, d, dtype, False, 132).schedule == "simple"


@pytest.mark.parametrize("d,dtype,schedule", [
    (1024, F32, "rows"), (1028, F32, "block_row"), (1024, BF16, "rows"),
    (1032, BF16, "block_row"), (2048, BF16, "block_row"), (1020, BF16, "rows"),
    (1028, BF16, "block_row"),
    (16384, F32, "block_row"), (16388, F32, "simple"),
    (32768, BF16, "block_row"), (32776, BF16, "simple"),
    (16380, BF16, "block_row"), (16388, BF16, "simple")])
def test_quantize_plan_row_length_limits(d, dtype, schedule):
    """rows to 32 elements a lane of 32 (d 1024), block_row to 512 threads x
    8 vectors (16384 fp32), simple past that (1020, 1028 and 16380 bf16:
    4-element vectors, as d % 8 != 0)."""
    assert tq.quantize_plan(16, d, dtype, True, 132).schedule == schedule


@pytest.mark.parametrize("d,dtype,vec", [
    (4, F32, 4), (768, F32, 4), (772, F32, 4), (4, BF16, 4), (8, BF16, 8),
    (768, BF16, 8), (772, BF16, 4), (2308, BF16, 4), (16384, BF16, 8)])
def test_quantize_vector_widths(d, dtype, vec):
    """16 bytes a vector (4 fp32, 8 bf16); 8 bytes (4 bf16) where d is a
    multiple of 4 but not of 8."""
    assert tq.quantize_vec(d, dtype) == vec
    assert tq.quantize_plan(16, d, dtype, True, 132).vec == vec


@pytest.mark.parametrize("n,d,dtype,lanes,per_lane", [
    (21504, 64, BF16, 8, 1), (21504, 64, F32, 8, 2), (21504, 128, BF16, 8, 2),
    (21504, 256, BF16, 16, 2), (64, 128, F32, 16, 2), (64, 72, BF16, 8, 2),
    (64, 132, F32, 32, 2), (64, 512, BF16, 32, 2), (8192, 768, F32, 32, 6),
    (8192, 768, BF16, 32, 3), (64, 28, F32, 8, 1), (64, 4, F32, 1, 1)])
def test_quantize_plan_lanes_a_row(n, d, dtype, lanes, per_lane):
    """One vector a lane for rows of up to 8 vectors, two beyond (at most
    32 lanes): the sweep's fastest at d 64 bf16 (8 vectors), d 128 bf16, d
    64 fp32 (16) and d 256 bf16 (32)."""
    p = tq.quantize_plan(n, d, dtype, True, 132)
    assert (p.schedule, p.lanes, p.per_lane, p.warps) == (
        "rows", lanes, per_lane, tq.ROWS_WARPS)
    assert p.grid == -(-n // (p.warps * 32 // lanes))


def test_schedule_plan_forced_shapes_and_caps():
    p = tq.schedule_plan("rows", 8192, 768, F32, lanes=32, warps=8)
    assert p == ("rows", 4, 32, 6, 8, 8192 // 8)    # each row once
    assert tq.schedule_plan("rows", 8193, 768, F32, lanes=32,
                            warps=2).grid == 4097
    assert tq.schedule_plan("rows", 21504, 64, BF16) == (
        "rows", 8, 8, 1, 4, 21504 // 16)
    p = tq.schedule_plan("block_row", 8192, 2304, BF16, lanes=288)
    assert p == ("block_row", 8, 288, 1, 9, 8192)
    assert tq.schedule_plan("block_row", 3, 4, F32).per_lane == 1
    assert tq.schedule_plan("simple", 5, 1001, F32) == (
        "simple", 1, 256, 0, 8, 5)
    for bad in (dict(lanes=3), dict(lanes=64), dict(lanes=16),
                dict(warps=17)):
        with pytest.raises(ValueError):
            tq.schedule_plan("rows", 4, 768, F32, **bad)
    with pytest.raises(ValueError):
        tq.schedule_plan("block_row", 4, 768, F32, lanes=48)
    with pytest.raises(ValueError):
        tq.schedule_plan("block_row", 4, 16388, F32)
    with pytest.raises(ValueError):
        tq.schedule_plan("block_row", 4, 768, F32, lanes=1024)


def test_quantize_int8_stochastic_cpu_launches_no_schedule():
    before = dict(ops.quantize_int8_stochastic.launches_by_schedule)
    ops.quantize_int8_stochastic(torch.ones(4, 768), 3)
    assert ops.quantize_int8_stochastic.launches_by_schedule == before == {
        "rows": 0, "block_row": 0, "simple": 0}
