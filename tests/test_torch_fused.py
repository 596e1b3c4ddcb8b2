"""The port's LayerNorm (K8), dropout (K7) and fused softmax cross-entropy
(K9) against the JAX package, and the plain twin of K7's generator against
its own contract.

LayerNorm: seeded numpy inputs go through the port's plain version and JAX's
``ops.layer_norm``, both on its jnp path and on its Pallas kernel K8 in
interpret mode (as tests/test_fused_kernels.py runs it), forward and
backward, at rtol 1e-5 / atol 2e-5 (fp32). Dropout: ``dropout_with_mask``
against JAX's exactly, on one numpy mask. JAX's in-kernel generator is a
stub in interpret mode (tests/test_fused_kernels.py:73-78), so K7's twin is
held by its properties instead: Philox4x32-10 answer vectors (Random123),
the keep share, values exactly ``x / keep`` or 0, the backward's mask equal
to the forward's, decorrelated seeds, salts and layers, and identity at
rate 0 and in eval. Softmax-CE: the port's plain version (the CPU path of
``ops.softmax_cross_entropy_fused``) against JAX's kernel K9 in interpret
mode, ce at rtol/atol 1e-5 and dlogits at rtol 1e-5 / atol 1e-6 (as
tests/test_fused_kernels.py holds JAX's own), bf16 dlogits within one bf16
ulp (the two lse differ in their last fp32 bits, which can move a rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import ops as jops
from np_modeling_tpu.ops import dispatch as jdispatch
from np_modeling_tpu_torch import nn as tnn
from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.ops import fused
from np_modeling_tpu_torch.rng import fold_seed, seed_of

TOL = dict(rtol=1e-5, atol=2e-5)
rng = np.random.default_rng(23)


def _randn(*shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---- LayerNorm ---------------------------------------------------------------

@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "k8_interpret"])
@pytest.mark.parametrize("shape", [(64, 128), (4, 10, 256), (100, 384),
                                   (6, 1000)])
def test_layer_norm_fwd_bwd_vs_jax(shape, pallas):
    x = _randn(*shape) * 2 + 0.5
    gamma, beta = _randn(shape[-1]), _randn(shape[-1])
    dz = _randn(*shape)
    eps = 1e-5

    def jfn(x, g, b):
        return jops.layer_norm(x, g, b, eps)

    args = [jnp.asarray(a) for a in (x, gamma, beta)]
    if pallas:
        with jdispatch.force_pallas(True, interpret=True):
            want, vjp = jax.vjp(jfn, *args)
            jgrads = vjp(jnp.asarray(dz))
    else:
        want, vjp = jax.vjp(jfn, *args)
        jgrads = vjp(jnp.asarray(dz))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, gamma, beta)]
    got = ops.layer_norm(*leaves, eps)
    got.backward(torch.tensor(dz))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for t, g in zip(leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layer_norm_bf16_rounds_once_like_jax(seed):
    """bf16 x, fp32 params: fp32 statistics, one rounding of the output;
    at most one bf16 ulp from JAX's (the fp32 sums may differ in order)."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((16, 768)) * 3).astype(jnp.bfloat16)
    gamma, beta = (r.standard_normal(768).astype(np.float32) for _ in "gb")
    want = np.asarray(jops.layer_norm(jnp.asarray(x), jnp.asarray(gamma),
                                      jnp.asarray(beta), 1e-5)
                      ).astype(np.float32)
    got = ops.layer_norm(torch.tensor(np.asarray(x, np.float32)).bfloat16(),
                         torch.tensor(gamma), torch.tensor(beta), 1e-5)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()

    def ulp(v):         # one bf16 ulp at |v| (8 significant bits)
        return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
                       - 7)

    assert (np.abs(got - want) <= np.maximum(ulp(got), ulp(want))).all()


def test_layer_norm_cpu_launches_nothing():
    before = (ops.layer_norm.launches_fwd, ops.layer_norm.launches_bwd)
    x = torch.randn(5, 64, requires_grad=True)
    ops.layer_norm(x, torch.ones(64), torch.zeros(64)).sum().backward()
    assert (ops.layer_norm.launches_fwd,
            ops.layer_norm.launches_bwd) == before


@pytest.mark.parametrize("d,threads", [(1, 32), (64, 32), (512, 32),
                                       (513, 64), (768, 64), (1000, 64),
                                       (1024, 64), (1025, 128),
                                       (8192, 512)])
def test_layer_norm_kernel_row_team(d, threads):
    assert fused.ln_threads(d) == threads


@pytest.mark.parametrize("n", [1, 7, 8, 33, 8192, 16384, 1 << 20])
@pytest.mark.parametrize("d", [1, 64, 768, 1000, 1001, 1024])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_ln_bwd_plan_gives_rows_to_warps(n, d, itemsize):
    """d <= 1024: a warp a row, a persistent grid of at most two blocks an
    SM (one for fp32), never more blocks than its 8 warps have rows for."""
    t_row, blocks = fused.ln_bwd_plan(n, d, 132, itemsize)
    per_sm = 2 if itemsize == 2 else 1
    assert t_row == 32
    assert blocks == min(-(-n // fused.LN_BWD_WARPS), per_sm * 132)
    assert 1 <= blocks <= per_sm * 132


@pytest.mark.parametrize("n", [1, 7, 16384])
@pytest.mark.parametrize("d", [1025, 2048, 8192])
def test_ln_bwd_plan_keeps_the_row_team_past_1024(n, d):
    t_row, blocks = fused.ln_bwd_plan(n, d, 132)
    assert t_row == fused.ln_threads(d) >= 128
    assert blocks == min(n, 4 * 132)


@pytest.mark.parametrize("d", [0, 8193])
def test_ln_bwd_plan_refuses_widths_the_kernels_cannot_hold(d):
    with pytest.raises(ValueError):
        fused.ln_bwd_plan(16, d, 132)


@pytest.mark.parametrize("d", [0, 8193])
def test_layer_norm_kernel_refuses_widths_it_cannot_hold(d):
    with pytest.raises(ValueError):
        fused.ln_threads(d)


# ---- dropout with an explicit mask -------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_with_mask_vs_jax_exactly(rate, dtype):
    """JAX divides x by ``1 - rate`` in x's dtype (bf16: 0.8984375 for 0.9);
    so does the port, and the two agree bit for bit, forward and backward."""
    x = (_randn(8, 96) * 3).astype(dtype)
    dy = (_randn(8, 96) * 3).astype(dtype)
    mask = rng.random((8, 96)) > rate
    want, vjp = jax.vjp(lambda x: jops.dropout_with_mask(
        x, jnp.asarray(mask), rate), jnp.asarray(x))
    (dwant,) = vjp(jnp.asarray(dy))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = torch.tensor(np.asarray(x, np.float32)).to(tdtype).requires_grad_()
    got = ops.dropout_with_mask(tx, torch.tensor(mask), rate)
    got.backward(torch.tensor(np.asarray(dy, np.float32)).to(tdtype))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(tx.grad.float().numpy(),
                                  np.asarray(dwant, np.float32))


# ---- the plain twin of K7's generator -------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox4x32_10_answer_vectors(ctr, key, want):
    words = fused.philox4x32_10(
        *[torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert tuple(int(w) for w in words) == want


def test_keep_mask_is_philox_of_the_flat_index():
    """Element i takes word i % 4 of the draw at counter i // 4 (high word of
    the counter included), keyed by the seed's low and high words."""
    seed = 0x0123456789ABCDEF
    mask = fused.philox_keep_mask(seed, (3, 7), 0.5)
    for i in (0, 5, 13, 20):
        words = fused.philox4x32_10(
            *[torch.tensor([c], dtype=torch.int64)
              for c in (i // 4, 0, 0, 0)], (0x89ABCDEF, 0x01234567))
        bit = int(words[i % 4]) < fused.keep_threshold(0.5)
        assert bool(mask.reshape(-1)[i]) == bit
    assert fused.keep_threshold(0.1) == int(0.9 * (2 ** 32 - 1))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_share_within_5_sigma(rate):
    n = 1 << 20
    kept = int(fused.philox_keep_mask(7, (n,), rate).sum())
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(kept - n * (1 - rate)) <= 5 * sigma


@pytest.mark.parametrize("path", ["mask", "prng"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_values_and_backward_mask(dtype, path):
    """Kept values are exactly x / keep in x's dtype, dropped ones 0; the
    backward drops the same elements and scales the rest the same way.
    ``mask``: the explicit mask; ``prng``: the seed, whose CPU path draws
    the plain twin of K7's bits."""
    x = torch.randn(6, 50, 33).to(dtype).requires_grad_()
    dy = torch.randn(6, 50, 33).to(dtype)
    seed, rate = 2024, 0.3
    mask = fused.philox_keep_mask(seed, x.shape, rate)
    y = (ops.dropout_with_mask(x, mask, rate) if path == "mask"
         else ops.dropout(x, seed, rate))
    y.backward(dy)
    assert torch.equal(y.detach()[mask], fused.dropout_scale(x.detach(),
                                                             rate)[mask])
    assert bool((y.detach()[~mask] == 0).all())
    assert torch.equal(x.grad[mask], fused.dropout_scale(dy, rate)[mask])
    assert bool((x.grad[~mask] == 0).all())


def test_dropout_prng_twin_equals_mask_path_and_strides_follow_shape():
    x = torch.randn(4, 64, 48)
    a = ops.dropout_with_mask(x, ops.make_dropout_mask(99, x.shape, 0.1), 0.1)
    b = ops.dropout(x, 99, 0.1)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):             # K7 takes CUDA tensors only
        fused.dropout_prng(x, 99, 0.1)
    xt = x.transpose(0, 2)                      # a strided view
    assert torch.equal(ops.dropout(xt, 5, 0.1),
                       ops.dropout(xt.contiguous(), 5, 0.1))


def test_dropout_seeds_salts_and_layers_decorrelate():
    shape = (16, 128)
    masks = [fused.philox_keep_mask(s, shape, 0.5) for s in
             (1, 2, fold_seed(1, 1), fold_seed(1, 2),
              fold_seed(fold_seed(1, 0), 1), fold_seed(fold_seed(1, 1), 1))]
    for i in range(len(masks)):
        for j in range(i + 1, len(masks)):
            agree = (masks[i] == masks[j]).float().mean().item()
            assert 0.4 < agree < 0.6, (i, j, agree)
    x = torch.ones(shape)
    drop = tnn.Dropout(0.5)
    seeds = tnn.split_rngs({"dropout": 1}, 0)
    a = drop(x, training=True, rngs=seeds, salt=1)
    b = drop(x, training=True, rngs=seeds, salt=2)
    c = drop(x, training=True, rngs=tnn.split_rngs({"dropout": 1}, 1), salt=1)
    assert not torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, drop(x, training=True, rngs=seeds, salt=1))


def test_dropout_generator_seeds_draw_once_and_advance():
    g = torch.Generator().manual_seed(3)
    first = seed_of(g)
    assert seed_of(torch.Generator().manual_seed(3)) == first
    assert seed_of(g) != first and 0 <= first < 2 ** 63
    with pytest.raises(TypeError):
        seed_of(torch.tensor(3))


def test_dropout_identity_at_rate_0_and_in_eval():
    x = torch.randn(4, 8)
    before = ops.dropout.launches
    assert ops.dropout(x, 1, 0.0) is x
    assert ops.dropout(x, 1, 0.5, training=False) is x
    assert ops.dropout(x, None, 0.5, training=False) is x
    with pytest.raises(ValueError):
        ops.dropout(x, None, 0.5)
    ops.dropout(x, 1, 0.5)                      # the CPU launches nothing
    assert ops.dropout.launches == before


# ---- fused softmax cross-entropy (K9) -----------------------------------------

def _sxe_case(shape, dtype, out_of_range):
    logits = (_randn(*shape) * 3).astype(dtype)
    labels = rng.integers(0, shape[-1], shape[:-1])
    if out_of_range:
        flat = labels.reshape(-1)
        flat[0], flat[-1] = shape[-1], -1
    g = _randn(*shape[:-1])
    return logits, labels, g


@pytest.mark.parametrize("out_of_range", [False, True],
                         ids=["in_range", "out_of_range"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(32, 128), (10, 1000), (64, 4096),
                                   (2, 7, 300)])
def test_softmax_cross_entropy_fused_vs_jax_kernel(shape, dtype,
                                                    out_of_range):
    logits, labels, g = _sxe_case(shape, dtype, out_of_range)

    def jloss(lg):
        return jnp.sum(jops.softmax_cross_entropy_fused(
            lg, jnp.asarray(labels)) * jnp.asarray(g))

    with jdispatch.force_pallas(True, interpret=True):
        want = jops.softmax_cross_entropy_fused(jnp.asarray(logits),
                                                jnp.asarray(labels))
        jgrad = jax.grad(jloss)(jnp.asarray(logits))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    leaf = torch.tensor(np.asarray(logits, np.float32)).to(tdtype)
    leaf.requires_grad_()
    before = (ops.softmax_cross_entropy_fused.launches_fwd,
              ops.softmax_cross_entropy_fused.launches_bwd)
    got = ops.softmax_cross_entropy_fused(leaf, torch.tensor(labels))
    got.backward(torch.tensor(g))
    assert got.dtype == torch.float32 and got.shape == shape[:-1]
    assert leaf.grad.dtype == tdtype
    assert (ops.softmax_cross_entropy_fused.launches_fwd,
            ops.softmax_cross_entropy_fused.launches_bwd) == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ops.softmax_cross_entropy_fused_reference(
            leaf.detach(), torch.tensor(labels)).numpy(), np.asarray(want),
        rtol=1e-5, atol=1e-5)
    dl = leaf.grad.float().numpy()
    jg = np.asarray(jgrad, np.float32)
    if dtype == jnp.float32:
        np.testing.assert_allclose(dl, jg, rtol=1e-5, atol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jg), 2.0 ** -126)))
                      - 7)
        assert (np.abs(dl - jg) <= np.maximum(ulp, 1e-6)).all()


def test_softmax_cross_entropy_fused_out_of_range_label_is_lse():
    """A label outside [0, v) picks up no logit and no onehot: ce = lse and
    the gradient is the softmax alone (``gather`` would raise instead)."""
    logits = torch.tensor(_randn(3, 17)).requires_grad_()
    labels = torch.tensor([17, -1, 4])
    ce = ops.softmax_cross_entropy_fused(logits, labels)
    ce.sum().backward()
    lse = torch.logsumexp(logits.detach(), dim=-1)
    p = torch.softmax(logits.detach(), dim=-1)
    torch.testing.assert_close(ce[:2], lse[:2])
    torch.testing.assert_close(logits.grad[:2], p[:2])
    assert ce[2] == lse[2] - logits[2, 4]


def test_softmax_cross_entropy_fused_matches_the_integer_label_loss():
    logits = torch.tensor(_randn(4, 9, 50)).requires_grad_()
    labels = torch.tensor(rng.integers(0, 50, (4, 9)))
    a = ops.softmax_cross_entropy_fused(logits, labels)
    (ga,) = torch.autograd.grad(a.mean(), logits)
    b = ops.softmax_cross_entropy_with_integer_labels(logits, labels)
    (gb,) = torch.autograd.grad(b.mean(), logits)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError):
        ops.softmax_cross_entropy_fused(logits, labels[:, :3])
