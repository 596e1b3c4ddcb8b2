"""The port's flash attention against the JAX package's.

The plain version (what runs on CPU tensors) is held against JAX
``flash_attention`` on its jnp path and against the Pallas kernels in
interpret mode (``force_pallas(True, interpret=True)``, 128 x 128 blocks, as
tests/test_attention.py runs them), forward and backward, with every
option: K1/K2, K1/K2 with segment ids, the split backward K5 (JAX's
``FUSED_BWD`` False) and the dual-kv forward K12 (``FWD_DUAL_KV`` True),
each with the port's flag set likewise, and Gemma-2's window and softcap at
head_dim 256 under each. Inputs are seeded numpy arrays
fed to both. fp32 at rtol 1e-5 / atol 2e-5, gradients at atol 5e-5 (the
JAX package's own kernel tests).
The CUDA kernels themselves are held against the plain version on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _schedule
from np_modeling_tpu import ops as jops
from np_modeling_tpu.ops import dispatch as jdispatch
from np_modeling_tpu_torch import ops

TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-5, atol=5e-5)
rng = np.random.default_rng(0)


def _randn(*shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(b, hq, hkv, sq, skv, d):
    return (_randn(b, hq, sq, d), _randn(b, hkv, skv, d),
            _randn(b, hkv, skv, d), _randn(b, hq, sq, d))


def _jax(q, k, v, do, bias=None, sinks=None, pallas=False, **kw):
    """o and the grads of (q, k, v[, bias][, sinks]) through JAX."""
    extra = [x for x in (bias, sinks) if x is not None]

    def f(q, k, v, *rest):
        it = iter(rest)
        return jops.flash_attention(
            q, k, v, bias=next(it) if bias is not None else None,
            sinks=next(it) if sinks is not None else None, **kw)

    args = [jnp.asarray(x) for x in (q, k, v, *extra)]
    if pallas:
        with jdispatch.force_pallas(True, interpret=True):
            o, vjp = jax.vjp(f, *args)
            grads = vjp(jnp.asarray(do))
    else:
        o, vjp = jax.vjp(f, *args)
        grads = vjp(jnp.asarray(do))
    return np.asarray(o), [np.asarray(g) for g in grads]


def _port(q, k, v, do, bias=None, sinks=None, **kw):
    kw = {k_: (torch.tensor(np.asarray(x)) if isinstance(x, np.ndarray)
               else x) for k_, x in kw.items()}
    if isinstance(kw.get("segment_ids"), tuple):
        kw["segment_ids"] = tuple(torch.tensor(x) for x in kw["segment_ids"])
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (q, k, v, *[x for x in (bias, sinks) if x is not None])]
    it = iter(leaves[3:])
    o = ops.flash_attention(*leaves[:3],
                            bias=next(it) if bias is not None else None,
                            sinks=next(it) if sinks is not None else None, **kw)
    o.backward(torch.tensor(do))
    return o.detach().numpy(), [t.grad.numpy() for t in leaves]


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def _segments(b, s):
    return np.sort(rng.integers(0, 3, (b, s)), axis=1).astype(np.int32)


def _case_kwargs(name, b, hq, sq, skv):
    """Keyword options of a named case (arrays as numpy)."""
    if name == "mask":
        mask = rng.random((b, 1, sq, skv)) > 0.3
        mask[..., 0] = True                      # keep every row non-empty
        return dict(mask=mask)
    if name == "bias":
        return dict(bias=_randn(1, hq, sq, skv))
    if name == "bias_full":
        return dict(bias=_randn(b, hq, sq, skv), causal=True)
    if name == "segments":
        kv_seg = _segments(b, skv)
        return dict(segment_ids=(kv_seg[:, :sq], kv_seg), causal=True)
    if name == "window":
        return dict(causal=True, window=7)
    if name == "softcap":
        return dict(softcap=5.0, causal=True)
    if name == "sinks":
        return dict(sinks=_randn(hq), causal=True)
    return dict(causal=name == "causal")


SHAPES = {"mha": (2, 4, 4, 24, 24, 16), "gqa": (2, 4, 2, 24, 24, 16),
          "ragged": (1, 2, 2, 200, 200, 16), "sq_ne_skv": (1, 2, 1, 20, 44, 16)}


@pytest.mark.parametrize("name", ["full", "causal", "mask", "bias",
                                  "bias_full", "segments", "window",
                                  "softcap", "sinks"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_vs_jax_jnp_path(shape, name):
    b, hq, hkv, sq, skv, d = SHAPES[shape]
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d)
    kw = _case_kwargs(name, b, hq, sq, skv)
    bias, sinks = kw.pop("bias", None), kw.pop("sinks", None)
    jkw = {k_: (tuple(jnp.asarray(x) for x in val) if isinstance(val, tuple)
                else jnp.asarray(val) if isinstance(val, np.ndarray) else val)
           for k_, val in kw.items()}
    _check(_port(q, k, v, do, bias, sinks, **kw),
           _jax(q, k, v, do, bias, sinks, **jkw))


@pytest.mark.parametrize("shape,kw", [
    ((1, 2, 2, 256, 256, 64), dict(causal=False)),
    ((1, 2, 2, 256, 256, 64), dict(causal=True)),
    ((1, 4, 2, 200, 200, 64), dict(causal=True)),
    ((1, 2, 2, 128, 256, 64), dict(causal=True, softcap=5.0)),
], ids=["full", "causal", "gqa_ragged", "sq_ne_skv_softcap"])
def test_plain_vs_jax_pallas_kernels_interpret(shape, kw):
    """K1/K2 themselves (Pallas interpret mode) against the port's plain
    version; the port's kernels follow the same tile algebra."""
    q, k, v, do = _inputs(*shape)
    want = _jax(q, k, v, do, pallas=True, block_q=128, block_kv=128, **kw)
    _check(_port(q, k, v, do, **kw), want)


def _jnp_kw(kw):
    return {k_: (tuple(jnp.asarray(x) for x in val) if isinstance(val, tuple)
                 else val) for k_, val in kw.items()}


@contextlib.contextmanager
def _flags(monkeypatch, fused_bwd=True, dual=False):
    """Both packages' schedule flags, set alike in a scope."""
    import np_modeling_tpu.ops.attention as jattention
    monkeypatch.setattr(jattention, "FUSED_BWD", fused_bwd)
    monkeypatch.setattr(jattention, "FWD_DUAL_KV", dual)
    with _schedule(fused_bwd, dual):
        yield


@pytest.mark.parametrize("fused_bwd", [True, False], ids=["k2", "k5"])
@pytest.mark.parametrize("shape,causal", [
    ((1, 2, 2, 256, 256, 64), True),
    ((1, 2, 2, 256, 256, 64), False),
    ((1, 4, 2, 200, 200, 64), True),
    ((1, 2, 1, 128, 256, 64), False),
], ids=["causal", "full", "gqa_ragged", "gqa_sq_ne_skv_full"])
def test_plain_vs_jax_pallas_segments_interpret(shape, causal, fused_bwd,
                                                monkeypatch):
    """K1 with segment ids and the backward that ``FUSED_BWD`` picks (K2 or
    K5), in interpret mode, against the port's plain version. Three
    documents a row, so some rows' first kv tiles are all another
    document's; every q row keeps its own key (q ids are kv's first sq)."""
    b, hq, hkv, sq, skv, d = shape
    q, k, v, do = _inputs(*shape)
    kv_seg = _segments(b, skv)
    kw = dict(segment_ids=(kv_seg[:, :sq], kv_seg), causal=causal)
    with _flags(monkeypatch, fused_bwd=fused_bwd):
        want = _jax(q, k, v, do, pallas=True, block_q=128, block_kv=128,
                    **_jnp_kw(kw))
        _check(_port(q, k, v, do, **kw), want)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_vs_jax_pallas_split_backward_interpret(causal, monkeypatch):
    """K5 alone (JAX's ``FUSED_BWD`` False), GQA, without segment ids."""
    q, k, v, do = _inputs(1, 4, 2, 256, 256, 64)
    with _flags(monkeypatch, fused_bwd=False):
        want = _jax(q, k, v, do, pallas=True, block_q=128, block_kv=128,
                    causal=causal)
        _check(_port(q, k, v, do, causal=causal), want)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_vs_jax_pallas_dual_forward_interpret(causal, monkeypatch):
    """K12 (JAX's ``FWD_DUAL_KV`` True: two kv blocks of 128 at s 256),
    GQA, and the K2 backward behind it."""
    q, k, v, do = _inputs(1, 4, 2, 256, 256, 64)
    with _flags(monkeypatch, dual=True):
        want = _jax(q, k, v, do, pallas=True, block_q=128, block_kv=128,
                    causal=causal)
        _check(_port(q, k, v, do, causal=causal), want)


# Gemma-2's options at its head_dim (256), GQA: under each schedule (K12
# takes the window but not the softcap, JAX's condition :856-858).
GEMMA_OPTS = {"window": dict(window=100), "softcap": dict(softcap=5.0),
              "both": dict(window=100, softcap=5.0)}


@pytest.mark.parametrize("opts,schedule", [
    ("window", "k2"), ("window", "k5"), ("window", "k12"), ("softcap", "k2"),
    ("softcap", "k5"), ("both", "k2"), ("both", "k5")])
def test_plain_vs_jax_pallas_window_softcap_d256_interpret(opts, schedule,
                                                           monkeypatch):
    """K1 (or K12) and K2 (or K5) in interpret mode at head_dim 256, b1 hq2
    hkv1 s256, with a window of 100 (it cuts inside and across the 128-row
    blocks), a softcap of 5.0 that bites, and both, against the port's
    plain version."""
    q, k, v, do = _inputs(1, 2, 1, 256, 256, 256)
    kw = dict(causal=True, **GEMMA_OPTS[opts])
    with _flags(monkeypatch, fused_bwd=schedule != "k5",
                dual=schedule == "k12"):
        want = _jax(q, k, v, do, pallas=True, block_q=128, block_kv=128,
                    **kw)
        _check(_port(q, k, v, do, **kw), want)


def test_schedule_flags_have_jax_defaults_and_change_nothing_on_cpu():
    import np_modeling_tpu.ops.attention as jattention
    assert (ops.attention.FUSED_BWD, ops.attention.FWD_DUAL_KV) == (
        jattention.FUSED_BWD, jattention.FWD_DUAL_KV) == (True, False)
    q, k, v, do = _inputs(1, 2, 2, 128, 128, 64)
    seg = _segments(1, 128)
    before = (ops.flash_attention.launches_fwd,
              ops.flash_attention.launches_fwd_dual,
              ops.flash_attention.launches_bwd,
              ops.flash_attention.launches_bwd_split)
    results = []
    for fused_bwd, dual in ((True, False), (False, True)):
        with _schedule(fused_bwd, dual):
            results.append(_port(q, k, v, do, causal=True))
            results.append(_port(q, k, v, do, segment_ids=seg,
                                 causal=False))
    for got, want in zip(results[2:], results[:2]):
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(g, w)
    assert (ops.flash_attention.launches_fwd,
            ops.flash_attention.launches_fwd_dual,
            ops.flash_attention.launches_bwd,
            ops.flash_attention.launches_bwd_split) == before


@pytest.mark.parametrize("dtype,d,keys", [
    (torch.bfloat16, 64, 128), (torch.bfloat16, 128, 128),
    (torch.bfloat16, 256, 64), (torch.float32, 64, 64),
    (torch.float32, 128, 64), (torch.float32, 256, 32)])
def test_dual_condition_counts_the_forward_kernels_kv_tiles(dtype, d, keys):
    """K12 runs where the forward kernel that would run has an even number
    of kv tiles: its own width (the bf16 wgmma forward's 128 keys, 64 at
    head_dim 256; the fp32 forward's 64, 32 at 256)."""
    assert ops.attention._fwd_kv_tile(dtype, d) == keys


def test_kernel_layout_copies_broadcast_views_only():
    """The kernels' layout: a view with 16-byte rows stays as it is (no
    copy); a broadcast (zero-stride) head or batch dimension, which the
    forward's TMA tensor maps cannot describe, is made contiguous."""
    x = torch.zeros(2, 8, 16, 64).transpose(1, 2)
    assert ops.attention._kernel_layout(x).data_ptr() == x.data_ptr()
    y = torch.randn(2, 1, 16, 64).expand(2, 4, 16, 64)
    z = ops.attention._kernel_layout(y)
    assert z.is_contiguous() and torch.equal(z, y)
    one = torch.randn(1, 1, 16, 64).expand(1, 1, 16, 64)
    assert ops.attention._kernel_layout(one).data_ptr() == one.data_ptr()


def test_attention_reference_vs_jax():
    q, k, v, _ = _inputs(2, 4, 2, 12, 12, 8)
    mask = rng.random((2, 1, 12, 12)) > 0.3
    mask[..., 0] = True
    want = jops.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), mask=jnp.asarray(mask),
                                    causal=True, softcap=4.0)
    got = ops.attention_reference(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), mask=torch.tensor(mask),
                                  causal=True, softcap=4.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_runs_plain_and_launches_nothing():
    q, k, v, do = (torch.tensor(x, requires_grad=True)
                   for x in _inputs(1, 2, 2, 8, 8, 16))
    before = (ops.flash_attention.launches_fwd,
              ops.flash_attention.launches_bwd)
    ops.flash_attention(q, k, v, causal=True).sum().backward()
    assert (ops.flash_attention.launches_fwd,
            ops.flash_attention.launches_bwd) == before


def test_bad_arguments_raise():
    q, k, v, _ = (torch.tensor(x) for x in _inputs(1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)                 # 3 heads over 2
    q, k, v, _ = (torch.tensor(x) for x in _inputs(1, 2, 2, 8, 8, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=4)       # window needs causal
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, sinks=torch.zeros(3))


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("group", [1, 2])
def test_plain_no_key_rows_vs_jax_jnp_path(group, d):
    """Rows that no key sees (non-causal, a q segment absent from kv): the
    plain version gives what JAX's jnp path gives, o the mean of v over all
    keys and gradients from p recomputed from that lse, fp32 within 1e-6 x
    max(1, max |JAX|) (gradients reach ~20 here, summed in another order). The
    flash kernels are held to the same rows on the card
    (tests/test_torch_cuda.py -k no_key)."""
    b, hkv, sq, skv = 2, 2, 40, 70
    q, k, v, do = _inputs(b, hkv * group, hkv, sq, skv, d)
    kv_seg = np.sort(rng.integers(0, 3, (b, skv)), axis=1).astype(np.int32)
    q_seg = np.sort(rng.integers(0, 5, (b, sq)), axis=1).astype(np.int32)
    q_seg[:, ::4] = 7                           # absent from kv_seg
    got = _port(q, k, v, do, segment_ids=(q_seg, kv_seg))
    want = _jax(q, k, v, do, segment_ids=(jnp.asarray(q_seg),
                                          jnp.asarray(kv_seg)))
    none = np.broadcast_to((q_seg == 7)[:, None, :, None], got[0].shape)
    np.testing.assert_allclose(
        got[0][none].reshape(b, -1, d),
        np.broadcast_to(v.mean(axis=2, keepdims=True).repeat(group, axis=1),
                        got[0].shape)[none].reshape(b, -1, d), atol=1e-6)
    for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(w).max()))
