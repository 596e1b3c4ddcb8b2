"""The port's paged attention against the JAX package's.

The plain PyTorch version is held against JAX ``paged_attention_reference``
(every option of the oracle) and against the JAX Pallas kernel run in
interpret mode, on the same numpy inputs (the JAX side under ``jax.jit``), in
fp32 at rtol 1e-5 / atol 2e-5.
Rows are compared only where every query row sees at least one position
(lengths >= sq): for emptier rows the TPU kernel and the oracle disagree by
design. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

import contextlib
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import ops as jops
from np_modeling_tpu.ops import dispatch as jdispatch
from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.ops import dispatch
from np_modeling_tpu_torch.serving import PagedKVCache

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)


def _case(b=3, sq=None, hq=4, hkv=2, d=16, psize=8, pages_per_seq=4,
          total=32, seed=0):
    rng = np.random.default_rng(seed)
    qshape = (b, hq, d) if sq is None else (b, sq, hq, d)
    q = rng.standard_normal(qshape).astype(np.float32)
    k = rng.standard_normal((hkv, total, psize, d)).astype(np.float32)
    v = rng.standard_normal((hkv, total, psize, d)).astype(np.float32)
    table = rng.permutation(total)[:b * pages_per_seq].reshape(
        b, pages_per_seq).astype(np.int32)
    lengths = rng.integers(max(sq or 1, 1), pages_per_seq * psize + 1,
                           b).astype(np.int32)
    return q, k, v, lengths, table


def _torch(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _jit(fn, *args, **kw):
    """``fn(*args, **kw)`` as one compiled JAX function (keywords static):
    eagerly JAX compiles each op for each new shape."""
    return jax.jit(functools.partial(fn, **kw))(*args)


CASES = [
    dict(),                                   # 3-D q, GQA g=2
    dict(hq=4, hkv=4),                        # MHA
    dict(hq=8, hkv=2, psize=16),              # g=4
    dict(hq=4, hkv=1),                        # one kv head
    dict(sq=1),                               # 4-D q, one token
    dict(sq=5, hq=8, hkv=2),                  # chunked append, GQA
    dict(sq=8, hq=4, hkv=4, pages_per_seq=6),
]
OPTIONS = [dict(), dict(window=3), dict(window=20), dict(softcap=5.0),
           dict(scale=0.3)]


@pytest.mark.parametrize("opts", OPTIONS)
@pytest.mark.parametrize("case", CASES)
def test_plain_vs_jax_reference(case, opts):
    q, k, v, lengths, table = _case(**case)
    want = _jit(jops.paged_attention_reference,
                *(jnp.asarray(a) for a in (q, k, v, lengths, table)), **opts)
    got = ops.paged_attention(*_torch(q, k, v, lengths, table), **opts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sq", [None, 3])
def test_plain_vs_jax_reference_bias_and_sinks(sq):
    q, k, v, lengths, table = _case(sq=sq, hq=8, hkv=2)
    rng = np.random.default_rng(1)
    bias = rng.standard_normal((3, 8, 4 * 8)).astype(np.float32)
    sinks = rng.standard_normal((8,)).astype(np.float32)
    want = _jit(lambda *a: jops.paged_attention_reference(
        *a[:5], bias=a[5], sinks=a[6]),
        *(jnp.asarray(a) for a in (q, k, v, lengths, table, bias, sinks)))
    got = ops.paged_attention(*_torch(q, k, v, lengths, table),
                              bias=torch.from_numpy(bias),
                              sinks=torch.from_numpy(sinks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (bias form, sq): a 4-D [b, hq, sq, L] bias, and 3-D biases narrower (L 20)
# and wider (L 45) than the table's 32 positions, GQA g = 2.
BIAS_CASES = [("4d", 3), ("narrow", None), ("narrow", 3), ("wide", None),
              ("wide", 3)]


@pytest.mark.parametrize("form,sq", BIAS_CASES)
def test_plain_bias_vs_jax_reference(form, sq):
    """Positions past a narrow bias get none; columns past the table are
    ignored; the bias follows each row's q head (h g + j) and token."""
    q, k, v, lengths, table = _case(sq=sq, hq=8, hkv=4)
    rng = np.random.default_rng(2)
    width = {"4d": 32, "narrow": 20, "wide": 45}[form]
    shape = (3, 8, sq, width) if form == "4d" else (3, 8, width)
    bias = (4.0 * rng.standard_normal(shape)).astype(np.float32)
    want = _jit(lambda *a: jops.paged_attention_reference(*a[:5], bias=a[5]),
                *(jnp.asarray(a) for a in (q, k, v, lengths, table, bias)))
    got = ops.paged_attention(*_torch(q, k, v, lengths, table),
                              bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = ops.paged_attention(*_torch(q, k, v, lengths, table))
    assert not np.allclose(got.numpy(), plain.numpy(), atol=1e-3)


def test_kernel_bias_strides_from_views():
    """The wrapper hands the kernel a bias's strides (elements, over b, q
    head, query token, position), 0 on a broadcast axis, and copies
    nothing: the engine's [h, S, n] gather seen as [S, h, n], a 4-D bias,
    a size-1 broadcast; other dtypes and shapes raise."""
    pa = importlib.import_module("np_modeling_tpu_torch.ops.paged_attention")
    by_dist = torch.zeros(12, 8, 128)            # [h, S, n] gather
    assert pa._bias_strides(by_dist.movedim(1, 0), 8, 12, 1) == (
        [128, 8 * 128, 0, 1], 128)
    assert pa._bias_strides(torch.zeros(2, 4, 5, 40), 2, 4, 5) == (
        [800, 200, 40, 1], 40)
    assert pa._bias_strides(torch.zeros(1, 4, 1, 40), 2, 4, 5) == (
        [0, 40, 0, 1], 40)
    for bad in (torch.zeros(2, 4, 40, dtype=torch.bfloat16),
                torch.zeros(2, 3, 40), torch.zeros(2, 4, 3, 40),
                torch.zeros(4, 40)):
        with pytest.raises(ValueError):
            pa._bias_strides(bad, 2, 4, 5)


def test_plain_int8_dequant_vs_jax():
    from np_modeling_tpu.ops.quantization import quantize_int8
    q, k, v, lengths, table = _case(hq=8, hkv=2)
    kq, vq = quantize_int8(jnp.asarray(k)), quantize_int8(jnp.asarray(v))
    want = jops.paged_attention(
        *(jnp.asarray(a) for a in (q,)), kq.values, vq.values,
        jnp.asarray(lengths), jnp.asarray(table), k_scales=kq.scales,
        v_scales=vq.scales)
    got = ops.paged_attention(
        *_torch(q, np.asarray(kq.values), np.asarray(vq.values), lengths,
                table), k_scales=torch.tensor(np.asarray(kq.scales)),
        v_scales=torch.tensor(np.asarray(vq.scales)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case,opts", [
    (dict(), dict()),
    (dict(hq=8, hkv=2), dict()),
    (dict(sq=4, hq=8, hkv=2), dict()),
    (dict(sq=3, hq=4, hkv=4), dict(window=5)),
    (dict(), dict(softcap=5.0)),
    # Gemma-2's head_dim 256 (GQA g=2) with its window and softcap: decode
    # and a chunk, a window inside a page, across pages and past every row.
    (dict(d=256, hq=4, hkv=2), dict(window=5, softcap=2.0)),
    (dict(d=256, sq=4, hq=4, hkv=2), dict(window=11, softcap=50.0)),
    (dict(d=256, sq=5, hq=4, hkv=2), dict(window=40, softcap=2.0)),
    (dict(d=256, sq=1, hq=4, hkv=2), dict(softcap=2.0, scale=0.125)),
])
def test_plain_vs_jax_pallas_kernel_interpret(case, opts):
    q, k, v, lengths, table = _case(**case)
    with jdispatch.force_pallas(True, interpret=True):
        want = _jit(jops.paged_attention,
                    *(jnp.asarray(a) for a in (q, k, v, lengths, table)),
                    pages_per_block=2, **opts)
    got = ops.paged_attention(*_torch(q, k, v, lengths, table), **opts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_dispatch_is_plain_and_unknown_device_raises():
    q, k, v, lengths, table = _torch(*_case())
    launches = ops.paged_attention.launches
    with dispatch.force_plain():
        forced = ops.paged_attention(q, k, v, lengths, table)
    plain = ops.paged_attention(q, k, v, lengths, table)
    torch.testing.assert_close(plain, forced, rtol=0, atol=0)
    assert ops.paged_attention.launches == launches
    with pytest.raises(NotImplementedError):
        dispatch.use_kernel(torch.empty(1, device="meta"))


def test_paged_kv_cache_appends_and_views():
    rng = np.random.default_rng(2)
    cache = PagedKVCache(num_kv_heads=2, head_dim=8, total_pages=8,
                         page_size=4, max_seqs=2)
    k = torch.from_numpy(rng.standard_normal((2, 7, 8)).astype(np.float32))
    cache.allocate(0)
    cache.append(0, k[:, :3], -k[:, :3])
    cache.append(0, k[:, 3:], -k[:, 3:])
    lengths, table = cache.batch_views([0])
    assert lengths.tolist() == [7] and cache.free_pages == 6
    pages = cache.k_pages[:, table[0].long()].reshape(2, 8, 8)[:, :7]
    torch.testing.assert_close(pages, k, rtol=0, atol=0)
    cache.free(0)
    assert cache.free_pages == 8


# ---- int8 pages (the int8 KV cache) --------------------------------------------

def _int8_case(case, q_dtype):
    """Pages quantized per token by JAX's quantize_int8; the same int8 pages
    and fp32 scales go to both packages."""
    from np_modeling_tpu.ops.quantization import quantize_int8
    q, k, v, lengths, table = _case(**case)
    kq, vq = quantize_int8(jnp.asarray(k)), quantize_int8(jnp.asarray(v))
    jax_args = (jnp.asarray(q).astype(q_dtype), kq.values, vq.values,
                jnp.asarray(lengths), jnp.asarray(table))
    scales = dict(k_scales=kq.scales, v_scales=vq.scales)
    torch_args = (torch.tensor(q).to(getattr(torch, q_dtype)),
                  *_torch(kq.values, vq.values, lengths, table))
    torch_scales = {n: torch.tensor(np.asarray(s)) for n, s in scales.items()}
    return jax_args, scales, torch_args, torch_scales


def _bf16_close(got, want):
    """One bf16 ulp of either value, or the fp32 tolerance near 0."""
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(
        np.abs(np.stack([got, want])), 2.0 ** -126))) - 7).max(axis=0)
    assert (np.abs(got - want) <= np.maximum(
        ulp, TOL["rtol"] * np.abs(want) + TOL["atol"])).all()


INT8_CASES = [dict(hq=8, hkv=2),                       # decode, GQA
              dict(sq=1, hq=4, hkv=4),
              dict(sq=5, hq=8, hkv=2),                 # chunk, GQA
              dict(sq=8, hq=4, hkv=1, pages_per_seq=6)]


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("case", INT8_CASES)
def test_plain_int8_pages_vs_jax(case, pallas, q_dtype):
    jax_args, scales, torch_args, torch_scales = _int8_case(case, q_dtype)
    block = dict(pages_per_block=2) if pallas else {}
    run = (lambda *a: jops.paged_attention(*a[:5], k_scales=a[5],
                                           v_scales=a[6], **block))
    with (jdispatch.force_pallas(True, interpret=True) if pallas
          else contextlib.nullcontext()):
        want = _jit(run, *jax_args, scales["k_scales"], scales["v_scales"])
    got = ops.paged_attention(*torch_args, **torch_scales)
    assert got.dtype == torch_args[0].dtype and got.shape == want.shape
    if q_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        _bf16_close(got, want)


def test_int8_pages_and_scales_come_together():
    _, _, (q, k8, v8, lengths, table), sc = _int8_case(dict(), "float32")
    with pytest.raises(ValueError, match="int8 pages"):
        ops.paged_attention(q, k8, v8, lengths, table)
    with pytest.raises(ValueError, match="int8 pages"):
        ops.paged_attention(q, k8.float(), v8.float(), lengths, table, **sc)
    with pytest.raises(ValueError, match="int8 pages"):
        ops.paged_attention(q, k8, v8, lengths, table,
                            k_scales=sc["k_scales"])


def test_quantized_paged_kv_cache_equals_jax():
    from np_modeling_tpu.serving import PagedKVCache as JaxCache
    rng = np.random.default_rng(3)
    kw = dict(num_kv_heads=2, head_dim=8, total_pages=8, page_size=4,
              max_seqs=2, quantize=True)
    jcache, tcache = JaxCache(**kw), PagedKVCache(**kw)
    for seq in (0, 1):
        jcache.allocate(seq)
        tcache.allocate(seq)
    k = rng.standard_normal((2, 9, 8)).astype(np.float32)
    v = rng.standard_normal((2, 9, 8)).astype(np.float32)
    v[:, 2] = 0.0                               # an all-zero token
    for seq, lo, hi in ((0, 0, 3), (1, 3, 5), (0, 5, 9)):
        jcache.append(seq, jnp.asarray(k[:, lo:hi]), jnp.asarray(v[:, lo:hi]))
        tcache.append(seq, torch.tensor(k[:, lo:hi]), torch.tensor(v[:, lo:hi]))
    assert tcache.k_pages.dtype == torch.int8
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        np.testing.assert_array_equal(getattr(tcache, name).numpy(),
                                      np.asarray(getattr(jcache, name)))
    lengths, table = tcache.batch_views([0, 1])
    jl, jt = jcache.batch_views([0, 1])
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jt))
    q = rng.standard_normal((2, 4, 8)).astype(np.float32)
    want = jops.paged_attention(jnp.asarray(q), jcache.k_pages,
                                jcache.v_pages, jl, jt,
                                **jcache.attention_kwargs())
    got = ops.paged_attention(torch.tensor(q), tcache.k_pages,
                              tcache.v_pages, lengths, table,
                              **tcache.attention_kwargs())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert PagedKVCache(**{**kw, "quantize": False}).attention_kwargs() == {}


SPLIT_CASES = [
    (dict(), {}),                                           # GQA g=2
    (dict(hq=8, hkv=2, psize=16, pages_per_seq=6), dict(window=20)),
    (dict(sq=5, hq=8, hkv=2), dict(softcap=5.0)),
    (dict(sq=1, hq=4, hkv=4, pages_per_seq=8), dict(window=9, softcap=2.0)),
    (dict(hq=4, hkv=1, pages_per_seq=8), dict(scale=0.3)),
]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("split_keys", [8, 16, 24, 1000])
@pytest.mark.parametrize("case,opts", SPLIT_CASES)
def test_split_and_merge_vs_reference_and_jax(case, opts, split_keys, int8):
    """K3's split-KV math in plain PyTorch (partials over key ranges, some
    empty: past a length or below the window, merged by their m and l)
    equals the port's and JAX's paged_attention_reference on the same numpy
    inputs, fp32 rtol 1e-5 / atol 2e-5; int8 pages dequantized as the kernel
    dequantizes them."""
    q, k, v, lengths, table = _case(**case)
    if int8:
        kq = ops.quantize_int8(torch.tensor(k))
        vq = ops.quantize_int8(torch.tensor(v))
        k = (kq.values.float() * kq.scales).numpy()
        v = (vq.values.float() * vq.scales).numpy()
    width = table.shape[1] * k.shape[2]
    splits = -(-width // split_keys)
    got = ops.paged_attention_split_reference(
        *_torch(q, k, v, lengths, table), splits, split_keys, **opts)
    want = ops.paged_attention_reference(*_torch(q, k, v, lengths, table),
                                         **opts)
    jwant = _jit(jops.paged_attention_reference,
                 *(jnp.asarray(a) for a in (q, k, v, lengths, table)), **opts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **TOL)


@pytest.mark.parametrize("b,hkv,rows,d,pps,psize,want_splits", [
    (8, 4, 2, 256, 512, 16, 32),     # Gemma-2 decode: 8 x 4 pairs
    (8, 12, 1, 64, 64, 16, 4),       # GPT-2 decode
    (7, 12, 256, 64, 48, 16, 1),     # GPT-2 prefill chunk: grid full already
    (7, 4, 512, 256, 64, 16, 1),     # Gemma-2 prefill chunk
    (8, 4, 2, 256, 16, 16, 1),       # a table of 256 keys
    (2, 2, 10, 128, 9, 64, 2),       # page 64: ranges of whole pages
])
def test_split_plan_from_table_width(b, hkv, rows, d, pps, psize,
                                     want_splits):
    """The wrapper's split plan depends on shapes alone (the table's width,
    never lengths, which lie on the card): ranges are whole multiples of 32
    keys and of the page, cover the width, and leave no range empty of the
    width; a small grid grows to at least two blocks an SM where the width
    allows. 132 SMs: an H100 SXM's."""
    pa = importlib.import_module("np_modeling_tpu_torch.ops.paged_attention")
    splits, keys = pa.split_plan(b, hkv, rows, d, pps, psize, 132)
    width = pps * psize
    assert splits == want_splits
    assert splits * keys >= width > (splits - 1) * keys
    if splits > 1:
        assert keys % 32 == 0 and keys % psize == 0
        assert keys >= pa.MIN_SPLIT_KEYS
        tile = 2 if rows <= 2 else (32 if d > 128 else 64)
        blocks = -(-rows // tile) * hkv * b * splits
        assert blocks >= pa.FULL_GRID_PER_SM * 132 \
            or keys * (splits - 1) < width
