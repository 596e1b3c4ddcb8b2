"""The port's paged attention against the JAX package's.

The plain PyTorch version is held against JAX ``paged_attention_reference``
(every option of the oracle) and against the JAX Pallas kernel run in
interpret mode, on the same numpy inputs, in fp32 at rtol 1e-5 / atol 2e-5.
Rows are compared only where every query row sees at least one position
(lengths >= sq): for emptier rows the TPU kernel and the oracle disagree by
design. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import ops as jops
from np_modeling_tpu.ops import dispatch as jdispatch
from np_modeling_tpu_torch import ops
from np_modeling_tpu_torch.ops import dispatch
from np_modeling_tpu_torch.serving import PagedKVCache

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
    want = jops.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(table), **opts)
    got = ops.paged_attention(*_torch(q, k, v, lengths, table), **opts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sq", [None, 3])
def test_plain_vs_jax_reference_bias_and_sinks(sq):
    q, k, v, lengths, table = _case(sq=sq, hq=8, hkv=2)
    rng = np.random.default_rng(1)
    bias = rng.standard_normal((3, 8, 4 * 8)).astype(np.float32)
    sinks = rng.standard_normal((8,)).astype(np.float32)
    want = jops.paged_attention_reference(
        *(jnp.asarray(a) for a in (q, k, v, lengths, table)),
        bias=jnp.asarray(bias), sinks=jnp.asarray(sinks))
    got = ops.paged_attention(*_torch(q, k, v, lengths, table),
                              bias=torch.from_numpy(bias),
                              sinks=torch.from_numpy(sinks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
])
def test_plain_vs_jax_pallas_kernel_interpret(case, opts):
    q, k, v, lengths, table = _case(**case)
    with jdispatch.force_pallas(True, interpret=True):
        want = jops.paged_attention(
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
