"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card: the kernels
have no CPU mode. This file imports no JAX, so the card can run it alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which that machine
does not have). Tolerances: fp32 1e-4, bf16 2e-2, each times max(1, max
|plain|) for flash attention; LayerNorm fp32 1e-5 times max(1, max |plain|)
and bf16 one bf16 ulp (or that fp32 bound near 0); dropout bit for bit;
K11 (matmul) as K4: fp32 out 1e-4 times max(1, max |plain|), bf16 out one
bf16 ulp; K9 ce 1e-5 times max(1, max |plain|), dlogits 1e-4 relative plus
1e-6 times the largest (bf16: one ulp); K10 bit for bit; the whole-GPT
criteria are the ones chip_smoke.py holds at full width, explained there.
"""

import contextlib
import importlib

import numpy as np
import pytest
import torch

from chip_smoke import _schedule
from np_modeling_tpu_torch import models, ops
from np_modeling_tpu_torch.ops import dispatch, fused

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2


# ---- paged attention (K3/K6) ----------------------------------------------------

def _paged_case(b, sq, hq, hkv, d, psize, pages_per_seq, total, seed=0):
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


@pytest.mark.parametrize("sq,hq,hkv,d,psize", [
    (None, 12, 12, 64, 16), (5, 12, 12, 64, 64), (256, 12, 12, 64, 16),
    (None, 8, 2, 128, 64), (5, 8, 2, 128, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_vs_plain(sq, hq, hkv, d, psize, dtype):
    rows = sq or 1
    pps = max(8, -(-(rows + 64) // psize))
    q, k, v, lengths, table = _paged_case(4, sq, hq, hkv, d, psize, pps,
                                          4 * pps + 2)
    lengths[:2] = [rows, psize * -(-rows // psize)]  # shortest; whole pages
    q, k, v, lengths, table = (torch.tensor(a).cuda()
                               for a in (q, k, v, lengths, table))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    got = ops.paged_attention(q, k, v, lengths, table)
    with dispatch.force_plain():
        want = ops.paged_attention(q, k, v, lengths, table)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype)


@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("opts", [
    dict(window=5), dict(window=37), dict(window=4096), dict(softcap=50.0),
    dict(softcap=2.0, window=37), dict(softcap=2.0, window=5, scale=0.0625)],
    ids=["window_in_page", "window_across", "window_past", "softcap",
         "both", "both_scaled"])
@pytest.mark.parametrize("sq,hq,hkv,d,psize", [
    (None, 8, 4, 256, 16), (5, 8, 4, 256, 16), (64, 8, 4, 256, 16),
    (None, 12, 12, 64, 16), (5, 8, 2, 128, 64)])
def test_cuda_kernel_window_softcap_vs_plain(sq, hq, hkv, d, psize, opts,
                                             pages):
    """K3's window and softcap (Gemma-2: head_dim 256, GQA g=2) against the
    plain version, with fp32, bf16 and int8 pages: windows inside a page,
    across pages and past every row. Table entries below the band of the
    first row and past the length are poisoned: the kernel reads neither."""
    rows = sq or 1
    pps = max(8, -(-(rows + 64) // psize))
    q, k, v, lengths, table = _paged_case(4, sq, hq, hkv, d, psize, pps,
                                          4 * pps + 2)
    lengths[:2] = [rows, psize * -(-rows // psize)]
    q, k, v, lengths, table = (torch.tensor(a).cuda()
                               for a in (q, k, v, lengths, table))
    kw = dict(opts)
    dtype = torch.bfloat16 if pages == "bfloat16" else torch.float32
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if pages == "int8":
        kq, vq = ops.quantize_int8(k), ops.quantize_int8(v)
        k, v = kq.values, vq.values
        kw.update(k_scales=kq.scales, v_scales=vq.scales)
    got = ops.paged_attention(q, k, v, lengths, table, **kw)
    with dispatch.force_plain():
        want = ops.paged_attention(q, k, v, lengths, table, **kw)
    poisoned = table.clone()
    window = opts.get("window", 1 << 30)
    for i, ln in enumerate(lengths.tolist()):
        poisoned[i, -(-ln // psize):] = 2 ** 30
        poisoned[i, :max(0, ln - rows - window + 1) // psize] = 2 ** 30
    again = ops.paged_attention(q, k, v, lengths, poisoned, **kw)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype)
    assert torch.equal(got, again)


# (splits, keys a split) forced on the kernel: one split, several, and more
# splits than the sequences have pages; None keeps the wrapper's own plan.
_SPLITS = [None, (1, None), (6, 96), (16, 32)]


@pytest.mark.parametrize("split", _SPLITS,
                         ids=["plan", "one", "several", "past_pages"])
@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("opts", [{}, dict(window=40), dict(softcap=5.0)],
                         ids=["plain", "window", "softcap"])
@pytest.mark.parametrize("sq,hq,hkv,d", [
    (None, 8, 4, 256), (None, 12, 12, 64), (1, 8, 2, 128), (7, 8, 4, 256),
    (40, 4, 2, 64)])
def test_cuda_paged_split_kv_vs_plain(sq, hq, hkv, d, opts, pages, split,
                                      monkeypatch):
    """K3's split-KV grid against the plain version: forced split counts (one,
    several, more than the pages), lengths 0, 1, one page and one page plus
    one beside long ones, a window that empties whole splits, fp32, bf16 and
    int8 pages at d 64/128/256 with GQA, decode and chunk rows (sq > 1); the
    tolerances of the cases above; launches_split counts the split calls."""
    import importlib
    pa = importlib.import_module("np_modeling_tpu_torch.ops.paged_attention")
    psize, pps = 16, 32
    rows = sq or 1
    q, k, v, lengths, table = _paged_case(6, sq, hq, hkv, d, psize, pps,
                                          6 * pps + 2, seed=d + hq)
    lengths[:] = [0 if rows == 1 else rows, rows, psize, psize + 1, 300,
                  pps * psize]
    lengths = np.maximum(lengths, rows if rows > 1 else 0)
    plan = pa.split_plan
    if split is not None:
        monkeypatch.setattr(pa, "split_plan", lambda *a: (
            split[0], split[1] or pps * psize))
    q, k, v, lengths, table = (torch.tensor(a).cuda()
                               for a in (q, k, v, lengths, table))
    kw = dict(opts)
    dtype = torch.bfloat16 if pages == "bfloat16" else torch.float32
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if pages == "int8":
        kq, vq = ops.quantize_int8(k), ops.quantize_int8(v)
        k, v = kq.values, vq.values
        kw.update(k_scales=kq.scales, v_scales=vq.scales)
    before = ops.paged_attention.launches_split
    got = ops.paged_attention(q, k, v, lengths, table, **kw)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = (split or plan(6, hkv, rows * hq // hkv, d, pps, psize, sms))[0]
    assert ops.paged_attention.launches_split - before == int(splits > 1)
    with dispatch.force_plain():
        want = ops.paged_attention(q, k, v, lengths, table, **kw)
    torch.cuda.synchronize()
    live = lengths > 0
    assert (got[live].float() - want[live].float()).abs().max().item() \
        <= _tol(dtype)
    assert bool((got[~live] == 0).all())


@pytest.mark.parametrize("option", ["bias", "sinks"])
def test_cuda_paged_unported_options_raise(option):
    q, k, v, lengths, table = (torch.tensor(a).cuda() for a in _paged_case(
        2, None, 4, 2, 64, 16, 4, 10))
    kw = {"bias": dict(bias=torch.zeros(2, 4, 64, device="cuda")),
          "sinks": dict(sinks=torch.zeros(4, device="cuda"))}[option]
    with pytest.raises(NotImplementedError, match=option):
        ops.paged_attention(q, k, v, lengths, table, **kw)


def test_cuda_gemma2_engine_vs_plain_engine():
    """A small Gemma-2-shaped GPT (head_dim 256, window 8 on even layers,
    both softcaps), fp32: the kernel engine's greedy tokens equal the plain
    engine's, K3 launching once a layer a forward."""
    from np_modeling_tpu_torch.serving import GenerationEngine
    cfg = models.GPTConfig(
        vocab_size=256, d_model=128, num_layers=4, num_heads=4,
        num_kv_heads=2, head_dim=256, hidden_units=256, max_len=256,
        positional="rope", norm="rms", ln_eps=1e-6, rms_offset=True,
        ffn="geglu", use_bias=False, embed_scale=True, sandwich_norm=True,
        attention_window=8, window_pattern=2, attn_logit_softcap=2.0,
        final_logit_softcap=3.0, query_pre_attn_scalar=64.0)
    gpt = models.GPT(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, 256, n) for i, n in enumerate((40, 90, 7))}
    streams = []
    for plain in (False, True):
        eng = GenerationEngine(gpt, total_pages=64, page_size=16, max_seqs=4,
                               prefill_chunk_size=64)
        with dispatch.force_plain() if plain else contextlib.nullcontext():
            before = ops.paged_attention.launches
            first = eng.add_requests(prompts)
            streams.append((first, eng.step_many(8), eng.step()))
            launched = ops.paged_attention.launches - before
        # 2 chunk calls + 9 decode steps, 4 layers.
        assert launched == (0 if plain else 44)
    assert streams[0] == streams[1]


# ---- flash attention (K1/K2) ----------------------------------------------------

def _flash_inputs(b, hq, hkv, sq, skv, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(*s, generator=g, device="cuda").to(dtype)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                      (b, hq, sq, d))]


@pytest.mark.parametrize("shape", [(2, 4, 4, 200, 200, 64),
                                   (2, 8, 2, 200, 200, 128),
                                   (1, 4, 4, 128, 640, 128),
                                   (1, 4, 2, 640, 128, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernels_vs_plain(shape, causal, dtype):
    q, k, v, do = _flash_inputs(*shape, dtype)
    results = []
    for plain in (False, True):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        if plain:
            with dispatch.force_plain():
                o = ops.flash_attention(*leaves, causal=causal)
                o.backward(do)
        else:
            o = ops.flash_attention(*leaves, causal=causal)
            o.backward(do)
        results.append([o.detach()] + [x.grad for x in leaves])
    torch.cuda.synchronize()
    for got, want in zip(*results):
        bound = _tol(dtype) * max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= bound


def test_cuda_flash_kernels_count_launches():
    q, k, v, do = _flash_inputs(1, 2, 2, 64, 64, 64, torch.bfloat16)
    q.requires_grad_()
    before = (ops.flash_attention.launches_fwd,
              ops.flash_attention.launches_bwd)
    ops.flash_attention(q, k, v, causal=True).backward(do)
    assert (ops.flash_attention.launches_fwd,
            ops.flash_attention.launches_bwd) == (before[0] + 1,
                                                  before[1] + 1)


@pytest.mark.parametrize("option", ["mask", "bias"])
def test_cuda_flash_unported_options_raise(option):
    q, k, v, _ = _flash_inputs(1, 2, 2, 64, 64, 64, torch.float32)
    kw = {"mask": dict(mask=torch.ones(1, 1, 64, 64, dtype=torch.bool,
                                       device="cuda")),
          "bias": dict(bias=torch.zeros(1, 2, 64, 64, device="cuda"))}[option]
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, v, **kw)


def test_cuda_flash_other_head_dims_raise():
    q, k, v, _ = _flash_inputs(1, 2, 2, 64, 64, 96, torch.float32)
    with pytest.raises(ValueError, match="head_dim 96"):
        ops.flash_attention(q, k, v, causal=True)


# ---- window, softcap and head_dim 256 (Gemma-2) in K1/K2/K5/K12 ------------

@pytest.mark.parametrize("opts", [
    dict(window=7), dict(window=64), dict(window=100), dict(window=4096),
    dict(softcap=50.0), dict(softcap=2.0), dict(window=100, softcap=2.0)],
    ids=["window7", "window64", "window100", "window_past", "softcap50",
         "softcap2", "both"])
@pytest.mark.parametrize("shape", [(1, 8, 4, 320, 320, 256),
                                   (2, 4, 2, 200, 200, 64),
                                   (1, 4, 4, 128, 300, 128)])
@pytest.mark.parametrize("fused_bwd", [True, False], ids=["k2", "k5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_window_softcap_vs_plain(shape, opts, fused_bwd, dtype):
    """K1 with Gemma-2's options (causal) and K2 or K5 behind it against the
    plain version, at head_dim 256 (GQA 8/4) and at 64 and 128: windows
    inside a tile, at its edge, across tiles and past every row, softcaps
    that bite and that do not, and both; K5 bit-equal across two runs."""
    q, k, v, do = _flash_inputs(*shape, dtype)
    kw = dict(causal=True, **opts)
    with _schedule(fused_bwd=fused_bwd):
        before = (ops.flash_attention.launches_fwd,
                  ops.flash_attention.launches_bwd,
                  ops.flash_attention.launches_bwd_split)
        got = _fwd_bwd(q, k, v, do, **kw)
        after = (ops.flash_attention.launches_fwd,
                 ops.flash_attention.launches_bwd,
                 ops.flash_attention.launches_bwd_split)
        again = _fwd_bwd(q, k, v, do, **kw)
    want = _fwd_bwd(q, k, v, do, plain=True, **kw)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(after, before)) == (
        (1, 1, 0) if fused_bwd else (1, 0, 1))
    for x, y, z in zip(got, want, again):
        bound = _tol(dtype) * max(1.0, y.float().abs().max().item())
        assert (x.float() - y.float()).abs().max().item() <= bound
        if not fused_bwd:
            assert torch.equal(x, z)


@pytest.mark.parametrize("window", [7, 100, 1000])
@pytest.mark.parametrize("shape", [(1, 8, 4, 640, 640, 256),
                                   (2, 4, 2, 1000, 1000, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_dual_forward_with_window_equals_k1(shape, window, dtype):
    """K12 with a window gives K1's o and lse bit for bit; with a softcap
    the flag launches K1."""
    from np_modeling_tpu_torch.ops import attention
    q, k, v, _ = _flash_inputs(*shape, dtype)
    scale = shape[-1] ** -0.5
    single = attention._flash_fwd_cuda(q, k, v, True, scale, True,
                                       window=window)
    dual = attention._flash_fwd_cuda(q, k, v, True, scale, True, dual=True,
                                     window=window)
    torch.cuda.synchronize()
    assert torch.equal(single[0], dual[0]) and torch.equal(single[1], dual[1])
    before = (ops.flash_attention.launches_fwd,
              ops.flash_attention.launches_fwd_dual)
    with _schedule(dual=True), torch.no_grad():
        ops.flash_attention(q, k, v, causal=True, window=window)
        ops.flash_attention(q, k, v, causal=True, window=window, softcap=5.0)
    assert (ops.flash_attention.launches_fwd - before[0],
            ops.flash_attention.launches_fwd_dual - before[1]) == (1, 1)


def test_cuda_gemma2_gpt_loss_fp32_kernels_vs_plain():
    """A small Gemma-2-shaped GPT (head_dim 256, GQA 4/2, window 40 on even
    layers, both softcaps), fp32: GPT.loss and every gradient through K1/K2
    against the plain path on 2 x 160 tokens (the windows cut): loss to
    1e-5, each gradient to 1e-4 relative L2."""
    cfg = models.GPTConfig(
        vocab_size=256, d_model=128, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=256, hidden_units=256, max_len=256,
        positional="rope", norm="rms", ln_eps=1e-6, rms_offset=True,
        ffn="geglu", use_bias=False, embed_scale=True, sandwich_norm=True,
        attention_window=40, window_pattern=2, attn_logit_softcap=2.0,
        final_logit_softcap=3.0, query_pre_attn_scalar=64.0)
    gpt = models.GPT(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, 256, (2, 160), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    before = ops.flash_attention.launches_fwd, ops.flash_attention.launches_bwd
    lk, gk = _grads(gpt, tokens, plain=False)
    assert (ops.flash_attention.launches_fwd - before[0],
            ops.flash_attention.launches_bwd - before[1]) == (2, 2)
    lp, gp = _grads(gpt, tokens, plain=True)
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for n in gp:
        assert _rel(gk[n], gp[n]) <= 1e-4, n


# ---- segment ids in K1/K2, the split backward K5, the dual forward K12 ----

def _packed_segments(b, s, seed=0):
    """Sorted document ids, documents 1..299 keys long, as packing makes
    them."""
    rng = np.random.default_rng(seed)
    ids = np.stack([np.repeat(np.arange(s), rng.integers(1, 300, s))[:s]
                    for _ in range(b)])
    return torch.tensor(ids, dtype=torch.int32, device="cuda")


def _fwd_bwd(q, k, v, do, plain=False, **kw):
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    with dispatch.force_plain() if plain else contextlib.nullcontext():
        o = ops.flash_attention(*leaves, **kw)
        o.backward(do)
    return [o.detach()] + [x.grad for x in leaves]


@pytest.mark.parametrize("shape", [(2, 4, 4, 200, 200, 64),
                                   (2, 8, 2, 384, 384, 128),
                                   (1, 4, 2, 128, 640, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fused_bwd", [True, False], ids=["k2", "k5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_segments_vs_plain(shape, causal, fused_bwd, dtype):
    """K1 with segment ids and K2 or K5 behind it; q's ids are kv's first
    sq, so every q row has a key of its own document."""
    q, k, v, do = _flash_inputs(*shape, dtype)
    kv_seg = _packed_segments(shape[0], shape[4])
    kw = dict(segment_ids=(kv_seg[:, :shape[3]], kv_seg), causal=causal)
    with _schedule(fused_bwd=fused_bwd):
        before = (ops.flash_attention.launches_bwd,
                  ops.flash_attention.launches_bwd_split)
        got = _fwd_bwd(q, k, v, do, **kw)
        after = (ops.flash_attention.launches_bwd,
                 ops.flash_attention.launches_bwd_split)
        want = _fwd_bwd(q, k, v, do, plain=True, **kw)
    torch.cuda.synchronize()
    assert (after[0] - before[0], after[1] - before[1]) == (
        (1, 0) if fused_bwd else (0, 1))
    for x, y in zip(got, want):
        bound = _tol(dtype) * max(1.0, y.float().abs().max().item())
        assert (x.float() - y.float()).abs().max().item() <= bound


# (causal, options) of the K2/K5 cases: every option each way it is taken
# (a window needs causal).
_BWD_OPTIONS = [(False, "none"), (True, "none"), (False, "segments"),
                (True, "segments"), (True, "window"), (False, "softcap"),
                (True, "softcap")]


@pytest.mark.parametrize("causal,option", _BWD_OPTIONS,
                         ids=[f"{'causal' if c else 'full'}-{o}"
                              for c, o in _BWD_OPTIONS])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("split", [False, True], ids=["k2", "k5"])
def test_cuda_flash_bwd_bf16_vs_plain_backward(d, group, causal, option,
                                               split):
    """K2 (and K5) in bf16 against ``_attn_bwd_plain`` on the same o and lse:
    dk and dv come out per kv head, each GQA group's q heads summed inside
    the kernel in fp32; ragged sq != skv and tiles cut by the window and the
    documents; K5 the same bits on every run."""
    from np_modeling_tpu_torch.ops import attention
    # Every q row keeps a key (causal rows past skv + window, or a document
    # absent from kv, would make a row that no key sees, whose gradients
    # follow the tiles a kernel visits).
    hkv = 2
    sq, skv = (300, 190) if not causal and option != "segments" else (260, 300)
    q, k, v, do = _flash_inputs(2, hkv * group, hkv, sq, skv, d,
                                torch.bfloat16, seed=d + group)
    seg = None
    kw = {}
    if option == "segments":
        kv_seg = _packed_segments(2, max(sq, skv))
        seg = (kv_seg[:, :sq], kv_seg[:, :skv])
    elif option == "window":
        kw["window"] = 37
    elif option == "softcap":
        kw["softcap"] = 2.0
    scale = d ** -0.5
    o, lse = attention._flash_fwd_cuda(q, k, v, causal, scale, True,
                                       *(seg or (None, None)), **kw)
    o = o.contiguous()
    got = attention._flash_bwd_cuda(q, k, v, o, lse, do, causal, scale,
                                    *(seg or (None, None)), split=split, **kw)
    again = attention._flash_bwd_cuda(q, k, v, o, lse, do, causal, scale,
                                      *(seg or (None, None)), split=split,
                                      **kw)
    mask = attention._merge_seg_into_mask(None, *(seg or (None, None)))
    want = attention._attn_bwd_plain(q, k, v, o, lse, do, mask, None, causal,
                                     kw.get("window"), scale,
                                     kw.get("softcap"))[:3]
    torch.cuda.synchronize()
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in want]
    for x, y in zip(got, want):
        bound = 2e-2 * max(1.0, y.float().abs().max().item())
        assert (x.float() - y.float()).abs().max().item() <= bound
    if split:
        assert all(torch.equal(x, y) for x, y in zip(got, again))


# (causal, option) of the bf16 forward cases; window widths are in kv tiles of
# the forward (128 keys, 64 at head_dim 256): 7 keys, a tile's edge -1, 0, +1,
# and one past every key.
_FWD_OPTIONS = [(False, "none"), (True, "none"), (True, "window7"),
                (True, "window_edge-1"), (True, "window_edge"),
                (True, "window_edge+1"), (True, "window_past"),
                (False, "softcap"), (True, "softcap"), (True, "window+softcap"),
                (False, "segments"), (True, "segments")]


@pytest.mark.parametrize("causal,option", _FWD_OPTIONS,
                         ids=[f"{'causal' if c else 'full'}-{o}"
                              for c, o in _FWD_OPTIONS])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_flash_fwd_bf16_vs_plain(d, group, causal, option):
    """K1 in bf16 (wgmma, the TMA k/v ring, the mask on edge tiles only)
    against ``_attn_fwd_plain``: o and lse within 2e-2 x max(1, max |plain|),
    at sq and skv that are multiples of neither tile and differ; K12 on the
    same inputs, wherever it takes them (no segment ids or softcap), gives
    K1's o and lse bit for bit."""
    from np_modeling_tpu_torch.ops import attention
    # Every q row keeps a key: causal rows stay below skv, and q's segment
    # ids are kv's first sq (a row with no key takes the mean of v over the
    # columns its tiles visit, which depends on the tile width).
    hkv = 2
    sq, skv = (260, 300) if causal or option == "segments" else (300, 190)
    q, k, v, _ = _flash_inputs(2, hkv * group, hkv, sq, skv, d,
                               torch.bfloat16, seed=3 * d + group)
    tile = attention._fwd_kv_tile(torch.bfloat16, d)
    seg = None
    kw = {}
    if option == "segments":
        kv_seg = _packed_segments(2, skv)
        seg = (kv_seg[:, :sq], kv_seg)
    if option.startswith("window"):
        kw["window"] = {"window7": 7, "window_edge-1": tile - 1,
                        "window_edge": tile, "window_edge+1": tile + 1,
                        "window_past": skv + 1}.get(option, 100)
    if option.endswith("softcap"):
        kw["softcap"] = 2.0
    scale = d ** -0.5
    before = ops.flash_attention.launches_fwd
    o, lse = attention._flash_fwd_cuda(q, k, v, causal, scale, True,
                                       *(seg or (None, None)), **kw)
    assert ops.flash_attention.launches_fwd == before + 1
    mask = attention._merge_seg_into_mask(None, *(seg or (None, None)))
    want = attention._attn_fwd_plain(q, k, v, mask, None, causal,
                                     kw.get("window"), scale,
                                     kw.get("softcap"))
    if seg is None and "softcap" not in kw:
        dual = attention._flash_fwd_cuda(q, k, v, causal, scale, True,
                                         dual=True, **kw)
    torch.cuda.synchronize()
    for x, y in zip((o, lse), want):
        assert x.shape == y.shape
        bound = 2e-2 * max(1.0, y.float().abs().max().item())
        assert (x.float() - y.float()).abs().max().item() <= bound
    if seg is None and "softcap" not in kw:
        assert torch.equal(o, dual[0]) and torch.equal(lse, dual[1])


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_no_key_rows_vs_plain(dtype, d):
    """P6: non-causal rows that no key sees (a q segment absent from kv_seg)
    take the mean of v over all skv keys and lse = mask + log(skv), as the
    plain path does, at every tile width (skv not a multiple of the forward's
    kv tile, so its last tile holds columns past skv): o of K1, its lse on
    rows with keys, equal to the plain lse on rows without, and dq, dk, dv
    of K2 and K5 on those o and lse, against the plain path; K12 bit-equal to
    K1 without segment ids on the same ragged skv. v has a mean of ~2, so a
    mean over the visited columns instead of the keys (skv of them over
    whole tiles) is ~0.24 off, 6x the bf16 bound."""
    from np_modeling_tpu_torch.ops import attention
    hkv, group, sq = 2, 2, 200
    tile = attention._fwd_kv_tile(dtype, d)
    skv = 3 * tile + tile // 2 + 3
    q, k, v, do = _flash_inputs(2, hkv * group, hkv, sq, skv, d, dtype,
                                seed=d)
    v = v + 2
    kv_seg = _packed_segments(2, skv)
    q_seg = _packed_segments(2, sq)
    q_seg[:, ::3] = 1 << 20                     # absent from kv_seg
    scale = d ** -0.5
    o, lse = attention._flash_fwd_cuda(q, k, v, False, scale, True, q_seg,
                                       kv_seg)
    mask = attention._merge_seg_into_mask(None, q_seg, kv_seg)
    want = attention._attn_fwd_plain(q, k, v, mask, None, False, None, scale)
    bound = _tol(dtype) * max(1.0, want[0].float().abs().max().item())
    assert (o.float() - want[0].float()).abs().max().item() <= bound
    # Rows without a key: the absent segment, and rows of a document that
    # the kv packing does not hold.
    keyless = ~(q_seg[:, :, None] == kv_seg[:, None, :]).any(-1)
    rows = keyless[:, None, :].expand(lse.shape)
    keyed = want[1][~rows]
    bound = _tol(dtype) * max(1.0, keyed.abs().max().item())
    assert (lse[~rows] - keyed).abs().max().item() <= bound
    assert torch.equal(lse[rows], want[1][rows])
    none = keyless[:, None, :, None].expand(o.shape)
    mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(group, 1)
    assert (o.float() - mean.expand(o.shape))[none].abs().max().item() \
        <= _tol(dtype) * max(1.0, mean.abs().max().item())
    o = o.contiguous()
    grads = attention._attn_bwd_plain(q, k, v, o, lse, do, mask, None, False,
                                      None, scale)[:3]
    for split in (False, True):
        got = attention._flash_bwd_cuda(q, k, v, o, lse, do, False, scale,
                                        q_seg, kv_seg, split=split)
        for x, y in zip(got, grads):
            bound = _tol(dtype) * max(1.0, y.float().abs().max().item())
            assert (x.float() - y.float()).abs().max().item() <= bound
    single = attention._flash_fwd_cuda(q, k, v, False, scale, True)
    if -(-skv // tile) % 2 == 0:
        dual = attention._flash_fwd_cuda(q, k, v, False, scale, True,
                                         dual=True)
        assert torch.equal(single[0], dual[0])
        assert torch.equal(single[1], dual[1])
    plain = attention._attn_fwd_plain(q, k, v, None, None, False, None,
                                      scale)
    torch.cuda.synchronize()
    for x, y in zip(single, plain):
        bound = _tol(dtype) * max(1.0, y.float().abs().max().item())
        assert (x.float() - y.float()).abs().max().item() <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_window_rows_past_every_key(dtype):
    """The documented divergence (ROADMAP Queue 3, beside F6): with a window
    and sq > skv, causal rows r >= skv + W - 1 see no key; a q tile made of
    such rows visits no kv tile (band skipping), so K1 stores o = 0 and lse =
    the mask value there (the plain path gives the mean of v)."""
    from np_modeling_tpu_torch.ops import attention
    sq, skv, window = 512, 64, 8
    q, k, v, _ = _flash_inputs(1, 2, 2, sq, skv, 64, dtype, seed=5)
    o, lse = attention._flash_fwd_cuda(q, k, v, True, 0.125, True,
                                       window=window)
    torch.cuda.synchronize()
    assert bool((o[:, :, 256:] == 0).all())
    assert bool((lse[:, :, 256:] == attention.DEFAULT_MASK_VALUE).all())


@pytest.mark.parametrize("shape", [(2, 8, 2, 200, 200, 64),
                                   (1, 4, 4, 256, 256, 128)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_split_backward_vs_plain_and_repeatable(shape, causal,
                                                           dtype):
    """K5 against the plain version, bit-equal to itself across two runs,
    and against K2 at fp32 rtol 2e-5 / atol 5e-5 (JAX's bound)."""
    q, k, v, do = _flash_inputs(*shape, dtype)
    with _schedule(fused_bwd=False):
        first = _fwd_bwd(q, k, v, do, causal=causal)
        again = _fwd_bwd(q, k, v, do, causal=causal)
    fused = _fwd_bwd(q, k, v, do, causal=causal)
    want = _fwd_bwd(q, k, v, do, plain=True, causal=causal)
    torch.cuda.synchronize()
    for x, y, z, w in zip(first, again, fused, want):
        assert torch.equal(x, y)
        bound = _tol(dtype) * max(1.0, w.float().abs().max().item())
        assert (x.float() - w.float()).abs().max().item() <= bound
        if dtype == torch.float32:
            torch.testing.assert_close(x, z, rtol=2e-5, atol=5e-5)


@pytest.mark.parametrize("shape", [(2, 4, 2, 256, 256, 64),
                                   (1, 4, 4, 1023, 1023, 64),
                                   (1, 2, 2, 100, 200, 128)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_dual_forward_equals_k1(shape, causal, dtype):
    """K12 (an even number of kv tiles, the ragged 1023 included) gives K1's
    o and lse bit for bit; with an odd number the flag launches K1."""
    from np_modeling_tpu_torch.ops import attention
    q, k, v, _ = _flash_inputs(*shape, dtype)
    scale = shape[-1] ** -0.5
    single = attention._flash_fwd_cuda(q, k, v, causal, scale, True)
    dual = attention._flash_fwd_cuda(q, k, v, causal, scale, True, dual=True)
    torch.cuda.synchronize()
    assert torch.equal(single[0], dual[0]) and torch.equal(single[1], dual[1])
    before = (ops.flash_attention.launches_fwd,
              ops.flash_attention.launches_fwd_dual)
    with _schedule(dual=True), torch.no_grad():
        ops.flash_attention(q, k, v, causal=causal)
        one_tile = k[:, :, :64]
        ops.flash_attention(q, one_tile, one_tile, causal=causal)
    assert (ops.flash_attention.launches_fwd - before[0],
            ops.flash_attention.launches_fwd_dual - before[1]) == (1, 1)


# ---- one GPT train step -----------------------------------------------------------

def _grads(gpt, tokens, plain):
    gpt.zero_grad(set_to_none=True)
    if plain:
        with dispatch.force_plain():
            loss = gpt.loss(tokens)
            loss.backward()
    else:
        loss = gpt.loss(tokens)
        loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in gpt.named_parameters()}


def _gpt(dtype, activation):
    cfg = models.GPTConfig(vocab_size=256, d_model=256, num_heads=2,
                           num_layers=2, hidden_units=512, max_len=256,
                           dtype=dtype, fused_loss=True, activation=activation)
    return models.GPT(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


def test_cuda_gpt_step_fp32_kernels_vs_plain():
    """fp32, gelu (smooth: relu's kink turns last-bit differences into
    gradient-mask flips): loss to 1e-5, each gradient to 1e-4 relative L2
    (the key bias, whose exact gradient is 0, by its size)."""
    gpt = _gpt(None, "gelu")
    tokens = torch.randint(0, 256, (2, 256), device="cuda")
    lk, gk = _grads(gpt, tokens, plain=False)
    lp, gp = _grads(gpt, tokens, plain=True)
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for n in gp:
        if n.endswith("bk"):
            assert gk[n].norm() <= 1e-4 * gp[n[:-2] + "wk"].norm(), n
        else:
            assert _rel(gk[n], gp[n]) <= 1e-4, n


def test_cuda_gpt_step_bf16_no_worse_than_plain():
    """bf16, gelu as in the fp32 test (relu's kink turns last-bit
    differences into gradient-mask flips, and the ratio below then changed
    from process to process): loss to 5e-3; against the fp32 step's
    gradients (same weights) each kernel-path gradient is no further than
    1.25x the plain bf16 step's, or 2e-2. Seeded tokens."""
    gpt = _gpt(torch.bfloat16, "gelu")
    ref_gpt = _gpt(None, "gelu")
    ref_gpt.load_state_dict(gpt.state_dict())
    tokens = torch.randint(0, 256, (2, 256), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    _, ref = _grads(ref_gpt, tokens, plain=True)
    lk, gk = _grads(gpt, tokens, plain=False)
    lp, gp = _grads(gpt, tokens, plain=True)
    assert abs(lk - lp) <= 5e-3 * abs(lp)
    for n in ref:
        if not n.endswith("bk"):
            assert _rel(gk[n], ref[n]) <= max(2e-2, 1.25 * _rel(gp[n], ref[n])), n


# ---- LayerNorm (K8) and dropout (K7) ----------------------------------------------

def _ln_case(rows, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, d, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(d, generator=g, device="cuda")
    beta = 0.1 * torch.randn(d, generator=g, device="cuda")
    dz = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    return x, gamma, beta, dz


def _ln_run(x, gamma, beta, dz, plain):
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    with dispatch.force_plain() if plain else contextlib.nullcontext():
        out = ops.layer_norm(*leaves, 1e-5)
        out.backward(dz)
    return [out.detach()] + [t.grad for t in leaves]


def _bf16_ulp(t):
    a = t.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.parametrize("rows,d", [(7, 64), (33, 768), (5, 1000), (9, 1001),
                                    (300, 1024), (4, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_layer_norm_kernels_vs_plain(rows, d, dtype):
    case = _ln_case(rows, d, dtype)
    got = _ln_run(*case, plain=False)
    want = _ln_run(*case, plain=True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        diff = (a.float() - b.float()).abs()
        bound = 1e-5 * max(1.0, b.float().abs().max().item())
        if a.dtype == torch.bfloat16:
            assert bool((diff <= torch.clamp(torch.maximum(
                _bf16_ulp(a), _bf16_ulp(b)), min=bound)).all())
        else:
            assert diff.max().item() <= bound


@pytest.mark.parametrize("d", [64, 768, 1000, 1001, 1024, 1025, 8192])
@pytest.mark.parametrize("rows", [1, 7, 33, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_layer_norm_backward_vs_plain_and_repeatable(rows, d, dtype):
    """K8's backward (a warp a row to d 1024, the row team past it; 1 and 7
    rows leave warps of the one block without a row) against the plain
    backward within test_cuda_layer_norm_kernels_vs_plain's bounds; dx,
    dgamma and dbeta equal bit for bit on a second run."""
    x, gamma, _, dz = _ln_case(rows, d, dtype, seed=rows + d)
    got = fused.layer_norm_bwd_cuda(x, gamma, dz, 1e-5)
    again = fused.layer_norm_bwd_cuda(x, gamma, dz, 1e-5)
    want = fused.layer_norm_bwd_plain(x, gamma, dz, 1e-5)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, c)
        diff = (a.float() - b.float()).abs()
        bound = 1e-5 * max(1.0, b.float().abs().max().item())
        if a.dtype == torch.bfloat16:
            assert bool((diff <= torch.clamp(torch.maximum(
                _bf16_ulp(a), _bf16_ulp(b)), min=bound)).all())
        else:
            assert diff.max().item() <= bound


def test_cuda_layer_norm_counts_launches_and_refuses_wide_rows():
    x, gamma, beta, dz = _ln_case(16, 256, torch.bfloat16)
    x.requires_grad_()
    before = (ops.layer_norm.launches_fwd, ops.layer_norm.launches_bwd)
    ops.layer_norm(x, gamma, beta).backward(dz)
    assert (ops.layer_norm.launches_fwd,
            ops.layer_norm.launches_bwd) == (before[0] + 1, before[1] + 1)
    wide = torch.zeros(2, 8193, device="cuda")
    with pytest.raises(ValueError):
        ops.layer_norm(wide, torch.ones(8193, device="cuda"),
                       torch.zeros(8193, device="cuda"))


@pytest.mark.parametrize("shape,strided", [((8, 64, 96), False),
                                           ((8, 64, 96), True),
                                           ((3, 1001), False), ((7,), False)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dropout_kernel_vs_plain_twin(shape, strided, rate, dtype):
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(*shape, generator=g, device="cuda").to(dtype)
    if strided:
        x = x.transpose(0, -1)
    seed = 0x5DEECE66D
    leaf = x.clone().requires_grad_()
    before = ops.dropout.launches
    got = ops.dropout(leaf, seed, rate)
    got.backward(torch.ones_like(got))
    assert ops.dropout.launches == before + 2
    with dispatch.force_plain():
        want = ops.dropout(x, seed, rate)
    mask = fused.philox_keep_mask(seed, x.shape, rate, x.device)
    kernel_mask = fused.dropout_cuda(torch.ones_like(x), seed, rate) != 0
    torch.cuda.synchronize()
    assert torch.equal(kernel_mask, mask)
    assert torch.equal(got.detach(), want)
    assert torch.equal(leaf.grad != 0, mask)


def test_cuda_dropout_identity_launches_nothing():
    x = torch.randn(64, device="cuda")
    before = ops.dropout.launches
    assert ops.dropout(x, 1, 0.0) is x
    assert ops.dropout(x, 1, 0.5, training=False) is x
    assert ops.dropout.launches == before


def test_cuda_gpt_dropout_step_fp32_kernels_vs_plain():
    """fp32 with dropout 0.1: one integer seed gives both paths the same
    masks, so loss and gradients agree as without dropout."""
    cfg = models.GPTConfig(vocab_size=256, d_model=256, num_heads=4,
                           num_layers=2, hidden_units=512, max_len=256,
                           activation="gelu", drop_rate=0.1)
    gpt = models.GPT(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, 256, (2, 256), device="cuda")
    results = []
    for plain in (False, True):
        gpt.zero_grad(set_to_none=True)
        with dispatch.force_plain() if plain else contextlib.nullcontext():
            loss = gpt.loss(tokens, training=True, rngs={"dropout": 42})
            loss.backward()
        results.append((loss.item(), {n: p.grad.clone()
                                      for n, p in gpt.named_parameters()}))
    (lk, gk), (lp, gp) = results
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for n in gp:
        if n.endswith("bk"):
            assert gk[n].norm() <= 1e-4 * gp[n[:-2] + "wk"].norm(), n
        else:
            assert _rel(gk[n], gp[n]) <= 1e-4, n


# ---- int8-weight matmul (K4) and int8 pages (K3/K6) --------------------------------

def _int8_mm_case(m, k, n, x_dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(k, n, generator=g, device="cuda")
    q = ops.quantize_params_int8({"dense2": {"w": w}})["dense2"]["w"]
    x = torch.randn(m, k, generator=g, device="cuda").to(x_dtype)
    bias = torch.randn(n, generator=g, device="cuda")
    return x, q["int8"], q["scale"], bias


@pytest.mark.parametrize("m,k,n", [(8, 768, 3072), (8, 3072, 768),
                                   (300, 768, 3072), (5, 96, 200),
                                   (1, 64, 640), (33, 384, 128), (7, 100, 30)])
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("bias", [False, True])
def test_cuda_int8_matmul_vs_plain(m, k, n, x_dtype, out_dtype, bias):
    """fp32 out within 1e-4 x max(1, max |plain|); bf16 out within one bf16
    ulp of either value (or that fp32 bound near 0)."""
    x, wq, scale, b = _int8_mm_case(m, k, n, x_dtype)
    b = b if bias else None
    before = ops.int8_matmul.launches
    got = ops.int8_matmul(x, wq, scale, b, out_dtype=out_dtype)
    assert ops.int8_matmul.launches == before + 1
    with dispatch.force_plain():
        want = ops.int8_matmul(x, wq, scale, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == out_dtype
    diff = (got.float() - want.float()).abs()
    bound = 1e-4 * max(1.0, want.float().abs().max().item())
    if out_dtype == torch.bfloat16:
        assert bool((diff <= torch.clamp(torch.maximum(
            _bf16_ulp(got), _bf16_ulp(want)), min=bound)).all())
    else:
        assert diff.max().item() <= bound


def _int8_mm_within(got, want, out_dtype):
    """test_cuda_int8_matmul_vs_plain's bounds."""
    diff = (got.float() - want.float()).abs()
    bound = 1e-4 * max(1.0, want.float().abs().max().item())
    if out_dtype == torch.bfloat16:
        return bool((diff <= torch.clamp(torch.maximum(
            _bf16_ulp(got), _bf16_ulp(want)), min=bound)).all())
    return diff.max().item() <= bound


# (k, n) of the schedule tests: GPT-2 small's two FFN products, ragged ones
# (k not a multiple of 64 or of 8, n not of 16 or of a tile, n below a tile).
_K4_KN = [(768, 3072), (3072, 768), (100, 30), (96, 200), (200, 96),
          (4104, 144)]


def _k4_cases():
    """(schedule, m, k, n, forced (n tile, splits asked for) or None for
    plan's own): skinny at every m it takes and forced tiles and splits
    whose k ranges fit its shared memory; wide where TMA reads x and the
    weight (k a multiple of 8, n of 16), also with split-k (3 splits: the
    last one empty where k < 129); simple everywhere."""
    quant = importlib.import_module("np_modeling_tpu_torch.ops.quantization")
    cases = []
    for k, n in _K4_KN:
        for m in (1, 8, 9, 63, 64):
            for f in (None, (32, 16), (64, 8), (128, 2)):
                if f is None or quant.skinny_split(k, f[1])[0] \
                        <= quant.SKINNY_MAX_ROWS:
                    cases.append(("skinny", m, k, n, f))
        if k % 8 == 0 and n % 16 == 0:
            cases += [("wide", m, k, n, None) for m in (65, 300, 1792)]
            cases.append(("wide", 65, k, n, (128, 3)))
        cases += [("simple", m, k, n, None) for m in (1, 65, 300)]
    return cases


_K4_CASES = _k4_cases()


@pytest.mark.parametrize(
    "schedule,m,k,n,forced", _K4_CASES,
    ids=[f"{s}-m{m}-k{k}-n{n}" + (f"-{f[0]}x{f[1]}" if f else "")
         for s, m, k, n, f in _K4_CASES])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias", [False, True])
def test_cuda_int8_matmul_schedules_vs_plain(schedule, m, k, n, forced,
                                             out_dtype, bias, monkeypatch):
    """K4's skinny, wide and simple schedules, each forced through a
    monkeypatched plan (skinny also at forced n tiles and splits, up to the
    cluster's 16; wide also with split-k), against the plain version within
    test_cuda_int8_matmul_vs_plain's bounds; the same bits on a second
    run; the launch counted under its schedule and its (schedule, k, n)."""
    quant = importlib.import_module("np_modeling_tpu_torch.ops.quantization")
    sms = fused.sm_count("cuda")
    if schedule == "skinny":
        tile, asked = forced or quant.plan(m, n, k, sms)[1:3]
        splits = quant.skinny_split(k, asked)[1]
        forced_plan = quant.Plan("skinny", tile, splits, splits)
    elif schedule == "wide":
        splits = forced[1] if forced else quant.plan(m, n, k, sms).splits
        forced_plan = quant.Plan("wide", 128, splits, 1)
    else:
        forced_plan = quant.Plan("simple", 64, 1, 1)
    monkeypatch.setattr(quant, "_cached_plan", lambda *a: forced_plan)
    x, wq, scale, b = _int8_mm_case(m, k, n, torch.bfloat16, seed=m + k)
    b = b if bias else None
    name, by_shape = f"launches_{schedule}", ops.int8_matmul.launches_by_shape
    before = (ops.int8_matmul.launches, getattr(ops.int8_matmul, name),
              by_shape.get((schedule, k, n), 0))
    got = ops.int8_matmul(x, wq, scale, b, out_dtype=out_dtype)
    again = ops.int8_matmul(x, wq, scale, b, out_dtype=out_dtype)
    assert (ops.int8_matmul.launches - before[0],
            getattr(ops.int8_matmul, name) - before[1],
            by_shape[schedule, k, n] - before[2]) == (2, 2, 2)
    with dispatch.force_plain():
        want = ops.int8_matmul(x, wq, scale, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert _int8_mm_within(got, want, out_dtype)
    assert torch.equal(got, again)


def test_cuda_int8_matmul_plans_the_serving_shapes():
    """The wrapper's own plan: GPT-2 small's FFN products take skinny at
    decode (8 rows) and wide at prefill (1792 rows); fp32 x takes simple."""
    counts = ("launches_skinny", "launches_wide", "launches_simple")
    for m, x_dtype, want in ((8, torch.bfloat16, "launches_skinny"),
                             (1792, torch.bfloat16, "launches_wide"),
                             (8, torch.float32, "launches_simple")):
        for k, n in ((768, 3072), (3072, 768)):
            x, wq, scale, b = _int8_mm_case(m, k, n, x_dtype)
            before = {c: getattr(ops.int8_matmul, c) for c in counts}
            ops.int8_matmul(x, wq, scale, b)
            assert {c: getattr(ops.int8_matmul, c) - before[c]
                    for c in counts} == {c: int(c == want) for c in counts}


@pytest.mark.parametrize("sq,hq,hkv,d,psize", [
    (None, 12, 12, 64, 16), (5, 12, 12, 64, 64), (256, 12, 12, 64, 16),
    (None, 8, 2, 128, 64), (5, 8, 2, 128, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_pages_vs_plain(sq, hq, hkv, d, psize, dtype):
    rows = sq or 1
    pps = max(8, -(-(rows + 64) // psize))
    q, k, v, lengths, table = _paged_case(4, sq, hq, hkv, d, psize, pps,
                                          4 * pps + 2)
    lengths[:2] = [rows, psize * -(-rows // psize)]
    q, k, v, lengths, table = (torch.tensor(a).cuda()
                               for a in (q, k, v, lengths, table))
    kq, vq = ops.quantize_int8(k), ops.quantize_int8(v)
    args = (q.to(dtype), kq.values, vq.values, lengths, table)
    scales = dict(k_scales=kq.scales, v_scales=vq.scales)
    before = ops.paged_attention.launches_int8
    got = ops.paged_attention(*args, **scales)
    assert ops.paged_attention.launches_int8 == before + 1
    with dispatch.force_plain():
        want = ops.paged_attention(*args, **scales)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype)


def test_cuda_quantized_engine_vs_plain_engine():
    """fp32 compute, int8 FFN weights and int8 pages: the kernels' greedy
    tokens equal the plain engine's."""
    from np_modeling_tpu_torch.serving import GenerationEngine
    from np_modeling_tpu_torch.utils import params_from_numpy, params_to_numpy
    cfg = models.GPTConfig(vocab_size=256, d_model=128, num_heads=2,
                           num_layers=2, hidden_units=512, max_len=256,
                           activation="gelu", ln_eps=1e-5)
    gpt = models.GPT(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    tree = ops.quantize_params_int8(params_to_numpy(gpt),
                                    match=r".*(dense1/linear/w|dense2/w)$")
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, 256, n) for i, n in enumerate((40, 90, 7))}
    streams = []
    for plain in (False, True):
        eng = GenerationEngine(params_from_numpy(tree, cfg, device="cuda"),
                               total_pages=64, page_size=16, max_seqs=4,
                               prefill_chunk_size=64, quantize_kv=True)
        with dispatch.force_plain() if plain else contextlib.nullcontext():
            before = (ops.int8_matmul.launches,
                      ops.paged_attention.launches_int8)
            first = eng.add_requests(prompts)
            streams.append((first, eng.step_many(8), eng.step()))
            launched = (ops.int8_matmul.launches - before[0],
                        ops.paged_attention.launches_int8 - before[1])
        # 2 chunk calls + 9 decode steps, 2 layers: 4 and 2 launches each.
        assert launched == ((0, 0) if plain else (44, 22))
    assert streams[0] == streams[1]


# ---- matmul (K11), softmax-CE (K9), stochastic int8 (K10) -----------------------

def _within(got, want, f32_tol):
    diff = (got.float() - want.float()).abs()
    bound = f32_tol * max(1.0, want.float().abs().max().item())
    if got.dtype == torch.bfloat16:
        return bool((diff <= torch.clamp(torch.maximum(
            _bf16_ulp(got), _bf16_ulp(want)), min=bound)).all())
    return diff.max().item() <= bound


@pytest.mark.parametrize("m,k,n", [(256, 768, 384), (100, 70, 50),
                                   (1, 64, 640), (129, 257, 255), (5, 0, 3)])
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False),
                                             (False, True), (True, True)])
@pytest.mark.parametrize("op_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("bias", [False, True])
def test_cuda_matmul_kernel_vs_plain(m, k, n, trans_a, trans_b, op_dtype,
                                     out_dtype, bias):
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(*((k, m) if trans_a else (m, k)), generator=g,
                    device="cuda").to(op_dtype)
    b = torch.randn(*((n, k) if trans_b else (k, n)), generator=g,
                    device="cuda").to(op_dtype)
    c = torch.randn(n, generator=g, device="cuda") if bias else None
    kw = dict(trans_a=trans_a, trans_b=trans_b, out_dtype=out_dtype)
    before = ops.matmul.launches
    with dispatch.force_kernels():
        got = ops.matmul(a, b, c, **kw)
    assert ops.matmul.launches == before + 1
    want = ops.matmul_reference(a, b, c, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == out_dtype and got.shape == (m, n)
    assert _within(got, want, 1e-4)


@pytest.mark.parametrize("m,k,n,trans_a,trans_b,variant,splits", [
    (256, 768, 384, False, False, "tma", 1),
    (256, 768, 384, True, True, "tma", 1),
    (768, 8192, 768, True, False, "tma", 3),
    (136, 16384, 200, False, True, "tma", 16),
    (100, 70, 50, False, False, "ragged", 1),
    (129, 257, 255, True, False, "ragged", 1),
    (9, 4099, 7, True, True, "ragged", 4)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias", [False, True])
def test_cuda_matmul_variants_and_split_k(m, k, n, trans_a, trans_b, variant,
                                          splits, out_dtype, bias):
    """K11's TMA and ragged variants and split-k against the plain version:
    plan() picks the variant and the splits; matmul.launches counts every
    launch and launches_ragged the ragged variant's; split-k gives the same
    bits on every run (a fixed order of the splits' sums)."""
    import importlib
    mm = importlib.import_module("np_modeling_tpu_torch.ops.matmul")
    assert mm.plan(m, k, n, trans_a, trans_b) == (variant, splits)
    g = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn(*((k, m) if trans_a else (m, k)), generator=g,
                    device="cuda").bfloat16()
    b = torch.randn(*((n, k) if trans_b else (k, n)), generator=g,
                    device="cuda").bfloat16()
    c = torch.randn(n, generator=g, device="cuda") if bias else None
    kw = dict(trans_a=trans_a, trans_b=trans_b, out_dtype=out_dtype)
    before = (ops.matmul.launches, ops.matmul.launches_ragged)
    with dispatch.force_kernels():
        got = ops.matmul(a, b, c, **kw)
        again = ops.matmul(a, b, c, **kw)
    assert (ops.matmul.launches - before[0],
            ops.matmul.launches_ragged - before[1]) == (
        2, 2 if variant == "ragged" else 0)
    want = ops.matmul_reference(a, b, c, **kw)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert _within(got, want, 1e-4)
    assert torch.equal(got, again)


def test_cuda_matmul_default_is_the_library_and_float16_raises():
    a = torch.randn(64, 32, device="cuda")
    before = ops.matmul.launches
    ops.matmul(a, a.t().contiguous())
    with dispatch.force_kernels(), dispatch.force_plain():
        ops.matmul(a, a, trans_b=True)
    assert ops.matmul.launches == before
    with pytest.raises(ValueError), dispatch.force_kernels():
        ops.matmul(a.half(), a.half(), trans_b=True)


@pytest.mark.parametrize("shape", [(64, 50257), (37, 1001), (2, 7, 300),
                                   (3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_softmax_cross_entropy_kernels_vs_plain(shape, dtype):
    g = torch.Generator(device="cuda").manual_seed(1)
    logits = (3 * torch.randn(*shape, generator=g, device="cuda")).to(dtype)
    labels = torch.randint(0, shape[-1], shape[:-1], generator=g,
                           device="cuda")
    labels.view(-1)[0] = shape[-1]                  # outside [0, v)
    cot = torch.randn(*shape[:-1], generator=g, device="cuda")
    results = []
    for plain in (False, True):
        leaf = logits.clone().requires_grad_()
        with dispatch.force_plain() if plain else contextlib.nullcontext():
            before = (ops.softmax_cross_entropy_fused.launches_fwd,
                      ops.softmax_cross_entropy_fused.launches_bwd)
            ce = ops.softmax_cross_entropy_fused(leaf, labels)
            ce.backward(cot)
            launched = (ops.softmax_cross_entropy_fused.launches_fwd
                        - before[0],
                        ops.softmax_cross_entropy_fused.launches_bwd
                        - before[1])
        assert launched == ((0, 0) if plain else (1, 1))
        results.append((ce.detach(), leaf.grad))
    torch.cuda.synchronize()
    (ce_k, dl_k), (ce_p, dl_p) = results
    assert ce_k.dtype == torch.float32 and dl_k.dtype == dtype
    assert (ce_k - ce_p).abs().max().item() <= 1e-5 * max(
        1.0, ce_p.abs().max().item())
    diff = (dl_k.float() - dl_p.float()).abs()
    bound = 1e-4 * dl_p.float().abs() + 1e-6 * dl_p.float().abs().max()
    if dtype == torch.bfloat16:
        bound = torch.maximum(bound, torch.maximum(_bf16_ulp(dl_k),
                                                   _bf16_ulp(dl_p)))
    assert bool((diff <= bound).all())


@pytest.mark.parametrize("shape", [(300, 768), (64, 12, 64), (5, 1001),
                                   (3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quantize_stochastic_kernel_equals_plain_twin(shape, dtype):
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(*shape, generator=g, device="cuda").to(dtype)
    x.view(-1, shape[-1])[0] = 0.0                   # a zero row
    before = ops.quantize_int8_stochastic.launches
    got = ops.quantize_int8_stochastic(x, 0x0123456789ABCDEF)
    assert ops.quantize_int8_stochastic.launches == before + 1
    with dispatch.force_plain():
        want = ops.quantize_int8_stochastic(x, 0x0123456789ABCDEF)
    torch.cuda.synchronize()
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.scales, want.scales)
    assert got.scales.shape == (*shape[:-1], 1)


def test_cuda_gpt_step_forced_vs_default():
    """fp32, gelu: every Linear through K11 (12 a pass for 2 layers, 36 a
    step) against the default library products: loss to 1e-5, each
    gradient to 1e-4 relative L2 (the key bias by its size)."""
    gpt = _gpt(None, "gelu")
    tokens = torch.randint(0, 256, (2, 256), device="cuda")
    results = []
    for forced in (True, False):
        gpt.zero_grad(set_to_none=True)
        before = ops.matmul.launches
        with dispatch.force_kernels() if forced else contextlib.nullcontext():
            loss = gpt.loss(tokens)
            fwd = ops.matmul.launches - before
            loss.backward()
        assert (fwd, ops.matmul.launches - before) == (
            (12, 36) if forced else (0, 0))
        results.append((loss.item(), {n: p.grad.clone()
                                      for n, p in gpt.named_parameters()}))
    (lk, gk), (lp, gp) = results
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for n in gp:
        if n.endswith("bk"):
            assert gk[n].norm() <= 1e-4 * gp[n[:-2] + "wk"].norm(), n
        else:
            assert _rel(gk[n], gp[n]) <= 1e-4, n
