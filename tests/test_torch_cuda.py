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

from chip_smoke import (BIAS_CASES, BIAS_DECODE_CASES, LATENT_CASES,
                        LATENT_PAGES, MASK_CASES, MLA_FLASH_CASES,
                        PAGED_BIAS_CASES, PAGED_BIAS_PAGES, _bias_fwd_bwd,
                        _generate_with_logits, _hold_fp32, _k10_schedule,
                        _schedule, _step0, flash_bias_case,
                        flash_bias_decode_case, flash_mask_case, k10_planned,
                        k10_run, latent_vs_plain, mla_flash_case,
                        paged_latent_case, paged_bias_case)
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
    """The bias is built alone: with a window or a softcap it raises, as
    sinks do (ROADMAP Queue 2 A)."""
    q, k, v, lengths, table = (torch.tensor(a).cuda() for a in _paged_case(
        2, None, 4, 2, 64, 16, 4, 10))
    bias = torch.zeros(2, 4, 64, device="cuda")
    cases = {"bias": [dict(bias=bias, window=8), dict(bias=bias, softcap=5.0)],
             "sinks": [dict(sinks=torch.zeros(4, device="cuda"))]}[option]
    for kw in cases:
        with pytest.raises(NotImplementedError, match=f"{option}.*Queue 2 A"):
            ops.paged_attention(q, k, v, lengths, table, **kw)


@pytest.mark.parametrize("pages", PAGED_BIAS_PAGES)
@pytest.mark.parametrize("case", PAGED_BIAS_CASES)
def test_cuda_paged_bias_vs_plain(case, pages):
    """K3's bias option over chip_smoke (c)'s cases: the plain version's
    output within its tolerance, table entries past the length unread,
    length-0 rows 0, one bias launch counted a call."""
    rng = np.random.default_rng(8 * PAGED_BIAS_CASES.index(case)
                                + PAGED_BIAS_PAGES.index(pages))
    q, k, v, lens, table, kw, lengths, dtype = paged_bias_case(case, pages,
                                                               rng)
    before = ops.paged_attention.launches_bias
    got = ops.paged_attention(q, k, v, lens, table, scale=1.0, **kw)
    assert ops.paged_attention.launches_bias == before + 1
    with dispatch.force_plain():
        want = ops.paged_attention(q, k, v, lens, table, scale=1.0, **kw)
    poisoned = table.clone()
    for i, ln in enumerate(lengths):
        poisoned[i, -(-ln // 16):] = 2 ** 30
    again = ops.paged_attention(q, k, v, lens, poisoned, scale=1.0, **kw)
    torch.cuda.synchronize()
    live = lens > 0
    assert (got[live].float() - want[live].float()).abs().max().item() \
        <= _tol(dtype)
    assert torch.equal(got, again)
    assert bool((got[~live] == 0).all())


def test_cuda_seq2seq_engine_vs_plain_engine():
    """A small T5 (d_kv 64, the kernel's head dim), fp32, relpos tables N(0,
    1): the Seq2SeqEngine's greedy tokens through K3's bias equal the plain
    engine's under joins and a leave, K3 launching with the bias once a
    decoder layer a step."""
    from np_modeling_tpu_torch.serving import Seq2SeqEngine
    cfg = models.T5Config(vocab_size=256, d_model=128, d_kv=64, num_heads=4,
                          num_encoder_layers=2, num_decoder_layers=2,
                          d_ff=256, relpos_buckets=8, relpos_max_distance=20)
    t5 = models.T5(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        t5.dec_relpos.mul_(50.0)
        t5.enc_relpos.mul_(50.0)
    rng = np.random.default_rng(0)
    sources = [rng.integers(1, 256, n) for n in (40, 7, 64, 21)]
    streams = []
    for plain in (False, True):
        eng = Seq2SeqEngine(t5, max_src_len=64, max_tgt_len=48,
                            total_pages=16, page_size=16, max_seqs=4)
        with dispatch.force_plain() if plain else contextlib.nullcontext():
            before = ops.paged_attention.launches_bias
            eng.add_request(0, sources[0])
            eng.add_request(1, sources[1])
            out = [eng.step() for _ in range(3)]
            eng.add_request(2, sources[2])
            eng.add_request(3, sources[3])
            out.append(eng.step_many(20))
            eng.finish(1)
            out.append(eng.step_many(10))
            launched = ops.paged_attention.launches_bias - before
        streams.append(out)
        assert launched == (0 if plain else 2 * 33)
    assert streams[0] == streams[1]


@pytest.mark.parametrize("pages", LATENT_PAGES)
@pytest.mark.parametrize("case", LATENT_CASES, ids=[c[0] for c in LATENT_CASES])
def test_cuda_paged_latent_vs_plain(case, pages):
    """K3's latent option (d 576, one page array as k and v) over chip_smoke
    (B)'s cases: g 16 and 128, decode and chunk rows, the planned split and
    forced ones, fp32, bf16 and int8 pages (one scale set) with fp32 and bf16
    q; within the paged tolerances of the plain version, a length-0 row 0,
    table entries past the length unread, one latent launch a call."""
    err, tol, _, _ = latent_vs_plain(case, pages, seed=len(case[4]))
    assert err <= tol


def test_cuda_latent_and_mla_refusals():
    """d 576 with distinct k and v arrays raises ValueError; a window, a
    softcap or a bias there NotImplementedError. An MLA model at head dims
    the kernels are not built for (qk 12, latent 20) raises ValueError on
    the card, naming the head dims that are built: its dense forward those
    of the flash kernels, its generate those of the paged kernel; the flash
    kernels at d 192 (MLA's) raise NotImplementedError on a window, a
    softcap, a mask or a bias, which no MLA caller passes."""
    q, rows, lens, table, _, _ = paged_latent_case(2, None, 16, [5, 9],
                                                   "float32", 0, pps=2)
    with pytest.raises(ValueError, match="one page array"):
        ops.paged_attention(q, rows, rows.clone(), lens, table)
    for kw in (dict(window=4), dict(softcap=5.0),
               dict(bias=torch.zeros(2, 16, 32, device="cuda"))):
        with pytest.raises(NotImplementedError, match="latent"):
            ops.paged_attention(q, rows, rows, lens, table, **kw)
    cfg = models.GPTConfig(vocab_size=64, d_model=32, num_heads=4,
                           num_layers=1, hidden_units=48, max_len=32,
                           positional="rope", norm="rms", ffn="swiglu",
                           use_bias=False, tie_embeddings=False,
                           mla=dict(kv_lora_rank=16, q_lora_rank=None,
                                    qk_nope_head_dim=8, qk_rope_head_dim=4,
                                    v_head_dim=8))
    gpt = models.GPT(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.zeros(1, 4, dtype=torch.long, device="cuda")
    with pytest.raises(ValueError, match="head_dim 12: the kernels take 64, "
                                         "128, 192 or 256"):
        gpt.apply(toks)
    with pytest.raises(ValueError, match="head_dim 20 .*64, 128, 256, or "
                                         "576"):
        gpt.generate(toks, 2)
    with dispatch.force_plain():
        assert gpt.generate(toks, 2).shape == (1, 2)
    q, k, v, _ = _flash_inputs(1, 2, 2, 64, 64, 192, torch.bfloat16)
    for kw in (dict(window=8), dict(softcap=5.0),
               dict(mask=torch.ones(1, 1, 64, 64, dtype=torch.bool,
                                    device="cuda")),
               dict(bias=torch.zeros(1, 2, 64, 64, device="cuda"))):
        with pytest.raises(NotImplementedError, match="head_dim 192"):
            ops.flash_attention(q, k, v, causal=True, **kw)


# ---- MLA's training path: the flash kernels at d 192 ---------------------------

@pytest.mark.parametrize("segments", [False, True], ids=["plain", "segments"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLA_FLASH_CASES,
                         ids=[c[0] for c in MLA_FLASH_CASES])
def test_cuda_flash_d192_vs_plain(case, dtype, causal, segments):
    """K1 + K2 and K1 + K5 at MLA's head dim 192 over chip_smoke (C)'s
    shapes (ragged, GQA, sq != skv both ways, the slice's b1 h16 s4096):
    o, lse, dq, dk, dv within the flash tolerances of the plain version; K12
    where JAX's condition holds, its o and lse equal to K1's bit for bit
    (``mla_flash_case``). Segment ids where sq == skv."""
    label, shape = case
    if segments and shape[3] != shape[4]:
        pytest.skip("segment ids are self-attention's (sq == skv)")
    # Raises where a value lies outside its bound or K12 differs from K1.
    mla_flash_case(shape, dtype, causal, segments, seed=len(label) + causal)


# The real head dims (qk 192, latent 576) at a narrow width: 16 heads, rank
# 512, nope 128, rope 64, v 128, YaRN, an untied head, fp32.
MLA_SMALL = dict(vocab_size=512, d_model=256, num_heads=16, num_layers=2,
                 hidden_units=384, max_len=512, positional="rope", norm="rms",
                 ln_eps=1e-6, ffn="swiglu", use_bias=False,
                 tie_embeddings=False,
                 rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096.0, 1.0),
                 mla=dict(kv_lora_rank=512, q_lora_rank=None,
                          qk_nope_head_dim=128, qk_rope_head_dim=64,
                          v_head_dim=128))


@pytest.mark.parametrize("packed", [False, True], ids=["rows", "packed"])
@pytest.mark.parametrize("fused_bwd", [True, False], ids=["k1_k2", "k12_k5"])
def test_cuda_mla_gpt_loss_fp32_kernels_vs_plain(fused_bwd, packed):
    """GPT.loss of a 2-layer MLA GPT at the real head dims on 2 x 300 tokens
    (packed: segment ids and positions restarting in each document), fp32:
    through K1 + K2 (or K12 + K5; K1 with segment ids) against
    force_plain(), loss within 1e-5 relative and every gradient within 1e-4
    relative L2 (chip_smoke's _hold_fp32); the kernels launched once a
    layer each way."""
    gpt = models.GPT(models.GPTConfig(**MLA_SMALL)).init(
        torch.Generator(device="cuda").manual_seed(3))
    rng = np.random.default_rng(3)
    tokens = torch.tensor(rng.integers(0, 512, (2, 300)), device="cuda")
    kw = {}
    if packed:
        seg = np.repeat(np.arange(6), 50)[None].repeat(2, 0)
        pos = np.tile(np.arange(50), 6)[None].repeat(2, 0)
        kw = dict(segment_ids=torch.tensor(seg, device="cuda"),
                  positions=torch.tensor(pos, device="cuda"))
    lp, ref = _step0(gpt, tokens, 0, plain=True, **kw)
    fa = ops.flash_attention
    before = (fa.launches_fwd + fa.launches_fwd_dual,
              fa.launches_bwd + fa.launches_bwd_split)
    with _schedule(fused_bwd=fused_bwd, dual=not fused_bwd):
        lk, gk = _step0(gpt, tokens, 0, plain=False, **kw)
    _hold_fp32("MLA GPT", "kernels vs plain", lk, gk, lp, ref)
    assert (fa.launches_fwd + fa.launches_fwd_dual - before[0],
            fa.launches_bwd + fa.launches_bwd_split - before[1]) == (2, 2)


def test_cuda_mla_generate_fp32_equals_plain():
    """fp32 GPT.generate of the 2-layer MLA GPT (12 tokens after 13: a cache
    of 25 rows, padded to 32) through K3's latent option: the tokens equal
    plain generate's, each step's logits within 1e-4 x max(1, max |logit|);
    one latent launch a layer a step and no flash call. MLAttention's decode
    past the end of its cache (JAX clamps the write, not the mask) equals
    the plain version's."""
    gpt = models.GPT(models.GPTConfig(**MLA_SMALL)).init(
        torch.Generator(device="cuda").manual_seed(4))
    prompt = torch.tensor(np.random.default_rng(4).integers(0, 512, (2, 13)),
                          device="cuda")
    before = (ops.paged_attention.launches_latent,
              ops.flash_attention.launches_fwd)
    toks, logits = _generate_with_logits(gpt, prompt, 12)
    assert (ops.paged_attention.launches_latent - before[0],
            ops.flash_attention.launches_fwd - before[1]) == (2 * 12, 0)
    with dispatch.force_plain():
        ptoks, plogits = _generate_with_logits(gpt, prompt, 12)
    assert torch.equal(toks, ptoks)
    scale = max(1.0, plogits.abs().max().item())
    assert (logits - plogits).abs().max().item() <= 1e-4 * scale
    attn = gpt.layer_0.self_attention
    x = torch.randn(2, 9, 256, generator=torch.Generator(device="cuda")
                    .manual_seed(5), device="cuda")
    outs = []
    for plain in (False, True):
        cache = attn.init_cache(2, 7, 256)
        got = []
        with torch.no_grad(), (dispatch.force_plain() if plain
                               else contextlib.nullcontext()):
            for lo, hi in ((0, 4), (4, 8), (8, 9)):
                y, cache = attn(x[:, lo:hi], cache=cache, decode=True)
                got.append(y)
        outs.append(torch.cat(got, dim=1))
    scale = max(1.0, outs[1].abs().max().item())
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-4 * scale


def test_cuda_mla_engine_vs_plain_engine():
    """A small MLA GPT with d 576 latent rows (rank 512 + rope 64, 16 heads),
    YaRN and an untied head, fp32 and int8 latent pages: the engine's greedy
    tokens through K3's latent option equal the plain engine's under joins
    and a leave; 3 latent launches a forward (one a layer)."""
    from np_modeling_tpu_torch.serving import GenerationEngine
    cfg = models.GPTConfig(
        vocab_size=256, d_model=256, num_heads=16, num_layers=3,
        hidden_units=256, max_len=512, positional="rope", norm="rms",
        ln_eps=1e-6, ffn="swiglu", use_bias=False, tie_embeddings=False,
        rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096.0, 1.0),
        mla=dict(kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=32,
                 qk_rope_head_dim=64, v_head_dim=32))
    gpt = models.GPT(cfg).init(torch.Generator(device="cuda").manual_seed(1))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n) for n in (300, 7, 129, 40)]
    for quantize in (False, True):
        streams = []
        for plain in (False, True):
            eng = GenerationEngine(gpt, total_pages=160, page_size=16,
                                   max_seqs=4, prefill_chunk_size=64,
                                   quantize_kv=quantize)
            with dispatch.force_plain() if plain else contextlib.nullcontext():
                before = ops.paged_attention.launches_latent
                out = [eng.add_requests({0: prompts[0], 1: prompts[1]})]
                out += [eng.step() for _ in range(3)]
                out.append(eng.add_requests({2: prompts[2], 3: prompts[3]}))
                out.append(eng.step_many(12))
                eng.finish(1)
                out.append(eng.step_many(6))
                launched = ops.paged_attention.launches_latent - before
            streams.append(out)
            # chunks: 5 + 3 at admission; 21 decode steps; 3 layers each
            assert launched == (0 if plain else 3 * (5 + 3 + 21))
        assert streams[0] == streams[1]


@pytest.mark.parametrize("tokens", [8, 48], ids=["gathered", "loop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_moe_vs_cpu(dtype, tokens):
    """A DeepSeek-form MoE (64 experts of 64, top 6, raw softmax gates, 2
    shared experts, no-drop) on the card against the same module on the
    CPU: seven router columns tie exactly at the top of every token's
    scores, so both keep the six lowest; the chosen experts equal, the
    output within 1e-4 (fp32) or 2e-2 (bf16) x max |CPU's|. 8 tokens take
    the gathered products, 48 the loop over experts."""
    from np_modeling_tpu_torch.nn import MoE
    tie = [3, 9, 17, 20, 33, 40, 63]
    cpu = MoE(256, 64, 64, capacity_factor=None, router_top_k=6,
              router_weights="softmax", shared_experts_units=128,
              ffn="swiglu", device="cpu").init(
                  torch.Generator().manual_seed(2))
    with torch.no_grad():
        cpu.router[0, tie[0]] = 3.0
        cpu.router[:, tie] = cpu.router[:, tie[:1]]
    card = MoE(256, 64, 64, capacity_factor=None, router_top_k=6,
               router_weights="softmax", shared_experts_units=128,
               ffn="swiglu", device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.tensor(np.random.default_rng(tokens).standard_normal(
        (tokens, 256)), dtype=torch.float32)
    x[:, 0] = 3.0
    x = x.to(dtype)
    with torch.no_grad():
        want = cpu(x).float()
        got = card(x.cuda()).float().cpu()
        i_cpu = cpu._route(x)[1]
        i_card = card._route(x.cuda())[1].cpu()
    assert torch.equal(i_card, i_cpu)
    assert bool((i_cpu == torch.tensor(tie[:6])).all())
    assert ((got - want).abs().max() / want.abs().max()).item() <= _tol(dtype)


def test_cuda_mla_moe_engine_vs_plain_engine():
    """A small MLA GPT with MoE layers (the first dense, 16 experts, top 4,
    shared experts, no-drop), fp32 pages: the engine's greedy tokens
    through K3's latent option equal the plain engine's and the plain
    ``generate``'s; one latent launch a layer a forward."""
    from np_modeling_tpu_torch.serving import GenerationEngine
    cfg = models.GPTConfig(
        vocab_size=256, d_model=256, num_heads=16, num_layers=3,
        hidden_units=256, max_len=512, positional="rope", norm="rms",
        ln_eps=1e-6, ffn="swiglu", use_bias=False, tie_embeddings=False,
        rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096.0, 1.0),
        mla=dict(kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=32,
                 qk_rope_head_dim=64, v_head_dim=32),
        moe_experts=16, moe_top_k=4, moe_capacity_factor=None,
        moe_router_weights="softmax", moe_shared_units=128,
        moe_hidden_units=64, moe_first_dense=1)
    gpt = models.GPT(cfg).init(torch.Generator(device="cuda").manual_seed(3))
    with torch.no_grad():
        gpt.embedding.table.mul_(50.0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n) for n in (300, 7, 129)]
    streams = []
    for plain in (False, True):
        eng = GenerationEngine(gpt, total_pages=160, page_size=16,
                               max_seqs=4, prefill_chunk_size=64)
        with dispatch.force_plain() if plain else contextlib.nullcontext():
            before = ops.paged_attention.launches_latent
            first = eng.add_requests(dict(enumerate(prompts)))
            steps = eng.step_many(10)
            launched = ops.paged_attention.launches_latent - before
        streams.append({i: [first[i]] + steps[i] for i in first})
        # chunks: 5 at admission; 10 decode steps; 3 layers each
        assert launched == (0 if plain else 3 * (5 + 10))
    assert streams[0] == streams[1]
    with torch.no_grad(), dispatch.force_plain():
        for i, p in enumerate(prompts):
            gen = gpt.generate(torch.tensor(p, device="cuda")[None], 11)
            assert gen[0].tolist() == streams[0][i]


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
    """A mask where q needs a gradient (the kernels' backwards take no mask
    yet), and a bias with a window, with a softcap beside segment ids or at
    head_dim 128 (not instantiated), raise on the card."""
    q, k, v, _ = _flash_inputs(1, 2, 2, 64, 64, 64, torch.float32)
    if option == "mask":
        with pytest.raises(NotImplementedError, match="Queue 2 A"):
            ops.flash_attention(q.requires_grad_(), k, v, mask=torch.ones(
                1, 1, 64, 64, dtype=torch.bool, device="cuda"))
        return
    bias = torch.zeros(1, 2, 64, 64, device="cuda")
    with pytest.raises(NotImplementedError, match="Queue 2 A"):
        ops.flash_attention(q, k, v, bias=bias, causal=True, window=8)
    seg = torch.zeros(1, 64, dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="Queue 2 A"):
        ops.flash_attention(q, k, v, bias=bias, softcap=5.0, segment_ids=seg)
    q, k, v, _ = _flash_inputs(1, 2, 2, 64, 64, 128, torch.float32)
    with pytest.raises(NotImplementedError, match="Queue 2 A"):
        ops.flash_attention(q, k, v, bias=bias, softcap=5.0)


@pytest.mark.parametrize("case", BIAS_CASES,
                         ids=[c[0].replace(" ", "_") for c in BIAS_CASES])
@pytest.mark.parametrize("fused_bwd", [True, False], ids=["k2", "k5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_bias_vs_plain(dtype, fused_bwd, case):
    """K1 and K2 (or K5) with the score bias (chip_smoke's BIAS_CASES: [1,
    h], [b, h] and [b, 1] biases, causal and not, padded segment ids, ragged
    500 x 77, GQA at d 128 and 256, scale 0.125 with a softcap) against the
    plain path: o, dq, dk, dv and dbias within the flash tolerances; K5's
    grads bit-equal across two runs; one bias launch each way counted."""
    rng = np.random.default_rng(7)
    q, k, v, do, bias, kw = flash_bias_case(case, dtype, rng)
    fa = ops.flash_attention
    before = (fa.launches_fwd_bias, fa.launches_bwd_bias)
    with _schedule(fused_bwd=fused_bwd):
        got = _bias_fwd_bwd(q, k, v, do, bias, False, **kw)
        again = None if fused_bwd else _bias_fwd_bwd(q, k, v, do, bias,
                                                     False, **kw)
    runs = 1 if fused_bwd else 2
    assert (fa.launches_fwd_bias, fa.launches_bwd_bias) == (
        before[0] + runs, before[1] + runs)
    want = _bias_fwd_bwd(q, k, v, do, bias, True, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        bound = _tol(dtype) * max(1.0, y.float().abs().max().item())
        assert (x.float() - y.float()).abs().max().item() <= bound
    if again is not None:
        assert all(torch.equal(x, y) for x, y in zip(got[1:], again[1:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_mask_and_bias_decode_vs_plain(dtype):
    """K1 with the mask and the bias at sq = 1 (T5's decode step over a
    cache of which a prefix is written): o and lse against the plain
    path."""
    from np_modeling_tpu_torch.ops import attention
    rng = np.random.default_rng(8)
    q, k, v, mask, bias = flash_bias_decode_case(BIAS_DECODE_CASES[0], dtype,
                                                 rng)
    o, lse = attention._flash_fwd_cuda(q, k, v, False, 1.0, True, mask=mask,
                                       bias=bias)
    want = attention._attn_fwd_plain(q, k, v, mask, bias, False, None, 1.0)
    torch.cuda.synchronize()
    for x, y in ((o, want[0]), (lse, want[1])):
        bound = _tol(dtype) * max(1.0, y.float().abs().max().item())
        assert (x.float() - y.float()).abs().max().item() <= bound


@pytest.mark.parametrize("case", MASK_CASES,
                         ids=[c[0].replace(" ", "_") for c in MASK_CASES])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_mask_vs_plain(dtype, d, case):
    """K1's mask option (chip_smoke's MASK_CASES: sq 1 and 300, skv 1000 and
    333, GQA 8/4, per-row and broadcast masks, window and softcap, a row
    without a key) against ``_attn_fwd_plain``: o, and lse on rows with a
    key, within the flash tolerances; the keyless row's lse equal to the
    plain one and its o the mean of v over all keys; one launch counted."""
    from np_modeling_tpu_torch.ops import attention
    rng = np.random.default_rng(d)
    q, k, v, mask, kw, keyless = flash_mask_case(case, dtype, d, rng)
    before = ops.flash_attention.launches_fwd_mask
    with torch.no_grad():
        o = ops.flash_attention(q, k, v, mask=mask, **kw)
    o2, lse = attention._flash_fwd_cuda(
        q, k, v, kw["causal"], kw["scale"], True, window=kw["window"],
        softcap=kw["softcap"], mask=mask)
    assert ops.flash_attention.launches_fwd_mask == before + 2
    want = attention._attn_fwd_plain(q, k, v, mask, None, kw["causal"],
                                     kw["window"], kw["scale"],
                                     kw["softcap"])
    torch.cuda.synchronize()
    assert torch.equal(o, o2)
    rows = torch.zeros(lse.shape, dtype=torch.bool, device="cuda") \
        if keyless is None else keyless[:, None, :].expand(lse.shape)
    for x, y in ((o, want[0]), (lse[~rows], want[1][~rows])):
        bound = _tol(dtype) * max(1.0, y.float().abs().max().item())
        assert (x.float() - y.float()).abs().max().item() <= bound
    if keyless is not None:
        assert torch.equal(lse[rows], want[1][rows])
        g = q.shape[1] // k.shape[1]
        mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(g, 1)
        none = keyless[:, None, :, None].expand(o.shape)
        err = (o.float() - mean.expand(o.shape))[none].abs().max().item()
        assert err <= _tol(dtype) * max(1.0, mean.abs().max().item())


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
                                    *(seg or (None, None)), split=split,
                                    **kw)[:3]
    again = attention._flash_bwd_cuda(q, k, v, o, lse, do, causal, scale,
                                      *(seg or (None, None)), split=split,
                                      **kw)[:3]
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


def _k10_equal_to_plain(x, seed, schedule=None, **knobs):
    """K10 on ``x`` (under ``schedule`` with ``knobs`` where given) against
    its plain twin, bit for bit; returns the schedule that ran."""
    with (_k10_schedule(schedule, **knobs) if schedule
          else contextlib.nullcontext()):
        got, ran = k10_run(x, seed)
        assert ran == k10_planned(x)
    with dispatch.force_plain():
        want = ops.quantize_int8_stochastic(x, seed)
    torch.cuda.synchronize()
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.scales, want.scales)
    assert got.scales.shape == (*x.shape[:-1], 1)
    return ran


@pytest.mark.parametrize("schedule", [None, "rows", "block_row", "simple"])
@pytest.mark.parametrize("shape", [
    (300, 768), (64, 12, 64), (5, 1001), (3, 1), (37, 4), (37, 64),
    (37, 256), (37, 772), (37, 1024), (19, 2304), (9, 4096), (5, 16384),
    (37, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quantize_stochastic_kernel_equals_plain_twin(shape, dtype,
                                                           schedule):
    """As planned (None) and under each schedule forced, at each
    schedule's edges: two vectors a lane from 9 vectors a row (d 64 fp32,
    256), 32 elements a lane of a warp (d 1024),
    4-element bf16 vectors (772), block_row's longer rows, ragged d
    (simple); 37 rows, not a multiple of a block's rows; a zero row. A
    schedule that cannot take the shape is refused, and never planned."""
    quant = importlib.import_module("np_modeling_tpu_torch.ops.quantization")
    n, d = int(np.prod(shape[:-1])), shape[-1]
    sms = fused.sm_count("cuda")
    if schedule is not None:
        try:
            quant.schedule_plan(schedule, n, d, dtype)
        except ValueError:
            assert quant.quantize_plan(n, d, dtype, True, sms).schedule \
                != schedule
            return
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(*shape, generator=g, device="cuda").to(dtype)
    x.view(-1, d)[0] = 0.0                           # a zero row
    ran = _k10_equal_to_plain(x, 0x0123456789ABCDEF, schedule)
    assert ran == (schedule or quant.quantize_plan(n, d, dtype, True,
                                                   sms).schedule)


@pytest.mark.parametrize("d", [4, 64, 768, 772, 2304])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quantize_stochastic_misaligned_view_and_high_seed(d, dtype):
    """A view one element into its storage is not 16-byte aligned: the plan
    takes simple, and the vector schedule the aligned view takes, forced,
    is refused (d % 4 == 0); seeds above 2^32 key Philox's high word."""
    g = torch.Generator(device="cuda").manual_seed(3)
    flat = torch.randn(37 * d + 1, generator=g, device="cuda").to(dtype)
    x = flat[1:].view(37, d)
    assert _k10_equal_to_plain(x, 2 ** 32 + 12345) == "simple"
    aligned = _k10_equal_to_plain(flat[:-1].view(37, d), 2 ** 63 + 7)
    assert aligned in ("rows", "block_row")
    with _k10_schedule(aligned), pytest.raises(RuntimeError):
        ops.quantize_int8_stochastic(x, 1)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("warps", [1, 4, 16])
@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16),
                                     (768, torch.float32),
                                     (772, torch.bfloat16)])
def test_cuda_quantize_stochastic_rows_lanes_and_grids(lanes, warps, d,
                                                       dtype):
    """rows at every lane group and 1..16 warps a block (300 rows: the last
    block holds rows past the end), against the plain twin."""
    quant = importlib.import_module("np_modeling_tpu_torch.ops.quantization")
    try:
        quant.schedule_plan("rows", 300, d, dtype, lanes=lanes)
    except ValueError:          # more vectors a lane than rows holds
        assert d // quant.quantize_vec(d, dtype) > \
            quant.ROWS_PER_LANE[-1] * lanes
        return
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(300, d, generator=g, device="cuda").to(dtype)
    x[7] = 0.0
    assert _k10_equal_to_plain(x, 99, "rows", lanes=lanes,
                               warps=warps) == "rows"


@pytest.mark.parametrize("threads", [32, 128, 288, 512])
@pytest.mark.parametrize("d,dtype", [(2304, torch.bfloat16),
                                     (16384, torch.float32),
                                     (32768, torch.bfloat16),
                                     (4100, torch.bfloat16)])
def test_cuda_quantize_stochastic_block_row_threads_and_grids(threads, d,
                                                              dtype):
    """block_row at 1..16 warps a block (9: 288 threads), a block a row
    (300 rows)."""
    quant = importlib.import_module("np_modeling_tpu_torch.ops.quantization")
    try:
        quant.schedule_plan("block_row", 300, d, dtype, lanes=threads)
    except ValueError:          # more vectors a thread than block_row holds
        assert d // quant.quantize_vec(d, dtype) > \
            quant.BLOCK_ROW_PER_LANE[-1] * threads
        return
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(300, d, generator=g, device="cuda").to(dtype)
    x[299] = 0.0
    assert _k10_equal_to_plain(x, 2 ** 40 + 1, "block_row",
                               lanes=threads) == "block_row"


def test_cuda_quantize_stochastic_counts_the_planned_schedule():
    """launches_by_schedule counts each launch once, on the schedule the
    plan chose, and launches counts them all."""
    counts = ops.quantize_int8_stochastic.launches_by_schedule
    before, total = dict(counts), ops.quantize_int8_stochastic.launches
    for shape, dtype in (((8192, 768), torch.float32),
                         ((21504, 64), torch.bfloat16),
                         ((64, 16384), torch.float32),
                         ((8, 1001), torch.float32)):
        ops.quantize_int8_stochastic(torch.ones(shape, device="cuda",
                                                dtype=dtype), 1)
    assert ops.quantize_int8_stochastic.launches == total + 4
    assert {k: counts[k] - before[k] for k in counts} == {
        "rows": 2, "block_row": 1, "simple": 1}


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
