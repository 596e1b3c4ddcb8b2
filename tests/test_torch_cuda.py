"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card: the kernels
have no CPU mode. This file imports no JAX, so the card can run it alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which that machine
does not have). Tolerances: fp32 1e-4, bf16 2e-2, each times max(1, max
|plain|) for flash attention; LayerNorm fp32 1e-5 times max(1, max |plain|)
and bf16 one bf16 ulp (or that fp32 bound near 0); dropout bit for bit;
the whole-GPT criteria are the ones chip_smoke.py holds at full width,
explained there.
"""

import contextlib

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("option", ["window", "softcap", "segment_ids",
                                    "mask", "bias"])
def test_cuda_flash_unported_options_raise(option):
    q, k, v, _ = _flash_inputs(1, 2, 2, 64, 64, 64, torch.float32)
    kw = {"window": dict(window=4, causal=True), "softcap": dict(softcap=5.0),
          "segment_ids": dict(segment_ids=torch.zeros(
              1, 64, dtype=torch.int32, device="cuda")),
          "mask": dict(mask=torch.ones(1, 1, 64, 64, dtype=torch.bool,
                                       device="cuda")),
          "bias": dict(bias=torch.zeros(1, 2, 64, 64, device="cuda"))}[option]
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, v, **kw)


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
    """bf16: loss to 5e-3; against the fp32 step's gradients (same weights)
    each kernel-path gradient is no further than 1.25x the plain bf16
    step's, or 2e-2."""
    gpt = _gpt(torch.bfloat16, "relu")
    ref_gpt = _gpt(None, "relu")
    ref_gpt.load_state_dict(gpt.state_dict())
    tokens = torch.randint(0, 256, (2, 256), device="cuda")
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
