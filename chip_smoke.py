"""Drives the PyTorch port's serving path, its bench training step and its
training entry point once on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  (a) device: the card's name and power limit, as nvidia-smi reports them;
  (b) build: every kernel of the three paths, from the sources in this
      checkout (one nvcc for each source, all started together);
  (c) each kernel vs its plain PyTorch version on the card, at the paths'
      shapes. Paged attention: max abs err <= 1e-4 with fp32 pages,
      <= 2e-2 with bf16 pages. Flash attention (o, lse, dq, dk, dv):
      max abs err <= 1e-4 (fp32) or 2e-2 (bf16) times max(1, max |plain|).
      LayerNorm K8 (out, dx, dgamma, dbeta): fp32 max abs err <= 1e-5 times
      max(1, max |plain|); a bf16 output within one bf16 ulp (or that fp32
      bound, where a value is so near 0 that fp32 rounding before the last
      cast exceeds its ulp). Dropout K7: the kernel's mask equals the plain
      twin's bit for bit and so do the values, the keep share lies within
      5 sigma of the binomial, the backward drops what the forward dropped,
      another seed or salt draws another mask, rate 0 and eval launch
      nothing;
  (d) serving: GPT-2 small (124M) at full width and depth with seeded random
      weights serves 8 requests through add_requests / step_many /
      add_request / step / finish; checks tokens, page accounting, that
      every attention call launched the kernel and every LayerNorm K8, and
      that fp32 greedy tokens equal those of the plain version (near-ties
      printed);
  (e) serving timings with CUDA events (median of >= 20 runs after warm-up);
  (f) training: the bench GPT (bench.py: 4 layers, d 1024, 8 heads, FFN
      4096, vocab 8192, batch 4 x 4096 tokens, bf16 compute, fused loss) at
      full width. Step 0 through the kernels against the same step with the
      plain attention, on the same weights: in fp32 with gelu in place of
      relu (loss within 1e-5 relative, each gradient's relative L2 error
      <= 1e-4; relu's kink makes fp32 gradients of two correct versions
      differ by ~1e-3); in bf16 (loss within 5e-3 relative, each gradient
      no further from the fp32 step's than 1.25x the plain bf16 step's own
      distance, or 2e-2). Then 3 steps of adam(1e-3) on one seeded batch
      through the kernels: the loss is finite and falls, K1/K2 each
      launch once a layer a step and K8 once a LayerNorm a step each way;
  (g) training timings with CUDA events: flash forward, backward and
      forward+backward at the bench layer shape, and the whole train step;
  (h) the training entry point (np_modeling_tpu_torch/train_gpt.py): GPT-2
      small (124M) at full width and depth with dropout 0.1, bf16 compute,
      batch 8 x 1024 tokens, the recipe chain(clip_by_global_norm(1.0),
      adamw(warmup_cosine(3e-4, 10, 20))) through make_train_step, data
      from data.epochs -> prefetch_to_device. Step 0 (forward, backward,
      clip) through the kernels against the plain step with the same seed,
      so both draw the same masks: fp32 loss within 1e-5 relative and each
      gradient's relative L2 error <= 1e-4; bf16 loss within 5e-3 and each
      gradient no further from the fp32 step's than 1.25x the plain bf16
      step's own distance, or 2e-2. Then 20 steps: the loss is finite and
      lower at step 19 than at step 1, and each step launches K7 50 times
      (25 dropout sites, forward and backward), K8 25 times each way and
      K1/K2 12 times each. The corpus is seeded random tokens with Zipf
      frequencies (p ~ 1/rank), as text has: uniform tokens leave a model
      nothing to learn, so their loss cannot show that training works;
  (i) entry-point timings: LayerNorm forward and backward at [8192, 768]
      and [16384, 1024] and dropout at [8, 1024, 768] (bf16), and the
      whole GPT-2 small train step;
  (p) where the entry point's step spends the card's time: torch.profiler
      over 3 steps, device time by kernel and by kind, device ops a step
      and the card's idle share (PERF.md, "Where the time goes"); a
      report, not a check: if the profiler sees no device time, it says so
      and the run goes on.
Each path runs with the launch counts set to 0 just before it and read just
after. Timings run each side twice, in the order plain, kernel, kernel,
plain. Every kernel is timed with CUDA events two ways: a call's wall time,
the host's share included (the JSON line's "ms"), and device time, calls
queued back to back behind a sleep kernel so the host's gaps drop out
("device_ms"). The line before the last holds the kernels' JSON summary;
the last line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}. It imports nothing of JAX and needs no network.
"""

from __future__ import annotations

import contextlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
HERE = pathlib.Path(__file__).resolve().parent
PAGED_SOURCE = "np_modeling_tpu_torch/csrc/paged_attention.cu"
FLASH_SOURCE = "np_modeling_tpu_torch/csrc/flash_attention.cu"
FUSED_SOURCE = "np_modeling_tpu_torch/csrc/fused.cu"
F32_TOL, BF16_TOL = 1e-4, 2e-2
LN_F32_TOL = 1e-5
# The bench GPT's training shape (bench.py:39): batch, sequence, layers.
TRAIN_B, TRAIN_S, TRAIN_LAYERS = 4, 4096, 4
LAYER_SHAPE = (TRAIN_B, 8, 8, TRAIN_S, TRAIN_S, 128)   # b, hq, hkv, sq, skv, d
NEAR_TIE = 1e-4
# The training entry point's GPT-2 small run: batch, sequence, steps.
GPT2_B, GPT2_S, GPT2_STEPS = 8, 1024, 20
# Phase (p): profiled steps, after warm-up steps.
PROFILE_STEPS, PROFILE_WARMUP = 3, 8
LN_EPS = 1e-5


def _import_port():
    import np_modeling_tpu_torch
    where = pathlib.Path(np_modeling_tpu_torch.__file__).resolve().parent
    if where.parent != HERE:
        raise RuntimeError(f"np_modeling_tpu_torch imported from {where}, "
                           f"not from this checkout ({HERE})")
    return np_modeling_tpu_torch


def _tol(dtype):
    import torch
    return F32_TOL if dtype == torch.float32 else BF16_TOL


def _cuda_ms(fn, runs=25, warmup=3):
    """Median milliseconds of ``fn()`` over ``runs`` CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, runs=20, warmup=3):
    """Device milliseconds per call of ``fn()``, the calls back to back:
    the card spins in a sleep kernel while the host queues ``runs`` calls
    behind it, so the CUDA events around them leave out the host's time
    between launches, which a call's wall time includes. The start event
    must still be pending when the last call is queued; if it is not (the
    host was slower than the sleep, or the launch queue filled), the card
    sleeps longer over fewer calls and the measurement is taken again."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    for _ in range(6):
        # Four times the calls' wall time at a 2 GHz clock, or longer.
        torch.cuda._sleep(int(4 * call_s * runs * 2e9) + 10 ** 6)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / runs
        runs, call_s = max(1, runs // 2), 2 * call_s
    raise AssertionError("the host could not queue the calls ahead of the card")


def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    line = out.strip().splitlines()[0]
    print(f"(a) device: {line}")
    return line


def phase_build():
    from np_modeling_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    libs = cuda_build.build("paged_attention", "flash_attention", "fused")
    print(f"(b) build: all three libraries in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"(b) {name}: nvcc {lib.build_seconds:.2f} s -> {lib.path.name}")
        for ln in lib.log.splitlines():
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
                print(f"    ptxas: {ln.strip()}")


def _pa_inputs(b, sq, hq, hkv, d, psize, lengths, dtype, rng, extra_pages=2):
    """Scrambled page table over a shared page pool; pages past a row's
    length stay valid indices (the plain version gathers the whole table)."""
    import torch
    pps = max(-(-max(lengths) // psize), 1)
    total = b * pps + extra_pages
    perm = rng.permutation(total)[:b * pps].reshape(b, pps)
    qshape = (b, hq, d) if sq is None else (b, sq, hq, d)
    dev = "cuda"
    q = torch.tensor(rng.standard_normal(qshape), dtype=torch.float32, device=dev)
    k = torch.tensor(rng.standard_normal((hkv, total, psize, d)),
                     dtype=torch.float32, device=dev)
    v = torch.tensor(rng.standard_normal((hkv, total, psize, d)),
                     dtype=torch.float32, device=dev)
    return (q.to(dtype), k.to(dtype), v.to(dtype),
            torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.tensor(perm, dtype=torch.int32, device=dev))


def phase_paged_vs_plain():
    """Paged kernel vs plain on the card; returns (max err fp32, bf16)."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    rng = np.random.default_rng(SEED)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for hq, hkv, d in ((12, 12, 64), (8, 2, 128)):
        for sq in (None, 1, 5, 256):
            for psize in (16, 64):
                rows = sq or 1
                mid = psize * 3 + psize // 2
                # shortest, whole pages, mid-page, long ragged, and (decode)
                # an empty row
                lengths = [rows, psize * -(-rows // psize),
                           max(mid, rows + psize // 2),
                           int(rng.integers(rows + 1, rows + 700))]
                if rows == 1:
                    lengths.append(0)
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v, lens, table = _pa_inputs(
                        len(lengths), sq, hq, hkv, d, psize, lengths, dtype, rng)
                    got = ops.paged_attention(q, k, v, lens, table)
                    with dispatch.force_plain():
                        want = ops.paged_attention(q, k, v, lens, table)
                    # Past ceil(length/psize) the kernel must read nothing:
                    # poisoned tail entries may not change its output.
                    poisoned = table.clone()
                    for i, ln in enumerate(lengths):
                        poisoned[i, -(-ln // psize):] = 2 ** 30
                    again = ops.paged_attention(q, k, v, lens, poisoned)
                    torch.cuda.synchronize()
                    live = lens > 0
                    err = (got[live].float() - want[live].float()).abs().max().item()
                    tol = _tol(dtype)
                    tag = (f"hq{hq}/hkv{hkv}/d{d} sq={sq} ps={psize} "
                           f"{str(dtype)[6:]} lengths={lengths}")
                    if not err <= tol:
                        raise AssertionError(f"(c) {tag}: max abs err {err} > {tol}")
                    if not torch.equal(got, again):
                        raise AssertionError(f"(c) {tag}: output depends on table "
                                             "entries past the length")
                    if not bool((got[~live] == 0).all()):
                        raise AssertionError(f"(c) {tag}: length-0 row not 0")
                    errs[dtype] = max(errs[dtype], err)
                    n += 1
                    print(f"(c) {tag}: max abs err {err:.3e}")
    print(f"(c) paged: {n} cases pass: max abs err fp32 {errs[torch.float32]:.3e} "
          f"(tol {F32_TOL}), bf16 {errs[torch.bfloat16]:.3e} (tol {BF16_TOL})")
    return errs[torch.float32], errs[torch.bfloat16]


def _flash_inputs(shape, dtype, rng):
    import torch
    b, hq, hkv, sq, skv, d = shape
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device="cuda").to(dtype)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                      (b, hq, sq, d))]


def _flash_fwd_bwd(q, k, v, do, causal, plain):
    """o, dq, dk, dv through ops.flash_attention (kernels or plain)."""
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    with dispatch.force_plain() if plain else contextlib.nullcontext():
        o = ops.flash_attention(*leaves, causal=causal)
        o.backward(do)
    return [o.detach()] + [x.grad for x in leaves]


def phase_flash_vs_plain():
    """K1/K2 vs the plain version on the card: o, lse, dq, dk, dv. Returns
    the max abs errors {dtype: (forward, backward)}."""
    import torch
    from np_modeling_tpu_torch.ops import attention
    rng = np.random.default_rng(SEED + 3)
    cases = [((2, hq, hkv, 200, 200, d), causal, dtype)
             for dtype in (torch.float32, torch.bfloat16)
             for causal in (False, True)
             for hq, hkv in ((8, 8), (8, 2)) for d in (64, 128)]
    cases += [((1, 8, 2, 128, 640, d), causal, dtype)
              for dtype in (torch.float32, torch.bfloat16)
              for causal in (False, True) for d in (64, 128)]
    cases.append((LAYER_SHAPE, True, torch.bfloat16))
    errs = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    for shape, causal, dtype in cases:
        q, k, v, do = _flash_inputs(shape, dtype, rng)
        got = _flash_fwd_bwd(q, k, v, do, causal, plain=False)
        want = _flash_fwd_bwd(q, k, v, do, causal, plain=True)
        scale = 1.0 / math.sqrt(shape[-1])
        got.insert(1, attention._flash_fwd_cuda(q, k, v, causal, scale, True)[1])
        want.insert(1, attention._attn_fwd_plain(q, k, v, None, None, causal,
                                                 None, scale)[1])
        torch.cuda.synchronize()
        tag = f"{shape} causal={causal} {str(dtype)[6:]}"
        line = []
        for name, x, y in zip(("o", "lse", "dq", "dk", "dv"), got, want):
            err = (x.float() - y.float()).abs().max().item()
            bound = _tol(dtype) * max(1.0, y.float().abs().max().item())
            if not err <= bound:
                raise AssertionError(f"(c) flash {tag}: {name} max abs err "
                                     f"{err} > {bound}")
            slot = 0 if name in ("o", "lse") else 1
            errs[dtype][slot] = max(errs[dtype][slot], err)
            line.append(f"{name} {err:.2e}/{bound:.1e}")
        print(f"(c) flash {tag}: max abs err / bound: {', '.join(line)}")
    print(f"(c) flash: {len(cases)} cases pass; max abs err fp32 fwd "
          f"{errs[torch.float32][0]:.3e} bwd {errs[torch.float32][1]:.3e}, "
          f"bf16 fwd {errs[torch.bfloat16][0]:.3e} bwd "
          f"{errs[torch.bfloat16][1]:.3e}")
    return errs


def _bf16_ulp(t):
    """One bf16 ulp at each |t| (8 significant bits)."""
    import torch
    a = t.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _ln_fwd_bwd(x, gamma, beta, dz, plain):
    """out, dx, dgamma, dbeta through ops.layer_norm (K8 or plain)."""
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    with dispatch.force_plain() if plain else contextlib.nullcontext():
        out = ops.layer_norm(*leaves, LN_EPS)
        out.backward(dz)
    return [out.detach()] + [t.grad for t in leaves]


def _ln_err(got, want):
    """Max abs err and whether it passes: fp32 <= 1e-5 x max(1, max |plain|);
    bf16 within one bf16 ulp of either value, or that fp32 bound."""
    import torch
    diff = (got.float() - want.float()).abs()
    f32_bound = LN_F32_TOL * max(1.0, want.float().abs().max().item())
    if got.dtype == torch.bfloat16:
        bound = torch.maximum(torch.maximum(_bf16_ulp(want), _bf16_ulp(got)),
                              torch.full_like(diff, f32_bound))
        return diff.max().item(), bool((diff <= bound).all())
    return diff.max().item(), diff.max().item() <= f32_bound


def _ln_cases():
    import torch
    cases = [(rows, d, dtype) for dtype in (torch.float32, torch.bfloat16)
             for d in (64, 768, 1000, 1001, 1024) for rows in (1, 7, 8192)]
    cases += [(64, 8192, torch.float32), (64, 8192, torch.bfloat16),
              (16384, 1024, torch.float32), (16384, 1024, torch.bfloat16)]
    return cases


def phase_fused_vs_plain():
    """K8 (LayerNorm forward, backward) and K7 (dropout) vs their plain
    versions on the card. Returns {name: (max err fp32, max err bf16)}."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import fused
    from np_modeling_tpu_torch.rng import fold_seed
    rng = np.random.default_rng(SEED + 5)
    errs = {"layer_norm_fwd": [0.0, 0.0], "layer_norm_bwd": [0.0, 0.0],
            "dropout": [0.0, 0.0]}
    cases = _ln_cases()
    for rows, d, dtype in cases:
        def rand(*shape, scale=1.0, shift=0.0):
            return torch.tensor(rng.standard_normal(shape) * scale + shift,
                                dtype=torch.float32, device="cuda")
        x = rand(rows, d, scale=2.0, shift=0.5).to(dtype)
        gamma, beta = rand(d, scale=0.1, shift=1.0), rand(d, scale=0.1)
        dz = rand(rows, d).to(dtype)
        got = _ln_fwd_bwd(x, gamma, beta, dz, plain=False)
        want = _ln_fwd_bwd(x, gamma, beta, dz, plain=True)
        torch.cuda.synchronize()
        line, slot = [], int(dtype == torch.bfloat16)
        for name, a, b in zip(("out", "dx", "dgamma", "dbeta"), got, want):
            err, ok = _ln_err(a, b)
            if not ok:
                raise AssertionError(f"(c) layer_norm [{rows}, {d}] "
                                     f"{str(dtype)[6:]}: {name} max abs err "
                                     f"{err} out of bounds")
            key = "layer_norm_fwd" if name == "out" else "layer_norm_bwd"
            errs[key][slot] = max(errs[key][slot], err)
            line.append(f"{name} {err:.2e}")
        print(f"(c) layer_norm [{rows}, {d}] {str(dtype)[6:]}: max abs err "
              f"{', '.join(line)}")
    try:
        ops.layer_norm(torch.zeros(2, 8193, device="cuda"),
                       torch.ones(8193, device="cuda"),
                       torch.zeros(8193, device="cuda"))
    except ValueError:
        pass
    else:
        raise AssertionError("(c) layer_norm took d 8193 on the card")
    print(f"(c) layer_norm: {len(cases)} cases pass (d 64..8192, rows 1..16384); "
          f"max abs err fp32 fwd {errs['layer_norm_fwd'][0]:.3e} bwd "
          f"{errs['layer_norm_bwd'][0]:.3e}, bf16 fwd "
          f"{errs['layer_norm_fwd'][1]:.3e} bwd {errs['layer_norm_bwd'][1]:.3e}")

    n_drop = 0
    for shape in ((8, 1024, 768), (3, 1001), (5, 33, 17), (7,), (1,)):
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.1, 0.5):
                for strided in (False, True)[:len(shape)]:
                    base = torch.tensor(rng.standard_normal(shape),
                                        dtype=torch.float32,
                                        device="cuda").to(dtype)
                    x = base.transpose(0, -1) if strided else base
                    seed = int(rng.integers(0, 2 ** 63))
                    tag = (f"(c) dropout {tuple(x.shape)} {str(dtype)[6:]} "
                           f"rate {rate}{' strided' if strided else ''}")
                    _check_dropout_case(tag, x, seed, rate)
                    n_drop += 1
    x = torch.ones(4096, device="cuda")
    a = fused.dropout_cuda(x, 1, 0.5) != 0
    for other in (fused.dropout_cuda(x, 2, 0.5) != 0,
                  fused.dropout_cuda(x, fold_seed(1, 1), 0.5) != 0):
        agree = (a == other).float().mean().item()
        if not 0.45 < agree < 0.55:
            raise AssertionError(f"(c) dropout: another seed or salt agrees "
                                 f"on {agree:.3f} of the mask")
    before = ops.dropout.launches
    if not (ops.dropout(x, 1, 0.0) is x
            and ops.dropout(x, 1, 0.5, training=False) is x
            and ops.dropout.launches == before):
        raise AssertionError("(c) dropout at rate 0 or in eval is not the "
                             "identity, or launched")
    print(f"(c) dropout: {n_drop} cases pass: kernel mask == plain twin's mask "
          "and values equal bit for bit; keep share within 5 sigma; backward "
          "drops the forward's elements; other seeds and salts decorrelate; "
          "rate 0 and eval launch nothing")
    return errs


def _check_dropout_case(tag, x, seed, rate):
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch, fused
    leaf = x.clone().requires_grad_()
    got = ops.dropout(leaf, seed, rate)
    got.backward(torch.ones_like(got))
    with dispatch.force_plain():
        want = ops.dropout(x, seed, rate)
    kernel_mask = fused.dropout_cuda(torch.ones_like(x), seed, rate) != 0
    plain_mask = fused.philox_keep_mask(seed, x.shape, rate, x.device)
    torch.cuda.synchronize()
    if not torch.equal(kernel_mask, plain_mask):
        raise AssertionError(f"{tag}: kernel mask differs from the plain "
                             f"twin's in {(kernel_mask != plain_mask).sum()} "
                             "elements")
    if not torch.equal(got.detach(), want):
        raise AssertionError(f"{tag}: values differ from plain, max "
                             f"{(got.float() - want.float()).abs().max()}")
    if not torch.equal(leaf.grad != 0, kernel_mask):
        raise AssertionError(f"{tag}: the backward's zeros differ from the "
                             "forward's mask")
    n = x.numel()
    kept = int(kernel_mask.sum())
    if n >= 1000 and abs(kept - n * (1 - rate)) > 5 * (n * rate * (1 - rate)) ** 0.5:
        raise AssertionError(f"{tag}: kept {kept} of {n}")
    print(f"{tag}: masks and values equal, kept {kept}/{n} "
          f"({kept / n:.4f}, expected {1 - rate})")


def gpt2_config(dtype, drop_rate=0.0):
    from np_modeling_tpu_torch.models import GPTConfig
    return GPTConfig(vocab_size=50257, d_model=768, num_heads=12,
                     num_layers=12, hidden_units=3072, max_len=1024,
                     activation="gelu", ln_eps=LN_EPS, drop_rate=drop_rate,
                     dtype=dtype)


def make_engine(gpt, kv_dtype):
    from np_modeling_tpu_torch.serving import GenerationEngine
    return GenerationEngine(gpt, total_pages=640, page_size=16, max_seqs=8,
                            kv_dtype=kv_dtype)


def traffic_prompts(vocab):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(128, 769, 8)
    return [rng.integers(0, vocab, n).astype(np.int64) for n in lens]


def run_traffic(eng, prompts):
    """The phase's traffic. Returns ({seq: tokens}, [(seq, token index,
    lm-head call, row)], lm-head calls made, prefill chunk calls)."""
    calls = []
    inner = eng._lm_head

    def recording(x):
        lg = inner(x)
        top = lg.topk(2, dim=-1).values
        calls.append((top[..., 0] - top[..., 1]).reshape(-1))
        return lg

    eng._lm_head = recording
    chunk = eng.prefill_chunk_size
    streams, where, chunk_calls = {}, [], 0

    def prefill(batch):
        nonlocal chunk_calls
        base = len(calls)
        first = eng.add_requests(batch)
        chunk_calls += len(calls) - base
        for row, sid in enumerate(sorted(batch)):
            final_ci = (len(batch[sid]) - 1) // chunk
            streams[sid] = [first[sid]]
            where.append((sid, 0, base + final_ci, row))

    def decode(n):
        slots = dict(eng._slots)
        base = len(calls)
        out = eng.step_many(n) if n > 1 else {s: [t] for s, t in eng.step().items()}
        for sid, toks in out.items():
            for i, t in enumerate(toks):
                where.append((sid, len(streams[sid]), base + i, slots[sid]))
                streams[sid].append(t)

    prefill({i: prompts[i] for i in range(7)})
    decode(32)
    prefill({7: prompts[7]})
    decode(32)
    eng.finish(1)
    eng.finish(4)
    for _ in range(4):
        decode(1)
    eng._lm_head = inner
    return streams, where, calls, chunk_calls


def phase_engine():
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.models import GPT
    from np_modeling_tpu_torch.ops import dispatch
    cfg = gpt2_config(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gpt = GPT(cfg, device="cuda").init(gen)
    n_params = sum(p.numel() for p in gpt.parameters())
    print(f"(d) GPT-2 small: {cfg.num_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {n_params} params, bf16 compute, bf16 pages")
    prompts = traffic_prompts(cfg.vocab_size)
    print(f"(d) prompt lengths {[len(p) for p in prompts]}")

    eng = make_engine(gpt, torch.bfloat16)
    free0 = eng.free_pages
    ops.paged_attention.launches = 0
    ops.layer_norm.launches_fwd = 0
    streams, _, calls, chunk_calls = run_traffic(eng, prompts)
    launches = ops.paged_attention.launches
    ln_launches = ops.layer_norm.launches_fwd
    decode_steps = len(calls) - chunk_calls
    for sid in eng.live:
        eng.finish(sid)
    expected = cfg.num_layers * (chunk_calls + decode_steps)
    ln_expected = (2 * cfg.num_layers + 1) * (chunk_calls + decode_steps)
    toks = np.concatenate([np.asarray(s) for s in streams.values()])
    print(f"(d) bf16 run: {len(toks)} tokens, {chunk_calls} prefill chunk calls, "
          f"{decode_steps} decode steps, kernel launches {launches} "
          f"(expected {expected}), LayerNorm K8 launches {ln_launches} "
          f"(expected {ln_expected}), free pages {eng.free_pages}/{free0}")
    if ln_launches != ln_expected:
        raise AssertionError(f"(d) {ln_launches} LayerNorm launches, expected "
                             f"{ln_expected}")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("(d) token out of range")
    if eng.free_pages != free0:
        raise AssertionError("(d) pages not restored after finish")
    if launches != expected:
        raise AssertionError(f"(d) {launches} kernel launches, expected {expected}")

    # Exactness: fp32 compute and pages, kernel vs plain, same weights.
    gpt32 = GPT(gpt2_config(None), device="cuda")
    gpt32.load_state_dict(gpt.state_dict())
    k_streams, _, _, _ = run_traffic(make_engine(gpt32, torch.float32), prompts)
    with dispatch.force_plain():
        p_streams, where, calls, _ = run_traffic(
            make_engine(gpt32, torch.float32), prompts)
    margin = {(sid, i): float(calls[c][row]) for sid, i, c, row in where}
    ties, compared = [], 0
    for sid in sorted(p_streams):
        for i, (a, b) in enumerate(zip(k_streams[sid], p_streams[sid])):
            compared += 1
            if a != b:
                m = margin[(sid, i)]
                if not m < NEAR_TIE:
                    raise AssertionError(
                        f"(d) fp32 seq {sid} token {i}: kernel {a} != plain {b}, "
                        f"plain top-2 margin {m}")
                ties.append((sid, i, a, b, m))
                break                       # the continuations now differ
    for sid, i, a, b, m in ties:
        print(f"(d) near-tie: seq {sid} token {i}: kernel {a}, plain {b}, "
              f"plain top-2 margin {m:.3e}")
    print(f"(d) fp32 kernel vs plain: {compared} greedy tokens compared, "
          f"{len(ties)} near-tie divergences, all else identical")
    return gpt, prompts, launches


def _plain(fn):
    """``fn`` under dispatch.force_plain()."""
    from np_modeling_tpu_torch.ops import dispatch

    def forced():
        with dispatch.force_plain():
            return fn()

    return forced


def _both(res, tag, name, fn, device_line, runs=25, warmup=3, plain_fn=None):
    """Plain, kernel, kernel, plain; keeps the lower median of each side."""
    plain_fn = plain_fn or _plain(fn)
    t = [_cuda_ms(f, runs, warmup) for f in (plain_fn, fn, fn, plain_fn)]
    res[name] = (min(t[1], t[2]), min(t[0], t[3]))
    print(f"({tag}) {name}: kernel {t[1]:.4f} / {t[2]:.4f} ms, plain "
          f"{t[0]:.4f} / {t[3]:.4f} ms (medians of {runs}, order plain, "
          f"kernel, kernel, plain) [{device_line}]")


def phase_timings(gpt, prompts, device_line):
    import torch
    from np_modeling_tpu_torch import ops
    rng = np.random.default_rng(SEED + 1)
    res = {}

    def both(name, fn, runs=25):
        _both(res, "e", name, fn, device_line, runs)

    # Decode shape of the engine: 8 sequences, ctx 512..800, GPT-2 heads.
    lengths = rng.integers(512, 801, 8).tolist()
    q, k, v, lens, table = _pa_inputs(8, 1, 12, 12, 64, 16, lengths,
                                      torch.bfloat16, rng, extra_pages=64)
    name = "paged_attention decode b8 ctx512-800 bf16"
    both(name, lambda: ops.paged_attention(q, k, v, lens, table))
    _device_both(res, "e", name,
                 lambda: ops.paged_attention(q, k, v, lens, table), device_line)
    # A 256-token prefill chunk of 7 sequences at bases 0..512.
    lengths = [256 * (1 + i % 3) for i in range(7)]
    q, k, v, lens, table = _pa_inputs(7, 256, 12, 12, 64, 16, lengths,
                                      torch.bfloat16, rng)
    both("paged_attention chunk b7 sq256 bf16",
         lambda: ops.paged_attention(q, k, v, lens, table))

    eng = make_engine(gpt, torch.bfloat16)
    batch = {i: prompts[i] for i in range(7)}
    n_tok = sum(len(p) for p in batch.values())

    def prefill():
        eng.add_requests(batch)
        for sid in eng.live:
            eng.finish(sid)

    both(f"engine prefill 7 prompts {n_tok} tokens", prefill, runs=20)
    # Decode from prompts cut to 512 tokens: 4 x 23 timed calls of 4 steps
    # keep every sequence inside max_len.
    eng.add_requests({i: prompts[i][:512] for i in range(8)})
    steps = 4
    name = f"engine decode step_many({steps}) 8 seqs ctx<=512+"
    both(name, lambda: eng.step_many(steps), runs=20)
    ms = res[name]
    print(f"(e) engine decode: kernel {8 * steps / ms[0] * 1e3:.1f} tokens/s, "
          f"plain {8 * steps / ms[1] * 1e3:.1f} tokens/s [{device_line}]")
    pf = res[f"engine prefill 7 prompts {n_tok} tokens"]
    print(f"(e) engine prefill: kernel {pf[0]:.3f} ms, plain {pf[1]:.3f} ms "
          f"for {n_tok} tokens [{device_line}]")
    return res


def bench_gpt_config(dtype, activation="relu"):
    """bench.py's training GPT (bench.py:39, built as build_ours builds it)."""
    from np_modeling_tpu_torch.models import GPTConfig
    return GPTConfig(vocab_size=8192, d_model=1024, num_heads=8,
                     num_layers=TRAIN_LAYERS, hidden_units=4096,
                     max_len=TRAIN_S, dtype=dtype, fused_loss=True,
                     activation=activation)


def _loss_and_grads(gpt, tokens, plain):
    from np_modeling_tpu_torch.ops import dispatch
    gpt.zero_grad(set_to_none=True)
    with dispatch.force_plain() if plain else contextlib.nullcontext():
        loss = gpt.loss(tokens)
        loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in gpt.named_parameters()}


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


def _is_key_bias(name):
    # The key bias's gradient is 0 in exact arithmetic (softmax does not see
    # a shift shared by all keys): every version gives rounding noise there,
    # so it is held to be small against the key weight's gradient instead.
    return name.endswith("self_attention.bk")


def _check_key_bias(tag, grads, ref, tol):
    for name in ref:
        if _is_key_bias(name):
            rel = grads[name].norm().item() / ref[name[:-2] + "wk"].norm().item()
            if not rel <= tol:
                raise AssertionError(f"{tag}: {name} gradient norm {rel} "
                                     "of wk's, want ~0")


def _compare_fp32(gpt, tokens):
    """fp32 compute: the step through the kernels vs the plain step."""
    lk, gk = _loss_and_grads(gpt, tokens, plain=False)
    lp, gp = _loss_and_grads(gpt, tokens, plain=True)
    loss_err = abs(lk - lp) / abs(lp)
    errs = {n: _rel(gk[n], gp[n]) for n in gp if not _is_key_bias(n)}
    worst = max(errs, key=errs.get)
    return lk, lp, loss_err, errs[worst], worst, gk, gp


def _hold_bf16(tag, lk, lp, gk, gp, ref):
    """The bf16 step-0 criteria: loss within 5e-3 of the plain step's; each
    gradient no further from the fp32 step's (``ref``) than 1.25 x the plain
    bf16 step's own distance, or 2e-2; the key bias by its size."""
    loss_err = abs(lk - lp) / abs(lp)
    if not (math.isfinite(lk) and loss_err <= 5e-3):
        raise AssertionError(f"{tag} bf16: loss kernel {lk} vs plain {lp}, "
                             f"relative err {loss_err} > 5e-3")
    ratio, ratio_name, spread = 0.0, None, 0.0
    for n in ref:
        if _is_key_bias(n):
            continue
        ek, ep = _rel(gk[n], ref[n]), _rel(gp[n], ref[n])
        spread = max(spread, _rel(gk[n], gp[n]))
        if not ek <= max(2e-2, 1.25 * ep):
            raise AssertionError(f"{tag} bf16: {n} gradient {ek:.3e} from the "
                                 f"fp32 step, plain bf16 {ep:.3e}")
        if ek / ep > ratio:
            ratio, ratio_name = ek / ep, n
    _check_key_bias(f"{tag} bf16", gk, ref, 2e-2)
    print(f"{tag} bf16 step 0, kernels vs plain: loss {lk:.6f} vs {lp:.6f} "
          f"(relative err {loss_err:.2e}, tol 5e-03); against the fp32 "
          f"step's gradients the kernels' error is at most {ratio:.3f} x the "
          f"plain bf16 step's ({ratio_name}, tol 1.25 x or 2e-02); kernels "
          f"vs plain bf16 differ by at most {spread:.2e} relative L2")
    return ratio


def phase_training():
    """Step-0 comparisons on the bench GPT's initial weights, then the main
    path: 3 adam steps through the kernels.

    What each comparison can hold, as measured on the chip (PERF.md,
    Findings): with relu, a last-bit difference in any pre-activation near
    0 flips its gradient mask, so two correct fp32 implementations differ
    by ~1e-3 in the gradients behind a relu; and a bf16 step's gradients
    are themselves only ~5e-2 from the fp32 step's. So (1) in fp32 the
    bench GPT with gelu in place of relu (smooth, every other width the
    same) must match the plain step to 1e-5 (loss) and 1e-4 (each
    gradient's relative L2); (2) in bf16 the bench GPT's loss must match
    the plain step's to 5e-3, and each gradient must be no further from the
    fp32 plain step's (same weights) than 1.25 times the plain bf16 step's
    own distance, or 2e-2."""
    import torch
    from np_modeling_tpu_torch import training
    from np_modeling_tpu_torch.models import GPT
    cfg = bench_gpt_config(torch.bfloat16)
    gpt = GPT(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in gpt.parameters())
    rng = np.random.default_rng(SEED + 2)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)),
                          device="cuda")
    print(f"(f) bench GPT: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads} heads, FFN {cfg.hidden_units}, vocab "
          f"{cfg.vocab_size}, {n_params} params; batch {TRAIN_B} x "
          f"{TRAIN_S} tokens, bf16 compute, fused loss, adam(1e-3)")

    # (1) fp32, gelu twin: kernels vs plain.
    twin = GPT(bench_gpt_config(None, "gelu"), device="cuda")
    twin.load_state_dict(gpt.state_dict())
    lk, lp, loss_err, worst, name, gk, _ = _compare_fp32(twin, tokens)
    print(f"(f) fp32 gelu step 0, kernels vs plain: loss {lk:.7f} vs "
          f"{lp:.7f} (relative err {loss_err:.2e}, tol 1e-05); worst "
          f"gradient relative L2 err {worst:.2e} ({name}, tol 1e-04)")
    if not (math.isfinite(lk) and loss_err <= 1e-5 and worst <= 1e-4):
        raise AssertionError("(f) fp32 gelu step: kernels differ from plain")
    _check_key_bias("(f) fp32 gelu", gk, gk, 1e-4)

    # The fp32 relu step: the reference of (2), and the relu-kink spread.
    twin = GPT(bench_gpt_config(None), device="cuda")
    twin.load_state_dict(gpt.state_dict())
    lk, lp, loss_err, worst, name, _, ref = _compare_fp32(twin, tokens)
    print(f"(f) fp32 relu step 0, kernels vs plain: loss {lk:.7f} vs "
          f"{lp:.7f} (relative err {loss_err:.2e}); worst gradient relative "
          f"L2 err {worst:.2e} ({name}): relu-mask flips, not held")
    if not (math.isfinite(lk) and loss_err <= 1e-5):
        raise AssertionError("(f) fp32 relu step: loss differs from plain")
    del twin
    torch.cuda.empty_cache()

    # (2) bf16, the bench GPT itself.
    lk, gk = _loss_and_grads(gpt, tokens, plain=False)
    lp, gp = _loss_and_grads(gpt, tokens, plain=True)
    _hold_bf16("(f)", lk, lp, gk, gp, ref)
    del gk, gp, ref
    torch.cuda.empty_cache()

    opt = training.adam(1e-3)
    params = dict(gpt.named_parameters())
    state = opt.init(params)
    _zero_launch_counts()
    losses = []
    for _ in range(3):
        loss, state = _train_step(gpt, opt, params, state, tokens)
        losses.append(loss.item())
    counts = _launch_counts()
    launches = (counts["flash_attention_fwd"], counts["flash_attention_bwd"])
    want = cfg.num_layers * len(losses)
    ln_want = (2 * cfg.num_layers + 1) * len(losses)
    print(f"(f) 3 adam steps through the kernels: losses {losses}; flash "
          f"launches fwd {launches[0]}, bwd {launches[1]} (expected {want}); "
          f"LayerNorm K8 launches fwd {counts['layer_norm_fwd']}, bwd "
          f"{counts['layer_norm_bwd']} (expected {ln_want})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(f) loss not finite: {losses}")
    if not losses[0] > losses[1] > losses[2]:
        raise AssertionError(f"(f) loss does not fall: {losses}")
    if launches != (want, want):
        raise AssertionError(f"(f) flash launches {launches}, expected "
                             f"{want} each")
    if (counts["layer_norm_fwd"], counts["layer_norm_bwd"]) != (ln_want,
                                                                ln_want):
        raise AssertionError(f"(f) LayerNorm launches {counts}, expected "
                             f"{ln_want} each way")
    return gpt, opt, params, state, tokens, launches


def _train_step(gpt, opt, params, state, tokens):
    from np_modeling_tpu_torch import training
    gpt.zero_grad(set_to_none=True)
    loss = gpt.loss(tokens)
    loss.backward()
    updates, state = opt.update({n: p.grad for n, p in params.items()},
                                state, params)
    training.apply_updates(params, updates)
    return loss, state


def phase_train_timings(gpt, opt, params, state, tokens, device_line):
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    res = {}
    rng = np.random.default_rng(SEED + 4)
    q, k, v, do = _flash_inputs(LAYER_SHAPE, torch.bfloat16, rng)
    shape = "b4 h8 s4096 d128 causal bf16"

    def fwd():
        with torch.no_grad():
            return ops.flash_attention(q, k, v, causal=True)

    name = f"flash forward {shape}"
    _both(res, "g", name, fwd, device_line, runs=20)
    _device_both(res, "g", name, fwd, device_line)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_kernel = ops.flash_attention(*leaves, causal=True)
    with dispatch.force_plain():
        o_plain = ops.flash_attention(*leaves, causal=True)

    def bwd(o):
        return lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)

    name = f"flash backward {shape}"
    _both(res, "g", name, bwd(o_kernel), device_line, runs=20,
          plain_fn=bwd(o_plain))
    _device_both(res, "g", name, bwd(o_kernel), device_line,
                 plain_fn=bwd(o_plain))
    del o_kernel, o_plain

    def fwd_bwd():
        o = ops.flash_attention(*leaves, causal=True)
        return torch.autograd.grad(o, leaves, do)

    _both(res, "g", f"flash forward+backward {shape}", fwd_bwd, device_line,
          runs=20)
    del leaves, q, k, v, do
    torch.cuda.empty_cache()

    box = [state]

    def step():
        _, box[0] = _train_step(gpt, opt, params, box[0], tokens)

    name = (f"train step (forward, backward, adam) b{TRAIN_B} s{TRAIN_S} "
            f"bench GPT bf16")
    _both(res, "g", name, step, device_line, runs=10, warmup=2)
    ms = res[name]
    n_tok = TRAIN_B * TRAIN_S
    print(f"(g) train step: kernel {ms[0]:.3f} ms ({n_tok / ms[0] * 1e3:.0f} "
          f"tokens/s), plain {ms[1]:.3f} ms ({n_tok / ms[1] * 1e3:.0f} "
          f"tokens/s) [{device_line}]")
    return res


def zipf_corpus(vocab, rows, seq, seed=SEED):
    """Seeded random tokens whose frequencies fall as 1/rank (Zipf)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    return rng.choice(vocab, size=(rows, seq), p=p / p.sum())


def _step0(gpt, tokens, seed, plain):
    """Step 0 of the recipe without the update: loss, and the gradients
    after clip_by_global_norm(1.0), with dropout seeded by ``seed``."""
    from np_modeling_tpu_torch import training
    from np_modeling_tpu_torch.ops import dispatch
    gpt.zero_grad(set_to_none=True)
    with dispatch.force_plain() if plain else contextlib.nullcontext():
        loss = gpt.loss(tokens, training=True, rngs={"dropout": seed})
        loss.backward()
        grads, _ = training.clip_by_global_norm(1.0).update(
            {n: p.grad for n, p in gpt.named_parameters()}, ())
    return loss.item(), {n: g.detach().clone() for n, g in grads.items()}


def _launch_counts():
    from np_modeling_tpu_torch import ops
    return {"dropout": ops.dropout.launches,
            "layer_norm_fwd": ops.layer_norm.launches_fwd,
            "layer_norm_bwd": ops.layer_norm.launches_bwd,
            "flash_attention_fwd": ops.flash_attention.launches_fwd,
            "flash_attention_bwd": ops.flash_attention.launches_bwd}


def _zero_launch_counts():
    from np_modeling_tpu_torch import ops
    ops.dropout.launches = 0
    ops.layer_norm.launches_fwd = ops.layer_norm.launches_bwd = 0
    ops.flash_attention.launches_fwd = ops.flash_attention.launches_bwd = 0


def phase_train_entry():
    """The training entry point on GPT-2 small: step-0 comparisons, then
    GPT2_STEPS steps of the recipe through train_gpt.train (the main path)."""
    import torch
    from np_modeling_tpu_torch import train_gpt
    from np_modeling_tpu_torch.models import GPT
    cfg = gpt2_config(torch.bfloat16, drop_rate=0.1)
    gpt = GPT(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in gpt.parameters())
    corpus = zipf_corpus(cfg.vocab_size, 64 * GPT2_B, GPT2_S)
    tokens = torch.tensor(corpus[:GPT2_B], device="cuda")
    print(f"(h) GPT-2 small: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads} heads, FFN {cfg.hidden_units}, vocab "
          f"{cfg.vocab_size}, {n_params} params, dropout {cfg.drop_rate}, "
          f"bf16 compute; batch {GPT2_B} x {GPT2_S} tokens; recipe chain("
          f"clip_by_global_norm(1.0), adamw(warmup_cosine(3e-4, 10, "
          f"{GPT2_STEPS})))")

    seed = SEED + 7
    twin = GPT(gpt2_config(None, drop_rate=0.1), device="cuda")
    twin.load_state_dict(gpt.state_dict())
    lk, gk = _step0(twin, tokens, seed, plain=False)
    lp, ref = _step0(twin, tokens, seed, plain=True)
    del twin
    loss_err = abs(lk - lp) / abs(lp)
    errs = {n: _rel(gk[n], ref[n]) for n in ref if not _is_key_bias(n)}
    worst = max(errs, key=errs.get)
    print(f"(h) fp32 step 0 (forward, backward, clip), kernels vs plain, same "
          f"dropout seed: loss {lk:.7f} vs {lp:.7f} (relative err "
          f"{loss_err:.2e}, tol 1e-05); worst gradient relative L2 err "
          f"{errs[worst]:.2e} ({worst}, tol 1e-04)")
    if not (math.isfinite(lk) and loss_err <= 1e-5 and errs[worst] <= 1e-4):
        raise AssertionError("(h) fp32 step 0: kernels differ from plain")
    _check_key_bias("(h) fp32", gk, gk, 1e-4)
    del gk
    lk, gk = _step0(gpt, tokens, seed, plain=False)
    lp, gp = _step0(gpt, tokens, seed, plain=True)
    _hold_bf16("(h)", lk, lp, gk, gp, ref)
    del gk, gp, ref
    torch.cuda.empty_cache()

    _zero_launch_counts()
    t0 = time.perf_counter()
    losses, _ = train_gpt.train(gpt, corpus, GPT2_STEPS, GPT2_B, "cuda",
                                log=lambda line: print(f"(h) {line}"))
    losses = losses.tolist()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    print(f"(h) {GPT2_STEPS} steps of the recipe in {seconds:.1f} s; losses "
          f"{[round(x, 4) for x in losses]}; kernel launches {launches}")
    sites, layers = 2 * cfg.num_layers + 1, cfg.num_layers
    want = {"dropout": 2 * sites * GPT2_STEPS,
            "layer_norm_fwd": sites * GPT2_STEPS,
            "layer_norm_bwd": sites * GPT2_STEPS,
            "flash_attention_fwd": layers * GPT2_STEPS,
            "flash_attention_bwd": layers * GPT2_STEPS}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(h) loss not finite: {losses}")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"(h) loss at step {GPT2_STEPS - 1} "
                             f"({losses[-1]}) not below step 1's "
                             f"({losses[1]})")
    if launches != want:
        raise AssertionError(f"(h) kernel launches {launches}, expected {want}")
    return gpt, corpus, launches


def _device_both(res, tag, name, fn, device_line, plain_fn=None):
    """Device time of kernel and plain version (order plain, kernel, kernel,
    plain), kept beside the CUDA-event times in ``res[name]``."""
    plain_fn = plain_fn or _plain(fn)
    t = [_device_ms(f) for f in (plain_fn, fn, fn, plain_fn)]
    res[name] += (min(t[1], t[2]), min(t[0], t[3]))
    print(f"({tag}) {name}: device time kernel {t[1]:.4f} / {t[2]:.4f} ms, plain "
          f"{t[0]:.4f} / {t[3]:.4f} ms (CUDA events over up to 20 calls "
          f"queued behind a sleep kernel) [{device_line}]")


def _entry_step(gpt, corpus):
    """One step of the entry point's recipe on the corpus's first batch, as
    a call without arguments (the optimizer state carried across calls)."""
    import torch
    from np_modeling_tpu_torch import train_gpt, training
    from np_modeling_tpu_torch.training import data
    opt = train_gpt.recipe(GPT2_STEPS)
    params = dict(gpt.named_parameters())
    box = [opt.init(params)]
    step = training.make_train_step(gpt.loss, lambda loss, _: loss, opt)
    (tokens,) = next(data.prefetch_to_device(
        data.batches([corpus], GPT2_B, seed=SEED), device="cuda"))
    g = torch.Generator().manual_seed(SEED)

    def train_step():
        _, box[0], _ = step(params, box[0], tokens, None, g)

    return train_step


def _kind(kernel):
    """The section of PERF.md's step breakdown that a device op falls in."""
    if "sgemm" in kernel or "gemm_f32f32" in kernel:
        return "fp32 GEMMs (the tied LM head, on CUDA cores)"
    if "flash_" in kernel:
        return "K1 + K2 flash attention"
    if "layer_norm_" in kernel or "dropout<" in kernel:
        return "K8 LayerNorm + K7 dropout"
    if "nvjet" in kernel or "gemm" in kernel:
        return "cuBLAS bf16 GEMMs (projections, FFN)"
    if "copy_kernel" in kernel:
        return "casts and copies"
    return "other elementwise and reductions"


def phase_profile(gpt, corpus, device_line):
    """Where the entry point's step spends the card's time: the step's wall
    time without a profiler (median of 10 after PROFILE_WARMUP), then
    torch.profiler over PROFILE_STEPS steps: device ms a step by kernel and
    by kind, and the device ops a step. The device's idle share of the
    unprofiled step is 1 - busy / wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step = _entry_step(gpt, corpus)
    wall = _cuda_ms(step, runs=10, warmup=PROFILE_WARMUP)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per_kernel[e.key] = (us / 1e3 / PROFILE_STEPS, e.count / PROFILE_STEPS)
    busy = sum(ms for ms, _ in per_kernel.values())
    if not busy > 0:
        print(f"(p) torch.profiler saw no device time; no breakdown "
              f"[{device_line}]")
        return
    ops_per_step = sum(n for _, n in per_kernel.values())
    print(f"(p) entry-point step: {wall:.3f} ms without the profiler (median "
          f"of 10 after {PROFILE_WARMUP}); device busy "
          f"{busy:.3f} ms a step, idle share {1 - busy / wall:.3f}; "
          f"{ops_per_step:.0f} device ops a step [{device_line}]")
    kinds = {}
    for key, (ms, n) in per_kernel.items():
        kind = kinds.setdefault(_kind(key), [0.0, 0.0])
        kind[0] += ms
        kind[1] += n
    for kind, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"(p) {ms:9.3f} ms/step {100 * ms / busy:5.1f}% x {n:6.0f}  "
              f"{kind}")
    for key, (ms, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0]):
        print(f"(p) {ms:9.3f} ms/step x {n:6.1f}  {key[:110]}")


def phase_entry_timings(gpt, corpus, device_line):
    """CUDA-event times (a call's wall time, host included) and device
    times (kernels only) of K8 and K7 and their plain versions, then the
    whole train step. ``res[name]`` = (kernel, plain[, kernel device, plain
    device]) ms."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import fused
    res = {}
    rng = np.random.default_rng(SEED + 8)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda").to(dtype)

    for rows, d in ((8192, 768), (16384, 1024)):
        x, dz = rand(rows, d), rand(rows, d)
        gamma = rand(d, dtype=torch.float32) * 0.1 + 1.0
        beta = rand(d, dtype=torch.float32) * 0.1

        def fwd():
            with torch.no_grad():
                return ops.layer_norm(x, gamma, beta, LN_EPS)

        def bwd():
            return fused.layer_norm_bwd_cuda(x, gamma, dz, LN_EPS)

        def bwd_plain():
            return fused.layer_norm_bwd_plain(x, gamma, dz, LN_EPS)

        for name, k, pl in ((f"layer_norm forward [{rows}, {d}] bf16", fwd,
                             None),
                            (f"layer_norm backward [{rows}, {d}] bf16", bwd,
                             bwd_plain)):
            _both(res, "i", name, k, device_line, plain_fn=pl)
            _device_both(res, "i", name, k, device_line, plain_fn=pl)
    x = rand(GPT2_B, GPT2_S, 768)
    seed = 12345

    def drop():
        with torch.no_grad():
            return ops.dropout(x, seed, 0.1)

    name = f"dropout [{GPT2_B}, {GPT2_S}, 768] bf16 rate 0.1"
    _both(res, "i", name, drop, device_line)
    _device_both(res, "i", name, drop, device_line)
    mask = fused.philox_keep_mask(seed, x.shape, 0.1, x.device)
    given = _cuda_ms(lambda: ops.dropout_with_mask(x, mask, 0.1))
    given_dev = _device_ms(lambda: ops.dropout_with_mask(x, mask, 0.1))
    print(f"(i) {name}: plain with the mask given (no draw): {given:.4f} ms, "
          f"device time {given_dev:.4f} ms [{device_line}]")
    del x, mask

    name = (f"train step (forward, backward, clip, adamw) b{GPT2_B} "
            f"s{GPT2_S} GPT-2 small dropout 0.1 bf16")
    _both(res, "i", name, _entry_step(gpt, corpus), device_line, runs=10,
          warmup=2)
    ms = res[name]
    n_tok = GPT2_B * GPT2_S
    print(f"(i) GPT-2 small train step: kernel {ms[0]:.3f} ms "
          f"({n_tok / ms[0] * 1e3:.0f} tokens/s), plain {ms[1]:.3f} ms "
          f"({n_tok / ms[1] * 1e3:.0f} tokens/s) [{device_line}]")
    return res


def main(phases="abcdefghip"):
    """Runs the phases named in ``phases`` (a, b and c always); the JSON
    summary and the ok line come only from a run of every phase a to i."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    _import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device_line = phase_device()
    phase_build()
    paged_err = phase_paged_vs_plain()
    flash_err = phase_flash_vs_plain()
    fused_err = phase_fused_vs_plain()
    serving = training_res = entry_res = None
    if "d" in phases:
        t0 = time.perf_counter()
        gpt, prompts, paged_launches = phase_engine()
        print(f"(d) serving phase {time.perf_counter() - t0:.1f} s")
        if "e" in phases:
            serving = phase_timings(gpt, prompts, device_line)
        del gpt
        torch.cuda.empty_cache()
    if "f" in phases:
        t0 = time.perf_counter()
        gpt, opt, params, state, tokens, flash_launches = phase_training()
        print(f"(f) training phase {time.perf_counter() - t0:.1f} s")
        if "g" in phases:
            training_res = phase_train_timings(gpt, opt, params, state, tokens,
                                               device_line)
        del gpt, opt, params, state, tokens
        torch.cuda.empty_cache()
    if "h" in phases:
        t0 = time.perf_counter()
        gpt, corpus, entry_launches = phase_train_entry()
        print(f"(h) training entry point phase {time.perf_counter() - t0:.1f} s")
        if "i" in phases:
            entry_res = phase_entry_timings(gpt, corpus, device_line)
        if "p" in phases:
            phase_profile(gpt, corpus, device_line)
        del gpt
        torch.cuda.empty_cache()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s [{device_line}]")
    if serving is None or training_res is None or entry_res is None:
        return 0
    shape = "b4 h8 s4096 d128 causal bf16"
    decode = serving["paged_attention decode b8 ctx512-800 bf16"]
    fwd = training_res[f"flash forward {shape}"]
    bwd = training_res[f"flash backward {shape}"]
    ln_fwd = entry_res["layer_norm forward [16384, 1024] bf16"]
    ln_bwd = entry_res["layer_norm backward [16384, 1024] bf16"]
    drop = entry_res[f"dropout [{GPT2_B}, {GPT2_S}, 768] bf16 rate 0.1"]
    f32, f16 = torch.float32, torch.bfloat16
    # name, source, replaces, launches, (max err fp32, bf16), times
    rows = [
        ("paged_attention", PAGED_SOURCE,
         "np_modeling_tpu/ops/paged_attention.py:221", paged_launches,
         paged_err, decode),
        ("flash_attention_fwd", FLASH_SOURCE,
         "np_modeling_tpu/ops/attention.py:756", flash_launches[0],
         (flash_err[f32][0], flash_err[f16][0]), fwd),
        ("flash_attention_bwd", FLASH_SOURCE,
         "np_modeling_tpu/ops/attention.py:1100", flash_launches[1],
         (flash_err[f32][1], flash_err[f16][1]), bwd)] + [
        (name, FUSED_SOURCE, where, entry_launches[name], fused_err[name], ms)
        for name, where, ms in (
            ("dropout", "np_modeling_tpu/ops/fused.py:310", drop),
            ("layer_norm_fwd", "np_modeling_tpu/ops/fused.py:48", ln_fwd),
            ("layer_norm_bwd", "np_modeling_tpu/ops/fused.py:58", ln_bwd))]
    # "ms": a call's wall time (CUDA events, host included), every entry;
    # "device_ms": calls back to back behind a sleep kernel (device only).
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": where,
         "launches": launches, "max_abs_err": err[0], "max_abs_err_bf16": err[1],
         "ms": ms[0], "plain_ms": ms[1], "device_ms": ms[2],
         "plain_device_ms": ms[3]}
        for name, source, where, launches, err, ms in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
