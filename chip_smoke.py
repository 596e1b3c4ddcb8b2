"""Drives the PyTorch port's serving and training paths once on one CUDA
card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  (a) device: the card's name and power limit, as nvidia-smi reports them;
  (b) build: every kernel of both paths, from the sources in this checkout
      (one nvcc for each source, all started together);
  (c) each kernel vs its plain PyTorch version on the card, at the paths'
      shapes. Paged attention: max abs err <= 1e-4 with fp32 pages,
      <= 2e-2 with bf16 pages. Flash attention (o, lse, dq, dk, dv):
      max abs err <= 1e-4 (fp32) or 2e-2 (bf16) times max(1, max |plain|);
  (d) serving: GPT-2 small (124M) at full width and depth with seeded random
      weights serves 8 requests through add_requests / step_many /
      add_request / step / finish; checks tokens, page accounting, that
      every attention call launched the kernel, and that fp32 greedy tokens
      equal those of the plain version (near-ties printed);
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
      through the kernels: the loss is finite and falls, and K1/K2 each
      launch once a layer a step;
  (g) training timings with CUDA events: flash forward, backward and
      forward+backward at the bench layer shape, and the whole train step.
Each path runs with the launch counts set to 0 just before it and read just
after. The line before the last holds the kernels' JSON summary; the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of JAX and needs no network.
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
F32_TOL, BF16_TOL = 1e-4, 2e-2
# The bench GPT's training shape (bench.py:39): batch, sequence, layers.
TRAIN_B, TRAIN_S, TRAIN_LAYERS = 4, 4096, 4
LAYER_SHAPE = (TRAIN_B, 8, 8, TRAIN_S, TRAIN_S, 128)   # b, hq, hkv, sq, skv, d
NEAR_TIE = 1e-4


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
    libs = cuda_build.build("paged_attention", "flash_attention")
    print(f"(b) build: both libraries in {time.perf_counter() - t0:.2f} s")
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


def gpt2_config(dtype):
    from np_modeling_tpu_torch.models import GPTConfig
    return GPTConfig(vocab_size=50257, d_model=768, num_heads=12, num_layers=12,
                     hidden_units=3072, max_len=1024, activation="gelu",
                     ln_eps=1e-5, dtype=dtype)


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
    streams, _, calls, chunk_calls = run_traffic(eng, prompts)
    launches = ops.paged_attention.launches
    decode_steps = len(calls) - chunk_calls
    for sid in eng.live:
        eng.finish(sid)
    expected = cfg.num_layers * (chunk_calls + decode_steps)
    toks = np.concatenate([np.asarray(s) for s in streams.values()])
    print(f"(d) bf16 run: {len(toks)} tokens, {chunk_calls} prefill chunk calls, "
          f"{decode_steps} decode steps, kernel launches {launches} "
          f"(expected {expected}), free pages {eng.free_pages}/{free0}")
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


def _both(res, tag, name, fn, device_line, runs=25, warmup=3, plain_fn=None):
    """Plain, kernel, kernel, plain; keeps the lower median of each side."""
    from np_modeling_tpu_torch.ops import dispatch

    def forced():
        with dispatch.force_plain():
            return fn()

    plain_fn = plain_fn or forced
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
    both("paged_attention decode b8 ctx512-800 bf16",
         lambda: ops.paged_attention(q, k, v, lens, table))
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
                raise AssertionError(f"(f) {tag}: {name} gradient norm {rel} "
                                     "of wk's, want ~0")


def _compare_fp32(gpt, tokens):
    """fp32 compute: the step through the kernels vs the plain step."""
    lk, gk = _loss_and_grads(gpt, tokens, plain=False)
    lp, gp = _loss_and_grads(gpt, tokens, plain=True)
    loss_err = abs(lk - lp) / abs(lp)
    errs = {n: _rel(gk[n], gp[n]) for n in gp if not _is_key_bias(n)}
    worst = max(errs, key=errs.get)
    return lk, lp, loss_err, errs[worst], worst, gk, gp


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
    from np_modeling_tpu_torch import ops, training
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
    _check_key_bias("fp32 gelu", gk, gk, 1e-4)

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
    loss_err = abs(lk - lp) / abs(lp)
    if not (math.isfinite(lk) and loss_err <= 5e-3):
        raise AssertionError(f"(f) bf16: loss kernel {lk} vs plain {lp}, "
                             f"relative err {loss_err} > 5e-3")
    ratio, ratio_name, spread = 0.0, None, 0.0
    for n in ref:
        if _is_key_bias(n):
            continue
        ek, ep = _rel(gk[n], ref[n]), _rel(gp[n], ref[n])
        spread = max(spread, _rel(gk[n], gp[n]))
        if not ek <= max(2e-2, 1.25 * ep):
            raise AssertionError(f"(f) bf16: {n} gradient {ek:.3e} from the "
                                 f"fp32 step, plain bf16 {ep:.3e}")
        if ek / ep > ratio:
            ratio, ratio_name = ek / ep, n
    _check_key_bias("bf16", gk, ref, 2e-2)
    print(f"(f) bf16 step 0, kernels vs plain: loss {lk:.6f} vs {lp:.6f} "
          f"(relative err {loss_err:.2e}, tol 5e-03); against the fp32 "
          f"step's gradients the kernels' error is at most {ratio:.3f} x the "
          f"plain bf16 step's ({ratio_name}, tol 1.25 x or 2e-02); kernels "
          f"vs plain bf16 differ by at most {spread:.2e} relative L2")
    del gk, gp, ref
    torch.cuda.empty_cache()

    opt = training.adam(1e-3)
    params = dict(gpt.named_parameters())
    state = opt.init(params)
    ops.flash_attention.launches_fwd = ops.flash_attention.launches_bwd = 0
    losses = []
    for _ in range(3):
        loss, state = _train_step(gpt, opt, params, state, tokens)
        losses.append(loss.item())
    launches = (ops.flash_attention.launches_fwd,
                ops.flash_attention.launches_bwd)
    want = cfg.num_layers * len(losses)
    print(f"(f) 3 adam steps through the kernels: losses {losses}; flash "
          f"launches fwd {launches[0]}, bwd {launches[1]} (expected {want})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(f) loss not finite: {losses}")
    if not losses[0] > losses[1] > losses[2]:
        raise AssertionError(f"(f) loss does not fall: {losses}")
    if launches != (want, want):
        raise AssertionError(f"(f) flash launches {launches}, expected "
                             f"{want} each")
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

    _both(res, "g", f"flash forward {shape}", fwd, device_line, runs=20)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_kernel = ops.flash_attention(*leaves, causal=True)
    with dispatch.force_plain():
        o_plain = ops.flash_attention(*leaves, causal=True)

    def bwd(o):
        return lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)

    _both(res, "g", f"flash backward {shape}", bwd(o_kernel), device_line,
          runs=20, plain_fn=bwd(o_plain))
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


def main(phases="abcdefg"):
    """Runs the phases named in ``phases`` (a, b and c always); the JSON
    summary and the ok line come only from a run of every phase."""
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
    serving = training_res = None
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
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s [{device_line}]")
    if serving is None or training_res is None:
        return 0
    shape = "b4 h8 s4096 d128 causal bf16"
    decode = serving["paged_attention decode b8 ctx512-800 bf16"]
    fwd = training_res[f"flash forward {shape}"]
    bwd = training_res[f"flash backward {shape}"]
    f32, f16 = torch.float32, torch.bfloat16
    print(json.dumps({"kernels": [
        {"name": "paged_attention", "route": "cuda", "source": PAGED_SOURCE,
         "replaces": "np_modeling_tpu/ops/paged_attention.py:221",
         "launches": paged_launches, "max_abs_err": paged_err[0],
         "max_abs_err_bf16": paged_err[1], "ms": decode[0],
         "plain_ms": decode[1]},
        {"name": "flash_attention_fwd", "route": "cuda", "source": FLASH_SOURCE,
         "replaces": "np_modeling_tpu/ops/attention.py:756",
         "launches": flash_launches[0], "max_abs_err": flash_err[f32][0],
         "max_abs_err_bf16": flash_err[f16][0], "ms": fwd[0],
         "plain_ms": fwd[1]},
        {"name": "flash_attention_bwd", "route": "cuda", "source": FLASH_SOURCE,
         "replaces": "np_modeling_tpu/ops/attention.py:1100",
         "launches": flash_launches[1], "max_abs_err": flash_err[f32][1],
         "max_abs_err_bf16": flash_err[f16][1], "ms": bwd[0],
         "plain_ms": bwd[1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
