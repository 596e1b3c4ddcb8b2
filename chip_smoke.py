"""Drives the PyTorch port's serving path, its quantized serving path, its
bench training step, its training entry point, that entry point with every
product forced through the matmul kernel, packed-document training,
Gemma-2 serving and Gemma-2 training once on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  (a) device: the card's name and power limit, as nvidia-smi reports them;
  (b) build: every kernel of the six paths, from the sources in this
      checkout (one nvcc for each source, all started together); each
      bf16 flash forward instantiation (K1, K12) and each of K5's bf16 dq
      kernel with its registers and stack (cuobjdump -res-usage) and its
      HGMMA count (cuobjdump -sass): one without HGMMA (not on wgmma)
      fails the run;
  (c) each kernel vs its plain PyTorch version on the card, at the paths'
      shapes. Paged attention: max abs err <= 1e-4 with fp32 pages,
      <= 2e-2 with bf16 pages; with int8 pages (per-token fp32 scales)
      <= 1e-4 with fp32 q, <= 2e-2 with bf16 q. The int8-weight matmul K4
      (bf16 and fp32 x, bf16 and fp32 out, with and without bias, at the
      FFN's decode and prefill shapes and ragged ones, and each of its
      schedules forced through its plan: skinny at m 1..64 with its own
      and forced tiles and cluster splits, wide at m 65..1792 and with
      split-k, simple; the same bits on a second call, the launch counted
      under its schedule): fp32 out max abs err <= 1e-4 times max(1, max
      |plain|), bf16 out within one bf16 ulp (or that bound near 0). Flash attention (o, lse, dq, dk, dv):
      max abs err <= 1e-4 (fp32) or 2e-2 (bf16) times max(1, max |plain|),
      for K1/K2, for K1 with segment ids (packed documents) and K2 or the
      split backward K5 behind it, causal and full, and for K5 without
      them, at the bench shape (b4 h8 s4096 d128), the GPT-2 shape (b8 h12
      s1024 d64) and ragged, GQA and sq != skv shapes; K5's dq, dk and dv
      equal across two runs bit for bit; the dual forward K12, causal and
      full, ragged (1023) included, gives o and lse equal to K1's bit for
      bit. Paged attention at Gemma-2's head_dim 256 (GQA g=2) with fp32,
      bf16 and int8 pages, decode and chunks of 1, 5 and 64 tokens, a
      window inside a page, across pages and past every row, softcap 50,
      and both: the tolerances above, and no table entry outside the band
      of positions a row sees is read. K1/K2, K5 and K12 with Gemma-2's
      options: windows 7, 64, 100 and 4096, softcaps 50 and 2.0 and a
      window with a cap, at head_dim 256 (GQA 8/4; ragged s 1000 and b1
      s8192) and at 64 and 128 (GQA, sq != skv), fp32 and bf16, segment ids
      with a window: the flash tolerances, K5 bit-equal run to run, K12
      with a window bit-equal to K1; and K1 at b1 s8192 d256 with a window
      of 1024 under half the device time of the call without one. Rows
      that no key sees (non-causal, a q segment absent from kv_seg; skv
      ragged at every kv tile width, fp32 and bf16, d 64/128/256): o, lse
      of K1 and dq, dk, dv of K2 and K5 against the plain path within the
      flash tolerances, their o the mean of v over all keys, K12 bit-equal
      to K1 on the same skv.
      LayerNorm K8 (out, dx, dgamma, dbeta): fp32 max abs err <= 1e-5 times
      max(1, max |plain|); a bf16 output within one bf16 ulp (or that fp32
      bound, where a value is so near 0 that fp32 rounding before the last
      cast exceeds its ulp); its backward alone at d 64..8192 and 1..16384
      rows, dx, dgamma and dbeta the same bits on a second call. Dropout K7: the kernel's mask equals the plain
      twin's bit for bit and so do the values, the keep share lies within
      5 sigma of the binomial, the backward drops what the forward dropped,
      another seed or salt draws another mask, rate 0 and eval launch
      nothing. The matmul K11 inside dispatch.force_kernels(), against
      matmul_reference: the GPT-2 step's 9 products (forward with bias,
      the trans_a weight gradient, the trans_b input gradient) in bf16
      (bf16 and fp32 out) and fp32, ragged shapes with every trans pair,
      mixed operands; K4's criteria; bf16 through the TMA variant, the
      ragged one (matmul.launches_ragged counts it) and split-k (the same
      bits on a second run), each schedule at least once; float16 raises. Softmax-CE K9,
      forward and backward, at the step's logits [8192, 50257] fp32/bf16
      and ragged shapes with labels outside [0, v): ce within 1e-5 x
      max(1, max |plain|), dlogits within 1e-4 x |plain| + 1e-6 x max
      |plain| (bf16: one ulp). Stochastic int8 K10 at [8192, 768],
      [1792, 12, 64] and ragged shapes, fp32/bf16: values and scales equal
      the plain twin's bit for bit, each value floor or floor + 1 of x /
      scale; unbiased over 256 seeds; another seed draws other bits;
  (d) serving: GPT-2 small (124M) at full width and depth with seeded random
      weights serves 8 requests through add_requests / step_many /
      add_request / step / finish; checks tokens, page accounting, that
      every attention call launched the kernel and every LayerNorm K8, and
      that fp32 greedy tokens equal those of the plain version (near-ties
      printed);
  (e) serving timings with CUDA events (median of >= 20 runs after warm-up);
  (j) quantized serving: (d)'s GPT-2 small with its FFN weights quantized
      to int8 (quantize_params_int8 -> params_from_numpy) and int8 KV pages
      (quantize_kv=True), bf16 compute, on (d)'s traffic; checks tokens,
      pages, that every FFN product launched K4 (24 a forward; its decode
      steps on K4's skinny schedule, its prefill chunks on wide), every
      attention call the int8-page kernel (12 a forward) and every
      LayerNorm K8 (25 a forward), and that fp32 greedy tokens equal those
      of the plain version (near-ties printed);
  (k) quantized serving timings: K4 at the decode and prefill shapes
      beside dequantize + torch.mm and torch.mm with bf16 weights (also in
      rounds of torch.mm, K4, K4, torch.mm),
      int8-page decode beside bf16-page decode, and the quantized engine's
      prefill and decode beside (e)'s bf16 engine (a report, not a check);
  (f) training: the bench GPT (bench.py: 4 layers, d 1024, 8 heads, FFN
      4096, vocab 8192, batch 4 x 4096 tokens, bf16 compute, fused loss) at
      full width. Step 0 through the kernels against the same step with the
      plain attention, on the same weights, with gelu in place of relu
      (relu's kink makes fp32 gradients of two correct versions differ by
      ~1e-3, and the bf16 criterion flip from process to process): in fp32
      (loss within 1e-5 relative, each gradient's relative L2 error <=
      1e-4); in bf16 (loss within 5e-3 relative, each gradient no further
      from the fp32 step's than 1.25x the plain bf16 step's own distance,
      or 2e-2). Then 3 steps of adam(1e-3) on one seeded batch
      through the kernels: the loss is finite and falls, K1/K2 each
      launch once a layer a step and K8 once a LayerNorm a step each way;
  (g) training timings with CUDA events: flash forward, backward and
      forward+backward at the bench layer shape (K1 and SDPA's forward, K2
      and SDPA's autograd backward, also in AB_ROUNDS rounds of SDPA, K,
      K, SDPA), and the whole train step;
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
      and [16384, 1024] (the backward also in rounds of F.layer_norm's
      autograd backward, K8, K8, F.layer_norm) and dropout at [8, 1024,
      768] (bf16), and the whole GPT-2 small train step;
  (l) the forced training path: (h)'s GPT-2 small run under
      dispatch.force_kernels(), so every Linear's forward, dx and dw runs
      K11. Step 0 forced against the default step (cuBLAS products) with
      the same dropout seed, by (h)'s criteria; then FORCED_STEPS steps of
      train_gpt.train: the loss is finite and falls, K11 launches 216
      times a step. On the trained model's logits K9 (forward, backward)
      against softmax_cross_entropy_with_integer_labels; K10 on its final
      hidden states against its plain twin;
  (m) K11 at the step's 9 product shapes (kernel, plain, cuBLAS; K11 and
      cuBLAS also in rounds of cuBLAS, K11, K11, cuBLAS) and their sum
      over a step's 216 products, K11 at 8192^3 bf16 in turns with
      torch.mm,
      K9 forward and backward beside F.cross_entropy, K10 (no library
      call), and the forced step beside the default step;
  (n) packed-document training: (h)'s GPT-2 small run on documents of
      seeded Zipf tokens (lengths geometric, mean 256, clipped to [8,
      1024]) packed in order into rows of 1024, the last document of a row
      cut at its end; segment ids number a row's documents and positions
      restart at 0 in each; data.epochs -> a dict a batch ->
      prefetch_to_device -> make_train_step over GPT.loss(tokens,
      segment_ids=, positions=). Isolation (eval, fp32, kernels): each
      document's logits in its packed row equal its own alone to 1e-4 x
      max(1, max |logit|). Step 0 with K1 + K2 and with K1 + K5
      (FUSED_BWD=False) against the plain step, same dropout seed, by (h)'s
      criteria. (h)'s unpacked step 0 with FWD_DUAL_KV=True: loss equal to
      the K1 step's bit for bit, 12 K12 launches, no K1. Then 20 steps with
      FUSED_BWD=False: the loss is finite and lower at step 19 than at step
      1, and each step launches K1 12 times, K5 12 times and K2 never;
  (o) K5 (and, by torch.profiler, its dq and dk/dv kernels) beside K2 and
      F.scaled_dot_product_attention's autograd backward, at the bench
      shape and the packed GPT-2 shape; K12 beside K1 and SDPA forward at
      the bench shape; K1/K2 with segment ids beside without (SDPA with the
      documents' boolean mask as yardstick); the packed step (K2, K5)
      beside (h)'s unpacked step. K2 against K5, kernel and step, K12
      against K1 and against SDPA, and K1 with segment ids against SDPA
      with the mask run AB_ROUNDS rounds of a, b, b, a and report medians
      and ranges;
  (p) where the entry point's step spends the card's time: torch.profiler
      over 3 steps, device time by kernel and by kind, device ops a step
      and the card's idle share (PERF.md, "Where the time goes"); a
      report, not a check: if the profiler sees no device time, it says so
      and the run goes on;
  (q) Gemma-2 2B serving (google/gemma-2-2b's config: 26 layers, d 2304,
      8 heads over 4 kv heads of 256, geglu FFN 9216, vocab 256000, RoPE,
      RMSNorm, sandwich norms, a window of 4096 on even layers, softcaps 50
      and 30) at full width and depth with seeded random weights, bf16
      compute and pages, 8 slots, page 16, chunk 256: 6 prompts of
      128..1024 tokens and one of 4,600 in one batched prefill, then 16
      decode steps. K3 launches 26 times a forward (13 with the window) and
      no other kernel does; bf16 last-position logits within 1.25 x the
      plain bf16 engine's distance from the fp32 engine's plus 1e-2 x
      max(1, max |logit|); fp32 greedy tokens equal the plain engine's
      (near-ties printed); each first token is the argmax of GPT.apply's
      last logits under force_plain(), within 1e-3 x max(1, max |logit|);
  (r) Gemma-2 timings: the engine's prefill ms and decode tokens/s, the
      decode profiled by kind (as (p)), K3 at that decode on the engine's
      pages for a local and a global layer beside its bound, and K3 on 8
      sequences of 1024 and 4096 tokens (a report, not a check);
  (s) Gemma-2 2B training at full width, depth cut to 12 layers (6 local,
      6 global) for memory, bf16 compute: step 0 through K1 + K2 and
      through K1 + K5 against the plain step, in fp32 at 2 layers on 5,120
      tokens and in bf16 at 4 layers on 8,192, by (h)'s criteria; then 10
      steps of train_gpt.train on seeded Zipf rows of 8,192 tokens, batch
      1: the loss is finite and falls, each step launches K1 and K2 12
      times (6 with the window) and K12 and K5 never; peak memory printed;
  (t) Gemma-2 training timings: K1, K2 and K5 at b1 hq8 hkv4 s8192 d256
      softcap 50 for a local layer (window 4096) and a global one beside
      their bounds (in-band pairs), the plain version and compiled
      flex_attention with the same softcap and band (the library call;
      its forward and K1, its backward and K2 also in rounds of flex, K,
      K, flex), K12 beside K1 without the cap and compiled flex_attention
      without a score_mod (its library call; K12 against K1 and against
      it in rounds), SDPA without cap or window beside as
      another function, and the 12-layer step in ms and tokens/s,
      profiled by kind (a report, not a check).
Each path runs with the launch counts set to 0 just before it and read just
after. Library yardsticks (one PyTorch call computing a kernel's function,
which the port never calls) are timed beside K1/K2/K5/K12 (scaled_dot_
product_attention; with window and softcap, compiled flex_attention), K7
(F.dropout), K8 (F.layer_norm), K9 (F.cross_entropy) and K11 (torch.addmm /
torch.mm); no single call computes K3, K4 or K10. Timings run each side twice, in the order plain, kernel, kernel,
plain. K5's bound is the gradients' work, K2's 5 products a pair, not
the 7 of its schedule. Every kernel is timed with CUDA events two ways: a call's wall time,
the host's share included (the JSON line's "ms"), and device time, calls
queued back to back behind a sleep kernel so the host's gaps drop out
("device_ms"). The line before the last holds the kernels' JSON summary;
the last line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}. It imports nothing of JAX and needs no network.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
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
INT8_SOURCE = "np_modeling_tpu_torch/csrc/int8_matmul.cu"
MATMUL_SOURCE = "np_modeling_tpu_torch/csrc/matmul.cu"
QUANT_SOURCE = "np_modeling_tpu_torch/csrc/quantize.cu"
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
# The quantized serving path: FFN-only int8 weights (bench.py's match).
FFN_MATCH = r".*(dense1/linear/w|dense2/w)$"
# GPT-2 small's FFN products [m, k] x [k, n] on the serving path: a decode
# step (8 slots) and a prefill chunk call of 7 sequences x 256 tokens.
K4_SHAPES = ((8, 768, 3072), (8, 3072, 768), (1792, 768, 3072),
             (1792, 3072, 768))
# The GPT-2 small train step's products (m = 8 x 1024 tokens) [m, k] x [k,
# n] with (trans_a, trans_b, bias): each Linear's forward (with bias), its
# weight gradient x^T dy (trans_a) and its input gradient dy w^T (trans_b),
# for the attention projections (768 -> 768) and the FFN (768 -> 3072 ->
# 768). A layer runs the first row 4 times and the others once a pass.
STEP_PRODUCTS = (
    (8192, 768, 768, False, False, True), (8192, 768, 3072, False, False, True),
    (8192, 3072, 768, False, False, True), (768, 8192, 768, True, False, False),
    (768, 8192, 3072, True, False, False), (3072, 8192, 768, True, False, False),
    (8192, 768, 768, False, True, False), (8192, 3072, 768, False, True, False),
    (8192, 768, 3072, False, True, False))
# Uses of each STEP_PRODUCTS row in one layer's pass (q, k, v, o share 768 ->
# 768).
STEP_USES = (4, 1, 1, 4, 1, 1, 4, 1, 1)
# Phase (l): forced steps of the recipe.
FORCED_STEPS = 10
# Phase (n): packed documents, lengths geometric with this mean, clipped to
# [DOC_MIN, GPT2_S]; the GPT-2 attention shape (b, hq, hkv, sq, skv, d).
DOC_MEAN, DOC_MIN = 256, 8
GPT2_LAYER = (GPT2_B, 12, 12, GPT2_S, GPT2_S, 64)
# Phase (q): Gemma-2 2B serving (google/gemma-2-2b's config.json as
# np_modeling_tpu/utils/hf_compat.py:1363-1408 maps it): local layers' window,
# score scale query_pre_attn_scalar ** -0.5; the engine's slots, page size,
# prefill chunk and pages; 6 prompts of 128..1024 tokens and one of
# GEMMA_LONG, past the window; decode steps after them.
GEMMA_WINDOW, GEMMA_SCALE = 4096, 256.0 ** -0.5
GEMMA_SLOTS, GEMMA_PAGE, GEMMA_CHUNK, GEMMA_PAGES = 8, 16, 256, 1024
GEMMA_LONG, GEMMA_DECODE = 4600, 16
# Phase (s): Gemma-2 2B training at full width, its depth cut to
# GEMMA_TRAIN_LAYERS (6 local, 6 global: 26 layers do not fit the card with
# the port's optimizer state), batch 1 x GEMMA_TRAIN_S tokens (Gemma-2's
# context, past the window), GEMMA_TRAIN_STEPS steps on GEMMA_TRAIN_ROWS
# seeded Zipf rows; step 0 in fp32 at 2 layers on GEMMA_F32_S tokens (the
# window still cuts rows 4096.. and the fp32 head fits) and in bf16 at
# GEMMA_BF16_LAYERS layers on GEMMA_TRAIN_S tokens. GEMMA_LAYER: its
# attention shape (b, hq, hkv, sq, skv, d); GEMMA_CAP: the attention softcap.
GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_S, GEMMA_TRAIN_STEPS = 12, 8192, 10
GEMMA_TRAIN_ROWS, GEMMA_F32_S, GEMMA_BF16_LAYERS = 16, 5120, 4
GEMMA_LAYER = (1, 8, 4, GEMMA_TRAIN_S, GEMMA_TRAIN_S, 256)
GEMMA_CAP = 50.0
# (c): K1 at GEMMA_LAYER with this window must take under half the device
# time of the same call without one (tiles outside the band are skipped).
BAND_WINDOW = 1024
# (q): the bf16 engine's last-position logits against the fp32 engine's: at
# most 1.25 x the plain bf16 engine's distance plus this share of max(1,
# max |fp32 logit|).
GEMMA_BF16_SLACK = 1e-2
# One H100 SXM (NVIDIA's data sheet): device-memory bytes/s, dense bf16
# tensor-core operations/s. A bound is the larger of bytes / the first and
# operations / the second.
PEAK_BYTES_S, PEAK_BF16_S = 3.35e12, 989e12


def _bound(nbytes, flops):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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
    libs = cuda_build.build("paged_attention", "flash_attention", "fused",
                            "int8_matmul", "matmul", "quantize")
    print(f"(b) build: all six libraries in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"(b) {name}: nvcc {lib.build_seconds:.2f} s -> {lib.path.name}")
        for ln in lib.log.splitlines():
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
                print(f"    ptxas: {ln.strip()}")
    check_forward_sass(libs["flash_attention"].path,
                       libs["flash_attention"].log)


def _fwd_variant(mangled):
    """(d, halves, options) of a bf16 forward entry's mangled name, (d, 0,
    options) of K5's bf16 dq kernel's, or None."""
    import re
    hit = re.search(r"flash_fwd_bf16ILi(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if hit is not None:
        return tuple(int(x) for x in hit.groups())
    hit = re.search(r"flash_bwd_dq_bf16ILi(\d+)ELi(\d+)E", mangled)
    return None if hit is None else (int(hit.group(1)), 0,
                                     int(hit.group(2)))


def check_forward_sass(lib_path, log):
    """Each bf16 forward instantiation (K1, K12) and each of K5's bf16 dq
    kernel in the built flash library:
    its registers and local memory (spills) from cuobjdump -res-usage, HGMMA
    (wgmma) in its SASS, and whether ptxas serialized its wgmma (C7514 in the
    build's ``log``, a loss of speed, reported); fails where an instantiation
    has no HGMMA, so that a forward or dq kernel built on mma.sync cannot
    pass."""
    import re
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME, "bin", "cuobjdump")
    usage = subprocess.run([tool, "-res-usage", str(lib_path)],
                           capture_output=True, text=True, check=True,
                           timeout=300).stdout
    regs, names = {}, []
    lines = usage.splitlines()
    for i, ln in enumerate(lines):
        key = _fwd_variant(ln) if "Function" in ln else None
        if key is not None and i + 1 < len(lines):
            names.append(re.search(r"(_Z\w+)", ln).group(1))
            regs[key] = " ".join(f for f in lines[i + 1].split()
                                 if f.startswith(("REG:", "STACK:", "LOCAL:",
                                                  "SHARED:")))
    # The SASS of the forward functions alone (the whole library's takes
    # tens of seconds to print).
    sass = subprocess.run([tool, "-sass", "-fun", ",".join(names),
                           str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout if names else ""
    hgmma = {}
    for part in sass.split("Function : ")[1:]:
        key = _fwd_variant(part.split("\n", 1)[0])
        if key is not None:
            hgmma[key] = part.count("HGMMA")
    serialized = {_fwd_variant(ln) for ln in log.splitlines() if "C7514" in ln}
    want = {(d, h, o) for d in (64, 128, 256) for o in range(8)
            for h in (0, 1)}
    want |= {(d, 2, o) for d in (64, 128, 256) for o in (0, 2)}
    for key in sorted(want):
        d, halves, opt = key
        kind = {0: "K5 dq", 1: "forward K1", 2: "forward K12"}[halves]
        print(f"(b) {kind} d{d} options "
              f"{opt} (seg 1, window 2, softcap 4): {regs.get(key, 'no usage')}"
              f", {hgmma.get(key, 0)} HGMMA in its SASS"
              f"{', wgmma serialized by ptxas (C7514)' if key in serialized else ''}")
    missing = sorted(k for k in want if not hgmma.get(k))
    if missing:
        raise AssertionError(f"(b) bf16 forward or K5 dq instantiations "
                             f"without HGMMA (wgmma) in their SASS: {missing}")
    print(f"(b) all {len(want)} bf16 forward (K1, K12) and K5 dq "
          f"instantiations run on wgmma")


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


def _int8_pages(k, v):
    """fp32 pages -> int8 pages and the kwargs with their per-token scales
    (ops.quantize_int8, as the int8 KV cache stores them)."""
    from np_modeling_tpu_torch import ops
    kq, vq = ops.quantize_int8(k), ops.quantize_int8(v)
    return kq.values, vq.values, {"k_scales": kq.scales,
                                  "v_scales": vq.scales}


def phase_paged_vs_plain(int8=False):
    """Paged kernel vs plain on the card, with fp32/bf16 pages or (``int8``)
    int8 pages and fp32 q or bf16 q; returns (max err fp32, bf16) by q's
    dtype with int8 pages, by the pages' dtype otherwise."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    rng = np.random.default_rng(SEED)
    what = "paged int8 pages" if int8 else "paged"
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
                        len(lengths), sq, hq, hkv, d, psize, lengths,
                        torch.float32 if int8 else dtype, rng)
                    kw = {}
                    if int8:
                        q = q.to(dtype)
                        k, v, kw = _int8_pages(k, v)
                    got = ops.paged_attention(q, k, v, lens, table, **kw)
                    with dispatch.force_plain():
                        want = ops.paged_attention(q, k, v, lens, table, **kw)
                    # Past ceil(length/psize) the kernel must read nothing:
                    # poisoned tail entries may not change its output.
                    poisoned = table.clone()
                    for i, ln in enumerate(lengths):
                        poisoned[i, -(-ln // psize):] = 2 ** 30
                    again = ops.paged_attention(q, k, v, lens, poisoned, **kw)
                    torch.cuda.synchronize()
                    live = lens > 0
                    err = (got[live].float() - want[live].float()).abs().max().item()
                    tol = _tol(dtype)
                    tag = (f"{what} hq{hq}/hkv{hkv}/d{d} sq={sq} ps={psize} "
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
    print(f"(c) {what}: {n} cases pass: max abs err fp32 {errs[torch.float32]:.3e} "
          f"(tol {F32_TOL}), bf16 {errs[torch.bfloat16]:.3e} (tol {BF16_TOL})")
    return errs[torch.float32], errs[torch.bfloat16]


def phase_paged_options_vs_plain():
    """K3's Gemma-2 options vs the plain version: head_dim 256, GQA g=2, in
    fp32, bf16 and int8 pages (int8 with fp32 q and with bf16 q), decode and
    chunked append (sq 1, 5 and 64), with a window below a page (7), across
    pages (37) and past every row (GEMMA_WINDOW), softcap 50, and both; the
    tolerances of the cases above. Table entries past the length and below
    the band of the first row are poisoned: the kernel must read neither.
    Returns (max err fp32, bf16) by q's dtype."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    rng = np.random.default_rng(SEED + 3)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n, psize = 0, GEMMA_PAGE
    options = (dict(window=7), dict(window=37), dict(window=GEMMA_WINDOW),
               dict(softcap=50.0), dict(softcap=50.0, window=37),
               dict(softcap=50.0, window=7, scale=GEMMA_SCALE))
    for sq in (None, 1, 5, 64):
        rows = sq or 1
        lengths = [rows, psize * -(-rows // psize), rows + 45,
                   int(rng.integers(rows + 300, rows + 900))]
        if rows == 1:
            lengths.append(0)
        for pages in ("float32", "bfloat16", "int8 fp32 q", "int8 bf16 q"):
            dtype = torch.bfloat16 if "bfloat16" in pages or "bf16" in pages \
                else torch.float32
            int8 = pages.startswith("int8")
            q, k, v, lens, table = _pa_inputs(
                len(lengths), sq, 8, 4, 256, psize, lengths,
                torch.float32 if int8 else dtype, rng)
            kw = {}
            if int8:
                q = q.to(dtype)
                k, v, kw = _int8_pages(k, v)
            for opts in options:
                got = ops.paged_attention(q, k, v, lens, table, **kw, **opts)
                with dispatch.force_plain():
                    want = ops.paged_attention(q, k, v, lens, table, **kw,
                                               **opts)
                poisoned = table.clone()
                window = opts.get("window", 1 << 30)
                for i, ln in enumerate(lengths):
                    poisoned[i, -(-ln // psize):] = 2 ** 30
                    poisoned[i, :max(0, ln - rows - window + 1) // psize] = \
                        2 ** 30
                again = ops.paged_attention(q, k, v, lens, poisoned, **kw,
                                            **opts)
                torch.cuda.synchronize()
                live = lens > 0
                err = (got[live].float() - want[live].float()).abs().max().item()
                tol = _tol(dtype)
                tag = (f"paged d256 hq8/hkv4 sq={sq} ps={psize} {pages} pages "
                       f"{opts} lengths={lengths}")
                if not err <= tol:
                    raise AssertionError(f"(c) {tag}: max abs err {err} > {tol}")
                if not torch.equal(got, again):
                    raise AssertionError(f"(c) {tag}: output depends on table "
                                         "entries outside the band")
                if not bool((got[~live] == 0).all()):
                    raise AssertionError(f"(c) {tag}: length-0 row not 0")
                errs[dtype] = max(errs[dtype], err)
                n += 1
                print(f"(c) {tag}: max abs err {err:.3e}")
    print(f"(c) paged d256 window/softcap: {n} cases pass: max abs err fp32 "
          f"{errs[torch.float32]:.3e} (tol {F32_TOL}), bf16 "
          f"{errs[torch.bfloat16]:.3e} (tol {BF16_TOL})")
    return errs[torch.float32], errs[torch.bfloat16]


def _flash_inputs(shape, dtype, rng):
    import torch
    b, hq, hkv, sq, skv, d = shape
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device="cuda").to(dtype)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                      (b, hq, sq, d))]


def _flash_fwd_bwd(q, k, v, do, causal, plain, **kw):
    """o, dq, dk, dv through ops.flash_attention (kernels or plain)."""
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    with dispatch.force_plain() if plain else contextlib.nullcontext():
        o = ops.flash_attention(*leaves, causal=causal, **kw)
        o.backward(do)
    return [o.detach()] + [x.grad for x in leaves]


@contextlib.contextmanager
def _schedule(fused_bwd=True, dual=False):
    """The flash schedule flags (JAX's FUSED_BWD, FWD_DUAL_KV) in a scope."""
    from np_modeling_tpu_torch.ops import attention
    saved = attention.FUSED_BWD, attention.FWD_DUAL_KV
    attention.FUSED_BWD, attention.FWD_DUAL_KV = fused_bwd, dual
    try:
        yield
    finally:
        attention.FUSED_BWD, attention.FWD_DUAL_KV = saved


def pack_rows(rng, rows, seq):
    """Documents packed in order into ``rows`` rows of ``seq``: lengths
    geometric with mean DOC_MEAN, clipped to [DOC_MIN, seq]; a row's last
    document is cut at its end. Returns segment ids (a row's documents
    numbered from 0) and positions (0 at each document's start), int32."""
    seg = np.empty((rows, seq), np.int32)
    pos = np.empty((rows, seq), np.int32)
    for r in range(rows):
        start = doc = 0
        while start < seq:
            n = int(np.clip(rng.geometric(1.0 / DOC_MEAN), DOC_MIN, seq))
            n = min(n, seq - start)
            seg[r, start:start + n] = doc
            pos[r, start:start + n] = np.arange(n)
            start, doc = start + n, doc + 1
    return seg, pos


def _doc_pairs(seg, causal=True):
    """(q, k) pairs that attend within a document, summed over rows."""
    lens = np.concatenate([np.unique(r, return_counts=True)[1] for r in seg])
    return int((lens * (lens + 1) // 2).sum() if causal else (lens ** 2).sum())


def _hold(tag, names, got, want, dtype, errs):
    """Each of ``got`` within _tol(dtype) x max(1, max |want|) of ``want``;
    returns the printed line and keeps the worst error in ``errs``."""
    line = []
    for name, x, y in zip(names, got, want):
        err = (x.float() - y.float()).abs().max().item()
        bound = _tol(dtype) * max(1.0, y.float().abs().max().item())
        if not err <= bound:
            raise AssertionError(f"(c) {tag}: {name} max abs err {err} > "
                                 f"{bound}")
        errs[dtype] = max(errs[dtype], err)
        line.append(f"{name} {err:.2e}/{bound:.1e}")
    return ", ".join(line)


def _hold_no_key_lse(tag, lse, want, none, dtype, errs):
    """lse on rows that see a key within _tol(dtype) x max(1, max |want|)
    over those rows; on the rows ``none`` [b, sq] that see no key, equal
    to the plain lse (mask + log(skv) rounds to the mask value in fp32)."""
    import torch
    none = none[:, None, :].expand(lse.shape)
    keyed = want[~none].float()
    err = (lse[~none].float() - keyed).abs().max().item()
    bound = _tol(dtype) * max(1.0, keyed.abs().max().item())
    if not err <= bound:
        raise AssertionError(f"(c) {tag}: lse max abs err {err} > {bound} on "
                             "rows with keys")
    if not torch.equal(lse[none], want[none]):
        raise AssertionError(f"(c) {tag}: lse on rows without a key differs "
                             "from the plain lse")
    errs[dtype] = max(errs[dtype], err)
    return f"lse {err:.2e}/{bound:.1e} (rows without a key: equal)"


def phase_flash_schedules_vs_plain():
    """K1/K2 with segment ids, the split backward K5 and the dual forward
    K12 against the plain version on the card: o, lse, dq, dk, dv within
    the flash tolerances; K5's dq, dk, dv equal across two runs bit for
    bit; K12's o and lse equal K1's bit for bit. Segment ids are packed
    documents (pack_rows); q's ids are kv's first sq, so every q row has a
    key of its own document. Returns the max abs errors {"segments",
    "split", "dual"} -> (fp32, bf16)."""
    import torch
    from np_modeling_tpu_torch.ops import attention
    rng = np.random.default_rng(SEED + 21)
    f32, f16 = torch.float32, torch.bfloat16
    errs = {key: {f32: 0.0, f16: 0.0} for key in ("segments", "split",
                                                  "dual")}
    ragged, sq_ne = (2, 8, 2, 1000, 1000, 64), (1, 4, 4, 300, 700, 128)
    # (shape, causal, dtype, segment ids, split backward)
    cases = [(shape, causal, dtype, True, split)
             for shape, dtype in ((GPT2_LAYER, f16), (LAYER_SHAPE, f16),
                                  (ragged, f32), (ragged, f16))
             for causal in (True, False) for split in (False, True)]
    cases += [(sq_ne, causal, f32, True, True) for causal in (True, False)]
    cases += [(shape, causal, dtype, False, True)
              for shape, dtype in ((GPT2_LAYER, f16), (LAYER_SHAPE, f16),
                                   (ragged, f32), (ragged, f16))
              for causal in (True, False)]
    n_bits = 0
    for shape, causal, dtype, segments, split in cases:
        q, k, v, do = _flash_inputs(shape, dtype, rng)
        kw = {}
        q_seg = kv_seg = None
        if segments:
            kv_seg = torch.tensor(pack_rows(rng, shape[0], shape[4])[0],
                                  device="cuda")
            q_seg = kv_seg[:, :shape[3]]
            kw = {"segment_ids": (q_seg, kv_seg)}
        scale = 1.0 / math.sqrt(shape[-1])
        with _schedule(fused_bwd=not split):
            got = _flash_fwd_bwd(q, k, v, do, causal, False, **kw)
            again = (_flash_fwd_bwd(q, k, v, do, causal, False, **kw)
                     if split else None)
        want = _flash_fwd_bwd(q, k, v, do, causal, True, **kw)
        got.insert(1, attention._flash_fwd_cuda(q, k, v, causal, scale, True,
                                                q_seg, kv_seg)[1])
        want.insert(1, attention._attn_fwd_plain(
            q, k, v, attention._merge_seg_into_mask(None, q_seg, kv_seg),
            None, causal, None, scale)[1])
        torch.cuda.synchronize()
        tag = (f"flash {'K1+K5' if split else 'K1+K2'}"
               f"{' segments' if segments else ''} {shape} causal={causal} "
               f"{str(dtype)[6:]}")
        # K1 without segment ids is held by phase_flash_vs_plain already.
        line = _hold(tag, ("o", "lse"), got[:2], want[:2], dtype,
                     errs["segments"] if segments else {f32: 0.0, f16: 0.0})
        line += ", " + _hold(tag, ("dq", "dk", "dv"), got[2:], want[2:], dtype,
                             errs["split" if split else "segments"])
        if split:
            if not all(torch.equal(x, y) for x, y in zip(got[2:], again[1:])):
                raise AssertionError(f"(c) {tag}: K5's dq/dk/dv differ "
                                     "between two runs")
            n_bits += 1
        print(f"(c) {tag}: max abs err / bound: {line}"
              f"{'; dq, dk, dv bit-equal across two runs' if split else ''}")
        del q, k, v, do, got, want, again
    dual_cases = [(shape, causal, dtype)
                  for shape, dtype in ((LAYER_SHAPE, f16), (GPT2_LAYER, f16),
                                       (ragged, f32))
                  for causal in (True, False)]
    dual_cases += [((1, 12, 12, GPT2_S - 1, GPT2_S - 1, 64), True, f16),
                   ((1, 4, 4, 700, 700, 128), True, f32)]
    for shape, causal, dtype in dual_cases:
        q, k, v, _ = _flash_inputs(shape, dtype, rng)
        scale = 1.0 / math.sqrt(shape[-1])
        single = attention._flash_fwd_cuda(q, k, v, causal, scale, True)
        dual = attention._flash_fwd_cuda(q, k, v, causal, scale, True,
                                         dual=True)
        want = attention._attn_fwd_plain(q, k, v, None, None, causal, None,
                                         scale)
        torch.cuda.synchronize()
        tag = f"flash K12 {shape} causal={causal} {str(dtype)[6:]}"
        if not (torch.equal(single[0], dual[0])
                and torch.equal(single[1], dual[1])):
            raise AssertionError(f"(c) {tag}: o/lse differ from K1's")
        line = _hold(tag, ("o", "lse"), dual, want, dtype, errs["dual"])
        print(f"(c) {tag}: o and lse equal K1's bit for bit; vs plain "
              f"{line}")
        del q, k, v, single, dual, want
    torch.cuda.empty_cache()
    out = {key: (e[f32], e[f16]) for key, e in errs.items()}
    print(f"(c) flash schedules: {len(cases)} K1/K2/K5 cases and "
          f"{len(dual_cases)} K12 cases pass, K5 repeatable in {n_bits}; max "
          f"abs err (fp32, bf16): {out}")
    return out


def _band_pairs(s_len, window):
    """(q, k) pairs of one head a causal window keeps over s_len rows."""
    if window is None or window >= s_len:
        return s_len * (s_len + 1) // 2
    return window * (window + 1) // 2 + (s_len - window) * window


def phase_flash_options_vs_plain():
    """K1/K2, K5 and K12 with Gemma-2's options against the plain version on
    the card: windows of 7 (inside a tile), 64 (a tile's edge), 100 (across
    tiles) and 4096 (past every row at s 1000; cutting at s 8192), softcaps
    50 and 2.0 (one that bites) and a window with a cap, at head_dim 256
    (GQA 8/4, ragged s 1000 and Gemma-2's own b1 s8192) and 64 and 128
    (GQA, sq != skv), fp32 and bf16, with segment ids and a window; o, lse,
    dq, dk, dv within the flash tolerances; K5 repeatable bit for bit; K12
    with a window equal to K1 bit for bit. Then the band check: K1 at
    GEMMA_LAYER with a window of BAND_WINDOW under half the device time of
    the call without one. Returns the max abs errors of the head_dim 256
    cases {"fwd", "bwd"} -> (fp32, bf16)."""
    import torch
    from np_modeling_tpu_torch.ops import attention
    rng = np.random.default_rng(SEED + 24)
    f32, f16 = torch.float32, torch.bfloat16
    errs = {key: {f32: 0.0, f16: 0.0} for key in ("fwd", "bwd")}
    opts = {"w7": dict(window=7), "w64": dict(window=64),
            "w100": dict(window=100), "w4096": dict(window=4096),
            "cap50": dict(softcap=GEMMA_CAP), "cap2": dict(softcap=2.0),
            "w100+cap2": dict(window=100, softcap=2.0)}
    d256 = (1, 8, 4, 1000, 1000, 256)
    # (shape, options, dtype, segment ids, split backward)
    cases = [(d256, o, dtype, False, split) for dtype in (f32, f16)
             for o in opts for split in (False, True)]
    cases += [(shape, o, dtype, False, split)
              for shape in ((2, 8, 2, 1000, 1000, 64), (1, 4, 4, 300, 700, 128))
              for o in ("w7", "w100", "cap2", "w100+cap2")
              for dtype in (f32, f16) for split in (False, True)]
    cases += [((2, 8, 4, 1000, 1000, 256), o, dtype, True, split)
              for o in ("w100", "w100+cap2") for dtype in (f32, f16)
              for split in (False, True)]
    opts["local"] = dict(window=GEMMA_WINDOW, softcap=GEMMA_CAP)
    opts["global"] = dict(softcap=GEMMA_CAP)
    cases += [(GEMMA_LAYER, o, f16, False, split) for o in ("local", "global")
              for split in (False, True)]
    t0 = time.perf_counter()
    for shape, name, dtype, segments, split in cases:
        q, k, v, do = _flash_inputs(shape, dtype, rng)
        kw = dict(opts[name])
        q_seg = kv_seg = None
        if segments:
            kv_seg = torch.tensor(pack_rows(rng, shape[0], shape[4])[0],
                                  device="cuda")
            q_seg = kv_seg[:, :shape[3]]
            kw["segment_ids"] = (q_seg, kv_seg)
        scale = 1.0 / math.sqrt(shape[-1])
        with _schedule(fused_bwd=not split):
            got = _flash_fwd_bwd(q, k, v, do, True, False, **kw)
            again = (_flash_fwd_bwd(q, k, v, do, True, False, **kw)
                     if split else None)
        want = _flash_fwd_bwd(q, k, v, do, True, True, **kw)
        window, softcap = kw.get("window"), kw.get("softcap")
        got.insert(1, attention._flash_fwd_cuda(
            q, k, v, True, scale, True, q_seg, kv_seg, window=window,
            softcap=softcap)[1])
        want.insert(1, attention._attn_fwd_plain(
            q, k, v, attention._merge_seg_into_mask(None, q_seg, kv_seg),
            None, True, window, scale, softcap)[1])
        torch.cuda.synchronize()
        tag = (f"flash {'K1+K5' if split else 'K1+K2'} {name}"
               f"{' segments' if segments else ''} {shape} causal "
               f"{str(dtype)[6:]}")
        spare = {f32: 0.0, f16: 0.0}
        line = _hold(tag, ("o", "lse"), got[:2], want[:2], dtype,
                     errs["fwd"] if shape[-1] == 256 else spare)
        line += ", " + _hold(tag, ("dq", "dk", "dv"), got[2:], want[2:], dtype,
                             errs["bwd"] if shape[-1] == 256 else spare)
        if split and not all(torch.equal(x, y)
                             for x, y in zip(got[2:], again[1:])):
            raise AssertionError(f"(c) {tag}: K5's dq/dk/dv differ between "
                                 "two runs")
        print(f"(c) {tag}: max abs err / bound: {line}"
              f"{'; dq, dk, dv bit-equal across two runs' if split else ''}")
        del q, k, v, do, got, want, again
    dual_cases = [(shape, window, dtype)
                  for shape in (d256, (2, 8, 2, 1024, 1024, 64))
                  for window in (7, 100, 4096) for dtype in (f32, f16)]
    dual_cases.append((GEMMA_LAYER, GEMMA_WINDOW, f16))
    for shape, window, dtype in dual_cases:
        q, k, v, _ = _flash_inputs(shape, dtype, rng)
        scale = 1.0 / math.sqrt(shape[-1])
        single = attention._flash_fwd_cuda(q, k, v, True, scale, True,
                                           window=window)
        dual = attention._flash_fwd_cuda(q, k, v, True, scale, True,
                                         dual=True, window=window)
        want = attention._attn_fwd_plain(q, k, v, None, None, True, window,
                                         scale)
        torch.cuda.synchronize()
        tag = f"flash K12 window {window} {shape} causal {str(dtype)[6:]}"
        if not (torch.equal(single[0], dual[0])
                and torch.equal(single[1], dual[1])):
            raise AssertionError(f"(c) {tag}: o/lse differ from K1's")
        line = _hold(tag, ("o", "lse"), dual, want, dtype,
                     errs["fwd"] if shape[-1] == 256 else {f32: 0.0, f16: 0.0})
        print(f"(c) {tag}: o and lse equal K1's bit for bit; vs plain {line}")
        del q, k, v, single, dual, want
    torch.cuda.empty_cache()

    # Band check: tiles outside the window's band are not visited.
    q, k, v, _ = _flash_inputs(GEMMA_LAYER, f16, rng)

    def k1(window):
        return lambda: attention._flash_fwd_cuda(q, k, v, True, GEMMA_SCALE,
                                                 True, window=window)

    t = [_device_ms(f, runs=10) for f in (k1(None), k1(BAND_WINDOW),
                                          k1(BAND_WINDOW), k1(None))]
    s_len = GEMMA_LAYER[3]
    share = _band_pairs(s_len, BAND_WINDOW) / _band_pairs(s_len, None)
    ratio = min(t[1], t[2]) / min(t[0], t[3])
    print(f"(c) band check, K1 b1 hq8/hkv4 s{s_len} d256 bf16 causal: window "
          f"{BAND_WINDOW} device {t[1]:.4f} / {t[2]:.4f} ms, no window "
          f"{t[0]:.4f} / {t[3]:.4f} ms (order none, window, window, none): "
          f"{ratio:.3f}x for {share:.3f} of the causal pairs (must be < 0.5)")
    if not ratio < 0.5:
        raise AssertionError(f"(c) K1 with a window of {BAND_WINDOW} takes "
                             f"{ratio:.3f} of the time without: tiles outside "
                             "the band are visited")
    del q, k, v
    torch.cuda.empty_cache()
    out = {key: (e[f32], e[f16]) for key, e in errs.items()}
    print(f"(c) flash options: {len(cases)} K1/K2/K5 cases and "
          f"{len(dual_cases)} K12 cases pass in "
          f"{time.perf_counter() - t0:.1f} s; head_dim 256 max abs err "
          f"(fp32, bf16): {out}")
    return out


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


def phase_flash_no_key_vs_plain():
    """P6: rows that no key sees (non-causal, a q segment absent from kv_seg)
    through K1 and K2 / K5 against the plain path on the card, fp32 and bf16
    at every forward kv tile width (skv ragged, so the last tile holds
    columns past skv): o, dq, dk, dv within the flash tolerances, lse within
    them on rows with keys and equal to the plain lse on rows without, the
    rows' o the mean of v (shifted to a mean of ~2) over all skv keys; K12
    without segment ids bit-equal to K1 on the same ragged skv where its tile
    count is even."""
    import torch
    from np_modeling_tpu_torch.ops import attention
    rng = np.random.default_rng(SEED + 31)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128, 256):
            tile = attention._fwd_kv_tile(dtype, d)
            skv, sq = 3 * tile + tile // 2 + 3, 300
            shape = (2, 8, 4, sq, skv, d)
            q, k, v, do = _flash_inputs(shape, dtype, rng)
            # v's mean of ~2 makes a mean over the visited columns instead
            # of the skv keys (the fault) ~0.24 off, 6x the bound.
            v = v + 2
            kv_seg = torch.tensor(pack_rows(rng, 2, skv)[0], device="cuda")
            q_seg = torch.tensor(pack_rows(rng, 2, sq)[0], device="cuda")
            q_seg[:, ::3] = 1 << 20                 # absent from kv_seg
            scale = d ** -0.5
            o, lse = attention._flash_fwd_cuda(q, k, v, False, scale, True,
                                               q_seg, kv_seg)
            mask = attention._merge_seg_into_mask(None, q_seg, kv_seg)
            want = attention._attn_fwd_plain(q, k, v, mask, None, False, None,
                                             scale)
            o = o.contiguous()
            tag = f"flash no-key rows {shape} full {str(dtype)[6:]}"
            line = _hold(tag, ("o",), (o,), want, dtype, errs)
            # Rows without a key: the absent segment, and rows of a document
            # that the kv packing does not hold.
            keyless = ~(q_seg[:, :, None] == kv_seg[:, None, :]).any(-1)
            line += ", " + _hold_no_key_lse(tag, lse, want[1], keyless,
                                            dtype, errs)
            none = keyless[:, None, :, None].expand(o.shape)
            mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(
                2, 1).expand(o.shape)
            err = (o.float() - mean)[none].abs().max().item()
            if not err <= _tol(dtype) * max(1.0, mean.abs().max().item()):
                raise AssertionError(f"(c) {tag}: rows without a key are "
                                     f"{err} from the mean of v")
            grads = attention._attn_bwd_plain(q, k, v, o, lse, do, mask, None,
                                              False, None, scale)[:3]
            for split in (False, True):
                got = attention._flash_bwd_cuda(q, k, v, o, lse, do, False,
                                                scale, q_seg, kv_seg,
                                                split=split)
                line += f"; {'K5' if split else 'K2'} " + _hold(
                    tag, ("dq", "dk", "dv"), got, grads, dtype, errs)
            if -(-skv // tile) % 2 == 0:
                single = attention._flash_fwd_cuda(q, k, v, False, scale, True)
                dual = attention._flash_fwd_cuda(q, k, v, False, scale, True,
                                                 dual=True)
                if not (torch.equal(single[0], dual[0])
                        and torch.equal(single[1], dual[1])):
                    raise AssertionError(f"(c) {tag}: K12 differs from K1")
                line += "; K12 bit-equal to K1"
            torch.cuda.synchronize()
            n += 1
            print(f"(c) {tag}: max abs err / bound: {line}; no-key rows' o "
                  f"{err:.2e} from the mean of v")
    print(f"(c) flash no-key rows: {n} cases pass; max abs err fp32 "
          f"{errs[torch.float32]:.3e}, bf16 {errs[torch.bfloat16]:.3e}")


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


def _bf16_or_f32_err(got, want, tol=LN_F32_TOL):
    """Max abs err and whether it passes: fp32 <= tol x max(1, max |plain|);
    bf16 within one bf16 ulp of either value, or that fp32 bound."""
    import torch
    diff = (got.float() - want.float()).abs()
    f32_bound = tol * max(1.0, want.float().abs().max().item())
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
            err, ok = _bf16_or_f32_err(a, b)
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
    n_bwd = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 768, 1000, 1001, 1024, 1025, 8192):
            for rows in (1, 7, 33, 16384):
                x = torch.tensor(rng.standard_normal((rows, d)) * 2.0 + 0.5,
                                 dtype=torch.float32, device="cuda").to(dtype)
                gamma = torch.tensor(rng.standard_normal(d) * 0.1 + 1.0,
                                     dtype=torch.float32, device="cuda")
                dz = torch.tensor(rng.standard_normal((rows, d)),
                                  dtype=torch.float32, device="cuda").to(dtype)
                got = fused.layer_norm_bwd_cuda(x, gamma, dz, LN_EPS)
                again = fused.layer_norm_bwd_cuda(x, gamma, dz, LN_EPS)
                want = fused.layer_norm_bwd_plain(x, gamma, dz, LN_EPS)
                torch.cuda.synchronize()
                slot = int(dtype == torch.bfloat16)
                for name, a, b, c in zip(("dx", "dgamma", "dbeta"), got, want,
                                         again):
                    err, ok = _bf16_or_f32_err(a, b)
                    if not (ok and torch.equal(a, c)):
                        raise AssertionError(
                            f"(c) layer_norm backward [{rows}, {d}] "
                            f"{str(dtype)[6:]}: {name} max abs err {err}, "
                            f"equal run to run {torch.equal(a, c)}")
                    errs["layer_norm_bwd"][slot] = max(
                        errs["layer_norm_bwd"][slot], err)
                n_bwd += 1
                del x, dz, got, again, want
    print(f"(c) layer_norm backward: {n_bwd} cases pass (d 64..8192 across "
          f"the warp kernel's 1024, rows 1, 7, 33, 16384), dx, dgamma and "
          f"dbeta bit-equal run to run; max abs err fp32 "
          f"{errs['layer_norm_bwd'][0]:.3e}, bf16 "
          f"{errs['layer_norm_bwd'][1]:.3e}")

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


def _k4_inputs(m, k, n, rng):
    """x [m, k] fp32, an int8 weight [k, n] quantized per column from
    GPT-2-scale values (std 0.02), its scales and an fp32 bias, on the
    card."""
    import torch
    from np_modeling_tpu_torch import ops

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32, device="cuda")

    q = ops.quantize_params_int8({"dense2": {"w": rand(k, n, scale=0.02)}}
                                 )["dense2"]["w"]
    return rand(m, k), q["int8"], q["scale"], rand(n, scale=0.1)


def phase_int8_matmul_vs_plain():
    """K4 vs its plain version at the serving path's shapes and ragged ones:
    bf16 and fp32 x, bf16 and fp32 out, with and without bias. fp32 out:
    max abs err <= 1e-4 x max(1, max |plain|); bf16 out: within one bf16
    ulp of either value (or that fp32 bound). Returns (max err fp32 out,
    bf16 out)."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    f32, f16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(SEED + 9)
    errs = {f32: 0.0, f16: 0.0}
    shapes = K4_SHAPES + ((5, 96, 200), (1, 64, 640), (33, 384, 128),
                          (7, 100, 30), (300, 770, 1000))
    n = 0
    for m, k, nn in shapes:
        x, wq, scale, bias = _k4_inputs(m, k, nn, rng)
        for x_dtype, out_dtype in ((f16, f16), (f16, f32), (f32, f32),
                                   (f32, f16)):
            for b in (None, bias):
                xin = x.to(x_dtype)
                got = ops.int8_matmul(xin, wq, scale, b, out_dtype=out_dtype)
                with dispatch.force_plain():
                    want = ops.int8_matmul(xin, wq, scale, b,
                                           out_dtype=out_dtype)
                torch.cuda.synchronize()
                err, ok = _bf16_or_f32_err(got, want, F32_TOL)
                tag = (f"int8_matmul [{m}, {k}] x [{k}, {nn}] x "
                       f"{str(x_dtype)[6:]} out {str(out_dtype)[6:]}"
                       f"{' bias' if b is not None else ''}")
                if not (ok and got.dtype == out_dtype
                        and got.shape == (m, nn)):
                    raise AssertionError(f"(c) {tag}: max abs err {err} out "
                                         "of bounds, or wrong dtype/shape")
                errs[out_dtype] = max(errs[out_dtype], err)
                n += 1
                print(f"(c) {tag}: max abs err {err:.3e}")
    print(f"(c) int8_matmul: {n} cases pass: max abs err fp32 out "
          f"{errs[f32]:.3e} (tol {F32_TOL} x max(1, max |plain|)), bf16 out "
          f"{errs[f16]:.3e} (one bf16 ulp)")
    return errs[f32], errs[f16]


# (k, n) of (c)'s forced-schedule K4 cases: GPT-2 small's FFN products and
# ragged ones (k not a multiple of 8 or 64, n not of 16 or of a tile).
K4_FORCED_KN = ((768, 3072), (3072, 768), (100, 30), (4104, 144))


def _k4_forced_plans(k, n):
    """(schedule, m, plan) of (c)'s forced K4 cases at (k, n): skinny at
    every m it takes, by its own plan and at 32-column tiles and 16 splits
    asked for; wide where TMA reads x and the weight (k % 8 == 0, n % 16
    == 0), also with 3 splits; simple."""
    from np_modeling_tpu_torch.ops import quantization as quant
    from np_modeling_tpu_torch.ops.fused import sm_count
    sms = sm_count("cuda")
    out = []
    for m in (1, 8, 9, 63, 64):
        own = quant.plan(m, n, k, sms)
        out.append(("skinny", m, own))
        rows, splits = quant.skinny_split(k, 16)
        if rows <= quant.SKINNY_MAX_ROWS:
            out.append(("skinny", m, quant.Plan("skinny", 32, splits, splits)))
    if k % 8 == 0 and n % 16 == 0:
        out += [("wide", m, quant.plan(m, n, k, sms)) for m in (65, 300, 1792)]
        out.append(("wide", 65, quant.Plan("wide", 128, 3, 1)))
    out += [("simple", m, quant.Plan("simple", 64, 1, 1)) for m in (1, 65)]
    return out


def phase_int8_schedules_vs_plain():
    """K4's three schedules forced through the wrapper's plan (skinny at m
    1..64 and forced tiles and splits, wide at m 65..1792 and with split-k,
    simple) against the plain version, bf16 x, bf16 and fp32 out, with
    bias, by (c)'s K4 criteria; the same bits on a second call; each
    launch counted under its schedule and its (schedule, k, n). Returns
    (max err fp32 out, bf16 out)."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    from np_modeling_tpu_torch.ops import quantization as quant
    f32, f16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(SEED + 13)
    errs = {f32: 0.0, f16: 0.0}
    n_cases, counted = 0, {"skinny": 0, "wide": 0, "simple": 0}
    cached = quant._cached_plan
    try:
        for k, n in K4_FORCED_KN:
            for schedule, m, p in _k4_forced_plans(k, n):
                x, wq, scale, bias = _k4_inputs(m, k, n, rng)
                x = x.to(f16)
                quant._cached_plan = lambda *a, p=p: p
                for out_dtype in (f16, f32):
                    name = f"launches_{schedule}"
                    by_shape = ops.int8_matmul.launches_by_shape
                    before = (getattr(ops.int8_matmul, name),
                              by_shape.get((schedule, k, n), 0))
                    got = ops.int8_matmul(x, wq, scale, bias,
                                          out_dtype=out_dtype)
                    again = ops.int8_matmul(x, wq, scale, bias,
                                            out_dtype=out_dtype)
                    ran = getattr(ops.int8_matmul, name) - before[0]
                    at_shape = by_shape[schedule, k, n] - before[1]
                    if at_shape != ran:
                        raise AssertionError(
                            f"(c) int8_matmul {schedule} [{m}, {k}] x [{k}, "
                            f"{n}]: {ran} launches, {at_shape} counted at "
                            f"the shape")
                    with dispatch.force_plain():
                        want = ops.int8_matmul(x, wq, scale, bias,
                                               out_dtype=out_dtype)
                    torch.cuda.synchronize()
                    err, ok = _bf16_or_f32_err(got, want, F32_TOL)
                    tag = (f"int8_matmul {schedule} {tuple(p)} [{m}, {k}] x "
                           f"[{k}, {n}] out {str(out_dtype)[6:]}")
                    if not (ok and ran == 2 and torch.equal(got, again)
                            and got.shape == (m, n)):
                        raise AssertionError(
                            f"(c) {tag}: max abs err {err}, {ran} launches "
                            f"counted as {schedule}, run-to-run equal "
                            f"{torch.equal(got, again)}")
                    errs[out_dtype] = max(errs[out_dtype], err)
                    counted[schedule] += ran
                    n_cases += 1
    finally:
        quant._cached_plan = cached
    print(f"(c) int8_matmul schedules: {n_cases} forced cases pass, each "
          f"bit-equal on a second call; launches by schedule {counted}; max "
          f"abs err fp32 out {errs[f32]:.3e}, bf16 out {errs[f16]:.3e}")
    return errs[f32], errs[f16]


def _mm_operands(m, k, n, trans_a, trans_b, rng, scale=1.0):
    """a, b in their stored layouts for op(a) [m, k] @ op(b) [k, n], fp32
    on the card, and an fp32 bias [n]."""
    import torch

    def rand(*shape):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32, device="cuda")

    a = rand(*((k, m) if trans_a else (m, k)))
    b = rand(*((n, k) if trans_b else (k, n)))
    return a, b, rand(n)


def _k11_plan(a, b, trans_a, trans_b):
    """K11's schedule for these operands, as ops/matmul.py's _launch takes
    it: (variant, splits) for bf16, ("fma", 1) for fp32."""
    import importlib
    import torch
    if torch.promote_types(a.dtype, b.dtype) != torch.bfloat16:
        return "fma", 1
    m = a.shape[1] if trans_a else a.shape[0]
    k = a.shape[0] if trans_a else a.shape[1]
    n = b.shape[0] if trans_b else b.shape[1]
    return importlib.import_module("np_modeling_tpu_torch.ops.matmul").plan(
        m, k, n, trans_a, trans_b,
        a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


def _check_k11(tag, a, b, bias, trans_a, trans_b, out_dtype, tally=None):
    """K11 under force_kernels() against matmul_reference: one launch (and
    one of the ragged variant where plan() takes it), the dtype and shape,
    fp32 out within 1e-4 x max(1, max |plain|), bf16 out within one bf16
    ulp (or that bound); split-k the same bits on a second run. Counts the
    case's schedule in ``tally``. Returns the max abs err."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    variant, splits = _k11_plan(a, b, trans_a, trans_b)
    before = (ops.matmul.launches, ops.matmul.launches_ragged)
    with dispatch.force_kernels():
        got = ops.matmul(a, b, bias, trans_a=trans_a, trans_b=trans_b,
                         out_dtype=out_dtype)
    counted = (ops.matmul.launches - before[0],
               ops.matmul.launches_ragged - before[1])
    want = ops.matmul_reference(a, b, bias, trans_a=trans_a, trans_b=trans_b,
                                out_dtype=out_dtype)
    torch.cuda.synchronize()
    err, ok = _bf16_or_f32_err(got, want, F32_TOL)
    if not (ok and got.dtype == want.dtype and got.shape == want.shape
            and counted == (1, int(variant == "ragged"))):
        raise AssertionError(f"(c) {tag}: max abs err {err} out of bounds, "
                             f"or wrong dtype/shape/launch counts {counted} "
                             f"({variant})")
    if splits > 1:
        with dispatch.force_kernels():
            again = ops.matmul(a, b, bias, trans_a=trans_a, trans_b=trans_b,
                               out_dtype=out_dtype)
        if not torch.equal(got, again):
            raise AssertionError(f"(c) {tag}: split-k differs between runs")
    if tally is not None:
        key = variant + (f" split {splits}" if splits > 1 else "")
        tally[key] = tally.get(key, 0) + 1
    return err


def phase_matmul_vs_plain():
    """K11 vs its plain version inside force_kernels(): the 9 products of
    the GPT-2 small step, in bf16 (bf16 and fp32 out) and fp32, then ragged
    shapes with every trans pair, bias or not; bf16 runs the TMA variant,
    the ragged one (rows not whole 16-byte vectors, k = 0) and split-k
    (the step's [768, 768] weight gradients; [9, 4099] x [4099, 7]), each
    counted. Returns (max err fp32 out, bf16 out)."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    f32, f16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(SEED + 13)
    errs, n, tally = {f32: 0.0, f16: 0.0}, 0, {}
    for m, k, nn, ta, tb, with_bias in STEP_PRODUCTS:
        a, b, bias = _mm_operands(m, k, nn, ta, tb, rng)
        bias = bias if with_bias else None
        for op_dtype, out_dtype in ((f16, f16), (f16, f32), (f32, f32)):
            tag = (f"matmul step [{m}, {k}] x [{k}, {nn}] trans_a={ta} "
                   f"trans_b={tb}{' bias' if with_bias else ''} "
                   f"{str(op_dtype)[6:]} out {str(out_dtype)[6:]}")
            err = _check_k11(tag, a.to(op_dtype), b.to(op_dtype), bias, ta,
                             tb, out_dtype, tally)
            tag += " [%s, %d split(s)]" % _k11_plan(a.to(op_dtype),
                                                    b.to(op_dtype), ta, tb)
            errs[out_dtype] = max(errs[out_dtype], err)
            n += 1
            print(f"(c) {tag}: max abs err {err:.3e}")
        del a, b, bias
    for m, k, nn in ((100, 70, 50), (1, 64, 640), (33, 384, 128),
                     (129, 257, 255), (8, 1024, 8), (5, 7, 3), (3, 0, 5),
                     (9, 4099, 7), (136, 16384, 200)):
        for ta in (False, True):
            for tb in (False, True):
                a, b, bias = _mm_operands(m, k, nn, ta, tb, rng)
                for op_dtype, out_dtype in ((f16, f16), (f16, f32),
                                            (f32, f32), (f32, f16)):
                    for bb in (None, bias):
                        tag = (f"matmul [{m}, {k}] x [{k}, {nn}] trans_a={ta}"
                               f" trans_b={tb}{' bias' if bb is not None else ''}"
                               f" {str(op_dtype)[6:]} out {str(out_dtype)[6:]}")
                        err = _check_k11(tag, a.to(op_dtype), b.to(op_dtype),
                                         bb, ta, tb, out_dtype, tally)
                        errs[out_dtype] = max(errs[out_dtype], err)
                        n += 1
    # Mixed operands are promoted (to fp32), as JAX's dot_general does.
    a, b, bias = _mm_operands(37, 96, 80, False, True, rng)
    err = _check_k11("matmul mixed bf16 x fp32", a.to(f16), b, bias, False,
                     True, f32)
    errs[f32] = max(errs[f32], err)
    n += 1
    try:
        with dispatch.force_kernels():
            ops.matmul(a.half(), b.t().half())
    except ValueError:
        pass
    else:
        raise AssertionError("(c) matmul: force_kernels() took float16")
    if not all(key in tally for key in ("tma", "ragged", "tma split 3",
                                        "ragged split 4")):
        raise AssertionError(f"(c) matmul: a K11 schedule went untested: "
                             f"{tally}")
    print(f"(c) matmul: cases by schedule {tally}")
    print(f"(c) matmul: {n} cases pass: max abs err fp32 out "
          f"{errs[f32]:.3e} (tol {F32_TOL} x max(1, max |plain|)), bf16 out "
          f"{errs[f16]:.3e} (one bf16 ulp); float16 raises")
    return errs[f32], errs[f16]


def _sxe_run(logits, labels, g, plain):
    """ce, lse-free dlogits through ops.softmax_cross_entropy_fused."""
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    leaf = logits.clone().requires_grad_()
    with dispatch.force_plain() if plain else contextlib.nullcontext():
        ce = ops.softmax_cross_entropy_fused(leaf, labels)
        ce.backward(g)
    return ce.detach(), leaf.grad


def _dlogits_err(got, want):
    """Max abs err of dlogits and whether it passes: fp32 within 1e-4 x
    |plain| + 1e-6 x max |plain| (the probabilities are ~1/v, so a bound
    on the largest value alone would let any of them through); bf16 within
    one bf16 ulp of either value, or that bound."""
    import torch
    diff = (got.float() - want.float()).abs()
    wf = want.float()
    bound = 1e-4 * wf.abs() + 1e-6 * wf.abs().max()
    if got.dtype == torch.bfloat16:
        bound = torch.maximum(bound, torch.maximum(_bf16_ulp(got),
                                                   _bf16_ulp(want)))
    return diff.max().item(), bool((diff <= bound).all())


def phase_sxe_vs_plain():
    """K9 forward and backward vs the plain version: the GPT-2 step's logits
    shape [8192, 50257] in fp32 and bf16 (scale 3, so the rows' softmax is
    far from uniform), and ragged cases with labels outside [0, v). ce
    within 1e-5 x max(1, max |plain|); dlogits by ``_dlogits_err``.
    Returns (max err fp32, bf16) over ce and dlogits."""
    import torch
    rng = np.random.default_rng(SEED + 14)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [((GPT2_B * GPT2_S,), 50257), ((37,), 1001), ((2, 7), 300),
             ((3,), 1)]
    n = 0
    for lead, v in cases:
        for dtype in (torch.float32, torch.bfloat16):
            logits = (torch.tensor(rng.standard_normal((*lead, v)) * 3,
                                   dtype=torch.float32, device="cuda")
                      .to(dtype))
            labels = torch.tensor(rng.integers(0, v, lead), device="cuda")
            flat = labels.view(-1)
            if flat.numel() > 3:
                flat[1], flat[2] = v, -1          # outside [0, v)
            g = torch.tensor(rng.standard_normal(lead), dtype=torch.float32,
                             device="cuda")
            ce_k, dl_k = _sxe_run(logits, labels, g, plain=False)
            ce_p, dl_p = _sxe_run(logits, labels, g, plain=True)
            torch.cuda.synchronize()
            tag = f"softmax_cross_entropy_fused {(*lead, v)} {str(dtype)[6:]}"
            ce_err = (ce_k - ce_p).abs().max().item()
            ce_ok = ce_err <= LN_F32_TOL * max(1.0, ce_p.abs().max().item())
            dl_err, dl_ok = _dlogits_err(dl_k, dl_p)
            if not (ce_ok and dl_ok and dl_k.dtype == dtype
                    and ce_k.dtype == torch.float32 and ce_k.shape == lead):
                raise AssertionError(f"(c) {tag}: ce err {ce_err}, dlogits "
                                     f"err {dl_err} out of bounds")
            errs[dtype] = max(errs[dtype], ce_err, dl_err)
            n += 1
            print(f"(c) {tag}: max abs err ce {ce_err:.3e}, dlogits "
                  f"{dl_err:.3e}")
            del logits, labels, g, ce_k, dl_k, ce_p, dl_p
    torch.cuda.empty_cache()
    print(f"(c) softmax_cross_entropy_fused: {n} cases pass (labels outside "
          f"[0, v) included): max abs err fp32 {errs[torch.float32]:.3e}, "
          f"bf16 {errs[torch.bfloat16]:.3e}")
    return errs[torch.float32], errs[torch.bfloat16]


def _check_k10(tag, x, seed):
    """K10 vs its plain twin: values and scales bit for bit, every value
    floor or floor + 1 of x / scale (clipped)."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    before = ops.quantize_int8_stochastic.launches
    got = ops.quantize_int8_stochastic(x, seed)
    with dispatch.force_plain():
        want = ops.quantize_int8_stochastic(x, seed)
    torch.cuda.synchronize()
    if ops.quantize_int8_stochastic.launches != before + 1:
        raise AssertionError(f"(c) {tag}: K10 not launched once")
    if not (torch.equal(got.values, want.values)
            and torch.equal(got.scales, want.scales)):
        raise AssertionError(
            f"(c) {tag}: differs from the plain twin in "
            f"{(got.values != want.values).sum().item()} values, "
            f"{(got.scales != want.scales).sum().item()} scales")
    s = x.float() / got.scales
    fl = torch.floor(s).clamp(-127, 127)
    q = got.values.float()
    if not bool(((q == fl) | (q == (fl + 1).clamp(-127, 127))).all()):
        raise AssertionError(f"(c) {tag}: a value is neither floor nor "
                             "floor + 1 of x / scale")
    return got


def phase_quantize_vs_plain():
    """K10 vs its plain twin (values and scales bit for bit) at [8192, 768]
    and [1792, 12, 64] in fp32 and bf16 and at ragged shapes with a zero
    row; unbiasedness over 256 seeds; another seed draws other bits."""
    import torch
    from np_modeling_tpu_torch import ops
    rng = np.random.default_rng(SEED + 15)
    n = 0
    for shape in ((GPT2_B * GPT2_S, 768), (1792, 12, 64), (5, 1001), (3, 1),
                  (4, 33)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                             device="cuda").to(dtype)
            if shape[0] == 4:
                x[1] = 0.0
            seed = int(rng.integers(0, 2 ** 63))
            _check_k10(f"quantize_int8_stochastic {shape} {str(dtype)[6:]}",
                       x, seed)
            n += 1
    # Unbiasedness: per element, the mean over 256 seeds of (dequantized -
    # x) / scale has expectation 0 and variance f (1 - f) / 256, f = frac(x /
    # scale); held within 5 sigma plus one draw's worth (1/256), as the mean
    # of 256 Bernoulli draws of a small f is far from normal.
    x = torch.tensor(rng.standard_normal((256, 768)), dtype=torch.float32,
                     device="cuda")
    total = torch.zeros_like(x)
    for seed in range(256):
        qt = ops.quantize_int8_stochastic(x, seed)
        total += (qt.values.float() * qt.scales - x) / qt.scales
    mean = total / 256
    s = x / qt.scales
    f = s - torch.floor(s)
    sigma = (f * (1 - f) / 256).sqrt()
    worst = ((mean.abs() - 1 / 256) / sigma.clamp(min=1e-12)).max().item()
    if not bool((mean.abs() <= 5 * sigma + 1 / 256).all()):
        raise AssertionError(f"(c) quantize_int8_stochastic: biased, worst "
                             f"excess {worst:.2f} sigma")
    print(f"(c) quantize_int8_stochastic: mean error over 256 seeds within 5 "
          f"sigma + 1/256 at every element of [256, 768] (overall mean "
          f"{mean.mean().item():.2e} steps)")
    a = ops.quantize_int8_stochastic(x, 1).values
    b = ops.quantize_int8_stochastic(x, 2).values
    share = (a != b).float().mean().item()
    expect = (2 * f * (1 - f)).mean().item()
    if not abs(share - expect) < 0.02:
        raise AssertionError(f"(c) quantize_int8_stochastic: seeds 1 and 2 "
                             f"differ in {share:.4f} of the values, expected "
                             f"{expect:.4f}")
    print(f"(c) quantize_int8_stochastic: {n} cases equal the plain twin bit "
          f"for bit, every value floor or floor + 1; seeds 1 and 2 differ in "
          f"{share:.4f} of the values (expected {expect:.4f})")
    return 0.0, 0.0


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


def make_engine(gpt, kv_dtype, quantize_kv=False):
    from np_modeling_tpu_torch.serving import GenerationEngine
    return GenerationEngine(gpt, total_pages=640, page_size=16, max_seqs=8,
                            kv_dtype=kv_dtype, quantize_kv=quantize_kv)


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


def gpt2_small():
    """GPT-2 small at bf16 compute with seeded random weights, on the card."""
    import torch
    from np_modeling_tpu_torch.models import GPT
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return GPT(gpt2_config(torch.bfloat16), device="cuda").init(gen)


def phase_engine(gpt, prompts):
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.models import GPT
    cfg = gpt.config
    n_params = sum(p.numel() for p in gpt.parameters())
    print(f"(d) GPT-2 small: {cfg.num_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {n_params} params, bf16 compute, bf16 pages")
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
    _greedy_vs_plain("(d)", lambda: make_engine(gpt32, torch.float32), prompts)
    return launches


def _greedy_vs_plain(tag, make, prompts):
    """The traffic through an engine from ``make()`` on the kernels and on
    the plain versions: greedy tokens must agree (``_same_greedy``)."""
    from np_modeling_tpu_torch.ops import dispatch
    k_streams, _, _, _ = run_traffic(make(), prompts)
    with dispatch.force_plain():
        p_streams, where, calls, _ = run_traffic(make(), prompts)
    margin = {(sid, i): float(calls[c][row]) for sid, i, c, row in where}
    _same_greedy(f"{tag} fp32 kernel vs plain:", k_streams, p_streams, margin)


def _same_greedy(tag, k_streams, p_streams, p_margins):
    """Kernel and plain greedy streams agree, except where the plain path's
    top-2 logits lie within NEAR_TIE (printed; the streams part there)."""
    ties, compared = [], 0
    for sid in sorted(p_streams):
        for i, (a, b) in enumerate(zip(k_streams[sid], p_streams[sid])):
            compared += 1
            if a != b:
                m = p_margins[(sid, i)]
                if not m < NEAR_TIE:
                    raise AssertionError(
                        f"{tag} seq {sid} token {i}: kernel {a} != plain {b}, "
                        f"plain top-2 margin {m}")
                ties.append((sid, i, a, b, m))
                break
    for sid, i, a, b, m in ties:
        print(f"{tag} near-tie: seq {sid} token {i}: kernel {a}, plain {b}, "
              f"plain top-2 margin {m:.3e}")
    print(f"{tag} {compared} greedy tokens compared, {len(ties)} near-tie "
          f"divergences, all else identical")


def _quantized_gpt(tree, dtype):
    from np_modeling_tpu_torch.utils import params_from_numpy
    return params_from_numpy(tree, gpt2_config(dtype), device="cuda")


def phase_quantized_engine(gpt, prompts):
    """(j) The quantized serving path: (d)'s GPT-2 small with its FFN
    weights quantized to int8 (quantize_params_int8 -> params_from_numpy)
    served with int8 KV pages (quantize_kv=True) on (d)'s traffic, bf16
    compute. Checks tokens, pages, and that every FFN product launched K4
    (24 a forward: skinny at decode, wide at prefill), every attention call
    the int8-page kernel (12 a forward) and every LayerNorm K8 (25 a
    forward); then fp32 compute, the
    kernels' greedy tokens against the plain engine's. Returns the bf16
    quantized GPT, the tree and the launch counts."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.utils import params_to_numpy
    tree = ops.quantize_params_int8(params_to_numpy(gpt), match=FFN_MATCH)
    qgpt = _quantized_gpt(tree, torch.bfloat16)
    n_int8 = sum(b.numel() for n, b in qgpt.named_buffers()
                 if n.endswith(".int8"))
    print(f"(j) GPT-2 small, FFN weights int8 ({n_int8} int8 values, "
          f"per-column fp32 scales), int8 KV pages with per-token scales, "
          f"bf16 compute")
    eng = make_engine(qgpt, None, quantize_kv=True)
    free0 = eng.free_pages
    ops.int8_matmul.launches = ops.int8_matmul.launches_skinny = 0
    ops.int8_matmul.launches_wide = ops.int8_matmul.launches_simple = 0
    ops.int8_matmul.launches_by_shape = {}
    ops.paged_attention.launches = ops.paged_attention.launches_int8 = 0
    ops.layer_norm.launches_fwd = 0
    streams, _, calls, chunk_calls = run_traffic(eng, prompts)
    counts = {"int8_matmul": ops.int8_matmul.launches,
              "int8_matmul_skinny": ops.int8_matmul.launches_skinny,
              "int8_matmul_wide": ops.int8_matmul.launches_wide,
              "int8_matmul_simple": ops.int8_matmul.launches_simple,
              "paged_attention": ops.paged_attention.launches,
              "paged_attention_int8": ops.paged_attention.launches_int8,
              "layer_norm_fwd": ops.layer_norm.launches_fwd}
    # K4's launches at each of GPT-2's FFN products, by schedule.
    counts.update({f"int8_matmul_{s} {k}x{n}": ops.int8_matmul
                   .launches_by_shape.get((s, k, n), 0)
                   for s in ("skinny", "wide")
                   for k, n in ((768, 3072), (3072, 768))})
    for sid in eng.live:
        eng.finish(sid)
    L, forwards = qgpt.config.num_layers, len(calls)
    # A decode step's FFN products have 8 rows (skinny), a prefill chunk
    # call's B x 256 (wide).
    want = {"int8_matmul": 2 * L * forwards,
            "int8_matmul_skinny": 2 * L * (forwards - chunk_calls),
            "int8_matmul_wide": 2 * L * chunk_calls, "int8_matmul_simple": 0,
            "paged_attention": L * forwards,
            "paged_attention_int8": L * forwards,
            "layer_norm_fwd": (2 * L + 1) * forwards}
    # Each forward runs each FFN product once a layer.
    want.update({f"int8_matmul_{s} {k}x{n}": L * (
        chunk_calls if s == "wide" else forwards - chunk_calls)
        for s in ("skinny", "wide") for k, n in ((768, 3072), (3072, 768))})
    toks = np.concatenate([np.asarray(s) for s in streams.values()])
    print(f"(j) {len(toks)} tokens, {chunk_calls} prefill chunk calls, "
          f"{forwards - chunk_calls} decode steps; launches {counts} "
          f"(expected {want}); free pages {eng.free_pages}/{free0}")
    if not ((toks >= 0) & (toks < qgpt.config.vocab_size)).all():
        raise AssertionError("(j) token out of range")
    if eng.free_pages != free0:
        raise AssertionError("(j) pages not restored after finish")
    if counts != want:
        raise AssertionError(f"(j) launches {counts}, expected {want}")
    del eng
    qgpt32 = _quantized_gpt(tree, None)
    _greedy_vs_plain("(j)", lambda: make_engine(qgpt32, None,
                                               quantize_kv=True), prompts)
    del qgpt32
    return qgpt, counts


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
    res["bound " + name] = _paged_bound(q, k, lens, table)
    # A 256-token prefill chunk of 7 sequences at bases 0..512.
    lengths = [256 * (1 + i % 3) for i in range(7)]
    q, k, v, lens, table = _pa_inputs(7, 256, 12, 12, 64, 16, lengths,
                                      torch.bfloat16, rng)
    both("paged_attention chunk b7 sq256 bf16",
         lambda: ops.paged_attention(q, k, v, lens, table))

    _engine_timings(res, "e", make_engine(gpt, torch.bfloat16), prompts,
                    device_line)
    return res


def _paged_bound(q, k_pages, lens, table, scales=(), window=None):
    """Bound of a paged call: q and out, the K/V rows of every position
    below a sequence's length (with a window, of the window's last
    positions only) and their scales, lengths and the table; 4 x positions
    x q heads x head_dim operations."""
    hkv, d = k_pages.shape[0], k_pages.shape[-1]
    seen = int((lens if window is None else lens.clamp(max=window)).sum())
    tokens = seen * hkv
    nbytes = (2 * _nbytes(q, lens, table) + 2 * tokens * d
              * k_pages.element_size() + 4 * tokens * len(scales))
    return _bound(nbytes, 4 * seen * q.shape[-2] * d)


def _engine_timings(res, tag, eng, prompts, device_line):
    """Engine prefill ms (7 prompts, from empty) and decode tokens/s (8
    sequences, step_many(4)), kernel and plain, into ``res``. Returns
    (prefill name, decode name)."""
    batch = {i: prompts[i] for i in range(7)}
    n_tok = sum(len(p) for p in batch.values())

    def prefill():
        eng.add_requests(batch)
        for sid in eng.live:
            eng.finish(sid)

    prefill_name = f"engine prefill 7 prompts {n_tok} tokens"
    _both(res, tag, prefill_name, prefill, device_line, runs=20)
    # Decode from prompts cut to 512 tokens: 4 x 23 timed calls of 4 steps
    # keep every sequence inside max_len.
    eng.add_requests({i: prompts[i][:512] for i in range(8)})
    steps = 4
    decode_name = f"engine decode step_many({steps}) 8 seqs ctx<=512+"
    _both(res, tag, decode_name, lambda: eng.step_many(steps), device_line,
          runs=20)
    for sid in eng.live:
        eng.finish(sid)
    ms = res[decode_name]
    res[decode_name + " tokens/s"] = tuple(8 * steps / t * 1e3 for t in ms)
    print(f"({tag}) engine decode: kernel {8 * steps / ms[0] * 1e3:.1f} "
          f"tokens/s, plain {8 * steps / ms[1] * 1e3:.1f} tokens/s "
          f"[{device_line}]")
    pf = res[prefill_name]
    print(f"({tag}) engine prefill: kernel {pf[0]:.3f} ms, plain {pf[1]:.3f} "
          f"ms for {n_tok} tokens [{device_line}]")
    return prefill_name, decode_name


def phase_quant_timings(qgpt, prompts, serving, device_line):
    """(k) K4 at the decode and prefill shapes beside the plain version and
    two library yardsticks (the dequantize-then-torch.mm path, three calls;
    torch.mm with the weight already bf16, the bf16-weight path, also in
    AB_ROUNDS rounds of torch.mm, K4, K4, torch.mm), int8-page
    decode beside bf16-page decode on the same values, and the quantized
    engine's prefill and decode beside (e)'s bf16 engine. A report, not a
    check. Returns {name: (kernel, plain[, kernel device, plain device])}
    plus bounds and yardsticks."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import quantization as quant
    from np_modeling_tpu_torch.ops.fused import sm_count
    res = {}
    rng = np.random.default_rng(SEED + 11)
    for m, k, n in K4_SHAPES:
        x, wq, scale, bias = _k4_inputs(m, k, n, rng)
        x = x.to(torch.bfloat16)
        w16 = (wq.float() * scale).to(torch.bfloat16)
        name = f"int8_matmul [{m}, {k}] x [{k}, {n}] bf16 bias"
        fn = (lambda x=x, wq=wq, scale=scale, bias=bias:
              ops.int8_matmul(x, wq, scale, bias))
        _both(res, "k", name, fn, device_line)
        _device_both(res, "k", name, fn, device_line)
        out = fn()
        res["bound " + name] = _bound(_nbytes(x, wq, scale, bias, out),
                                      2 * m * k * n)
        pair = (lambda x=x, wq=wq, scale=scale:
                torch.mm(x, (wq * scale).to(torch.bfloat16)))
        def bf16w(x=x, w16=w16):
            return torch.mm(x, w16)

        res["dequant+mm " + name] = (_cuda_ms(pair), _device_ms(pair))
        res["bf16 mm " + name] = (_cuda_ms(bf16w), _device_ms(bf16w))
        ab = _alternate(bf16w, fn, _device_ms)
        res["ab_mm " + name] = tuple(statistics.median(t) for t in ab)
        sched = quant.plan(m, n, k, sm_count(x.device),
                           aligned=x.data_ptr() % 16 == 0)
        print(f"(k) {name} ({sched.schedule}, {sched.n_tile}-column tiles, "
              f"{sched.splits} k splits): "
              f"{_ab_line(ab, 'torch.mm (bf16 weight)', 'K4', '.5f')} "
              f"[{device_line}]")
        print(f"(k) {name}: bound {res['bound ' + name][0]:.5f} ms "
              f"({res['bound ' + name][1]}); yardsticks, wall / device ms: "
              f"dequantize + torch.mm (three calls, no bias) "
              f"{res['dequant+mm ' + name][0]:.4f} / "
              f"{res['dequant+mm ' + name][1]:.4f}, torch.mm with a bf16 "
              f"weight {res['bf16 mm ' + name][0]:.4f} / "
              f"{res['bf16 mm ' + name][1]:.4f} [{device_line}]")
        del x, wq, scale, bias, w16, out
    lengths = rng.integers(512, 801, 8).tolist()
    q, k, v, lens, table = _pa_inputs(8, 1, 12, 12, 64, 16, lengths,
                                      torch.float32, rng, extra_pages=64)
    q = q.to(torch.bfloat16)
    k8, v8, kw = _int8_pages(k, v)
    k16, v16 = k.to(torch.bfloat16), v.to(torch.bfloat16)
    for name, kk, vv, kwargs in (
            ("paged_attention decode b8 ctx512-800 bf16 q, int8 pages", k8,
             v8, kw),
            ("paged_attention decode b8 ctx512-800 bf16 q, bf16 pages", k16,
             v16, {})):
        fn = (lambda kk=kk, vv=vv, kwargs=kwargs:
              ops.paged_attention(q, kk, vv, lens, table, **kwargs))
        _both(res, "k", name, fn, device_line)
        _device_both(res, "k", name, fn, device_line)
        res["bound " + name] = _paged_bound(q, kk, lens, table,
                                            tuple(kwargs.values()))
        print(f"(k) {name}: bound {res['bound ' + name][0]:.5f} ms "
              f"({res['bound ' + name][1]}) [{device_line}]")
    del q, k, v, k8, v8, k16, v16, kw
    prefill_name, decode_name = _engine_timings(
        res, "k", make_engine(qgpt, None, quantize_kv=True), prompts,
        device_line)
    q_tps = res[decode_name + " tokens/s"][0]
    b_tps = serving[decode_name + " tokens/s"][0]
    print(f"(k) int8 FFN weights + int8 pages vs (e)'s bf16 engine, kernels: "
          f"decode {q_tps:.1f} vs {b_tps:.1f} tokens/s (ratio "
          f"{q_tps / b_tps:.3f}), prefill {res[prefill_name][0]:.3f} vs "
          f"{serving[prefill_name][0]:.3f} ms [{device_line}]")
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


def _hold_fp32(tag, what, lk, gk, lp, ref):
    """The fp32 step-0 criteria: loss within 1e-5 relative of the reference
    step's, each gradient's relative L2 error <= 1e-4; the key bias by its
    size."""
    loss_err = abs(lk - lp) / abs(lp)
    errs = {n: _rel(gk[n], ref[n]) for n in ref if not _is_key_bias(n)}
    worst = max(errs, key=errs.get)
    print(f"{tag} fp32 step 0 (forward, backward, clip), {what}: loss "
          f"{lk:.7f} vs {lp:.7f} (relative err {loss_err:.2e}, tol 1e-05); "
          f"worst gradient relative L2 err {errs[worst]:.2e} ({worst}, tol "
          f"1e-04)")
    if not (math.isfinite(lk) and loss_err <= 1e-5 and errs[worst] <= 1e-4):
        raise AssertionError(f"{tag} fp32 step 0: {what} differ")
    _check_key_bias(f"{tag} fp32", gk, gk, 1e-4)


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
    are themselves only ~5e-2 from the fp32 step's. So the comparisons run
    on the bench GPT with gelu in place of relu (smooth, every other width
    the same): (1) in fp32 it must match the plain step to 1e-5 (loss) and
    1e-4 (each gradient's relative L2); (2) in bf16 its loss must match the
    plain step's to 5e-3, and each gradient must be no further from the
    fp32 plain step's (same weights) than 1.25 times the plain bf16 step's
    own distance, or 2e-2 (with relu that ratio changed from process to
    process)."""
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

    # (1) fp32, gelu twin: kernels vs plain; its plain gradients are the
    # reference of (2).
    twin = GPT(bench_gpt_config(None, "gelu"), device="cuda")
    twin.load_state_dict(gpt.state_dict())
    lk, lp, loss_err, worst, name, gk, ref = _compare_fp32(twin, tokens)
    print(f"(f) fp32 gelu step 0, kernels vs plain: loss {lk:.7f} vs "
          f"{lp:.7f} (relative err {loss_err:.2e}, tol 1e-05); worst "
          f"gradient relative L2 err {worst:.2e} ({name}, tol 1e-04)")
    if not (math.isfinite(lk) and loss_err <= 1e-5 and worst <= 1e-4):
        raise AssertionError("(f) fp32 gelu step: kernels differ from plain")
    _check_key_bias("(f) fp32 gelu", gk, gk, 1e-4)

    # The fp32 relu step: the relu-kink spread, reported.
    twin = GPT(bench_gpt_config(None), device="cuda")
    twin.load_state_dict(gpt.state_dict())
    lk, lp, loss_err, worst, name, _, _ = _compare_fp32(twin, tokens)
    print(f"(f) fp32 relu step 0, kernels vs plain: loss {lk:.7f} vs "
          f"{lp:.7f} (relative err {loss_err:.2e}); worst gradient relative "
          f"L2 err {worst:.2e} ({name}): relu-mask flips, not held")
    if not (math.isfinite(lk) and loss_err <= 1e-5):
        raise AssertionError("(f) fp32 relu step: loss differs from plain")
    del twin
    torch.cuda.empty_cache()

    # (2) bf16, the bench GPT's gelu twin: with relu the criterion flipped
    # from process to process (relu masks).
    twin = GPT(bench_gpt_config(torch.bfloat16, "gelu"), device="cuda")
    twin.load_state_dict(gpt.state_dict())
    lk, gk = _loss_and_grads(twin, tokens, plain=False)
    lp, gp = _loss_and_grads(twin, tokens, plain=True)
    _hold_bf16("(f)", lk, lp, gk, gp, ref)
    del gk, gp, ref, twin
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


def _library(tag, what, fn, device_line):
    """Wall and device ms of one PyTorch call that computes a kernel's
    function (its library yardstick; the port never calls it)."""
    t = (_cuda_ms(fn), _device_ms(fn))
    print(f"({tag}) library {what}: {t[0]:.4f} ms, device time {t[1]:.4f} ms "
          f"[{device_line}]")
    return t


def phase_train_timings(gpt, opt, params, state, tokens, device_line):
    import torch
    import torch.nn.functional as F
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
    b, h, s_len, d = q.shape
    pairs = b * h * d * s_len * (s_len + 1) // 2     # causal (q, k) pairs x d
    res["bound " + name] = _bound(_nbytes(q, k, v, q), 4 * pairs)

    def sdpa():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    res["library " + name] = _library(
        "g", "F.scaled_dot_product_attention(is_causal=True) forward", sdpa,
        device_line)
    ab = _alternate(sdpa, fwd, _device_ms)
    res["ab " + name] = [statistics.median(x) for x in ab]
    print(f"(g) {name}: device time {_ab_line(ab, 'SDPA forward', 'K1')}; "
          f"bound {res['bound ' + name][0]:.4f} ms [{device_line}]")
    lib_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*lib_leaves, is_causal=True)
    def sdpa_bwd():
        return torch.autograd.grad(o_lib, lib_leaves, do, retain_graph=True)

    res["library " + f"flash backward {shape}"] = _library(
        "g", "F.scaled_dot_product_attention backward (autograd)", sdpa_bwd,
        device_line)
    # dq, dk, dv out; q, k, v, o, do and the fp32 lse in.
    lse = torch.empty((b, h, s_len), dtype=torch.float32, device=q.device)
    res["bound " + f"flash backward {shape}"] = _bound(
        _nbytes(q, k, v, q, q, lse, q, k, v), 10 * pairs)
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
    ab = _alternate(sdpa_bwd, bwd(o_kernel), _device_ms)
    res["ab " + name] = [statistics.median(x) for x in ab]
    print(f"(g) {name}: device time {_ab_line(ab, 'SDPA backward', 'K2')}; "
          f"bound {res['bound ' + name][0]:.4f} ms [{device_line}]")
    del o_kernel, o_plain, lib_leaves, o_lib

    def fwd_bwd():
        o = ops.flash_attention(*leaves, causal=True)
        return torch.autograd.grad(o, leaves, do)

    _both(res, "g", f"flash forward+backward {shape}", fwd_bwd, device_line,
          runs=20)
    print(f"(g) K1 / K2 at the bench shape (no window or softcap: the "
          f"template variant without them): device "
          f"{res['flash forward ' + shape][2]:.4f} / "
          f"{res['flash backward ' + shape][2]:.4f} ms; PERF.md's table "
          f"before the wgmma kernels (same shape and card type): 1.3307 / "
          f"4.3636 ms (the mma.sync K1 read 1.3375 there) [{device_line}]")
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


def _step0(gpt, tokens, seed, plain, forced=False, **loss_kw):
    """Step 0 of the recipe without the update: loss, and the gradients
    after clip_by_global_norm(1.0), with dropout seeded by ``seed``; under
    force_plain() with ``plain``, under force_kernels() with ``forced``;
    ``loss_kw`` (segment ids, positions) go to GPT.loss."""
    from np_modeling_tpu_torch import training
    from np_modeling_tpu_torch.ops import dispatch
    gpt.zero_grad(set_to_none=True)
    scope = (dispatch.force_plain() if plain else dispatch.force_kernels()
             if forced else contextlib.nullcontext())
    with scope:
        loss = gpt.loss(tokens, training=True, rngs={"dropout": seed},
                        **loss_kw)
        loss.backward()
        grads, _ = training.clip_by_global_norm(1.0).update(
            {n: p.grad for n, p in gpt.named_parameters()}, ())
    return loss.item(), {n: g.detach().clone() for n, g in grads.items()}


def _launch_counts():
    from np_modeling_tpu_torch import ops
    return {"matmul": ops.matmul.launches,
            "matmul_ragged": ops.matmul.launches_ragged,
            "softmax_cross_entropy_fwd":
                ops.softmax_cross_entropy_fused.launches_fwd,
            "softmax_cross_entropy_bwd":
                ops.softmax_cross_entropy_fused.launches_bwd,
            "quantize_int8_stochastic": ops.quantize_int8_stochastic.launches,
            "dropout": ops.dropout.launches,
            "layer_norm_fwd": ops.layer_norm.launches_fwd,
            "layer_norm_bwd": ops.layer_norm.launches_bwd,
            "flash_attention_fwd": ops.flash_attention.launches_fwd,
            "flash_attention_bwd": ops.flash_attention.launches_bwd,
            "flash_attention_fwd_dual": ops.flash_attention.launches_fwd_dual,
            "flash_attention_bwd_split":
                ops.flash_attention.launches_bwd_split,
            "flash_attention_fwd_window":
                ops.flash_attention.launches_fwd_window,
            "flash_attention_bwd_window":
                ops.flash_attention.launches_bwd_window}


def _zero_launch_counts():
    from np_modeling_tpu_torch import ops
    ops.matmul.launches = ops.quantize_int8_stochastic.launches = 0
    ops.matmul.launches_ragged = 0
    ops.softmax_cross_entropy_fused.launches_fwd = 0
    ops.softmax_cross_entropy_fused.launches_bwd = 0
    ops.dropout.launches = 0
    ops.layer_norm.launches_fwd = ops.layer_norm.launches_bwd = 0
    ops.flash_attention.launches_fwd = ops.flash_attention.launches_bwd = 0
    ops.flash_attention.launches_fwd_dual = 0
    ops.flash_attention.launches_bwd_split = 0
    ops.flash_attention.launches_fwd_window = 0
    ops.flash_attention.launches_bwd_window = 0


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
    _hold_fp32("(h)", "kernels vs plain, same dropout seed", lk, gk, lp, ref)
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
    want = {"matmul": 0, "matmul_ragged": 0,
            "softmax_cross_entropy_fwd": 0,
            "softmax_cross_entropy_bwd": 0, "quantize_int8_stochastic": 0,
            "dropout": 2 * sites * GPT2_STEPS,
            "layer_norm_fwd": sites * GPT2_STEPS,
            "layer_norm_bwd": sites * GPT2_STEPS,
            "flash_attention_fwd": layers * GPT2_STEPS,
            "flash_attention_bwd": layers * GPT2_STEPS,
            "flash_attention_fwd_dual": 0, "flash_attention_bwd_split": 0,
            "flash_attention_fwd_window": 0, "flash_attention_bwd_window": 0}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(h) loss not finite: {losses}")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"(h) loss at step {GPT2_STEPS - 1} "
                             f"({losses[-1]}) not below step 1's "
                             f"({losses[1]})")
    if launches != want:
        raise AssertionError(f"(h) kernel launches {launches}, expected {want}")
    return gpt, corpus, launches


def phase_forced_training():
    """(l) The forced training path: (h)'s GPT-2 small run with every
    product of ops.linear through K11 (dispatch.force_kernels(), the
    counterpart of JAX's force_pallas(True)). Step 0 forced against the
    default step (cuBLAS products) with the same dropout seed, by (h)'s
    criteria; then FORCED_STEPS steps of train_gpt.train under
    force_kernels(): the loss stays finite and falls, and each step
    launches K11 216 times (12 layers x 6 Linears x forward, dx, dw). On
    the trained model's logits K9 (forward and backward) is held against
    softmax_cross_entropy_with_integer_labels, and K10 quantizes its final
    hidden states; neither changes K11's count. Returns the model, the
    corpus and the launch counts."""
    import torch
    from np_modeling_tpu_torch import ops, train_gpt
    from np_modeling_tpu_torch.models import GPT
    from np_modeling_tpu_torch.ops import dispatch
    cfg = gpt2_config(torch.bfloat16, drop_rate=0.1)
    gpt = GPT(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    corpus = zipf_corpus(cfg.vocab_size, 64 * GPT2_B, GPT2_S)
    tokens = torch.tensor(corpus[:GPT2_B], device="cuda")
    print(f"(l) GPT-2 small as in (h), every Linear's forward, dx and dw "
          f"through K11 under dispatch.force_kernels()")
    seed = SEED + 7
    twin = GPT(gpt2_config(None, drop_rate=0.1), device="cuda")
    twin.load_state_dict(gpt.state_dict())
    ops.matmul.launches = 0
    lk, gk = _step0(twin, tokens, seed, plain=False, forced=True)
    fp32_launches = ops.matmul.launches
    lp, ref = _step0(twin, tokens, seed, plain=False)
    del twin
    _hold_fp32("(l)", f"forced vs default, same dropout seed, K11 launches "
               f"{fp32_launches}", lk, gk, lp, ref)
    if fp32_launches != 216:
        raise AssertionError(f"(l) fp32 step 0: {fp32_launches} K11 launches, "
                             "expected 216")
    del gk
    lk, gk = _step0(gpt, tokens, seed, plain=False, forced=True)
    lp, gp = _step0(gpt, tokens, seed, plain=False)
    _hold_bf16("(l) forced vs default,", lk, lp, gk, gp, ref)
    del gk, gp, ref
    torch.cuda.empty_cache()

    _zero_launch_counts()
    after_first = []

    def log(line):
        after_first.append(ops.matmul.launches)
        print(f"(l) {line}")

    t0 = time.perf_counter()
    with dispatch.force_kernels():
        losses, _ = train_gpt.train(gpt, corpus, FORCED_STEPS, GPT2_B,
                                    "cuda", log=log)
    losses = losses.tolist()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    print(f"(l) {FORCED_STEPS} forced steps in {seconds:.1f} s; losses "
          f"{[round(x, 4) for x in losses]}; K11 launches after step 0 "
          f"{after_first[0]}; kernel launches {launches}")
    sites, layers = 2 * cfg.num_layers + 1, cfg.num_layers
    want = {"matmul": 216 * FORCED_STEPS, "matmul_ragged": 0,
            "softmax_cross_entropy_fwd": 0,
            "softmax_cross_entropy_bwd": 0, "quantize_int8_stochastic": 0,
            "dropout": 2 * sites * FORCED_STEPS,
            "layer_norm_fwd": sites * FORCED_STEPS,
            "layer_norm_bwd": sites * FORCED_STEPS,
            "flash_attention_fwd": layers * FORCED_STEPS,
            "flash_attention_bwd": layers * FORCED_STEPS,
            "flash_attention_fwd_dual": 0, "flash_attention_bwd_split": 0,
            "flash_attention_fwd_window": 0, "flash_attention_bwd_window": 0}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(l) loss not finite: {losses}")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"(l) loss at step {FORCED_STEPS - 1} "
                             f"({losses[-1]}) not below step 1's "
                             f"({losses[1]})")
    if launches != want or after_first[0] != 216:
        raise AssertionError(f"(l) kernel launches {launches}, expected "
                             f"{want} (216 K11 a step)")

    # K9 on the trained model's logits, bf16 [8192, 50257], against the
    # op GPT.loss uses; K10 on its final hidden states.
    targets = torch.roll(tokens, -1, dims=-1)
    with torch.no_grad():
        logits = gpt.apply(tokens, logits_dtype=torch.bfloat16)
        hidden = gpt.apply(tokens, return_hidden=True)
    g = torch.full(targets.shape, 1.0 / targets.numel(), device="cuda")
    k11_before = ops.matmul.launches
    results = []
    for fn in (ops.softmax_cross_entropy_fused,
               ops.softmax_cross_entropy_with_integer_labels):
        leaf = logits.clone().requires_grad_()
        ce = fn(leaf, targets)
        ce.backward(g)
        results.append((ce.detach(), leaf.grad))
        del leaf, ce
    (ce_k, dl_k), (ce_r, dl_r) = results
    torch.cuda.synchronize()
    ce_err = (ce_k - ce_r).abs().max().item()
    dl_err, dl_ok = _dlogits_err(dl_k, dl_r)
    print(f"(l) K9 on the step's logits {tuple(logits.shape)} bf16 vs "
          f"softmax_cross_entropy_with_integer_labels: ce max abs err "
          f"{ce_err:.3e}, dlogits {dl_err:.3e}")
    if not (ce_err <= LN_F32_TOL * max(1.0, ce_r.abs().max().item())
            and dl_ok):
        raise AssertionError("(l) K9 differs from the integer-label CE")
    del logits, results, ce_k, dl_k, ce_r, dl_r
    qt = _check_k10(f"(l) K10 on the step's hidden states "
                    f"{tuple(hidden.shape)} bf16", hidden, SEED + 16)
    deq_err = ((qt.values.float() * qt.scales - hidden.float()).abs()
               / qt.scales).max().item()
    print(f"(l) K10 on the step's final hidden states {tuple(hidden.shape)}"
          f" bf16: equal to the plain twin; max |dequantized - x| "
          f"{deq_err:.4f} steps (< 1)")
    if not deq_err < 1.0 + 1e-5:
        raise AssertionError("(l) K10: error of a step or more")
    if ops.matmul.launches != k11_before:
        raise AssertionError("(l) K9/K10 changed K11's launch count")
    counts = _launch_counts()
    print(f"(l) kernel launches of the whole phase after the counts were set "
          f"to 0: {counts}")
    del hidden, qt
    torch.cuda.empty_cache()
    return gpt, corpus, counts


def phase_forced_timings(gpt, corpus, device_line):
    """(m) K11 at the step's product shapes (kernel, plain, cuBLAS), and
    the sum over one step's 216 products; the 8192^3 bf16 diagnostic
    beside torch.mm; K9 forward and backward at [8192, 50257] bf16 beside
    F.cross_entropy; K10 at [8192, 768] fp32 (no library call computes
    it); the forced GPT-2 step beside the default step."""
    import torch
    import torch.nn.functional as F
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    res = {}
    rng = np.random.default_rng(SEED + 17)
    f16 = torch.bfloat16

    def forced(fn):
        def run():
            with dispatch.force_kernels():
                return fn()
        return run

    step_k = step_lib = 0.0
    step_ab = [0.0, 0.0]      # library, K11: the in-turn medians' sums
    for (m, k, n, ta, tb, with_bias), uses in zip(STEP_PRODUCTS, STEP_USES):
        a, b, bias = _mm_operands(m, k, n, ta, tb, rng)
        a, b = a.to(f16), b.to(f16)
        bias = bias if with_bias else None
        name = (f"matmul [{m}, {k}] x [{k}, {n}] trans_a={ta} trans_b={tb}"
                f"{' bias' if with_bias else ''} bf16")

        def k11(a=a, b=b, bias=bias, ta=ta, tb=tb):
            return ops.matmul(a, b, bias, trans_a=ta, trans_b=tb)

        def plain(a=a, b=b, bias=bias, ta=ta, tb=tb):
            return ops.matmul_reference(a, b, bias, trans_a=ta, trans_b=tb)

        _both(res, "m", name, forced(k11), device_line, plain_fn=plain)
        _device_both(res, "m", name, forced(k11), device_line,
                     plain_fn=plain)
        res["bound " + name] = _bound(_nbytes(a, b) + 2 * m * n
                                      + (4 * n if with_bias else 0),
                                      2 * m * k * n)
        # The library call: the default path's cuBLAS product (addmm with a
        # bf16 bias where there is one).
        a_op, b_op = (a.t() if ta else a), (b.t() if tb else b)
        if with_bias:
            b16 = bias.to(f16)
            lib = (lambda a_op=a_op, b_op=b_op, b16=b16:
                   torch.addmm(b16, a_op, b_op))
            what = "torch.addmm"
        else:
            lib = lambda a_op=a_op, b_op=b_op: torch.mm(a_op, b_op)  # noqa
            what = "torch.mm"
        res["library " + name] = _library("m", f"{what} {name}", lib,
                                          device_line)
        ab = _alternate(lib, forced(k11), _device_ms)
        res["ab " + name] = [statistics.median(x) for x in ab]
        print(f"(m) {name} [K11 %s, %d split(s)]: device time "
              % _k11_plan(a, b, ta, tb)
              + _ab_line(ab, what, "K11") + f" [{device_line}]")
        step_k += 12 * uses * res[name][2]
        step_lib += 12 * uses * res["library " + name][1]
        step_ab = [x + 12 * uses * y for x, y in zip(step_ab,
                                                      res["ab " + name])]
        del a, b, bias, a_op, b_op
    flops = 12 * sum(2 * m * k * n * u for (m, k, n, *_), u
                     in zip(STEP_PRODUCTS, STEP_USES))
    res["k11 step"] = (step_k, step_lib, flops / PEAK_BF16_S * 1e3)
    print(f"(m) one GPT-2 step's 216 products ({flops:.3e} FLOP): K11 "
          f"{step_k:.3f} ms, cuBLAS {step_lib:.3f} ms of device time, bound "
          f"{res['k11 step'][2]:.3f} ms; from the in-turn medians: K11 "
          f"{step_ab[1]:.3f} ms, the library {step_ab[0]:.3f} ms, "
          f"{step_ab[1] / step_ab[0]:.3f}x [{device_line}]")
    res["k11 step ab"] = step_ab

    a = torch.randn(8192, 8192, device="cuda").to(f16)
    b = torch.randn(8192, 8192, device="cuda").to(f16)
    name = "matmul [8192, 8192] x [8192, 8192] bf16"
    ab = _alternate(lambda: torch.mm(a, b), forced(lambda: ops.matmul(a, b)),
                    lambda f: _device_ms(f, runs=10), rounds=3)
    k11_ms, mm_ms = (statistics.median(x) for x in (ab[1], ab[0]))
    res["diag"] = (k11_ms, mm_ms, _bound(_nbytes(a, b, a), 2 * 8192 ** 3)[0])
    print(f"(m) {name}: device time {_ab_line(ab, 'torch.mm', 'K11')}")
    print(f"(m) {name}: K11 {k11_ms:.3f} ms ({2 * 8192 ** 3 / k11_ms / 1e9:.1f}"
          f" TFLOP/s), torch.mm {mm_ms:.3f} ms "
          f"({2 * 8192 ** 3 / mm_ms / 1e9:.1f} TFLOP/s), bound "
          f"{res['diag'][2]:.3f} ms [{device_line}]")
    del a, b
    torch.cuda.empty_cache()

    n_rows, v = GPT2_B * GPT2_S, 50257
    logits = (torch.randn(n_rows, v, device="cuda") * 3).to(f16)
    labels = torch.randint(0, v, (n_rows,), device="cuda")
    g = torch.full((n_rows,), 1.0 / n_rows, device="cuda")
    fwd_name = f"softmax_cross_entropy_fused forward [{n_rows}, {v}] bf16"
    bwd_name = fwd_name.replace("forward", "backward")

    def fwd():
        with torch.no_grad():
            return ops.softmax_cross_entropy_fused(logits, labels)

    _both(res, "m", fwd_name, fwd, device_line)
    _device_both(res, "m", fwd_name, fwd, device_line)
    ce = fwd()
    res["bound " + fwd_name] = _bound(_nbytes(logits, labels, ce, ce), 0)
    leaf = logits.clone().requires_grad_()
    out_k = ops.softmax_cross_entropy_fused(leaf, labels)
    with dispatch.force_plain():
        out_p = ops.softmax_cross_entropy_fused(leaf, labels)

    def bwd(o):
        return lambda: torch.autograd.grad(o, leaf, g, retain_graph=True)

    _both(res, "m", bwd_name, bwd(out_k), device_line, plain_fn=bwd(out_p))
    _device_both(res, "m", bwd_name, bwd(out_k), device_line,
                 plain_fn=bwd(out_p))
    res["bound " + bwd_name] = _bound(
        _nbytes(logits, labels, ce, ce, logits), 0)
    del out_k, out_p

    def lib_fwd():
        with torch.no_grad():
            return F.cross_entropy(logits, labels, reduction="none")

    res["library " + fwd_name] = _library(
        "m", "F.cross_entropy(reduction='none') forward", lib_fwd,
        device_line)
    lib_out = F.cross_entropy(leaf, labels, reduction="none")
    res["library " + bwd_name] = _library(
        "m", "F.cross_entropy backward (autograd)",
        lambda: torch.autograd.grad(lib_out, leaf, g.to(lib_out.dtype),
                                    retain_graph=True), device_line)
    del logits, leaf, lib_out, ce
    torch.cuda.empty_cache()

    x = torch.randn(GPT2_B * GPT2_S, 768, device="cuda")
    name = f"quantize_int8_stochastic [{GPT2_B * GPT2_S}, 768] fp32"
    quant = (lambda: ops.quantize_int8_stochastic(x, 12345))  # noqa: E731
    _both(res, "m", name, quant, device_line)
    _device_both(res, "m", name, quant, device_line)
    qt = quant()
    res["bound " + name] = _bound(_nbytes(x, qt.values, qt.scales), 0)
    del x, qt

    step = _entry_step(gpt, corpus)
    name = (f"train step (forward, backward, clip, adamw) b{GPT2_B} "
            f"s{GPT2_S} GPT-2 small dropout 0.1 bf16, K11 forced")
    # "kernel" is the forced step, "plain" the default step (cuBLAS).
    _both(res, "m", name, forced(step), device_line, runs=10, warmup=2,
          plain_fn=step)
    ms = res[name]
    print(f"(m) GPT-2 small step: forced (K11) {ms[0]:.3f} ms, default "
          f"(cuBLAS) {ms[1]:.3f} ms [{device_line}]")
    return res


def _device_both(res, tag, name, fn, device_line, plain_fn=None):
    """Device time of kernel and plain version (order plain, kernel, kernel,
    plain), kept beside the CUDA-event times in ``res[name]``."""
    plain_fn = plain_fn or _plain(fn)
    t = [_device_ms(f) for f in (plain_fn, fn, fn, plain_fn)]
    res[name] += (min(t[1], t[2]), min(t[0], t[3]))
    print(f"({tag}) {name}: device time kernel {t[1]:.4f} / {t[2]:.4f} ms, plain "
          f"{t[0]:.4f} / {t[3]:.4f} ms (CUDA events over up to 20 calls "
          f"queued behind a sleep kernel) [{device_line}]")


def _entry_step(gpt, corpus, batch=GPT2_B, steps=GPT2_STEPS):
    """One step of the entry point's recipe (scheduled over ``steps``) on the
    corpus's first batch of ``batch`` rows, as a call without arguments (the
    optimizer state carried across calls)."""
    import torch
    from np_modeling_tpu_torch import train_gpt, training
    from np_modeling_tpu_torch.training import data
    opt = train_gpt.recipe(steps)
    params = dict(gpt.named_parameters())
    box = [opt.init(params)]
    step = training.make_train_step(gpt.loss, lambda loss, _: loss, opt)
    (tokens,) = next(data.prefetch_to_device(
        data.batches([corpus], batch, seed=SEED), device="cuda"))
    g = torch.Generator().manual_seed(SEED)

    def train_step():
        _, box[0], _ = step(params, box[0], tokens, None, g)

    return train_step


def _kind(kernel):
    """The section of PERF.md's step breakdown that a device op falls in."""
    if "paged_attention_kernel" in kernel or "paged_attention_merge" in kernel:
        return "K3 paged attention"
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


def _profile(tag, what, step, device_line, warmup=PROFILE_WARMUP):
    """Where ``step()`` spends the card's time: its wall time without a
    profiler (median of 10 after ``warmup``, returned), then torch.profiler
    over PROFILE_STEPS calls: device ms a call by kernel and by kind, and
    the device ops a call. The device's idle share of the unprofiled call
    is 1 - busy / wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    wall = _cuda_ms(step, runs=10, warmup=warmup)
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
        print(f"({tag}) torch.profiler saw no device time; no breakdown "
              f"[{device_line}]")
        return wall
    ops_per_step = sum(n for _, n in per_kernel.values())
    print(f"({tag}) {what}: {wall:.3f} ms without the profiler (median of 10 "
          f"after {warmup}); device busy {busy:.3f} ms a call, idle share "
          f"{1 - busy / wall:.3f}; {ops_per_step:.0f} device ops a call "
          f"[{device_line}]")
    kinds = {}
    for key, (ms, n) in per_kernel.items():
        kind = kinds.setdefault(_kind(key), [0.0, 0.0])
        kind[0] += ms
        kind[1] += n
    for kind, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"({tag}) {ms:9.3f} ms/call {100 * ms / busy:5.1f}% x {n:6.0f}  "
              f"{kind}")
    for key, (ms, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0]):
        print(f"({tag}) {ms:9.3f} ms/call x {n:6.1f}  {key[:110]}")
    return wall


def phase_profile(gpt, corpus, device_line):
    """The entry point's step, profiled (``_profile``)."""
    _profile("p", "entry-point step", _entry_step(gpt, corpus), device_line)


def phase_entry_timings(gpt, corpus, device_line):
    """CUDA-event times (a call's wall time, host included) and device
    times (kernels only) of K8 and K7 and their plain versions, then the
    whole train step. ``res[name]`` = (kernel, plain[, kernel device, plain
    device]) ms."""
    import torch
    import torch.nn.functional as F
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
        name = f"layer_norm forward [{rows}, {d}] bf16"
        bwd_name = name.replace("forward", "backward")
        res["bound " + name] = _bound(_nbytes(x, x, gamma, beta), 0)
        res["bound " + bwd_name] = _bound(
            _nbytes(x, dz, gamma, x, gamma, beta), 0)
        print(f"(i) bounds: {name} {res['bound ' + name][0]:.5f} ms, "
              f"{bwd_name} {res['bound ' + bwd_name][0]:.5f} ms (bytes)")
        # The library call takes the affine parameters in x's dtype.
        lx, lg, lb = (t.clone().requires_grad_()
                      for t in (x, gamma.to(x.dtype), beta.to(x.dtype)))

        def lib_fwd(lx=lx, lg=lg, lb=lb, d=d):
            with torch.no_grad():
                return F.layer_norm(lx, (d,), lg, lb, LN_EPS)

        res["library " + name] = _library(
            "i", f"F.layer_norm forward [{rows}, {d}] bf16", lib_fwd,
            device_line)
        ly = F.layer_norm(lx, (d,), lg, lb, LN_EPS)

        def lib_bwd(ly=ly, lx=lx, lg=lg, lb=lb, dz=dz):
            return torch.autograd.grad(ly, (lx, lg, lb), dz, retain_graph=True)

        res["library " + bwd_name] = _library(
            "i", f"F.layer_norm backward (autograd) [{rows}, {d}] bf16",
            lib_bwd, device_line)
        ab = _alternate(lib_bwd, bwd, _device_ms)
        res["ab " + bwd_name] = tuple(statistics.median(t) for t in ab)
        bound = res["bound " + bwd_name][0]
        print(f"(i) {bwd_name}: "
              f"{_ab_line(ab, 'F.layer_norm autograd backward', 'K8', '.5f')}"
              f"; {bound / res['ab ' + bwd_name][1]:.1%} of its bound "
              f"[{device_line}]")
        del lx, lg, lb, ly
    x = rand(GPT2_B, GPT2_S, 768)
    seed = 12345

    def drop():
        with torch.no_grad():
            return ops.dropout(x, seed, 0.1)

    name = f"dropout [{GPT2_B}, {GPT2_S}, 768] bf16 rate 0.1"
    _both(res, "i", name, drop, device_line)
    _device_both(res, "i", name, drop, device_line)
    res["bound " + name] = _bound(_nbytes(x, x), 0)

    def lib_drop():
        with torch.no_grad():
            return F.dropout(x, 0.1, training=True)

    res["library " + name] = _library("i", f"F.dropout {name[8:]}", lib_drop,
                                      device_line)
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


def packed_corpus(vocab, rows, seed=SEED):
    """(n)'s corpus: seeded Zipf tokens [rows, GPT2_S] with documents packed
    by pack_rows; returns tokens, segment ids and positions."""
    tokens = zipf_corpus(vocab, rows, GPT2_S, seed)
    seg, pos = pack_rows(np.random.default_rng(seed + 22), rows, GPT2_S)
    return tokens, seg, pos


def _packed_batches(packed):
    """data.epochs over the packed arrays, a dict a batch, through
    prefetch_to_device onto the card."""
    from np_modeling_tpu_torch.training import data
    batches = ({"tokens": t, "segment_ids": s, "positions": p}
               for t, s, p in data.epochs(list(packed), GPT2_B,
                                          num_epochs=100))
    return data.prefetch_to_device(batches, device="cuda")


def _packed_loss(gpt):
    """GPT.loss on a packed batch dict, as make_train_step's apply_fn."""
    def loss(batch, training=False, rngs=None):
        return gpt.loss(batch["tokens"], training=training, rngs=rngs,
                        segment_ids=batch["segment_ids"],
                        positions=batch["positions"])
    return loss


def _check_isolation(twin, batch):
    """Eval, fp32, the kernels: each document's logits inside its packed
    row equal those of the document run alone at positions 0..len-1, to
    1e-4 x max(1, max |logit|). Returns (documents, worst err / bound)."""
    import torch
    seg = batch["segment_ids"].cpu().numpy()
    worst, n_docs = 0.0, 0
    with torch.no_grad():
        packed = twin.apply(batch["tokens"], segment_ids=batch["segment_ids"],
                            positions=batch["positions"])
        for r in range(seg.shape[0]):
            for doc in np.unique(seg[r]):
                cols = torch.tensor(np.flatnonzero(seg[r] == doc),
                                    device="cuda")
                alone = twin.apply(batch["tokens"][r:r + 1, cols])[0]
                want = packed[r, cols]
                err = (alone - want).abs().max().item()
                bound = F32_TOL * max(1.0, want.abs().max().item())
                if not err <= bound:
                    raise AssertionError(
                        f"(n) isolation: row {r} document {doc} "
                        f"({len(cols)} tokens) max abs err {err} > {bound}")
                worst, n_docs = max(worst, err / bound), n_docs + 1
    return n_docs, worst


def phase_packed_training():
    """(n) Packed-document training of GPT-2 small: isolation, step 0 with
    K1 + K2 and with K1 + K5 against the plain step, the dual forward's
    step 0 against K1's, then GPT2_STEPS split-backward steps of the
    recipe (the main path). Returns the model, the packed corpus and the
    launch counts {"segments", "split", "dual"}."""
    import torch
    from np_modeling_tpu_torch import train_gpt, training
    from np_modeling_tpu_torch.models import GPT
    cfg = gpt2_config(torch.bfloat16, drop_rate=0.1)
    gpt = GPT(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    packed = packed_corpus(cfg.vocab_size, 64 * GPT2_B)
    n_docs = sum(len(np.unique(r)) for r in packed[1])
    lens = np.concatenate([np.unique(r, return_counts=True)[1]
                           for r in packed[1]])
    print(f"(n) packed GPT-2 small as in (h): {n_docs} documents of seeded "
          f"Zipf tokens in {len(packed[0])} rows of {GPT2_S} (lengths "
          f"geometric, mean {DOC_MEAN}, clipped to [{DOC_MIN}, {GPT2_S}]; "
          f"packed mean {lens.mean():.1f}, max {lens.max()}); batches "
          f"data.epochs -> dict -> prefetch_to_device")
    it = _packed_batches(packed)
    first = next(it)
    kw = {"segment_ids": first["segment_ids"], "positions": first["positions"]}
    tokens = first["tokens"]

    twin = GPT(gpt2_config(None, drop_rate=0.1), device="cuda")
    twin.load_state_dict(gpt.state_dict())
    docs, worst = _check_isolation(twin, first)
    print(f"(n) isolation (eval, fp32, kernels): {docs} documents of the "
          f"first batch, each equal to itself alone at positions 0..len-1; "
          f"worst max abs err {worst:.3f} of its bound (1e-4 x max(1, max "
          f"|logit|))")
    seed = SEED + 7
    lp, ref = _step0(twin, tokens, seed, plain=True, **kw)
    lp16, gp16 = _step0(gpt, tokens, seed, plain=True, **kw)
    for fused_bwd, name in ((True, "K1 + K2"), (False, "K1 + K5")):
        with _schedule(fused_bwd=fused_bwd):
            lk, gk = _step0(twin, tokens, seed, plain=False, **kw)
            _hold_fp32("(n) packed", f"{name} vs plain, same dropout seed",
                       lk, gk, lp, ref)
            del gk
            lk, gk = _step0(gpt, tokens, seed, plain=False, **kw)
            _hold_bf16(f"(n) packed {name},", lk, lp16, gk, gp16, ref)
            del gk
    del twin, ref, gp16
    torch.cuda.empty_cache()

    # The dual-kv forward: (h)'s unpacked step 0 on the same rows.
    _zero_launch_counts()
    with _schedule(dual=True):
        l_dual, _ = _step0(gpt, tokens, seed, plain=False)
    dual_counts = _launch_counts()
    l_single, _ = _step0(gpt, tokens, seed, plain=False)
    print(f"(n) unpacked step 0, K12 vs K1 forward, same dropout seed: loss "
          f"{l_dual!r} vs {l_single!r}; launches K12 "
          f"{dual_counts['flash_attention_fwd_dual']}, K1 "
          f"{dual_counts['flash_attention_fwd']} (expected "
          f"{cfg.num_layers}, 0)")
    if (l_dual != l_single or dual_counts["flash_attention_fwd_dual"]
            != cfg.num_layers or dual_counts["flash_attention_fwd"] != 0):
        raise AssertionError("(n) K12 step differs from K1's, or K12 did "
                             "not carry its forward")
    torch.cuda.empty_cache()

    opt = train_gpt.recipe(GPT2_STEPS)
    params = dict(gpt.named_parameters())
    state = opt.init(params)
    step = training.make_train_step(_packed_loss(gpt), lambda loss, _: loss,
                                    opt)
    g = torch.Generator().manual_seed(1)
    _zero_launch_counts()
    t0 = time.perf_counter()
    losses = []
    with _schedule(fused_bwd=False):
        for _ in range(GPT2_STEPS):
            params, state, loss = step(params, state, next(it), None, g)
            losses.append(loss)
    losses = torch.stack(losses).tolist()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    print(f"(n) {GPT2_STEPS} packed steps of the recipe, FUSED_BWD=False, in "
          f"{seconds:.1f} s; losses {[round(x, 4) for x in losses]}; kernel "
          f"launches {launches}")
    sites, layers = 2 * cfg.num_layers + 1, cfg.num_layers
    want = {"matmul": 0, "matmul_ragged": 0,
            "softmax_cross_entropy_fwd": 0,
            "softmax_cross_entropy_bwd": 0, "quantize_int8_stochastic": 0,
            "dropout": 2 * sites * GPT2_STEPS,
            "layer_norm_fwd": sites * GPT2_STEPS,
            "layer_norm_bwd": sites * GPT2_STEPS,
            "flash_attention_fwd": layers * GPT2_STEPS,
            "flash_attention_bwd": 0, "flash_attention_fwd_dual": 0,
            "flash_attention_bwd_split": layers * GPT2_STEPS,
            "flash_attention_fwd_window": 0, "flash_attention_bwd_window": 0}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(n) loss not finite: {losses}")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"(n) loss at step {GPT2_STEPS - 1} "
                             f"({losses[-1]}) not below step 1's "
                             f"({losses[1]})")
    if launches != want:
        raise AssertionError(f"(n) kernel launches {launches}, expected "
                             f"{want}")
    counts = {"segments": launches["flash_attention_fwd"],
              "split": launches["flash_attention_bwd_split"],
              "dual": dual_counts["flash_attention_fwd_dual"]}
    return gpt, packed, counts


def _kernel_split_ms(fn, patterns, calls=5):
    """Device ms a call of ``fn`` spends in the kernels whose names hold
    each of ``patterns`` (torch.profiler), or None where it sees none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(patterns)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        for pat in patterns:
            if pat in e.key:
                out[pat] = (out[pat] or 0.0) + us / 1e3 / calls
    return out


AB_ROUNDS = 5


def _alternate(fn_a, fn_b, timer, rounds=AB_ROUNDS):
    """``rounds`` rounds of a, b, b, a through ``timer``: (a's times, b's)."""
    a, b = [], []
    for _ in range(rounds):
        t = [timer(f) for f in (fn_a, fn_b, fn_b, fn_a)]
        a += [t[0], t[3]]
        b += [t[1], t[2]]
    return a, b


def _ab_line(ab, name_a, name_b, fmt=".4f"):
    """Medians and ranges of an _alternate result, and b's ratio to a."""
    med = [statistics.median(x) for x in ab]
    return (f"{name_b} median {med[1]:{fmt}} ms (range {min(ab[1]):{fmt}}.."
            f"{max(ab[1]):{fmt}}) against {name_a} median {med[0]:{fmt}} ms "
            f"(range {min(ab[0]):{fmt}}..{max(ab[0]):{fmt}}), "
            f"{med[1] / med[0]:.3f}x, {len(ab[0])} readings each in rounds "
            f"of {name_a}, {name_b}, {name_b}, {name_a}")


def _bwd_timings(res, tag, shape, q, k, v, do, device_line, pairs, **kw):
    """K5's backward (and its dq and dk/dv kernels) beside K2 and the
    plain backward on the same inputs; returns K5's name in ``res``. Its
    bound is the function's work, K2's: 10 operations a (q, k) pair and
    feature of the ``pairs`` the inputs need (K5's two extra products a
    pair are its schedule's price, not work the gradients need)."""
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_k2 = ops.flash_attention(*leaves, causal=True, **kw)
    with _schedule(fused_bwd=False):
        o_k5 = ops.flash_attention(*leaves, causal=True, **kw)
    with dispatch.force_plain():
        o_plain = ops.flash_attention(*leaves, causal=True, **kw)

    def bwd(o):
        return lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)

    name = f"flash backward split {shape}"
    _both(res, tag, name, bwd(o_k5), device_line, runs=20,
          plain_fn=bwd(o_plain))
    _device_both(res, tag, name, bwd(o_k5), device_line,
                 plain_fn=bwd(o_plain))
    ab = _alternate(bwd(o_k2), bwd(o_k5), _device_ms)
    res["K2 " + name] = statistics.median(ab[0])
    parts = _kernel_split_ms(bwd(o_k5), ("flash_bwd_dq", "flash_bwd_bf16"))
    res["parts " + name] = parts
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
    seg = kw.get("segment_ids")
    res["bound " + name] = _bound(
        _nbytes(q, k, v, q, q, lse, q, k, v, *(() if seg is None else
                                               (seg, seg))), 10 * pairs)
    print(f"({tag}) {name}: device time {_ab_line(ab, 'K2', 'K5')}; "
          f"K5's kernels (torch.profiler, a call): dq "
          f"{parts['flash_bwd_dq'] or 'not measured'} ms, dk/dv "
          f"{parts['flash_bwd_bf16'] or 'not measured'} ms; bound "
          f"{res['bound ' + name][0]:.5f} ms ({res['bound ' + name][1]}) "
          f"[{device_line}]")
    return name


def phase_packed_timings(gpt, corpus, packed, device_line):
    """(o) K5 beside K2 and F.scaled_dot_product_attention's autograd
    backward at the bench shape and the packed GPT-2 shape; K12 beside K1
    and SDPA forward at the bench shape; K1/K2 with segment ids beside
    without at the GPT-2 shape, SDPA with the documents' boolean mask as
    yardstick; the packed step (K2 and K5) beside (h)'s unpacked step.
    Bounds count the work these inputs need: causal pairs, and with
    segment ids the pairs inside a document."""
    import torch
    import torch.nn.functional as F
    from np_modeling_tpu_torch import ops, training, train_gpt
    res = {}
    rng = np.random.default_rng(SEED + 23)
    f16 = torch.bfloat16

    # The bench shape, no segment ids: K5 and K12.
    q, k, v, do = _flash_inputs(LAYER_SHAPE, f16, rng)
    shape = "b4 h8 s4096 d128 causal bf16"
    b, h, s_len, d = q.shape
    pairs = b * h * d * s_len * (s_len + 1) // 2
    name = _bwd_timings(res, "o", shape, q, k, v, do, device_line, pairs)
    lib_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*lib_leaves, is_causal=True)
    res["library " + name] = _library(
        "o", "F.scaled_dot_product_attention backward (autograd)",
        lambda: torch.autograd.grad(o_lib, lib_leaves, do, retain_graph=True),
        device_line)
    del lib_leaves, o_lib

    def fwd():
        with torch.no_grad():
            return ops.flash_attention(q, k, v, causal=True)

    def fwd_dual():
        with _schedule(dual=True):
            return fwd()

    name = f"flash forward dual {shape}"
    _both(res, "o", name, fwd_dual, device_line, runs=20)
    _device_both(res, "o", name, fwd_dual, device_line)
    ab = _alternate(fwd, fwd_dual, _device_ms)
    res["K1 " + name] = statistics.median(ab[0])
    print(f"(o) {name}: device time {_ab_line(ab, 'K1', 'K12')} "
          f"[{device_line}]")
    res["bound " + name] = _bound(_nbytes(q, k, v, q), 4 * pairs)

    def sdpa():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    res["library " + name] = _library(
        "o", "F.scaled_dot_product_attention(is_causal=True) forward", sdpa,
        device_line)
    ab = _alternate(sdpa, fwd_dual, _device_ms)
    res["ab " + name] = [statistics.median(x) for x in ab]
    print(f"(o) {name}: device time {_ab_line(ab, 'SDPA forward', 'K12')} "
          f"[{device_line}]")
    del q, k, v, do
    torch.cuda.empty_cache()

    # The packed GPT-2 shape: K1/K2 with segment ids beside without, and K5.
    q, k, v, do = _flash_inputs(GPT2_LAYER, f16, rng)
    seg_np = packed[1][:GPT2_B]
    seg = torch.tensor(seg_np, device="cuda")
    shape = "b8 h12 s1024 d64 causal bf16"
    b, h, s_len, d = q.shape
    doc_pairs = h * d * _doc_pairs(seg_np)

    def fwd_seg():
        with torch.no_grad():
            return ops.flash_attention(q, k, v, segment_ids=seg, causal=True)

    def fwd_none():
        with torch.no_grad():
            return ops.flash_attention(q, k, v, causal=True)

    name = f"flash forward segments {shape}"
    _both(res, "o", name, fwd_seg, device_line, runs=20)
    _device_both(res, "o", name, fwd_seg, device_line)
    res["bound " + name] = _bound(_nbytes(q, k, v, q, seg, seg), 4 * doc_pairs)
    keep = seg[:, None, :, None] == seg[:, None, None, :]
    keep &= torch.ones(s_len, s_len, dtype=torch.bool, device="cuda").tril()

    def sdpa_seg():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=keep)

    res["library " + name] = _library(
        "o", "F.scaled_dot_product_attention(attn_mask=documents & causal) "
        "forward", sdpa_seg, device_line)
    ab = _alternate(sdpa_seg, fwd_seg, _device_ms)
    res["ab " + name] = [statistics.median(x) for x in ab]
    print(f"(o) {name}: device time "
          f"{_ab_line(ab, 'SDPA forward with the mask', 'K1')} "
          f"[{device_line}]")
    t = [_device_ms(f) for f in (fwd_none, fwd_seg, fwd_seg, fwd_none)]
    res["K1 no segments " + name] = min(t[0], t[3])
    print(f"(o) {name}: device time with segment ids {t[1]:.4f} / {t[2]:.4f} "
          f"ms, without {t[0]:.4f} / {t[3]:.4f} ms; bound "
          f"{res['bound ' + name][0]:.5f} ms ({_doc_pairs(seg_np)} "
          f"in-document causal pairs of {b * s_len * (s_len + 1) // 2}) "
          f"[{device_line}]")
    bwd_name = _bwd_timings(res, "o", "segments " + shape, q, k, v, do,
                            device_line, doc_pairs, segment_ids=seg)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_seg = ops.flash_attention(*leaves, segment_ids=seg, causal=True)
    o_none = ops.flash_attention(*leaves, causal=True)
    t = [_device_ms(lambda o=o: torch.autograd.grad(o, leaves, do,
                                                   retain_graph=True))
         for o in (o_none, o_seg, o_seg, o_none)]
    res["K2 segments " + shape] = (min(t[1], t[2]), min(t[0], t[3]))
    lib_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*lib_leaves, attn_mask=keep)
    res["library " + bwd_name] = _library(
        "o", "F.scaled_dot_product_attention(attn_mask) backward (autograd)",
        lambda: torch.autograd.grad(o_lib, lib_leaves, do, retain_graph=True),
        device_line)
    print(f"(o) K2 backward {shape}: device time with segment ids "
          f"{t[1]:.4f} / {t[2]:.4f} ms, without {t[0]:.4f} / {t[3]:.4f} ms "
          f"[{device_line}]")
    del q, k, v, do, leaves, o_seg, o_none, lib_leaves, o_lib, keep
    torch.cuda.empty_cache()

    # Whole steps: (h)'s unpacked step, the packed step with K2, with K5.
    unpacked = _entry_step(gpt, corpus)
    opt = train_gpt.recipe(GPT2_STEPS)
    params = dict(gpt.named_parameters())
    box = [opt.init(params)]
    step = training.make_train_step(_packed_loss(gpt), lambda loss, _: loss,
                                    opt)
    batch = next(_packed_batches(packed))
    g = torch.Generator().manual_seed(SEED)

    def packed_step():
        _, box[0], _ = step(params, box[0], batch, None, g)

    def split_step():
        with _schedule(fused_bwd=False):
            packed_step()

    t = [_cuda_ms(f, runs=10, warmup=2)
         for f in (unpacked, packed_step, packed_step, unpacked)]
    ab = _alternate(packed_step, split_step,
                    lambda f: _cuda_ms(f, runs=5, warmup=1))
    res["steps"] = (min(t[0], t[3]), min(t[1], t[2]),
                    statistics.median(ab[1]))
    n_tok = GPT2_B * GPT2_S
    what = (f"(o) GPT-2 small train step (forward, backward, clip, adamw) "
            f"b{GPT2_B} s{GPT2_S} dropout 0.1 bf16")
    print(f"{what}, medians of 10 (order unpacked, packed, packed, "
          f"unpacked): unpacked {t[0]:.3f} / {t[3]:.3f} ms, packed K1+K2 "
          f"{t[1]:.3f} / {t[2]:.3f} ms ({n_tok / res['steps'][1] * 1e3:.0f} "
          f"tokens/s packed) [{device_line}]")
    print(f"{what}, packed, each reading a median of 5: "
          f"{_ab_line(ab, 'K1+K2', 'K1+K5', '.3f')} [{device_line}]")
    return res


def gemma2_config(dtype):
    """google/gemma-2-2b (its config.json, as np_modeling_tpu/utils/
    hf_compat.py's import_gemma2 and llama_config map it): 26 layers, d 2304,
    8 heads over 4 kv heads of 256, a tanh-gelu-gated FFN of 9216, vocab
    256000, RoPE, zero-centred RMSNorm, sandwich norms, the embedding
    scale, a window of 4096 on even layers, caps 50 and 30, scale 256**-0.5."""
    from np_modeling_tpu_torch.models import GPTConfig
    return GPTConfig(vocab_size=256000, d_model=2304, num_layers=26,
                     num_heads=8, num_kv_heads=4, head_dim=256,
                     hidden_units=9216, max_len=8192, positional="rope",
                     rope_base=10000.0, norm="rms", ln_eps=1e-6,
                     rms_offset=True, ffn="geglu", use_bias=False,
                     embed_scale=True, sandwich_norm=True,
                     attention_window=GEMMA_WINDOW, window_pattern=2,
                     attn_logit_softcap=50.0, final_logit_softcap=30.0,
                     query_pre_attn_scalar=256.0, dtype=dtype)


def gemma2_prompts(vocab):
    """{seq: tokens}: 6 prompts of 128..1024 seeded tokens and one of
    GEMMA_LONG, whose local layers' windows cut."""
    rng = np.random.default_rng(SEED + 20)
    lens = [int(n) for n in rng.integers(128, 1025, 6)] + [GEMMA_LONG]
    return {i: rng.integers(0, vocab, n).astype(np.int64)
            for i, n in enumerate(lens)}


def make_gemma_engine(gpt, kv_dtype):
    from np_modeling_tpu_torch.serving import GenerationEngine
    return GenerationEngine(gpt, total_pages=GEMMA_PAGES, page_size=GEMMA_PAGE,
                            max_seqs=GEMMA_SLOTS, kv_dtype=kv_dtype,
                            prefill_chunk_size=GEMMA_CHUNK)


def gemma2_traffic(eng, prompts, steps=GEMMA_DECODE):
    """Every prompt prefilled by one add_requests call, then ``steps`` decode
    steps (step_many), then finish. Returns the streams {seq: tokens}, each
    token's top-2 logit margin {(seq, i): m}, the prefill's last-position
    logits [prompts, vocab] (rows by seq id) and the prefill chunk calls."""
    import torch
    calls = []
    inner = eng._lm_head

    def recording(x):
        lg = inner(x)
        calls.append(lg[:, 0])
        return lg

    eng._lm_head = recording
    try:
        first = eng.add_requests(prompts)
        chunk_calls = len(calls)
        slots = dict(eng._slots)
        rest = eng.step_many(steps) if steps else {sid: [] for sid in first}
    finally:
        eng._lm_head = inner
    sids = sorted(prompts)
    final = [(len(prompts[sid]) - 1) // eng.prefill_chunk_size for sid in sids]
    last = torch.stack([calls[c][row] for row, c in enumerate(final)])
    top = last.topk(2, dim=-1).values
    margins = {(sid, 0): float(top[row, 0] - top[row, 1])
               for row, sid in enumerate(sids)}
    if steps:
        top = torch.stack(calls[chunk_calls:]).topk(2, dim=-1).values.cpu()
        for sid in sids:
            for i in range(steps):
                m = top[i, slots[sid]]
                margins[(sid, i + 1)] = float(m[0] - m[1])
    streams = {sid: [first[sid]] + rest[sid] for sid in sids}
    for sid in sids:
        eng.finish(sid)
    return streams, margins, last, chunk_calls


def _paged_counts():
    from np_modeling_tpu_torch import ops
    return {"paged_attention": ops.paged_attention.launches,
            "paged_attention_window": ops.paged_attention.launches_window,
            "paged_attention_int8": ops.paged_attention.launches_int8,
            "int8_matmul": ops.int8_matmul.launches, **_launch_counts()}


def _zero_paged_counts():
    from np_modeling_tpu_torch import ops
    _zero_launch_counts()
    ops.paged_attention.launches = ops.paged_attention.launches_int8 = 0
    ops.paged_attention.launches_window = ops.int8_matmul.launches = 0
    ops.paged_attention.launches_split = 0


def phase_gemma2():
    """(q) Gemma-2 2B serving at full width and depth, weights from SEED:
    the 7 prompts through one batched chunked prefill, then GEMMA_DECODE
    decode steps, bf16 compute and bf16 pages (the main path). Checks that
    K3 launched once a layer a forward (26), with the window on the 13 local
    layers, and no other kernel; that the bf16 engine's last-position
    logits lie within 1.25 x the plain bf16 engine's distance from the fp32
    engine's, plus GEMMA_BF16_SLACK x max(1, max |fp32 logit|); that fp32
    greedy tokens equal the plain engine's (near-ties printed); that each
    fp32 first token is the argmax of GPT.apply's last logits under
    force_plain(), whose logits the engine's match to 1e-3 x max(1, max
    |logit|). Returns the bf16 GPT, the prompts and the launch counts."""
    import torch
    from np_modeling_tpu_torch.models import GPT
    from np_modeling_tpu_torch.ops import dispatch
    cfg = gemma2_config(torch.bfloat16)
    gpt = GPT(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    prompts = gemma2_prompts(cfg.vocab_size)
    n_params = sum(p.numel() for p in gpt.parameters())
    print(f"(q) Gemma-2 2B: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv heads of "
          f"{cfg.head_dim}, FFN {cfg.hidden_units}, vocab {cfg.vocab_size}, "
          f"{n_params} params (fp32 master weights), bf16 compute, bf16 "
          f"pages; {GEMMA_SLOTS} slots, page {GEMMA_PAGE}, chunk "
          f"{GEMMA_CHUNK}; prompt lengths {[len(p) for p in prompts.values()]}"
          f", then {GEMMA_DECODE} decode steps")

    eng = make_gemma_engine(gpt, torch.bfloat16)
    free0 = eng.free_pages
    _zero_paged_counts()
    t0 = time.perf_counter()
    streams, _, last16, chunk_calls = gemma2_traffic(eng, prompts)
    seconds = time.perf_counter() - t0
    counts = _paged_counts()
    forwards, layers = chunk_calls + GEMMA_DECODE, cfg.num_layers
    want = dict.fromkeys(counts, 0)
    want["paged_attention"] = layers * forwards
    want["paged_attention_window"] = (layers + 1) // 2 * forwards
    toks = np.concatenate([np.asarray(t) for t in streams.values()])
    from np_modeling_tpu_torch import ops
    print(f"(q) bf16 run in {seconds:.1f} s: {len(toks)} tokens, "
          f"{chunk_calls} prefill chunk calls, {GEMMA_DECODE} decode steps; "
          f"launches {counts}, of K3 split across blocks "
          f"{ops.paged_attention.launches_split}; free pages "
          f"{eng.free_pages}/{free0}")
    if counts != want:
        raise AssertionError(f"(q) launches {counts}, expected {want}")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("(q) token out of range")
    if eng.free_pages != free0:
        raise AssertionError("(q) pages not restored after finish")
    del eng
    with dispatch.force_plain():
        _, _, last16p, _ = gemma2_traffic(make_gemma_engine(gpt, torch.bfloat16),
                                          prompts, steps=0)

    gpt32 = GPT(gemma2_config(None), device="cuda")
    gpt32.load_state_dict(gpt.state_dict())
    k_streams, _, last32, _ = gemma2_traffic(
        make_gemma_engine(gpt32, torch.float32), prompts)
    with dispatch.force_plain():
        p_streams, p_margins, _, _ = gemma2_traffic(
            make_gemma_engine(gpt32, torch.float32), prompts)
    _same_greedy("(q) fp32 kernel vs plain engine:", k_streams, p_streams,
                 p_margins)

    scale = max(1.0, last32.abs().max().item())
    err_k = (last16 - last32).abs().max().item()
    err_p = (last16p - last32).abs().max().item()
    bound = 1.25 * err_p + GEMMA_BF16_SLACK * scale
    print(f"(q) bf16 last-position logits vs the fp32 engine's: kernels "
          f"{err_k:.4e}, plain {err_p:.4e} (bound {bound:.4e}: 1.25 x plain + "
          f"{GEMMA_BF16_SLACK} x {scale:.3f})")
    if not err_k <= bound:
        raise AssertionError(f"(q) bf16 logits {err_k} from fp32 > {bound}")
    del last16, last16p
    torch.cuda.empty_cache()

    worst = 0.0
    with dispatch.force_plain(), torch.no_grad():
        for row, sid in enumerate(sorted(prompts)):
            ids = torch.tensor(prompts[sid], device="cuda")[None]
            ref = gpt32.apply(ids)[0, -1]
            top = ref.topk(2).values
            diff = (last32[row] - ref).abs().max().item()
            worst = max(worst, diff / max(1.0, ref.abs().max().item()))
            if int(ref.argmax()) != k_streams[sid][0] and \
                    not float(top[0] - top[1]) < NEAR_TIE:
                raise AssertionError(
                    f"(q) seq {sid}: first token {k_streams[sid][0]} != "
                    f"GPT.apply argmax {int(ref.argmax())}")
            del ref
            torch.cuda.empty_cache()
    print(f"(q) fp32 first tokens equal GPT.apply's last-logit argmax under "
          f"force_plain() for all {len(prompts)} prompts; engine logits vs "
          f"GPT.apply: max abs err {worst:.3e} x max(1, max |logit|) (tol "
          f"1e-3)")
    if not worst <= 1e-3:
        raise AssertionError(f"(q) engine logits {worst} from GPT.apply's")
    del gpt32, last32
    torch.cuda.empty_cache()
    return gpt, prompts, counts


def phase_gemma2_timings(gpt, prompts, device_line):
    """(r) The bf16 Gemma-2 engine's prefill (the 7 prompts from empty) in
    ms and its decode (the 7 sequences, step_many(4)) in tokens/s, each
    side twice, in the order plain, kernel, kernel, plain; the decode
    step_many(4) profiled (``_profile``); K3 at that decode on the engine's
    own pages for a local layer (0, window GEMMA_WINDOW) and a global layer
    (1), device time beside the bound (K/V bytes of the positions a layer
    reads, the local layer's cut to its window), also in the order plain,
    kernel, kernel, plain; and K3's device time on 8 sequences of one
    length, 1024 and 4096, to show what its time follows. A report, not a
    check."""
    import torch
    from np_modeling_tpu_torch import ops
    res = {}
    eng = make_gemma_engine(gpt, torch.bfloat16)
    n_tok = sum(len(p) for p in prompts.values())

    def prefill():
        eng.add_requests(prompts)
        for sid in eng.live:
            eng.finish(sid)

    prefill_name = f"gemma2 engine prefill {len(prompts)} prompts {n_tok} tokens"
    _both(res, "r", prefill_name, prefill, device_line, runs=2, warmup=1)
    eng.add_requests(prompts)
    steps = 4
    decode_name = f"gemma2 engine decode step_many({steps}) {len(prompts)} seqs"
    _both(res, "r", decode_name, lambda: eng.step_many(steps), device_line,
          runs=5, warmup=1)
    ms = res[decode_name]
    res[decode_name + " tokens/s"] = tuple(len(prompts) * steps / t * 1e3
                                           for t in ms)
    print(f"(r) Gemma-2 engine: prefill kernel {res[prefill_name][0]:.2f} ms, "
          f"plain {res[prefill_name][1]:.2f} ms for {n_tok} tokens; decode "
          f"kernel {res[decode_name + ' tokens/s'][0]:.1f} tokens/s, plain "
          f"{res[decode_name + ' tokens/s'][1]:.1f} tokens/s [{device_line}]")
    _profile("r", decode_name, lambda: eng.step_many(steps), device_line,
             warmup=2)

    st = eng._state
    lens = torch.where(st["active"], st["lengths"] + 1, 0).to(torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    hq, d = gpt.config.num_heads, gpt.config.head_dim
    q = torch.randn(GEMMA_SLOTS, hq, d, generator=gen,
                    device="cuda").to(torch.bfloat16)
    keys = {}
    for li, kind, window in ((0, "local", GEMMA_WINDOW), (1, "global", None)):
        kp, vp = st["k_pages"][li], st["v_pages"][li]
        key = (f"paged_attention decode gemma2 {kind} layer b{GEMMA_SLOTS} "
               f"d{d} ctx {lens.tolist()} bf16")

        def fn(kp=kp, vp=vp, window=window):
            return ops.paged_attention(q, kp, vp, lens, st["table"],
                                       scale=GEMMA_SCALE, window=window,
                                       softcap=50.0)

        _both(res, "r", key, fn, device_line)
        _device_both(res, "r", key, fn, device_line)
        res["bound " + key] = _paged_bound(q, kp, lens, st["table"],
                                           window=window)
        print(f"(r) {key}: bound {res['bound ' + key][0]:.5f} ms "
              f"({res['bound ' + key][1]}) [{device_line}]")
        keys[kind] = key
    for sid in eng.live:
        eng.finish(sid)
    del eng
    rng = np.random.default_rng(SEED + 22)
    for ctx, window in ((1024, None), (4096, None), (4096, 1024)):
        q, k, v, lens, table = _pa_inputs(GEMMA_SLOTS, None, hq, 4, d,
                                          GEMMA_PAGE, [ctx] * GEMMA_SLOTS,
                                          torch.bfloat16, rng)
        ms = _device_ms(lambda: ops.paged_attention(
            q, k, v, lens, table, scale=GEMMA_SCALE, window=window,
            softcap=50.0))
        bound = _paged_bound(q, k, lens, table, window=window)[0]
        print(f"(r) K3 decode b{GEMMA_SLOTS} hq{hq}/hkv4 d{d} bf16, every "
              f"sequence {ctx} tokens, window {window}: device {ms:.4f} ms, "
              f"bound {bound:.5f} ms [{device_line}]")
        del q, k, v
    return res, keys


def gemma2_train_config(dtype, layers):
    """gemma2_config with its depth cut to ``layers`` (even: half local)."""
    return dataclasses.replace(gemma2_config(dtype), num_layers=layers)


def _gemma2_gpt(dtype, layers):
    import torch
    from np_modeling_tpu_torch.models import GPT
    return GPT(gemma2_train_config(dtype, layers), device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))


def phase_gemma2_training():
    """(s) Gemma-2 2B training at full width, GEMMA_TRAIN_LAYERS layers,
    weights from SEED, on seeded Zipf rows of GEMMA_TRAIN_S tokens. Step 0
    (forward, backward, clip) through K1 + K2 and through K1 + K5 against
    the plain step: in fp32 at 2 layers (one local, one global) on
    GEMMA_F32_S tokens (loss 1e-5, each gradient 1e-4 relative L2); in bf16
    at GEMMA_BF16_LAYERS layers on GEMMA_TRAIN_S tokens (loss 5e-3, each
    gradient no further from the fp32 plain step's than 1.25 x the plain
    bf16 step's distance, or 2e-2). Then the main path: GEMMA_TRAIN_STEPS
    steps of train_gpt.train (clip + adamw + warmup-cosine, batch 1): the
    loss is finite and lower at the last step than at step 1; each step
    launches K1 and K2 once a layer (half of them with the window) and K12
    and K5 never. Returns the model, the corpus and the launch counts."""
    import torch
    from np_modeling_tpu_torch import train_gpt
    t_phase = time.perf_counter()
    corpus = zipf_corpus(256000, GEMMA_TRAIN_ROWS, GEMMA_TRAIN_S,
                         seed=SEED + 30)
    seed = SEED + 31          # GPT.loss's dropout seed (Gemma-2's rate is 0)

    gpt = _gemma2_gpt(None, 2)
    tokens = torch.tensor(corpus[:1, :GEMMA_F32_S], device="cuda")
    lp, ref = _step0(gpt, tokens, seed, plain=True)
    for fused_bwd, name in ((True, "K1 + K2"), (False, "K1 + K5")):
        with _schedule(fused_bwd=fused_bwd):
            lk, gk = _step0(gpt, tokens, seed, plain=False)
        _hold_fp32(f"(s) 2 layers, 1 x {GEMMA_F32_S} tokens,",
                   f"{name} vs plain", lk, gk, lp, ref)
        del gk
    del gpt, ref
    torch.cuda.empty_cache()

    gpt = _gemma2_gpt(torch.bfloat16, GEMMA_BF16_LAYERS)
    twin = _gemma2_gpt(None, GEMMA_BF16_LAYERS)
    tokens = torch.tensor(corpus[:1], device="cuda")
    _, ref = _step0(twin, tokens, seed, plain=True)
    del twin
    torch.cuda.empty_cache()
    lp, gp = _step0(gpt, tokens, seed, plain=True)
    for fused_bwd, name in ((True, "K1 + K2"), (False, "K1 + K5")):
        with _schedule(fused_bwd=fused_bwd):
            lk, gk = _step0(gpt, tokens, seed, plain=False)
        _hold_bf16(f"(s) {GEMMA_BF16_LAYERS} layers, 1 x {GEMMA_TRAIN_S} "
                   f"tokens, {name}:", lk, lp, gk, gp, ref)
        del gk
    del gpt, ref, gp
    torch.cuda.empty_cache()
    print(f"(s) step-0 comparisons {time.perf_counter() - t_phase:.1f} s")

    cfg = gemma2_train_config(torch.bfloat16, GEMMA_TRAIN_LAYERS)
    gpt = _gemma2_gpt(torch.bfloat16, GEMMA_TRAIN_LAYERS)
    n_params = sum(p.numel() for p in gpt.parameters())
    print(f"(s) Gemma-2 2B at full width, depth cut to {cfg.num_layers} of 26 "
          f"layers: d {cfg.d_model}, {cfg.num_heads} heads / "
          f"{cfg.num_kv_heads} kv heads of {cfg.head_dim}, FFN "
          f"{cfg.hidden_units}, vocab {cfg.vocab_size}, {n_params} params "
          f"(fp32 master weights), bf16 compute; batch 1 x {GEMMA_TRAIN_S} "
          f"seeded Zipf tokens; recipe chain(clip_by_global_norm(1.0), "
          f"adamw(warmup_cosine(3e-4, 10, {GEMMA_TRAIN_STEPS})))")
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    losses, state = train_gpt.train(gpt, corpus, GEMMA_TRAIN_STEPS, 1, "cuda",
                                    log=lambda line: print(f"(s) {line}"))
    losses = losses.tolist()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    layers, steps = cfg.num_layers, GEMMA_TRAIN_STEPS
    want = dict.fromkeys(launches, 0)
    want.update(flash_attention_fwd=layers * steps,
                flash_attention_bwd=layers * steps,
                flash_attention_fwd_window=(layers + 1) // 2 * steps,
                flash_attention_bwd_window=(layers + 1) // 2 * steps)
    print(f"(s) {steps} steps of the recipe in {seconds:.1f} s; losses "
          f"{[round(x, 4) for x in losses]}; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated); kernel "
          f"launches {launches}; phase {time.perf_counter() - t_phase:.1f} s")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(s) loss not finite: {losses}")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"(s) loss at step {steps - 1} ({losses[-1]}) "
                             f"not below step 1's ({losses[1]})")
    if launches != want:
        raise AssertionError(f"(s) kernel launches {launches}, expected {want}")
    return gpt, corpus, launches


def flex_gemma2(window, softcap=GEMMA_CAP, scale=GEMMA_SCALE):
    """``attention(q, k, v)`` through torch's flex_attention, compiled as it
    is used: Gemma-2's logit softcap as a score_mod on the scaled scores
    (none for softcap None) and the causal band ``row - window < col <=
    row`` (causal alone for None) as a block mask, GQA by ``enable_gqa``.
    The library yardstick of K1/K2 with window and softcap, and of K12
    without the softcap; the port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(HERE / "build" / "torchinductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(HERE / "build" / "triton"))
    flex = torch.compile(flex_attention, dynamic=False)

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, q_idx, kv_idx):
        causal = q_idx >= kv_idx
        return causal if window is None else causal & (q_idx - kv_idx < window)

    masks = {}

    def attention(q, k, v):
        sq, skv = q.shape[2], k.shape[2]
        if (sq, skv) not in masks:
            masks[sq, skv] = create_block_mask(mask_mod, None, None, sq, skv,
                                               device=q.device)
        return flex(q, k, v, score_mod=None if softcap is None else score_mod,
                    block_mask=masks[sq, skv], scale=scale, enable_gqa=True)

    return attention


def _flex_library(res, name, bwd_name, q, k, v, do, o_kernel, window,
                  device_line, kernel_fwd, kernel_bwd):
    """compiled flex_attention forward and autograd backward as ``name``'s
    and ``bwd_name``'s library yardsticks, with its compile seconds and its
    output's distance from the kernel's; then its forward and ``kernel_fwd``
    (K1's), and its backward and ``kernel_bwd`` (K2's on the same inputs),
    in turns. Prints the error and leaves the yardstick null if it does not
    run at this shape."""
    import torch
    attention = flex_gemma2(window)
    try:
        t0 = time.perf_counter()
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o_lib = attention(*leaves)
        torch.autograd.grad(o_lib, leaves, do, retain_graph=True)
        err = (o_lib.detach().float() - o_kernel.float()).abs().max()
        print(f"(t) flex_attention {name}: compiled forward and backward in "
              f"{time.perf_counter() - t0:.1f} s; max |flex - K1| "
              f"{err.item():.3e}")
        res["library " + name] = _library(
            "t", f"compiled flex_attention (softcap score_mod, causal"
            f"{'' if window is None else ' window'} block mask, enable_gqa) "
            f"forward, inputs requiring grad (one compiled graph) {name}",
            lambda: attention(*leaves), device_line)
        ab = _alternate(lambda: attention(*leaves), kernel_fwd, _device_ms)
        res["ab " + name] = [statistics.median(x) for x in ab]
        print(f"(t) {name}: device time "
              f"{_ab_line(ab, 'flex forward', 'K1')} [{device_line}]")
        def lib_bwd():
            return torch.autograd.grad(o_lib, leaves, do, retain_graph=True)

        res["library " + bwd_name] = _library(
            "t", f"compiled flex_attention backward (autograd) {bwd_name}",
            lib_bwd, device_line)
        ab = _alternate(lib_bwd, kernel_bwd, _device_ms)
        res["ab " + bwd_name] = [statistics.median(x) for x in ab]
        print(f"(t) {bwd_name}: device time "
              f"{_ab_line(ab, 'flex backward', 'K2')} [{device_line}]")
    except Exception as e:              # a report: the yardstick stays null
        print(f"(t) flex_attention does not run at {name}: "
              f"{type(e).__name__}: {str(e)[:400]}")
    torch.cuda.empty_cache()


def _dual_timings(res, kind, q, k, v, window, device_line):
    """K12 (no softcap: JAX's dual schedule takes none) at Gemma-2's shape
    beside K1 on the same call, device time, order K1, K12, K12, K1, with
    its bound (the in-band pairs' forward work)."""
    import torch
    from np_modeling_tpu_torch import ops
    b, hq, s_len, d = q.shape

    def fwd():
        with torch.no_grad():
            return ops.flash_attention(q, k, v, causal=True, window=window,
                                       scale=GEMMA_SCALE)

    def fwd_dual():
        with _schedule(dual=True):
            return fwd()

    name = (f"flash forward dual gemma2 {kind} b{b} hq{hq} hkv{k.shape[1]} "
            f"s{s_len} d{d} bf16 (no softcap)")
    ab = _alternate(fwd, fwd_dual, _device_ms)
    res[name] = tuple(statistics.median(x) for x in reversed(ab))
    res["bound " + name] = _bound(_nbytes(q, k, v, q),
                                  4 * b * hq * d * _band_pairs(s_len, window))
    print(f"(t) {name}: device time {_ab_line(ab, 'K1', 'K12')}; bound "
          f"{res['bound ' + name][0]:.4f} ms ({res['bound ' + name][1]}) "
          f"[{device_line}]")
    # The library call: compiled flex_attention without a score_mod, the
    # same band as its block mask, GQA.
    attention = flex_gemma2(window, softcap=None)
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            err = (attention(q, k, v).float() - fwd().float()).abs().max()
        print(f"(t) flex_attention {name}: compiled forward in "
              f"{time.perf_counter() - t0:.1f} s; max |flex - K1| "
              f"{err.item():.3e}")

        def lib():
            with torch.no_grad():
                return attention(q, k, v)

        res["library " + name] = _library(
            "t", f"compiled flex_attention (no score_mod, causal"
            f"{'' if window is None else ' window'} block mask, enable_gqa) "
            f"forward {name}", lib, device_line)
        ab = _alternate(lib, fwd_dual, _device_ms)
        res["ab " + name] = [statistics.median(x) for x in ab]
        print(f"(t) {name}: device time "
              f"{_ab_line(ab, 'flex forward', 'K12')} [{device_line}]")
    except Exception as e:              # a report: the yardstick stays null
        print(f"(t) flex_attention does not run at {name}: "
              f"{type(e).__name__}: {str(e)[:400]}")


def phase_gemma2_train_timings(gpt, corpus, device_line):
    """(t) K1, K2 and K5 at Gemma-2's training shape (b1 hq8 hkv4 s8192
    d256 bf16 causal, softcap 50, scale 256 ** -0.5) for a local layer
    (window 4096) and a global one: wall and device time, kernel and plain,
    order plain, kernel, kernel, plain; K5 beside K2; each beside its bound
    (the in-band pairs' work: 4 d operations a pair forward, 10 d
    backward) and beside compiled flex_attention with the same softcap and
    band (the library call); K12 beside K1 without the softcap. SDPA
    without cap or window is printed beside, as another function. Then the
    (s) model's train step, ms and tokens/s, profiled by kind as (p). A
    report, not a check."""
    import torch
    import torch.nn.functional as F
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import dispatch
    res, keys = {}, {}
    rng = np.random.default_rng(SEED + 32)
    q, k, v, do = _flash_inputs(GEMMA_LAYER, torch.bfloat16, rng)
    b, hq, s_len, d = q.shape
    lse = torch.empty((b, hq, s_len), dtype=torch.float32, device="cuda")
    shape = f"b{b} hq{hq} hkv{k.shape[1]} s{s_len} d{d} softcap 50 bf16"
    for kind, window in (("local", GEMMA_WINDOW), ("global", None)):
        kw = dict(causal=True, window=window, softcap=GEMMA_CAP,
                  scale=GEMMA_SCALE)
        pairs = b * hq * d * _band_pairs(s_len, window)

        def fwd(kw=kw):
            with torch.no_grad():
                return ops.flash_attention(q, k, v, **kw)

        name = f"flash forward gemma2 {kind} {shape}"
        _both(res, "t", name, fwd, device_line, runs=10)
        _device_both(res, "t", name, fwd, device_line)
        res["bound " + name] = _bound(_nbytes(q, k, v, q), 4 * pairs)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o_kernel = ops.flash_attention(*leaves, **kw)
        with dispatch.force_plain():
            o_plain = ops.flash_attention(*leaves, **kw)

        def bwd(o):
            return lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)

        bwd_name = f"flash backward gemma2 {kind} {shape}"
        _both(res, "t", bwd_name, bwd(o_kernel), device_line, runs=10,
              plain_fn=bwd(o_plain))
        _device_both(res, "t", bwd_name, bwd(o_kernel), device_line,
                     plain_fn=bwd(o_plain))
        res["bound " + bwd_name] = _bound(_nbytes(q, k, v, q, q, lse, q, k, v),
                                          10 * pairs)
        _flex_library(res, name, bwd_name, q, k, v, do, o_kernel.detach(),
                      window, device_line, fwd, bwd(o_kernel))
        del leaves, o_plain, o_kernel
        split = _bwd_timings(res, "t", f"gemma2 {kind} {shape}", q, k, v, do,
                             device_line, pairs, window=window,
                             softcap=GEMMA_CAP, scale=GEMMA_SCALE)
        for key in (name, bwd_name, split):
            print(f"(t) {key}: bound {res['bound ' + key][0]:.4f} ms "
                  f"({res['bound ' + key][1]}; {pairs // (b * hq * d)} "
                  f"in-band (q, k) pairs a head) [{device_line}]")
        _dual_timings(res, kind, q, k, v, window, device_line)
        keys[kind] = (name, bwd_name)
    kr, vr = (x.repeat_interleave(hq // k.shape[1], dim=1) for x in (k, v))

    def sdpa():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, kr, vr, is_causal=True,
                                                  scale=GEMMA_SCALE)

    _library("t", f"F.scaled_dot_product_attention(is_causal=True) forward "
             f"b{b} h{hq} s{s_len} d{d} bf16, without the softcap or the "
             f"window (another function, not the library yardstick)", sdpa,
             device_line)
    del q, k, v, do, kr, vr
    torch.cuda.empty_cache()

    name = (f"gemma2 train step ({GEMMA_TRAIN_LAYERS} layers; forward, "
            f"backward, clip, adamw) b1 s{GEMMA_TRAIN_S} bf16")
    wall = _profile("t", name, _entry_step(gpt, corpus, 1, GEMMA_TRAIN_STEPS),
                    device_line, warmup=2)
    print(f"(t) {name}: {wall:.3f} ms, {GEMMA_TRAIN_S / wall * 1e3:.0f} "
          f"tokens/s [{device_line}]")
    return res, keys


def main(phases="abcdefghijklmnopqrst"):
    """Runs the phases named in ``phases`` (a, b and c always; ``"abcj"``
    runs the quantized serving path alone, ``"abcqr"`` Gemma-2 serving,
    ``"abcst"`` Gemma-2 training); the JSON summary and the ok line come
    only from a run of every phase a to t."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    _import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    lap = [t_start]

    def since(what):
        """Prints the seconds since the last call (where the run's time goes)."""
        now = time.perf_counter()
        print(f"chip_smoke: {what} {now - lap[0]:.1f} s")
        lap[0] = now

    device_line = phase_device()
    phase_build()
    since("(a), (b)")
    paged_err = phase_paged_vs_plain()
    paged8_err = phase_paged_vs_plain(int8=True)
    paged256_err = phase_paged_options_vs_plain()
    k4_err = phase_int8_matmul_vs_plain()
    k4_err = tuple(map(max, k4_err, phase_int8_schedules_vs_plain()))
    flash_err = phase_flash_vs_plain()
    sched_err = phase_flash_schedules_vs_plain()
    phase_flash_no_key_vs_plain()
    opt_err = phase_flash_options_vs_plain()
    fused_err = phase_fused_vs_plain()
    k11_err = phase_matmul_vs_plain()
    sxe_err = phase_sxe_vs_plain()
    k10_err = phase_quantize_vs_plain()
    since("(c)")
    serving = training_res = entry_res = quant_res = forced_res = None
    packed_res = gemma_res = gemma_train_res = None
    if "d" in phases or "j" in phases:
        gpt = gpt2_small()
        prompts = traffic_prompts(gpt.config.vocab_size)
        if "d" in phases:
            t0 = time.perf_counter()
            paged_launches = phase_engine(gpt, prompts)
            print(f"(d) serving phase {time.perf_counter() - t0:.1f} s")
            if "e" in phases:
                serving = phase_timings(gpt, prompts, device_line)
                since("(d), (e)")
        if "j" in phases:
            t0 = time.perf_counter()
            qgpt, quant_launches = phase_quantized_engine(gpt, prompts)
            print(f"(j) quantized serving phase "
                  f"{time.perf_counter() - t0:.1f} s")
            if "k" in phases and serving is not None:
                quant_res = phase_quant_timings(qgpt, prompts, serving,
                                                device_line)
                since("(j), (k)")
            del qgpt
        del gpt
        torch.cuda.empty_cache()
    if "f" in phases:
        t0 = time.perf_counter()
        gpt, opt, params, state, tokens, flash_launches = phase_training()
        print(f"(f) training phase {time.perf_counter() - t0:.1f} s")
        if "g" in phases:
            training_res = phase_train_timings(gpt, opt, params, state, tokens,
                                               device_line)
            since("(f), (g)")
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
        since("(h), (i), (p)")
        del gpt
        torch.cuda.empty_cache()
    if "l" in phases:
        t0 = time.perf_counter()
        gpt, corpus, forced_launches = phase_forced_training()
        print(f"(l) forced training phase {time.perf_counter() - t0:.1f} s")
        if "m" in phases:
            forced_res = phase_forced_timings(gpt, corpus, device_line)
            since("(l), (m)")
        del gpt
        torch.cuda.empty_cache()
    if "n" in phases:
        t0 = time.perf_counter()
        gpt, packed, packed_launches = phase_packed_training()
        print(f"(n) packed training phase {time.perf_counter() - t0:.1f} s")
        if "o" in phases:
            packed_res = phase_packed_timings(gpt, packed[0], packed,
                                              device_line)
            since("(n), (o)")
        del gpt
        torch.cuda.empty_cache()
    if "q" in phases:
        t0 = time.perf_counter()
        gpt, prompts, gemma_launches = phase_gemma2()
        print(f"(q) Gemma-2 serving phase {time.perf_counter() - t0:.1f} s")
        if "r" in phases:
            gemma_res, gemma_keys = phase_gemma2_timings(gpt, prompts,
                                                         device_line)
            since("(q), (r)")
        del gpt
        torch.cuda.empty_cache()
    if "s" in phases:
        t0 = time.perf_counter()
        gpt, corpus, gemma_train_launches = phase_gemma2_training()
        print(f"(s) Gemma-2 training phase {time.perf_counter() - t0:.1f} s")
        if "t" in phases:
            gemma_train_res, train_keys = phase_gemma2_train_timings(
                gpt, corpus, device_line)
            since("(s), (t)")
        del gpt
        torch.cuda.empty_cache()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s [{device_line}]")
    if None in (serving, training_res, entry_res, quant_res, forced_res,
                packed_res, gemma_res, gemma_train_res):
        return 0
    packed_shape = "b8 h12 s1024 d64 causal bf16"
    shape = "b4 h8 s4096 d128 causal bf16"
    # (j) runs K4's decode shapes on skinny and its prefill shapes on wide.
    k4_at_shape = {
        f"int8_matmul [{m}, {k}] x [{k}, {n}] bf16 bias": quant_launches[
            f"int8_matmul_{'skinny' if m == 8 else 'wide'} {k}x{n}"]
        for m, k, n in K4_SHAPES}
    f32, f16 = torch.float32, torch.bfloat16
    # name, source, replaces, launches, (max err fp32, bf16), results, key
    rows = [
        ("paged_attention", PAGED_SOURCE,
         "np_modeling_tpu/ops/paged_attention.py:221", paged_launches,
         paged_err, serving, "paged_attention decode b8 ctx512-800 bf16"),
        ("paged_attention_int8", PAGED_SOURCE,
         "np_modeling_tpu/ops/paged_attention.py:221",
         quant_launches["paged_attention_int8"], paged8_err, quant_res,
         "paged_attention decode b8 ctx512-800 bf16 q, int8 pages")] + [
        # K4 at each of its four shapes in (k); `launches` is every K4
        # launch of (j), `launches_at_shape` those at the row's (schedule,
        # k, n), both counted by the wrapper.
        (name, INT8_SOURCE, "np_modeling_tpu/ops/quantization.py:242",
         quant_launches["int8_matmul"], k4_err, quant_res,
         f"int8_matmul [{m}, {k}] x [{k}, {n}] bf16 bias")
        for name, (m, k, n) in zip(
            ("int8_matmul", "int8_matmul_decode_k3072",
             "int8_matmul_prefill_k768", "int8_matmul_prefill_k3072"),
            K4_SHAPES)] + [
        ("flash_attention_fwd", FLASH_SOURCE,
         "np_modeling_tpu/ops/attention.py:756", flash_launches[0],
         (flash_err[f32][0], flash_err[f16][0]), training_res,
         f"flash forward {shape}"),
        ("flash_attention_bwd", FLASH_SOURCE,
         "np_modeling_tpu/ops/attention.py:1100", flash_launches[1],
         (flash_err[f32][1], flash_err[f16][1]), training_res,
         f"flash backward {shape}")] + [
        (name, FUSED_SOURCE, where, entry_launches[name], fused_err[name],
         entry_res, key)
        for name, where, key in (
            ("dropout", "np_modeling_tpu/ops/fused.py:310",
             f"dropout [{GPT2_B}, {GPT2_S}, 768] bf16 rate 0.1"),
            ("layer_norm_fwd", "np_modeling_tpu/ops/fused.py:48",
             "layer_norm forward [16384, 1024] bf16"),
            ("layer_norm_bwd", "np_modeling_tpu/ops/fused.py:58",
             "layer_norm backward [16384, 1024] bf16"))] + [
        # GPT-2 small's own LayerNorms (d 768) in (h): every K8 backward
        # launch of the entry point.
        ("layer_norm_bwd_d768", FUSED_SOURCE, "np_modeling_tpu/ops/fused.py:58",
         entry_launches["layer_norm_bwd"], fused_err["layer_norm_bwd"],
         entry_res, f"layer_norm backward [{GPT2_B * GPT2_S}, 768] bf16"),
        ("matmul", MATMUL_SOURCE, "np_modeling_tpu/ops/matmul.py:27",
         forced_launches["matmul"], k11_err, forced_res,
         "matmul [8192, 768] x [768, 3072] trans_a=False trans_b=False bias "
         "bf16"),
        ("softmax_cross_entropy_fwd", FUSED_SOURCE,
         "np_modeling_tpu/ops/fused.py:153",
         forced_launches["softmax_cross_entropy_fwd"], sxe_err, forced_res,
         f"softmax_cross_entropy_fused forward [{GPT2_B * GPT2_S}, 50257] "
         "bf16"),
        ("softmax_cross_entropy_bwd", FUSED_SOURCE,
         "np_modeling_tpu/ops/fused.py:189",
         forced_launches["softmax_cross_entropy_bwd"], sxe_err, forced_res,
         f"softmax_cross_entropy_fused backward [{GPT2_B * GPT2_S}, 50257] "
         "bf16"),
        ("quantize_int8_stochastic", QUANT_SOURCE,
         "np_modeling_tpu/ops/quantization.py:47",
         forced_launches["quantize_int8_stochastic"], k10_err, forced_res,
         f"quantize_int8_stochastic [{GPT2_B * GPT2_S}, 768] fp32"),
        ("flash_attention_bwd_split", FLASH_SOURCE,
         "np_modeling_tpu/ops/attention.py:983", packed_launches["split"],
         sched_err["split"], packed_res, f"flash backward split {shape}"),
        ("flash_attention_fwd_dual", FLASH_SOURCE,
         "np_modeling_tpu/ops/attention.py:693", packed_launches["dual"],
         sched_err["dual"], packed_res, f"flash forward dual {shape}"),
        ("flash_attention_segments", FLASH_SOURCE,
         "np_modeling_tpu/ops/attention.py:756", packed_launches["segments"],
         sched_err["segments"], packed_res,
         f"flash forward segments {packed_shape}"),
        ("paged_attention_d256_local", PAGED_SOURCE,
         "np_modeling_tpu/ops/paged_attention.py:221",
         gemma_launches["paged_attention_window"], paged256_err, gemma_res,
         gemma_keys["local"]),
        ("paged_attention_d256_global", PAGED_SOURCE,
         "np_modeling_tpu/ops/paged_attention.py:221",
         gemma_launches["paged_attention"]
         - gemma_launches["paged_attention_window"], paged256_err, gemma_res,
         gemma_keys["global"])]
    g = gemma_train_launches
    local = {"fwd": g["flash_attention_fwd_window"],
             "bwd": g["flash_attention_bwd_window"]}
    every = {"fwd": g["flash_attention_fwd"], "bwd": g["flash_attention_bwd"]}
    rows += [(f"flash_attention_{way}_d256_{kind}", FLASH_SOURCE,
              f"np_modeling_tpu/ops/attention.py:{line}",
              local[way] if kind == "local" else every[way] - local[way],
              opt_err[way], gemma_train_res, train_keys[kind][i])
             for kind in ("local", "global")
             for i, (way, line) in enumerate((("fwd", 756), ("bwd", 1100)))]
    # "ms": a call's wall time (CUDA events, host included), every entry;
    # "device_ms": calls back to back behind a sleep kernel (device only);
    # "bound_ms": the larger of this call's bytes over 3.35 TB/s and its
    # operations over 989 TFLOP/s; "library_ms" / "library_device_ms": one
    # PyTorch call computing the same function (null where none does; K4's
    # dequantize + torch.mm yardstick, three calls, is printed in (k), and
    # torch.mm on the weight already bf16 stands beside it in turns as
    # "bf16_mm_device_ms_in_turns"; none computes K10's stochastic
    # rounding). K4's rows carry its launches by schedule.
    kernels = []
    for name, source, where, launches, err, res, key in rows:
        ms, (bound_ms, bound_by) = res[key], res["bound " + key]
        lib = res.get("library " + key, (None, None))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": where,
            "launches": launches, "max_abs_err": err[0],
            "max_abs_err_bf16": err[1], "shape": key, "ms": ms[0],
            "plain_ms": ms[1], "device_ms": ms[2], "plain_device_ms": ms[3],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib[0],
            "library_device_ms": lib[1]})
        if "parts " + key in res:  # K5: its dq and dk/dv kernels (profiler)
            parts = res["parts " + key]
            kernels[-1]["dq_device_ms"] = parts["flash_bwd_dq"]
            kernels[-1]["dkdv_device_ms"] = parts["flash_bwd_bf16"]
        if "ab " + key in res:  # device ms in AB rounds with the library call
            kernels[-1]["library_device_ms_in_turns"], \
                kernels[-1]["device_ms_in_turns"] = res["ab " + key]
        if "ab_mm " + key in res:  # K4: in AB rounds with torch.mm, bf16 weight
            kernels[-1]["bf16_mm_device_ms_in_turns"], \
                kernels[-1]["device_ms_in_turns"] = res["ab_mm " + key]
            kernels[-1].update({f"launches_{s}": quant_launches[
                f"int8_matmul_{s}"] for s in ("skinny", "wide", "simple")})
            kernels[-1]["launches_at_shape"] = k4_at_shape[key]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
