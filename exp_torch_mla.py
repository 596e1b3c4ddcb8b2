"""MLA's training path on one CUDA card: the flash kernels at head dim 192
and the depth of DeepSeek-V2-Lite that one card trains.

    python3 exp_torch_mla.py [--check] [--timings] [--depths 4,5]
                             [--repeat N] [--recipe LAYERS]

Builds the flash and paged libraries from this checkout and prints ptxas's
registers and spills of the d 192 instantiations. ``--check`` holds the d
192 kernels against their plain version over chip_smoke's MLA_FLASH_CASES
(``phase_mla_flash_vs_plain``); ``--timings`` times them at the slice's
shape beside SDPA (``phase_mla_flash_timings``); ``--depths`` runs two steps
of train_gpt.train on chip_smoke's DeepSeek-V2-Lite training config
(``mla_train_config``: its MoE layers, bf16 compute, remat, the optimizer
state donated, 1 x 4096 seeded Zipf tokens) at each
depth and prints its peak device memory (torch.cuda.max_memory_allocated)
and the second step's time, or that it ran out of memory. ``--repeat N``
runs K2 and K5 N times on one input at the slice's shape (b1 h16 s4096
d192 causal bf16) and prints whether dk and dv (K2, written once an
element) and dq, dk and dv (K5, no atomics) are the same bits on every
run. ``--recipe LAYERS`` runs 8 steps of train_gpt.train at that depth
through the kernels and again from the same weights under force_plain(),
and prints both runs' losses. A report, not a check; it imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import chip_smoke


def depth_probe(layers, device_line):
    """Two recipe steps at ``layers`` layers: (peak GiB, the second step's
    seconds), or None where the card's memory does not hold them."""
    import torch
    from np_modeling_tpu_torch import train_gpt
    corpus = chip_smoke.zipf_corpus(chip_smoke.DSV2_LITE["vocab_size"], 4,
                                    chip_smoke.MLA_S,
                                    seed=chip_smoke.SEED + 101)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    try:
        gpt = chip_smoke._mla_gpt(torch.bfloat16, layers, remat=True)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state = train_gpt.train(gpt, corpus, 1, 1, "cuda", log=None)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del state
    except torch.cuda.OutOfMemoryError as e:
        print(f"depth {layers}: out of memory ({str(e)[:160]}) "
              f"[{device_line}]")
        return None
    finally:
        gpt = None
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"depth {layers}: peak {peak:.2f} GiB, a step (train_gpt.train of "
          f"one step, optimizer state made anew) {times[1]:.3f} s "
          f"[{device_line}]")
    return peak, times[1]


def repeat_check(runs, device_line):
    """K2's dk, dv and K5's dq, dk, dv over ``runs`` runs on one input: how
    many runs differ from the first, bit for bit."""
    import numpy as np
    import torch
    rng = np.random.default_rng(chip_smoke.SEED + 111)
    q, k, v, do = chip_smoke._flash_inputs(chip_smoke.MLA_LAYER,
                                           torch.bfloat16, rng)
    for name, fused, parts in (("K2", True, (2, 3)), ("K5", False, (1, 2, 3))):
        first, differ = None, 0
        for _ in range(runs):
            with chip_smoke._schedule(fused_bwd=fused):
                got = chip_smoke._flash_fwd_bwd(q, k, v, do, True, plain=False)
            got = [got[i] for i in parts]
            if first is None:
                first = got
            else:
                differ += not all(torch.equal(a, b) for a, b in zip(got, first))
        print(f"{name} at {chip_smoke.MLA_LAYER}: {differ} of {runs - 1} runs "
              f"differ from the first in {['o', 'dq', 'dk', 'dv'][parts[0]:]} "
              f"[{device_line}]")


def recipe_vs_plain(layers, device_line):
    """8 recipe steps through the kernels and under force_plain(), from the
    same seeded weights and corpus."""
    import torch
    from np_modeling_tpu_torch import train_gpt
    from np_modeling_tpu_torch.ops import dispatch
    corpus = chip_smoke.zipf_corpus(chip_smoke.DSV2_LITE["vocab_size"],
                                    chip_smoke.MLA_TRAIN_ROWS,
                                    chip_smoke.MLA_S,
                                    seed=chip_smoke.SEED + 101)
    for plain in (False, True):
        gpt = chip_smoke._mla_gpt(torch.bfloat16, layers, remat=True)
        with dispatch.force_plain() if plain else contextlib.nullcontext():
            losses, state = train_gpt.train(gpt, corpus, 8, 1, "cuda",
                                            log=None)
        print(f"{layers} layers, {'plain' if plain else 'kernels'}: losses "
              f"{[round(x, 4) for x in losses.tolist()]} [{device_line}]")
        del gpt, state
        torch.cuda.empty_cache()


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--timings", action="store_true")
    ap.add_argument("--depths", default="")
    ap.add_argument("--repeat", type=int, default=0)
    ap.add_argument("--recipe", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_torch_mla: no CUDA device", file=sys.stderr)
        return 2
    chip_smoke._import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    from np_modeling_tpu_torch.ops import cuda_build
    device_line = chip_smoke.phase_device()
    t0 = time.perf_counter()
    libs = cuda_build.build("flash_attention", "paged_attention")
    print(f"build: {time.perf_counter() - t0:.1f} s")
    log = libs["flash_attention"].log.splitlines()
    for i, line in enumerate(log):
        if "Compiling entry" in line and "ILi192E" in line:
            print("ptxas:", line.strip())
            for nxt in log[i + 1:i + 4]:
                if "registers" in nxt or "spill" in nxt:
                    print("    ", nxt.strip())
    if args.check:
        chip_smoke.phase_mla_flash_vs_plain()
    if args.timings:
        chip_smoke.phase_mla_flash_timings(device_line)
    for layers in (int(x) for x in args.depths.split(",") if x):
        depth_probe(layers, device_line)
    if args.repeat:
        repeat_check(args.repeat, device_line)
    if args.recipe:
        recipe_vs_plain(args.recipe, device_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
