"""K3 (the paged-attention kernel) on one CUDA card: its device time under
split plans of other sizes, and at the prefill chunk shapes beside an older
tree's kernel.

    python3 exp_torch_k3_splits.py
    python3 exp_torch_k3_splits.py --chunk-ab DIR

The first form times decode shapes with the wrapper's split ranges held to
at least 64, 128, 256 (the default) and 512 keys, beside each shape's bound
(chip_smoke's _paged_bound). Shapes: Gemma-2 decode (8 sequences, hq 8 / hkv
4, d 256, bf16 pages of 16; the engine's lengths from chip_smoke's (r) and a
table of 512 pages, with the local layer's window of 4096 and without), 8
sequences of 1024 and of 4096 tokens (chip_smoke's (r) sweep), and GPT-2
decode (8 sequences of 512..800 tokens, 12 heads of 64, a table of 64
pages).

The second form times K3 at the prefill chunk shapes (chip_smoke's (e)
GPT-2 chunk, 7 x 256 rows at d 64; Gemma-2 chunks of 256 rows at d 256 with
the softcap, 7 sequences and the long prompt's one, local and global) in
four processes, the tree in DIR (an unpacked older checkout, whose package
has the same ``ops.paged_attention``), this tree, this tree, DIR, each on
the same seeded inputs, and prints each side's device ms and their ratio.
``--chunk [--package DIR]`` is one such process.

A report, not a check; it imports nothing of JAX.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys

import numpy as np

import chip_smoke

MIN_KEYS = (64, 128, 256, 512)
GEMMA_LENGTHS = [1085, 536, 519, 698, 1087, 394, 4757, 0]


def main():
    import torch
    if not torch.cuda.is_available():
        print("exp_torch_k3_splits: no CUDA device", file=sys.stderr)
        return 2
    from np_modeling_tpu_torch import ops
    pa = importlib.import_module("np_modeling_tpu_torch.ops.paged_attention")
    card = _card()
    rng = np.random.default_rng(chip_smoke.SEED)
    cases = []
    for lengths, window, pps in ((GEMMA_LENGTHS, 4096, 512),
                                 (GEMMA_LENGTHS, None, 512),
                                 ([1024] * 8, None, 64), ([4096] * 8, None, 256)):
        q, k, v, lens, table = chip_smoke._pa_inputs(
            8, None, 8, 4, 256, 16, [max(n, 1) for n in lengths],
            torch.bfloat16, rng, extra_pages=pps * 8)
        table = torch.cat([table, table[:, :1].expand(8, pps - table.shape[1])],
                          dim=1).contiguous()
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        cases.append((f"gemma2 d256 ctx {lengths} window {window}", q, k, v,
                      lens, table, dict(scale=chip_smoke.GEMMA_SCALE,
                                        window=window, softcap=50.0)))
    lengths = rng.integers(512, 801, 8).tolist()
    q, k, v, lens, table = chip_smoke._pa_inputs(8, None, 12, 12, 64, 16,
                                                 lengths, torch.bfloat16, rng,
                                                 extra_pages=64 * 8)
    table = torch.cat([table, table[:, :1].expand(8, 64 - table.shape[1])],
                      dim=1).contiguous()
    cases.append((f"gpt2 d64 ctx {lengths}", q, k, v, lens, table, {}))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    default = pa.MIN_SPLIT_KEYS
    for name, q, k, v, lens, table, kw in cases:
        bound = chip_smoke._paged_bound(q, k, lens, table,
                                        window=kw.get("window"))[0]
        line = []
        for keys in MIN_KEYS:
            pa.MIN_SPLIT_KEYS = keys
            rows = q.shape[1] // k.shape[0]
            splits, per = pa.split_plan(q.shape[0], k.shape[0], rows,
                                        q.shape[-1], table.shape[1], 16, sms)
            ms = chip_smoke._device_ms(
                lambda: ops.paged_attention(q, k, v, lens, table, **kw))
            line.append(f"min {keys}: {splits} x {per} keys {ms:.4f} ms "
                        f"({ms / bound:.2f}x)")
        pa.MIN_SPLIT_KEYS = default
        print(f"K3 {name}: bound {bound:.5f} ms; " + "; ".join(line)
              + f" [{card}]")
    return 0


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def chunk(package=None):
    """Device ms of K3 at the prefill chunk shapes, one JSON line; the
    package from ``package`` (a tree's root) where given."""
    if package is not None:
        sys.path.insert(0, package)
    import torch
    if not torch.cuda.is_available():
        print("exp_torch_k3_splits: no CUDA device", file=sys.stderr)
        return 2
    from np_modeling_tpu_torch import ops
    rng = np.random.default_rng(chip_smoke.SEED + 7)
    res = {"package": ops.__file__}
    cases = [("gpt2 chunk b7 sq256 d64", 7, 12, 12, 64,
              [256 * (1 + i % 3) for i in range(7)], None, {})]
    for b, lengths in ((7, [256, 512, 768, 1024, 256, 512, 4352]),
                       (1, [4608])):
        for window in (chip_smoke.GEMMA_WINDOW, None):
            cases.append((f"gemma2 chunk b{b} sq256 d256 window {window}", b,
                          8, 4, 256, lengths, 512,
                          dict(scale=chip_smoke.GEMMA_SCALE, window=window,
                               softcap=50.0)))
    for name, b, hq, hkv, d, lengths, pps, kw in cases:
        q, k, v, lens, table = chip_smoke._pa_inputs(
            b, 256, hq, hkv, d, 16, lengths, torch.bfloat16, rng,
            extra_pages=(pps or 0) * b + 2)
        if pps is not None:
            table = torch.cat([table, table[:, :1].expand(
                b, pps - table.shape[1])], dim=1).contiguous()
        res[name] = [chip_smoke._device_ms(
            lambda: ops.paged_attention(q, k, v, lens, table, **kw))
            for _ in range(3)]
    print(json.dumps(res))
    return 0


def chunk_ab(parent):
    """``chunk`` in four processes: ``parent``, this tree, this tree,
    ``parent``; prints each shape's medians and this tree over ``parent``."""
    runs = []
    for package in (parent, None, None, parent):
        cmd = [sys.executable, __file__, "--chunk"]
        cmd += [] if package is None else ["--package", package]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{cmd} failed:\n{out.stderr}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    card = _card()
    for name in runs[0]:
        if name == "package":
            continue
        old = sorted(runs[0][name] + runs[3][name])
        new = sorted(runs[1][name] + runs[2][name])
        mid = len(old) // 2
        print(f"K3 {name}: {parent} {' '.join(f'{t:.4f}' for t in old)} ms; "
              f"this tree {' '.join(f'{t:.4f}' for t in new)} ms; medians "
              f"{old[mid]:.4f} / {new[mid]:.4f}, this tree "
              f"{new[mid] / old[mid]:.3f}x (order old, new, new, old) "
              f"[{card}]")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--chunk-ab"]:
        sys.exit(chunk_ab(args[1]))
    if args[:1] == ["--chunk"]:
        sys.exit(chunk(args[2] if args[1:2] == ["--package"] else None))
    sys.exit(main())
