"""K3's latent option (MLA, head dim 576, one page array as k and v) on one
CUDA card: its device time under split plans of other sizes.

    python3 exp_torch_k3_latent.py

Times the latent option at chip_smoke (B)'s shapes with the wrapper's
latent split ranges held to at least 32, 64, 128 (the default) and 256
keys, beside each shape's bound (chip_smoke's _latent_bound) and the
splits the plan gave: the engine's decode (8 sequences of 16 heads, the
context lengths of (B)'s traffic, a table of 2048 positions) with fp32,
bf16 and int8 pages and fp32 / bf16 q as the engine pairs them, 8 x 2048
tokens, and one prefill chunk (8 x 256 tokens at (B)'s prompt lengths,
bf16). A report, not a check; it imports nothing of JAX.
"""

from __future__ import annotations

import importlib
import subprocess
import sys

import chip_smoke

MIN_KEYS = (32, 64, 128, 256)
DECODE_LENGTHS = [1076, 276, 322, 1007, 665, 457, 670, 580]


def main():
    import torch
    if not torch.cuda.is_available():
        print("exp_torch_k3_latent: no CUDA device", file=sys.stderr)
        return 2
    from np_modeling_tpu_torch import ops
    pa = importlib.import_module("np_modeling_tpu_torch.ops.paged_attention")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cases = []
    for label, sq, lengths, pages in (
            ("decode", None, DECODE_LENGTHS, "float32"),
            ("decode", None, DECODE_LENGTHS, "bfloat16"),
            ("decode", None, DECODE_LENGTHS, "int8 bf16 q"),
            ("decode 8 x 2048", None, [2048] * 8, "bfloat16"),
            ("chunk", 256, [1000, 256, 256, 931, 589, 381, 594, 504],
             "bfloat16")):
        q, rows, lens, table, kw, _ = chip_smoke.paged_latent_case(
            8, sq, 16, lengths, pages, chip_smoke.SEED + 7)
        cases.append((f"{label} {pages} pages lengths {lengths}", q, rows,
                      lens, table, kw))
    default = pa.LATENT_MIN_SPLIT_KEYS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, q, rows, lens, table, kw in cases:
        peak = (chip_smoke.PEAK_F32_S if q.dtype == torch.float32
                else chip_smoke.PEAK_BF16_S)
        bound = chip_smoke._latent_bound(q, rows, lens, table,
                                         tuple(kw.values())[:1], peak=peak)
        line = []
        for keys in MIN_KEYS:
            pa.LATENT_MIN_SPLIT_KEYS = keys
            rows_a_head = (q.shape[1] if q.dim() == 4 else 1) * q.shape[-2]
            splits, _ = pa.split_plan(8, 1, rows_a_head, 576, table.shape[1],
                                      16, sms)

            def fn():
                return ops.paged_attention(q, rows, rows, lens, table,
                                           scale=192 ** -0.5, **kw)

            ms = chip_smoke._device_ms(fn)
            line.append(f"{keys}: {ms:.4f} ms ({splits} splits)")
        pa.LATENT_MIN_SPLIT_KEYS = default
        print(f"K3 latent {name}: " + ", ".join(line) + f"; bound "
              f"{bound[0]:.5f} ms ({bound[1]}) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
