"""Decode speed of the port's serving features on one CUDA card: the engine's
decode greedy and sampled, GPT.generate's beside the engine's, and K1's
mask option at the decode shapes in fp32 and bf16.

    python3 exp_torch_decode.py

GPT-2 small (chip_smoke's config, seeded weights, bf16 compute), 8
prompts of 512 seeded tokens:
- the engine (bf16 pages, 640 pages of 16, 8 slots, chunk 256): after the
  prefill, ``step_many(32)`` greedy, at temperature 0.8 / top-k 50 / top-p
  0.95, and with a SamplingParams carrying penalties; tokens/s, each side
  twice in the order greedy, sampled, sampled, greedy;
- ``GPT.generate`` over the same 8 prompts (fp32 caches, as JAX's: the
  fp32 K1): the decode's tokens/s from the difference of 33 and 1
  generated tokens, beside the engine's greedy decode;
- K1 with a mask at GPT-2's decode (b8 h12 d64 sq1, L 512..1024 by 128)
  and Gemma-2's local decode (b1 8/4 heads of 256, L 4096, softcap 50),
  fp32 and bf16, device ms beside the bound.
Each number is printed with the card's name and power limit. A report,
not a check; it imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent


def main():
    sys.path.insert(0, str(HERE))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.models import GPT
    from np_modeling_tpu_torch.serving import GenerationEngine, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.phase_device()
    gpt = GPT(cs.gpt2_config(torch.bfloat16), device="cuda").init(
        torch.Generator(device="cuda").manual_seed(cs.SEED))
    rng = np.random.default_rng(cs.SEED + 60)
    prompts = {i: rng.integers(0, gpt.config.vocab_size, cs.GEN_PROMPT)
               for i in range(8)}
    steps = 32
    configs = {"greedy": {}, "sampled": cs.SAMPLING,
               "penalties": dict(sampling=SamplingParams(
                   repetition_penalty=1.3, frequency_penalty=0.2))}
    engines = {}
    for name, kw in configs.items():
        eng = GenerationEngine(gpt, total_pages=640, page_size=16,
                               max_seqs=8, kv_dtype=torch.bfloat16, **kw)
        eng.add_requests(prompts)
        engines[name] = eng
    readings = {name: [] for name in configs}
    for name in ("greedy", "sampled", "penalties", "penalties", "sampled",
                 "greedy"):
        ms = cs._cuda_ms(lambda e=engines[name]: e.step_many(steps), runs=3,
                         warmup=1)
        readings[name].append(8 * steps / ms * 1e3)
    for name, tps in readings.items():
        print(f"engine decode {name}: 8 x {cs.GEN_PROMPT} prompts, step_many("
              f"{steps}): {max(tps):.1f} tokens/s (readings "
              f"{', '.join(f'{x:.1f}' for x in tps)}) [{card}]")
    del engines
    torch.cuda.empty_cache()

    batch = torch.tensor(np.stack(list(prompts.values())), device="cuda")
    ms = [cs._cuda_ms(lambda n=n: gpt.generate(batch, n), runs=3, warmup=1)
          for n in (1, steps + 1)]
    tps = 8 * steps / (ms[1] - ms[0]) * 1e3
    print(f"generate (fp32 caches): 8 x {cs.GEN_PROMPT} prompts, {steps + 1} "
          f"tokens {ms[1]:.2f} ms, 1 token {ms[0]:.2f} ms: decode "
          f"{tps:.1f} tokens/s against the engine's greedy "
          f"{max(readings['greedy']):.1f} [{card}]")

    for dtype in (torch.float32, torch.bfloat16):
        for name, b, hq, hkv, d, lens, cap in (
                [("gpt2 decode", 8, 12, 12, 64, L, None)
                 for L in range(512, 1025, 128)]
                + [("gemma2 local decode", 1, 8, 4, 256, 4096, 50.0)]):
            q, k, v, _ = cs._flash_inputs((b, hq, hkv, 1, lens, d), dtype,
                                          rng)
            col = torch.arange(lens, device="cuda")
            mask = (col > lens - 1 - cs.GEMMA_WINDOW)[None, None, None, :]
            with torch.no_grad():
                def fn():
                    return ops.flash_attention(
                        q, k, v, mask=mask, softcap=cap,
                        scale=cs.GEMMA_SCALE if cap else None)
                o = fn()
                t = cs._device_ms(fn)
            bound = cs._mask_bound(q, k, v, mask, o)
            print(f"K1 mask {name} b{b} h{hq}/{hkv} d{d} L{lens} "
                  f"{str(dtype)[6:]}: device {t:.4f} ms, bound "
                  f"{bound[0]:.5f} ms ({bound[1]}) [{card}]")


if __name__ == "__main__":
    main()
