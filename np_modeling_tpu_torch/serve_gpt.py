"""Serve a GPT model with continuous batching over a paged KV cache: the
serving example of the JAX package (examples/serve_gpt.py) in the PyTorch
port.

    python -m np_modeling_tpu_torch.serve_gpt [--quantize-kv]

It runs on the card; ``--device cpu`` asks for the CPU (the plain versions
of the kernels). Requests join and leave mid-stream (continuous batching),
one prompt is forked into three greedy continuations that share its pages,
and a draft model proposes for three speculative rounds. The model is the
example's (d 128, 8 q heads of 16 over 2 kv heads, 4 layers, vocab 512;
its pages are stored 64 wide, the paged kernel's narrowest head dim), the
draft d 32 with 2 heads of 16 and one layer.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from np_modeling_tpu_torch import models, serving


def main(argv=None, log=print):
    """Runs the example; returns {"outputs", "forked", "free_pages",
    "speculative"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--quantize-kv", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = models.GPTConfig(vocab_size=512, d_model=128, num_heads=8,
                           num_kv_heads=2, num_layers=4, hidden_units=512,
                           max_len=256)
    gpt = models.GPT(cfg, device=args.device).init(
        torch.Generator(device=args.device).manual_seed(0))

    engine = serving.GenerationEngine(gpt, total_pages=256, page_size=16,
                                      max_seqs=8,
                                      quantize_kv=args.quantize_kv)
    rng = np.random.default_rng(0)
    outputs = {}

    def step4():
        for _ in range(4):
            for sid, tok in engine.step().items():
                outputs[sid].append(tok)

    # Request A arrives.
    outputs[0] = [engine.add_request(0, rng.integers(0, 512, 12))]
    step4()
    # Request B joins mid-stream (continuous batching).
    outputs[1] = [engine.add_request(1, rng.integers(0, 512, 20))]
    step4()
    # A completes; its pages are reclaimed while B continues.
    engine.finish(0)
    step4()
    engine.finish(1)

    for sid, toks in outputs.items():
        log(f"request {sid}: generated {toks}")
    free = engine.free_pages
    log(f"free pages after completion: {free}")

    # ---- fork (prefix caching): N continuations of one prompt ----------
    prompt = rng.integers(0, 512, 40)
    first = engine.add_request(2, prompt)      # one prefill
    engine.fork(2, 3)                          # one page a fork
    engine.fork(2, 4)
    forked = {sid: [first] for sid in (2, 3, 4)}
    for sid, toks in engine.step_many(6).items():
        forked[sid].extend(toks)
    log("forked continuations (greedy twins): "
        f"{ {sid: t[:4] for sid, t in forked.items()} }")
    for sid in (2, 3, 4):
        engine.finish(sid)

    # ---- speculative decoding with a draft model ------------------------
    dcfg = models.GPTConfig(vocab_size=512, d_model=32, num_heads=2,
                            num_layers=1, hidden_units=128, max_len=256)
    draft = models.GPT(dcfg, device=args.device).init(
        torch.Generator(device=args.device).manual_seed(1))
    spec = serving.GenerationEngine(gpt, total_pages=256, page_size=16,
                                    max_seqs=8, draft_gpt=draft)
    spec.add_request(0, prompt)
    toks = spec.step_speculative_many(rounds=3, gamma=4)[0]
    log(f"speculative decode: {len(toks)} tokens in 3 rounds (train the "
        "draft on the target's outputs to raise acceptance)")
    return {"outputs": outputs, "forked": forked, "free_pages": free,
            "speculative": toks}


if __name__ == "__main__":
    main()
