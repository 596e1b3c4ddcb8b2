"""Train a GPT-style causal LM on a seeded random corpus: the training entry
point of the JAX package (examples/train_gpt.py) in the PyTorch port.

    python -m np_modeling_tpu_torch.train_gpt --bf16

It runs on the card; ``--device cpu`` asks for the CPU (the plain
versions of the kernels).

The recipe is the example's: dropout 0.1, ``GPT.loss(training=True)``,
``chain(clip_by_global_norm(1.0), adamw(warmup_cosine(3e-4, 10, steps)))``
with adamw's defaults, driven by ``training.make_train_step`` over batches
from ``data.epochs`` through ``data.prefetch_to_device``. The dropout rng is
a CPU generator seeded 1 that the model draws one seed from a step, as the
example splits its key a step. The example's ``--moe``, ``--shard``,
``--remat`` and ``--ckpt`` options and its closing ``generate`` sample are
not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from np_modeling_tpu_torch import models, training
from np_modeling_tpu_torch.training import data, schedules


def recipe(steps: int) -> training.Optimizer:
    """The example's optimizer for a run of ``steps`` steps."""
    sched = schedules.warmup_cosine(3e-4, warmup_steps=10, total_steps=steps)
    return training.chain(training.clip_by_global_norm(1.0),
                          training.adamw(sched))


def _objective(loss, targets):
    del targets          # GPT.loss is the objective already
    return loss


def train(gpt: models.GPT, corpus: np.ndarray, steps: int, batch: int,
          device, log=print):
    """``steps`` steps of the recipe on ``corpus`` [n, seq] (int tokens).
    Returns the per-step losses (a device tensor) and the optimizer state.
    ``log`` (None for quiet) gets a line every 10 steps and at the last."""
    opt = recipe(steps)
    params = dict(gpt.named_parameters())
    state = opt.init(params)
    step = training.make_train_step(gpt.loss, _objective, opt)
    rng = torch.Generator().manual_seed(1)
    it = data.prefetch_to_device(data.epochs([corpus], batch, num_epochs=100),
                                 device=device)
    losses = []
    t0 = time.time()
    for i in range(steps):
        (tokens,) = next(it)
        params, state, loss = step(params, state, tokens, None, rng)
        losses.append(loss)
        if log and (i % 10 == 0 or i == steps - 1):
            log(f"step {i:4d}  loss {float(loss):.4f}  "
                f"({(time.time() - t0) / (i + 1) * 1e3:.1f} ms/step avg)")
    return torch.stack(losses), state


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = models.GPTConfig(
        vocab_size=args.vocab, d_model=args.d_model, num_heads=args.heads,
        num_layers=args.layers, hidden_units=4 * args.d_model,
        max_len=args.seq, drop_rate=0.1,
        dtype=torch.bfloat16 if args.bf16 else None)
    gpt = models.GPT(cfg, device=args.device).init(
        torch.Generator(device=args.device).manual_seed(0))
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, args.vocab, (64 * args.batch, args.seq))
    losses, _ = train(gpt, corpus, args.steps, args.batch, args.device)
    return losses


if __name__ == "__main__":
    main()
