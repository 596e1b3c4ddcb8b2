"""Train a GPT-style causal LM on a seeded random corpus: the training entry
point of the JAX package (examples/train_gpt.py) in the PyTorch port.

    python -m np_modeling_tpu_torch.train_gpt --bf16
    python -m np_modeling_tpu_torch.train_gpt --bf16 --moe 8
    python -m np_modeling_tpu_torch.train_gpt --bf16 --remat --ckpt gpt.pt

It runs on the card; ``--device cpu`` asks for the CPU (the plain
versions of the kernels). ``--moe N`` makes every FFN a mixture of N
experts with JAX's other defaults (top 2, capacity factor 1.25, relu
experts of 4 x d, aux weight 0.01); the aux joins the loss. ``--remat``
recomputes each block's activations in the backward (``GPTConfig.remat``);
``--ckpt PATH`` saves the final parameters there
(``training.save_checkpoint``, the port's own file format).

The recipe is the example's: dropout 0.1, ``GPT.loss(training=True)``,
``chain(clip_by_global_norm(1.0), adamw(warmup_cosine(3e-4, 10, steps)))``
with adamw's defaults, driven by ``training.make_train_step`` (the
optimizer state donated: updated in place) over batches from
``data.epochs`` through ``data.prefetch_to_device``. The dropout rng is a
CPU generator seeded 1 that the model draws one seed from a step, as the
example splits its key a step. It closes, as the example does, with a
greedy ``GPT.generate`` sample of 16 tokens after the first row's first 8.
The example's ``--shard`` option is not ported yet.
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
    ap.add_argument("--moe", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt", type=str, default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    return ap.parse_args(argv)


def config(args: argparse.Namespace) -> models.GPTConfig:
    """The example's model for the parsed ``args``."""
    return models.GPTConfig(
        vocab_size=args.vocab, d_model=args.d_model, num_heads=args.heads,
        num_layers=args.layers, hidden_units=4 * args.d_model,
        max_len=args.seq, drop_rate=0.1, remat=args.remat,
        moe_experts=args.moe,
        dtype=torch.bfloat16 if args.bf16 else None)


def corpus_of(args: argparse.Namespace) -> np.ndarray:
    """The example's seeded random corpus, 64 batches of ``args.seq``."""
    rng = np.random.default_rng(0)
    return rng.integers(0, args.vocab, (64 * args.batch, args.seq))


def main(argv=None):
    args = parse_args(argv)
    gpt = models.GPT(config(args), device=args.device).init(
        torch.Generator(device=args.device).manual_seed(0))
    corpus = corpus_of(args)
    losses, _ = train(gpt, corpus, args.steps, args.batch, args.device)
    if args.ckpt:
        training.save_checkpoint(args.ckpt, dict(gpt.named_parameters()))
        print("saved", args.ckpt)
    sample = gpt.generate(torch.as_tensor(corpus[:1, :8], device=args.device),
                          steps=16)
    print("sample continuation:", sample.cpu().numpy()[0])
    return losses


if __name__ == "__main__":
    main()
