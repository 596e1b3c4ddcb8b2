"""Losses with hand-written backwards (training path).

Counterpart of np_modeling_tpu/ops/losses.py:

- ``mse``, ``cross_entropy_probs`` and ``softmax_cross_entropy`` (JAX
  :27-100): the losses the ``Trainer`` resolves by name, each with JAX's
  backward (``cross_entropy_probs`` keeps the reference framework's
  ``-t / p`` gradient and its unnormalised sum).
- ``softmax_cross_entropy_with_integer_labels`` (JAX :102-160): per-example
  CE from logits, one-hot free; statistics fp32. Labels outside [0, vocab)
  give ce = lse and no correct-class gradient term.
- ``fused_lm_head_loss`` (JAX :183-336): mean CE of ``softmax(x @ head)``
  computed ``chunk`` positions at a time, so the [N, vocab] logits never
  exist at once. The backward recomputes each chunk's softmax and
  accumulates dx and an fp32 dtable. The chunk products run in x's dtype
  with fp32 accumulation; in JAX they are plain products outside any Pallas
  kernel, so here they are library matrix products.
"""

from __future__ import annotations

import math

import torch

from np_modeling_tpu_torch.ops import fused
from np_modeling_tpu_torch.ops.matmul import mm


class _Mse(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, targets):
        ctx.save_for_backward(y, targets)
        return (y - targets).square().sum() / y.numel()

    @staticmethod
    def backward(ctx, g):
        y, targets = ctx.saved_tensors
        d = (2.0 / y.numel()) * (y - targets) * g
        return d, -d


def mse(y: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``sum((y - t)^2) / y.size``."""
    return _Mse.apply(y, targets)


class _CrossEntropyProbs(torch.autograd.Function):

    @staticmethod
    def forward(ctx, probs, targets):
        ctx.save_for_backward(probs, targets)
        return -(targets * torch.log(probs)).sum()

    @staticmethod
    def backward(ctx, g):
        probs, targets = ctx.saved_tensors
        return -targets / probs * g, -torch.log(probs) * g


def cross_entropy_probs(probs: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """``-sum(t * log(p))`` on probabilities (an unnormalised sum)."""
    return _CrossEntropyProbs.apply(probs, targets)


class _SoftmaxCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels):
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m)
        sum_e = e.sum(dim=-1, keepdim=True)
        log_z = torch.log(sum_e) + m
        ctx.save_for_backward(e / sum_e, labels, logits)
        return log_z.squeeze(-1) - (labels * logits).sum(dim=-1)

    @staticmethod
    def backward(ctx, g):
        probs, labels, logits = ctx.saved_tensors
        g = g[..., None]
        return (probs - labels) * g, -logits * g


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-example CE from logits and label distributions: ``logsumexp -
    sum(labels * logits)``, shape ``logits.shape[:-1]``; the backward is
    ``softmax(logits) - labels``."""
    return _SoftmaxCrossEntropy.apply(logits, labels)


class _SxeIntegerLabels(torch.autograd.Function):
    """The plain math of K9's plain version (``ops.fused``), which is the
    same function; JAX runs this op outside any kernel."""

    @staticmethod
    def forward(ctx, logits, labels):
        l2, lab = fused.sxe_rows(logits, labels)
        ce, lse = fused.sxe_fwd_plain(l2, lab)
        ctx.save_for_backward(l2, lab, lse)
        ctx.shape = logits.shape
        return ce.reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        l2, lab, lse = ctx.saved_tensors
        dl = fused.sxe_bwd_plain(l2, lab, lse, g.reshape(-1))
        return dl.reshape(ctx.shape), None


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor,
                                              labels: torch.Tensor):
    """fp32 per-example CE, shape ``logits.shape[:-1]``."""
    return _SxeIntegerLabels.apply(logits, labels)


def _chunks(n, chunk):
    return [(i, min(i + chunk, n)) for i in range(0, n, chunk)]


class _FusedLMHeadLoss(torch.autograd.Function):
    """x [N, d], table [vocab, d], labels [N], valid [N] fp32 weights."""

    @staticmethod
    def forward(ctx, x, table, labels, valid, chunk):
        tb = table.to(x.dtype)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for a, b in _chunks(x.shape[0], chunk):
            logits = mm(x[a:b], tb.t(), torch.float32)      # [chunk, vocab]
            lse = torch.logsumexp(logits, dim=-1)
            correct = logits.gather(1, labels[a:b, None])[:, 0]
            loss_sum = loss_sum + (valid[a:b] * (lse - correct)).sum()
        denom = valid.sum().clamp(min=1.0)
        ctx.save_for_backward(x, table, labels, valid, denom)
        ctx.chunk = chunk
        return loss_sum / denom

    @staticmethod
    def backward(ctx, dy):
        x, table, labels, valid, denom = ctx.saved_tensors
        tb = table.to(x.dtype)
        scale = dy / denom
        dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        dtable = torch.zeros(table.shape, dtype=torch.float32,
                             device=x.device)                 # fp32 accumulator
        for a, b in _chunks(x.shape[0], ctx.chunk):
            logits = mm(x[a:b], tb.t(), torch.float32)
            dlogits = torch.softmax(logits, dim=-1)
            rows = torch.arange(b - a, device=x.device)
            dlogits[rows, labels[a:b]] -= 1.0                  # p - onehot
            dlc = (dlogits * (valid[a:b] * scale)[:, None]).to(x.dtype)
            dx[a:b] = mm(dlc, tb, torch.float32)
            dtable += mm(dlc.t(), x[a:b], torch.float32)
        return dx.to(x.dtype), dtable.to(table.dtype), None, None, None


def fused_lm_head_loss(x: torch.Tensor, table: torch.Tensor,
                       labels: torch.Tensor, *, chunk: int | None = None,
                       valid=None, table_layout: str = "vd",
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE of ``softmax(x @ head)`` against integer labels.

    ``x`` [..., d] final hidden states; ``table`` the LM head, a tied
    embedding table [vocab, d] (``table_layout="vd"``) or an untied head
    weight [d, vocab] (``"dv"``); ``labels`` [...] int in [0, vocab);
    ``valid`` optional [...] 0/1 weights, the mean is over valid positions;
    ``bias`` [vocab], untied heads only. ``chunk`` defaults to 512 (the JAX
    package's measured choice).
    """
    if table_layout not in ("vd", "dv"):
        raise ValueError(f"table_layout {table_layout!r}: want 'vd' or 'dv'")
    d = x.shape[-1]
    n = math.prod(x.shape[:-1])
    chunk = 512 if chunk is None else chunk
    xf = x.reshape(n, d)
    lf = labels.reshape(n).long()
    vf = (torch.ones(n, dtype=torch.float32, device=x.device) if valid is None
          else valid.reshape(n).float())
    if bias is not None:
        # Absorb the bias as one more input column: logits = [x, 1] @ [head; b].
        # The concatenations sit outside the Function, so autograd splits
        # the head's gradient back into (dhead, dbias).
        if table_layout != "dv":
            raise ValueError("bias implies an untied [d, vocab] head")
        xf = torch.cat([xf, torch.ones((n, 1), dtype=xf.dtype,
                                       device=xf.device)], dim=1)
        table = torch.cat([table, bias[None, :].to(table.dtype)], dim=0)
    if table_layout == "dv":
        table = table.t()
    return _FusedLMHeadLoss.apply(xf, table, lf, vf, chunk)
