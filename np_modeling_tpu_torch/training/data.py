"""Minimal data pipeline: batching and host-to-device prefetch.

Counterpart of np_modeling_tpu/training/data.py. ``batches`` and ``epochs``
are the JAX package's numpy code (the same shuffles, so the same batches).
``prefetch_to_device`` keeps ``size`` batches in flight on ``device``: each
array is copied into pinned host memory and sent with ``non_blocking=True``,
so the copies of queued batches overlap the running step. It takes an
explicit device in place of JAX's sharding.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch


def batches(arrays: Sequence[np.ndarray], batch_size: int, *,
            shuffle: bool = True, seed: int = 0,
            drop_remainder: bool = True) -> Iterator[tuple]:
    """Yield tuples of aligned minibatch slices (one epoch)."""
    n = len(arrays[0])
    if any(len(a) != n for a in arrays):
        raise ValueError("arrays must be aligned on the leading axis")
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for start in range(0, end, batch_size):
        sel = idx[start:start + batch_size]
        yield tuple(a[sel] for a in arrays)


def epochs(arrays: Sequence[np.ndarray], batch_size: int, num_epochs: int,
           *, seed: int = 0, drop_remainder: bool = True) -> Iterator[tuple]:
    for e in range(num_epochs):
        yield from batches(arrays, batch_size, shuffle=True, seed=seed + e,
                           drop_remainder=drop_remainder)


def _put(batch, device):
    """``batch`` with each array sent to ``device``, through dicts (same
    keys), namedtuples (same type), tuples and lists, as
    ``jax.tree_util.tree_map`` maps ``device_put`` over a pytree."""
    if isinstance(batch, dict):
        return type(batch)((k, _put(a, device)) for k, a in batch.items())
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(_put(a, device) for a in batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(_put(a, device) for a in batch)
    host = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device=None) -> Iterator:
    """Yield the iterator's batches (numpy arrays, or dicts, namedtuples,
    tuples and lists of them, nested) as tensors on ``device`` (default:
    the card, ``cuda``, as JAX puts them on its default backend; without a
    card the first batch raises), with ``size`` of them sent ahead."""
    device = torch.device(device if device is not None else "cuda")
    queue = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(size):
            queue.append(_put(next(it), device))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            queue.append(_put(next(it), device))
        except StopIteration:
            pass
        yield out
