"""Checkpoint save and restore for parameter and optimizer-state trees.

Counterpart of np_modeling_tpu/training/checkpoint.py's single-file pair
(``save_checkpoint`` / ``load_checkpoint``, :38-58). A tree is dicts,
tuples, lists and NamedTuples whose leaves are tensors or Python scalars
(``dict(model.named_parameters())``, an optimizer state, or a dict of both).

The file is the port's own format, since the card has neither flax nor
msgpack: ``torch.save`` of ``{"format": FORMAT, "leaves": {path: leaf}}``,
each tensor on the CPU, each path the tree's keys, field names and indices
joined by ``/``. It is read back with ``weights_only=True``. A JAX msgpack
checkpoint and a port checkpoint are not interchangeable;
``utils.params_to_numpy`` / ``params_from_numpy`` are the bridge between
the two packages' parameters.
"""

from __future__ import annotations

import os
import tempfile

import torch

FORMAT = "np_modeling_tpu_torch checkpoint 1"


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree):
    """(key, child) pairs of a tree node; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix="", out=None):
    out = {} if out is None else out
    children = _children(tree)
    if children is None:
        out[prefix] = tree
        return out
    for key, child in children:
        _flatten(child, f"{prefix}/{key}" if prefix else key, out)
    return out


def save_checkpoint(path: str, tree) -> None:
    """Write ``tree`` to ``path`` atomically: into a temporary file in the
    target directory, then ``os.replace``; on failure the temporary is
    removed and ``path`` is left as it was (JAX :38-51)."""
    leaves = {k: (v.detach().cpu() if torch.is_tensor(v) else v)
              for k, v in _flatten(tree).items()}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save({"format": FORMAT, "leaves": leaves}, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _check(wanted, leaves):
    """Raises unless the checkpoint's ``leaves`` are the target's flattened
    ``wanted`` leaves, each of its kind (tensor or scalar) and shape."""
    extra = set(leaves) - set(wanted)
    if extra:
        raise KeyError(f"checkpoint leaves not in the target: "
                       f"{sorted(extra)}")
    for path, target in wanted.items():
        if path not in leaves:
            raise KeyError(f"checkpoint has no leaf {path!r}")
        value = leaves[path]
        if torch.is_tensor(value) != torch.is_tensor(target):
            saved = "a tensor" if torch.is_tensor(value) \
                else type(value).__name__
            held = "a tensor" if torch.is_tensor(target) \
                else type(target).__name__
            raise TypeError(f"{path}: {saved} in the checkpoint, {held} in "
                            f"the target")
        if torch.is_tensor(value) and value.shape != target.shape:
            raise ValueError(f"{path}: shape {tuple(value.shape)} in the "
                             f"checkpoint, {tuple(target.shape)} in the "
                             f"target")


@torch.no_grad()
def _restore(target, prefix, leaves):
    children = _children(target)
    if children is None:
        value = leaves[prefix]
        return target.copy_(value) if torch.is_tensor(target) else value
    rebuilt = [_restore(child, f"{prefix}/{key}" if prefix else key, leaves)
               for key, child in children]
    if isinstance(target, dict):
        return dict(zip(target.keys(), rebuilt))
    if _is_namedtuple(target):
        return type(target)(*rebuilt)
    return type(target)(rebuilt)


def load_checkpoint(path: str, target):
    """Restore ``path`` into ``target``'s structure: each tensor of
    ``target`` is filled in place (its dtype and device kept) and returned
    in that structure, each scalar replaced by the saved one. A leaf the
    checkpoint lacks, a leaf only the checkpoint has, a shape that differs
    or a tensor saved where the target holds a scalar (or the reverse)
    raises before any tensor of ``target`` is written."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(data, dict) or data.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT!r} file (a JAX msgpack "
                         "checkpoint does not load here: convert its "
                         "params with utils.params_from_numpy)")
    leaves = data["leaves"]
    _check(_flatten(target), leaves)
    return _restore(target, "", leaves)
