"""JAX parameter pytree <-> the port's modules.

``load_params(module, tree)`` copies a JAX parameter tree, nested dicts of
arrays (numpy, or anything ``np.asarray`` reads), into any port module whose
parameter names are the tree's paths with ``.`` for ``/``; a missing, extra
or mis-shaped leaf raises. ``params_from_numpy`` does so for the JAX GPT's
tree (``layer_{i}/self_attention/wq``, ``layer_{i}/dense1/linear/w``,
``embedding/table``, ...) and returns a port ``GPT`` holding those weights.
``params_to_numpy`` and ``tree_to_numpy`` are the way back: the port's
parameters, or any ``{name: tensor}`` dict such as their gradients, as the
JAX-shaped nested dict of fp32 numpy arrays, for a leaf-by-leaf comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from np_modeling_tpu_torch.models.transformer_lm import GPT, GPTConfig


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


@torch.no_grad()
def load_params(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    leaves = _flatten(tree)
    params = dict(module.named_parameters())
    if set(leaves) != set(params):
        raise KeyError(
            f"parameter trees differ: only in JAX {sorted(set(leaves) - set(params))},"
            f" only in the port {sorted(set(params) - set(leaves))}")
    for name, p in params.items():
        arr = np.asarray(leaves[name], dtype=np.float32)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape}, port shape "
                             f"{tuple(p.shape)}")
        p.copy_(torch.tensor(arr))
    return module


def params_from_numpy(tree: dict, config: GPTConfig, device=None) -> GPT:
    return load_params(GPT(config, device=device), tree)


def tree_to_numpy(named: dict) -> dict:
    """``{"a.b.c": tensor}`` -> ``{"a": {"b": {"c": ndarray}}}`` (fp32)."""
    tree: dict = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return tree


def params_to_numpy(gpt: GPT) -> dict:
    """The port GPT's parameters as the JAX parameter tree."""
    return tree_to_numpy(dict(gpt.named_parameters()))
