"""JAX parameter pytree <-> the port's modules.

``params_from_numpy`` takes the JAX GPT's parameter tree as nested dicts of
arrays (numpy, or anything ``np.asarray`` reads) with the JAX keys
(``layer_{i}/self_attention/wq``, ``layer_{i}/dense1/linear/w``,
``embedding/table``, ...) and returns a port ``GPT`` holding those weights.
The port's parameter names are the JAX paths with ``.`` for ``/``, so the
mapping is by name; a missing, extra or mis-shaped leaf raises.
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
def params_from_numpy(tree: dict, config: GPTConfig, device=None) -> GPT:
    gpt = GPT(config, device=device)
    leaves = _flatten(tree)
    params = dict(gpt.named_parameters())
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
    return gpt


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
