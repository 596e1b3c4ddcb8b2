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

Weight-only int8 leaves (``{"int8", "scale"}``, from
``ops.quantize_params_int8``) load into a ``Linear``'s weight, which then
runs ``ops.int8_matmul``; the way back gives them as they were (int8 values,
fp32 scales). A quantized leaf aimed at any other module raises
NotImplementedError: the attention projections take plain weights, and the
JAX engine fails on int8 ``wq/wk/wv/wo`` too (ROADMAP.md Queue 3, F4).
"""

from __future__ import annotations

import numpy as np
import torch

from np_modeling_tpu_torch.models.transformer_lm import GPT, GPTConfig
from np_modeling_tpu_torch.nn.linear import Int8Weight, Linear
from np_modeling_tpu_torch.ops.quantization import QKEYS, QKEYS4


def _is_quantized(v) -> bool:
    return isinstance(v, dict) and frozenset(v) in (QKEYS, QKEYS4)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict) and not _is_quantized(v):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _load_quantized(module: torch.nn.Module, name: str, leaf: dict) -> None:
    owner_name, _, attr = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    if not (isinstance(owner, Linear) and attr == "w" and "int8" in leaf):
        raise NotImplementedError(
            f"{name}: a quantized leaf ({sorted(leaf)}) loads only into a "
            "Linear's weight as {'int8', 'scale'}; quantize the FFN only "
            "(match=r'.*(dense1/linear/w|dense2/w)$'). The JAX engine fails "
            "on int8 attention weights too (ROADMAP.md Queue 3, F4); int4 "
            "leaves need ops.dequantize_params first")
    owner.load_int8_(np.array(leaf["int8"]), np.array(leaf["scale"]))


@torch.no_grad()
def load_params(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    leaves = _flatten(tree)
    for name, leaf in leaves.items():
        if _is_quantized(leaf):
            _load_quantized(module, name, leaf)
    params = dict(module.named_parameters())
    plain = {n for n, v in leaves.items() if not _is_quantized(v)}
    if plain != set(params):
        raise KeyError(
            f"parameter trees differ: only in JAX {sorted(plain - set(params))},"
            f" only in the port {sorted(set(params) - plain)}")
    for name, p in params.items():
        arr = np.asarray(leaves[name], dtype=np.float32)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape}, port shape "
                             f"{tuple(p.shape)}")
        p.copy_(torch.tensor(arr))
    return module


def params_from_numpy(tree: dict, config: GPTConfig, device=None) -> GPT:
    """A ``GPT`` on ``device`` (default: the card, as ``GPT``) holding the
    JAX tree's weights."""
    return load_params(GPT(config, device=device), tree)


def tree_to_numpy(named: dict) -> dict:
    """``{"a.b.c": tensor}`` -> ``{"a": {"b": {"c": ndarray}}}``: floating
    tensors as fp32, int8 ones as they are."""
    tree: dict = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        t = t.detach().cpu()
        node[leaf] = (t if t.dtype == torch.int8 else t.float()).numpy()
    return tree


def params_to_numpy(gpt: GPT) -> dict:
    """The port GPT's parameters as the JAX parameter tree (int8 weights as
    their ``{"int8", "scale"}`` leaves)."""
    named = dict(gpt.named_parameters())
    for name, m in gpt.named_modules():
        if isinstance(m, Int8Weight):
            named[f"{name}.int8"], named[f"{name}.scale"] = m.int8, m.scale
    return tree_to_numpy(named)
