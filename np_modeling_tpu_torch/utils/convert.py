"""JAX parameter pytree <-> the port's modules.

``load_params(module, tree)`` copies a JAX parameter tree, nested dicts of
arrays (numpy, or anything ``np.asarray`` reads), into any port module whose
parameter names are the tree's paths with ``.`` for ``/``; a missing, extra
or mis-shaped leaf raises. ``params_from_numpy`` does so for the JAX GPT's,
T5's, Seq2SeqTransformer's or BertEncoder's tree
(``layer_{i}/self_attention/wq``,
``enc_relpos``, ``decoder/layer_{i}/cross_attention/wk``, ...; an MLA GPT's
``layer_{i}/self_attention/kv_a``, ``kv_a_norm/gamma``, ``kv_b``, ``wo`` and
``wq`` or ``q_a`` / ``q_a_norm/gamma`` / ``q_b``, and an untied head's
``lm_head/w``; an MoE layer's ``layer_{i}/moe/router``, its 3-D expert
weights ``w_gate`` / ``w_up`` / ``w_down`` [E, ., .] (or ``w1`` / ``b1`` /
``w2`` / ``b2``), biases, and ``moe/shared/w_gate|w_up|w_down``; gpt-oss's
``layer_{i}/self_attention/sinks`` [hq]; BERT's ``embedding/table``,
``pos_embedding/table``, ``type_embedding/table``, ``embed_norm``,
``layer_{i}/norm1``, ``dense1/linear``, ``pooler``, ``classifier``,
``mlm_transform``, ``mlm_norm`` and ``mlm_bias``), the model picked by the
config's type, and returns the port's model holding those weights.
``adapters_from_numpy`` / ``adapters_to_numpy`` carry a LoRA adapter tree
(``{path: {"a", "b"}}``, ``training.lora``) across and back.
``params_to_numpy`` and ``tree_to_numpy`` are the way back: a
port model's parameters, or any ``{name: tensor}`` dict such as their
gradients, as the JAX-shaped nested dict of fp32 numpy arrays, for a
leaf-by-leaf comparison.

Weight-only int8 leaves (``{"int8", "scale"}``, from
``ops.quantize_params_int8``) load into a ``Linear``'s weight, which then
runs ``ops.int8_matmul``; the way back gives them as they were (int8 values,
fp32 scales). A quantized leaf aimed at any other module raises
NotImplementedError: the attention projections take plain weights, and the
JAX engine fails on int8 ``wq/wk/wv/wo`` too (ROADMAP.md Queue 3, F4). MoE
expert leaves raise the same way: they are no JAX int8 target either
(``WEIGHT_QUANT_TARGETS`` names the dense FFN's and attention's leaves).
"""

from __future__ import annotations

import numpy as np
import torch

from np_modeling_tpu_torch.models.bert import BertConfig, BertEncoder
from np_modeling_tpu_torch.models.seq2seq import (Seq2SeqConfig,
                                                  Seq2SeqTransformer)
from np_modeling_tpu_torch.models.t5 import T5, T5Config
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


_MODELS = ((GPTConfig, GPT), (T5Config, T5),
           (Seq2SeqConfig, Seq2SeqTransformer), (BertConfig, BertEncoder))


def params_from_numpy(tree: dict, config, device=None) -> torch.nn.Module:
    """The model of ``config`` (a ``GPTConfig``, ``T5Config``,
    ``Seq2SeqConfig`` or ``BertConfig``) on ``device`` (default: the card,
    as the models) holding the JAX tree's weights."""
    for cfg_type, model in _MODELS:
        if isinstance(config, cfg_type):
            return load_params(model(config, device=device), tree)
    raise TypeError(f"no port model for a {type(config).__name__}")


def adapters_from_numpy(tree: dict, device=None) -> dict:
    """A JAX LoRA adapter tree ``{path: {"a": A, "b": B}}`` (numpy, or
    anything ``np.asarray`` reads; ``training.lora_init``'s) as the port's:
    the same paths, fp32 tensors on ``device`` (default: the card)."""
    device = torch.device("cuda") if device is None else device
    return {path: {k: torch.tensor(np.asarray(v, dtype=np.float32),
                                   device=device) for k, v in ad.items()}
            for path, ad in tree.items()}


def adapters_to_numpy(adapters: dict) -> dict:
    """The port's adapter tree as JAX's, fp32 numpy arrays (copies: a
    fine-tune step updates the adapters in place)."""
    return {path: {k: v.detach().cpu().float().numpy().copy()
                   for k, v in ad.items()}
            for path, ad in adapters.items()}


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


def params_to_numpy(model: torch.nn.Module) -> dict:
    """A port model's parameters as the JAX parameter tree (int8 weights as
    their ``{"int8", "scale"}`` leaves)."""
    named = dict(model.named_parameters())
    for name, m in model.named_modules():
        if isinstance(m, Int8Weight):
            named[f"{name}.int8"], named[f"{name}.scale"] = m.int8, m.scale
    return tree_to_numpy(named)
