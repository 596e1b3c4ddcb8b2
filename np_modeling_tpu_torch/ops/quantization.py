"""Int8 quantization: absmax quant/dequant, weight-only int8/int4 parameter
trees, and the int8-weight matmul.

Counterpart of np_modeling_tpu/ops/quantization.py. ``quantize_int8`` is the
per-row (last axis) round-to-nearest absmax quantizer that the int8 KV cache
uses; ``torch.round`` rounds half to even, as ``jnp.round`` does, so values
and scales equal JAX's bit for bit. ``quantize_params_int8`` /
``quantize_params_int4`` / ``dequantize_params`` work on nested-dict trees of
tensors or numpy arrays; a leaf's path joins its keys with ``/``.

``int8_matmul`` launches the hand-written Hopper kernel in
``csrc/int8_matmul.cu`` on CUDA tensors and runs ``int8_matmul_reference``
(the JAX package's off-TPU path) on CPU tensors or under
``dispatch.force_plain()``. It has no backward, as in JAX.

``quantize_int8_stochastic`` is the per-row absmax quantizer with
stochastic rounding: the hand-written kernel K10 (``csrc/quantize.cu``) on
CUDA tensors, its plain twin on CPU tensors. Both draw the same Philox bits
(``ops.fused.philox_bits``), so they agree bit for bit; see its docstring
for how this differs from JAX off the TPU.
"""

from __future__ import annotations

import ctypes
import numbers
import re
from typing import NamedTuple

import numpy as np
import torch

from np_modeling_tpu_torch.ops import dispatch
from np_modeling_tpu_torch.ops.fused import philox_bits
from np_modeling_tpu_torch.ops.matmul import mm


class QuantizedTensor(NamedTuple):
    values: torch.Tensor   # int8, same shape as the source
    scales: torch.Tensor   # fp32, source shape with last axis -> 1


def quantize_int8(x: torch.Tensor) -> QuantizedTensor:
    """Round-to-nearest absmax int8 over the last axis."""
    absmax = x.float().abs().amax(dim=-1, keepdim=True)
    scales = torch.where(absmax == 0, 1.0, absmax / 127.0)
    values = torch.round(x / scales).clamp(-127, 127).to(torch.int8)
    return QuantizedTensor(values, scales)


def dequantize_int8(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return (qt.values.float() * qt.scales).to(dtype)


# ---------------------------------------------------------------------------
# Stochastic-rounding quantization (K10)
# ---------------------------------------------------------------------------

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK64 = (1 << 64) - 1


def stochastic_round_int8(x: torch.Tensor, u: torch.Tensor) -> QuantizedTensor:
    """Absmax int8 over the last axis with stochastic rounding given the
    uniforms ``u`` in [0, 1) (x's shape), in the TPU kernel's fp32
    arithmetic (JAX :50-62): ``scale = 1 if absmax == 0 else absmax / 127``,
    ``s = x / scale``, ``q = floor(s) + (u < s - floor(s))`` clipped to
    +-127. The divisors are device tensors: a Python-scalar divisor is a
    product with its reciprocal on CUDA, not a division."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    d127 = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scales = torch.where(absmax == 0, 1.0, absmax / d127)
    scaled = xf / scales
    fl = torch.floor(scaled)
    rounded = fl + (u < scaled - fl).float()
    return QuantizedTensor(rounded.clamp(-127, 127).to(torch.int8), scales)


def philox_uniforms(seed: int, shape, device=None) -> torch.Tensor:
    """The uniforms K10 draws for a tensor of ``shape`` under ``seed``: the
    top 24 bits of element i's Philox word over 2**24 (exact in fp32)."""
    bits = philox_bits(seed, shape, device)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _seed_int(seed) -> int:
    """A 64-bit seed from a host integer or a 1-element CPU tensor (JAX's
    ``seed`` array); a device tensor is refused, as reading it would sync."""
    if isinstance(seed, torch.Tensor):
        if seed.device.type != "cpu" or seed.numel() != 1:
            raise ValueError(f"seed: a host integer or a 1-element CPU tensor, "
                             f"not {tuple(seed.shape)} on {seed.device}")
        return int(seed.reshape(-1)[0]) & _MASK64
    if isinstance(seed, bool) or not isinstance(seed, numbers.Integral) \
            or not 0 <= seed <= _MASK64:
        raise TypeError(f"seed: a 64-bit host integer or a 1-element CPU "
                        f"tensor, not {seed!r}")
    return int(seed)


def quantize_int8_stochastic(x: torch.Tensor, seed) -> QuantizedTensor:
    """Absmax int8 over the last axis with stochastic (unbiased) rounding.

    ``seed``: a 64-bit host integer or a 1-element CPU tensor. Values int8
    with x's shape, scales fp32 with the last axis 1. The uniform of element
    i (its flat index) is the top 24 bits of Philox4x32-10's word ``i % 4``
    at counter ``i // 4`` keyed by the seed, over 2**24: the TPU kernel's
    generator bits cannot be reproduced, so the port defines its own. K10
    on CUDA tensors; on CPU tensors (or under ``dispatch.force_plain()``)
    the plain twin, which draws the same bits in torch integer arithmetic.
    Off the TPU, JAX rounds to nearest instead (only because its generator
    has no CPU emulation); the port keeps the stochastic rounding on every
    device."""
    seed = _seed_int(seed)
    if not dispatch.use_kernel(x):
        return stochastic_round_int8(x, philox_uniforms(seed, x.shape,
                                                        x.device))
    return _quantize_stochastic_cuda(x, seed)


# Kernel launches since import (or since a caller reset it to 0).
quantize_int8_stochastic.launches = 0


def _quantize_stochastic_cuda(x, seed):
    if x.dtype not in _X_CODES:
        raise ValueError(f"K10 takes float32 or bfloat16, not {x.dtype}")
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"K10 takes rows of at least one element, not "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    n = x2.shape[0]
    values = torch.empty(x2.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    if n:
        from np_modeling_tpu_torch.ops import cuda_build
        fn = cuda_build.load("quantize").lib.np_quantize_int8_stochastic
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_void_p]
        with torch.cuda.device(x.device):
            rc = fn(x2.data_ptr(), values.data_ptr(), scales.data_ptr(),
                    _X_CODES[x.dtype], n, d, seed,
                    torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K10 quantize kernel launch failed: CUDA "
                               f"error {rc}")
        quantize_int8_stochastic.launches += 1
    return QuantizedTensor(values.reshape(x.shape),
                           scales.reshape(*x.shape[:-1], 1))


# Matmul weights of the transformer stack (attention projections, FFN, the
# untied LM head); embeddings are left out, as in JAX.
WEIGHT_QUANT_TARGETS = (
    r".*(/w[qkvo]|dense1/linear/w|dense2/w|swiglu/w_(gate|up|down)"
    r"|lm_head/w|mlm_transform/w)$")

QKEYS = frozenset(("int8", "scale"))
QKEYS4 = frozenset(("int4", "scale"))


def _map_leaves(tree, fn, path=""):
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict, where
    ``path`` joins the keys with ``/``."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def _tensor(a) -> torch.Tensor:
    """A tensor as it is; anything else (numpy, possibly read-only) copied."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _like(result: torch.Tensor, leaf):
    """``result`` as a numpy array when ``leaf`` was one, else a tensor."""
    return result.numpy() if isinstance(leaf, np.ndarray) else result


def quantize_params_int8(params, match: str = WEIGHT_QUANT_TARGETS):
    """Replace matched weight leaves (ndim >= 2) with ``{"int8", "scale"}``
    dicts. Scales reduce over axis 0 only: a 2-D weight [in, out] gets
    per-output-column scales [1, out]."""
    pat = re.compile(match)

    def f(path, leaf):
        if not (pat.match(path) and leaf.ndim >= 2):
            return leaf
        x = _tensor(leaf).float()
        absmax = x.abs().amax(dim=0, keepdim=True)
        scale = torch.where(absmax == 0, 1.0, absmax / 127.0)
        values = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
        return {"int8": _like(values, leaf), "scale": _like(scale, leaf)}

    return _map_leaves(params, f)


def quantize_params_int4(params, match: str = WEIGHT_QUANT_TARGETS,
                         group: int = 64):
    """Replace matched weight leaves with ``{"int4", "scale"}`` dicts:
    nibble-packed int4 values (two rows of axis 0 a byte) in [-7, 7] with
    absmax scales shared by ``group`` consecutive rows of axis 0. A leaf
    whose axis 0 ``group`` does not divide stays as it is."""
    pat = re.compile(match)

    def f(path, leaf):
        if not (pat.match(path) and leaf.ndim >= 2):
            return leaf
        n = leaf.shape[0]
        if n % group or group % 2:
            return leaf
        x = _tensor(leaf).float()
        rest = tuple(leaf.shape[1:])
        xg = x.reshape(n // group, group, *rest)
        absmax = xg.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax == 0, 1.0, absmax / 7.0)
        q = torch.round(xg / scale).clamp(-7, 7).to(torch.int32)
        q = q.reshape(n // 2, 2, *rest)
        packed = ((q[:, 0] & 0xF) | ((q[:, 1] & 0xF) << 4)).to(torch.int8)
        return {"int4": _like(packed, leaf), "scale": _like(scale, leaf)}

    return _map_leaves(params, f)


def _unpack_int4(packed, scale, dtype):
    """[n/2, *rest] nibble-packed + [G, 1, *rest] group scales -> [n, *rest]."""
    p = _tensor(packed).to(torch.int32)
    low = ((p & 0xF) ^ 8) - 8            # sign-extend the low nibble
    high = (((p >> 4) & 0xF) ^ 8) - 8
    q = torch.stack([low, high], dim=1)  # [n/2, 2, *rest]
    n = 2 * p.shape[0]
    rest = tuple(p.shape[1:])
    scale = _tensor(scale)
    g = n // scale.shape[0]
    xg = q.reshape(n // g, g, *rest).float() * scale
    return xg.reshape(n, *rest).to(dtype)


def dequantize_params(qparams, dtype=torch.bfloat16):
    """Rebuild a compute tree from ``quantize_params_int8`` /
    ``quantize_params_int4`` output: quantized leaves become ``dtype``
    tensors, every other leaf stays as it is."""
    if isinstance(qparams, dict):
        keys = frozenset(qparams.keys())
        if keys == QKEYS:
            return (_tensor(qparams["int8"]).float()
                    * _tensor(qparams["scale"])).to(dtype)
        if keys == QKEYS4:
            return _unpack_int4(qparams["int4"], qparams["scale"], dtype)
        return {k: dequantize_params(v, dtype) for k, v in qparams.items()}
    if isinstance(qparams, (list, tuple)):
        return type(qparams)(dequantize_params(v, dtype) for v in qparams)
    return qparams


# ---------------------------------------------------------------------------
# Int8-weight matmul (K4)
# ---------------------------------------------------------------------------


def int8_matmul_reference(x, w_int8, scale, bias=None, *, out_dtype=None):
    """Plain version (JAX's off-TPU path): the weight dequantized as
    ``bf16(fp32(w) * scale)``, its product with x accumulated in fp32, the
    bias added in fp32, one rounding to ``out_dtype``."""
    k, n = w_int8.shape
    lead = x.shape[:-1]
    w = (w_int8.float() * scale.reshape(1, n).float()).to(torch.bfloat16)
    out = mm(x.reshape(-1, k), w.to(x.dtype), torch.float32)
    if bias is not None:
        out = out + bias.float()
    return out.reshape(*lead, n).to(out_dtype or x.dtype)


def int8_matmul(x, w_int8, scale, bias=None, *, out_dtype=None):
    """``x @ dequant(w)`` with the weight read as int8.

    ``x`` [..., k] bf16 or fp32; ``w_int8`` [k, n] int8; ``scale`` [1, n]
    or [n] fp32 per-output-column scales (``quantize_params_int8``'s 2-D
    layout); ``bias`` [n] or None. Returns [..., n] in ``out_dtype``
    (default x's dtype). The kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if not dispatch.use_kernel(x):
        return int8_matmul_reference(x, w_int8, scale, bias,
                                     out_dtype=out_dtype)
    return _launch(x, w_int8, scale, bias, out_dtype or x.dtype)


# Kernel launches since import (or since a caller reset it to 0).
int8_matmul.launches = 0


def _launch(x, w_int8, scale, bias, out_dtype):
    if w_int8.dtype != torch.int8 or w_int8.dim() != 2:
        raise ValueError(f"w_int8 {w_int8.dtype} {tuple(w_int8.shape)}: want "
                         "a 2-D int8 [k, n]")
    k, n = w_int8.shape
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not contract with w "
                         f"[{k}, {n}]")
    if scale.numel() != n:
        raise ValueError(f"scale {tuple(scale.shape)}: want [1, {n}] or [{n}]")
    if bias is not None and bias.numel() != n:
        raise ValueError(f"bias {tuple(bias.shape)}: want [{n}]")
    if x.dtype not in _X_CODES or out_dtype not in _X_CODES:
        raise ValueError(f"dtypes x {x.dtype} / out {out_dtype}: want float32"
                         " or bfloat16")
    tensors = [t for t in (x, w_int8, scale, bias) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    w = w_int8.contiguous()
    scale = scale.reshape(n).float().contiguous()
    bias = bias.reshape(n).float().contiguous() if bias is not None else None
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)

    from np_modeling_tpu_torch.ops import cuda_build
    fn = cuda_build.load("int8_matmul").lib.np_int8_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x2.data_ptr(), w.data_ptr(), scale.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), _X_CODES[x.dtype], _X_CODES[out_dtype], m, n,
                k, stream)
    if rc != 0:
        raise RuntimeError(f"int8-matmul kernel launch failed: CUDA error {rc}")
    int8_matmul.launches += 1
    return out.reshape(*lead, n)
