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
``dispatch.force_plain()``. It has no backward, as in JAX. ``plan`` picks
the kernel's schedule from shapes alone: ``skinny`` (decode: k split
across a thread-block cluster), ``wide`` (prefill: wgmma) or ``simple``.

``quantize_int8_stochastic`` is the per-row absmax quantizer with
stochastic rounding: the hand-written kernel K10 (``csrc/quantize.cu``) on
CUDA tensors, its plain twin on CPU tensors. Both draw the same Philox bits
(``ops.fused.philox_bits``), so they agree bit for bit; see its docstring
for how this differs from JAX off the TPU.
"""

from __future__ import annotations

import ctypes
import functools
import numbers
import re
from typing import NamedTuple

import numpy as np
import torch

from np_modeling_tpu_torch.ops import dispatch
from np_modeling_tpu_torch.ops.fused import philox_bits, sm_count
from np_modeling_tpu_torch.ops.matmul import mm, round_up


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


# Kernel launches since import (or since a caller reset them to 0): all of
# them, again by schedule, and again by (schedule, k, n).
int8_matmul.launches = 0
int8_matmul.launches_skinny = 0
int8_matmul.launches_wide = 0
int8_matmul.launches_simple = 0
int8_matmul.launches_by_shape = {}


class Plan(NamedTuple):
    schedule: str   # "skinny", "wide" or "simple"
    n_tile: int     # skinny: columns a block (32, 64 or 128); wide: 128
    splits: int     # k ranges: skinny's blocks of one cluster, wide's split-k
    cluster: int    # blocks a thread-block cluster (skinny: = splits)


# skinny: rows of x it takes, its column tiles (tried widest first), its k
# splits (fewest first for each tile; above 8 the cluster is of the
# non-portable size), the k rows a split is rounded to and holds at most
# (shared memory), and the waves of the card's SMs its grid aims for. On
# the H100 (132 SMs) exp_torch_k4_k8.py's sweep is fastest at 128 x 12
# (288 blocks) for [8, 768] x [768, 3072] and at 64 x 16 (192 blocks) for
# [8, 3072] x [3072, 768]: the rule picks both for any SKINNY_WAVES in
# (1.09, 1.45]; larger grids (384 blocks and more) were slower at both.
SKINNY_M, SKINNY_TILES, SKINNY_SPLITS = 64, (128, 64, 32), (1, 2, 4, 8, 16)
SKINNY_ROWS, SKINNY_MAX_ROWS, SKINNY_WAVES = 64, 512, 1.4
# wide: K11's tile and slice, split-k as K11 plans it.
WIDE_TILE, WIDE_SLICE, WIDE_MIN_SPLIT_SLICES = 128, 64, 16


def _cdiv(a, b):
    return -(-a // b)


def skinny_split(k: int, splits: int):
    """(k rows a split, splits) when ``skinny`` is asked for ``splits``
    ranges of k: each a whole number of SKINNY_ROWS rows, none empty (so
    there may be fewer than asked for)."""
    rows = round_up(_cdiv(k, splits), SKINNY_ROWS)
    return rows, _cdiv(k, rows)


def plan(m: int, n: int, k: int, sms: int, aligned: bool = True,
         x_bf16: bool = True) -> Plan:
    """K4's schedule for x [m, k] @ w [k, n] on a card of ``sms`` SMs
    (``fused.sm_count``), from shapes alone.

    ``skinny`` for bf16 x with 1 <= m <= SKINNY_M and k > 0: the first
    (n tile, splits) in order of wider tiles, then fewer splits, whose
    grid of n tiles x splits blocks covers SKINNY_WAVES waves of ``sms``
    SMs, each split a whole number of SKINNY_ROWS-row blocks of k (at most
    SKINNY_MAX_ROWS); where none does, the one with the most blocks.
    (exp_torch_k4_k8.py times every tile and split on the card.)
    ``wide`` for bf16 x with m > SKINNY_M where TMA can read x and the
    weight (k > 0 a multiple of 8, n of 16; x and w 16-byte aligned:
    ``aligned``), split-k only where its [128, 128] tiles cannot fill the
    card (K11's rule). ``simple`` for fp32 x and every other shape."""
    if not x_bf16 or m < 1 or n < 1 or k < 1:
        return Plan("simple", 64, 1, 1)
    if m <= SKINNY_M:
        best = None
        for tile in SKINNY_TILES:
            for req in SKINNY_SPLITS:
                rows, splits = skinny_split(k, req)
                if rows > SKINNY_MAX_ROWS:
                    continue
                blocks = _cdiv(n, tile) * splits
                if blocks >= SKINNY_WAVES * sms:
                    return Plan("skinny", tile, splits, splits)
                if best is None or blocks > best[0]:
                    best = (blocks, Plan("skinny", tile, splits, splits))
        return best[1] if best is not None else Plan("simple", 64, 1, 1)
    if aligned and k % 8 == 0 and n % 16 == 0:
        tiles = _cdiv(m, WIDE_TILE) * _cdiv(n, WIDE_TILE)
        splits = max(1, min(sms // tiles,
                            k // (WIDE_SLICE * WIDE_MIN_SPLIT_SLICES)))
        return Plan("wide", WIDE_TILE, splits, 1)
    return Plan("simple", 64, 1, 1)


@functools.lru_cache(maxsize=1024)
def _cached_plan(m, n, k, x_bf16, aligned, index):
    """``plan`` once per shape, layout and device."""
    return plan(m, n, k, sm_count(torch.device("cuda", index)), aligned,
                x_bf16)


_SCHEDULES = {"simple": 0, "skinny": 1, "wide": 2}


@functools.lru_cache(maxsize=None)
def _function():
    """The library's C function ``np_int8_matmul``, typed (built at first
    use)."""
    from np_modeling_tpu_torch.ops import cuda_build
    fn = cuda_build.load("int8_matmul").lib.np_int8_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    return fn


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
    if m == 0 or n == 0:
        return out.reshape(*lead, n)
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    aligned = x2.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    p = _cached_plan(m, n, k, x.dtype == torch.bfloat16, aligned, index)
    ws = (torch.empty((p.splits, m, n), dtype=torch.float32, device=x.device)
          if p.schedule == "wide" and p.splits > 1 else None)
    with torch.cuda.device(x.device):
        rc = _function()(
            x2.data_ptr(), w.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            ws.data_ptr() if ws is not None else None, _X_CODES[x.dtype],
            _X_CODES[out_dtype], m, n, k, _SCHEDULES[p.schedule], p.n_tile,
            p.splits, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8-matmul kernel ({p.schedule}) launch failed: "
                           f"CUDA error {rc}")
    int8_matmul.launches += 1
    setattr(int8_matmul, f"launches_{p.schedule}",
            getattr(int8_matmul, f"launches_{p.schedule}") + 1)
    by_shape = int8_matmul.launches_by_shape
    by_shape[p.schedule, k, n] = by_shape.get((p.schedule, k, n), 0) + 1
    return out.reshape(*lead, n)
