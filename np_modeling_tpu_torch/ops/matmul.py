"""2-D matrix product ``op(a) @ op(b) (+ bias)`` with fp32 accumulation,
logical transposes and a bias epilogue: the wrapper of the hand-written CUDA
kernel K11 (``csrc/matmul.cu``) and its plain version.

Counterpart of np_modeling_tpu/ops/matmul.py. As there, the default path is
the library product (JAX: ``lax.dot_general``; here ``mm``, cuBLAS on the
card): the products of ``ops.linear`` run there unless a caller asks for the
kernel. Under ``dispatch.force_kernels()`` (JAX: ``force_pallas(True)``) a
product of CUDA tensors launches K11; CPU tensors, or ``force_plain()``,
keep the library path. ``matmul_reference`` is K11's plain version: the
product of the exact fp32 copies, the bias added in fp32, one rounding.

``mm`` stays the library product for the callers that JAX leaves to XLA
whatever the dispatch says (the chunk products of ``fused_lm_head_loss``,
``int8_matmul_reference``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from np_modeling_tpu_torch.ops import dispatch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """2-D ``a @ b`` accumulated in fp32 and rounded once to ``out_dtype``.

    On CUDA a bf16 product with an fp32 result is ``aten::mm.dtype``; the
    CPU build has no such kernel, and there the product of the fp32 copies
    is exact for bf16 operands."""
    if a.device.type == "cuda":
        if a.dtype == out_dtype:
            return torch.mm(a, b)
        return torch.mm(a, b, out_dtype=out_dtype)
    return torch.mm(a.float(), b.float()).to(out_dtype)


def _dims(a, b, trans_a, trans_b):
    """(m, k, n) of ``op(a) @ op(b)``; raises on ranks or a contraction
    mismatch."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, not {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    m, ka = (a.shape[1], a.shape[0]) if trans_a else a.shape
    kb, n = (b.shape[1], b.shape[0]) if trans_b else b.shape
    if ka != kb:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)} (trans_a={trans_a}, "
                         f"trans_b={trans_b})")
    return m, ka, n


def _logical(a, b, trans_a, trans_b):
    """op(a), op(b) as views, in their promoted dtype (JAX's dot_general
    promotes mixed operands)."""
    ct = torch.promote_types(a.dtype, b.dtype)
    return (a.t() if trans_a else a).to(ct), (b.t() if trans_b else b).to(ct)


def matmul_reference(a, b, bias=None, *, trans_a=False, trans_b=False,
                     out_dtype=None):
    """K11's plain version: the product of the exact fp32 copies of op(a)
    and op(b), the bias added in fp32, one rounding to ``out_dtype``."""
    _dims(a, b, trans_a, trans_b)
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    a_op, b_op = _logical(a, b, trans_a, trans_b)
    out = torch.mm(a_op.float(), b_op.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def matmul(a: torch.Tensor, b: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, trans_a: bool = False,
           trans_b: bool = False, out_dtype=None, block_m: int = 512,
           block_n: int = 512, block_k: int = 512) -> torch.Tensor:
    """2-D ``op(a) @ op(b) (+ bias)`` with fp32 accumulation, one rounding
    to ``out_dtype`` (default: the operands' promoted dtype).

    ``trans_a``/``trans_b`` transpose the operands logically: K11 reads
    them in their stored layout, and no transposed copy is made.
    ``block_m/n/k`` are the TPU kernel's tiling; they are accepted for
    parity with the JAX signature and change nothing here."""
    del block_m, block_n, block_k
    m, k, n = _dims(a, b, trans_a, trans_b)
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    if dispatch.kernels_forced() and dispatch.use_kernel(a):
        return _launch(a, b, bias, trans_a, trans_b, out_dtype, m, k, n)
    a_op, b_op = _logical(a, b, trans_a, trans_b)
    if bias is None:
        return mm(a_op, b_op, out_dtype)
    return (mm(a_op, b_op, torch.float32) + bias.float()).to(out_dtype)


# Kernel launches since import (or since a caller reset it to 0).
matmul.launches = 0


# Of those, the launches of K11's ragged variant (bf16 operands whose stored
# rows are not whole 16-byte vectors, or k = 0).
matmul.launches_ragged = 0

# K11's bf16 tile (rows x columns of the output a block owns) and k slice;
# the card's SMs, which split-k fills.
TILE, SLICE, SMS = 128, 64, 132
# Split-k takes at least this many k slices a split.
MIN_SPLIT_SLICES = 16


def plan(m, k, n, trans_a, trans_b, aligned=True):
    """K11's schedule for bf16 operands: (variant, splits).

    variant "tma" where TMA can read both operands (each stored row a whole
    number of 16-byte vectors: k for a k-contiguous operand, m or n
    otherwise; ``aligned``: both base pointers 16-byte aligned; k > 0),
    else "ragged". splits > 1 where the [TILE, TILE] output tiles cannot
    fill the card's SMS SMs and k holds MIN_SPLIT_SLICES slices a split:
    as many splits as fit one wave of blocks."""
    rows_a = m if trans_a else k
    rows_b = k if trans_b else n
    tma = aligned and k > 0 and rows_a % 8 == 0 and rows_b % 8 == 0
    tiles = -(-m // TILE) * -(-n // TILE)
    splits = max(1, min(SMS // tiles, k // (SLICE * MIN_SPLIT_SLICES)))
    return ("tma" if tma else "ragged"), splits


@functools.lru_cache(maxsize=None)
def _function():
    """The library's C function ``np_matmul``, typed (built at first use)."""
    from np_modeling_tpu_torch.ops import cuda_build
    fn = cuda_build.load("matmul").lib.np_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    return fn


def _launch(a, b, bias, trans_a, trans_b, out_dtype, m, k, n):
    ct = torch.promote_types(a.dtype, b.dtype)
    if ct not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"K11 takes float32 or bfloat16 operands and "
                         f"output, not {a.dtype} x {b.dtype} -> {out_dtype}")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias {tuple(bias.shape)}: want [{n}]")
    tensors = [t for t in (a, b, bias) if t is not None]
    if any(t.device != a.device for t in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    a, b = a.to(ct).contiguous(), b.to(ct).contiguous()
    bias = bias.float().contiguous() if bias is not None else None
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    variant, splits = "tma", 1
    if ct == torch.bfloat16:
        variant, splits = plan(m, k, n, trans_a, trans_b,
                               a.data_ptr() % 16 == 0
                               and b.data_ptr() % 16 == 0)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    with torch.cuda.device(a.device):
        rc = _function()(a.data_ptr(), b.data_ptr(),
                         bias.data_ptr() if bias is not None else None,
                         out.data_ptr(), ws.data_ptr() if ws is not None
                         else None, _DTYPE_CODES[ct],
                         _DTYPE_CODES[out_dtype], m, n, k, int(trans_a),
                         int(trans_b), int(variant == "ragged"), splits,
                         torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K11 matmul kernel launch failed: CUDA error {rc}")
    matmul.launches += 1
    if ct == torch.bfloat16 and variant == "ragged":
        matmul.launches_ragged += 1
    return out
