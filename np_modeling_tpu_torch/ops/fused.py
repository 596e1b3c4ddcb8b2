"""LayerNorm (K8), in-kernel-generator dropout (K7) and fused softmax
cross-entropy (K9): the wrappers of the hand-written CUDA kernels of
``csrc/fused.cu`` and their plain PyTorch versions.

Counterpart of np_modeling_tpu/ops/fused.py (LayerNorm :48-145, softmax-CE
:153-302, dropout :310-370). ``ops.layer_norm`` and ``ops.dropout``
(ops/normalization.py) choose between kernel and plain version by
``ops.dispatch``; the launch counts are theirs (``layer_norm.launches_fwd``
/ ``.launches_bwd``, ``dropout.launches``). ``softmax_cross_entropy_fused``
is defined here, with its counts (``.launches_fwd`` / ``.launches_bwd``).

Random bits. The TPU kernel draws its mask from the TPU's generator, whose
bits exist nowhere else. Here a mask bit is a pure function of a 64-bit
seed and the element's flat index: Philox4x32-10 keyed by the seed, counter
``i // 4``, word ``i % 4``; element i is kept when its word is below
``uint32((1 - rate) * (2**32 - 1))`` (JAX :314). ``philox_keep_mask`` is the
plain twin of the kernel's generator in torch integer arithmetic, so kernel
and plain version draw the same mask, on the card and on the CPU. Seeds are
64-bit host integers (``np_modeling_tpu_torch.rng``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from np_modeling_tpu_torch.ops import dispatch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# ---- Philox4x32-10, the plain twin of the kernel's generator -------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of ``a * m``, exactly, for ``a`` int64
    holding uint32 values: 16-bit limbs of m keep every product below 2**48."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = (p_lo >> 16) + p_hi                      # (a * m) >> 16
    return t >> 16, ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, key):
    """Philox4x32-10 on int64 tensors of uint32 counter words with the key
    ``(k0, k1)`` (Python ints); returns the four output words."""
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """Element kept iff its uint32 word is below this (JAX fused.py:314)."""
    return int((1.0 - rate) * (2 ** 32 - 1))


def philox_bits(seed: int, shape, device=None) -> torch.Tensor:
    """The uint32 words (as int64) that the port's kernels draw for a tensor
    of ``shape`` under ``seed``: element i takes word ``i % 4`` of the draw
    at counter ``i // 4``, computed in torch on ``device``."""
    n = 1
    for s in shape:
        n *= int(s)
    groups = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    zero = torch.zeros_like(groups)
    words = philox4x32_10(groups & _MASK32, groups >> 32, zero, zero,
                          (seed & _MASK32, (seed >> 32) & _MASK32))
    return torch.stack(words, dim=-1).reshape(-1)[:n].reshape(shape)


def philox_keep_mask(seed: int, shape, rate: float, device=None):
    """The keep-mask (True = keep) that the dropout kernel draws for a
    tensor of ``shape`` under ``seed``, computed in torch on ``device``."""
    return philox_bits(seed, shape, device) < keep_threshold(rate)


@functools.lru_cache(maxsize=64)
def keep_in(dtype: torch.dtype, rate: float) -> float:
    """``1 - rate`` as x's dtype holds it: JAX divides x by the weakly typed
    Python float, which takes x's dtype (bf16: 0.9 -> 0.8984375)."""
    return float(torch.tensor(1.0 - rate, dtype=dtype))


def dropout_scale(x: torch.Tensor, rate: float) -> torch.Tensor:
    """``x / keep`` in fp32, rounded once to x's dtype (the plain version of
    the kernel's kept elements). The divisor is a device tensor: a CPU
    scalar divisor becomes a product with its reciprocal on CUDA."""
    keep = torch.full((), keep_in(x.dtype, rate), dtype=torch.float32,
                      device=x.device)
    return (x.float() / keep).to(x.dtype)


# ---- the CUDA kernels (K7, K8, K9) ---------------------------------------

_LN_PER_THREAD, _LN_MAX_THREADS = 16, 512
LN_MAX_D = _LN_PER_THREAD * _LN_MAX_THREADS


def ln_threads(d: int) -> int:
    """Threads the LayerNorm kernels give a row of ``d``: the least power of
    two >= 32 holding it at 16 elements a thread; raises past 8192."""
    if not 1 <= d <= LN_MAX_D:
        raise ValueError(f"the LayerNorm kernels take 1 <= d <= {LN_MAX_D}, "
                         f"got d = {d}")
    t = 32
    while t * _LN_PER_THREAD < d:
        t *= 2
    return t


_ARGTYPES = {
    "np_layer_norm_fwd": [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_float],
    "np_layer_norm_bwd": [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float],
    "np_dropout": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_uint64, ctypes.c_uint32,
                   ctypes.c_float],
    "np_sxe_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int],
    "np_sxe_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int],
}


@functools.lru_cache(maxsize=None)
def _function(name):
    """The library's C function ``name``, typed (built at first use)."""
    from np_modeling_tpu_torch.ops import cuda_build
    fn = getattr(cuda_build.load("fused").lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name] + [ctypes.c_void_p]   # ..., stream
    return fn


def _call(name, *args, device):
    """Launches ``name`` on the current stream of ``device``; raises if the
    launch returned a CUDA error."""
    fn = _function(name)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {rc}")


def _counters():
    # The public ops carry the launch counts; imported at call time because
    # ops/normalization.py imports this module.
    from np_modeling_tpu_torch.ops import normalization
    return normalization


def _rows(x, d):
    """x as contiguous rows [n, d] (a copy only where the view is not)."""
    return x.reshape(-1, d).contiguous()


def _check_ln(x, gamma):
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the LayerNorm kernels take float32 or bfloat16, "
                         f"not {x.dtype}")
    if gamma.shape != (x.shape[-1],) or gamma.device != x.device:
        raise ValueError(f"gamma {tuple(gamma.shape)} on {gamma.device} for "
                         f"x {tuple(x.shape)} on {x.device}")
    return ln_threads(x.shape[-1])


def layer_norm_fwd_cuda(x, gamma, beta, eps):
    """K8 forward on a CUDA tensor: ``out`` in x's dtype."""
    t_row = _check_ln(x, gamma)
    d = x.shape[-1]
    x2 = _rows(x, d)
    out = torch.empty_like(x2)
    if x2.shape[0]:
        g, b = gamma.float().contiguous(), beta.float().contiguous()
        _call("np_layer_norm_fwd", x2.data_ptr(), g.data_ptr(),
              b.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
              x2.shape[0], d, t_row, eps, device=x.device)
        _counters().layer_norm.launches_fwd += 1
    return out.view(x.shape)


def layer_norm_bwd_cuda(x, gamma, dz, eps):
    """K8 backward on CUDA tensors: dx in dz's dtype (= x's), dgamma and
    dbeta in gamma's dtype from per-block fp32 partials summed here."""
    t_row = _check_ln(x, gamma)
    if dz.dtype != x.dtype or dz.shape != x.shape:
        raise ValueError(f"dz {dz.dtype} {tuple(dz.shape)} for x {x.dtype} "
                         f"{tuple(x.shape)}: the kernel takes them alike")
    d = x.shape[-1]
    x2, dz2 = _rows(x, d), _rows(dz, d)
    n = x2.shape[0]
    dx = torch.empty_like(x2)
    if n == 0:
        zeros = torch.zeros(d, dtype=gamma.dtype, device=x.device)
        return dx.view(x.shape), zeros, zeros.clone()
    rows_per_block = max(128 // t_row, 1)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_blocks = min(-(-n // rows_per_block), 4 * sms)
    dg_part = torch.empty((n_blocks, d), dtype=torch.float32, device=x.device)
    db_part = torch.empty_like(dg_part)
    g = gamma.float().contiguous()
    _call("np_layer_norm_bwd", x2.data_ptr(), g.data_ptr(), dz2.data_ptr(),
          dx.data_ptr(), dg_part.data_ptr(), db_part.data_ptr(),
          _DTYPE_CODES[x.dtype], n, d, t_row, n_blocks, eps, device=x.device)
    _counters().layer_norm.launches_bwd += 1
    return (dx.view(x.shape), dg_part.sum(dim=0).to(gamma.dtype),
            db_part.sum(dim=0).to(gamma.dtype))


def dropout_cuda(x, seed, rate):
    """K7 on a CUDA tensor: ``x / keep`` where the seed's mask keeps, else 0."""
    if not x.is_cuda:
        raise ValueError(f"the dropout kernel takes a CUDA tensor, not one on "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the dropout kernel takes float32 or bfloat16, not "
                         f"{x.dtype}")
    xc = x.contiguous()
    if xc.data_ptr() % 16:
        xc = xc.clone()
    out = torch.empty_like(xc)
    if xc.numel():
        _call("np_dropout", xc.data_ptr(), out.data_ptr(),
              _DTYPE_CODES[x.dtype], xc.numel(), seed, keep_threshold(rate),
              keep_in(x.dtype, rate), device=x.device)
        _counters().dropout.launches += 1
    return out


# ---- the plain versions --------------------------------------------------

def _stats(x, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf - mean) * rstd, rstd


def layer_norm_fwd_plain(x, gamma, beta, eps):
    yhat, _ = _stats(x, eps)
    return (gamma.float() * yhat + beta.float()).to(x.dtype)


def layer_norm_bwd_plain(x, gamma, dz, eps):
    """The fused two-reduction backward (JAX normalization.py:63-83)."""
    yhat, rstd = _stats(x, eps)
    dzf = dz.float()
    batch = tuple(range(dz.dim() - 1))
    dbeta = dzf.sum(dim=batch).to(gamma.dtype)
    dgamma = (dzf * yhat).sum(dim=batch).to(gamma.dtype)
    dyhat = dzf * gamma.float()
    m1 = dyhat.mean(dim=-1, keepdim=True)
    m2 = (dyhat * yhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dyhat - m1 - yhat * m2)).to(dz.dtype)
    return dx, dgamma, dbeta


class _DropoutPRNG(torch.autograd.Function):
    """The mask is never stored: the backward draws it again from the seed."""

    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        return dropout_cuda(x, seed, rate)

    @staticmethod
    def backward(ctx, dy):
        return dropout_cuda(dy, ctx.seed, ctx.rate), None, None


def dropout_prng(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Inverted dropout whose mask K7 draws from ``seed`` (JAX :345-364), on
    CUDA tensors only, as JAX's K7 runs on the TPU only. ``ops.dropout``
    calls it on the card; elsewhere its plain path is the explicit mask
    ``philox_keep_mask``, which holds the same bits."""
    return _DropoutPRNG.apply(x, seed, rate)


# ---- fused softmax cross-entropy (K9) --------------------------------------

def sxe_rows(logits, labels):
    """logits as contiguous rows [n, v] and labels as int64 [n]; raises on
    shapes that do not pair."""
    if labels.shape != logits.shape[:-1]:
        raise ValueError(f"labels {tuple(labels.shape)} for logits "
                         f"{tuple(logits.shape)}: want logits.shape[:-1]")
    v = logits.shape[-1]
    return logits.reshape(-1, v).contiguous(), \
        labels.reshape(-1).to(torch.int64).contiguous()


def sxe_fwd_plain(l2, lab):
    """(ce, lse), fp32 [n]: logsumexp minus the label's logit, nothing
    picked up for a label outside [0, v) (JAX's ``hit`` never fires)."""
    lf = l2.float()
    v = lf.shape[-1]
    lse = torch.logsumexp(lf, dim=-1)
    valid = (lab >= 0) & (lab < v)
    hit = lf.gather(-1, lab.clamp(0, v - 1)[:, None])[:, 0]
    return lse - torch.where(valid, hit, 0.0), lse


def sxe_bwd_plain(l2, lab, lse, g):
    """``(softmax - onehot) * g`` in the logits' dtype, one rounding."""
    lf = l2.float()
    p = torch.exp(lf - lse[:, None])
    cols = torch.arange(lf.shape[-1], device=lf.device)
    onehot = (cols == lab[:, None]).float()
    return ((p - onehot) * g.float()[:, None]).to(l2.dtype)


def _check_sxe(l2, lab):
    if l2.dtype not in _DTYPE_CODES:
        raise ValueError(f"the softmax-CE kernels take float32 or bfloat16 "
                         f"logits, not {l2.dtype}")
    if lab.device != l2.device:
        raise ValueError(f"labels on {lab.device}, logits on {l2.device}")


def sxe_fwd_cuda(l2, lab):
    """K9 forward on CUDA rows: (ce, lse), fp32 [n]."""
    _check_sxe(l2, lab)
    n, v = l2.shape
    ce = torch.empty(n, dtype=torch.float32, device=l2.device)
    lse = torch.empty_like(ce)
    if n:
        _call("np_sxe_fwd", l2.data_ptr(), lab.data_ptr(), ce.data_ptr(),
              lse.data_ptr(), _DTYPE_CODES[l2.dtype], n, v, device=l2.device)
        softmax_cross_entropy_fused.launches_fwd += 1
    return ce, lse


def sxe_bwd_cuda(l2, lab, lse, g):
    """K9 backward on CUDA rows: dlogits [n, v] in the logits' dtype."""
    _check_sxe(l2, lab)
    n, v = l2.shape
    if l2.data_ptr() % 16:
        l2 = l2.clone()          # rows split alike in logits and dlogits
    out = torch.empty_like(l2)
    if n:
        g, lse = g.to(torch.float32).contiguous(), lse.contiguous()
        _call("np_sxe_bwd", l2.data_ptr(), lab.data_ptr(),
              lse.data_ptr(), g.data_ptr(), out.data_ptr(),
              _DTYPE_CODES[l2.dtype], n, v, device=l2.device)
        softmax_cross_entropy_fused.launches_bwd += 1
    return out


class _SxeFused(torch.autograd.Function):
    """Saves the logits, the labels and lse (fp32 [n]) only; the backward
    recomputes the probabilities."""

    @staticmethod
    def forward(ctx, logits, labels):
        l2, lab = sxe_rows(logits, labels)
        ctx.kernel = dispatch.use_kernel(l2)
        ce, lse = (sxe_fwd_cuda if ctx.kernel else sxe_fwd_plain)(l2, lab)
        ctx.save_for_backward(l2, lab, lse)
        ctx.shape = logits.shape
        return ce.reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        l2, lab, lse = ctx.saved_tensors
        g2 = g.reshape(-1)
        dl = (sxe_bwd_cuda if ctx.kernel else sxe_bwd_plain)(l2, lab, lse, g2)
        return dl.reshape(ctx.shape), None


def softmax_cross_entropy_fused(logits: torch.Tensor,
                                labels: torch.Tensor) -> torch.Tensor:
    """Per-example CE from logits [..., v] (fp32 or bf16) and integer labels
    [...]: fp32 with the labels' shape (JAX :211). A label outside [0, v)
    picks up no logit (ce = lse) and no onehot. K9 on CUDA tensors, the
    plain version on CPU tensors or under ``dispatch.force_plain()``; the
    backward is ``(softmax - onehot) * g`` in the logits' dtype."""
    return _SxeFused.apply(logits, labels)


def softmax_cross_entropy_fused_reference(logits: torch.Tensor,
                                          labels: torch.Tensor):
    """K9's plain forward: per-example ce, fp32, with the labels' shape."""
    l2, lab = sxe_rows(logits, labels)
    return sxe_fwd_plain(l2, lab)[0].reshape(labels.shape)


# Kernel launches since import (or since a caller reset them to 0).
softmax_cross_entropy_fused.launches_fwd = 0
softmax_cross_entropy_fused.launches_bwd = 0
