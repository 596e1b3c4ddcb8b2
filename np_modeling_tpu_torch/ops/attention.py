"""Flash attention with a hand-written backward (training path).

Counterpart of np_modeling_tpu/ops/attention.py. ``flash_attention`` is a
``torch.autograd.Function``. On CUDA tensors it launches the hand-written
Hopper kernels of ``csrc/flash_attention.cu``: the forward K1 (or its
dual-kv schedule K12 under ``FWD_DUAL_KV``) and the fused backward K2 (or
the split backward K5 when ``FUSED_BWD`` is False). On CPU tensors, or under
``dispatch.force_plain()``, it runs the plain version, the port of
``_attn_fwd_jnp``/``_attn_bwd_jnp``, which carries every option whatever
the flags say. The choice of kernels is made once in the forward and kept
for the backward.

Layouts (the JAX package's): q [b, hq, sq, d]; k/v [b, hkv, skv, d];
hq % hkv == 0. Softmax statistics and lse ([b, hq, sq]) are fp32; o is in
q's dtype. Masked scores take the finite ``DEFAULT_MASK_VALUE``, never -inf.
The causal mask is top-left (``col <= row`` in absolute indices), as in JAX.

The kernels take causal and non-causal attention, GQA, segment ids, a
sliding window, a logit softcap (each a template option of the kernels, so
a call without it runs code without it), any sq/skv >= 1, head_dim 64, 128
or 256, and fp32 (FMA path) or bf16 (tensor cores); a head_dim under 64
runs on zero-padded copies of q, k and v at 64 (``_fwd_padded``,
``_bwd_padded``: the padded columns add 0 to every score, the scale stays
the caller's, and o, dq, dk and dv are cut back). Head_dim 192 (MLA's
nope + rope, v zero-padded to it) is built for what MLA passes: causal or
not, GQA, segment ids, and nothing else (a window, softcap, mask or bias
there raises NotImplementedError on a CUDA tensor). The forward K1 also
takes a boolean ``mask`` (read by its own strides, broadcast dims
included; segment ids are merged into it on the host): dense KV-cache
decode runs through it at every sq, 1 included, where JAX sends sq < 128
to XLA. Every kernel takes an additive fp32 ``bias`` (T5's relative
positions), read by its strides like the mask and added after the softcap;
K2 and K5's dq kernel write dbias, which the wrapper sums over the bias's
broadcast dims. The bias runs alone, with segment ids, with K1's mask, and
with the softcap alone at head_dim 64; with a window, or with the softcap
beside segment ids or a mask or at another head_dim, it raises
NotImplementedError on a CUDA tensor
(uninstantiated, ROADMAP.md Queue 2 A), and any other head_dim (ValueError).
The backwards K2 and K5 take the mask (segment ids merged into it) alone at
head_dim 64, fp32 and bf16, causal or not: BERT's ``mask=``. A mask with
gradients and a window, a softcap or a bias, or at head_dim 128/192/256,
raises NotImplementedError on a CUDA tensor before any launch (Queue 2 A).
The backwards reproduce the plain path on a row that the mask leaves
without a key: its lse is the mask value, so p is 1 at every key (dv = do
there, dq nonzero), as JAX's jnp path gives.
K12 takes no bias: a bias sends the forward to K1, as JAX does. Sinks run,
as in JAX, as a plain rescale around the kernels. ``block_q``/``block_kv`` are accepted for
the JAX signature; the kernels' tiles are their own (the bf16 forward: 128
q rows by 128 keys, 64 keys at head_dim 192 and 256; the bf16 backward 64-row q
tiles; fp32 64 x 64, 32 x 32 at head_dim 192 and 256).
"""

from __future__ import annotations

import ctypes
import math

import torch

from np_modeling_tpu_torch.ops import dispatch

# np_modeling_tpu/ops/attention.py DEFAULT_MASK_VALUE.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _fwd_kv_tile(dtype, d):
    """Keys a kv tile of the forward kernel that runs (K1 and K12 alike)."""
    if dtype == torch.bfloat16:
        return 64 if d > 128 else 128
    return 32 if d > 128 else 64

# JAX's schedule flags (np_modeling_tpu/ops/attention.py:100, :1185), read
# by each call's forward and kept for its backward. FWD_DUAL_KV: the forward
# runs K12, two kv tiles a loop step, where JAX's conditions hold (no mask,
# bias, segment ids or softcap, an even number of kv tiles; a window runs);
# its o and lse equal K1's bit for bit. FUSED_BWD False: the backward runs
# K5, a dq kernel that owns its rows and a dk/dv kernel, in place of K2,
# whose dq is summed with atomics in an order that changes from run to run;
# K5's is the same on every run.
FWD_DUAL_KV = False
FUSED_BWD = True


def _repeat_kv(x, g):
    return x.repeat_interleave(g, dim=1) if g > 1 else x


def _apply_masks(s, mask, causal, window=None):
    if causal:
        sq, skv = s.shape[-2], s.shape[-1]
        row = torch.arange(sq, device=s.device)[:, None]
        col = torch.arange(skv, device=s.device)[None, :]
        keep = col <= row
        if window is not None:
            keep = keep & (col > row - window)
        s = torch.where(keep, s, DEFAULT_MASK_VALUE)
    if mask is not None:
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    return s


def attention_reference(q, k, v, mask=None, causal=False, scale=None,
                        softcap=None):
    """Plain attention (torch autograd through it): the test oracle."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    g = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     _repeat_kv(k, g).float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    p = torch.softmax(_apply_masks(s, mask, causal), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        _repeat_kv(v, g).float()).to(q.dtype)


def _merge_seg_into_mask(mask, q_seg, kv_seg):
    if q_seg is None:
        return mask
    smask = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
    return smask if mask is None else (mask & smask)


def _group_sum(x_full, g):
    """Sum per-q-head kv grads over each GQA group: [b,hq,..] -> [b,hkv,..]."""
    if g == 1:
        return x_full
    b, hq = x_full.shape[:2]
    return x_full.reshape(b, hq // g, g, *x_full.shape[2:]).sum(dim=2)


def _unbroadcast_bias(dbias, bias):
    """Sum dbias over the dims where bias was broadcast ([b|1, h|1, ..])."""
    for ax in range(4):
        if bias.shape[ax] == 1 and dbias.shape[ax] != 1:
            dbias = dbias.sum(dim=ax, keepdim=True)
    return dbias.to(bias.dtype)


def _scores(q, k, g, scale, softcap, bias):
    """Scaled (and capped, biased) fp32 scores; also the softcap's
    derivative factor, or None."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     _repeat_kv(k, g).float()) * scale
    cap_grad = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        cap_grad = 1.0 - t * t
        s = softcap * t
    if bias is not None:
        s = s + bias
    return s, cap_grad


def _attn_fwd_plain(q, k, v, mask, bias, causal, window, scale,
                    softcap=None):
    g = q.shape[1] // k.shape[1]
    s, _ = _scores(q, k, g, scale, softcap, bias)
    s = _apply_masks(s, mask, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, _repeat_kv(v, g).float()) / l
    lse = m.squeeze(-1) + torch.log(l.squeeze(-1))
    return o.to(q.dtype), lse


def _attn_bwd_plain(q, k, v, o, lse, do, mask, bias, causal, window, scale,
                    softcap=None):
    """FlashAttention-2-style gradients (p recomputed from the saved lse)."""
    g = q.shape[1] // k.shape[1]
    s, cap_grad = _scores(q, k, g, scale, softcap, bias)
    s = _apply_masks(s, mask, causal, window)
    p = torch.exp(s - lse[..., None])
    do32 = do.float()
    dv_full = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, _repeat_kv(v, g).float())
    di = (do32 * o.float()).sum(dim=-1, keepdim=True)
    ds_raw = p * (dp - di)              # grad wrt the post-bias scores
    ds = ds_raw if cap_grad is None else ds_raw * cap_grad
    ds = ds * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _repeat_kv(k, g).float())
    dk_full = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dk, dv = _group_sum(dk_full, g), _group_sum(dv_full, g)
    dbias = _unbroadcast_bias(ds_raw, bias) if bias is not None else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


# ---- the CUDA kernels (K1, K12, K2, K5) -------------------------------------

# The smallest head_dim the kernels are built for: a narrower one runs on
# zero-padded copies.
MIN_KERNEL_D = 64


def _pad_d(*xs):
    return [torch.nn.functional.pad(x, (0, MIN_KERNEL_D - x.shape[-1]))
            for x in xs]


def _fwd_padded(fwd, q, k, v, *args, **kw):
    """``fwd(q, k, v, ...)`` -> (o, lse) at head_dim 64 where q's is less,
    o cut back to it. The zero columns change no score, and ``fwd`` gets
    the scale from the caller."""
    d = q.shape[-1]
    if d >= MIN_KERNEL_D:
        return fwd(q, k, v, *args, **kw)
    o, lse = fwd(*_pad_d(q, k, v), *args, **kw)
    return o[..., :d], lse


def _bwd_padded(bwd, q, k, v, o, lse, do, *args, **kw):
    """``bwd(q, k, v, o, lse, do, ...)`` -> (dq, dk, dv, dbias) at head_dim
    64 where q's is less, dq, dk and dv cut back to it."""
    d = q.shape[-1]
    if d >= MIN_KERNEL_D:
        return bwd(q, k, v, o, lse, do, *args, **kw)
    dq, dk, dv, dbias = bwd(*_pad_d(q, k, v, o), lse, *_pad_d(do), *args,
                            **kw)
    return dq[..., :d], dk[..., :d], dv[..., :d], dbias

def _kernel_layout(x):
    """``x`` as the kernels read it: last dim contiguous, 16-byte aligned
    rows, no broadcast (zero-stride) dimension, as the forward's TMA tensor
    maps need (a copy only where the view does not allow that)."""
    vec = 16 // x.element_size()
    if x.stride(-1) != 1 or any(s % vec or (s == 0 and n > 1) for s, n in
                                zip(x.stride()[:3], x.shape[:3])) \
            or x.data_ptr() % 16:
        x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("flash attention needs 16-byte aligned tensors")
    return x


def _check_kernel_inputs(q, k, v, q_seg, kv_seg):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want [b,hq,sq,d], [b,hkv,skv,d]")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match (batch, head_dim, or head groups)")
    if d not in (64, 128, 192, 256):
        raise ValueError(f"head_dim {d}: the kernels take 64, 128, 192 or "
                         "256")
    if sq == 0 or k.shape[2] == 0:
        raise ValueError("flash attention needs sq >= 1 and skv >= 1")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} / k {k.dtype} / v {v.dtype}: "
                         "want all float32 or all bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one CUDA device")
    if q_seg is not None:
        for name, seg, n in (("q", q_seg, sq), ("kv", kv_seg, k.shape[2])):
            if tuple(seg.shape) != (b, n) or seg.device != q.device:
                raise ValueError(f"{name} segment ids {tuple(seg.shape)}: "
                                 f"want [{b}, {n}] on {q.device}")


def _check_d192(d, window, softcap, mask, bias):
    """Head_dim 192 is instantiated without options but segment ids
    (csrc/flash_attention.cu, with_mla_opt): MLA refuses a window and passes
    no softcap, mask or bias."""
    if d == 192:
        given = [name for name, x in (("a window", window), ("a softcap",
                                                             softcap),
                                      ("a mask", mask), ("a bias", bias))
                 if x is not None]
        if given:
            raise NotImplementedError(
                f"the flash kernels at head_dim 192 (MLA) are not built with "
                f"{' or '.join(given)} (ROADMAP.md Queue 2 A)")


def _mask_bwd_unbuilt(d, window, softcap, bias):
    """Why the backwards cannot take a mask with these options, or None: it
    is built alone at head_dim 64 (csrc/flash_attention.cu, with_bwd_opt)."""
    given = [name for name, x in (("a window", window), ("a softcap", softcap),
                                  ("a bias", bias)) if x is not None]
    if given:
        return f"a mask with {' or '.join(given)}"
    if d != 64:
        return f"a mask at head_dim {d}"
    return None


def _seg_int32(seg):
    return None if seg is None else seg.to(torch.int32)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _mask_u8(mask, q, k):
    """The mask as the kernel reads it: a uint8 view of a bool [b|1, hq|1,
    sq, skv] (no copy of a broadcast view; a dimension of size 1 gets stride
    0, which the kernel never steps)."""
    b, hq, sq, _ = q.shape
    if mask.dim() != 4 or mask.shape[0] not in (1, b) \
            or mask.shape[1] not in (1, hq) \
            or tuple(mask.shape[2:]) != (sq, k.shape[2]):
        raise ValueError(f"mask {tuple(mask.shape)}: want [b|1, h|1, {sq}, "
                         f"{k.shape[2]}]")
    if mask.device != q.device:
        raise ValueError(f"mask on {mask.device}, q on {q.device}")
    if mask.dtype != torch.bool:
        mask = mask != 0
    return mask.view(torch.uint8)


def _mask_strides(mask):
    return [0 if n == 1 else s for n, s in zip(mask.shape, mask.stride())]


def _bias_f32(bias, q, k):
    """The bias as the kernels read it: fp32 [b|1, hq|1, sq, skv] by its
    strides (a broadcast sq or skv dim as a zero-stride view, no copy of an
    fp32 one)."""
    b, hq, sq, _ = q.shape
    skv = k.shape[2]
    if bias.dim() != 4 or bias.shape[0] not in (1, b) \
            or bias.shape[1] not in (1, hq) or bias.shape[2] not in (1, sq) \
            or bias.shape[3] not in (1, skv):
        raise ValueError(f"bias {tuple(bias.shape)}: want [b|1, h|1, {sq}, "
                         f"{skv}]")
    if bias.device != q.device:
        raise ValueError(f"bias on {bias.device}, q on {q.device}")
    return bias.float().expand(bias.shape[0], bias.shape[1], sq, skv)


def _launch(name, tensors, strided, segs, dims, scale, window, softcap,
            mask=None, bias=None):
    """Calls ``name`` in the library: the data pointers of ``tensors`` (None
    for null), 24 strides ((b, h, s) of ``strided``, q, k, v[, do], then
    (b, s) of the segment ids ``segs``, zeros without them, then (b, h, q, k)
    of ``mask`` and of ``bias``, zeros without one), the 9 ints
    ``dims``, the window (0 for none; one past any row is cut to 2**30, where
    it cuts nothing either way), the scale, the softcap (0 for none) and the
    current stream; raises if a launch returned a CUDA error."""
    from np_modeling_tpu_torch.ops import cuda_build
    fn = getattr(cuda_build.load("flash_attention").lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (len(tensors) + 1)
                   + [ctypes.c_int] * 10 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    strides = [s for t in strided for s in t.stride()[:3]]
    strides += [0] * (12 - len(strides))
    strides += ([s for t in segs for s in t.stride()] if segs[0] is not None
                else [0] * 4)
    for x in (mask, bias):
        strides += _mask_strides(x) if x is not None else [0] * 4
    q = strided[0]
    with torch.cuda.device(q.device):
        rc = fn(*[_ptr(t) for t in tensors],
                (ctypes.c_longlong * 24)(*strides), *dims,
                0 if window is None else min(int(window), 1 << 30), scale,
                0.0 if softcap is None else softcap,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash-attention kernel {name} failed to launch: "
                           f"CUDA error {rc}")


def _flash_fwd_cuda(q, k, v, causal, scale, need_lse, q_seg=None,
                    kv_seg=None, dual=False, window=None, softcap=None,
                    mask=None, bias=None):
    """K1 (or K12 with ``dual``): o [b, hq, sq, d] (a view) and lse. With
    ``mask`` K1 reads it (segment ids merged into it here), with ``bias``
    adds it to the scores."""
    _check_kernel_inputs(q, k, v, q_seg, kv_seg)
    _check_d192(q.shape[-1], window, softcap, mask, bias)
    if (mask is not None or bias is not None) and dual:
        raise ValueError("K12 takes no mask or bias (JAX :856-858)")
    if bias is not None:
        # The bias's instantiations (csrc/flash_attention.cu,
        # with_bias_opt): alone, with segment ids, with K1's mask, and with
        # the softcap alone at head_dim 64; no window.
        why = ("a bias with a window" if window is not None
               else None if softcap is None
               else "a bias with a softcap and a mask or segment ids"
               if mask is not None or q_seg is not None
               else None if q.shape[-1] == 64
               else f"a bias with a softcap at head_dim {q.shape[-1]}")
        if why is not None:
            raise NotImplementedError(f"the flash kernels are not built for "
                                      f"{why} (ROADMAP.md Queue 2 A)")
        bias = _bias_f32(bias, q, k)
    if mask is not None:
        mask = _mask_u8(_merge_seg_into_mask(mask, q_seg, kv_seg), q, k)
        q_seg = kv_seg = None
    q, k, v = (_kernel_layout(x) for x in (q, k, v))
    q_seg, kv_seg = _seg_int32(q_seg), _seg_int32(kv_seg)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    _launch("np_flash_attention_fwd",
            (q, k, v, o, lse, q_seg, kv_seg, mask, bias), (q, k, v),
            (q_seg, kv_seg), (_DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv, d,
                              int(causal), int(dual)),
            scale, window, softcap, mask, bias)
    if dual:
        flash_attention.launches_fwd_dual += 1
    else:
        flash_attention.launches_fwd += 1
    if window is not None:
        flash_attention.launches_fwd_window += 1
    if mask is not None:
        flash_attention.launches_fwd_mask += 1
        if q.dtype == torch.float32:
            flash_attention.launches_fwd_mask_fp32 += 1
    if bias is not None:
        flash_attention.launches_fwd_bias += 1
    return o.transpose(1, 2), lse


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, q_seg=None,
                    kv_seg=None, split=False, window=None, softcap=None,
                    bias=None, need_dbias=True, mask=None):
    """K2 (or K5 with ``split``): dq, dk, dv in the JAX layouts, and with
    ``bias`` dbias [b, hq, sq, skv] fp32 (None unless ``need_dbias``), the
    gradient of the post-bias scores, not yet summed over the bias's
    broadcast dims. ``mask`` (alone, head_dim 64) is read as K1 reads it,
    segment ids merged into it here."""
    _check_kernel_inputs(q, k, v, q_seg, kv_seg)
    _check_d192(q.shape[-1], window, softcap, mask, bias)
    if mask is not None:
        why = _mask_bwd_unbuilt(q.shape[-1], window, softcap, bias)
        if why is not None:
            raise NotImplementedError(f"the flash kernels' backwards are not "
                                      f"built for {why} (ROADMAP.md Queue 2 "
                                      f"A)")
        mask = _mask_u8(_merge_seg_into_mask(mask, q_seg, kv_seg), q, k)
        q_seg = kv_seg = None
    if bias is not None:        # its combinations were checked forward
        bias = _bias_f32(bias, q, k)
    q, k, v, do = (_kernel_layout(x) for x in (q, k, v, do.to(q.dtype)))
    q_seg, kv_seg = _seg_int32(q_seg), _seg_int32(kv_seg)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    # di = rowsum(do * o) outside the kernel, as JAX does (:1214).
    di = (do.float() * o.float()).sum(dim=-1).contiguous()
    lse = lse.contiguous()
    # K2 adds dq into a zeroed fp32 buffer; K5's dq kernel writes it once.
    dq = (torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device) if split
          else torch.zeros((b, sq, hq, d), dtype=torch.float32,
                           device=q.device))
    # bf16: K2/K5 sum each GQA group's q heads in the kernel (in fp32, one
    # rounding); the fp32 kernels write dk and dv per q head.
    hkv_out = hkv if q.dtype == torch.bfloat16 else hq
    dk = torch.empty((b, skv, hkv_out, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    # Written once an element by K2 or K5's dq kernel; the pairs that causal
    # band skipping never visits keep the zeros.
    dbias = None
    if bias is not None and need_dbias:
        alloc = torch.zeros if causal else torch.empty
        dbias = alloc((b, hq, sq, skv), dtype=torch.float32, device=q.device)
    _launch("np_flash_attention_bwd",
            (q, k, v, do, lse, di, q_seg, kv_seg, mask, bias, dq, dk, dv,
             dbias),
            (q, k, v, do), (q_seg, kv_seg),
            (_DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv, d, int(causal),
             int(split)), scale, window, softcap, mask, bias)
    if split:
        flash_attention.launches_bwd_split += 1
    else:
        flash_attention.launches_bwd += 1
    if window is not None:
        flash_attention.launches_bwd_window += 1
    if mask is not None:
        flash_attention.launches_bwd_mask += 1
    if bias is not None:
        flash_attention.launches_bwd_bias += 1
    g = hkv_out // hkv
    if g > 1:   # fp32: [b, skv, hq, d] -> [b, skv, hkv, d]
        dk = dk.view(b, skv, hkv, g, d).sum(dim=3)
        dv = dv.view(b, skv, hkv, g, d).sum(dim=3)
    return dq.to(q.dtype).transpose(1, 2), dk.transpose(1, 2), \
        dv.transpose(1, 2), dbias


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, sinks, mask, q_seg, kv_seg, causal,
                window, scale, softcap):
        kernel = dispatch.use_kernel(q)
        split = not FUSED_BWD
        if kernel:
            need_lse = sinks is not None or any(ctx.needs_input_grad[:5])
            # JAX's conditions for K12 (:856-858), an even number of kv
            # tiles counted at the width of the forward kernel that runs.
            tile = _fwd_kv_tile(q.dtype, max(q.shape[-1], MIN_KERNEL_D))
            dual = (FWD_DUAL_KV and q_seg is None and softcap is None
                    and mask is None and bias is None
                    and -(-k.shape[2] // tile) % 2 == 0)
            o, lse = _fwd_padded(_flash_fwd_cuda, q, k, v, causal, scale,
                                 need_lse, q_seg, kv_seg, dual, window,
                                 softcap, mask, bias)
        else:
            o, lse = _attn_fwd_plain(
                q, k, v, _merge_seg_into_mask(mask, q_seg, kv_seg), bias,
                causal, window, scale, softcap)
        if sinks is not None:
            # o = o_std * sigmoid(lse_std - sink); the residuals carry the
            # sink-inclusive o and lse, for which the standard backward is
            # exact (the sink's value is zero).
            lse_tot = torch.logaddexp(lse, sinks.float()[None, :, None])
            o = (o.float() * torch.exp(lse - lse_tot)[..., None]).to(q.dtype)
            lse = lse_tot
        ctx.save_for_backward(q, k, v, o, lse, bias, sinks, mask, q_seg,
                              kv_seg)
        ctx.opts = (kernel, split, causal, window, scale, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias, sinks, mask, q_seg, kv_seg = ctx.saved_tensors
        kernel, split, causal, window, scale, softcap = ctx.opts
        dbias = dsinks = None
        if kernel:
            dq, dk, dv, dbias = _bwd_padded(
                _flash_bwd_cuda, q, k, v, o, lse, do, causal, scale, q_seg,
                kv_seg, split, window, softcap, bias,
                need_dbias=ctx.needs_input_grad[3], mask=mask)
            if dbias is not None:
                dbias = _unbroadcast_bias(dbias, bias)
        else:
            dq, dk, dv, dbias = _attn_bwd_plain(
                q, k, v, o, lse, do, _merge_seg_into_mask(mask, q_seg, kv_seg),
                bias, causal, window, scale, softcap)
        if sinks is not None:
            di = (do.float() * o.float()).sum(dim=-1)
            p_sink = torch.exp(sinks.float()[None, :, None] - lse)
            dsinks = (-(p_sink * di).sum(dim=(0, 2))).to(sinks.dtype)
        return (dq, dk, dv, dbias, dsinks) + (None,) * 7


def flash_attention(q, k, v, mask=None, bias=None, segment_ids=None, *,
                    causal=False, window=None, scale=None, block_q=None,
                    block_kv=None, softcap=None, sinks=None):
    """Scaled dot-product attention with a hand-written backward.

    ``mask``: boolean [b|1, h|1, sq, skv], True = attend. ``bias``: additive
    score bias [b|1, h|1, sq, skv], differentiable. ``segment_ids``:
    (q_seg [b, sq], kv_seg [b, skv]) integer ids, or one [b, s] array for
    self-attention; positions attend only within their segment. ``window``:
    sliding window W (causal only): position i attends to [i-W+1, i].
    ``softcap``: ``cap * tanh(s / cap)`` on the scaled scores before bias and
    mask. ``sinks``: per-q-head sink logits [hq], a virtual no-value key in
    each row's softmax; differentiable.
    """
    del block_q, block_kv
    d = q.shape[-1]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    if q.shape[1] % k.shape[1]:
        raise ValueError("q heads must be a multiple of kv heads")
    if k.shape[:3] != v.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    for name, x in (("mask", mask), ("bias", bias)):
        if x is not None and (x.dim() != 4 or x.shape[0] not in (1, q.shape[0])
                              or x.shape[1] not in (1, q.shape[1])):
            raise ValueError(f"{name} must be [b|1, h|1, sq, skv]")
    if window is not None and not (causal and window >= 1):
        raise ValueError("window requires causal=True and a positive width")
    if softcap is not None:
        softcap = float(softcap)
        if softcap <= 0:
            raise ValueError("softcap must be a positive cap value")
    if segment_ids is not None and not isinstance(segment_ids, (tuple, list)):
        segment_ids = (segment_ids, segment_ids)
    q_seg, kv_seg = segment_ids if segment_ids is not None else (None, None)
    if sinks is not None and tuple(sinks.shape) != (q.shape[1],):
        raise ValueError(f"sinks must be [hq], got {tuple(sinks.shape)}")
    if dispatch.use_kernel(q) and mask is not None \
            and torch.is_grad_enabled() and any(
                x.requires_grad for x in (q, k, v, bias) if x is not None):
        # The backwards take the mask alone at head_dim 64 (and below, on
        # the padded copies).
        why = _mask_bwd_unbuilt(max(d, MIN_KERNEL_D), window, softcap, bias)
        if why is not None:
            raise NotImplementedError(
                f"the CUDA flash-attention backwards are not built for {why} "
                "(ROADMAP.md Queue 2 A)")
    return _FlashAttention.apply(q, k, v, bias, sinks, mask, q_seg, kv_seg,
                                 causal, window, scale, softcap)


# Kernel launches since import (or since a caller reset them to 0): a run
# shows with them that its attention went through K1 (launches_fwd), K12
# (launches_fwd_dual), K2 (launches_bwd) or K5 (launches_bwd_split, one a
# pair of its kernels); of those, the ones with a window count again in
# launches_fwd_window (K1, K12) and launches_bwd_window (K2, K5), K1's
# with a mask in launches_fwd_mask (those of the fp32 forward again in
# launches_fwd_mask_fp32), K2's and K5's (pairs) with a mask in
# launches_bwd_mask, K1's with a bias in launches_fwd_bias and K2's and
# K5's (pairs) with a bias in launches_bwd_bias.
flash_attention.launches_fwd = 0
flash_attention.launches_fwd_dual = 0
flash_attention.launches_bwd = 0
flash_attention.launches_bwd_split = 0
flash_attention.launches_fwd_window = 0
flash_attention.launches_fwd_mask = 0
flash_attention.launches_fwd_mask_fp32 = 0
flash_attention.launches_bwd_window = 0
flash_attention.launches_bwd_mask = 0
flash_attention.launches_fwd_bias = 0
flash_attention.launches_bwd_bias = 0
