"""Paged attention for decode and chunked append (serving path).

Counterpart of np_modeling_tpu/ops/paged_attention.py. On CUDA tensors
``paged_attention`` launches the hand-written Hopper kernel in
``csrc/paged_attention.cu``; on CPU tensors (or under
``dispatch.force_plain()``) it runs ``paged_attention_reference``, the port
of the JAX oracle.

Shapes (the JAX layout):
  q            [batch, num_q_heads, head_dim]        (one decode token)
               or [batch, sq, num_q_heads, head_dim] (chunked append)
  k/v_pages    [num_kv_heads, total_pages, page_size, head_dim]
  lengths      [batch] int32 (tokens in cache INCLUDING the sq query tokens:
               query token t sits at position lengths - sq + t and attends
               to positions <= its own)
  page_indices [batch, pages_per_seq] int32
  k/v_scales   [num_kv_heads, total_pages, page_size, 1] fp32 per-token
               scales, given with int8 pages and only with them: each page
               row is dequantized as int8 * scale in fp32
  bias         [batch, num_q_heads, bias_len] (one row for every query
               token) or [batch, num_q_heads, sq, bias_len], an additive
               score bias over ABSOLUTE cache positions (T5's relative
               positions in the encoder-decoder serving engine), added after
               the scale and the softcap and before the mask; positions past
               bias_len get none, columns past the table's width are
               ignored. The kernel reads an fp32 bias by its strides (a
               size-1 axis broadcasts): no copy is made, so hand it a view
               with unit stride along positions.
  sinks        [num_q_heads] fp32 (gpt-oss's attention sinks): a logit a q
               head that joins each row's softmax as a key with no value,
               once a row (in the merge when the keys are split). The
               kernel takes it at head_dim 64, alone or with a window.
Returns [batch, num_q_heads, head_dim] or [batch, sq, num_q_heads, head_dim]
in q's dtype.

A sequence with length 0 differs between the two versions, as it does in
the JAX package: the kernel stores 0, the plain version returns the mean of
v over the table's positions (its mask value is finite). With sinks both
give 0 (the sink outweighs every masked key).

The latent option (MLA's absorbed serving form, JAX serving/engine.py
:1739-1817): at head_dim 576 the kernel takes one page array as both k and
v (``paged_attention(q, P, P, ...)``, and with int8 pages one scale set as
both scales), and reads each latent row once for q.k and p.v; it returns
the full 576 columns. Distinct k and v arrays at 576 raise ValueError, a
window, softcap or bias there NotImplementedError. The plain version is
``paged_attention_reference`` with the same array as k and v.
"""

from __future__ import annotations

import ctypes
import math

import torch

from np_modeling_tpu_torch.ops import dispatch

# np_modeling_tpu/ops/attention.py DEFAULT_MASK_VALUE.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {**_DTYPE_CODES, torch.int8: 2}


def _normalize_bias(bias, b, hq, sq):
    """[b, hq, kv_len] (broadcast over query tokens) or [b, hq, sq, kv_len]
    -> fp32 [b, hq, sq, kv_len]."""
    if bias is None:
        return None
    if bias.dim() == 3:
        bias = bias[:, :, None]
    return bias.float().expand(b, hq, sq, bias.shape[-1])


def paged_attention_reference(q, k_pages, v_pages, lengths, page_indices,
                              scale=None, window=None, bias=None,
                              softcap=None, sinks=None):
    """Plain PyTorch version: gather each sequence's pages, masked softmax.

    ``window``: query at position p sees [p-W+1, p]. ``bias``: additive score
    bias over absolute cache positions. ``softcap``: cap*tanh(s/cap) on the
    scaled scores. ``sinks``: per-q-head logit of a virtual no-value key."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, sq, hq, d = q.shape
    hkv, _, psize, _ = k_pages.shape
    g = hq // hkv
    max_len = page_indices.shape[1] * psize

    idx = page_indices.long()
    k_seq = k_pages[:, idx].movedim(1, 0).reshape(b, hkv, max_len, d)
    v_seq = v_pages[:, idx].movedim(1, 0).reshape(b, hkv, max_len, d)

    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, g, d).movedim(1, 2)          # [b,hkv,sq,g,d]
    s = torch.einsum("bhtgd,bhkd->bhtgk", qg.float(), k_seq.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    bias = _normalize_bias(bias, b, hq, sq)
    if bias is not None:
        kv = min(max_len, bias.shape[-1])
        bg = bias.reshape(b, hkv, g, sq, -1).movedim(2, 3)  # [b,hkv,sq,g,kv]
        s[..., :kv] += bg[..., :kv]
    pos = torch.arange(max_len, device=q.device)
    own = (lengths.long()[:, None, None, None, None] - sq
           + torch.arange(sq, device=q.device)[None, None, :, None, None])
    keep = pos <= own
    if window is not None:
        keep = keep & (pos > own - window)
    s = torch.where(keep, s, DEFAULT_MASK_VALUE)
    if sinks is not None:
        sk = sinks.float().reshape(hkv, g)[None, :, None, :, None]
        comb = torch.cat([s, sk.expand(*s.shape[:-1], 1)], dim=-1)
        p = torch.softmax(comb, dim=-1)[..., :-1]
    else:
        p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhtgk,bhkd->bhtgd", p, v_seq.float())
    o = o.movedim(2, 1).reshape(b, sq, hq, d).to(q.dtype)
    return o[:, 0] if squeeze else o


def paged_attention_split_reference(q, k_pages, v_pages, lengths,
                                    page_indices, splits, split_keys,
                                    scale=None, window=None, softcap=None,
                                    sinks=None):
    """Plain PyTorch version of the kernel's split-KV schedule: key range
    [i * split_keys, (i + 1) * split_keys) of each sequence gives a partial
    (m, l, acc) over the positions a row sees in it (l = 0 where it sees
    none: a range past the length or below the window), and the partials
    merge as m = max m_i, o = sum e^(m_i - m) acc_i / sum e^(m_i - m) l_i.
    ``sinks`` join once, after the merge: m' = max(m, sink), l' = l e^(m -
    m') + e^(sink - m'), o = acc e^(m - m') / l' (0 where no position is
    seen). Equals ``paged_attention_reference`` wherever a row sees a
    position."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, sq, hq, d = q.shape
    hkv, _, psize, _ = k_pages.shape
    g = hq // hkv
    max_len = page_indices.shape[1] * psize
    idx = page_indices.long()
    k_seq = k_pages[:, idx].movedim(1, 0).reshape(b, hkv, max_len, d).float()
    v_seq = v_pages[:, idx].movedim(1, 0).reshape(b, hkv, max_len, d).float()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, g, d).movedim(1, 2).float()   # [b,hkv,sq,g,d]
    s = torch.einsum("bhtgd,bhkd->bhtgk", qg, k_seq) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(max_len, device=q.device)
    own = (lengths.long()[:, None, None, None, None] - sq
           + torch.arange(sq, device=q.device)[None, None, :, None, None])
    keep = pos <= own
    if window is not None:
        keep = keep & (pos > own - window)
    m_all, l_all, acc_all = [], [], []
    for i in range(splits):
        lo, hi = i * split_keys, min((i + 1) * split_keys, max_len)
        seen = keep[..., lo:hi]
        x = torch.where(seen, s[..., lo:hi], -math.inf)
        m = x.amax(dim=-1).clamp(min=DEFAULT_MASK_VALUE)
        p = torch.where(seen, torch.exp(x - m[..., None]), 0.0)
        m_all.append(m)
        l_all.append(p.sum(dim=-1))
        acc_all.append(torch.einsum("bhtgk,bhkd->bhtgd", p, v_seq[:, :, lo:hi]))
    m, l, acc = torch.stack(m_all), torch.stack(l_all), torch.stack(acc_all)
    live = l > 0
    mx = torch.where(live, m, DEFAULT_MASK_VALUE).amax(dim=0)
    w = torch.where(live, torch.exp(m - mx), 0.0)
    lsum = (w * l).sum(dim=0)
    acc = (w[..., None] * acc).sum(dim=0)
    if sinks is not None:
        sk = sinks.float().reshape(hkv, g)[None, :, None, :]  # [1,hkv,1,g]
        mn = torch.maximum(mx, sk)
        c = torch.exp(mx - mn)
        lsum = lsum * c + torch.exp(sk - mn)
        acc = acc * c[..., None]
    o = acc / torch.where(lsum > 0, lsum, 1.0)[..., None]
    o = o.movedim(2, 1).reshape(b, sq, hq, d).to(q.dtype)
    return o[:, 0] if squeeze else o


def paged_attention(q, k_pages, v_pages, lengths, page_indices, scale=None,
                    k_scales=None, v_scales=None, window=None, bias=None,
                    softcap=None, sinks=None):
    """Paged-KV attention: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. Int8 pages come with their scales, and scales
    only with int8 pages. ``window`` (a positive width), ``softcap`` (a
    positive cap) and ``bias`` (fp32, 3-D or 4-D, any width) run in both.
    The kernel takes fp32 or bf16 q, fp32, bf16 or int8 pages, head_dim 64,
    128 or 256 (a narrower one runs on q and pages zero-padded to 64, with
    the scale of the true head_dim; pages may come padded already, as the
    serving engine stores them), or 576 with one page array as k and v (the
    latent option),
    any GQA group, any sq >= 1, page sizes 8..128 (powers of two), and
    ``sinks`` (fp32 [hq]) at head_dim 64 alone or with a window; it raises
    on sinks at another head dim or with a softcap or a bias, and on a bias
    with a window or a softcap."""
    int8_pages = k_pages.dtype == torch.int8 or v_pages.dtype == torch.int8
    scaled = k_scales is not None or v_scales is not None
    if int8_pages != scaled or (scaled and (k_scales is None
                                            or v_scales is None)):
        raise ValueError("int8 pages need both k_scales and v_scales, and "
                         "scales need int8 pages")
    if window is not None and not (int(window) == window and window >= 1):
        raise ValueError(f"window {window}: want a positive integer width")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap {softcap}: want a positive cap")
    d = q.shape[-1]
    if k_pages.shape[-1] != d and not (
            d < MIN_KERNEL_D and k_pages.shape[-1] == MIN_KERNEL_D):
        raise ValueError(f"q's head_dim {d}, pages' {k_pages.shape[-1]}: "
                         "want equal, or pages zero-padded to "
                         f"{MIN_KERNEL_D} under a narrower q")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if not dispatch.use_kernel(q):
        if scaled:
            k_pages = k_pages.float() * k_scales
            v_pages = v_pages.float() * v_scales
        # Padded pages: their zero columns add nothing to a score or to o.
        return paged_attention_reference(q, k_pages[..., :d],
                                         v_pages[..., :d], lengths,
                                         page_indices, scale, window, bias,
                                         softcap, sinks)
    if sinks is not None and (q.shape[-1] != 64 or softcap is not None
                              or bias is not None):
        raise NotImplementedError(
            "the CUDA paged-attention kernel takes sinks at head_dim 64, "
            "alone or with a window: sinks at head_dim "
            f"{q.shape[-1]}, with a softcap or with a bias are not built yet "
            "(ROADMAP.md Queue 2 A, K3)")
    if bias is not None and (window is not None or softcap is not None):
        raise NotImplementedError(
            "the CUDA paged-attention kernel takes the bias alone: a bias "
            "with a window or a softcap is not built yet (ROADMAP.md Queue 2 "
            "A, K3)")
    if d >= MIN_KERNEL_D:
        return _launch(q, k_pages, v_pages, k_scales, v_scales, lengths,
                       page_indices, scale, window, softcap, bias, sinks)
    # A head_dim under 64 (JAX pads to a multiple of 128, :391-399): q, and
    # pages not already padded, zero-padded to 64 for this call. A zero
    # column changes no score, nor an int8 page's absmax scale; the scale
    # stays the caller's and o is cut back.
    pad = [torch.nn.functional.pad(x, (0, MIN_KERNEL_D - x.shape[-1]))
           if x.shape[-1] < MIN_KERNEL_D else x
           for x in (q, k_pages, v_pages)]
    out = _launch(*pad, k_scales, v_scales, lengths, page_indices, scale,
                  window, softcap, bias, sinks)
    paged_attention.launches_padded += 1
    return out[..., :d]


# The kernel's narrowest head_dim: a narrower q runs zero-padded to it.
MIN_KERNEL_D = 64

# Kernel launches since import (or since a caller reset it to 0): a run
# shows with it that its attention went through the kernel. launches counts
# every call (its split pass and, with more than one split, its merge are one
# launch), launches_int8 those over int8 pages, launches_window those with a
# sliding window, launches_bias those with a score bias, launches_latent
# those of the latent option (head_dim 576, one array as k and v),
# launches_sinks those with attention sinks, launches_split those whose grid
# had more than one split, launches_padded those of a head_dim under 64 run
# at 64.
paged_attention.launches = 0
paged_attention.launches_int8 = 0
paged_attention.launches_window = 0
paged_attention.launches_bias = 0
paged_attention.launches_latent = 0
paged_attention.launches_sinks = 0
paged_attention.launches_split = 0
paged_attention.launches_padded = 0

# The split plan (flash-decoding). The kernel's row tiles: up to 2 rows (a
# decode's g rows), else 64 (32 at head_dim 256). A grid of fewer than
# FULL_GRID_PER_SM blocks a streaming multiprocessor is split along the keys,
# each range at least MIN_SPLIT_KEYS keys and a multiple of 32 and of the
# page size, into at most MAX_BLOCKS_PER_SM blocks an SM (a cap on the
# partials' scratch at very wide tables; no measured shape reaches it).
# exp_torch_k3_splits.py times the kernel at 64..512 keys a range (H100
# 80GB HBM3, 700 W): 256 was chosen for Gemma-2's global decode layer and for
# 8 x 4096 tokens (512 was faster there, but 2.77x slower than 256 at 8 x
# 1024); GPT-2's decode is ~3% slower with 256 than with 128.
FULL_GRID_PER_SM, MAX_BLOCKS_PER_SM, MIN_SPLIT_KEYS = 2, 16, 256
# The latent option (head_dim LATENT_DIM): row tiles of 16 rows (a decode
# token's 16 heads) or 32; a key costs 576-wide q.k and p.v for every row,
# so its ranges start at LATENT_MIN_SPLIT_KEYS keys: a table of 2048
# positions gives MLA's 8 decode sequences 16 ranges each, ~132 blocks.
LATENT_DIM, LATENT_MIN_SPLIT_KEYS = 576, 128


def split_plan(batch, num_kv_heads, rows, head_dim, pages_per_seq,
               page_size, sms):
    """(splits, keys a split) of a call from its shapes alone: ``rows`` q
    rows a kv head (sq x the GQA group), the table's width pages_per_seq x
    page_size, on a card of ``sms`` streaming multiprocessors. Never reads
    lengths (they lie on the card)."""
    if head_dim == LATENT_DIM:
        tile, min_keys = (16 if rows <= 16 else 32), LATENT_MIN_SPLIT_KEYS
    else:
        tile = 2 if rows <= 2 else (32 if head_dim > 128 else 64)
        min_keys = MIN_SPLIT_KEYS
    width = pages_per_seq * page_size
    blocks = -(-rows // tile) * num_kv_heads * batch
    splits = min(width // min_keys,
                 -(-MAX_BLOCKS_PER_SM * sms // blocks))
    if blocks >= FULL_GRID_PER_SM * sms or splits <= 1:
        return 1, max(width, 1)
    align = max(32, page_size)
    keys = -(-width // splits)
    keys = -(-keys // align) * align
    return -(-width // keys), keys


def _bias_strides(bias, b, hq, sq):
    """(strides over (b, q head, query token, position), width) of a 3-D
    [b, hq, L] or 4-D [b, hq, sq, L] fp32 bias, 0 on a broadcast axis (size
    1, and the query axis of a 3-D bias); raises on what the kernel cannot
    read."""
    if bias.dim() not in (3, 4) or bias.dtype != torch.float32:
        raise ValueError(f"bias {bias.dtype} {tuple(bias.shape)}: want fp32 "
                         f"[{b}, {hq}, L] or [{b}, {hq}, {sq}, L]")
    shape, strides = list(bias.shape), list(bias.stride())
    if bias.dim() == 3:
        shape.insert(2, 1)
        strides.insert(2, 0)
    for n, want in zip(shape[:3], (b, hq, sq)):
        if n not in (1, want):
            raise ValueError(f"bias {tuple(bias.shape)} does not broadcast "
                             f"over [{b}, {hq}, {sq}, L]")
    return [0 if n == 1 else st for n, st in zip(shape[:3], strides[:3])] + [
        strides[3]], shape[3]


def _launch(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices,
            scale, window, softcap, bias, sinks):
    q4 = q[:, None] if q.dim() == 3 else q
    if q4.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} / pages {tuple(k_pages.shape)}:"
                         " want q [b,(sq,)hq,d], pages [hkv,P,ps,d]")
    b, sq, hq, d = q4.shape
    hkv, total_pages, psize, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages differ in shape or dtype")
    latent = d == LATENT_DIM
    if dk != d or d not in (64, 128, 256, LATENT_DIM):
        raise ValueError(f"head_dim {d} (pages {dk}): the kernel takes 64, "
                         f"128, 256, or {LATENT_DIM} with one page array as "
                         "k and v")
    if latent and (v_pages.data_ptr() != k_pages.data_ptr() or (
            k_scales is not None
            and v_scales.data_ptr() != k_scales.data_ptr())):
        raise ValueError(f"head_dim {LATENT_DIM} is the latent option (MLA): "
                         "it takes one page array as both k and v, and one "
                         "scale set as both scales")
    if latent and (window is not None or softcap is not None
                   or bias is not None):
        raise NotImplementedError(
            "the paged kernel's latent option takes no window, softcap or "
            "bias (no MLA caller passes them; ROADMAP.md Queue 2 A, K3)")
    if hq % hkv:
        raise ValueError(f"{hq} q heads do not group over {hkv} kv heads")
    if psize < 8 or psize > 128 or psize & (psize - 1):
        raise ValueError(f"page_size {psize}: want a power of two in 8..128")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype not in _KV_CODES:
        raise ValueError(f"dtypes q {q.dtype} / pages {k_pages.dtype}: want "
                         "float32 or bfloat16 q, float32, bfloat16 or int8 "
                         "pages")
    scales = () if k_scales is None else (k_scales, v_scales)
    for s in scales:
        if s.dtype != torch.float32 or s.shape != (hkv, total_pages, psize,
                                                   1):
            raise ValueError(f"scales {s.dtype} {tuple(s.shape)}: want fp32 "
                             f"[{hkv}, {total_pages}, {psize}, 1]")
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise ValueError("lengths and page_indices must be int32")
    if lengths.shape != (b,) or page_indices.dim() != 2 \
            or page_indices.shape[0] != b:
        raise ValueError(f"lengths {tuple(lengths.shape)} / page_indices "
                         f"{tuple(page_indices.shape)} do not match batch {b}")
    tensors = (q, k_pages, v_pages, lengths, page_indices, *scales)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged attention takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q and pages must be 16-byte aligned")
    bias_strides, bias_len = [0, 0, 0, 0], 0
    if bias is not None:
        if bias.device != q.device:
            raise ValueError("the bias must lie on q's CUDA device")
        bias_strides, bias_len = _bias_strides(bias, b, hq, sq)
    if sinks is not None:
        if sinks.shape != (hq,) or sinks.device != q.device:
            raise ValueError(f"sinks {tuple(sinks.shape)} on {sinks.device}: "
                             f"want [{hq}] on q's CUDA device")
        sinks = sinks.float().contiguous()

    from np_modeling_tpu_torch.ops import cuda_build
    fn = cuda_build.load("paged_attention").lib.np_paged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p] + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    out = torch.empty_like(q)
    rows, pps = sq * (hq // hkv), page_indices.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, split_keys = split_plan(b, hkv, rows, d, pps, psize, sms)
    part_acc = part_ml = None
    if splits > 1:   # the partials (m, l, acc) of each split, fp32
        part_acc = torch.empty((b, hkv, splits, rows, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, hkv, splits, rows, 2), dtype=torch.float32,
                              device=q.device)
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    scale_ptrs = [s.data_ptr() for s in scales] or [None, None]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                *scale_ptrs, lengths.data_ptr(), page_indices.data_ptr(),
                out.data_ptr(),
                None if part_acc is None else part_acc.data_ptr(),
                None if part_ml is None else part_ml.data_ptr(),
                _DTYPE_CODES[q.dtype], _KV_CODES[k_pages.dtype], b, sq, hq,
                hkv, d, total_pages, psize.bit_length() - 1, pps, splits,
                split_keys, scale, 0 if window is None else int(window),
                0.0 if softcap is None else float(softcap),
                None if bias is None else bias.data_ptr(), *bias_strides,
                bias_len, None if sinks is None else sinks.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"paged-attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    if splits > 1:
        paged_attention.launches_split += 1
    if scales:
        paged_attention.launches_int8 += 1
    if window is not None:
        paged_attention.launches_window += 1
    if bias is not None:
        paged_attention.launches_bias += 1
    if latent:
        paged_attention.launches_latent += 1
    if sinks is not None:
        paged_attention.launches_sinks += 1
    return out
