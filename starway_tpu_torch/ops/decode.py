"""Cached decode attention: the hand-written CUDA kernel
(csrc/decode_attention.cu) and its plain PyTorch version.

A thread block attends the ``n_rep`` grouped query heads of C consecutive
positions of one (batch row, kv head) against a share of the narrow
cache's live tiles, reading each once; a second kernel merges the shares
(split over T).  See the kernel source for what bounds it.
:func:`decode_attention` launches the kernel for CUDA tensors and takes
:func:`decode_attention_reference` only for CPU tensors.

Layouts follow models/generate.py: ``q [B, Hq, C, D]``, caches
``[B, Hkv, T, D]``, int8 scales ``[B, Hkv, T]`` float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import NEG_BIG

HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's compiled head sizes
TILE = 32  # keys per kernel tile (kBK in the source)


def _check_args(q, k_cache, v_cache, k_scale, v_scale, window):
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    quant = k_scale is not None or v_scale is not None
    if quant and (k_scale is None or v_scale is None):
        raise ValueError("int8 caches need BOTH k_scale and v_scale")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if quant != (c.dtype == torch.int8):
            raise ValueError(
                f"{name} dtype {c.dtype} inconsistent with "
                f"{'present' if quant else 'absent'} scales (int8 caches "
                f"carry per-token scales; see ops/quantize.py)")
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"want q [B,Hq,C,D] and caches [B,Hkv,T,D], got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, hq, _, d = q.shape
    if (k_cache.shape[0] != b or k_cache.shape[3] != d
            or hq % k_cache.shape[1]):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if quant:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.shape != k_cache.shape[:3] or s.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 "
                                 f"{tuple(k_cache.shape[:3])}, got "
                                 f"{s.dtype} {tuple(s.shape)}")
    return quant


def _pos_rows(pos, b: int, device) -> torch.Tensor:
    """``pos`` (int, 0-d or [B]) as an int32 [B] tensor on ``device``."""
    p = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    if p.numel() not in (1, b):
        raise ValueError(f"pos must be a scalar or [{b}], got {p.shape}")
    return p.expand(b).contiguous()


def decode_attention_reference(q, k_cache, v_cache, pos, *,
                               sm_scale: Optional[float] = None,
                               window: Optional[int] = None,
                               k_scale=None, v_scale=None):
    """The kernel's function in plain PyTorch, on any device.

    Query heads are grouped by kv head as rows ``r = rep * C + ci`` (row r
    sits at position ``pos[b] + r % C``); scores and the softmax are
    float32; ``k_scale`` multiplies the score columns with ``sm_scale``,
    ``v_scale`` multiplies p after ``l`` is summed, and p is rounded to the
    query dtype before ``p @ v``."""
    _check_args(q, k_cache, v_cache, k_scale, v_scale, window)
    b, hq, n_q, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    rows = (hq // hkv) * n_q
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    dev = q.device
    qg = q.reshape(b, hkv, rows, d).float()
    s = torch.matmul(qg, k_cache.to(q.dtype).float().transpose(-1, -2))
    if k_scale is not None:
        s = s * (k_scale[:, :, None, :] * sm_scale)
    else:
        s = s * sm_scale
    p_rows = _pos_rows(pos, b, dev).long()
    q_pos = (p_rows[:, None, None, None]
             + (torch.arange(rows, device=dev) % n_q)[None, None, :, None])
    kv_pos = torch.arange(t, device=dev)[None, None, None, :]
    keep = kv_pos <= q_pos
    if window is not None:
        keep = keep & (kv_pos > q_pos - window)
    s = torch.where(keep, s, torch.full_like(s, NEG_BIG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_BIG / 2, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    acc = torch.matmul(p.to(q.dtype).float(), v_cache.to(q.dtype).float())
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.reshape(b, hq, n_q, d)


def decode_attention(q, k_cache, v_cache, pos, *,
                     sm_scale: Optional[float] = None,
                     window: Optional[int] = None,
                     stream: Optional[bool] = None, k_scale=None,
                     v_scale=None):
    """Cached decode attention (C >= 1 query positions per row) without
    expanding the grouped cache.  Returns ``[B, Hq, C, D]`` in q's dtype.

    ``pos``: an int or a per-row ``[B]`` tensor; row b's queries sit at
    ``pos[b] .. pos[b] + C - 1`` and mask the keys above themselves, so
    write-then-attend callers must have written the C entries already.
    ``window``: attend only the last ``window`` positions; tiles below the
    window are not read.  ``k_scale``/``v_scale`` ([B, Hkv, T] float32):
    int8 caches (ops/quantize.py).  ``stream`` chose between two grid
    schedules of the TPU kernel; one CUDA kernel serves both values.

    CUDA tensors launch the kernel (csrc/decode_attention.cu), CPU tensors
    take :func:`decode_attention_reference`.
    """
    if stream not in (None, True, False):
        raise ValueError(f"stream must be a bool or None, got {stream!r}")
    quant = _check_args(q, k_cache, v_cache, k_scale, v_scale, window)
    if not q.is_cuda:
        return decode_attention_reference(
            q, k_cache, v_cache, pos, sm_scale=sm_scale, window=window,
            k_scale=k_scale, v_scale=v_scale)
    b, hq, n_q, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    rows = (hq // hkv) * n_q
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bfloat16 or float32, got {q.dtype}")
    if not quant and k_cache.dtype != q.dtype:
        raise ValueError(f"cache dtype {k_cache.dtype} != q dtype {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not compiled; the kernel takes "
                         f"{HEAD_DIMS}")
    tensors = [q, k_cache, v_cache] + ([k_scale, v_scale] if quant else [])
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"tensor on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError("decode_attention needs contiguous tensors")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention reads the caches with 16-byte "
                         "loads; they must be 16-byte aligned")
    pos_arr = _pos_rows(pos, b, q.device)
    lib = _build.library()
    smem = lib.sw_decode_attention_smem(rows, d)
    props = torch.cuda.get_device_properties(q.device)
    if smem > props.shared_memory_per_block_optin:
        raise ValueError(f"{rows} query rows of head_dim {d} need {smem} "
                         f"bytes of shared memory; the card allows "
                         f"{props.shared_memory_per_block_optin}")
    # Split the live tiles of each (row, kv head) over enough blocks to
    # give every SM a few.
    n_split = max(1, min(-(-4 * props.multi_processor_count // (b * hkv)),
                         -(-t // TILE)))
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    o_part = torch.empty((b * hkv, n_split, rows, d), **f32)
    m_part = torch.empty((b * hkv, n_split, rows), **f32)
    l_part = torch.empty((b * hkv, n_split, rows), **f32)
    err = lib.sw_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        pos_arr.data_ptr(), out.data_ptr(), o_part.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), b, hkv, n_split, rows, n_q, t,
        d, 0 if window is None else int(window),
        int(q.dtype == torch.bfloat16), float(sm_scale), int(quant),
        _build.stream_ptr(q))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
