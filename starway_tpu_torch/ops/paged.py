"""Decode attention over a paged KV pool: the hand-written CUDA kernel
(csrc/paged_attention.cu) and its plain PyTorch version.

The pool ``k/v [n_pages, Hkv, page, D]`` is shared by every slot; a block
table ``[B, max_pages]`` int32 names the pages of each slot: page i of
slot b holds positions ``i * page .. (i + 1) * page - 1`` and is
``pool[table[b, i]]``.  Entries past a slot's cursor may be anything and
are never read.  The kernel runs the dense decode kernel's tile loop
(csrc/decode_tiles.cuh) with each key row's address looked up through the
table, so the live pages are read once, narrow, and no dense view is
built: bf16 on the tensor cores in one launch a call (the regime and the
split of :func:`~starway_tpu_torch.ops.decode.decode_plan`), float32 on
the FMA loop.  :func:`paged_decode_attention` launches them for CUDA
tensors and takes :func:`paged_decode_attention_reference` only for CPU
tensors.

int8 pools are refused, as the JAX package refuses them.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .decode import (HEAD_DIMS, _pos_rows, decode_attention_reference,
                     launch_plan, pos_arg)


def gather_logical(pool, table):
    """Dense view of each slot's logical cache: pool ``[n_pages, Hkv,
    page, D]`` and table ``[B, max_pages]`` -> ``[B, Hkv, max_pages *
    page, D]``.  For tests and oracles only: building it is what the
    kernel avoids."""
    g = pool[table.long()]  # [B, max_pages, Hkv, page, D]
    b, mp, hkv, page, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, mp * page, d)


def _check_args(q, k_pool, v_pool, table):
    if k_pool.dtype == torch.int8 or v_pool.dtype == torch.int8:
        raise NotImplementedError(
            "int8 paged pools are not supported; serve int8 caches through "
            "the dense decode kernel (ops/decode.py)")
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"want q [B,Hq,C,D] and pools [n_pages,Hkv,page,D], "
                         f"got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    b, hq, _, d = q.shape
    if k_pool.shape[3] != d or hq % k_pool.shape[1]:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"table must be [{b}, max_pages], got "
                         f"{tuple(table.shape)}")


def paged_decode_attention_reference(q, k_pool, v_pool, table, pos, *,
                                     sm_scale: Optional[float] = None):
    """The kernel's function in plain PyTorch, on any device: the dense
    :func:`~starway_tpu_torch.ops.decode.decode_attention_reference` over
    the gathered live pages.  Table entries past each slot's last live page
    (``(pos + C - 1) // page``) are replaced by page 0 before the gather,
    so they are never read; the positions they cover are masked anyway."""
    _check_args(q, k_pool, v_pool, table)
    b, _, n_q, _ = q.shape
    page, max_pages = k_pool.shape[2], table.shape[1]
    pos_arr = _pos_rows(pos, b, q.device).long()
    last = (pos_arr + n_q - 1) // page  # last live page of each slot
    n_live = max(1, min(max_pages, int(last.max()) + 1))
    cols = torch.arange(n_live, device=q.device)
    ids = torch.where(cols[None, :] <= last[:, None],
                      table[:, :n_live].to(q.device).long(), 0)
    return decode_attention_reference(
        q, gather_logical(k_pool, ids), gather_logical(v_pool, ids), pos_arr,
        sm_scale=sm_scale)


def paged_decode_attention(q, k_pool, v_pool, table, pos, *,
                           sm_scale: Optional[float] = None):
    """Decode attention (C >= 1 query positions per slot) over a paged
    pool.  ``q [B, Hq, C, D]``; pools ``[n_pages, Hkv, page, D]`` in q's
    dtype; ``table [B, max_pages]`` int32 page ids (ids up to each slot's
    last live page must be valid pages; later ones are never read);
    ``pos`` an int or ``[B]`` cursors: slot b's queries sit at ``pos[b] ..
    pos[b] + C - 1`` and mask the keys above themselves, so write-then-
    attend callers must have written those entries.  Returns ``[B, Hq, C,
    D]`` in q's dtype.

    CUDA tensors launch the kernels (csrc/paged_attention.cu): bf16 the
    tensor-core kernel at every compiled head size, one launch a call;
    float32 the FMA loop.  ``pos`` and ``table`` are read on the device
    only.  CPU tensors take :func:`paged_decode_attention_reference`.
    """
    _check_args(q, k_pool, v_pool, table)
    if not q.is_cuda:
        return paged_decode_attention_reference(q, k_pool, v_pool, table, pos,
                                                sm_scale=sm_scale)
    b, hq, n_q, d = q.shape
    hkv, page = k_pool.shape[1], k_pool.shape[2]
    max_pages = table.shape[1]
    rows = (hq // hkv) * n_q
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bfloat16 or float32, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype} != q dtype {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not compiled; the kernel takes "
                         f"{HEAD_DIMS}")
    if table.dtype != torch.int32:
        raise ValueError(f"table must be int32, got {table.dtype}")
    for x in (q, k_pool, v_pool, table):
        if x.device != q.device:
            raise ValueError(f"tensor on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError("paged_decode_attention needs contiguous "
                             "tensors")
    if q.data_ptr() % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode_attention reads q and the pools with "
                         "16-byte copies; they must be 16-byte aligned")
    bf16 = q.dtype == torch.bfloat16
    regime, n_split = launch_plan(b, hkv, rows, max_pages * page, d, bf16,
                                  False, q.device.index or 0, False)
    lib = _build.library()
    out = torch.empty_like(q)
    pos_t, pos_stride, pos_value = pos_arg(pos, b, q.device)
    head = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), None if pos_t is None else pos_t.data_ptr(),
            pos_stride, pos_value, out.data_ptr())
    if bf16:
        shift = page.bit_length() - 1 if page & (page - 1) == 0 else -1
        err = lib.sw_paged_attention(
            *head, b, hkv, rows, n_q, max_pages, page, shift, d,
            float(sm_scale), int(regime == "decode"), n_split,
            _build.stream_ptr(q))
    else:
        f32 = dict(dtype=torch.float32, device=q.device)
        o_part = torch.empty((b * hkv, n_split, rows, d), **f32)
        m_part = torch.empty((b * hkv, n_split, rows), **f32)
        l_part = torch.empty((b * hkv, n_split, rows), **f32)
        err = lib.sw_paged_attention_fma(
            *head, o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            b, hkv, n_split, rows, n_q, max_pages, page, d, float(sm_scale),
            _build.stream_ptr(q))
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
