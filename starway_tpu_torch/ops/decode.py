"""Cached decode attention: the hand-written CUDA kernels
(csrc/decode_tma.cu, csrc/decode_attention.cu) and their plain PyTorch
version.

A thread block attends a tile of the ``n_rep * C`` query rows (the grouped
heads of C consecutive positions) of one (batch row, kv head) against a
share of the narrow cache's live tiles, reading each once.  bfloat16
queries run on the tensor cores in one launch a call.  The decode regime
(at most 16 rows) at head sizes 64 and 128 (:func:`tma_route`) runs
csrc/decode_tma.cu: tiles by TMA, products on ``wgmma``, and as many
blocks over T as :func:`tma_plan` finds fill the card, merged through a
workspace in split order.  Every other bf16 call runs
csrc/decode_attention.cu's ``mma.sync`` kernel, in the regime and split
that :func:`decode_plan` picks ("decode": one m16 tile of rows, the warps
dividing each tile's keys; "ingest": 64-row tiles, 16 rows a warp), whose
splits of a row tile are one thread block cluster that merges their
partials on chip.  float32 queries (the parity runs) take the FMA loop:
partials in device memory and a combine kernel.  See the kernel sources
for what bounds them.  :func:`decode_attention` launches the kernels for
CUDA tensors and takes :func:`decode_attention_reference` only for CPU
tensors.

Layouts follow models/generate.py: ``q [B, Hq, C, D]``, caches
``[B, Hkv, T, D]``, int8 scales ``[B, Hkv, T]`` float32.
"""

from __future__ import annotations

import functools
import numbers
from typing import Optional

import torch

from . import _build
from .attention import NEG_BIG

HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernels' compiled head sizes
N_SMS = 132  # SMs of an H100 SXM: the plan's card where none is named
KEYS = 64  # keys a tile of the bf16 kernels (kKeys in csrc/decode_tiles.cuh)
DECODE_MAX_ROWS = 16  # rows of one m16 tile: the decode regime's limit
REGIME_ROWS = {"decode": 16, "ingest": 64}  # query rows a block
# Blocks an SM the split aims at, at D <= 128: a decode block fits three
# an SM, and two leave room for the clusters to pack; an ingest block
# fits two, and its clusters of 4 at two an SM ran as two waves on the
# H100, so it aims at three for every two SMs (ops/decode_bench.py
# --sweep).  At D = 256 both fit one an SM, and the split aims at three
# for every four.
SPLIT_PER_SM = {"decode": 2.0, "ingest": 1.5}
# The TMA kernel (csrc/decode_tma.cu): its head sizes; the most splits
# over T it merges (kMaxTmaSplits), the most that one block merges
# (kSingleMerge: past it, groups of kMergeGroup first).  Its plan: about
# TMA_TILES_PER_SPLIT tiles a split of the longest row, at least one block
# for each SM, at most TMA_MAX_PER_SM blocks an SM (kBlocksPerSM fit at
# once) and one split for every TMA_MIN_TILES tiles.  Measured on the H100
# (PERF.md, the decode kernel's entry).
TMA_HEAD_DIMS = (64, 128)
TMA_MAX_SPLITS = 256
TMA_SINGLE_MERGE = 32
TMA_MERGE_GROUP = 8
TMA_TILES_PER_SPLIT = 4
TMA_MAX_PER_SM = 4
TMA_MIN_TILES = 2
FMA_TILE = 32  # keys per tile of the float32 loop (kFmaKeys)
FMA_ROW_TILE = 64  # query rows per float32 block (kFmaRows)


def max_splits(d: int) -> int:
    """The largest split over T (one thread block cluster) at head size
    ``d``: 16, a non-portable cluster, or 8 at d = 256, whose blocks (one
    an SM) may not find 16 SMs on one GPC."""
    return 16 if d <= 128 else 8


def decode_plan(b: int, hkv: int, rows: int, t: int, d: int = 128,
                n_sms: int = N_SMS) -> tuple[str, int]:
    """(regime, n_split) of a bf16 call with ``rows = n_rep * C`` query
    rows per (batch row, kv head) over a cache of capacity ``t``: "decode"
    up to ``DECODE_MAX_ROWS`` rows, else "ingest"; ``n_split`` blocks of a
    cluster share each row tile's live tiles, as many as keep the grid
    within ``SPLIT_PER_SM`` blocks an SM (0.75 at d = 256), at most
    :func:`max_splits` and the tiles ``t`` holds.  Nothing here depends
    on ``pos``: each block finds its share on the device."""
    regime = "decode" if rows <= DECODE_MAX_ROWS else "ingest"
    units = b * hkv * -(-rows // REGIME_ROWS[regime])
    per_sm = SPLIT_PER_SM[regime] if d <= 128 else 0.75
    n_split = min(int(per_sm * n_sms) // units, max_splits(d), -(-t // KEYS))
    return regime, max(1, n_split)


def tma_route(bf16: bool, rows: int, d: int) -> bool:
    """Does a call with ``rows = n_rep * C`` query rows per (batch row, kv
    head) at head size ``d`` run the TMA kernel (csrc/decode_tma.cu)?  bf16
    q in the decode regime at head sizes 64 and 128; every other call runs
    csrc/decode_attention.cu."""
    return bf16 and rows <= DECODE_MAX_ROWS and d in TMA_HEAD_DIMS


def tma_plan(b: int, hkv: int, t: int, n_sms: int = N_SMS) -> int:
    """Blocks over T for each (batch row, kv head) of the TMA kernel over a
    cache of capacity ``t``: enough that the longest row's share is about
    ``TMA_TILES_PER_SPLIT`` tiles and that the grid has a block for each
    of the card's ``n_sms`` SMs, at most ``TMA_MAX_PER_SM`` blocks an SM,
    one split for every ``TMA_MIN_TILES`` tiles and ``TMA_MAX_SPLITS``;
    between ``TMA_SINGLE_MERGE`` and twice it, ``TMA_SINGLE_MERGE`` (one
    block's merge beats the two-level one there).  Nothing here depends
    on ``pos``: each block finds its share of the live tiles on the
    device, and a block left without one returns at once."""
    units = b * hkv
    tiles = -(-t // KEYS)
    n = max(-(-tiles // TMA_TILES_PER_SPLIT), -(-n_sms // units))
    n = min(n, TMA_MAX_PER_SM * n_sms // units,
            -(-tiles // TMA_MIN_TILES), TMA_MAX_SPLITS)
    n = max(1, n)
    return TMA_SINGLE_MERGE if TMA_SINGLE_MERGE < n < 2 * TMA_SINGLE_MERGE \
        else n


def call_plan(b: int, hkv: int, rows: int, t: int, d: int = 128,
              bf16: bool = True, n_sms: int = N_SMS,
              tma: bool = True) -> tuple[str, int]:
    """(regime, n_split) of a call: ("tma", :func:`tma_plan`) where
    :func:`tma_route` says so (and ``tma``: the paged kernel has no TMA
    route), else :func:`decode_plan`'s for bf16 q and ("fma",
    :func:`split_count`) for float32."""
    if tma and tma_route(bf16, rows, d):
        return "tma", tma_plan(b, hkv, t, n_sms)
    if bf16:
        return decode_plan(b, hkv, rows, t, d, n_sms)
    return "fma", split_count(b, hkv, rows, t, n_sms)


def split_count(b: int, hkv: int, rows: int, t: int, n_sms: int) -> int:
    """Blocks over T per (batch row, kv head, row tile) of the float32
    loop: enough to give every SM a few blocks, and no more than the cache
    has tiles."""
    n_rt = -(-rows // FMA_ROW_TILE)
    return max(1, min(-(-4 * n_sms // (b * hkv * n_rt)), -(-t // FMA_TILE)))


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple[int, int]:
    """(SM count, shared memory a block may opt into) of CUDA card
    ``index``, read once."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, hkv: int, rows: int, t: int, d: int, bf16: bool,
                quant: bool, index: int, tma: bool = True) -> tuple[str, int]:
    """:func:`call_plan` on card ``index``; raises where a block needs
    more shared memory than the card allows.  Cached: a decode step makes
    32 calls of one shape."""
    n_sms, allowed = _card(index)
    regime, n_split = call_plan(b, hkv, rows, t, d, bf16, n_sms, tma)
    lib = _build.library()
    if regime == "tma":
        smem = lib.sw_decode_tma_smem(rows, d, int(quant))
    else:
        smem = lib.sw_decode_attention_smem(
            rows, d, int(bf16), int(quant), int(regime == "decode"))
    if smem > allowed:
        raise ValueError(f"head_dim {d} needs {smem} bytes of shared memory "
                         f"per block; the card allows {allowed}")
    return regime, n_split


_workspaces: dict = {}  # (card, stream) -> the TMA kernel's float32 scratch


def _workspace(device, stream: int, n: int) -> int:
    """Pointer to at least ``n`` float32 of scratch for the partials of the
    TMA kernel launched on ``stream``: one ``torch.empty`` buffer a (card,
    stream), grown when a call needs more, so that a decode step's 32
    calls allocate nothing.  A launch writes it only after its
    ``griddepcontrol.wait``, that is after every kernel before it on the
    stream has finished, so no two launches use it at once."""
    key = (device.index, stream)
    buf = _workspaces.get(key)
    if buf is None or buf.numel() < n:
        have = 0 if buf is None else buf.numel()
        buf = torch.empty(max(n, 2 * have), dtype=torch.float32,
                          device=device)
        _workspaces[key] = buf
    return buf.data_ptr()


def pos_arg(pos, b: int, device) -> tuple:
    """``pos`` as the kernels take it, (device tensor or None, stride,
    value): a [B] or one-element int32 tensor on ``device`` as it is
    (stride 1 or 0, read on the device), an int as the value of every row.
    Other tensors are converted first; none is read on the host."""
    if isinstance(pos, numbers.Integral):
        return None, 0, int(pos)
    p = torch.as_tensor(pos)
    if p.numel() not in (1, b):
        raise ValueError(f"pos must be a scalar or [{b}], got "
                         f"{tuple(p.shape)}")
    if p.dtype != torch.int32 or p.device != device or not p.is_contiguous():
        p = p.to(device=device, dtype=torch.int32).contiguous()
    return p, int(p.numel() == b), 0


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

    CUDA tensors launch the kernels, one launch a call for bf16 q (bf16
    or int8 caches): csrc/decode_tma.cu where :func:`tma_route` says so
    (counted also in ``decode_attention.tma_launches``), planned by
    :func:`tma_plan`, else csrc/decode_attention.cu's tensor-core kernel
    as :func:`decode_plan` plans it; float32 q the FMA loop.  ``pos`` is
    read on the device only (:func:`pos_arg`).  CPU tensors take
    :func:`decode_attention_reference`.
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
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention reads q and the caches with "
                         "16-byte copies; they must be 16-byte aligned")
    bf16 = q.dtype == torch.bfloat16
    regime, n_split = launch_plan(b, hkv, rows, t, d, bf16, quant,
                                  q.device.index or 0)
    lib = _build.library()
    out = torch.empty_like(q)
    scales = ((k_scale.data_ptr(), v_scale.data_ptr()) if quant
              else (None, None))
    pos_t, pos_stride, pos_value = pos_arg(pos, b, q.device)
    head = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales,
            None if pos_t is None else pos_t.data_ptr(), pos_stride,
            pos_value, out.data_ptr())
    win = 0 if window is None else int(window)
    if regime == "tma":
        stream = _build.stream_ptr(q)
        part = None
        if n_split > 1:  # the splits' partials, then their groups'
            n_groups = (-(-n_split // TMA_MERGE_GROUP)
                        if n_split > TMA_SINGLE_MERGE else 0)
            part = _workspace(q.device, stream, b * hkv * (n_split + n_groups)
                              * rows * (d + 2))
        err = lib.sw_decode_tma(*head, part, b, hkv, rows, n_q, t, d, win,
                                float(sm_scale), int(quant), n_split, stream)
        _build.check(err, "decode_attention")
        decode_attention.launches += 1
        decode_attention.tma_launches += 1
        return out
    if bf16:
        err = lib.sw_decode_attention(
            *head, b, hkv, rows, n_q, t, d, win, float(sm_scale), int(quant),
            int(regime == "decode"), n_split, _build.stream_ptr(q))
    else:
        f32 = dict(dtype=torch.float32, device=q.device)
        o_part = torch.empty((b * hkv, n_split, rows, d), **f32)
        m_part = torch.empty((b * hkv, n_split, rows), **f32)
        l_part = torch.empty((b * hkv, n_split, rows), **f32)
        err = lib.sw_decode_attention_fma(
            *head, o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            b, hkv, n_split, rows, n_q, t, d, win, float(sm_scale),
            int(quant), _build.stream_ptr(q))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.tma_launches = 0  # of them, on csrc/decode_tma.cu
