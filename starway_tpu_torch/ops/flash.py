"""Flash attention, forward and backward, and the ring step's partials:
the hand-written CUDA kernels (csrc/flash_fwd*.cu, csrc/flash_bwd*.cu) and
their plain PyTorch versions.

Layouts: ``q [B, Hq, S, D]``, ``k/v [B, Hkv, Skv, D]`` (grouped kv is
taken as it is; query head h reads kv head ``h // n_rep``).  Every kernel
runs bf16 on the tensor cores and float32 on the FMA units.  The forward
returns the output and the row log-sum-exp ``lse [B, Hq, S]`` float32; the
backward recomputes the probabilities from that lse in two passes (dK/dV
kv-stationary, dQ q-stationary), the dK/dV pass split over query heads
when its grid is too small for the card (:func:`dkv_splits`).
:func:`flash_attention` is differentiable through a
``torch.autograd.Function`` whose backward is the two kernels, as the JAX
package's ``custom_vjp`` is.

A bf16 forward, partial or backward of head size 64 or 128 runs the
kernels on Hopper's wgmma fed by TMA (csrc/flash_fwd_wgmma.cu,
csrc/flash_bwd_wgmma.cu); head sizes 16 and 32 the mma.sync kernels
(:func:`fwd_route`, :func:`bwd_route`, from the shapes).  Every kernel
takes 16-byte aligned bases of q, k, v and dO and refuses others.

A ring step (parallel/ring_attention.py) runs :func:`flash_partial`, the
unnormalised partial ``(o, m, l)`` of q against one kv shard at global
offsets, and :func:`flash_partial_bwd`, the same two backward passes at
those offsets with float32 outputs, from the globally merged lse and
delta.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build
from .attention import NEG_BIG, partial_attention, repeat_kv

HEAD_DIMS = (16, 32, 64, 128)  # the kernels' compiled head sizes


def _check_args(q, k, v, causal, window):
    if window is not None:
        if not causal:
            raise ValueError("window requires causal attention")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,Hq,S,D] and k/v [B,Hkv,Skv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]
            or q.shape[1] % k.shape[1]):
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def _check_kernel_args(tensors, name):
    """What the CUDA kernels take: one device, contiguous, bf16 or f32,
    a compiled head size, bases on the 16-byte grid (the kernels copy
    16-byte chunks: TMA boxes, cp.async)."""
    q = tensors[0]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bfloat16 or float32, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not compiled; the kernel "
                         f"takes {HEAD_DIMS}")
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"tensor on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned tensors")


N_SMS = 132   # SMs of an H100 SXM: the plans' count where no card is named
TILE = 64     # rows of the kernels' q and kv tiles
WGMMA_HEAD_DIMS = (64, 128)  # the wgmma forward's compiled head sizes


def fwd_route(bf16: bool, head_dim: int) -> str:
    """The forward and partial kernel a call takes: "wgmma" (csrc/
    flash_fwd_wgmma.cu, TMA and wgmma) for bf16 at a head size of
    ``WGMMA_HEAD_DIMS`` (TMA's strides, D * 2 and S * D * 2 bytes, are
    multiples of 16 there; its bases, as every kernel's here, are
    16-byte aligned or refused by ``_check_kernel_args``), "mma"
    (csrc/flash_fwd.cu, mma.sync) for bf16 at the other head sizes, "fma"
    for float32.  Decided from the arguments alone, never from a failed
    launch."""
    if not bf16:
        return "fma"
    return "wgmma" if head_dim in WGMMA_HEAD_DIMS else "mma"


def bwd_route(bf16: bool, head_dim: int) -> str:
    """The backward passes' kernels (both passes of :func:`flash_backward`
    and :func:`flash_partial_bwd`): "wgmma" (csrc/flash_bwd_wgmma.cu, TMA
    and wgmma) for bf16 at a head size of ``WGMMA_HEAD_DIMS``, "mma"
    (csrc/flash_bwd.cu, mma.sync) for bf16 at the other head sizes, "fma"
    (csrc/flash_bwd.cu) for float32: the forward's split, for the same
    reasons (:func:`fwd_route`).  Decided from the arguments alone, never
    from a failed launch."""
    return fwd_route(bf16, head_dim)


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def q_heights(head_dim: int) -> tuple:
    """The q-tile heights the bf16 forward and partial kernels have at
    ``head_dim``: 64 rows for the wgmma kernel (64 and 128: two blocks
    an SM, which beat blocks of 128 rows at every main-path shape on the
    H100), 64 and 128 for the mma.sync kernel at 32, 64 at 16 (ptxas
    spills the taller tile there)."""
    return (TILE, 2 * TILE) if head_dim == 32 else (TILE,)


def fwd_q_rows(b: int, hq: int, s_len: int, kv_len: int, causal: bool,
               window: Optional[int] = None, q_offset: int = 0,
               kv_offset: int = 0, n_sms: int = N_SMS,
               head_dim: int = 128) -> int:
    """The q-tile height of the bf16 forward and partial kernels, of
    :func:`q_heights`: where the kernel has two, 128 rows (each warp two
    16-row m-tiles, so every K/V tile staged from L2 serves twice the
    rows) when the grid at that height keeps the card's ``n_sms`` SMs
    busy, else 64.  Blocks of equal work (every row sees every key: no
    causal mask, or a ring step's past block) run side by side, so a
    block for every other SM will do; under a causal diagonal the
    heaviest blocks walk twice the average, and it takes two blocks an SM
    for the heaviest-first order to balance them."""
    if 2 * TILE not in q_heights(head_dim):
        return TILE
    blocks = b * hq * -(-s_len // (2 * TILE))
    full = not causal or (window is None
                          and q_offset >= kv_offset + kv_len - 1)
    need = n_sms // 2 if full else 2 * n_sms
    return 2 * TILE if blocks >= need else TILE


def _mask(s_len, kv_len, causal, window, device, q_offset=0, kv_offset=0):
    """[S, Skv] visibility at global offsets, or None when every key is
    visible."""
    if not causal:
        return None
    qp = q_offset + torch.arange(s_len, device=device)[:, None]
    kp = kv_offset + torch.arange(kv_len, device=device)[None, :]
    mask = qp >= kp
    if window is not None:
        mask = mask & (kp > qp - window)
    return mask


def flash_forward_reference(q, k, v, *, causal: bool = False,
                            sm_scale: Optional[float] = None,
                            window: Optional[int] = None):
    """The kernel's function in plain PyTorch, on any device: returns
    ``(o, lse)``.  Scores and the softmax are float32, p is rounded to the
    input dtype before ``p @ v``, and a row with no visible key gives
    o = 0."""
    _check_args(q, k, v, causal, window)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    n_rep = q.shape[1] // k.shape[1]
    kx, vx = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    s = torch.matmul(q.float(), kx.float().transpose(-1, -2)) * sm_scale
    mask = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_BIG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.clamp(m, min=NEG_BIG / 2))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.matmul(p.to(q.dtype).float(), vx.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_forward(q, k, v, *, causal: bool = False,
                  sm_scale: Optional[float] = None,
                  window: Optional[int] = None):
    """Flash-attention forward: ``(o [B,Hq,S,D], lse [B,Hq,S] f32)``.

    ``causal`` masks keys after each query; ``window`` (requires
    ``causal``) keeps ``k_pos in (q_pos - window, q_pos]``.  Keys past the
    end of k (Skv) are never attended.  CUDA tensors launch the kernel
    (csrc/flash_fwd.cu; bf16 at the q-tile height :func:`fwd_q_rows`
    plans), CPU tensors take :func:`flash_forward_reference`.
    """
    _check_args(q, k, v, causal, window)
    if not q.is_cuda:
        return flash_forward_reference(q, k, v, causal=causal,
                                       sm_scale=sm_scale, window=window)
    _check_kernel_args((q, k, v), "flash_forward")
    b, hq, s_len, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    rows = fwd_q_rows(b, hq, s_len, k.shape[2], causal, window,
                      n_sms=_n_sms(q.device.index), head_dim=d)
    route = fwd_route(q.dtype == torch.bfloat16, d)
    out = _launch_forward(q, k, v, rows, causal, sm_scale, window)
    flash_forward.launches += 1
    flash_forward.wgmma_launches += route == "wgmma"
    return out


flash_forward.launches = 0
flash_forward.wgmma_launches = 0  # of them, on csrc/flash_fwd_wgmma.cu


def _launch_forward(q, k, v, rows, causal, sm_scale, window):
    """The forward kernel (:func:`fwd_route`'s) on checked CUDA tensors at
    ``rows``-row q tiles (bf16; float32 has one tiling), uncounted:
    :func:`flash_forward`'s launch, and the tests' and the sweep's
    (ops/flash_sweep.py) at a height of :func:`q_heights` that
    :func:`fwd_q_rows` does not pick."""
    b, hq, s_len, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    route = fwd_route(bf16, d)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s_len), dtype=torch.float32, device=q.device)
    lib = _build.library()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, hq, k.shape[1], s_len, k.shape[2], d,
            int(causal), 0 if window is None else int(window),
            float(sm_scale))
    if rows not in q_heights(d):
        raise ValueError(f"no {rows}-row q tiles at head_dim {d}")
    if route == "wgmma":
        err = lib.sw_flash_fwd_wgmma(*head, _build.stream_ptr(q))
    else:
        err = lib.sw_flash_fwd(*head, int(bf16), rows, _build.stream_ptr(q))
    _build.check(err, "flash_forward")
    return o, lse


# ------------------------------------------------------------------ backward


def _backward_plain(q, k, v, do, lse, delta, causal, window, sm_scale,
                    q_offset=0, kv_offset=0):
    """The backward passes' function: float32 ``(dq, dk, dv)``, dk/dv
    summed per kv head, with the kernels' rounding points."""
    b, hq, s_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    kx = repeat_kv(k, n_rep).float()
    vx = repeat_kv(v, n_rep).float()
    qf, dof = q.float(), do.float()
    s = torch.matmul(qf, kx.transpose(-1, -2)) * sm_scale
    p = torch.exp(s - lse.float()[..., None])
    mask = _mask(s_len, kv_len, causal, window, q.device, q_offset, kv_offset)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.matmul(dof, vx.transpose(-1, -2))
    ds = p * (dp - delta.float()[..., None])
    ds_r = ds.to(q.dtype).float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds_r.transpose(-1, -2), qf) * sm_scale
    dq = torch.matmul(ds_r, kx) * sm_scale

    def group(x):  # [B, Hq, Skv, D] -> [B, Hkv, Skv, D], summed per kv head
        return x.reshape(b, hkv, n_rep, kv_len, d).sum(dim=2)

    return dq, group(dk), group(dv)


def flash_backward_reference(q, k, v, o, lse, do, *, causal: bool = False,
                             sm_scale: Optional[float] = None,
                             window: Optional[int] = None):
    """The backward kernels' function in plain PyTorch, on any device:
    ``(dq, dk, dv)`` in the input dtype, written with the explicit formulas

        p = exp(s - lse),  delta = rowsum(dO * O),
        ds = p * (dp - delta) with dp = dO v^T,
        dv = p^T dO,  dk = ds^T q * sm_scale,  dq = ds k * sm_scale,

    dk and dv summed over the n_rep query heads of each kv head.  Scores
    and sums are float32; p is rounded to dO's dtype before ``p^T dO`` and
    ds to the input dtype before its products, as the kernels do."""
    _check_args(q, k, v, causal, window)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq, dk, dv = _backward_plain(q, k, v, do, lse, delta, causal, window,
                                 sm_scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The library's entries of each backward pass by route: pass A ("dkv",
# which takes a split count) and pass B ("dq").
_BWD_ENTRIES = {
    "wgmma": {"dkv": "sw_flash_bwd_dkv_wgmma", "dq": "sw_flash_bwd_dq_wgmma"},
    "mma": {"dkv": "sw_flash_bwd_dkv_split", "dq": "sw_flash_bwd_dq"},
    "fma": {"dkv": "sw_flash_bwd_dkv_split", "dq": "sw_flash_bwd_dq"},
}


def _bwd_launcher(q, k, v, do, lse, delta, causal, window, sm_scale,
                  q_offset, kv_offset):
    """``(launch, route)``: ``launch(pass_, out_ptrs, out_f32, n_split=1)``
    runs one backward pass ("dkv" split ``n_split`` ways over query heads,
    or "dq") on :func:`bwd_route`'s kernels into the outputs at
    ``out_ptrs``, float32 when ``out_f32`` (a ring step or a split pass A)
    else the input dtype.  The arguments both passes share are read once:
    a ring calls the passes 2 n^2 + n times a layer, and the host's time
    counts."""
    lib = _build.library()
    b, hq, s_len, d = q.shape
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    tail = (b, hq, k.shape[1], s_len, k.shape[2], d, int(causal),
            0 if window is None else int(window), int(q_offset),
            int(kv_offset), float(sm_scale))
    bf16 = q.dtype == torch.bfloat16
    route = bwd_route(bf16, d)
    entries = _BWD_ENTRIES[route]
    # The mma.sync / FMA entries take the input type; the wgmma ones bf16.
    typed = () if route == "wgmma" else (int(bf16),)
    stream = _build.stream_ptr(q)

    def launch(pass_, out_ptrs, out_f32, n_split=1):
        split = (n_split,) if pass_ == "dkv" else ()
        err = getattr(lib, entries[pass_])(*head, *out_ptrs, *tail,
                                           int(out_f32), *typed, *split,
                                           stream)
        _build.check(err, entries[pass_])

    return launch, route


def dkv_splits(b: int, hkv: int, kv_len: int, n_rep: int,
               n_sms: int = N_SMS) -> int:
    """How many ways pass A splits each kv head's walk over its ``n_rep``
    query heads: 1 when its grid (kv tiles x B * Hkv blocks) already
    holds two blocks for each of the card's ``n_sms`` SMs (both pass A
    kernels, mma.sync and wgmma, run 64-key blocks two to an SM), else the
    least divisor of ``n_rep`` that brings it there (``n_rep`` at most).  On an
    H100 SXM (132 SMs) a ring shard (T = 1024, B = 1, 8 kv heads: 128
    blocks) splits 4 ways; plain training at B = 2, S = 2048 (512 blocks)
    does not split."""
    blocks = -(-kv_len // TILE) * b * hkv
    for n in range(1, n_rep + 1):
        if n_rep % n == 0 and blocks * n >= 2 * n_sms:
            return n
    return n_rep


def _dkv(launch, k, n_rep, out_dtype):
    """Pass A into ``(dk, dv)`` of ``out_dtype``.  A split pass writes one
    float32 partial a split; the partials are summed here in a fixed order
    (deterministic, no atomics) before any cast to ``out_dtype``.  The
    split is planned for the SMs of k's card."""
    n = dkv_splits(k.shape[0], k.shape[1], k.shape[2], n_rep,
                   _n_sms(k.device.index))
    if n == 1:
        dk = torch.empty(k.shape, dtype=out_dtype, device=k.device)
        dv = torch.empty_like(dk)
        launch("dkv", (dk.data_ptr(), dv.data_ptr()),
               out_dtype == torch.float32)
        return dk, dv
    part = torch.empty((2, n, *k.shape), dtype=torch.float32,
                       device=k.device)
    ptr = part.data_ptr()
    launch("dkv", (ptr, ptr + 4 * n * k.numel()), True, n)
    dk, dv = part.sum(dim=1).to(out_dtype).unbind(0)
    return dk, dv


def _check_bwd(q, k, v, do, lse, delta, name):
    _check_kernel_args((q, k, v, do), name)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for x in (lse, delta):
        if (x.shape != q.shape[:3] or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{name}: lse/delta must be contiguous float32 "
                             f"{tuple(q.shape[:3])} on {q.device}")


def flash_backward_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                       sm_scale: float, window: Optional[int] = None):
    """Pass A of the backward on CUDA tensors: ``(dk, dv)`` in k's dtype,
    from ``lse`` and ``delta = rowsum(dO * O)`` (both ``[B, Hq, S]``
    float32), on :func:`bwd_route`'s kernel."""
    _check_bwd(q, k, v, do, lse, delta, "flash_backward_dkv")
    launch, route = _bwd_launcher(q, k, v, do, lse, delta, causal, window,
                                  sm_scale, 0, 0)
    dk, dv = _dkv(launch, k, q.shape[1] // k.shape[1], k.dtype)
    flash_backward_dkv.launches += 1
    flash_backward_dkv.wgmma_launches += route == "wgmma"
    return dk, dv


flash_backward_dkv.launches = 0
flash_backward_dkv.wgmma_launches = 0  # of them, on csrc/flash_bwd_wgmma.cu


def flash_backward_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                      sm_scale: float, window: Optional[int] = None):
    """Pass B of the backward on CUDA tensors: ``dq`` in q's dtype; the
    arguments are pass A's."""
    _check_bwd(q, k, v, do, lse, delta, "flash_backward_dq")
    dq = torch.empty_like(q)
    launch, route = _bwd_launcher(q, k, v, do, lse, delta, causal, window,
                                  sm_scale, 0, 0)
    launch("dq", (dq.data_ptr(),), q.dtype == torch.float32)
    flash_backward_dq.launches += 1
    flash_backward_dq.wgmma_launches += route == "wgmma"
    return dq


flash_backward_dq.launches = 0
flash_backward_dq.wgmma_launches = 0  # of them, on csrc/flash_bwd_wgmma.cu


def flash_backward_delta_reference(o, do):
    """``delta = rowsum(dO * O)`` in plain PyTorch, on any device: float32
    ``[B, H, S]`` from float32 copies, as the JAX package's ``_bwd_impl``
    computes it."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_backward_delta(o, do):
    """``delta = rowsum(dO * O)``, float32 ``[B, H, S]``, which both
    backward passes read.  CUDA tensors launch the kernel
    (csrc/flash_bwd.cu ``flash_bwd_delta_kernel``: dO and O read once,
    summed in float32 in a fixed order), CPU tensors take
    :func:`flash_backward_delta_reference`."""
    if not o.is_cuda:
        return flash_backward_delta_reference(o, do)
    _check_kernel_args((o, do), "flash_backward_delta")
    if do.shape != o.shape or do.dtype != o.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match O "
                         f"{tuple(o.shape)} {o.dtype}")
    d = o.shape[-1]
    delta = torch.empty(o.shape[:-1], dtype=torch.float32, device=o.device)
    err = _build.library().sw_flash_bwd_delta(
        do.data_ptr(), o.data_ptr(), delta.data_ptr(), o.numel() // d, d,
        int(o.dtype == torch.bfloat16), _build.stream_ptr(o))
    _build.check(err, "flash_backward_delta")
    flash_backward_delta.launches += 1
    return delta


flash_backward_delta.launches = 0


def flash_backward(q, k, v, o, lse, do, *, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   window: Optional[int] = None):
    """Gradients ``(dq, dk, dv)`` of flash attention from the forward's
    ``o`` and ``lse`` and the output gradient ``do``.  CUDA tensors launch
    the two kernels (:func:`bwd_route`'s) after
    :func:`flash_backward_delta`'s; CPU tensors take
    :func:`flash_backward_reference`."""
    _check_args(q, k, v, causal, window)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return flash_backward_reference(q, k, v, o, lse, do, causal=causal,
                                        sm_scale=sm_scale, window=window)
    delta = flash_backward_delta(o, do)
    kw = dict(causal=causal, sm_scale=sm_scale, window=window)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, **kw)
    return flash_backward_dq(q, k, v, do, lse, delta, **kw), dk, dv


class _Flash(torch.autograd.Function):
    """The JAX package's ``_flash`` custom_vjp: the forward kernel saves
    ``q, k, v, o, lse``; the backward runs the two backward kernels and
    drops lse's cotangent (lse is an auxiliary statistic)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        o, lse = flash_forward(q, k, v, causal=causal, sm_scale=sm_scale,
                               window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = dict(causal=causal, sm_scale=sm_scale, window=window)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(),
                                    **ctx.cfg)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None):
    """Flash attention, differentiable: the output of :func:`flash_forward`,
    with :func:`flash_backward` as its gradient."""
    _check_args(q, k, v, causal, window)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    return _Flash.apply(q, k, v, causal, float(sm_scale), window)[0]


# ------------------------------------------------------------ ring steps


def flash_partial_reference(q, k, v, q_offset: int, kv_offset: int, *,
                            causal: bool = True,
                            sm_scale: Optional[float] = None,
                            window: Optional[int] = None):
    """The partial kernel's function in plain PyTorch, on any device:
    ops/attention.py's ``partial_attention`` over the expanded kv heads
    (scores float32, p rounded to v's dtype before ``p @ v``)."""
    _check_args(q, k, v, causal, window)
    n_rep = q.shape[1] // k.shape[1]
    return partial_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                             q_offset=q_offset, kv_offset=kv_offset,
                             causal=causal, sm_scale=sm_scale, window=window)


def flash_partial(q, k, v, q_offset: int, kv_offset: int, *,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  window: Optional[int] = None):
    """One ring step's attention partial: q ``[B, Hq, T, D]`` at global
    position ``q_offset`` against one kv shard ``[B, Hkv, Tkv, D]`` at
    ``kv_offset``.  Returns ``(o, m, l)`` in the mergeable unnormalised
    form of ops/attention.py ``partial_attention``: o ``[B, Hq, T, D]``, m
    and l ``[B, Hq, T]``, all float32; a row that sees no key is the
    identity (o = 0, m = NEG_BIG, l = 0).  ``window`` (requires
    ``causal``) is the sliding band.  CUDA tensors launch the kernel
    (csrc/flash_fwd.cu, as :func:`flash_forward`), CPU tensors take
    :func:`flash_partial_reference`.  Not differentiable: ring attention's
    autograd Function pairs it with :func:`flash_partial_bwd`."""
    _check_args(q, k, v, causal, window)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return flash_partial_reference(q, k, v, q_offset, kv_offset,
                                       causal=causal, sm_scale=sm_scale,
                                       window=window)
    _check_kernel_args((q, k, v), "flash_partial")
    b, hq, s_len, d = q.shape
    rows = fwd_q_rows(b, hq, s_len, k.shape[2], causal, window, q_offset,
                      kv_offset, _n_sms(q.device.index), d)
    route = fwd_route(q.dtype == torch.bfloat16, d)
    out = _launch_partial(q, k, v, q_offset, kv_offset, rows, causal,
                          sm_scale, window)
    flash_partial.launches += 1
    flash_partial.wgmma_launches += route == "wgmma"
    return out


flash_partial.launches = 0
flash_partial.wgmma_launches = 0  # of them, on csrc/flash_fwd_wgmma.cu


def _launch_partial(q, k, v, q_offset, kv_offset, rows, causal, sm_scale,
                    window):
    """The partial kernel on checked CUDA tensors at ``rows``-row q tiles,
    uncounted, as :func:`_launch_forward`."""
    b, hq, s_len, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    route = fwd_route(bf16, d)
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty(q.shape, **f32)
    m = torch.empty((b, hq, s_len), **f32)
    l = torch.empty((b, hq, s_len), **f32)
    lib = _build.library()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, hq, k.shape[1], s_len, k.shape[2],
            d, int(causal), 0 if window is None else int(window),
            int(q_offset), int(kv_offset), float(sm_scale))
    if rows not in q_heights(d):
        raise ValueError(f"no {rows}-row q tiles at head_dim {d}")
    if route == "wgmma":
        err = lib.sw_flash_partial_wgmma(*head, _build.stream_ptr(q))
    else:
        err = lib.sw_flash_partial(*head, int(bf16), rows,
                                   _build.stream_ptr(q))
    _build.check(err, "flash_partial")
    return o, m, l


def flash_partial_bwd_reference(q, do, k, v, lse, delta, q_offset: int,
                                kv_offset: int, *, causal: bool = True,
                                sm_scale: Optional[float] = None,
                                window: Optional[int] = None):
    """The ring step's backward in plain PyTorch, on any device (the JAX
    package's ``_step_bwd``, with the kernels' rounding points): float32
    ``(dq, dk, dv)``, dk/dv grouped."""
    _check_args(q, k, v, causal, window)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    return _backward_plain(q, k, v, do, lse, delta, causal, window, sm_scale,
                           q_offset, kv_offset)


def flash_partial_bwd(q, do, k, v, lse, delta, q_offset: int, kv_offset: int,
                      *, causal: bool = True,
                      sm_scale: Optional[float] = None,
                      window: Optional[int] = None):
    """One ring step's gradient contributions ``(dq, dk, dv)``, float32,
    dk/dv grouped ``[B, Hkv, Tkv, D]``, from the *globally merged* ``lse``
    and ``delta = rowsum(dO * O)`` (``[B, Hq, T]`` float32): with global
    statistics each step's contribution is its slice of the full gradient,
    so the contributions sum across the ring.  CUDA tensors launch both
    backward kernels (:func:`bwd_route`'s) with float32 outputs, counted
    as one launch of this wrapper; CPU tensors take
    :func:`flash_partial_bwd_reference`."""
    _check_args(q, k, v, causal, window)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return flash_partial_bwd_reference(q, do, k, v, lse, delta, q_offset,
                                           kv_offset, causal=causal,
                                           sm_scale=sm_scale, window=window)
    _check_bwd(q, k, v, do, lse, delta, "flash_partial_bwd")
    launch, route = _bwd_launcher(q, k, v, do, lse, delta, causal, window,
                                  sm_scale, q_offset, kv_offset)
    dk, dv = _dkv(launch, k, q.shape[1] // k.shape[1], torch.float32)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    launch("dq", (dq.data_ptr(),), True)
    flash_partial_bwd.launches += 1
    flash_partial_bwd.wgmma_launches += route == "wgmma"
    return dq, dk, dv


flash_partial_bwd.launches = 0
flash_partial_bwd.wgmma_launches = 0  # of them, on csrc/flash_bwd_wgmma.cu
