"""Flash attention, forward and backward: the hand-written CUDA kernels
(csrc/flash_fwd.cu, csrc/flash_bwd.cu) and their plain PyTorch versions.

Layouts: ``q [B, Hq, S, D]``, ``k/v [B, Hkv, Skv, D]`` (grouped kv is
taken as it is; query head h reads kv head ``h // n_rep``).  The forward
returns the output and the row log-sum-exp ``lse [B, Hq, S]`` float32; the
backward recomputes the probabilities from that lse in two passes (dK/dV
kv-stationary, dQ q-stationary).  :func:`flash_attention` is
differentiable through a ``torch.autograd.Function`` whose backward is the
two kernels, as the JAX package's ``custom_vjp`` is.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import NEG_BIG, repeat_kv

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
    a compiled head size."""
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


def _mask(s_len, kv_len, causal, window, device):
    """[S, Skv] visibility, or None when every key is visible."""
    if not causal:
        return None
    qp = torch.arange(s_len, device=device)[:, None]
    kp = torch.arange(kv_len, device=device)[None, :]
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
    (csrc/flash_fwd.cu), CPU tensors take :func:`flash_forward_reference`.
    """
    _check_args(q, k, v, causal, window)
    if not q.is_cuda:
        return flash_forward_reference(q, k, v, causal=causal,
                                       sm_scale=sm_scale, window=window)
    _check_kernel_args((q, k, v), "flash_forward")
    b, hq, s_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s_len), dtype=torch.float32, device=q.device)
    err = _build.library().sw_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, hq, hkv, s_len, kv_len, d, int(causal),
        0 if window is None else int(window), float(sm_scale),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(err, "flash_forward")
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


# ------------------------------------------------------------------ backward


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
    b, hq, s_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    kx = repeat_kv(k, n_rep).float()
    vx = repeat_kv(v, n_rep).float()
    qf, dof = q.float(), do.float()
    s = torch.matmul(qf, kx.transpose(-1, -2)) * sm_scale
    p = torch.exp(s - lse.float()[..., None])
    mask = _mask(s_len, kv_len, causal, window, q.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    delta = (dof * o.float()).sum(dim=-1)
    dp = torch.matmul(dof, vx.transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    ds_r = ds.to(q.dtype).float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds_r.transpose(-1, -2), qf) * sm_scale
    dq = torch.matmul(ds_r, kx) * sm_scale

    def group(x):  # [B, Hq, Skv, D] -> [B, Hkv, Skv, D], summed per kv head
        return x.reshape(b, hkv, n_rep, kv_len, d).sum(dim=2)

    return dq.to(q.dtype), group(dk).to(k.dtype), group(dv).to(v.dtype)


def _bwd_args(q, k, v, do, lse, delta, causal, window, sm_scale, q_offset,
              kv_offset):
    b, hq, s_len, d = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr()), (
        b, hq, k.shape[1], s_len, k.shape[2], d, int(causal),
        0 if window is None else int(window), int(q_offset), int(kv_offset),
        float(sm_scale), int(q.dtype == torch.bfloat16), _build.stream_ptr(q))


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
                       sm_scale: float, window: Optional[int] = None,
                       q_offset: int = 0, kv_offset: int = 0):
    """Pass A of the backward on CUDA tensors: ``(dk, dv)`` in k's dtype,
    from ``lse`` and ``delta = rowsum(dO * O)`` (both ``[B, Hq, S]``
    float32).  ``q_offset``/``kv_offset`` are the global positions of the
    first q row and key (0 for plain attention)."""
    _check_bwd(q, k, v, do, lse, delta, "flash_backward_dkv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs, rest = _bwd_args(q, k, v, do, lse, delta, causal, window, sm_scale,
                           q_offset, kv_offset)
    err = _build.library().sw_flash_bwd_dkv(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *rest)
    _build.check(err, "flash_backward_dkv")
    flash_backward_dkv.launches += 1
    return dk, dv


flash_backward_dkv.launches = 0


def flash_backward_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                      sm_scale: float, window: Optional[int] = None,
                      q_offset: int = 0, kv_offset: int = 0):
    """Pass B of the backward on CUDA tensors: ``dq`` in q's dtype; the
    arguments are pass A's."""
    _check_bwd(q, k, v, do, lse, delta, "flash_backward_dq")
    dq = torch.empty_like(q)
    ptrs, rest = _bwd_args(q, k, v, do, lse, delta, causal, window, sm_scale,
                           q_offset, kv_offset)
    err = _build.library().sw_flash_bwd_dq(*ptrs, dq.data_ptr(), *rest)
    _build.check(err, "flash_backward_dq")
    flash_backward_dq.launches += 1
    return dq


flash_backward_dq.launches = 0


def flash_backward(q, k, v, o, lse, do, *, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   window: Optional[int] = None):
    """Gradients ``(dq, dk, dv)`` of flash attention from the forward's
    ``o`` and ``lse`` and the output gradient ``do``.  CUDA tensors launch
    the two kernels (csrc/flash_bwd.cu) after one float32 reduction for
    ``delta``; CPU tensors take :func:`flash_backward_reference`."""
    _check_args(q, k, v, causal, window)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return flash_backward_reference(q, k, v, o, lse, do, causal=causal,
                                        sm_scale=sm_scale, window=window)
    delta = (do.float() * o.float()).sum(dim=-1)
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
