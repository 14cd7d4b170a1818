"""Flash-attention forward: the hand-written CUDA kernel
(csrc/flash_fwd.cu) and its plain PyTorch version.

Layouts: ``q [B, Hq, S, D]``, ``k/v [B, Hkv, Skv, D]`` (grouped kv is
taken as it is; query head h reads kv head ``h // n_rep``).  The forward
returns the output and the row log-sum-exp ``lse [B, Hq, S]`` float32, the
primal output a backward pass will save.  There is no backward yet:
:func:`flash_attention` refuses inputs that ask for a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import NEG_BIG, repeat_kv

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's compiled head sizes


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
    s_len, kv_len = q.shape[2], k.shape[2]
    if causal:
        qp = torch.arange(s_len, device=q.device)[:, None]
        kp = torch.arange(kv_len, device=q.device)[None, :]
        mask = qp >= kp
        if window is not None:
            mask = mask & (kp > qp - window)
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
    b, hq, s_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bfloat16 or float32, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not compiled; the kernel takes "
                         f"{HEAD_DIMS}")
    for x in (q, k, v):
        if x.device != q.device:
            raise ValueError(f"tensor on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError("flash_forward needs contiguous tensors")
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


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None):
    """Flash attention, forward only: the output of :func:`flash_forward`.
    Raises for inputs that require a gradient (the backward kernels come
    with the training path)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet (the flash backward "
            "kernels are queued in ROADMAP.md); call it under "
            "torch.no_grad() or on tensors that do not require grad")
    return flash_forward(q, k, v, causal=causal, sm_scale=sm_scale,
                         window=window)[0]
