"""Int8-weight matmul (W8A16): the hand-written CUDA kernel
(csrc/int8_gemv.cu) and its plain PyTorch version.

``x [M, D] @ (wq int8 [D, F] * scale f32 [F]) -> [M, F]`` in x's dtype,
accumulated in float32 with the per-column scale applied after the
product (ops/quantize.py:quantize_weight).
"""

from __future__ import annotations

import torch

from . import _build


def _check_args(x, wq, scale):
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"want x [M, D] and wq [D, F], got "
                         f"{tuple(x.shape)}, {tuple(wq.shape)}")
    if wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8, got {wq.dtype}")
    if scale.shape != (wq.shape[1],) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32 [{wq.shape[1]}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")


def int8_matmul_reference(x, wq, scale):
    """The kernel's function in plain PyTorch: ``(x @ wq) * scale`` in
    float32, cast to x's dtype."""
    _check_args(x, wq, scale)
    return ((x.float() @ wq.float()) * scale).to(x.dtype)


def int8_matmul(x, wq, scale):
    """``x [M, D] @ (wq int8 [D, F] * scale f32 [F]) -> [M, F]``.

    CUDA tensors launch the kernel (csrc/int8_gemv.cu), CPU tensors take
    :func:`int8_matmul_reference`."""
    _check_args(x, wq, scale)
    if not x.is_cuda:
        return int8_matmul_reference(x, wq, scale)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    for t in (x, wq, scale):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError("int8_matmul needs contiguous tensors")
    m, d = x.shape
    f = wq.shape[1]
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    vec = f % 16 == 0 and wq.data_ptr() % 16 == 0  # 16-byte weight loads
    err = _build.library().sw_int8_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), m, d,
        f, int(x.dtype == torch.bfloat16), int(vec), _build.stream_ptr(x))
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
