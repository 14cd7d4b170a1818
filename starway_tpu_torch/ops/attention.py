"""Attention building blocks in plain PyTorch: online-softmax partials and
the blockwise and materialised attention oracles.

These are the reference versions every attention kernel of the package is
held against (ops/decode.py, ops/flash.py), and the attention that runs on
the CPU.  The algebra is the flash/ring-attention one: a kv block yields an
*unnormalised* output ``o = exp(s - m) @ v`` with row statistics
``(m = rowmax(s), l = rowsum(exp(s - m)))``, and partials merge
associatively with :func:`merge_partials`.

Layout convention: ``q, k, v: [batch, heads, seq, head_dim]``.  Scores and
row statistics are float32 whatever the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_BIG = -0.9e30  # mask fill; avoids -inf NaN traps in exp/max chains


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand grouped KV heads to match query heads (GQA): kv head ``h``
    serves query heads ``h * n_rep .. h * n_rep + n_rep - 1``."""
    if n_rep == 1:
        return x
    b, h, t, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, t, d).reshape(b, h * n_rep, t, d)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q @ k^T`` accumulated in float32 (inputs widen exactly)."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``p @ v`` with ``p`` rounded to ``v``'s dtype first, float32 result."""
    return torch.matmul(p.to(v.dtype).float(), v.float())


def partial_attention(q, k, v, *, q_offset: int = 0, kv_offset: int = 0,
                      causal: bool = False, kv_limit: Optional[int] = None,
                      sm_scale: Optional[float] = None,
                      window: Optional[int] = None,
                      kv_min: Optional[int] = None):
    """Attention of ``q`` against one kv block, in mergeable partial form.

    Returns ``(o, m, l)``: unnormalised output ``[B,H,Tq,D]``, row max
    ``[B,H,Tq]`` and row sum ``[B,H,Tq]``, all float32.  ``q_offset`` and
    ``kv_offset`` are the global positions of the first query and key;
    ``kv_limit`` masks key positions at or beyond it (padding), ``kv_min``
    those below it.  ``window`` (requires ``causal``) keeps
    ``kv_pos in (q_pos - window, q_pos]``.
    """
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if window is not None and not causal:
        raise ValueError("window requires causal attention")
    dev = q.device
    s = _scores(q, k) * sm_scale
    kv_pos = kv_offset + torch.arange(k.shape[2], device=dev)
    mask = torch.ones((q.shape[2], k.shape[2]), dtype=torch.bool, device=dev)
    if causal:
        q_pos = q_offset + torch.arange(q.shape[2], device=dev)
        mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
    if kv_limit is not None:
        mask = mask & (kv_pos < kv_limit)[None, :]
    if kv_min is not None:
        mask = mask & (kv_pos >= kv_min)[None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_BIG))
    m = s.amax(dim=-1)
    # Rows with no visible key: exp(s - m) would be exp(0) = 1; zero them.
    p = torch.where(s > NEG_BIG / 2, torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    return _pv(p, v), m, l


def merge_partials(a, b):
    """Associatively merge two attention partials over the same queries."""
    o_a, m_a, l_a = a
    o_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    sa = torch.exp(m_a - m)
    sb = torch.exp(m_b - m)
    l = l_a * sa + l_b * sb
    o = o_a * sa[..., None].to(o_a.dtype) + o_b * sb[..., None].to(o_b.dtype)
    return o, m, l


def zero_partial(q):
    """Identity element for :func:`merge_partials` over queries shaped like
    ``q``; the accumulators are float32 whatever the compute dtype."""
    b, h, tq, d = q.shape
    return (torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, tq), NEG_BIG, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, tq), dtype=torch.float32, device=q.device))


def finalize_partial(o, m, l, out_dtype=None):
    """Normalise a merged partial into the attention output."""
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.to(out_dtype) if out_dtype is not None else out


def blockwise_attention(q, k, v, *, causal: bool = False, block_k: int = 512,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None):
    """Single-device flash-style attention: a loop over kv blocks with the
    online-softmax merge, never building the full ``[Tq, Tkv]`` matrix.
    Grouped kv (fewer kv heads than q heads) is expanded here.  Returns
    the output in ``q``'s dtype."""
    if k.shape[1] != q.shape[1]:
        n_rep = q.shape[1] // k.shape[1]
        k = repeat_kv(k, n_rep)
        v = repeat_kv(v, n_rep)
    tkv = k.shape[2]
    block_k = min(block_k, tkv)
    nblocks = (tkv + block_k - 1) // block_k
    pad = nblocks * block_k - tkv
    carry = zero_partial(q)
    for i in range(nblocks):
        off = i * block_k
        part = partial_attention(
            q, k[:, :, off:off + block_k], v[:, :, off:off + block_k],
            q_offset=0, kv_offset=off, causal=causal,
            kv_limit=tkv if pad else None, sm_scale=sm_scale, window=window)
        carry = merge_partials(carry, part)
    return finalize_partial(*carry, out_dtype=q.dtype)


def attention_reference(q, k, v, *, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None):
    """Plain materialised-softmax attention (test oracle); ``k``/``v`` carry
    as many heads as ``q``."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    s = _scores(q, k) * sm_scale
    if causal:
        tq, tkv = q.shape[2], k.shape[2]
        qp = torch.arange(tq, device=q.device)[:, None]
        kp = torch.arange(tkv, device=q.device)[None, :]
        mask = qp >= kp
        if window is not None:
            mask = mask & (kp > qp - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_BIG))
    elif window is not None:
        raise ValueError("window requires causal attention")
    p = torch.softmax(s, dim=-1)
    return _pv(p, v).to(v.dtype)
