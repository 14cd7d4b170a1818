"""Symmetric int8 quantization for the KV cache and the matmul weights.

KV cache: each cached ``[head_dim]`` vector ``x`` is stored as
``q = round(x / s)`` with ``s = max(|x|) / 127`` (``s`` float32, ``q``
int8), per token and head.  The decode kernel (ops/decode.py) streams the
int8 blocks and folds the scales into its algebra.

Weights (W8A16): ``w [..., D, F]`` is stored as int8 with one float32 scale
per OUTPUT channel; the scale commutes with the product
(``(x @ q) * s == x @ (q * s)``), so the int8 GEMV kernel (ops/gemv.py)
applies it after the product and never builds a wide weight.

``torch.round`` rounds half to even, so the codes equal those of any other
round-half-to-even implementation on the same float32 inputs.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0


def quantize_kv(x: torch.Tensor):
    """Quantize along the last axis: ``x [..., D]`` -> ``(q int8 [..., D],
    scale f32 [...])`` with ``x ~= q * scale[..., None]``.  All-zero
    vectors get scale 0 and quantize to zeros, so padding stays inert."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / INT8_MAX
    div = torch.where(scale > 0.0, scale, torch.ones_like(scale))[..., None]
    q = torch.clamp(torch.round(xf / div), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (up to rounding)."""
    return (q.float() * scale[..., None]).to(dtype)


def quantize_weight(w: torch.Tensor) -> dict:
    """Weight-only int8, symmetric per output channel: ``w [..., D, F]`` ->
    ``{"q": int8 same shape, "s": f32 [..., F]}`` with ``w ~= q * s``.
    Leading axes (the stacked-layer dim) are batch dims of the scheme,
    quantized one slice at a time so the float32 scratch is one layer's."""
    if w.dim() > 2:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.float32,
                        device=w.device)
        for i, part in enumerate(w):
            one = quantize_weight(part)
            q[i], s[i] = one["q"], one["s"]
        return {"q": q, "s": s}
    wf = w.float()
    scale = wf.abs().amax(dim=-2) / INT8_MAX
    div = torch.where(scale > 0.0, scale, torch.ones_like(scale))[..., None, :]
    q = torch.clamp(torch.round(wf / div), -INT8_MAX, INT8_MAX)
    return {"q": q.to(torch.int8), "s": scale}


# The matmul weights of the Llama tree (models/llama.py:init_params): every
# leaf consumed as ``x @ w``.  embed stays wide (a gather, not a matmul);
# norms are vectors.
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_params(params: dict) -> dict:
    """Weight-only int8 serving tree: every matmul weight of a dense Llama
    parameter tree becomes a ``{"q", "s"}`` pair; embed, norms and biases
    stay as they are.  The tree is for inference only: it flows through
    forward, prefill, decode and serving via models/llama.py:matmul_w."""
    layers = params["layers"]
    if "moe" in layers:
        raise NotImplementedError(
            "quantize_params covers dense models; MoE expert weights are "
            "not wired for weight-only int8")
    new_layers = dict(layers)
    for name in _MATMUL_LEAVES:
        if name in new_layers:
            new_layers[name] = quantize_weight(new_layers[name])
    out = dict(params)
    out["layers"] = new_layers
    out["lm_head"] = quantize_weight(params["lm_head"])
    return out
