"""KV-cache inference for the Llama family: prefill, single-token decode,
sampling and ``generate``.

The cache holds ``max_len`` slots per layer, stacked like the parameters:
``k/v [n_layers, B, Hkv, max_len, head_dim]`` (int8 caches add float32
``k_scale/v_scale [n_layers, B, Hkv, max_len]``).  Attention masks by
position, so every step has the same shapes.  Decode writes each new
entry into the cache IN PLACE: the dict passed in is updated and returned.

A write position past the end of the cache is clamped to the last slot,
never wrapped and never an error; a dead serving slot with a frozen cursor
writes there harmlessly (models/serving.py).

Only the dense, non-rolling path is ported: rolling (sliding-window
circular) caches raise ``NotImplementedError`` until their slice lands.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.attention import NEG_BIG, repeat_kv
from .llama import (LlamaConfig, apply_rope, cfg_rope_tables, embed_tokens,
                    forward, layer_params, matmul_w, mlp_gate_act,
                    params_device, qkv_proj, resolve_longrope, rmsnorm)

_ROLLING_TODO = ("rolling (sliding-window circular) caches are not ported "
                 "yet (ROADMAP.md, Queue 1: rolling and prefix paths)")


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zeroed decode cache: ``k/v [n_layers, B, Hkv, max_len, head_dim]``
    in the compute dtype, or int8 plus float32 ``k_scale/v_scale`` when
    ``cfg.kv_quant == "int8"`` (the scale keys mark the format)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dev = torch.device(device)
    if cfg.kv_quant == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev),
        }
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}


def _attend_cached(q, k_cache, v_cache, pos, n_rep, window=None,
                   k_scale=None, v_scale=None):
    """Attention of ``q [B, Hq, C, D]`` over caches ``[B, Hkv, T, D]``: row
    b's queries sit at ``pos[b] .. pos[b] + C - 1`` (``pos`` scalar or
    [B]) and mask keys above themselves and, with ``window``, below the
    window.  int8 caches carry ``k_scale``/``v_scale`` [B, Hkv, T].

    On CUDA the decode kernel (ops/decode.py) reads the grouped cache once;
    on the CPU the cache is dequantized, expanded with ``repeat_kv`` and
    attended with a float32 softmax."""
    if q.is_cuda:
        from ..ops.decode import decode_attention

        return decode_attention(q, k_cache, v_cache, pos, window=window,
                                k_scale=k_scale, v_scale=v_scale)
    if k_scale is not None:
        from ..ops.quantize import dequantize_kv

        k_cache = dequantize_kv(k_cache, k_scale, q.dtype)
        v_cache = dequantize_kv(v_cache, v_scale, q.dtype)
    k = repeat_kv(k_cache, n_rep)
    v = repeat_kv(v_cache, n_rep)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s / (q.shape[-1] ** 0.5)
    kv_pos = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    qp = (torch.as_tensor(pos, device=q.device).reshape(-1)[:, None, None, None]
          + torch.arange(q.shape[2], device=q.device)[None, None, :, None])
    keep = kv_pos <= qp
    if window is not None:
        keep = keep & (kv_pos > qp - window)
    s = torch.where(keep, s, torch.full_like(s, NEG_BIG))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def decode_step(params: dict, cache: dict, token, pos, cfg: LlamaConfig,
                rope=None, rolling: bool = False):
    """One token in, next-token logits out.  ``token`` [B] ints; ``pos``
    the absolute position of ``token``: an int (aligned batch) or a [B]
    tensor (ragged batch, each row at its own cursor).  Writes the new k/v
    into ``cache`` in place and returns ``(logits [B, V] float32,
    cache)``."""
    if rolling:
        raise NotImplementedError(_ROLLING_TODO)
    if cfg.n_experts > 0:
        raise NotImplementedError("mixture-of-experts decode is not ported "
                                  "yet (ROADMAP.md)")
    T = cache["k"].shape[3]
    dev = token.device
    if rope is None:
        rope = cfg_rope_tables(cfg, T, device=dev)
    cos, sin = rope
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        pos = pos.to(device=dev, dtype=torch.int32)
        p_long = pos.long()
        slot = p_long.clamp(0, T - 1)
        ri = p_long.clamp(0, cos.shape[0] - 1)
        cos_p = cos[ri][:, None, None, :]
        sin_p = sin[ri][:, None, None, :]
        rows = torch.arange(token.shape[0], device=dev)

        def write(c, u):  # c [B, Hkv, T(, D)], u [B, Hkv, 1(, D)]
            c[rows, :, slot] = u[:, :, 0]
    else:
        pos = int(pos)
        s0 = min(max(pos, 0), T - 1)
        r0 = min(max(pos, 0), cos.shape[0] - 1)
        cos_p, sin_p = cos[r0:r0 + 1], sin[r0:r0 + 1]

        def write(c, u):
            c[:, :, s0:s0 + 1] = u

    def attend(q, lc):
        return _attend_cached(q, lc["k"], lc["v"], pos, n_rep,
                              window=cfg.sliding_window,
                              k_scale=lc.get("k_scale"),
                              v_scale=lc.get("v_scale"))

    h = embed_tokens(params, token, cfg)[:, None, :]  # [B, 1, D]
    h, cache = cached_layer_scan(params, cache, h, cos_p, sin_p, cfg, write,
                                 attend)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = matmul_w(h[:, 0, :], params["lm_head"]).float()
    return logits, cache


def cached_layer_scan(params, cache, h, cos_p, sin_p, cfg: LlamaConfig,
                      write, attend):
    """The per-layer body of every cached decode path: qkv projection,
    RoPE, quantize-on-write for an int8 cache, ``write(c, u)`` of each new
    entry at the caller's cursor(s) into the layer's cache (in place),
    ``attend(q, layer_cache)``, then the FFN.  ``h [B, C, D]``; returns
    ``(h, cache)``."""
    B, C = h.shape[0], h.shape[1]
    quant = "k_scale" in cache
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        lc = {name: t[li] for name, t in cache.items()}
        x = rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = qkv_proj(x, lp, cfg)
        q = apply_rope(q, cos_p, sin_p)
        k = apply_rope(k, cos_p, sin_p)
        if quant:
            from ..ops.quantize import quantize_kv

            k, k_s = quantize_kv(k)
            v, v_s = quantize_kv(v)
            write(lc["k_scale"], k_s)
            write(lc["v_scale"], v_s)
        write(lc["k"], k)
        write(lc["v"], v)
        o = attend(q, lc)
        o = o.transpose(1, 2).reshape(B, C, cfg.n_heads * cfg.head_dim)
        h = h + matmul_w(o, lp["wo"])
        x = rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
        gate = mlp_gate_act(matmul_w(x, lp["w_gate"]), cfg).to(x.dtype)
        h = h + matmul_w(gate * matmul_w(x, lp["w_up"]), lp["w_down"])
    return h, cache


def prefill(params: dict, cfg: LlamaConfig, prompt,
            max_len: Optional[int] = None, attn_fn=None,
            logit_positions=None):
    """One forward pass over the whole prompt -> the decode state.

    Returns ``(next_logits [B, V], cache)``; the cache holds the post-RoPE
    grouped k/v of positions ``0..P-1``, zero-padded to ``max_len``.
    ``logit_positions`` ([B] ints, right-padded ragged batches) takes each
    row's logits from its own position instead of the last column."""
    B, P = prompt.shape
    if max_len is None:
        max_len = P
    elif max_len < P:
        raise ValueError(f"max_len={max_len} is smaller than the prompt ({P})")
    logits, (ks, vs) = forward(
        params, prompt, cfg, attn_fn, return_kv=True,
        last_only=logit_positions is None, logit_positions=logit_positions)
    cache = {"k": ks, "v": vs}
    if cfg.kv_quant == "int8":
        from ..ops.quantize import quantize_kv

        cache["k"], cache["k_scale"] = quantize_kv(ks)
        cache["v"], cache["v_scale"] = quantize_kv(vs)
    pad = max_len - P
    if pad:
        # Every leaf's T axis sits at index 3.
        cache = {name: F.pad(a, (0, 0, 0, pad) if a.dim() == 5 else (0, pad))
                 for name, a in cache.items()}
    return logits[:, 0], cache


def prefill_rolling(*args, **kwargs):
    """Chunked O(window) prefill into a rolling cache: not ported yet."""
    raise NotImplementedError(_ROLLING_TODO)


def validate_prompt_lengths(prompt_lengths, B: int, P: int) -> torch.Tensor:
    """The ragged-batch lengths contract: [B] ints in [1, P].  Returns them
    as an int64 CPU tensor."""
    lengths = torch.as_tensor(prompt_lengths).long().cpu()
    if lengths.shape != (B,):
        raise ValueError(f"prompt_lengths must be [{B}], got "
                         f"{tuple(lengths.shape)}")
    if bool((lengths < 1).any()) or bool((lengths > P).any()):
        raise ValueError(
            f"prompt_lengths must be in [1, {P}]; got {lengths.tolist()}")
    return lengths


def _filter_logits(logits, temperature: float, top_k: Optional[int],
                   top_p: Optional[float]):
    """The sampling distribution's logits: temperature-scaled, then top-k /
    nucleus masked (NEG_BIG outside the kept set).  Only meaningful for
    ``temperature > 0``."""
    l = logits / temperature
    neg = torch.full_like(l, NEG_BIG)
    if top_k is not None and top_k < l.shape[-1]:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, neg, l)
    if top_p is not None and top_p < 1.0:
        srt = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p  # exclusive prefix mass; index 0 stays
        thresh = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                             ).amin(dim=-1, keepdim=True)
        l = torch.where(l < thresh, neg, l)
    return l


def _sample(logits, generator: Optional[torch.Generator], temperature: float,
            top_k: Optional[int], top_p: Optional[float]):
    """One token id per row of ``logits [B, V]``: temperature 0 is greedy
    (argmax, the first maximum wins); otherwise a draw from the filtered
    distribution with ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(params: dict, cfg: LlamaConfig, prompt, max_new_tokens: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None, top_k: Optional[int] = None,
             top_p: Optional[float] = None, prompt_lengths=None,
             eos_id: Optional[int] = None, return_logprobs: bool = False):
    """Autoregressive generation on the device of ``params``.  prompt:
    [B, P] ints.

    Aligned batch (default): returns ``[B, P + max_new_tokens]`` (prompt +
    continuation).  Ragged batch: pass ``prompt_lengths`` ([B], right-padded
    prompt); every row decodes from its own length and only the new tokens
    ``[B, max_new_tokens]`` are returned.  temperature 0 is greedy,
    otherwise sampling with ``generator`` (top-k / top-p optional).
    ``eos_id``: a row that emits it keeps emitting it.  ``return_logprobs``
    also returns each emitted token's unfiltered model logprob (0.0 at
    eos-fill positions).
    """
    dev = params_device(params)
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, P = prompt.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    total = P + max_new_tokens
    if max_len is None:
        max_len = total
    elif max_len < total:
        raise ValueError(
            f"max_len={max_len} is smaller than prompt + max_new_tokens={total}")
    cfg = resolve_longrope(cfg, max_len)
    if cfg.n_experts > 0:
        raise NotImplementedError("mixture-of-experts generation is not "
                                  "ported yet (ROADMAP.md)")
    ragged = prompt_lengths is not None
    if (not ragged and cfg.sliding_window is not None
            and cfg.sliding_window < max_len):
        raise NotImplementedError(_ROLLING_TODO)
    rope = cfg_rope_tables(cfg, max_len, device=dev)
    if ragged:
        lengths = validate_prompt_lengths(prompt_lengths, B, P).to(dev)
        logits, small = prefill(params, cfg, prompt, max_len,
                                logit_positions=lengths - 1)
        pos = lengths.int()
    else:
        logits, small = prefill(params, cfg, prompt, max_len)
        pos = P
    cache = small
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    toks, lps = [], []
    for i in range(max_new_tokens):
        tok = _sample(logits, generator, temperature, top_k, top_p)
        if return_logprobs:
            lp = torch.log_softmax(logits, dim=-1).gather(
                -1, tok[:, None])[:, 0]
        else:
            lp = torch.zeros(B, dtype=torch.float32, device=dev)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            lp = torch.where(done, torch.zeros_like(lp), lp)
            done = done | (tok == eos_id)
        toks.append(tok)
        lps.append(lp)
        if i + 1 < max_new_tokens:
            logits, cache = decode_step(params, cache, tok, pos, cfg, rope)
            pos = pos + 1
    new = torch.stack(toks, dim=1)
    out = new if ragged else torch.cat([prompt, new], dim=1)
    if return_logprobs:
        return out, torch.stack(lps, dim=1)
    return out
