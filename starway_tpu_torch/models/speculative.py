"""Multi-token ingestion at decode-path semantics: ``chunk_decode_step``.

The dense server's prefix admission ingests a suffix through it
(models/serving.py).  The speculative drafting and prompt-lookup loops
that also build on it are not ported yet (ROADMAP.md, Queue 1 item 10).
"""

from __future__ import annotations

import torch

from .generate import _attend_cached, cached_layer_scan
from .llama import LlamaConfig, embed_tokens, matmul_w, rmsnorm


def chunk_decode_step(params, cache, tokens, pos, cfg: LlamaConfig, rope):
    """``C`` tokens in, ``C`` next-token logits out: the multi-token form
    of :func:`~starway_tpu_torch.models.generate.decode_step` (C=1 reduces
    to it).

    ``tokens [B, C]`` ints at absolute positions ``pos .. pos + C - 1``
    (``pos`` an int or a per-row ``[B]`` tensor).  Write-then-attend: the
    chunk's k/v (quantized for an int8 cache) are written into ``cache``
    in place first, then the chunk attends through the cache with per-row
    position masks, so in-chunk causality follows from the positions.  A
    write that would run past the cache starts at ``T - C`` instead, as
    JAX's ``dynamic_update_slice`` clamps it.  Returns ``(logits [B, C, V]
    float32, cache)``.

    A cache of exactly ``cfg.sliding_window`` slots is a rolling cache,
    whose modular slots absolute positions cannot address, and is refused;
    allocate a full cache (``max_len = window + C`` costs nothing, as
    positions past the window are masked)."""
    B, C = tokens.shape
    T = cache["k"].shape[3]
    if cfg.sliding_window is not None and T == cfg.sliding_window:
        raise ValueError(
            f"chunk_decode_step does not support rolling caches: got a "
            f"{T}-slot cache == cfg.sliding_window, which is a rolling "
            f"cache's layout; allocate a full cache (max_len != "
            f"sliding_window) for multi-token ingestion")
    if cfg.n_experts > 0:
        raise NotImplementedError("mixture-of-experts decode is not ported "
                                  "yet (ROADMAP.md)")
    dev = tokens.device
    n_rep = cfg.n_heads // cfg.n_kv_heads
    cos, sin = rope
    pos_b = torch.as_tensor(pos, dtype=torch.long, device=dev).reshape(-1)
    pos_b = pos_b.expand(B)
    pos_bc = pos_b[:, None] + torch.arange(C, device=dev)[None, :]  # [B, C]
    ri = pos_bc.clamp(0, cos.shape[0] - 1)
    cos_p = cos[ri][:, None]  # [B, 1, C, hd/2]
    sin_p = sin[ri][:, None]
    slots = pos_b.clamp(0, T - C)[:, None] + torch.arange(C, device=dev)
    rows = torch.arange(B, device=dev)[:, None]

    def write(c, u):
        # c [B, Hkv, T(, D)], u [B, Hkv, C(, D)]: the index pair selects
        # [B, C, Hkv(, D)].
        c[rows, :, slots] = u.transpose(1, 2)

    def attend(q, lc):
        return _attend_cached(q, lc["k"], lc["v"], pos_b.int(), n_rep,
                              window=cfg.sliding_window,
                              k_scale=lc.get("k_scale"),
                              v_scale=lc.get("v_scale"))

    h = embed_tokens(params, tokens, cfg)  # [B, C, D]
    h, cache = cached_layer_scan(params, cache, h, cos_p, sin_p, cfg, write,
                                 attend)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return matmul_w(h, params["lm_head"]).float(), cache
