"""Beam-search decoding.

K beams of every row advance together through ``decode_step``, the cache
laid out as ``[L, B * K, ...]`` rows (beam k of row b is row ``b * K +
k``), so the decode kernel, int8 caches and W8A16 weights serve beams as
they serve a batch.  Each step keeps the K best of the K * V extensions
of every row, and the surviving beams gather their parents' cache rows:
a copy of the whole K-way cache a step, the price of exact beam search.
Latency-bound serving wants ``generate()`` or the speculative decoders.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import NEG_BIG
from .generate import decode_step, prefill
from .llama import (LlamaConfig, cfg_rope_tables, params_device,
                    resolve_longrope, top_k_stable)


def generate_beam(params: dict, cfg: LlamaConfig, prompt,
                  max_new_tokens: int, *, beams: int = 4,
                  eos_id: Optional[int] = None,
                  max_len: Optional[int] = None, return_all: bool = False):
    """Beam-search generation.  prompt ``[B, P]``; K = ``beams``.

    Returns ``[B, P + max_new_tokens]``: each row's highest-scoring beam
    (the sum of its tokens' logprobs).  A beam that emits ``eos_id`` keeps
    its score and continues only with eos, competing at that score.
    ``return_all=True`` returns ``(sequences [B, K, max_new], scores [B,
    K], finished [B, K])``, score-sorted per row; every score is the
    teacher-forced sum of its beam's logprobs up to and including its
    first eos.  ``beams=1`` is greedy ``generate()``.

    The cache is full (``max_len`` slots, default ``P + max_new_tokens``);
    a sliding-window model attends through it with the window mask."""
    dev = params_device(params)
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, P = prompt.shape
    K = int(beams)
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if K < 1:
        raise ValueError(f"beams must be >= 1, got {beams}")
    if K > cfg.vocab_size:
        raise ValueError(f"beams={beams} exceeds the vocab ({cfg.vocab_size})")
    total = P + max_new_tokens
    if max_len is None:
        max_len = total
    elif max_len < total:
        raise ValueError(
            f"max_len={max_len} is smaller than prompt + max_new_tokens="
            f"{total}")
    cfg = resolve_longrope(cfg, max_len)  # one rope regime for the run
    rope = cfg_rope_tables(cfg, max_len, device=dev)
    logits, cache = prefill(params, cfg, prompt, max_len)
    logp = torch.log_softmax(logits, dim=-1)  # [B, V]
    V = logp.shape[-1]
    # K beams a row from its K best first tokens (distinct), the prompt's
    # cache rows repeated K ways.
    scores, tok = top_k_stable(logp, K)
    cache = {name: a.repeat_interleave(K, dim=1) for name, a in cache.items()}
    fin = (torch.zeros((B, K), dtype=torch.bool, device=dev)
           if eos_id is None else tok == eos_id)
    out = torch.zeros((B, K, max_new_tokens), dtype=torch.long, device=dev)
    out[:, :, 0] = tok
    base = torch.arange(B, device=dev)[:, None] * K
    if eos_id is not None:
        frozen = torch.full((V,), NEG_BIG, device=dev)
        frozen[eos_id] = 0.0
    for i in range(max_new_tokens - 1):
        logits, cache = decode_step(params, cache, tok.reshape(B * K), P + i,
                                    cfg, rope)
        logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
        if eos_id is not None:
            # A finished beam continues only as itself, at no added cost.
            logp = torch.where(fin[:, :, None], frozen, logp)
        scores, flat = top_k_stable((scores[:, :, None] + logp
                                     ).reshape(B, K * V), K)
        parent, tok = flat // V, flat % V
        out = out.gather(1, parent[:, :, None].expand_as(out))
        fin = fin.gather(1, parent)
        if eos_id is not None:
            fin = fin | (tok == eos_id)
        out[:, :, i + 1] = tok
        # Every cache leaf follows its beam's parent (the int8 scales too).
        rows = (base + parent).reshape(B * K)
        cache = {name: a.index_select(1, rows) for name, a in cache.items()}
    if return_all:
        return out, scores, fin
    return torch.cat([prompt, out[:, 0]], dim=1)

