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

Sliding-window models also run on a rolling cache of exactly
``sliding_window`` slots (:func:`init_rolling_cache`): position ``p`` is
written to slot ``p % W``, so cache memory is O(window) for any length.
:func:`prefill_rolling` fills one chunk by chunk, and ``generate()`` takes
it for aligned batches whenever the window is shorter than ``max_len``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.attention import NEG_BIG, repeat_kv
from ..ops.quantize import dequantize_kv, quantize_kv
from .llama import (LlamaConfig, cfg_rope_tables, decoder_block,
                    embed_tokens, final_logits, forward, params_device,
                    resolve_longrope)
from .moe import require_dropless


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device="cuda", params=None) -> dict:
    """Zeroed decode cache: ``k/v [n_layers, B, Hkv, max_len, head_dim]``
    in the compute dtype, or int8 plus float32 ``k_scale/v_scale`` when
    ``cfg.kv_quant == "int8"`` (the scale keys mark the format).  For a
    sharded serving tree (``params``), each leaf is a models/sharded.py
    ``HeadSplit``: every slot's part holds its kv heads of its data
    group's rows."""
    from .sharded import shard_cache, tree_mesh

    mesh = None if params is None else tree_mesh(params)
    if mesh is not None:
        return shard_cache(cfg, params, batch, lambda c, rows: init_cache(
            c, rows, max_len, device=mesh.device))
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


def init_rolling_cache(cfg: LlamaConfig, batch: int, device="cuda",
                       params=None) -> dict:
    """O(window) cache for sliding-window models: ``sliding_window`` slots
    per layer, written modulo the window (``decode_step(rolling=True)``);
    per slot ``HeadSplit`` parts for a sharded tree (``params``), as
    :func:`init_cache`."""
    if cfg.sliding_window is None:
        raise ValueError("rolling caches require cfg.sliding_window")
    return init_cache(cfg, batch, cfg.sliding_window, device=device,
                      params=params)


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
    cache)``.

    ``rolling``: the cache is a circular window of exactly
    ``cfg.sliding_window`` slots (:func:`init_rolling_cache`); the entry
    goes to slot ``pos % W`` and attention covers every warm slot with the
    position clamped to ``W - 1`` and no window mask (the residents are
    the window; keys carry their absolute rope, and attention does not
    depend on the order of the keys).  Its rope tables must be passed:
    positions run past the cache.  A ``pos`` tensor is never read on the
    host.

    A tree over the data axes decodes each data group's rows on the
    group's slots (models/sharded.py ``data_groups``); every process gets
    the logits of the whole batch."""
    from .sharded import data_groups

    groups = data_groups(params, cfg)
    if groups is not None:
        def one(view, g, rows):
            p = pos[rows] if isinstance(pos, torch.Tensor) and pos.dim() else pos
            return decode_step(view, groups.cache_of(cache, g), token[rows],
                               p, cfg, rope, rolling)[0]

        return groups.run(token.shape[0], one, (cfg.vocab_size,)), cache
    T = cache["k"].shape[3]
    if rolling:
        if cfg.sliding_window is None or T != cfg.sliding_window:
            raise ValueError(
                f"rolling decode needs a cache of exactly sliding_window="
                f"{cfg.sliding_window} slots, got {T}")
        if rope is None:
            raise ValueError("rolling decode requires explicit rope tables")
    dev = token.device
    if rope is None:
        rope = cfg_rope_tables(cfg, T, device=dev)
    cos, sin = rope
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        pos = pos.to(device=dev, dtype=torch.int32)
        p_long = pos.long()
        slot = p_long % T if rolling else p_long.clamp(0, T - 1)
        ri = p_long.clamp(0, cos.shape[0] - 1)
        cos_p = cos[ri][:, None, None, :]
        sin_p = sin[ri][:, None, None, :]
        rows = torch.arange(token.shape[0], device=dev)
        seen = pos.clamp(max=T - 1) if rolling else pos

        def write(c, u):  # c [B, Hkv, T(, D)], u [B, Hkv, 1(, D)]
            c[rows, :, slot] = u[:, :, 0]
    else:
        pos = int(pos)
        s0 = pos % T if rolling else min(max(pos, 0), T - 1)
        r0 = min(max(pos, 0), cos.shape[0] - 1)
        cos_p, sin_p = cos[r0:r0 + 1], sin[r0:r0 + 1]
        seen = min(pos, T - 1) if rolling else pos

        def write(c, u):
            c[:, :, s0:s0 + 1] = u

    def attend(q, lc):
        return _attend_cached(q, lc["k"], lc["v"], seen, n_rep,
                              window=None if rolling else cfg.sliding_window,
                              k_scale=lc.get("k_scale"),
                              v_scale=lc.get("v_scale"))

    h = embed_tokens(params, token, cfg)[:, None, :]  # [B, 1, D]
    h, cache = cached_layer_scan(params, cache, h, cos_p, sin_p, cfg, write,
                                 attend)
    return final_logits(params, h[:, 0, :], cfg), cache


def cached_layer_scan(params, cache, h, cos_p, sin_p, cfg: LlamaConfig,
                      write, attend, attend_first: bool = False):
    """The per-layer body of every cached decode path: the model's decoder
    block (:func:`~starway_tpu_torch.models.llama.decoder_block`) whose
    attention quantizes each new entry for an int8 cache, writes it with
    ``write(c, u)`` at the caller's cursor(s) into the layer's cache (in
    place) and runs ``attend(q, layer_cache)``; with ``attend_first``,
    ``attend(q, layer_cache, k, v)`` runs before the write, on the new
    entries as computed (rolling admission, whose writes overwrite keys
    its own queries still see).  The FFN is dense, or the MoE's
    :func:`~starway_tpu_torch.models.moe.switch_moe` at the config's
    capacity over the ``B * C`` tokens of the step.  ``h [B, C, D]``;
    returns ``(h, cache)``.  A sharded tree runs each slot's heads
    against its part of the cache (models/sharded.py ``HeadSplit``) and,
    over ``"ep"``, its own experts (``serving_tree``)."""
    from .sharded import cache_parts, serving_tree

    tree = serving_tree(params, cfg)
    parts = {name: cache_parts(c) for name, c in cache.items()}
    quant = "k_scale" in cache

    def moe(xs, ms):
        return tree.moe(xs, ms, cfg, tree.moe_fn)

    def attend_slots(lcs):
        def run(qs, ks, vs):
            outs = []
            for q, k, v, lc in zip(qs, ks, vs, lcs):
                if attend_first:
                    outs.append(attend(q, lc, k, v))
                if quant:
                    k, k_s = quantize_kv(k)
                    v, v_s = quantize_kv(v)
                    write(lc["k_scale"], k_s)
                    write(lc["v_scale"], v_s)
                write(lc["k"], k)
                write(lc["v"], v)
                if not attend_first:
                    outs.append(attend(q, lc))
            return outs

        return run

    hs = [h] * tree.n
    for li in range(cfg.n_layers):
        lcs = [{name: p[j][li] for name, p in parts.items()}
               for j in range(tree.n)]
        hs = decoder_block(tree.layer(li), hs, cfg, cos_p, sin_p,
                           attend_slots(lcs), moe, tree.reduce)[0]
    return hs[0], cache


def prefill(params: dict, cfg: LlamaConfig, prompt,
            max_len: Optional[int] = None, attn_fn=None,
            logit_positions=None):
    """One forward pass over the whole prompt -> the decode state.

    Returns ``(next_logits [B, V], cache)``; the cache holds the post-RoPE
    grouped k/v of positions ``0..P-1``, zero-padded to ``max_len``.
    ``logit_positions`` ([B] ints, right-padded ragged batches) takes each
    row's logits from its own position instead of the last column.  A
    tree over the data axes prefills each data group's rows on the
    group's slots; the batch must split over them."""
    B, P = prompt.shape
    if max_len is None:
        max_len = P
    elif max_len < P:
        raise ValueError(f"max_len={max_len} is smaller than the prompt ({P})")
    from .sharded import data_groups, per_part, serving_moe

    groups = data_groups(params, cfg)
    if groups is not None:
        lp = (None if logit_positions is None else
              torch.as_tensor(logit_positions, device=prompt.device))
        caches = {g: init_cache(cfg, 0, max_len, params=groups.views[g])
                  for g in groups.local}

        def one(view, g, rows):
            logits, caches[g] = prefill(view, cfg, prompt[rows], max_len,
                                        attn_fn,
                                        None if lp is None else lp[rows])
            return logits

        logits = groups.run(B, one, (cfg.vocab_size,))
        return logits, groups.join_cache(caches, B)
    logits, (ks, vs) = forward(
        params, prompt, cfg, attn_fn, return_kv=True,
        moe_fn=serving_moe(params, cfg), last_only=logit_positions is None,
        logit_positions=logit_positions)
    cache = {"k": ks, "v": vs}
    if cfg.kv_quant == "int8":
        cache["k"], cache["k_scale"] = per_part(quantize_kv, ks)
        cache["v"], cache["v_scale"] = per_part(quantize_kv, vs)
    pad = max_len - P
    if pad:
        # Every leaf's T axis sits at index 3.
        def grow(a):
            return F.pad(a, (0, 0, 0, pad) if a.dim() == 5 else (0, pad))

        cache = {name: per_part(grow, a) for name, a in cache.items()}
    return logits[:, 0], cache


def rolling_plan(P: int, W: int, chunk: Optional[int] = None,
                 widths=None) -> list:
    """The chunk widths :func:`prefill_rolling` cuts a ``P``-token prompt
    into: ``chunk`` (default and at most ``W``) tokens at a time with a
    shorter last chunk, or, with ``widths``, a greedy cover by those
    denominations (each capped at ``W``), refused when it cannot reach
    ``P``."""
    plan, c0 = [], 0
    if widths is None:
        C = min(chunk or W, W, P)
        while c0 < P:
            plan.append(min(C, P - c0))
            c0 += plan[-1]
        return plan
    for width in widths:
        width = min(int(width), W)
        while P - c0 >= width:
            plan.append(width)
            c0 += width
    if c0 != P:
        raise ValueError(
            f"widths={tuple(widths)} cannot cover prompt length {P} "
            f"(include 1 as the smallest denomination)")
    return plan


def prefill_rolling(params: dict, cfg: LlamaConfig, prompt, *,
                    chunk: Optional[int] = None, attn_fn=None, widths=None):
    """Prefill in O(window) memory: the prompt streams through the model in
    chunks of at most ``sliding_window`` tokens (:func:`rolling_plan`),
    each attending to the rolling cache (its window's past) and to itself.

    Returns ``(last_logits [B, V], rolling cache)``; continue with
    ``decode_step(..., pos=P, rolling=True)``.  Equal to the one-pass
    windowed prefill up to the order of the softmax sums (the two partials
    of each chunk merge as in ring attention).  ``attn_fn`` must be None:
    the chunk owns its attention.  A sharded tree fills each slot's part
    of the cache with its kv heads (each data group its rows)."""
    W = cfg.sliding_window
    if W is None:
        raise ValueError("prefill_rolling requires cfg.sliding_window")
    if attn_fn is not None:
        raise ValueError("prefill_rolling owns its attention; attn_fn must "
                         "be None")
    from .sharded import data_groups

    dev = params_device(params)
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, P = prompt.shape
    groups = data_groups(params, cfg)
    if groups is not None:
        caches = {g: init_rolling_cache(cfg, 0, params=groups.views[g])
                  for g in groups.local}

        def one(view, g, rows):
            logits, caches[g] = prefill_rolling(view, cfg, prompt[rows],
                                                chunk=chunk, widths=widths)
            return logits

        bodies = len(rolling_plan(P, W, chunk, widths))
        logits = groups.run(B, one, (cfg.vocab_size,),
                            lambda view: groups.post_gathers(view, bodies))
        return logits, groups.join_cache(caches, B)
    cos, sin = cfg_rope_tables(cfg, P, device=dev)
    cache = init_rolling_cache(cfg, B, device=dev, params=params)
    h, c0 = None, 0
    for Cc in rolling_plan(P, W, chunk, widths):
        h = _prefill_chunk(params, cache, prompt[:, c0:c0 + Cc], c0,
                           cos[c0:c0 + Cc], sin[c0:c0 + Cc], cfg)
        c0 += Cc
    return final_logits(params, h[:, -1], cfg), cache


def _prefill_chunk(params, cache, tokens, c0: int, cos, sin,
                   cfg: LlamaConfig):
    """One chunk of :func:`prefill_rolling` (tokens at ``c0 .. c0 + Cc -
    1``) through every layer (:func:`cached_layer_scan`, attending before
    it writes); writes its entries into ``cache`` in place at slots ``(c0
    + i) % W`` and returns the last hidden states.

    Each layer's cache is read in position order ``c0 - W .. c0 - 1``
    (slot ``s`` holds the latest position ``p < c0`` with ``p % W ==
    s``), so the past is one partial at global offsets with the cold
    slots (positions below 0) masked by ``kv_min=0``; the chunk itself is
    the other partial, and the two merge.  An int8 cache is dequantized
    for the past and quantized per slot on the write."""
    from ..ops.attention import (finalize_partial, merge_partials,
                                 partial_attention)

    W = cfg.sliding_window
    n_rep = cfg.n_heads // cfg.n_kv_heads
    dev = tokens.device
    Cc = tokens.shape[1]
    slots = (c0 + torch.arange(Cc, device=dev)) % W
    order = (c0 - W + torch.arange(W, device=dev)) % W

    def write(c, u):
        c[:, :, slots] = u

    def attend(q, lc, k, v):
        kco, vco = lc["k"][:, :, order], lc["v"][:, :, order]
        if "k_scale" in lc:
            kco = dequantize_kv(kco, lc["k_scale"][:, :, order], q.dtype)
            vco = dequantize_kv(vco, lc["v_scale"][:, :, order], q.dtype)
        past = partial_attention(
            q, repeat_kv(kco, n_rep), repeat_kv(vco, n_rep), q_offset=c0,
            kv_offset=c0 - W, causal=True, window=W, kv_min=0)
        here = partial_attention(
            q, repeat_kv(k, n_rep), repeat_kv(v, n_rep), q_offset=c0,
            kv_offset=c0, causal=True, window=W)
        return finalize_partial(*merge_partials(past, here),
                                out_dtype=q.dtype)

    h = embed_tokens(params, tokens, cfg)
    return cached_layer_scan(params, cache, h, cos, sin, cfg, write, attend,
                             attend_first=True)[0]


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
    ragged = prompt_lengths is not None
    if ragged:
        # Pad tokens share the batch-wide expert capacity (computed from
        # the padded B * P); only provable droplessness keeps real rows
        # untouched.
        require_dropless(cfg, "ragged generation")
    W = cfg.sliding_window
    # Aligned batches of a windowed model decode through a rolling cache
    # of W slots whenever that is smaller; ragged ones keep the full cache.
    rolling = not ragged and W is not None and W < max_len
    rope = cfg_rope_tables(cfg, max_len, device=dev)
    if ragged:
        lengths = validate_prompt_lengths(prompt_lengths, B, P).to(dev)
        logits, cache = prefill(params, cfg, prompt, max_len,
                                logit_positions=lengths - 1)
        pos = lengths.int()
    elif rolling:
        pos = P
        if P <= W:
            # Zero-padded to W slots, position p already sits at p % W.
            logits, cache = prefill(params, cfg, prompt, W)
        else:
            logits, cache = prefill(params, cfg, prompt, P)
            # The last W positions, each at its slot p % W; every leaf's T
            # axis is at index 3.
            src = (P - W) + (torch.arange(W, device=dev) - (P - W)) % W
            cache = {name: a.index_select(3, src)
                     for name, a in cache.items()}
    else:
        logits, cache = prefill(params, cfg, prompt, max_len)
        pos = P
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
            logits, cache = decode_step(params, cache, tok, pos, cfg, rope,
                                        rolling=rolling)
            pos = pos + 1
    new = torch.stack(toks, dim=1)
    out = new if ragged else torch.cat([prompt, new], dim=1)
    if return_logprobs:
        return out, torch.stack(lps, dim=1)
    return out
