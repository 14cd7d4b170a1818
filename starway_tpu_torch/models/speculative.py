"""Speculative decoding: draft proposals verified by one chunk forward.

Decode streams the whole KV cache once a token.  A cheap drafter proposes
``gamma - 1`` tokens; the target scores the pending token and the
proposals in one :func:`chunk_decode_step` (C = ``gamma`` query rows
through the decode kernel), and the rejection rule keeps the output
distribution the target's (greedy: its tokens).  Two drafters:
:func:`generate_speculative` runs a draft model (for example
:func:`draft_from_truncation`, the target's first layers), and
:func:`generate_lookup` copies the continuation of the latest earlier
occurrence of the current n-gram (prompt lookup), with no model at all.

Each decoder is a Python loop of rounds over tensors on the device: every
row keeps its own cursor and advances 1 .. ``gamma`` tokens a round;
rejected entries sit past the cursor, where the position masks hide them
and later writes replace them, so a rejection costs no copy.  The loop
reads one flag a round on the host (whether every row is done) and
nothing else.  Sampling draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .generate import (_attend_cached, _filter_logits, _sample,
                       cached_layer_scan, decode_step, prefill,
                       validate_prompt_lengths)
from .llama import (LlamaConfig, cfg_rope_tables, embed_tokens,
                    final_logits, params_device, resolve_longrope)
from .moe import require_dropless

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
    positions past the window are masked).  A tree over the data axes runs
    each data group's rows on the group's slots."""
    from .sharded import data_groups

    groups = data_groups(params, cfg)
    if groups is not None:
        def one(view, g, rows):
            p = pos[rows] if isinstance(pos, torch.Tensor) and pos.dim() else pos
            return chunk_decode_step(view, groups.cache_of(cache, g),
                                     tokens[rows], p, cfg, rope)[0]

        return groups.run(tokens.shape[0], one,
                          (tokens.shape[1], cfg.vocab_size)), cache
    B, C = tokens.shape
    T = cache["k"].shape[3]
    if cfg.sliding_window is not None and T == cfg.sliding_window:
        raise ValueError(
            f"chunk_decode_step does not support rolling caches: got a "
            f"{T}-slot cache == cfg.sliding_window, which is a rolling "
            f"cache's layout; allocate a full cache (max_len != "
            f"sliding_window) for multi-token ingestion")
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
    return final_logits(params, h, cfg), cache


# ------------------------------------------------------------ the decoders


def _accept_emit(drafts, pd, t_logits, generator, out, n_out, t_pend, pos,
                 stats, *, greedy: bool, G: int, max_new: int, probs_of):
    """The acceptance rule and the output bookkeeping of both decoders.

    ``drafts [B, G-1]`` with their proposal distributions ``pd [B, G-1,
    V]`` (one-hot for a deterministic drafter), ``t_logits [B, G, V]`` of
    the verify.  Greedy accepts a draft equal to the target's argmax;
    sampling accepts where ``u * pd_d < qt_d`` (strict: a draft outside
    the target's support is rejected even at u = 0), then draws the
    correction from the residual ``max(q - p, 0)`` (from ``q`` itself
    after a full acceptance, or where the residual's mass is under 1e-9).
    Row b writes ``d_1 .. d_a, c`` at ``n_out[b]`` and advances ``a + 1``
    tokens, clamped to its remaining budget; a finished row stays frozen.
    ``stats [B, 2]`` adds ``[live macro steps, accepted drafts emitted]``.
    Returns ``(out, n_out, t_pend, pos, stats, emit [B, G])``."""
    B = drafts.shape[0]
    dev = drafts.device
    rows = torch.arange(B, device=dev)
    idx = torch.arange(G - 1, device=dev)[None, :]
    if greedy:
        ok = drafts == torch.argmax(t_logits[:, :-1], dim=-1)
    else:
        qt = probs_of(t_logits[:, :-1])
        u = torch.rand(drafts.shape, generator=generator, device=dev)
        qt_d = qt.gather(-1, drafts[..., None])[..., 0]
        pd_d = pd.gather(-1, drafts[..., None])[..., 0]
        ok = u * pd_d < qt_d
    a = torch.cumprod(ok.long(), dim=1).sum(dim=1)  # leading accepts
    la = t_logits[rows, a]  # the logits of the token after d_a
    if greedy:
        c = torch.argmax(la, dim=-1)
    else:
        qa = probs_of(la)
        pa = F.pad(pd, (0, 0, 0, 1))[rows, a]
        res = torch.clamp(qa - pa, min=0.0)
        res_sum = res.sum(dim=-1, keepdim=True)
        use_res = (a[:, None] < G - 1) & (res_sum > 1e-9)
        dist = torch.where(use_res, res / torch.clamp(res_sum, min=1e-30),
                           qa)
        c = torch.multinomial(dist, 1, generator=generator)[:, 0]
    emit = torch.where(idx < a[:, None], drafts, torch.zeros_like(drafts))
    emit = torch.cat([emit, torch.zeros_like(emit[:, :1])], dim=1)
    emit[rows, a] = c
    out.scatter_(1, n_out[:, None] + torch.arange(G, device=dev), emit)
    done = n_out >= max_new
    adv = torch.where(done, torch.zeros_like(a),
                      torch.minimum(a + 1, max_new - n_out))
    live = (~done).long()
    stats += torch.stack([live, live * torch.minimum(a, adv)], dim=1)
    t_pend = torch.where(adv == a + 1, c, t_pend)
    return out, n_out + adv, t_pend, pos + adv, stats, emit


def draft_from_truncation(params: dict, cfg: LlamaConfig, n_layers: int):
    """A draft model for free: the target's first ``n_layers`` layers with
    its embedding, final norm and head.  Returns ``(draft_params,
    draft_cfg)``; the layer leaves are views of the target's and the other
    leaves are the target's own, so no weight is copied."""
    if not 1 <= n_layers < cfg.n_layers:
        raise ValueError(
            f"n_layers must be in [1, {cfg.n_layers - 1}], got {n_layers}")
    draft = dict(params)
    draft["layers"] = {
        name: ({k: t[:n_layers] for k, t in w.items()}
               if isinstance(w, dict) else w[:n_layers])
        for name, w in params["layers"].items()}
    return draft, dataclasses.replace(cfg, n_layers=n_layers)


def _lookup_propose(seq, pos, *, ngram: int, gamma: int):
    """Prompt-lookup proposals ``[B, gamma - 1]``: ``seq [B, L]`` is valid
    through ``pos`` ([B]); the current n-gram is ``seq[pos - ngram + 1 ..
    pos]``.  Takes the largest ``j < pos`` whose n-gram ending at ``j``
    equals it and proposes ``seq[j + 1 .. j + gamma - 1]``; with no match
    ``j = ngram - 1`` (any proposal is safe: the verify rejects it)."""
    B, L = seq.shape
    dev = seq.device
    idx = torch.arange(L, device=dev)[None, :]
    match = torch.ones((B, L), dtype=torch.bool, device=dev)
    for k in range(ngram):
        shifted = F.pad(seq, (k, 0))[:, :L]
        want = seq.gather(1, torch.clamp(pos[:, None] - k, min=0))
        match = match & (shifted == want) & (idx >= k)
    match = match & (idx < pos[:, None]) & (idx >= ngram - 1)
    j = torch.where(match, idx, torch.full_like(idx, ngram - 1)).amax(dim=1)
    start = torch.clamp(j + 1, max=L - (gamma - 1))  # a slice stays inside
    return seq.gather(1, start[:, None] + torch.arange(gamma - 1,
                                                       device=dev))


def _probs_fn(temperature, top_k, top_p):
    """The distribution ``_sample`` draws from, as probabilities."""

    def probs_of(logits):
        return torch.softmax(_filter_logits(logits, temperature, top_k,
                                            top_p), dim=-1)

    return probs_of


def _prefill_rows(params, cfg, prompt, lengths, max_len):
    """``(next logits [B, V], cache of max_len slots)`` of a prompt whose
    rows end at ``lengths`` (None: all at P)."""
    lp = None if lengths is None else lengths - 1
    return prefill(params, cfg, prompt, max_len, logit_positions=lp)


def _rounds(step, t0, lengths, prompt, max_new: int, G: int):
    """Run ``step(out, n_out, t_pend, pos, stats)`` rounds from the first
    token ``t0`` until every row has ``max_new`` tokens; returns
    ``(tokens [B, max_new], stats [B, 2])``.  Whether every row is done
    is the one value read on the host a round."""
    B, P = prompt.shape
    dev = prompt.device
    out = torch.zeros((B, max_new + G), dtype=torch.long, device=dev)
    out[:, 0] = t0
    pos = (torch.full((B,), P, dtype=torch.long, device=dev)
           if lengths is None else lengths.long())
    state = (out, torch.ones(B, dtype=torch.long, device=dev), t0, pos,
             torch.zeros((B, 2), dtype=torch.long, device=dev))
    while bool((state[1] < max_new).any()):
        state = step(*state)
    return state[0][:, :max_new], state[4]


def generate_speculative(params: dict, cfg: LlamaConfig, draft_params: dict,
                         draft_cfg: LlamaConfig, prompt,
                         max_new_tokens: int, *, gamma: int = 4,
                         temperature: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None,
                         eos_id: Optional[int] = None, prompt_lengths=None,
                         return_stats: bool = False):
    """Speculative generation: the target model's output at a fraction of
    its decode steps.  prompt ``[B, P]``; returns ``[B, P +
    max_new_tokens]`` (ragged ``prompt_lengths``: only the new tokens),
    the :func:`~starway_tpu_torch.models.generate.generate` contract.

    Each round the draft decodes ``gamma - 1`` proposals from its own
    cache (and writes the last one's entry), the target verifies the
    pending token and the proposals in one chunk, and each row advances by
    its accepted drafts plus one.  Greedy output equals ``generate()``'s
    up to argmax near-ties between the chunk and the stepwise logits;
    sampling keeps the target's distribution.  ``eos_id`` fills after a
    row's first eos.  ``return_stats`` adds ``{"macro_steps",
    "accepted"}`` per row.  Both caches are full (``P + max_new + gamma``
    slots), so sliding-window models speculate with window masks."""
    dev = params_device(params)
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, P = prompt.shape
    _validate_spec_args(max_new_tokens, gamma, (cfg, "target"),
                        (draft_cfg, "draft"))
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(
            f"target and draft must share a vocab: {cfg.vocab_size} != "
            f"{draft_cfg.vocab_size}")
    lengths = _validate_lengths(prompt_lengths, B, P, dev)
    # The rope regime of the request's horizon, as generate() takes it;
    # the gamma slots past it are scratch.
    cfg = resolve_longrope(cfg, P + max_new_tokens)
    draft_cfg = resolve_longrope(draft_cfg, P + max_new_tokens)
    max_len = _cache_len(P, max_new_tokens, gamma, cfg)
    rope = cfg_rope_tables(cfg, max_len, device=dev)
    sampling = (float(temperature), top_k, top_p)
    greedy = temperature == 0.0
    probs_of = _probs_fn(*sampling)
    G = int(gamma)
    t_logits, t_cache = _prefill_rows(params, cfg, prompt, lengths, max_len)
    _, d_cache = _prefill_rows(draft_params, draft_cfg, prompt, lengths,
                               max_len)
    t0 = _sample(t_logits, generator, *sampling)

    def step(out, n_out, t_pend, pos, stats):
        toks, pds, tok = [], [], t_pend
        for i in range(G - 1):
            logits, _ = decode_step(draft_params, d_cache, tok, pos + i,
                                    draft_cfg, rope)
            if greedy:
                tok = torch.argmax(logits, dim=-1)
                pd = F.one_hot(tok, logits.shape[-1]).float()
            else:
                tok = _sample(logits, generator, *sampling)
                pd = probs_of(logits)
            toks.append(tok)
            pds.append(pd)
        # The last proposal's entry, so a full acceptance leaves no hole in
        # the draft's cache.
        decode_step(draft_params, d_cache, tok, pos + G - 1, draft_cfg, rope)
        drafts = torch.stack(toks, dim=1)
        chunk = torch.cat([t_pend[:, None], drafts], dim=1)
        t_logits, _ = chunk_decode_step(params, t_cache, chunk, pos, cfg,
                                        rope)
        return _accept_emit(
            drafts, torch.stack(pds, dim=1), t_logits, generator, out,
            n_out, t_pend, pos, stats, greedy=greedy, G=G,
            max_new=max_new_tokens, probs_of=probs_of)[:5]

    toks, stats = _rounds(step, t0, lengths, prompt, max_new_tokens, G)
    return _finish_spec(prompt, toks, stats, eos_id, return_stats,
                        ragged=prompt_lengths is not None)


def generate_lookup(params: dict, cfg: LlamaConfig, prompt,
                    max_new_tokens: int, *, gamma: int = 4, ngram: int = 2,
                    temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    eos_id: Optional[int] = None, prompt_lengths=None,
                    return_stats: bool = False):
    """Prompt-lookup speculative generation: the proposals continue the
    latest earlier occurrence of the current ``ngram``-gram in the
    sequence so far (:func:`_lookup_propose`), and the target verifies
    them as in :func:`generate_speculative` (a deterministic drafter is
    the one-hot case of the same rule).  Only the target runs, so any
    acceptance saves a decode step.  Same contract and guarantees as
    :func:`generate_speculative`."""
    dev = params_device(params)
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, P = prompt.shape
    _validate_spec_args(max_new_tokens, gamma, (cfg, "target"))
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")
    lengths = _validate_lengths(prompt_lengths, B, P, dev)
    cfg = resolve_longrope(cfg, P + max_new_tokens)
    max_len = _cache_len(P, max_new_tokens, gamma, cfg)
    rope = cfg_rope_tables(cfg, max_len, device=dev)
    sampling = (float(temperature), top_k, top_p)
    probs_of = _probs_fn(*sampling)
    G = int(gamma)
    t_logits, t_cache = _prefill_rows(params, cfg, prompt, lengths, max_len)
    t0 = _sample(t_logits, generator, *sampling)
    # The lookup corpus: the prompt, then every emitted token at its
    # position.  A ragged row's pad columns are never a key or a copied
    # span before emits replace them (matches scan j < pos only).
    seq = torch.zeros((B, max_len), dtype=torch.long, device=dev)
    seq[:, :P] = prompt
    seq[torch.arange(B, device=dev),
        P if lengths is None else lengths] = t0
    span = torch.arange(G, device=dev)

    def step(out, n_out, t_pend, pos, stats):
        drafts = _lookup_propose(seq, pos, ngram=ngram, gamma=G)
        pd = F.one_hot(drafts, cfg.vocab_size).float()
        chunk = torch.cat([t_pend[:, None], drafts], dim=1)
        t_logits, _ = chunk_decode_step(params, t_cache, chunk, pos, cfg,
                                        rope)
        *state, emit = _accept_emit(
            drafts, pd, t_logits, generator, out, n_out, t_pend, pos, stats,
            greedy=temperature == 0.0, G=G, max_new=max_new_tokens,
            probs_of=probs_of)
        # Mirror the emit into the corpus after the old cursor (its junk
        # tail is overwritten by the next mirror).
        start = torch.clamp(pos + 1, max=max_len - G)
        seq.scatter_(1, start[:, None] + span, emit)
        return tuple(state)

    toks, stats = _rounds(step, t0, lengths, prompt, max_new_tokens, G)
    return _finish_spec(prompt, toks, stats, eos_id, return_stats,
                        ragged=prompt_lengths is not None)


def _cache_len(P: int, max_new: int, gamma: int, cfg: LlamaConfig) -> int:
    """Slots of the decoders' full caches: a round may write ``gamma - 1``
    entries past the last kept token.  One more where that equals the
    window, whose size :func:`chunk_decode_step` reads as a rolling cache
    (the extra slot is masked)."""
    max_len = P + max_new + gamma
    return max_len + 1 if max_len == cfg.sliding_window else max_len


def _validate_spec_args(max_new_tokens: int, gamma: int, *cfgs):
    """The restrictions both speculative entry points share; ``cfgs`` are
    ``(config, "target" or "draft")`` pairs."""
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if gamma < 2:
        raise ValueError(f"gamma must be >= 2 (got {gamma}); gamma=1 is "
                         f"plain decode: use generate()")
    for c, who in cfgs:
        if who == "target":
            # Only the target's routing must not depend on the shape (the
            # chunk verify against stepwise decode); a droppy draft only
            # proposes worse, and the rejection rule keeps the target's
            # output.
            require_dropless(c, f"speculative decoding ({who})")


def _validate_lengths(prompt_lengths, B: int, P: int, dev):
    """``generate()``'s ragged-lengths contract, or None (aligned)."""
    if prompt_lengths is None:
        return None
    return validate_prompt_lengths(prompt_lengths, B, P).to(dev)


def _finish_spec(prompt, toks, stats, eos_id, return_stats, ragged=False):
    """Eos fill after each row's first eos, the prompt in front (aligned
    batches), and the acceptance stats when asked."""
    if eos_id is not None:
        hit = (toks == eos_id).long()
        fill = (torch.cumsum(hit, dim=1) - hit) > 0
        toks = torch.where(fill, torch.full_like(toks, eos_id), toks)
    out = toks if ragged else torch.cat([prompt, toks], dim=1)
    if return_stats:
        return out, {"macro_steps": stats[:, 0], "accepted": stats[:, 1]}
    return out
