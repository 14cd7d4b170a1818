"""Continuous-batching serving: admit requests into a running batch.

* **Slots, not batches.**  The KV cache is ``[L, n_slots, Hkv, max_len,
  Dh]``; every per-slot cursor (position, liveness, token budget) is an
  ``[n_slots]`` tensor on the device, so shapes never depend on which
  requests are in flight.
* **Admission = bucketed prefill.**  A new request's prompt is
  right-padded to a power-of-two bucket and prefilled alone, then its kv
  rows are copied into the slot.  Pad columns are never read: attention
  masks by the slot's cursor, and decode overwrites each position before
  the cursor reaches it (write-then-attend).
* **Decode runs in chunks.**  One chunk advances all live slots ``chunk``
  tokens with no host round trip; dead slots are masked (frozen cursor,
  writes land on a position that admission or the advancing cursor
  overwrites before any read).  The host reads tokens once per chunk.
* **Greedy continuous batching equals standalone ``generate()``** for
  every request, whatever the interleaving: same prefill, same decode
  step, same masking.

The cache is updated in place.  Errors of the device (out of memory, a
failed kernel launch) propagate out of ``step()``; a request is never
silently re-queued.  Prefix caching, sliding-window (rolling) models and
MoE models are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from .generate import _sample, decode_step, init_cache, prefill
from .llama import (LlamaConfig, cfg_rope_tables, params_device,
                    resolve_longrope)


def default_buckets(max_len: int) -> tuple:
    """Powers of two from 32, then ``max_len`` itself, so that every prompt
    up to ``max_len - 1`` has a bucket."""
    b, buckets = 32, []
    while b < max_len:
        buckets.append(b)
        b *= 2
    return tuple(buckets) + (max_len,)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest bucket "
                     f"{buckets[-1]}")


def _write_slot_and_sample(cache, small, logits, slot, generator,
                           temperature, top_k, top_p):
    """File one request's ``[L, 1, Hkv, T', ...]`` cache rows into ``slot``
    (in place; every leaf, the int8 scales included) and sample its first
    token.  ``slot`` is clamped to the slot range."""
    slot = min(max(int(slot), 0), cache["k"].shape[1] - 1)
    for name, rows in small.items():
        cache[name][:, slot:slot + 1, :, :rows.shape[3]].copy_(rows)
    return _sample(logits, generator, temperature, top_k, top_p)[0]


def make_chunk_scan_step(decode_one, max_len: int, temperature: float,
                         top_k, top_p, eos_id, generator=None):
    """The per-step body of the chunked serving loop.
    ``decode_one(cache, token, pos) -> (logits, cache)``; the returned
    ``step(cache, token, pos, live, remaining)`` gives the new state and
    ``(sampled tokens, emission mask)``: a token is real when its slot was
    live with budget left."""

    def step(cache, token, pos, live, remaining):
        logits, cache = decode_one(cache, token, pos)
        nxt = _sample(logits, generator, temperature, top_k, top_p)
        emit_live = live & (remaining > 0)
        if eos_id is not None:
            newly_done = emit_live & (nxt == eos_id)
        else:
            newly_done = torch.zeros_like(emit_live)
        remaining = remaining - emit_live.int()
        live = emit_live & ~newly_done & (remaining > 0) & (pos + 2 < max_len)
        # Dead slots freeze: cursor stays, pending token irrelevant.
        pos = pos + emit_live.int()
        token = torch.where(emit_live, nxt, token)
        return (cache, token, pos, live, remaining), (nxt, emit_live)

    return step


class SlotServer:
    """Continuous-batching front end on the device of ``params``.

    >>> srv = SlotServer(params, cfg, n_slots=4, max_len=512)
    >>> rid = srv.submit([1, 2, 3], max_new_tokens=32)
    >>> done = srv.run()          # {rid: np.ndarray of generated tokens}

    ``submit`` queues; ``step()`` admits pending requests into free slots
    and advances one decode chunk, returning newly finished requests;
    ``run()`` loops until everything queued has finished.  Generated tokens
    include the terminating eos (when ``eos_id`` fires).

    ``on_tokens(rid, tokens, done)`` fires inside ``step()``: once per
    request per step with that step's new tokens (done=False), and once
    with ``([], True)`` when the request finishes.  A cancelled request
    gets no done event.
    """

    def __init__(self, params, cfg: LlamaConfig, *, n_slots: int = 4,
                 max_len: int = 512, chunk: int = 8,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, eos_id: Optional[int] = None,
                 prompt_buckets=None, seed: int = 0, on_tokens=None):
        if cfg.n_experts > 0:
            raise NotImplementedError(
                "serving mixture-of-experts models is not ported yet "
                "(ROADMAP.md)")
        if cfg.sliding_window is not None:
            raise NotImplementedError(
                "sliding-window models serve through rolling caches, which "
                "are not ported yet (ROADMAP.md, Queue 1: rolling and "
                "prefix paths)")
        if n_slots < 1 or chunk < 1:
            raise ValueError(f"need n_slots >= 1 and chunk >= 1, got "
                             f"{n_slots}/{chunk}")
        cfg = resolve_longrope(cfg, max_len)
        self.params = params
        self.cfg = cfg
        self.device = params_device(params)
        self.n_slots = n_slots
        self.max_len = max_len
        self.chunk = chunk
        self.sampling = (float(temperature), top_k, top_p)
        self.eos_id = None if eos_id is None else int(eos_id)
        if prompt_buckets is None:
            prompt_buckets = default_buckets(max_len)
        self.buckets = tuple(sorted(set(prompt_buckets)))
        if self.buckets[-1] > max_len:
            raise ValueError(f"bucket {self.buckets[-1]} exceeds "
                             f"max_len={max_len}")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.rope = cfg_rope_tables(cfg, max_len, device=self.device)

        dev = self.device
        self.cache = init_cache(cfg, n_slots, max_len, device=dev)
        self.token = torch.zeros(n_slots, dtype=torch.long, device=dev)
        self.pos = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        self.live = torch.zeros(n_slots, dtype=torch.bool, device=dev)
        self.remaining = torch.zeros(n_slots, dtype=torch.int32, device=dev)

        self._next_rid = 0
        self._pending: deque = deque()
        self._slot_rid: dict[int, int] = {}
        self._collected: dict[int, list] = {}
        self.on_tokens = on_tokens
        self._step = make_chunk_scan_step(
            lambda cache, token, pos: decode_step(
                self.params, cache, token, pos, self.cfg, self.rope),
            max_len, *self.sampling, self.eos_id, self.generator)

    # ------------------------------------------------------------ intake
    def register_prefix(self, tokens) -> int:
        """Prefix caching ingests the suffix through the speculative chunk
        decode step, which is not ported yet."""
        raise NotImplementedError(
            "prefix caching needs speculative.chunk_decode_step, which is "
            "not ported yet (ROADMAP.md, Queue 1: rolling and prefix paths)")

    def submit(self, prompt, max_new_tokens: int) -> int:
        """Queue one request; returns its id (resolved by step()/run())."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new_tokens}) "
                f"exceeds max_len={self.max_len}")
        _bucket(len(prompt), self.buckets)  # refuse now, not at admission
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append((rid, prompt, int(max_new_tokens)))
        return rid

    # ------------------------------------------------------------- engine
    def _admit(self, slot: int, rid: int, prompt: np.ndarray,
               max_new: int) -> None:
        pb = _bucket(len(prompt), self.buckets)
        padded = torch.zeros((1, pb), dtype=torch.long)
        padded[0, :len(prompt)] = torch.from_numpy(prompt)
        last = torch.tensor([len(prompt) - 1], device=self.device)
        logits, small = prefill(self.params, self.cfg,
                                padded.to(self.device), pb,
                                logit_positions=last)
        tok = _write_slot_and_sample(self.cache, small, logits, slot,
                                     self.generator, *self.sampling)
        self._finish_admit(slot, rid, tok, len(prompt), max_new)

    def _finish_admit(self, slot: int, rid: int, tok, cursor: int,
                      max_new: int) -> None:
        """Record the first token, fire the streaming hook, and set the
        slot's cursor, liveness and budget."""
        tok_host = int(tok)
        self._slot_rid[slot] = rid
        self._collected[rid] = [tok_host]
        if self.on_tokens is not None:
            self.on_tokens(rid, [tok_host], False)
            if rid not in self._collected:
                # The callback cancelled this very request; setting the
                # slot state would resurrect it.
                return
        done = (max_new == 1 or
                (self.eos_id is not None and tok_host == self.eos_id))
        self.token[slot] = tok_host
        self.pos[slot] = cursor
        self.live[slot] = not done
        self.remaining[slot] = max_new - 1

    def cancel(self, rid: int) -> bool:
        """Abort a request: de-queue it if pending, else kill its slot so
        the next step() frees it.  Returns True if the request was found.
        A cancelled request is not reported by step()/run() and gets no
        on_tokens done event."""
        for i, (qrid, *_rest) in enumerate(self._pending):
            if qrid == rid:
                del self._pending[i]
                return True
        for slot, srid in self._slot_rid.items():
            if srid == rid:
                self.live[slot] = False
                self.remaining[slot] = 0
                del self._slot_rid[slot]
                self._collected.pop(rid, None)
                return True
        return False

    def _harvest_dead(self, finished: dict) -> None:
        live = self.live.cpu().numpy()
        # Snapshot + tolerant pops: a done-event callback may cancel()
        # another request that finished in this same step.
        for slot, rid in list(self._slot_rid.items()):
            if not live[slot]:
                if rid not in self._collected:
                    self._slot_rid.pop(slot, None)
                    continue
                finished[rid] = np.asarray(self._collected.pop(rid),
                                           np.int32)
                self._slot_rid.pop(slot, None)
                if self.on_tokens is not None:
                    self.on_tokens(rid, [], True)

    def step(self) -> dict:
        """Admit what fits, decode one chunk; returns {rid: tokens} for
        requests that finished during this step."""
        finished: dict = {}
        self._harvest_dead(finished)  # 1-token / instant-eos admissions
        free = [s for s in range(self.n_slots) if s not in self._slot_rid]
        while free and self._pending:
            rid, prompt, max_new = self._pending.popleft()
            self._admit(free.pop(0), rid, prompt, max_new)
        self._harvest_dead(finished)
        if not self._slot_rid:
            return finished

        toks, mask = self._run_chunk()
        for slot, rid in list(self._slot_rid.items()):
            if rid not in self._collected:
                continue  # cancelled by an earlier callback this step
            new = [int(t) for t, m in zip(toks[:, slot], mask[:, slot]) if m]
            self._collected[rid].extend(new)
            if self.on_tokens is not None and new:
                self.on_tokens(rid, new, False)
        self._harvest_dead(finished)
        return finished

    @property
    def busy(self) -> bool:
        """True while any request is queued or occupying a slot."""
        return bool(self._pending or self._slot_rid)

    def _run_chunk(self):
        """Advance every slot ``chunk`` steps on the device; returns host
        ``(tokens [chunk, n_slots], mask [chunk, n_slots])``."""
        state = (self.cache, self.token, self.pos, self.live, self.remaining)
        toks, mask = [], []
        for _ in range(self.chunk):
            state, (nxt, emitted) = self._step(*state)
            toks.append(nxt)
            mask.append(emitted)
        self.cache, self.token, self.pos, self.live, self.remaining = state
        return (torch.stack(toks).cpu().numpy(),
                torch.stack(mask).cpu().numpy())

    def run(self) -> dict:
        """Drive step() until every submitted request has finished."""
        finished: dict = {}
        while self.busy:
            finished.update(self.step())
        return finished
