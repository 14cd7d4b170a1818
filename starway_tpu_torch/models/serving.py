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
* **Prefix caching.**  ``register_prefix`` prefills a shared prefix once
  into a standalone ``[L, 1, Hkv, bucket, Dh]`` cache; a prefixed
  admission copies its rows into the slot where position < plen (bucket
  junk above the prefix must not land where suffix positions would attend
  it) and ingests the suffix through one
  :func:`~starway_tpu_torch.models.speculative.chunk_decode_step` against
  the slot's own rows (write-then-attend), so a prefixed request generates
  exactly what ``generate(prefix + suffix)`` would, while admission
  compute scales with the suffix.
* **Rolling slots.**  A sliding-window model serves through per-slot
  rolling caches ``[L, n_slots, Hkv, W, Dh]``: O(window) memory per slot
  however long a request runs.  Admission is the chunked
  ``prefill_rolling`` with the denominations :data:`ROLLING_ADMIT_WIDTHS`
  (no prompt buckets), ``max_len`` bounds only the rope horizon, and
  prefixes are refused (each slot rebuilds its own window).

The cache is updated in place.  Errors of the device (out of memory, a
failed kernel launch) propagate out of ``step()``; a request is never
silently re-queued.  MoE models serve when their capacity is provably
dropless (``moe_capacity_factor >= n_experts``, models/moe.py
``require_dropless``): slots that share a decode step share its expert
capacity.  Subclasses (the paged
server, models/paged.py) replace the cache through the hooks
``_make_cache``, ``_post_init``, ``_on_slot_freed``, ``_decode_one``,
``_admit_plain``, ``_admit_prefixed``, ``_admissible`` and
``_check_pages``.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from .generate import (_sample, decode_step, init_cache, init_rolling_cache,
                       prefill, prefill_rolling)
from .llama import (LlamaConfig, cfg_rope_tables, params_device,
                    resolve_longrope)
from .moe import require_dropless


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


# Chunk widths of rolling admission: a prompt is covered greedily by these,
# so admission takes at most P/64 + 7 + 7 chunks of three shapes.
ROLLING_ADMIT_WIDTHS = (64, 8, 1)


def _rolling_prefill_state(params, cfg: LlamaConfig, prompt: np.ndarray):
    """``(next_logits [1, V], rolling cache [L, 1, Hkv, W, ...])`` of one
    prompt by ``prefill_rolling`` over :data:`ROLLING_ADMIT_WIDTHS`:
    rolling admission, and the single-request oracle of its tests."""
    tokens = torch.as_tensor(np.asarray(prompt, np.int64)[None],
                             device=params_device(params))
    return prefill_rolling(params, cfg, tokens, widths=ROLLING_ADMIT_WIDTHS)


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

    ``register_prefix(tokens)`` prefills a shared prefix once; requests
    submitted with ``prefix=pid`` continue it with their own tokens, and
    generate exactly what ``generate(prefix + suffix)`` would.

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
        # Cohabiting slots share the batch-wide expert capacity; only
        # provable droplessness keeps them independent.
        require_dropless(cfg, "continuous batching")
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
        # Rolling slots keep W positions each; max_len is then the rope
        # horizon (prompt + budget), not the cache size.
        self.rolling = cfg.sliding_window is not None
        if self.rolling:
            self.buckets = ()  # rolling admission never buckets prompts
        else:
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
        self.cache = self._make_cache()
        self.token = torch.zeros(n_slots, dtype=torch.long, device=dev)
        self.pos = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        self.live = torch.zeros(n_slots, dtype=torch.bool, device=dev)
        self.remaining = torch.zeros(n_slots, dtype=torch.int32, device=dev)

        self._next_rid = 0
        self._pending: deque = deque()  # (rid, prompt, max_new, prefix)
        self._slot_rid: dict[int, int] = {}
        self._collected: dict[int, list] = {}
        self._prefixes: dict[int, tuple] = {}  # pid -> (prefix state, plen)
        self._next_pid = 0
        self.on_tokens = on_tokens
        self._post_init()

    # ------------------------------------------------------------- hooks
    def _make_cache(self):
        if self.rolling:
            return init_rolling_cache(self.cfg, self.n_slots,
                                      device=self.device)
        return init_cache(self.cfg, self.n_slots, self.max_len,
                          device=self.device, params=self.params)

    def _post_init(self) -> None:
        """Subclass hook, called at the end of ``__init__``."""

    def _on_slot_freed(self, slot: int) -> None:
        """Subclass hook: a slot's request finished or was cancelled (the
        paged server returns its pages to the pool here)."""

    def _decode_one(self, cache, token, pos):
        """One decode step of every slot: ``(logits [n_slots, V], cache)``."""
        return decode_step(self.params, cache, token, pos, self.cfg,
                           self.rope, rolling=self.rolling)

    def _check_pages(self, prompt_len: int, prefix: Optional[int]) -> None:
        """Subclass hook of ``submit``: refuse a request that the cache
        could never admit (the dense cache admits every valid request)."""

    def _admissible(self, prompt_len: int, prefix: Optional[int]) -> bool:
        """Subclass hook of ``step``: whether the head of the queue can be
        admitted now (False keeps it queued)."""
        return True

    # ------------------------------------------------------------ intake
    def _padded(self, tokens: np.ndarray, width: int) -> torch.Tensor:
        """``tokens`` right-padded with zeros to ``[1, width]`` on the
        device."""
        padded = torch.zeros((1, width), dtype=torch.long)
        padded[0, :len(tokens)] = torch.from_numpy(tokens)
        return padded.to(self.device)

    def _prefill_bucket(self, tokens: np.ndarray, width: int):
        """Prefill ``tokens`` padded to ``width``: ``(logits [1, V] at the
        last real token, cache [L, 1, Hkv, width, ...])``."""
        last = torch.tensor([len(tokens) - 1], device=self.device)
        return prefill(self.params, self.cfg, self._padded(tokens, width),
                       width, logit_positions=last)

    def _check_prefix_tokens(self, tokens) -> np.ndarray:
        if self.rolling:
            raise ValueError("prefix caching needs the dense slot cache; "
                             "rolling (sliding-window) slots rebuild their "
                             "window per request anyway")
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        if len(tokens) < 1:
            raise ValueError("empty prefix")
        if len(tokens) + self.buckets[0] + 1 > self.max_len:
            # The suffix ingest writes bucket-wide, so a prefix must leave
            # at least the smallest bucket plus one generated token;
            # checked before a prefill is spent on a prefix no submit()
            # could use.
            raise ValueError(
                f"prefix ({len(tokens)}) + smallest suffix bucket "
                f"({self.buckets[0]}) + 1 exceeds max_len={self.max_len}")
        return tokens

    def register_prefix(self, tokens) -> int:
        """Prefill a shared prefix (system prompt, few-shot preamble) once
        and return its id; requests submitted with ``prefix=pid`` reuse its
        cache rows instead of prefilling them.  Its ``[L, 1, Hkv, bucket,
        ...]`` cache stays on the device until :meth:`drop_prefix`."""
        tokens = self._check_prefix_tokens(tokens)
        _logits, small = self._prefill_bucket(
            tokens, _bucket(len(tokens), self.buckets))
        pid = self._next_pid
        self._next_pid += 1
        self._prefixes[pid] = (small, len(tokens))
        return pid

    def _refuse_drop_if_queued(self, pid: int) -> None:
        if any(p == pid for _rid, _pr, _mn, p in self._pending):
            raise ValueError(
                f"prefix {pid} is still referenced by queued requests; "
                f"run()/step() them first")

    def drop_prefix(self, pid: int) -> None:
        """Free a registered prefix's cache rows.  Refuses while a queued
        request references it (admitted requests no longer need it)."""
        self._refuse_drop_if_queued(pid)
        del self._prefixes[pid]

    def submit(self, prompt, max_new_tokens: int,
               prefix: Optional[int] = None) -> int:
        """Queue one request; returns its id (resolved by step()/run()).

        ``prefix``: a :meth:`register_prefix` id; ``prompt`` is then the
        suffix that continues it."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        plen = 0
        if prefix is not None:
            if prefix not in self._prefixes:
                raise KeyError(f"unknown prefix id {prefix}")
            plen = self._prefixes[prefix][1]
        if plen + len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prefix ({plen}) + prompt ({len(prompt)}) + max_new "
                f"({max_new_tokens}) exceeds max_len={self.max_len}")
        # Refuse now what admission could not place, not after the request
        # has left the queue.
        if not self.rolling:
            sb = _bucket(len(prompt), self.buckets)
            if prefix is not None and plen + sb > self.max_len:
                raise ValueError(
                    f"prefix ({plen}) + suffix bucket ({sb}, rounded up from "
                    f"{len(prompt)}) exceeds max_len={self.max_len}: the "
                    f"suffix ingest writes bucket-wide")
        self._check_pages(len(prompt), prefix)
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append((rid, prompt, int(max_new_tokens), prefix))
        return rid

    # ------------------------------------------------------------- engine
    def _admit(self, slot: int, rid: int, prompt: np.ndarray, max_new: int,
               prefix: Optional[int] = None) -> None:
        if prefix is None:
            tok = self._admit_plain(slot, prompt)
            cursor = len(prompt)
        else:
            if prefix not in self._prefixes:
                raise KeyError(f"prefix {prefix} was dropped while request "
                               f"{rid} waited in the queue")
            tok = self._admit_prefixed(slot, prompt, prefix)
            cursor = self._prefixes[prefix][1] + len(prompt)
        self._finish_admit(slot, rid, tok, cursor, max_new)

    def _admit_plain(self, slot: int, prompt: np.ndarray):
        """Prefill ``prompt`` into ``slot``; returns its first token."""
        if self.rolling:
            logits, small = _rolling_prefill_state(self.params, self.cfg,
                                                   prompt)
        else:
            logits, small = self._prefill_bucket(
                prompt, _bucket(len(prompt), self.buckets))
        return _write_slot_and_sample(self.cache, small, logits, slot,
                                      self.generator, *self.sampling)

    def _admit_prefixed(self, slot: int, suffix: np.ndarray, prefix: int):
        """File the prefix's rows into positions < plen of ``slot`` (the
        slot's other rows stay), ingest the suffix at ``plen ..`` through
        :func:`chunk_decode_step` on the slot's rows in place (int8 scales
        ride along: every leaf's T axis is at index 3), and sample from
        the suffix's last real position.  Returns the first token."""
        from .speculative import chunk_decode_step

        small, plen = self._prefixes[prefix]
        rows = {name: t[:, slot:slot + 1] for name, t in self.cache.items()}
        for name, row in rows.items():
            row[:, :, :, :plen] = small[name][:, :, :, :plen]
        # Suffix columns past its length are junk at positions above the
        # cursor: masked out of every real token's attention and
        # overwritten by decode before the cursor reaches them.
        tokens = self._padded(suffix, _bucket(len(suffix), self.buckets))
        logits, _ = chunk_decode_step(self.params, rows, tokens, plen,
                                      self.cfg, self.rope)
        return _sample(logits[:, len(suffix) - 1], self.generator,
                       *self.sampling)[0]

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
                self._on_slot_freed(slot)
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
                self._on_slot_freed(slot)
                if self.on_tokens is not None:
                    self.on_tokens(rid, [], True)

    def step(self) -> dict:
        """Admit what fits, decode one chunk; returns {rid: tokens} for
        requests that finished during this step."""
        finished: dict = {}
        self._harvest_dead(finished)  # 1-token / instant-eos admissions
        free = [s for s in range(self.n_slots) if s not in self._slot_rid]
        while free and self._pending:
            _rid, prompt, _max_new, prefix = self._pending[0]
            if not self._admissible(len(prompt), prefix):
                break  # stays queued until in-flight requests free room
            self._admit(free.pop(0), *self._pending.popleft())
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
        # Built per chunk, not kept on self: a stored closure over the
        # bound _decode_one would put the server, and with it the weights
        # and the cache, in a reference cycle that outlives the last name.
        step = make_chunk_scan_step(self._decode_one, self.max_len,
                                    *self.sampling, self.eos_id,
                                    self.generator)
        state = (self.cache, self.token, self.pos, self.live, self.remaining)
        toks, mask = [], []
        for _ in range(self.chunk):
            state, (nxt, emitted) = step(*state)
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
