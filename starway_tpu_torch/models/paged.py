"""Paged continuous batching: the serving cache as a shared page pool.

The dense :class:`~starway_tpu_torch.models.serving.SlotServer` cache
reserves ``n_slots x max_len`` positions whatever the requests use.
Paging shares one pool of fixed-size pages across the slots, so device
memory follows the live tokens:

* pool ``k/v [L, n_pages, Hkv, page, D]``, sized by the tokens expected in
  flight, not by ``n_slots x max_len``;
* host-managed page tables ``[n_slots, max_pages]`` and a free list; pages
  are taken lazily as each cursor grows and return to the pool when a
  request finishes or is cancelled;
* decode attention walks the table inside the CUDA kernel
  (ops/paged.py), so no dense view is built and each live page is read
  once.

Page 0 is a reserved trash page: the table rows of free slots point at
it, so the frozen-cursor writes of dead slots land where no live slot
attends.  Dead slots may write the same trash position in one step; the
last write wins and nothing reads it.

Prefix sharing: a registered prefix's whole pages are referenced, not
copied, by every request that continues it (refcounted); only the partial
tail page that the suffix continues inside is copied into the slot's
first own page, and the suffix is ingested as one chunk of
``C = suffix bucket`` positions over the page table.

Greedy outputs equal the dense server's and ``generate()``'s: paging
changes where the bytes live, not what attention computes.  Scope:
full-causal models with a cache in the compute dtype (sliding-window and
int8 caches are refused, as the JAX package refuses them), over a whole
tree or any sharded serving tree (models/sharded.py): each slot holds a
contiguous pool part ``[L, n_pages, Hkv / tp, page, D]`` of its kv heads,
every data group a part of the whole page range; the page table, the
free list and the prefix registry stay one a server.  Admission writes
(a prompt's pages, a prefix's, a prefixed suffix's) go to every local
data group's pool; a decode step writes each row's entries into its own
group's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.paged import paged_decode_attention
from .generate import _sample, cached_layer_scan
from .llama import LlamaConfig, embed_tokens, final_logits
from .serving import SlotServer, _bucket
from .sharded import HeadSplit, data_groups, per_part, tree_mesh


def init_paged_pool(cfg: LlamaConfig, n_pages: int, page: int,
                    device="cuda", params=None) -> dict:
    """Zeroed k/v pools ``[L, n_pages, Hkv, page, D]`` in the compute dtype
    (page 0 is the trash page).  For a sharded serving tree (``params``),
    each leaf is a models/sharded.py ``HeadSplit``: every local slot's
    own contiguous pool of its kv heads."""
    mesh = None if params is None else tree_mesh(params)
    if mesh is not None:
        from .sharded import shard_cache

        return shard_cache(cfg, params, None, lambda c, _rows:
                           init_paged_pool(c, n_pages, page,
                                           device=mesh.device))
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page, cfg.head_dim)
    dev = torch.device(device)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}


def paged_chunk_step(params, pool, table, tokens, pos, cfg: LlamaConfig,
                     rope):
    """``C`` tokens of each slot in, ``C`` next-token logits out, over the
    pool: the paged form of
    :func:`~starway_tpu_torch.models.speculative.chunk_decode_step`.

    ``tokens [B, C]`` at positions ``pos .. pos + C - 1`` (``pos`` an int
    or ``[B]``); ``table [B, max_pages]`` int32 on the device.  Write-then-
    attend: the new k/v of position p of slot b land in ``pool[table[b, p
    // page], :, p % page]`` in place, then the chunk attends the slot's
    pages through :func:`~starway_tpu_torch.ops.paged.paged_decode_attention`.
    Returns ``(logits [B, C, V] float32, pool)``.  A tree over the data
    axes runs each data group's rows over its pool part."""
    groups = data_groups(params, cfg)
    if groups is not None:
        def one(view, g, rows):
            p = pos[rows] if isinstance(pos, torch.Tensor) and pos.dim() else pos
            return paged_chunk_step(view, groups.cache_of(pool, g),
                                    table[rows], tokens[rows], p, cfg,
                                    rope)[0]

        return groups.run(tokens.shape[0], one,
                          (tokens.shape[1], cfg.vocab_size)), pool
    B, C = tokens.shape
    page = pool["k"].shape[3]
    dev = tokens.device
    cos, sin = rope
    pos_b = torch.as_tensor(pos, dtype=torch.long, device=dev).reshape(-1)
    pos_b = pos_b.expand(B)
    spos = pos_b[:, None] + torch.arange(C, device=dev)[None, :]  # [B, C]
    ri = spos.clamp(0, cos.shape[0] - 1)
    cos_p = cos[ri][:, None]  # [B, 1, C, hd/2]
    sin_p = sin[ri][:, None]
    pids = table.long().gather(1, (spos // page).clamp(max=table.shape[1] - 1))
    offs = spos % page
    pos_i32 = pos_b.int()

    def write(c, u):
        # c [n_pages, Hkv, page, D], u [B, Hkv, C, D]: the index pair
        # selects [B, C, Hkv, D].
        c[pids, :, offs] = u.transpose(1, 2)

    def attend(q, lc):
        return paged_decode_attention(q, lc["k"], lc["v"], table, pos_i32)

    h = embed_tokens(params, tokens, cfg)  # [B, C, D]
    h, pool = cached_layer_scan(params, pool, h, cos_p, sin_p, cfg, write,
                                attend)
    return final_logits(params, h, cfg), pool


def paged_decode_step(params, pool, table, token, pos, cfg: LlamaConfig,
                      rope):
    """One token of each slot in, next-token logits out, over the pool:
    :func:`~starway_tpu_torch.models.generate.decode_step` with the write
    scattered to ``pool[table[b, pos[b] // page], :, pos[b] % page]`` and
    the attention through the paged kernel.  ``token``/``pos`` ``[B]``.
    Returns ``(logits [B, V] float32, pool)``."""
    logits, pool = paged_chunk_step(params, pool, table, token[:, None], pos,
                                    cfg, rope)
    return logits[:, 0], pool


class PagedSlotServer(SlotServer):
    """Continuous batching over a shared page pool.

    >>> srv = PagedSlotServer(params, cfg, n_slots=8, max_len=512,
    ...                       page=64, n_pages=33)
    >>> rid = srv.submit(prompt, max_new_tokens=32)
    >>> done = srv.run()

    The dense server's queue, streaming, cancel and prefix surface, and its
    greedy-equals-``generate()`` result; ``n_pages`` bounds the live tokens
    (``(n_pages - 1) * page``) instead of reserving ``max_len`` per slot.

    Admission is decided before any device work: ``submit`` refuses a
    request whose admission needs more pages than the pool has; ``step``
    admits the head of the queue only when enough pages are free, keeps it
    queued while requests in flight will return pages, and raises
    ``RuntimeError`` when none will.  Lazy growth that exhausts the pool
    mid-generation raises ``RuntimeError`` ("page pool exhausted"):
    preemption is not implemented, so size ``n_pages`` for the expected
    concurrency.  Pages are taken from the free list, and shared pages'
    refcounts raised, only after the device work of an admission or a
    prefix registration has returned.
    """

    def __init__(self, params, cfg: LlamaConfig, *, n_slots: int = 4,
                 max_len: int = 512, page: int = 64,
                 n_pages: Optional[int] = None, chunk: int = 8,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 on_tokens=None):
        if cfg.sliding_window is not None:
            raise NotImplementedError(
                "paged serving is full-causal; sliding-window models serve "
                "in O(window) through rolling caches instead")
        if cfg.kv_quant != "none":
            raise NotImplementedError(
                "int8 paged pools are not supported; use the dense "
                "SlotServer for kv_quant='int8'")
        if page < 1 or max_len % page:
            raise ValueError(f"page ({page}) must divide max_len "
                             f"({max_len})")
        self.page = int(page)
        self.max_pages = max_len // page
        if n_pages is None:
            n_pages = 1 + n_slots * self.max_pages  # the dense equivalent
        if n_pages < 2:
            raise ValueError("need n_pages >= 2 (page 0 is the trash page)")
        self.n_pages = int(n_pages)
        # Page multiples, so that an admission fills whole pages.
        b, buckets = self.page, []
        while b < max_len:
            buckets.append(b)
            b *= 2
        super().__init__(params, cfg, n_slots=n_slots, max_len=max_len,
                         chunk=chunk, temperature=temperature, top_k=top_k,
                         top_p=top_p, eos_id=eos_id,
                         prompt_buckets=tuple(buckets) + (max_len,),
                         seed=seed, on_tokens=on_tokens)

    # ------------------------------------------------------------- hooks
    def _make_cache(self):
        return init_paged_pool(self.cfg, self.n_pages, self.page,
                               device=self.device, params=self.params)

    def _post_init(self) -> None:
        # Host allocator: every slot starts on the trash page.
        self._tables = np.zeros((self.n_slots, self.max_pages), np.int32)
        self._table_dev = torch.zeros((self.n_slots, self.max_pages),
                                      dtype=torch.int32, device=self.device)
        self._free = list(range(1, self.n_pages))
        # Shared prefix pages: refcount = the registry's one + each slot
        # that references the page; it returns to the pool at 0.
        self._page_refs: dict[int, int] = {}

    def _on_slot_freed(self, slot: int) -> None:
        for pid in map(int, self._tables[slot]):
            if pid == 0:
                continue
            if pid in self._page_refs:  # a shared prefix page
                self._page_refs[pid] -= 1
                if self._page_refs[pid] == 0:  # its prefix was dropped
                    del self._page_refs[pid]
                    self._free.append(pid)
            else:
                self._free.append(pid)
        self._tables[slot] = 0

    def _decode_one(self, cache, token, pos):
        return paged_decode_step(self.params, cache, self._table_dev, token,
                                 pos, self.cfg, self.rope)

    @property
    def pages_in_use(self) -> int:
        """Pool pages held by slots and registered prefixes."""
        return self.n_pages - 1 - len(self._free)

    # ------------------------------------------------------------- pages
    def _table_pages(self, prompt_len: int, prefix: Optional[int]) -> int:
        """Pages that a request's table row covers at admission."""
        plen = 0 if prefix is None else self._prefixes[prefix][1]
        return -(-(plen + _bucket(prompt_len, self.buckets)) // self.page)

    def _own_pages(self, prompt_len: int, prefix: Optional[int]) -> int:
        """Pages an admission takes from the free list (a prefix's whole
        pages are shared)."""
        plen = 0 if prefix is None else self._prefixes[prefix][1]
        return self._table_pages(prompt_len, prefix) - plen // self.page

    def _check_pages(self, prompt_len: int, prefix: Optional[int]) -> None:
        need = self._table_pages(prompt_len, prefix)
        if need > self.n_pages - 1:
            raise ValueError(
                f"the request needs {need} pages at admission and the pool "
                f"has {self.n_pages - 1}: it could never be admitted; size "
                f"n_pages for the workload")

    def _admissible(self, prompt_len: int, prefix: Optional[int]) -> bool:
        need = self._own_pages(prompt_len, prefix)
        if need <= len(self._free):
            return True
        if self._slot_rid:
            return False  # requests in flight will return pages
        raise RuntimeError(
            f"page pool exhausted: the next request needs {need} page(s), "
            f"{len(self._free)} are free and no request in flight holds any "
            f"(registered prefixes hold {len(self._page_refs)}); drop a "
            f"prefix or size n_pages for the workload")

    def _peek_free(self, n: int) -> list:
        """The ``n`` pages that the next allocation takes, left on the
        free list until :meth:`_commit`."""
        if n > len(self._free):
            raise RuntimeError(f"page pool exhausted: {n} page(s) needed, "
                               f"{len(self._free)} free")
        return self._free[len(self._free) - n:][::-1]

    def _commit(self, n: int) -> None:
        del self._free[len(self._free) - n:]

    def _alloc_to(self, slot: int, n_needed: int) -> None:
        """Extend the slot's table to ``n_needed`` pages."""
        row = self._tables[slot]
        have = int((row != 0).sum())
        n_needed = min(n_needed, self.max_pages)
        if n_needed > have and len(self._free) < n_needed - have:
            raise RuntimeError(
                f"page pool exhausted: slot {slot} needs "
                f"{n_needed - have} more page(s), {len(self._free)} free "
                f"(n_pages={self.n_pages}); finish or cancel requests or "
                f"size the pool for the workload")
        for i in range(have, n_needed):
            row[i] = self._free.pop()

    def _file_pages(self, small: dict, pids: list, n: int) -> dict:
        """Scatter the first ``n`` pages of a prefill cache ``[L, 1, Hkv,
        bucket, D]`` into pool pages ``pids`` (of every local group, each
        slot's part from the part at its view index: ``DataGroups.spread``);
        returns every page of it as ``[L, bucket / page, Hkv, page, D]``
        views (over data groups, one at each view index)."""
        def pages(t):
            L, _, hkv, width, d = t.shape
            return t.reshape(L, hkv, width // self.page, self.page,
                             d).transpose(1, 2)

        groups = self._groups
        ids = torch.tensor(pids[:n], device=self.device)
        if groups is None:
            paged = {name: per_part(pages, small[name]) for name in self.cache}
            for name, c in self.cache.items():
                if n:
                    c[:, ids] = per_part(lambda t: t[:, :n], paged[name])
            return paged
        paged = {name: {k: pages(t) for k, t in small[name].items()}
                 for name in self.cache}
        for g in groups.local:
            for j, k in groups.members[g]:
                for name, c in self.cache.items():
                    if n:
                        c.parts[j][:, ids] = paged[name][k][:, :n]
        return paged

    # --------------------------------------------------------- admission
    def register_prefix(self, tokens) -> int:
        """Prefill a shared prefix once into pool pages.  Requests with
        ``prefix=pid`` reference its whole pages (refcounted across slots)
        and copy only the partial tail page that their suffix continues
        inside, which the registry keeps beside the pool."""
        tokens = self._check_prefix_tokens(tokens)
        plen = len(tokens)
        n_full = plen // self.page
        pids = self._peek_free(n_full)
        _logits, small = self._prefill_bucket(
            tokens, _bucket(plen, self.buckets))
        paged = self._file_pages(small, pids, n_full)
        def tail(t):
            return t[:, n_full].clone()

        tails = {name: (None if not plen % self.page else
                        per_part(tail, p) if self._groups is None else
                        {k: tail(t) for k, t in p.items()})
                 for name, p in paged.items()}
        self._commit(n_full)
        for p in pids:
            self._page_refs[p] = 1  # the registry's own reference
        pid = self._next_pid
        self._next_pid += 1
        self._prefixes[pid] = ((tuple(pids), tails["k"], tails["v"]), plen)
        return pid

    def drop_prefix(self, pid: int) -> None:
        """Release the registry's reference; the whole pages return to the
        pool once no admitted slot reads them."""
        self._refuse_drop_if_queued(pid)
        (pids, _tk, _tv), _plen = self._prefixes.pop(pid)
        for p in pids:
            self._page_refs[p] -= 1
            if self._page_refs[p] == 0:
                del self._page_refs[p]
                self._free.append(p)

    def _admit_plain(self, slot: int, prompt: np.ndarray):
        pb = _bucket(len(prompt), self.buckets)
        pids = self._peek_free(pb // self.page)
        logits, small = self._prefill_bucket(prompt, pb)
        self._file_pages(small, pids, len(pids))
        tok = _sample(logits, self.generator, *self.sampling)[0]
        self._commit(len(pids))
        self._tables[slot, :len(pids)] = pids
        return tok

    def _admit_prefixed(self, slot: int, suffix: np.ndarray, prefix: int):
        (shared, _tk, _tv), plen = self._prefixes[prefix]
        n_own = self._own_pages(len(suffix), prefix)
        row = np.zeros(self.max_pages, np.int32)
        row[:len(shared)] = shared
        row[len(shared):len(shared) + n_own] = self._peek_free(n_own)
        logits = self._ingest_prefixed(row, suffix, prefix)
        tok = _sample(logits, self.generator, *self.sampling)[0]
        self._commit(n_own)
        for p in shared:
            self._page_refs[p] += 1
        self._tables[slot] = row
        return tok

    def _ingest_prefixed(self, row: np.ndarray, suffix: np.ndarray,
                         prefix: int):
        """The device work of a prefixed admission into the pages of
        ``row``: copy the prefix's tail page into the first own page, then
        ingest the suffix as one ``C = bucket`` chunk over the table.
        Returns the logits ``[1, V]`` of the suffix's last real token."""
        (_shared, tail_k, tail_v), plen = self._prefixes[prefix]
        table = torch.from_numpy(row[None]).to(self.device)
        tokens = self._padded(suffix, _bucket(len(suffix), self.buckets))
        own0 = int(row[plen // self.page])
        groups = self._groups

        def ingest(params, pool, tails):
            if tail_k is not None:
                pool["k"][:, own0], pool["v"][:, own0] = tails
            return paged_chunk_step(params, pool, table, tokens, plen,
                                    self.cfg, self.rope)[0]

        if groups is None:
            logits = ingest(self.params, self.cache, (tail_k, tail_v))
        else:
            # Every group's pool takes the suffix's pages, each slot's part
            # the tail at its view index.
            def tails_of(g):
                return tuple(None if t is None else HeadSplit(
                    [t[k] for _, k in groups.members[g]], 2)
                    for t in (tail_k, tail_v))

            outs = groups.each(range(groups.size), lambda view, g: ingest(
                view, groups.cache_of(self.cache, g), tails_of(g)))
            logits = outs[min(outs)]
        return logits[:, len(suffix) - 1]

    # ------------------------------------------------------------ decode
    def _run_chunk(self):
        # Lazy growth: the chunk writes positions pos .. pos + chunk - 1 of
        # every live slot, so its table must reach (pos + chunk - 1) // page.
        pos = self.pos.cpu().numpy()
        live = self.live.cpu().numpy()
        for slot in np.flatnonzero(live):
            reach = min(int(pos[slot]) + self.chunk, self.max_len)
            self._alloc_to(int(slot), -(-reach // self.page))
        self._table_dev.copy_(torch.from_numpy(self._tables))
        return super()._run_chunk()
