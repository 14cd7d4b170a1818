"""Serving over the transport: tagged requests in, token streams out.

The repo's two halves meet here: the async tag-matched P2P transport, the
product's surface, carries the serving stack's workload.  Requests arrive
as tagged messages on a :class:`~starway_tpu_torch.Server`,
:class:`~starway_tpu_torch.models.serving.SlotServer` admits them into its
continuous batch on the card, and each request's tokens stream back per
decode chunk over the same connection.  Works over every data plane
behind the one worker contract (in-process, TCP, shared-memory rings, the
C++ engine) -- pinned by tests/test_torch_serve_remote.py's transport
matrix -- and speaks the JAX package's wire protocol exactly, so a JAX
client meets a port server and the reverse.

Wire protocol — all payloads are little-endian int32 arrays; the 64-bit
tag's top byte is the message type (tag routing, reference-style):

====== ========= ================ =======================================
type   direction tag              payload
====== ========= ================ =======================================
0xA1   S -> C    ASSIGN           [client_id, max_prompt_tokens] — sent
                                  on accept; identity for request tags +
                                  the server's request-size limit
0xA2   C -> S    REQUEST | cid    [nonce, max_new, n, prompt x n]
0xA3   S -> C    TOKENS | nonce   [nonce, status, count, tokens x count]
                                  status: 0 = streaming, 1 = done,
                                  2 = aborted (rejected or cancelled)
0xA4   C -> S    CANCEL | cid     [nonce] — abort that request; its slot
                                  frees on the next decode step
====== ========= ================ =======================================

Routing: the matcher reports a completed wildcard recv's SENDER TAG, not
its endpoint, so the request tag carries the server-assigned client_id
(low 32 bits) and the bridge maps it back to the accepted endpoint.  The
token stream needs no client id in its tag — it rides the requesting
client's own connection — so the low bits carry the client-chosen nonce,
letting one client run many concurrent generates.

The nonce is an unsigned 32-bit word.  Unlike the JAX package, which
reflects the signed payload word into the reply tag as it is (a negative
word there clobbers the tag's type byte and the reply never reaches its
client), this module masks it to 32 bits wherever it parses REQUEST and
CANCEL payloads and builds TOKENS tags, and the client refuses to send a
nonce that does not fit 32 bits.

The per-chunk TOKENS messages for one request are FIFO on one
connection (the engine preserves per-connection send order), so the
client just accumulates until ``done``.  Send completion is local:
mid-stream no flush is needed (a dead client just
fails its pending sends, logged and dropped), but serve() flushes once
before returning so a close right after cannot cancel the final chunks
out from under still-reading clients.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..api import Client, Server
from .serving import SlotServer

logger = logging.getLogger("starway.serve_remote")

TAG_TYPE_SHIFT = 56
TAG_ASSIGN = 0xA1 << TAG_TYPE_SHIFT
TAG_REQUEST = 0xA2 << TAG_TYPE_SHIFT
TAG_TOKENS = 0xA3 << TAG_TYPE_SHIFT
TAG_CANCEL = 0xA4 << TAG_TYPE_SHIFT
TYPE_MASK = 0xFF << TAG_TYPE_SHIFT

STATUS_STREAMING, STATUS_DONE, STATUS_ABORTED = 0, 1, 2
FULL_MASK = (1 << 64) - 1
_ID_MASK = (1 << 32) - 1


def _wire(words) -> np.ndarray:
    """int32 payload -> the uint8 byte view the transport sends."""
    return np.ascontiguousarray(np.asarray(words, np.int32)).view(np.uint8)


def _word(nonce: int) -> int:
    """A 32-bit nonce as the int32 payload word with the same bits."""
    return nonce - (1 << 32) if nonce >= 1 << 31 else nonce


def _recv_buf(n_words: int) -> np.ndarray:
    """Receive target (the transport requires uint8); read back with
    ``buf.view(np.int32)``."""
    return np.empty(4 * n_words, np.uint8)


class RemoteSlotServer:
    """Serve a :class:`SlotServer` behind a transport :class:`Server`.

    >>> bridge = RemoteSlotServer(slot_server)
    >>> bridge.server.listen("127.0.0.1", port)
    >>> await bridge.serve()            # until bridge.stop() from a task

    Request ingestion is callback-chained on the engine thread (each
    completed wildcard recv immediately re-posts); the asyncio drive loop
    drains them into ``SlotServer.submit`` and advances decode chunks in
    an executor so the event loop keeps absorbing arrivals while the
    device computes.  Token emission rides ``SlotServer.on_tokens``,
    which only queues: every transport call is made from the loop.
    """

    def __init__(self, slot_server: SlotServer, server: Optional[Server] = None,
                 *, max_prompt_tokens: int = 8192):
        if slot_server.on_tokens is not None:
            raise ValueError("slot_server.on_tokens is already claimed")
        slot_server.on_tokens = self._on_tokens
        self.slot = slot_server
        self.server = server if server is not None else Server()
        self.max_prompt_tokens = int(max_prompt_tokens)
        self._eps: dict[int, object] = {}      # client_id -> endpoint
        self._next_cid = 1
        self._rid_route: dict[int, tuple] = {}  # rid -> (cid, nonce)
        self._emissions: list = []              # (rid, tokens, done)
        self._requests: deque = deque()         # (sender_tag, payload copy)
        self._unassigned: deque = deque()       # cids awaiting their ASSIGN
        self._dead_cids: deque = deque()        # send-failed clients to drop
        self._stopping = False
        self._closed = False
        self._recv_posted = False
        self._cancels: deque = deque()          # (cid, nonce) to abort
        # Cancels that arrived BEFORE their request was submitted (both
        # can land in the queues during one multi-second decode step and
        # cancels drain first): consulted at submit time so the request
        # is rejected instead of the cancel being silently lost.
        # Insertion-ordered and bounded: a cancel for a nonce that never
        # shows up must not leak.
        self._pre_cancels: dict[tuple, bool] = {}
        self.server.set_accept_cb(self._on_accept)

    # ------------------------------------------------- engine-thread side
    def _on_accept(self, ep) -> None:
        cid = self._next_cid
        self._next_cid += 1
        self._eps[cid] = ep
        # The ASSIGN cannot be sent from here: on the in-process path the
        # accept callback fires inline DURING the client's connect, before
        # the client worker reaches RUNNING, and the send would die with
        # "peer closed".  The serve loop flushes it (the client's
        # register() recv waits however late it lands).
        self._unassigned.append(cid)

    def _post_typed_recv(self, tag: int, n_words: int, on_msg) -> None:
        """One self-re-posting wildcard recv chain per message type.
        ``on_msg(sender_tag, words)`` runs on the engine thread and must
        only enqueue.  Failures re-post too: a failed recv is consumed by
        the matcher, so without the re-post one bad message (e.g. a
        truncated oversized request) would permanently halt that type's
        intake."""
        buf = _recv_buf(n_words)

        def done(stag, length, buf=buf):
            try:
                on_msg(int(stag), buf.view(np.int32)[:length // 4].copy())
            except Exception:
                # A sink crash must not break the re-post chain.
                logger.exception("recv sink failed (tag type %x)",
                                 tag >> TAG_TYPE_SHIFT)
            if not self._closed:
                self._post_typed_recv(tag, n_words, on_msg)

        def fail(reason):
            # Expected at close ("cancel...") — not the CANCEL message
            # type, but the engine's op-cancellation reason string.
            if self._closed or "cancel" in reason:
                return
            logger.warning("recv (tag type %x) failed: %s",
                           tag >> TAG_TYPE_SHIFT, reason)
            try:
                self._post_typed_recv(tag, n_words, on_msg)
            except Exception:
                pass  # worker shutting down

        self.server.recv(buf, tag, TYPE_MASK, done, fail)

    def _post_request_recv(self) -> None:
        self._post_typed_recv(
            TAG_REQUEST, 3 + self.max_prompt_tokens,
            lambda stag, words: self._requests.append((stag, words)))

    def _post_cancel_recv(self) -> None:
        def on_msg(stag, words):
            if len(words) >= 1:  # an empty CANCEL payload is just noise
                self._cancels.append((stag & _ID_MASK,
                                      int(words[0]) & _ID_MASK))

        self._post_typed_recv(TAG_CANCEL, 1, on_msg)

    def _on_tokens(self, rid: int, tokens: list, done: bool) -> None:
        # Fires inside SlotServer.step() (executor thread); the drive
        # loop flushes after the step returns, preserving order.
        self._emissions.append((rid, tokens, done))

    # --------------------------------------------------- loop-thread side
    def _drop_dead_clients(self) -> None:
        while self._dead_cids:
            cid = self._dead_cids.popleft()
            if self._eps.pop(cid, None) is not None:
                logger.warning("dropping client %d (send failed)", cid)
            for rid, (rcid, _nonce) in list(self._rid_route.items()):
                if rcid == cid:
                    # Decoding for a peer that will never read the
                    # stream is wasted chip time: free the slot too.
                    self.slot.cancel(rid)
                    del self._rid_route[rid]
            for k in [k for k in self._pre_cancels if k[0] == cid]:
                self._pre_cancels.pop(k, None)  # free the stash budget

    def _drain_cancels(self) -> None:
        while self._cancels:
            cid, nonce = self._cancels.popleft()
            for rid, (rcid, rnonce) in list(self._rid_route.items()):
                if rcid == cid and rnonce == nonce:
                    self.slot.cancel(rid)
                    del self._rid_route[rid]
                    # Closure marker so a still-listening generate()
                    # terminates instead of awaiting forever.
                    self._send_chunk(cid, nonce, [], STATUS_ABORTED)
                    break
            else:
                if cid not in self._eps:
                    continue  # junk/stale cid: nothing to stash for
                # Not routed yet: the REQUEST may still be in flight
                # behind this cancel.  Stash so submit rejects it.
                # Budget is PER CLIENT so one cancel-spraying peer
                # cannot evict another client's genuine pre-cancel.
                self._pre_cancels[(cid, nonce)] = True
                mine = [k for k in self._pre_cancels if k[0] == cid]
                for k in mine[:max(0, len(mine) - 64)]:
                    self._pre_cancels.pop(k, None)

    def _flush_assigns(self) -> None:
        while self._unassigned:
            cid = self._unassigned.popleft()
            ep = self._eps.get(cid)
            if ep is None:
                continue
            # max_prompt_tokens rides along so the client can reject an
            # oversized prompt LOCALLY — sent to the server it would
            # truncate the wildcard recv before the nonce is parsed,
            # leaving nothing to reply to.
            self.server.send(
                ep, _wire([cid, self.max_prompt_tokens]), TAG_ASSIGN,
                lambda: None,
                lambda reason, cid=cid: logger.warning(
                    "assign to client %d failed: %s", cid, reason))

    def _drain_requests(self) -> int:
        n = 0
        while self._requests:
            stag, arr = self._requests.popleft()
            cid = stag & _ID_MASK
            if cid not in self._eps:
                # No endpoint to reply over; the sender is gone or buggy.
                logger.warning("request from unknown client id %d", cid)
                continue
            if len(arr) < 3 or len(arr) != 3 + int(arr[2]):
                logger.warning("malformed request from client %d "
                               "(%d words)", cid, len(arr))
                if len(arr) >= 1:
                    # The nonce survived: reject fatally instead of
                    # leaving the client's generate() awaiting forever.
                    self._send_chunk(cid, int(arr[0]) & _ID_MASK, [],
                                     STATUS_ABORTED)
                continue
            nonce = int(arr[0]) & _ID_MASK
            max_new, n_tok = int(arr[1]), int(arr[2])
            if self._pre_cancels.pop((cid, nonce), False):
                # Cancelled before it was ever submitted (the CANCEL
                # overtook the REQUEST in the drain order).
                self._send_chunk(cid, nonce, [], STATUS_ABORTED)
                continue
            try:
                rid = self.slot.submit(arr[3:3 + n_tok], max_new)
            except (ValueError, KeyError) as e:
                # Reject without killing the serve loop: an empty, fatal
                # "done" stream tells the client this request is over.
                logger.warning("rejected request from client %d: %s",
                               cid, e)
                self._send_chunk(cid, nonce, [], STATUS_ABORTED)
                continue
            self._rid_route[rid] = (cid, nonce)
            n += 1
        return n

    def _send_chunk(self, cid: int, nonce: int, tokens: list,
                    status) -> None:
        ep = self._eps.get(cid)
        if ep is None:
            return
        def failed(reason, cid=cid):
            # Engine-thread callback: only enqueue; the serve loop drops
            # the endpoint and its routes (no cross-thread dict mutation).
            logger.warning("token chunk to client %d failed: %s",
                           cid, reason)
            self._dead_cids.append(cid)

        self.server.send(
            ep, _wire([_word(nonce), int(status), len(tokens), *tokens]),
            TAG_TOKENS | nonce, lambda: None, failed)

    def _flush_emissions(self) -> None:
        emissions, self._emissions = self._emissions, []
        for rid, tokens, done in emissions:
            route = self._rid_route.get(rid)
            if route is None:
                continue  # cancelled mid-step; stream already closed
            cid, nonce = route
            self._send_chunk(cid, nonce, tokens,
                             STATUS_DONE if done else STATUS_STREAMING)
            if done:
                del self._rid_route[rid]

    async def serve(self, *, idle_sleep: float = 0.002) -> None:
        """Drive until :meth:`stop` AND all in-flight work has drained.
        The server must be listening (posting a recv needs a RUNNING
        worker), so call ``bridge.server.listen(...)`` first."""
        if not self._recv_posted:
            self._post_request_recv()
            self._post_cancel_recv()
            self._recv_posted = True
        loop = asyncio.get_running_loop()
        while not (self._stopping and not self.slot.busy
                   and not self._requests):
            self._drop_dead_clients()
            self._drain_cancels()
            self._flush_assigns()
            self._drain_requests()
            if self.slot.busy:
                await loop.run_in_executor(None, self._step)
                self._flush_emissions()
            else:
                await asyncio.sleep(idle_sleep)
        self._flush_emissions()
        # Send completion is LOCAL; a close right after serve()
        # could cancel the final TOKENS chunks still in flight and hang
        # mid-stream clients — the flush is the delivery barrier.
        try:
            await self.server.aflush()
        except Exception as e:  # worker already closing
            logger.warning("final flush failed: %s", e)

    def _step(self) -> None:
        """One ``SlotServer.step`` on the executor thread.  Grad mode and
        the current CUDA device are per thread in torch, so the step sets
        both itself: no autograd graph over the layers, the kernels on the
        server's card."""
        dev = self.slot.device
        on_card = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
        with torch.no_grad(), on_card:
            self.slot.step()

    def stop(self) -> None:
        """Finish in-flight requests, then let serve() return."""
        self._stopping = True

    async def aclose(self) -> None:
        self._closed = True
        await self.server.aclose()


class RemoteGenerateSession:
    """Client-side counterpart: submit prompts, await token streams.

    >>> session = await RemoteGenerateSession.aconnect(addr, port)
    >>> tokens = await session.generate(prompt, max_new_tokens=32)

    ``generate`` calls may run concurrently on one session (distinct
    nonces route the streams); tokens accumulate per decode chunk, so
    wrapping the recv loop yields true streaming if a caller wants it.
    """

    class Handle:
        """Out-param for generate(): carries the request nonce so the
        caller can cancel() a stream it no longer wants."""

        nonce: Optional[int] = None

    def __init__(self, client: Client):
        self.client = client
        self.client_id: Optional[int] = None
        self.server_max_prompt: Optional[int] = None
        self._nonce = 0

    @classmethod
    async def aconnect(cls, addr: str, port: int) -> "RemoteGenerateSession":
        client = Client()
        await client.aconnect(addr, port)
        session = cls(client)
        await session.register()
        return session

    async def register(self) -> int:
        """Receive the server-assigned client id (sent on accept)."""
        buf = _recv_buf(2)
        await self.client.arecv(buf, TAG_ASSIGN, FULL_MASK)
        words = buf.view(np.int32)
        self.client_id = int(words[0])
        self.server_max_prompt = int(words[1])
        return self.client_id

    async def generate(self, prompt, max_new_tokens: int,
                       *, max_chunk_tokens: int = 4096,
                       on_tokens=None, handle: "Optional[Handle]" = None) -> np.ndarray:
        """Round-trip one request; returns the generated tokens.

        ``on_tokens(list)``: optional per-chunk streaming callback.
        ``handle``: a :class:`Handle` that receives the request nonce
        before the request is sent — pass it to :meth:`cancel` from
        another task to abort the stream server-side."""
        if self.client_id is None:
            raise RuntimeError("call register() (or aconnect()) first")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if (self.server_max_prompt is not None
                and len(prompt) > self.server_max_prompt):
            # Server-side this would truncate the request recv before the
            # nonce is parsed — unanswerable; reject here instead.
            raise ValueError(
                f"prompt ({len(prompt)} tokens) exceeds the server's "
                f"request limit ({self.server_max_prompt})")
        nonce = self._nonce
        if nonce != nonce & _ID_MASK:
            # The server masks the nonce word to 32 bits; a wider nonce
            # would await a stream tagged with bits no reply carries.
            raise ValueError(f"nonce {nonce} does not fit 32 bits")
        self._nonce = (nonce + 1) & _ID_MASK
        if handle is not None:
            handle.nonce = nonce
        req = _wire(np.concatenate([
            np.asarray([_word(nonce), int(max_new_tokens), len(prompt)],
                       np.int32),
            prompt]))
        await self.client.asend(req, TAG_REQUEST | self.client_id)
        out: list = []
        while True:
            buf = _recv_buf(3 + max_chunk_tokens)
            await self.client.arecv(buf, TAG_TOKENS | nonce, FULL_MASK)
            words = buf.view(np.int32)
            count, status = int(words[2]), int(words[1])
            chunk = [int(t) for t in words[3:3 + count]]
            out.extend(chunk)
            if chunk and on_tokens is not None:
                on_tokens(chunk)
            if status == STATUS_ABORTED:
                raise ValueError(
                    "request rejected or cancelled by the server "
                    f"(after {len(out)} tokens); rejections mean "
                    "prompt/max_new exceeded the server's max_len")
            if status == STATUS_DONE:
                return np.asarray(out, np.int32)

    async def cancel(self, handle: "Handle") -> None:
        """Abort the stream identified by ``handle`` server-side: its
        slot frees on the next decode step and the stream terminates
        with an aborted marker (the awaiting generate() raises)."""
        if handle.nonce is None:
            raise ValueError("handle was never passed to generate()")
        if handle.nonce != handle.nonce & _ID_MASK:
            raise ValueError(f"nonce {handle.nonce} does not fit 32 bits")
        await self.client.asend(_wire([_word(handle.nonce)]),
                                TAG_CANCEL | self.client_id)

    async def aclose(self) -> None:
        await self.client.aclose()
