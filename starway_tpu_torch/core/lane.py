"""Multi-rail striping: the Lane abstraction and the stripe scheduler.

One message, many transports (DESIGN.md §17; ROADMAP item 1).  A railed
connection (``STARWAY_RAILS``, core/frames.py ``"rails"``/``"rail_of"``
handshake keys) exposes N interchangeable :class:`Lane` objects -- the
primary conn (tcp or sm-upgraded) plus N-1 secondary TCP conns -- and a
send at or above ``STARWAY_STRIPE_THRESHOLD`` is split at
``STARWAY_STRIPE_CHUNK`` granularity and pushed across ALL of them
concurrently:

* **TX** -- :class:`RailGroup` (on the primary conn) owns a FIFO of
  :class:`StripeSource` records (one per striped message, holding the
  payload by reference until the receiver's T_SACK).  Each lane runs one
  persistent :class:`StripeFeeder` tx item that *claims* the next chunk
  from the group the moment its current chunk finishes writing --
  completion-driven work stealing, not static round-robin: a lane twice
  as fast naturally carries twice the chunks, and a stalled lane stops
  claiming.  Each lane tracks an EWMA of its delivered throughput, and
  under ``STARWAY_STRIPE_WEIGHTED`` a slow lane (below half the fastest
  live lane's EWMA) declines *steal* claims in a message's tail so the
  last chunks avoid stragglers -- dispatch claims are never declined,
  which is what keeps a declined chunk from stranding (DESIGN.md §17).
  Each chunk travels as a self-describing T_SDATA frame
  (msg id, offset, total), so chunks are idempotent and unordered.
* **RX** -- :class:`StripeRx` (on the receiving side's primary conn)
  reassembles by offset into ONE matcher message per msg id, whatever
  rail each chunk arrived on.  Duplicate offsets are drained and dropped
  (exactly-once bytes under rail death, FaultProxy ``duplicate``, and
  session replay), and assembly completion answers T_SACK.
* **Failure** -- a *rail* dying mid-stripe re-queues that rail's
  claimed-but-unacked chunks onto the surviving lanes
  (``rail_resteals``); the payload is pinned until SACK, so the resend is
  always legal.  Only the PRIMARY dying takes the usual contract: seed
  semantics fail the striped ops, a live session suspends and
  re-dispatches every un-SACKed source wholesale at resume -- sessions
  journal per-message, never per-lane (CLAUDE.md invariant).

The flush barrier never rides the rails: secondary lanes carry only
SDATA/SACK (+ liveness probes), and a worker/endpoint flush additionally
waits until every source submitted before it is SACKed
(core/engine.py FlushRec.stripe_waits) -- which covers striped delivery
end-to-end even while chunks are mid-resteal.

The C++ engine implements the identical scheduler in
native/sw_engine.cpp (``StripeSrc``/``StripeAsm``); all four engine
pairings interoperate chunk-for-chunk.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from .. import config
from ..errors import REASON_CANCELLED
from . import frames, swtrace

#: EWMA smoothing for per-lane delivered throughput (one update per
#: completed chunk; ~3-4 chunks to converge after a speed change).
EWMA_ALPHA = 0.3

#: A lane slower than this fraction of the fastest live lane's EWMA
#: declines tail steals under STARWAY_STRIPE_WEIGHTED.
SLOW_FRACTION = 0.5

#: Completed-message ids remembered per receiving rail group so a late or
#: replayed chunk re-SACKs instead of corrupting state.  Bounded: the
#: sender stops resending a message at first SACK, so only a small recent
#: window can ever see stragglers.
DONE_LRU = 4096


class Lane:
    """Stripe-target view of one transport (a conn): the scheduling unit
    of the rail set.  ``idx`` 0 is the primary; the feeder is this lane's
    persistent tx item while it has (or may claim) chunks."""

    __slots__ = ("conn", "idx", "feeder", "chunks_tx", "ewma_bps",
                 "tail_declines")

    def __init__(self, conn, idx: int):
        self.conn = conn
        self.idx = idx
        self.feeder: Optional["StripeFeeder"] = None
        self.chunks_tx = 0  # cumulative chunks this lane carried (balance)
        self.ewma_bps = 0.0  # delivered-throughput EWMA (0 = no data yet)
        self.tail_declines = 0  # tail steals declined as the slow lane

    @property
    def alive(self) -> bool:
        c = self.conn
        return c.alive and c.sock is not None

    def note_chunk(self, nbytes: int, dt: float) -> None:
        """One chunk fully written after ``dt`` seconds on this lane:
        fold it into the throughput EWMA (tracked unconditionally -- one
        multiply per chunk; only the weighted-claim *policy* is gated)."""
        if dt <= 0.0 or nbytes <= 0:
            return
        bps = nbytes / dt
        self.ewma_bps = (bps if self.ewma_bps == 0.0
                         else (1.0 - EWMA_ALPHA) * self.ewma_bps
                         + EWMA_ALPHA * bps)


class StripeSource:
    """One striped outgoing message.  Holds the payload BY REFERENCE
    until the receiver's T_SACK (or terminal failure): chunks may be
    resent after a rail death or a session resume, so the bytes must stay
    stable -- rendezvous rules, whatever the size (config.py
    STARWAY_STRIPE_THRESHOLD)."""

    __slots__ = ("msg_id", "tag", "payload", "total", "chunk", "done",
                 "fail", "owner", "pending", "rail_offs", "done_offs",
                 "unwritten", "writers", "local_done", "counted", "sacked",
                 "failed", "t_post", "__weakref__")

    def __init__(self, msg_id: int, tag: int, payload, done, fail, owner,
                 chunk: int):
        self.t_post = time.perf_counter()  # swpulse pin/send origin (§25)
        self.msg_id = msg_id
        self.tag = tag
        self.payload = payload
        self.total = len(payload)
        self.chunk = chunk
        self.done = done
        self.fail = fail
        self.owner = owner
        self.pending: deque = deque(range(0, self.total, chunk))
        # Per-lane chunk ledgers, kept until SACK so a dead rail's share
        # can be re-queued: offsets IN FLIGHT on the lane (claimed, not
        # fully written) vs already WRITTEN to its transport -- the split
        # keeps `unwritten` exact across a resteal.
        self.rail_offs: dict = {}  # conn_id -> [offsets in flight]
        self.done_offs: dict = {}  # conn_id -> [offsets fully written]
        self.unwritten = len(self.pending)
        self.writers = 0         # feeders holding a chunk of this source
        self.local_done = False  # transmission begun (rndv semantics)
        self.counted = False     # sends_completed recorded once
        self.sacked = False
        self.failed = False

    def chunk_len(self, off: int) -> int:
        return min(self.chunk, self.total - off)

    def started(self) -> bool:
        return (self.local_done or bool(self.rail_offs)
                or bool(self.done_offs))

    def maybe_release(self) -> None:
        """Drop the payload pin once the source is settled AND no feeder
        is mid-frame on it -- a frame header already promised its chunk's
        bytes, so the view must stay valid until that frame completes."""
        if (self.sacked or self.failed) and self.writers <= 0:
            self.payload = None
            self.owner = None

    def settle(self, fires: list, reason: Optional[str],
               force: bool = False) -> None:
        """Terminal: fire the op outcome exactly once and release the
        payload pin (immediately when ``force`` -- terminal conn teardown,
        no feeder will ever touch it again)."""
        if reason is not None and not self.failed:
            self.failed = True
            if not self.local_done and self.fail is not None:
                fires.append(lambda f=self.fail, r=reason: f(r))
            self.local_done = True
        if force:
            self.writers = 0
        self.maybe_release()


class StripeFeeder:
    """One lane's persistent tx-queue item: streams its current chunk and
    claims the next from the group when it finishes (the work-stealing
    edge).  Speaks the same duck-typed tx protocol as TxData/TxCtl
    (core/conn.py); ``counted`` is pre-set so the generic pump accounting
    skips it -- the SOURCE owns per-message accounting."""

    __slots__ = ("group", "lane", "src", "chunk_off", "header", "chunk_end",
                 "written", "switch_after", "counted", "sess_seq",
                 "sess_nbytes", "e2e_ord", "claim_t0")

    def __init__(self, group: "RailGroup", lane: Lane):
        self.group = group
        self.lane = lane
        self.src: Optional[StripeSource] = None
        self.chunk_off = 0
        self.header = b""
        self.chunk_end = 0
        self.written = 0
        self.switch_after = False
        self.counted = True   # generic pump accounting: not a data item
        self.sess_seq = 0     # chunks are never seq-framed (idempotent)
        self.sess_nbytes = 0
        self.e2e_ord = 0
        self.claim_t0 = 0.0   # perf_counter at claim (lane EWMA sample)

    # ------------------------------------------------------------- claim
    def _claim(self, steal: bool = True) -> bool:
        nxt = self.group.claim_next(self.lane, steal)
        if nxt is None:
            return False
        src, off = nxt
        self.claim_t0 = time.perf_counter()
        self.src = src
        src.writers += 1
        self.chunk_off = off
        n = src.chunk_len(off)
        self.header = frames.pack_sdata_header(src.tag, src.msg_id, off,
                                               src.total, n)
        if self.lane.conn.csum_ok:
            # §19 integrity: every chunk frame is self-verifying -- the
            # prefix's crc_head covers header+sub-header (so routing is
            # validated before the chunk bytes land in a sink), crc_frame
            # the chunk bytes too.  Per-lane: each rail negotiated csum
            # in its own handshake.
            self.header = frames.pack_csum_for(
                self.header, src.payload[off:off + n]) + self.header
        self.chunk_end = off + n
        self.written = 0
        return True

    def _drop_src(self) -> None:
        src, self.src = self.src, None
        if src is not None:
            src.writers -= 1
            src.maybe_release()

    def _frame_total(self) -> int:
        return len(self.header) + (self.chunk_end - self.chunk_off)

    @property
    def off(self) -> int:
        """Generic tx-item progress (the close path's untouched-item
        check reads ``tx[0].off``): bytes of the current frame written."""
        return self.written

    @property
    def remaining(self) -> int:
        if self.src is None and not self._claim():
            return 0
        return self._frame_total() - self.written

    def tx_views(self, max_bytes: int) -> list:
        if self.src is None and not self._claim():
            return []
        views = []
        take = 0
        hlen = len(self.header)
        if self.written < hlen:
            h = memoryview(self.header)[self.written:]
            views.append(h)
            take = len(h)
        if take < max_bytes:
            pos = max(self.written - hlen, 0)
            sl = self.src.payload[self.chunk_off + pos:
                                  self.chunk_end]
            sl = sl[: max_bytes - take]
            if len(sl):
                views.append(sl)
        return views

    def advance(self, n: int, fires: list) -> None:
        if self.src is None:
            return
        self.written += n
        if n > 0 and not self.src.local_done:
            # Transmission begun: rndv-style local completion for the
            # whole striped message (DESIGN.md §17).
            self.group.first_progress(self.src, fires)
        if self.written >= self._frame_total():
            self.lane.note_chunk(self.chunk_end - self.chunk_off,
                                 time.perf_counter() - self.claim_t0)
            self.group.chunk_written(self.lane, self.src, self.chunk_off,
                                     fires)
            self._drop_src()
            self._claim()  # work-stealing: grab the next chunk now

    def write(self, conn, fires: list) -> bool:
        """Ring-transport path (sm-upgraded primary): stream chunk frames
        until the group runs dry or the ring fills."""
        while True:
            if self.src is None and not self._claim():
                return True
            hlen = len(self.header)
            while self.written < self._frame_total():
                if self.written < hlen:
                    chunk = memoryview(self.header)[self.written:]
                else:
                    pos = self.chunk_off + (self.written - hlen)
                    chunk = self.src.payload[pos: self.chunk_end]
                try:
                    n = conn._tx_write(chunk)
                except BlockingIOError:
                    if self.written > 0 and not self.src.local_done:
                        self.group.first_progress(self.src, fires)
                    return False
                self.written += n
                if not self.src.local_done:
                    self.group.first_progress(self.src, fires)
            self.lane.note_chunk(self.chunk_end - self.chunk_off,
                                 time.perf_counter() - self.claim_t0)
            self.group.chunk_written(self.lane, self.src, self.chunk_off,
                                     fires)
            self._drop_src()

    def cancel(self, fires: list, reason: str = REASON_CANCELLED) -> None:
        # The SOURCE owns the op callbacks; a dying lane's feeder is
        # inert -- rail_lost / group teardown settles the sources.
        self._drop_src()


class StripeAsm:
    """Receiver-side reassembly of one striped message: the matcher's
    InboundMsg plus the offset-dedup set that makes chunks idempotent."""

    __slots__ = ("msg_id", "tag", "total", "received", "msg", "offs")

    def __init__(self, msg_id: int, tag: int, total: int, msg):
        self.msg_id = msg_id
        self.tag = tag
        self.total = total
        self.received = 0
        self.msg = msg  # matching.InboundMsg (sink/discard/posted)
        self.offs: set = set()


class StripeRx:
    """Per-rail-group receive state, living on the primary conn: chunks
    from ANY rail of the group land in the same assembly table."""

    __slots__ = ("root", "asms", "done_ids", "done_fifo")

    def __init__(self, root):
        self.root = root  # primary TcpConn
        self.asms: dict = {}
        self.done_ids: set = set()
        self.done_fifo: deque = deque()

    def chunk_start(self, tag: int, msg_id: int, off: int, total: int,
                    chunk_len: int, fires: list):
        """Resolve one arriving chunk.  Returns the assembly to stream
        into, or None when the chunk must be drained (duplicate offset /
        already-completed message -- the caller re-SACKs those)."""
        if msg_id in self.done_ids:
            return None  # late resend of a completed message: re-SACK
        asm = self.asms.get(msg_id)
        if asm is None:
            worker = self.root.worker
            with worker.lock:
                msg, f = worker.matcher.on_message_start(tag, total)
            fires.extend(f)
            asm = self.asms[msg_id] = StripeAsm(msg_id, tag, total, msg)
        if off in asm.offs or off + chunk_len > total:
            return None  # duplicate (or malformed) chunk: drain + drop
        return asm

    def chunk_done(self, conn, asm: StripeAsm, off: int, chunk_len: int,
                   fires: list) -> None:
        """All bytes of one chunk ingested on ``conn``; completes the
        message (matcher + SACK) when it was the last."""
        if off in asm.offs:
            # A cross-rail duplicate was already streaming when its twin
            # completed (both passed chunk_start before either finished):
            # the bytes are identical, but the accounting must be
            # exactly-once or the assembly completes early and corrupt.
            return
        asm.offs.add(off)
        asm.received += chunk_len
        conn._ctr.stripe_chunks_rx += 1
        if asm.received < asm.total:
            return
        root = self.root
        msg = asm.msg
        msg.received = asm.total
        del self.asms[asm.msg_id]
        self.done_ids.add(asm.msg_id)
        self.done_fifo.append(asm.msg_id)
        while len(self.done_fifo) > DONE_LRU:
            self.done_ids.discard(self.done_fifo.popleft())
        # A cross-rail duplicate of some offset may still be mid-stream
        # on a sibling lane.  Completion hands the sink back to the user
        # (the receive's done fires below), so redirect those writes to
        # the drain path NOW -- the remaining bytes must never land in a
        # buffer the caller may already be reusing.
        for lane_conn in [root] + list(root.rails):
            st = lane_conn._rx_stripe
            if st is not None and st[0] is asm:
                lane_conn._rx_skip = st[2] - lane_conn._rx_stripe_got
                lane_conn._rx_stripe = None
                lane_conn._rx_stripe_got = 0
        worker = root.worker
        with worker.lock:
            fires.extend(worker.matcher.on_message_complete(msg))
        if msg.remote is not None:
            # §18 rendezvous delivery: resolve the descriptor record so
            # deferred flush ACKs release, and let the now-complete
            # message behave like ordinary staged data from here on.
            msg.remote = None
            root.fc_rx.pop(asm.msg_id, None)
            root.remote_resolved(msg, fires)
        self.sack(conn, asm.msg_id, asm.total, fires)
        if root._ring is not None and root.tr_id:
            # swscope: ONE end-to-end marker per striped message, on the
            # primary, ordinal = msg_id (shared wire state, so the pair
            # survives out-of-order assembly completion).
            root._ring.rec(swtrace.EV_E2E, asm.msg_id, root.conn_id,
                           asm.total, root.tr_id + ":sr")
        root._sess_commit()  # no-op off sessions (chunks are unsequenced)

    @staticmethod
    def sack(conn, msg_id: int, total: int, fires: list) -> None:
        if conn.alive and conn.sock is not None:
            conn.send_ctl(frames.pack_sack(msg_id, total), fires)

    def purge(self) -> None:
        """Primary died terminally: partial assemblies can never finish;
        drop them from the matcher so they cannot shadow live traffic."""
        worker = self.root.worker
        with worker.lock:
            for asm in self.asms.values():
                worker.matcher.purge_inflight(asm.msg)
        self.asms.clear()


class RailGroup:
    """TX scheduler for one railed connection (lives on the primary)."""

    __slots__ = ("primary", "lanes", "next_msg_id", "queue", "by_id")

    def __init__(self, primary):
        self.primary = primary
        self.lanes: list = [Lane(primary, 0)]
        self.next_msg_id = 1
        self.queue: deque = deque()  # sources with unclaimed chunks, FIFO
        self.by_id: dict = {}        # msg_id -> source until SACK/terminal

    def add_rail(self, conn) -> Lane:
        lane = Lane(conn, len(self.lanes))
        self.lanes.append(lane)
        return lane

    def live_lanes(self) -> list:
        return [ln for ln in self.lanes if ln.alive]

    def stripe_ok(self, nbytes: int, payload) -> bool:
        """Should this send stripe?  Needs a flat host view (chunks are
        random-offset slices), the threshold armed, and >1 live lane."""
        thr = config.stripe_threshold()
        return (thr > 0 and nbytes >= thr
                and isinstance(payload, memoryview)
                and len(self.live_lanes()) > 1)

    # ------------------------------------------------------------ submit
    def submit(self, tag: int, payload, done, fail, owner,
               fires: list) -> StripeSource:
        src = StripeSource(self.next_msg_id, tag, payload, done, fail,
                           owner, config.stripe_chunk())
        self.next_msg_id += 1
        self.by_id[src.msg_id] = src
        self.queue.append(src)
        self.primary.dirty = True
        self.dispatch(fires)
        return src

    def dispatch(self, fires: list) -> None:
        """Make sure every live lane has an active feeder and kick it.
        Feeders claim their FIRST chunk eagerly: one that cannot claim is
        never queued (a dry feeder parked in tx would stall every frame
        behind it -- the gather pump stops at feeders)."""
        for lane in self.live_lanes():
            feeder = lane.feeder
            conn = lane.conn
            if feeder is None or feeder not in conn.tx:
                feeder = StripeFeeder(self, lane)
                if not feeder._claim(steal=False):
                    break  # group dry: later lanes have nothing to claim
                lane.feeder = feeder
                conn.tx.append(feeder)
            conn.kick_tx(fires)

    def claim_next(self, lane: Lane, steal: bool = False):
        """The work-stealing heart: hand the next pending chunk (FIFO
        across sources) to whichever lane asked first.

        ``steal`` marks a refill claim (a feeder that just finished a
        chunk) as opposed to a dispatch claim.  Only steals may be
        declined by the weighted-tail policy: dispatch always feeds
        every live lane, so a declined chunk can never strand -- any
        requeue path (submit, rail death, NACK retransmit, session
        resume) goes through dispatch, and the fastest live lane never
        declines (its EWMA is the maximum by definition)."""
        while self.queue:
            src = self.queue[0]
            if not src.pending or src.sacked or src.failed:
                self.queue.popleft()
                continue
            break
        for src in self.queue:
            if not src.pending or src.sacked or src.failed:
                continue  # settled mid-queue: dropped when it reaches front
            if steal and self._decline_tail(lane, src):
                # Leave THIS message's tail to faster lanes, but keep
                # scanning: a slow lane declining msg N must still carry
                # the bulk of msg N+1 queued behind it -- idling the
                # lane entirely would halve throughput exactly when the
                # knob is meant to help.
                continue
            off = src.pending.popleft()
            src.rail_offs.setdefault(lane.conn.conn_id, []).append(off)
            lane.chunks_tx += 1
            return src, off
        return None

    def _decline_tail(self, lane: Lane, src: StripeSource) -> bool:
        """STARWAY_STRIPE_WEIGHTED tail bias (DESIGN.md §17): in the last
        chunks of a message -- where handing the final chunk to a slow
        lane makes that lane's drain time the WHOLE message's completion
        time -- a lane whose delivered-throughput EWMA sits below
        SLOW_FRACTION of the fastest live lane's declines the steal."""
        if not config.stripe_weighted() or lane.ewma_bps <= 0.0:
            return False
        live = self.live_lanes()
        if len(live) < 2 or len(src.pending) > len(live):
            return False  # not the tail (or nobody else to leave it to)
        best = max(ln.ewma_bps for ln in live)
        if lane.ewma_bps >= SLOW_FRACTION * best:
            return False
        lane.tail_declines += 1
        return True

    # -------------------------------------------------------- completion
    def first_progress(self, src: StripeSource, fires: list) -> None:
        if src.local_done:
            return
        src.local_done = True
        us = int((time.perf_counter() - src.t_post) * 1e6)
        self.primary._hists.send_local_us[swtrace.hist_bucket(us)] += 1
        if src.done is not None:
            fires.append(src.done)

    def chunk_written(self, lane: Lane, src: StripeSource, off: int,
                      fires: list) -> None:
        prim = self.primary
        prim._ctr.stripe_chunks_tx += 1
        prim.retx_offs.discard((src.msg_id, off))  # §19 retx satisfied
        cid = lane.conn.conn_id
        infl = src.rail_offs.get(cid)
        if infl is not None and off in infl:
            infl.remove(off)
            src.done_offs.setdefault(cid, []).append(off)
        src.unwritten -= 1
        if src.unwritten <= 0 and not src.pending and not src.counted:
            src.counted = True
            prim._ctr.sends_completed += 1
            if prim._ring is not None and prim.tr_id:
                prim._ring.rec(swtrace.EV_E2E, src.msg_id, prim.conn_id,
                               src.total, prim.tr_id + ":sx")

    def on_sack(self, msg_id: int, fires: list) -> None:
        src = self.by_id.pop(msg_id, None)
        if src is None or src.sacked:
            return
        if self.primary.retx_offs:
            self.primary.retx_offs = {
                t for t in self.primary.retx_offs if t[0] != msg_id}
        src.sacked = True
        # swpulse pin residency (§25): submit -> SACK is exactly how long
        # the payload stayed pinned by reference.
        us = int((time.perf_counter() - src.t_post) * 1e6)
        self.primary._hists.pin_us[swtrace.hist_bucket(us)] += 1
        src.settle(fires, None)
        self.primary.worker._on_stripe_sack(self.primary, fires)

    def has_unsacked(self, watermark: Optional[int] = None) -> bool:
        if watermark is None:
            return bool(self.by_id)
        return any(mid <= watermark for mid in self.by_id)

    # ----------------------------------------------------------- failure
    def rail_lost(self, conn, fires: list) -> None:
        """A secondary lane died: push its claimed-but-unacked chunks
        back to pending and let the survivors steal them.  The payload is
        pinned until SACK, so the resend is always legal; the receiver's
        offset dedup absorbs chunks that did land."""
        prim = self.primary
        self.lanes = [ln for ln in self.lanes if ln.conn is not conn]
        restolen = 0
        for src in self.by_id.values():
            infl = src.rail_offs.pop(conn.conn_id, None) or []
            done = src.done_offs.pop(conn.conn_id, None) or []
            if (not infl and not done) or src.failed or src.sacked:
                continue
            for off in infl:
                src.pending.append(off)  # never written: unwritten already
            for off in done:             # counts them
                src.pending.append(off)
                src.unwritten += 1       # written to the DEAD lane: back
            restolen += len(infl) + len(done)  # to unwritten for resend
            if src not in self.queue:
                self.queue.append(src)
        if restolen:
            prim._ctr.rail_resteals += restolen
            self.dispatch(fires)

    def expire(self, src: StripeSource, fires: list, reason: str) -> bool:
        """Deadline on a striped send: an unstarted source withdraws
        cleanly (returns False); a started one fails and the caller
        tears the group down (chunks already promised on the wire)."""
        if src.started():
            src.settle(fires, reason)
            return True
        self.by_id.pop(src.msg_id, None)
        try:
            self.queue.remove(src)
        except ValueError:
            pass
        src.settle(fires, reason)
        return False

    def redispatch_all(self, fires: list) -> None:
        """Session resume: re-dispatch every un-SACKed source from chunk
        zero across the (rebuilt) rail set.  The receiver's assemblies
        survived the outage keyed on the primary conn; its offset dedup
        and completed-id LRU make the wholesale resend exactly-once --
        the journal is per-message, never per-lane."""
        self.queue.clear()
        self.primary.retx_offs.clear()  # wholesale resend supersedes NACKs
        for msg_id in sorted(self.by_id):
            src = self.by_id[msg_id]
            if src.sacked or src.failed:
                continue
            src.pending = deque(range(0, src.total, src.chunk))
            src.rail_offs.clear()
            src.done_offs.clear()
            src.writers = 0  # the suspended incarnation's feeders are gone
            src.unwritten = len(src.pending)
            self.queue.append(src)
        if self.queue:
            self.dispatch(fires)

    def cancel_all(self, fires: list, reason: str) -> None:
        """Primary terminal teardown: settle every un-SACKed source.
        Entries stay in ``by_id`` (marked failed) so a flush barrier
        waiting on their SACKs observes the dead conn and fails instead
        of completing vacuously (engine.py stripe_waits)."""
        count = 0
        for src in self.by_id.values():
            if not src.sacked and not src.failed:
                src.settle(fires, reason, force=True)
                count += 1
        self.queue.clear()
        self.primary.retx_offs.clear()
        if count:
            self.primary._ctr.ops_cancelled += count
