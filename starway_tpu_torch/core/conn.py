"""Connection objects: the per-peer data plane of the host runtime.

The reference models a peer as a ``ucp_ep_h`` driven by a busy-poll progress
thread (reference: src/bindings/main.cpp:361-468, 1126-1268).  The TPU build
replaces that with two connection kinds, both driven by an event-driven
engine thread (see core/engine.py -- no busy-poll; the host CPU belongs to
XLA dispatch, not to spin loops):

* :class:`TcpConn` -- framed stream socket (core/frames.py).  This is the
  bootstrap / cross-process / DCN-adjacent path and carries the reference's
  flush-vs-close delivery semantics (tests/test_basic.py:190-415).  When
  both peers share a host and ``STARWAY_TLS`` allows ``sm``, the handshake
  upgrades the conn to shared-memory rings (core/shmring.py): the same
  framed byte stream flows through the rings, the socket stays open as the
  doorbell + liveness channel, and every semantic above is unchanged --
  the frame parser reads from ``_rx_read`` and cannot tell the transports
  apart.  This mirrors UCX negotiating posix shm over the same API when
  ``UCX_TLS`` includes ``sm`` (reference: benchmark.md:114-126).
* :class:`InprocConn` -- same-process fast path.  Delivery is a single copy
  into the matched receive buffer under the receiver's lock; device-buffer
  (jax.Array) payloads hand over array references and move HBM-to-HBM over
  ICI with no host serialization.

Send completion semantics (mirrors UCX eager/RNDV, SURVEY.md section 5
"Distributed communication backend"):

* eager (payload <= STARWAY_RNDV_THRESHOLD): the send future resolves once
  the payload is fully handed to the transport (written to the kernel socket
  / delivered in-process).  A graceful close afterwards still delivers.
* rendezvous (larger): the send future resolves when transmission has begun
  (header on the wire).  Delivery is only guaranteed after ``aflush`` /
  ``aflush_ep``; closing with the payload still in flight aborts the
  connection and the peer's receive never completes -- exactly the behaviour
  the reference pins with 8 GiB in-flight sends (tests/test_basic.py:190-339).
"""

from __future__ import annotations

import itertools
import logging
import socket
import time
from collections import deque
from typing import Optional

from .. import config, perf
from ..errors import REASON_CANCELLED, REASON_CORRUPT, REASON_NOT_CONNECTED
from . import frames, state, swtrace
from .lane import RailGroup, StripeFeeder, StripeRx
from .matching import InboundMsg
from .shmring import SmCorrupt

logger = logging.getLogger("starway_tpu_torch")

_conn_ids = itertools.count(1)

TX_CHUNK = 1 << 22  # 4 MiB socket write granularity
RX_CHUNK = 1 << 22
# Gathered-write bounds for the socket TX pump (kick_tx): views per sendmsg
# (well under IOV_MAX=1024) and bytes per pass.  Mirrors the native engine's
# tcp_tx_gather (native/sw_engine.cpp) -- one syscall covers a burst of
# queued small frames plus the front of a large payload.
GATHER_IOV = 64

# §19 integrity plane: frame types exempt from the negotiated per-frame
# checksum -- the handshake pair predates negotiation and the T_SEQ
# session prefix glues OUTSIDE the checksum envelope (wire order
# [SEQ][CSUM][frame]; a corrupted SEQ surfaces as a seq gap, which is
# already a recoverable fault).  Everything else on a csum conn must be
# announced by a T_CSUM or the stream is poisoned.  The sets live in
# frames.py (one decode contract: this parser, frames.decode_stream, and
# the native kCsumExempt[]/kCsumBody[] -- diffed by the wirefuzz pass).
_CSUM_EXEMPT = frames.CSUM_EXEMPT
# Frame types whose bytes continue past the header on the wire (given
# header ``b`` > 0): the full-frame CRC verifies at their last byte;
# every other type is header-only and verifies at dispatch.
_CSUM_BODY = frames.CSUM_BODY

# Doorbell byte values on an sm-upgraded conn's socket (the contract shared
# with the native engine -- native/sw_engine.cpp).  Any byte wakes the peer
# (drain socket, pump ring, retry tx); DB_STARVING additionally asks the
# peer to reply with a doorbell after it drains, which is the wakeup for a
# producer sleeping on a full ring.  Wakeups ride the socket exclusively:
# the send/recv syscall pair orders the cursor stores between processes, so
# the sleep needs no shared flag and no timed poll (see shmring.py).
DB_DATA = 1
DB_STARVING = 2

# swpulse (DESIGN.md §25): sink for items built without a worker-backed
# histogram set (tests constructing bare conns) -- the bump sites then
# never branch.  Mirrors the ``_ctr`` fallback in BaseConn.__init__.
_ORPHAN_HISTS = swtrace.Hists()


class TxData:
    """An outgoing tagged message (header + zero-copy payload view).

    ``payload`` is either a flat host ``memoryview`` or a *chunked* payload
    duck type (``nbytes`` + ``host_chunk(pos) -> (chunk_start, view)``, see
    device.py DevicePayload.chunked): the TX pump then materialises host
    bytes one chunk at a time, and the payload prefetches the next chunk's
    device-to-host copy before returning the current one -- staging overlaps
    transmission (DESIGN.md §12).  Either way the wire sees one ordinary
    DATA frame.
    """

    # __weakref__: deadline timers (core/engine.py) hold queued sends
    # weakly, so a completed send's payload is not pinned until its timer
    # would have fired.
    __slots__ = ("header", "payload", "nbytes", "tag", "off", "done", "fail",
                 "owner", "rndv", "local_done", "switch_after", "counted",
                 "sess_seq", "sess_nbytes", "e2e_ord", "t_post", "t_park",
                 "hists", "_chunk_start", "_chunk_view", "__weakref__")

    def __init__(self, tag: int, payload, done, fail, owner,
                 hists: Optional[swtrace.Hists] = None):
        if isinstance(payload, memoryview):
            self.nbytes = len(payload)
            self._chunk_start = 0
            self._chunk_view: Optional[memoryview] = payload
        else:  # chunked payload duck type
            self.nbytes = int(payload.nbytes)
            self._chunk_start = 0
            self._chunk_view = None
        self.header = frames.pack_data_header(tag, self.nbytes)
        self.payload = payload
        self.tag = tag
        self.off = 0
        self.done = done
        self.fail = fail
        self.owner = owner
        self.rndv = self.nbytes > config.rndv_threshold()
        self.local_done = False
        self.switch_after = False
        self.counted = False  # sends_completed recorded (replay must not re-count)
        self.sess_seq = 0     # session sequence number (0 = unframed)
        self.sess_nbytes = 0  # journal accounting (prefix + header + payload)
        self.e2e_ord = 0      # swscope wire ordinal (assigned at first full TX)
        # swpulse (DESIGN.md §25): creation stamp for the send_local_us
        # distribution, park stamp for park_us (0 = never parked).
        self.t_post = time.perf_counter()
        self.t_park = 0.0
        self.hists = hists if hists is not None else _ORPHAN_HISTS

    def _pulse_local(self) -> None:
        """One send_local_us bump at the local-completion transition
        (§25): a clock read + an array increment, nothing else."""
        us = int((time.perf_counter() - self.t_post) * 1e6)
        self.hists.send_local_us[swtrace.hist_bucket(us)] += 1

    def _pulse_unpark(self) -> None:
        """One park_us bump as a §18-parked send leaves the park queue."""
        if self.t_park:
            us = int((time.perf_counter() - self.t_park) * 1e6)
            self.hists.park_us[swtrace.hist_bucket(us)] += 1
            self.t_park = 0.0

    @property
    def total(self) -> int:
        return len(self.header) + self.nbytes

    @property
    def remaining(self) -> int:
        return self.total - self.off

    def payload_slice(self, pos: int, limit: int) -> memoryview:
        """Up to ``limit`` payload bytes starting at ``pos``, never crossing
        a staging-chunk boundary."""
        view, start = self._chunk_view, self._chunk_start
        if view is None or not (start <= pos < start + len(view)):
            start, view = self.payload.host_chunk(pos)
            self._chunk_start, self._chunk_view = start, view
        rel = pos - start
        return view[rel : rel + limit]

    def tx_views(self, max_bytes: int) -> list:
        """Unwritten views for the gathered socket pump (header remnant +
        the current payload chunk), bounded by ``max_bytes``."""
        views = []
        off, hlen, take = self.off, len(self.header), 0
        if off < hlen:
            h = memoryview(self.header)[off:]
            views.append(h)
            take = len(h)
            off = hlen
        if take < max_bytes and off < self.total:
            sl = self.payload_slice(off - hlen, min(TX_CHUNK, max_bytes - take))
            if len(sl):
                views.append(sl)
        return views

    def advance(self, n: int, fires: list) -> None:
        self.off += n
        self._maybe_local_complete(fires)
        if self.off >= self.total and not self.local_done:
            self.local_done = True
            self._pulse_local()
            if self.done is not None:
                fires.append(self.done)

    def write(self, conn: "TcpConn", fires: list) -> bool:
        """Write as much as possible (ring transport).  True when fully
        written.  (The socket transport uses the gathered pump in kick_tx.)"""
        hlen = len(self.header)
        while self.off < self.total:
            if self.off < hlen:
                # Header + first payload chunk in one gathered write: small
                # messages cost one syscall (and one TCP segment), not two.
                views = [memoryview(self.header)[self.off :]]
                if self.nbytes:
                    views.append(self.payload_slice(0, TX_CHUNK))
                try:
                    n = conn._tx_writev(views)
                except BlockingIOError:
                    self._maybe_local_complete(fires)
                    return False
            else:
                p = self.off - hlen
                try:
                    n = conn._tx_write(self.payload_slice(p, TX_CHUNK))
                except BlockingIOError:
                    self._maybe_local_complete(fires)
                    return False
            self.off += n
            self._maybe_local_complete(fires)
        if not self.local_done:
            self.local_done = True
            self._pulse_local()
            if self.done is not None:
                fires.append(self.done)
        return True

    def _maybe_local_complete(self, fires: list) -> None:
        # Rendezvous local completion: transmission begun (header written).
        if self.rndv and not self.local_done and self.off >= len(self.header):
            self.local_done = True
            self._pulse_local()
            if self.done is not None:
                fires.append(self.done)

    def cancel(self, fires: list, reason: str = REASON_CANCELLED) -> None:
        if not self.local_done:
            self.local_done = True
            if self.fail is not None:
                fires.append(lambda f=self.fail, r=reason: f(r))

    # ------------------------------------------------------------ session
    def sess_wrap(self, seq: int, prefix: bytes) -> None:
        """Frame for the session layer: embed the T_SEQ prefix and, for
        eager flat payloads, snapshot the bytes -- the user may legally
        reuse the buffer once ``done`` fires, and a later replay must
        resend what was originally promised.  Rendezvous payloads stay
        by-reference (delivery is only promised after a flush; the
        journal pins the payload object until the peer ACKs -- the §14
        stability contract).  Eager payloads are always flat host views
        here: device.py keeps the lazy-chunked pipeline off session
        conns, so the snapshot below covers every eager frame."""
        self.sess_seq = seq
        self.header = prefix + self.header
        if not self.rndv and isinstance(self.payload, memoryview):
            # swcheck: allow(hotpath-copy): journal must own eager payload bytes past local completion (session opt-in)
            snap = memoryview(bytes(self.payload))
            self.payload = snap
            self._chunk_view = snap
            self._chunk_start = 0
            self.owner = None
        self.sess_nbytes = self.total

    def reset_for_replay(self) -> None:
        self.off = 0
        self._chunk_start = 0
        self._chunk_view = self.payload if isinstance(self.payload, memoryview) else None


class TxDevpull:
    """A DEVPULL descriptor send: a tagged message whose payload stays on
    the sender's transfer server (device.py).  Local completion = the
    descriptor fully handed to the transport (eager semantics: the array
    itself is already registered for pull)."""

    __slots__ = ("data", "off", "done", "fail", "owner", "switch_after",
                 "counted", "sess_seq", "sess_nbytes", "e2e_ord")

    def __init__(self, data: bytes, done, fail, owner):
        self.data = data
        self.off = 0
        self.done = done
        self.fail = fail
        self.owner = owner
        self.switch_after = False
        self.counted = False
        self.sess_seq = 0
        self.sess_nbytes = 0
        self.e2e_ord = 0

    @property
    def remaining(self) -> int:
        return len(self.data) - self.off

    def tx_views(self, max_bytes: int) -> list:
        v = memoryview(self.data)[self.off : self.off + max_bytes]
        return [v] if len(v) else []

    def advance(self, n: int, fires: list) -> None:
        self.off += n
        if self.off >= len(self.data) and self.done is not None:
            done, self.done = self.done, None
            fires.append(done)

    def write(self, conn: "TcpConn", fires: list) -> bool:
        while self.off < len(self.data):
            try:
                n = conn._tx_write(memoryview(self.data)[self.off :])
            except BlockingIOError:
                return False
            self.off += n
        if self.done is not None:
            done, self.done = self.done, None
            fires.append(done)
        return True

    def cancel(self, fires: list, reason: str = REASON_CANCELLED) -> None:
        if self.done is not None and self.fail is not None:
            fail, self.fail = self.fail, None
            self.done = None
            fires.append(lambda r=reason: fail(r))

    def sess_wrap(self, seq: int, prefix: bytes) -> None:
        self.sess_seq = seq
        self.data = prefix + self.data
        self.sess_nbytes = len(self.data)

    def reset_for_replay(self) -> None:
        self.off = 0


class RtsHandle:
    """Receiver-side §18 rendezvous offer (the sender's T_RTS): the
    matcher treats it exactly like a devpull descriptor -- duck-typed
    ``started`` / ``start(msg)`` invoked via fire thunks outside locks,
    flush-barrier deferral and force-start included.  ``start`` hops to
    the engine thread, which picks the sink, pre-registers the assembly,
    and answers CTS."""

    __slots__ = ("conn", "msg_id", "total", "tag", "started", "msg")

    def __init__(self, conn, msg_id: int, total: int, tag: int):
        self.conn = conn
        self.msg_id = msg_id
        self.total = total
        self.tag = tag
        self.started = False
        self.msg = None

    def start(self, msg) -> None:
        worker = self.conn.worker
        with worker.lock:
            if self.started or worker.status != state.RUNNING:
                return
            self.started = True
            worker._busy += 1
            worker.ops.append(("fc_cts", self.conn, msg))
        worker._wake()


class TxCtl:
    """A small control frame (HELLO/HELLO_ACK/FLUSH/FLUSH_ACK).

    ``switch_after`` marks the sm transport switch point (the HELLO_ACK):
    once this item finishes writing to the socket, TX flips to the ring --
    items queued behind it ride the ring even while it is still draining,
    so stream bytes can never follow the ACK onto the socket.
    """

    __slots__ = ("data", "off", "switch_after", "sess_seq", "sess_nbytes")

    def __init__(self, data: bytes, switch_after: bool = False):
        self.data = data
        self.off = 0
        self.switch_after = switch_after
        self.sess_seq = 0     # nonzero on sequenced session ctl (FLUSH/FLUSH_ACK)
        self.sess_nbytes = 0

    @property
    def remaining(self) -> int:
        return len(self.data) - self.off

    def tx_views(self, max_bytes: int) -> list:
        v = memoryview(self.data)[self.off : self.off + max_bytes]
        return [v] if len(v) else []

    def advance(self, n: int, fires: list) -> None:
        self.off += n

    def write(self, conn: "TcpConn", fires: list) -> bool:
        while self.off < len(self.data):
            try:
                n = conn._tx_write(memoryview(self.data)[self.off :])
            except BlockingIOError:
                return False
            self.off += n
        return True

    def cancel(self, fires: list, reason: str = REASON_CANCELLED) -> None:
        pass

    def sess_wrap(self, seq: int, prefix: bytes) -> None:
        self.sess_seq = seq
        self.data = prefix + self.data
        self.sess_nbytes = len(self.data)

    def reset_for_replay(self) -> None:
        self.off = 0


class BaseConn:
    def __init__(self, worker, mode: str):
        self.conn_id = next(_conn_ids)
        self.worker = worker
        # swtrace counters + per-worker stage scope, cached so the data
        # path pays one attribute load per sample (DESIGN.md §13).
        self._ctr = getattr(worker, "counters", None) or swtrace.Counters()
        # swpulse distributions (DESIGN.md §25), cached like the counters.
        self._hists = getattr(worker, "hists", None) or _ORPHAN_HISTS
        self._scope = getattr(worker, "stage_scope", None)
        # swscope (DESIGN.md §15): the worker's trace ring (None = dark),
        # the negotiated trace-conn id ("tr" handshake key; "" until both
        # sides confirm), and the per-direction wire ordinals that pair
        # send-side and recv-side EV_E2E events across processes.
        self._ring = getattr(worker, "_trace", None)
        # swrefine protocol-event channel (DESIGN.md §22): the same ring,
        # armed only by STARWAY_PROTO_TRACE / STARWAY_MONITOR -- the seed
        # path (and plain STARWAY_TRACE runs) pay one `is None` check per
        # frame and emit nothing.
        self._proto = self._ring if swtrace.proto_active() else None
        self.tr_id = ""
        self.tx_e2e_ord = 0
        self.rx_e2e_ord = 0
        # Best clock-offset estimate for the peer (EV_CLOCK samples from
        # timestamped PING/PONG round trips): peer ~= local + offset.
        self.clock_off_us = 0
        self.clock_err_us = 0  # 0 = no sample yet
        self.mode = mode  # "socket" | "address"
        self.alive = True
        self.peer_name = ""
        self.local_addr = ""
        self.local_port = 0
        self.remote_addr = ""
        self.remote_port = 0
        self.flush_seq = 0
        self.flush_acked = 0
        # Delivery-barrier accounting: ``dirty`` = tagged data handed to this
        # conn that no completed flush has covered yet.  A dead+dirty conn
        # fails flush instead of passing it vacuously.
        self.dirty = False
        self._data_counter = 0
        self._flush_marks: dict[int, int] = {}

    def alloc_flush_seq(self) -> int:
        self.flush_seq += 1
        return self.flush_seq


class TcpConn(BaseConn):
    kind = "tcp"

    def __init__(self, worker, sock: socket.socket, mode: str, handshaken: bool):
        super().__init__(worker, mode)
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.sock = sock
        self.handshaken = handshaken  # False on server side until HELLO arrives
        # Peer-liveness keepalive (frames.py PING/PONG): negotiated via
        # "ka": "ok" in the handshake; last_rx is proof-of-life (any inbound
        # bytes -- stream, ring, or doorbell -- refresh it).
        self.ka_ok = False
        self.last_rx = time.monotonic()
        self.tx: deque = deque()
        self._registered = False
        self._want_write = False
        # rx parser state
        self._hdr = bytearray(frames.HEADER_SIZE)
        self._hdr_got = 0
        self._ctl: Optional[tuple] = None  # (ftype, body, got, header_a)
        self._rx_msg: Optional[InboundMsg] = None
        self._scratch: Optional[bytearray] = None
        # Shared-memory upgrade state (core/shmring.py).  ``sm_active`` =
        # negotiated; ``_tx_via_ring`` flips once everything queued before
        # the switch (the HELLO_ACK) has drained to the socket, so stream
        # bytes never interleave across transports.
        self._sm = None
        self.sm_tx = None
        self.sm_rx = None
        self.sm_active = False
        self.sm_negotiated = False  # sticky: survives teardown for introspection
        self._tx_via_ring = False
        # Doorbell bytes that hit a full socket buffer: flushed on EPOLLOUT.
        # A starving byte (DB_STARVING) is the only wakeup a ring-blocked
        # producer gets, so doorbells must never be silently dropped.
        self._db_out = bytearray()
        self._tx_want_sock = False
        # PJRT pull extension (frames.py T_DEVPULL): negotiated in the
        # handshake; descriptors received on this conn that have not yet
        # resolved (pull done/failed) hold back FLUSH_ACKs so the sender's
        # flush barrier covers pulled payloads too.
        self.devpull_ok = False
        # The peer's "cudaipc" value (device.py) when the port's own pull
        # was negotiated instead; None otherwise.
        self.cudaipc_peer = None
        self._remote_msgs: set = set()
        self._deferred_flush_acks: list = []
        # Resilient-session state (core/session.py; negotiated via the
        # "sess" handshake key).  None on seed-parity conns: every session
        # hook below is a single `is None` check.
        # Multi-rail striping (core/lane.py; DESIGN.md §17).  On a
        # PRIMARY conn: ``rails`` holds the attached secondary conns,
        # ``stripe``/``stripe_rx`` the lazily-created TX scheduler and RX
        # reassembly tables.  On a SECONDARY: ``rail_parent`` points at
        # the primary.  All None/empty on seed-parity conns.
        self.rails: list = []
        self.rail_parent: Optional["TcpConn"] = None
        self.rails_ok = False
        self.stripe: Optional[RailGroup] = None
        self.stripe_rx: Optional[StripeRx] = None
        # per-rail striped-chunk rx parser state
        self._sdata: Optional[tuple] = None   # (tag, subhdr buf, got, blen)
        self._rx_stripe: Optional[tuple] = None  # (asm, offset, chunk_len)
        self._rx_stripe_got = 0
        # Receiver-driven flow control (DESIGN.md §18; negotiated via the
        # "fc" handshake key).  Sender half: ``fc_window`` is the PEER's
        # advertised unexpected-queue budget, ``fc_credits`` the signed
        # remainder (negative only via the one-oversized-frame
        # admission), ``fc_waiting`` the unframed FIFO of parked sends,
        # ``fc_rts`` the announced-but-unSACKed rendezvous sends
        # (msg_id -> [TxData, state, tag]; payload pinned until SACK).
        # Receiver half: ``fc_unexp`` is this conn's outstanding
        # (un-granted) spill bytes, ``fc_rx_gen`` the incarnation
        # generation that orphans stale grants across a session resume,
        # ``fc_rx`` the un-completed inbound RTS records (dedup for
        # re-announcements).  All zero/empty on seed-parity conns.
        self.fc_ok = False
        self.fc_window = 0
        self.fc_credits = 0
        self.fc_waiting: deque = deque()
        self.fc_rts: dict = {}
        self._fc_next_msg = 1
        self.fc_unexp = 0
        self.fc_rx_gen = 0
        self.fc_rx: dict = {}
        self._unexp_cap = config.unexp_cap()
        # §19 integrity plane (negotiated via the "csum" handshake key).
        # ``csum_ok`` arms TX framing + RX verification; ``poison_reason``
        # overrides the cancel reason at teardown ("corrupt");
        # ``_csum_pend`` is the (crc_frame, crc_head) pair announced by
        # the last T_CSUM with ``_csum_accum`` the running CRC of the
        # protected frame; ``retx_offs`` tracks NACK-requeued striped
        # chunks until rewritten (the ``retx_pending`` gauge).
        self.csum_ok = False
        self.poison_reason = None
        self._csum_pend = None
        self._csum_accum = 0
        self.retx_offs: set = set()
        self.sess = None
        self._sess_pending = None   # seq announced by the last T_SEQ
        self._sess_drop = False     # next frame is a duplicate: drain + drop
        self._rx_skip = 0           # dup-frame payload bytes left to drain
        self._sess_ack_armed = False  # idle ACK timer outstanding
        self.sess_fail_reason = None  # flush-failure override at expiry
        if mode == "socket":
            try:
                self.local_addr, self.local_port = sock.getsockname()[:2]
                self.remote_addr, self.remote_port = sock.getpeername()[:2]
            except OSError:
                pass
        # In address mode the endpoint reports empty socket fields, mirroring
        # the reference (README.md:141-143).

    # ------------------------------------------------------------------ sm
    def adopt_sm(self, seg, creator: bool, defer_tx: bool = False) -> None:
        """Switch this conn's framed stream onto shared-memory rings.

        Called on the connector after HELLO_ACK confirms ``sm: ok`` and on
        the acceptor before queueing that ACK (``defer_tx=True``: the ACK
        itself must still go over the socket, so TX moves to the ring only
        once the tx queue drains -- see kick_tx).  RX moves immediately:
        the peer writes no stream bytes to the socket past its own switch
        point.
        """
        self._sm = seg
        self.sm_tx, self.sm_rx = seg.tx_rx(creator)
        self.sm_active = True
        self.sm_negotiated = True
        seg.unlink()
        if not defer_tx:
            if self.tx:
                # Anything already queued predates the switch: it drains to
                # the socket, then TX flips (kick_tx sees the marker).
                self.tx[-1].switch_after = True
            else:
                self._tx_via_ring = True

    def _doorbell(self, fires: list, val: int = DB_DATA) -> None:
        b = bytes([val])
        if self._db_out:
            if val not in self._db_out:
                self._db_out.extend(b)
            return
        self._ctr.io_syscalls += 1  # §23 runtime cost twin
        try:
            self.sock.send(b)
        except BlockingIOError:
            # Queue + EPOLLOUT: the peer will drain the socket eventually and
            # the byte goes out then (never lost, never polled for).
            self._db_out.extend(b)
            self._sync_write_interest()
        except OSError:
            self.worker._conn_broken(self, fires)

    def on_writable(self, fires: list) -> None:
        """EPOLLOUT: flush queued doorbell bytes first, then the tx queue."""
        while self._db_out:
            self._ctr.io_syscalls += 1  # §23 runtime cost twin
            try:
                n = self.sock.send(self._db_out)
            except BlockingIOError:
                return
            except OSError:
                self.worker._conn_broken(self, fires)
                return
            del self._db_out[:n]
        self.kick_tx(fires)

    def _close_sm(self) -> None:
        if self._sm is not None:
            seg, self._sm = self._sm, None
            self.sm_tx = self.sm_rx = None
            # sm_negotiated stays set: introspection on dead endpoints still
            # reports what the conn ran on (same as the native engine).
            self.sm_active = False
            self._tx_via_ring = False
            seg.unlink()
            seg.close()

    # ------------------------------------------------------------------ tx
    def _tx_write(self, chunk) -> int:
        """Write bytes to the active transport; raises BlockingIOError when
        it cannot take any (socket buffer / ring full)."""
        t0 = time.perf_counter()
        if not self._tx_via_ring:
            self._ctr.io_syscalls += 1  # §23 runtime cost twin
            n = self.sock.send(chunk)
            if n:
                self._ctr.bytes_tx += n
                perf.record_stage("tx", time.perf_counter() - t0, n,
                                  self._scope)
            return n
        n = self.sm_tx.write(chunk)
        if n == 0:
            # Ring full.  kick_tx signals the peer with a starving doorbell;
            # its reply (sent after it drains) re-enters kick_tx.  All wakeup
            # signaling rides the socket, so syscall ordering makes the sleep
            # race-free even though pure Python cannot fence (shmring.py).
            raise BlockingIOError
        self._ctr.bytes_tx += n
        self._ctr.hot_copies += 1  # §23 sm ring put (one slot copy)
        perf.record_stage("tx", time.perf_counter() - t0, n, self._scope)
        return n

    def _tx_writev(self, views: list) -> int:
        """Gathered write of several views via :meth:`_tx_write` (the
        socket transport instead gathers across whole queue items in
        kick_tx's sendmsg pump); raises BlockingIOError when the transport
        cannot take any bytes."""
        total = 0
        for v in views:
            try:
                n = self._tx_write(v)
            except BlockingIOError:
                if total == 0:
                    raise
                break
            total += n
            if n < len(v):
                break
        return total

    # ---------------------------------------------------------- integrity
    def _csum_arm(self, item) -> None:
        """Embed the T_CSUM prefix into one tx item's framed bytes
        (DESIGN.md §19).  Runs at dispatch, after the item's final wire
        header exists and BEFORE any session T_SEQ framing, so the wire
        order is [SEQ][CSUM][frame] and journal replays stay
        byte-identical.  Handshake frames are never wrapped."""
        if not self.csum_ok:
            return
        if isinstance(item, (TxCtl, TxDevpull)):
            if item.data[0] in _CSUM_EXEMPT:
                return
            item.data = frames.pack_csum_for(item.data) + item.data
            return
        # TxData: flat host payload (device.py stages integrity conns
        # flat, like session conns -- the CRC needs the whole payload).
        payload = item.payload if isinstance(item.payload, memoryview) \
            else None
        item.header = frames.pack_csum_for(item.header, payload) \
            + item.header

    def _corrupt(self, fires: list, what: str) -> None:
        """Unrepairable verification failure: poison the conn with the
        stable "corrupt" reason.  Without a session this takes the §10
        failure contract (queued sends fail "corrupt", posted recvs keep
        the peer-death pendings, flush fails); with a live session
        _conn_broken suspends instead and the journal replay re-delivers
        verified bytes exactly-once."""
        self._ctr.csum_fail += 1
        logger.warning("starway: integrity failure on conn %s: %s",
                       self.conn_id, what)
        self.poison_reason = REASON_CORRUPT
        sess = self.sess
        if sess is None or sess.expired:
            # Flush barriers against the poisoned conn report the true
            # cause (engine.py _try_complete_flush reads this override).
            self.sess_fail_reason = REASON_CORRUPT
        self.worker._conn_broken(self, fires)

    def _on_snack(self, msg_id: int, off: int, fires: list) -> None:
        """The receiver NACKed one striped chunk (payload checksum failed
        with an intact sub-header): re-queue JUST that chunk.  The payload
        is pinned until T_SACK, so the resend is always legal; the
        receiver's offset dedup never recorded the corrupt chunk, so the
        retransmit streams into the same sink region."""
        if self.fc_ok and msg_id in self.fc_rts:
            # §18 rendezvous delivery (one self-describing chunk): the
            # whole frame rides again, exactly like a CTS re-dispatch.
            ent = self.fc_rts[msg_id]
            if ent[1] != "tx":
                return  # not dispatched yet (stale/garbled NACK)
            item = ent[0]
            if item in self.tx:
                return  # still (re)transmitting
            item.reset_for_replay()
            self._ctr.chunk_retx += 1
            self.tx.append(item)
            self.kick_tx(fires)
            return
        root = self.stripe_root()
        grp = root.stripe
        if grp is None:
            return
        src = grp.by_id.get(msg_id)
        if (src is None or src.sacked or src.failed
                or off >= src.total or off % src.chunk):
            return  # settled or garbled: a late SACK/redispatch covers it
        if off in src.pending:
            return  # duplicate NACK: already queued for resend
        for offs in src.rail_offs.values():
            if off in offs:
                return  # already back in flight on some lane
        removed = False
        for offs in src.done_offs.values():
            if off in offs:
                offs.remove(off)
                removed = True
                break
        if not removed:
            return  # ledger cleared by a resume: redispatch_all covers it
        src.pending.append(off)
        src.unwritten += 1
        root._ctr.chunk_retx += 1
        root.retx_offs.add((msg_id, off))
        if src not in grp.queue:
            grp.queue.append(src)
        grp.dispatch(fires)

    # ------------------------------------------------------------- stripe
    def stripe_root(self) -> "TcpConn":
        return self.rail_parent if self.rail_parent is not None else self

    def stripe_group(self) -> RailGroup:
        if self.stripe is None:
            self.stripe = RailGroup(self)
        return self.stripe

    def _stripe_rx_tbl(self) -> StripeRx:
        root = self.stripe_root()
        if root.stripe_rx is None:
            root.stripe_rx = StripeRx(root)
        return root.stripe_rx

    def attach_rail(self, conn: "TcpConn", fires: list) -> None:
        """Adopt ``conn`` as a secondary lane of this (primary) conn."""
        conn.rail_parent = self
        self.rails = [r for r in self.rails if r.alive]
        self.rails.append(conn)
        grp = self.stripe_group()
        grp.lanes = [ln for ln in grp.lanes
                     if ln.conn is self or ln.alive]
        grp.add_rail(conn)
        if grp.queue:
            grp.dispatch(fires)  # mid-stripe join: start stealing now

    def send_data(self, tag: int, payload, done, fail, owner, fires: list,
                  kick: bool = True):
        """Queue a tagged message.  Returns the TxData handle so the worker
        can arm a deadline timer against it (core/engine.py), or None when
        the conn is already dead.

        ``kick=False`` defers the transport push: the engine's op drain
        queues a whole burst of sends first and kicks each conn once, so
        the gathered pump coalesces the burst into single sendmsg passes
        (Worker._drain_ops)."""
        if not self.alive:
            if fail is not None:
                fires.append(lambda: fail(REASON_NOT_CONNECTED + " (connection reset)"))
            return None
        if self.rails:
            grp = self.stripe_group()
            nbytes = (len(payload) if isinstance(payload, memoryview)
                      else int(payload.nbytes))
            if grp.stripe_ok(nbytes, payload):
                # Striped path (DESIGN.md §17): the source is NOT
                # seq-framed even on session conns -- chunks are
                # idempotent and the journal is per-message (the group
                # re-dispatches un-SACKed sources wholesale at resume).
                # Striped sends are exempt from the §18 credit window:
                # like the RTS path they are SACK-terminated large
                # transfers (stripe_threshold should sit at or above the
                # rndv threshold when combining the two planes).
                return grp.submit(tag, payload, done, fail, owner, fires)
        if self.fc_ok:
            return self._fc_send(tag, payload, done, fail, owner, fires, kick)
        self.dirty = True
        self._data_counter += 1
        item = TxData(tag, payload, done, fail, owner, self._hists)
        self._csum_arm(item)
        if self.sess is not None:
            self._sess_submit(item, fires, kick)
            return item
        self.tx.append(item)
        if kick:
            self.kick_tx(fires)
        return item

    def _proto_tx(self, ftype: int) -> None:
        """swrefine tx event at the ctl-plane handoff (DESIGN.md §22;
        data frames are covered by send_post/send_done and the peer's
        rx events)."""
        self._proto.rec(swtrace.EV_PROTO, 0, self.conn_id, 0,
                        "tx:" + frames.FRAME_NAMES.get(ftype, "OTHER"))

    def send_flush(self, seq: int, fires: list) -> None:
        self._flush_marks[seq] = self._data_counter
        if self._proto is not None:
            self._proto_tx(frames.T_FLUSH)
        item = TxCtl(frames.pack_flush(seq))
        self._csum_arm(item)
        if self.sess is not None:
            self._sess_submit(item, fires, True)
            return
        self.tx.append(item)
        self.kick_tx(fires)

    def send_flush_ack(self, seq: int, fires: list) -> None:
        """FLUSH_ACK is a *sequenced* session frame (a barrier ACK lost
        with a conn must replay, or the peer's flush hangs forever)."""
        if self._proto is not None:
            self._proto_tx(frames.T_FLUSH_ACK)
        item = TxCtl(frames.pack_flush_ack(seq))
        self._csum_arm(item)
        if self.sess is not None:
            self._sess_submit(item, fires, True)
            return
        self.tx.append(item)
        self.kick_tx(fires)

    def on_flush_acked(self, seq: int) -> None:
        mark = self._flush_marks.pop(seq, None)
        if mark is not None and mark == self._data_counter:
            self.dirty = False

    def send_ctl(self, data: bytes, fires: list, switch_after: bool = False) -> None:
        if self._proto is not None and data:
            self._proto_tx(data[0])  # the frame header leads with its type
        item = TxCtl(data, switch_after)
        self._csum_arm(item)
        self.tx.append(item)
        self.kick_tx(fires)

    def send_ping(self, fires: list) -> None:
        """Liveness probe (only sent on ka-negotiated conns).  Rides the
        active transport -- ring for sm conns (the doorbell accompanies it
        via kick_tx), socket otherwise.  Always timestamped: the PONG then
        doubles as a swscope clock sample (old peers echo zeros)."""
        if self.alive:
            self.send_ctl(frames.pack_ping(time.perf_counter_ns()), fires)

    # ------------------------------------------------------------ swscope
    def _tx_e2e(self, item) -> None:
        """One EV_E2E per data frame, at its FIRST full handoff to the
        transport -- completion order IS wire order, so the ordinal here
        equals the receiver's accept ordinal for the same message
        (DESIGN.md §15).  The ``counted`` guard on the call sites makes
        this once-only across session replays."""
        if self._ring is None or not self.tr_id:
            return
        self.tx_e2e_ord += 1
        item.e2e_ord = self.tx_e2e_ord
        nbytes = getattr(item, "nbytes", None)
        if nbytes is None:
            nbytes = len(item.data)
        self._ring.rec(swtrace.EV_E2E, self.tx_e2e_ord, self.conn_id,
                       nbytes, self.tr_id + ":tx")

    def _rx_e2e(self, nbytes: int) -> None:
        """Receiver half of the pair: one EV_E2E per accepted (non-dup)
        data frame, in stream order.  Dup session frames drain via
        ``_sess_drop``/``_rx_skip`` and never reach this counter."""
        if self._ring is None or not self.tr_id:
            return
        self.rx_e2e_ord += 1
        self._ring.rec(swtrace.EV_E2E, self.rx_e2e_ord, self.conn_id,
                       nbytes, self.tr_id + ":rx")

    def _on_pong(self, echo_ns: int, peer_ns: int) -> None:
        """A timestamped PONG closed the loop: one NTP-style clock sample
        for this peer -- ``offset = t_peer - (t_tx + rtt/2)``, error
        ``rtt/2``.  Zero fields mean an old peer's plain probe answer."""
        if not echo_ns or not peer_ns:
            return
        now = time.perf_counter_ns()
        rtt = now - echo_ns
        if rtt < 0:
            return  # a replayed/garbled echo cannot yield a sane sample
        err_us = max(1, rtt // 2000)
        off_us = (peer_ns - (echo_ns + rtt // 2)) // 1000
        if self.clock_err_us == 0 or err_us < self.clock_err_us:
            self.clock_off_us = off_us
            self.clock_err_us = err_us
        if self._ring is not None and self.tr_id:
            self._ring.rec(swtrace.EV_CLOCK, 0, self.conn_id, 0,
                           f"{self.tr_id}:{off_us}:{err_us}")

    def send_devpull(self, data: bytes, done, fail, owner, fires: list,
                     kick: bool = True) -> None:
        """Queue a DEVPULL descriptor (counts as data for flush/dirty
        accounting: the flush barrier must cover the pulled payload)."""
        if not self.alive:
            if fail is not None:
                fires.append(lambda: fail(REASON_NOT_CONNECTED + " (connection reset)"))
            return
        self.dirty = True
        self._data_counter += 1
        if self._proto is not None:
            self._proto_tx(frames.T_DEVPULL)
        item = TxDevpull(data, done, fail, owner)
        self._csum_arm(item)
        if self.sess is not None:
            self._sess_submit(item, fires, kick)
            return
        self.tx.append(item)
        if kick:
            self.kick_tx(fires)

    # ------------------------------------------------------------- session
    @staticmethod
    def _sess_wire_bytes(item) -> int:
        """Wire footprint of an unframed item (payload + frame header +
        the T_SEQ prefix it will gain)."""
        base = item.total if isinstance(item, TxData) else len(item.data)
        return base + frames.HEADER_SIZE

    def _sess_frame(self, item) -> None:
        seq = self.sess.next_seq()
        item.sess_wrap(seq, frames.pack_seq(seq))
        self.sess.journal_add(item, item.sess_nbytes)

    def _sess_submit(self, item, fires: list, kick: bool) -> None:
        """Frame + journal + queue a session frame, or park it when the
        journal is at its byte cap (backpressure: the send completes late
        instead of the journal OOMing).  Parked items keep FIFO order."""
        sess = self.sess
        if not sess.has_room(self._sess_wire_bytes(item)):
            sess.waiting.append(item)
            return
        self._sess_frame(item)
        self.tx.append(item)
        if kick:
            self.kick_tx(fires)

    def _sess_drain_waiting(self) -> bool:
        """Move parked items into the journal/tx as ACKs free room.
        Returns True when anything moved (caller kicks)."""
        sess = self.sess
        moved = False
        while sess.waiting:
            item = sess.waiting[0]
            nb = self._sess_wire_bytes(item)
            if sess.journal and sess.journal_bytes + nb > sess.journal_cap:
                break
            sess.waiting.popleft()
            self._sess_frame(item)
            self.tx.append(item)
            moved = True
        return moved

    def _on_ack(self, cum_seq: int, fires: list) -> None:
        """Peer's cumulative ACK: trim the journal, unblock parked sends."""
        self._ctr.acks_rx += 1
        self.sess.journal_trim(cum_seq)
        if self._sess_drain_waiting():
            self.kick_tx(fires)

    def _on_seq(self, seq: int, fires: list) -> bool:
        """T_SEQ announcing the next frame's sequence number.  Returns
        False when the conn was torn down (seq gap)."""
        sess = self.sess
        if sess is None:
            # Peer speaks the session protocol on a conn that never
            # negotiated it: protocol violation.
            self.worker._conn_broken(self, fires)
            return False
        if seq <= sess.rx_cum:
            # Already processed (a replay overlap): drain + drop the frame.
            self._ctr.dup_frames_dropped += 1
            self._sess_drop = True
        elif seq == sess.rx_cum + 1:
            self._sess_pending = seq
        else:
            # Gap inside one incarnation (reordered/corrupted relay): the
            # framed stream cannot be repaired in place -- reset and let
            # the resume handshake replay from the cumulative ACK.
            self.worker._conn_broken(self, fires)
            return False
        return True

    def _sess_commit(self) -> None:
        """The sequenced frame announced by the last T_SEQ was fully
        processed: advance the cumulative counter and make sure an ACK
        eventually goes out even if no further reads piggyback one."""
        if self._sess_pending is None:
            return
        self.sess.rx_cum = self._sess_pending
        self._sess_pending = None
        if not self._sess_ack_armed:
            self._sess_ack_armed = True
            self.worker._add_timer(0.2, self._sess_ack_tick)

    def _sess_ack_tick(self, fires: list) -> None:
        self._sess_ack_armed = False
        self._sess_maybe_ack(fires)

    def _sess_maybe_ack(self, fires: list) -> None:
        """Piggybacked cumulative ACK: sent at the end of a read pass (and
        from the idle timer) whenever rx progress is unacknowledged."""
        sess = self.sess
        if sess is None or not self.alive or sess.suspended:
            return
        if sess.rx_cum > sess.acked_sent:
            sess.acked_sent = sess.rx_cum
            self._ctr.acks_tx += 1
            self.send_ctl(frames.pack_ack(sess.acked_sent), fires)

    def suspend(self, fires: list) -> None:
        """The transport died but the session is resumable: drop the
        socket and all per-incarnation parser state, keep every queue,
        journal, and flush bookkeeping.  The conn stays ``alive`` so
        flush barriers keep waiting and new sends keep queueing -- they
        complete after resume instead of failing."""
        if self._proto is not None:
            # swrefine: (estab, lost) -> suspended (DESIGN.md §22).
            self._proto.rec(swtrace.EV_PROTO, 0, self.conn_id, 0, "lost")
        sess = self.sess
        sess.suspend()
        self.worker._unregister_conn_io(self)
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
        # rx parser reset: the replayed stream restarts at a frame boundary.
        self._hdr_got = 0
        self._ctl = None
        self._rx_skip = 0
        self._sess_drop = False
        self._sess_pending = None
        self._csum_pend = None  # per-incarnation: replay re-announces
        self._csum_accum = 0
        # Striped rx parser state is per-incarnation; the ASSEMBLIES
        # (stripe_rx) survive -- the resumed sender re-dispatches
        # un-SACKed sources and offset dedup keeps bytes exactly-once.
        self._sdata = None
        self._rx_stripe = None
        self._rx_stripe_got = 0
        msg, self._rx_msg = self._rx_msg, None
        if msg is not None:
            with self.worker.lock:
                pr = msg.posted
                if pr is not None and not msg.complete:
                    # Re-arm the stranded receive at the FRONT of the
                    # queue: the replayed frame must claim the same
                    # receive (its buffer was partially written; the
                    # replay rewrites it from the start).
                    msg.posted = None
                    pr.claimed = False
                    self.worker.matcher.purge_inflight(msg)
                    self.worker.matcher.posted.appendleft(pr)
                else:
                    self.worker.matcher.purge_inflight(msg)
        # Journaled frames replay from the journal; bare per-incarnation
        # ctl (PING/PONG/ACK) queued on the old transport dies with it.
        self.tx.clear()
        self._db_out = bytearray()
        self._want_write = False
        self._tx_want_sock = False

    def resume(self, sock: socket.socket, peer_ack: int, fires: list,
               ack_ctl: Optional[bytes] = None) -> None:
        """A reconnect re-handshake matched this session: adopt the new
        socket, trim the journal by the peer's cumulative ACK (carried in
        the handshake), and replay everything past it.  ``ack_ctl`` is the
        acceptor's HELLO_ACK -- it must precede replayed frames on the
        wire."""
        if self._proto is not None:
            # swrefine: (suspended, resume) -> estab; the resume dial's
            # HELLO/HELLO_ACK exchange is folded into this one event
            # (the conn never leaves the session machine, DESIGN.md §22).
            self._proto.rec(swtrace.EV_PROTO, 0, self.conn_id, 0, "resume")
        sess = self.sess
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.sock = sock
        self.last_rx = time.monotonic()
        sess.resume()
        sess.journal_trim(peer_ack)
        # The handshake carried our rx_cum as sess_ack: the peer starts
        # from it, so there is nothing older to re-ACK.
        sess.acked_sent = sess.rx_cum
        # Frames queued while suspended are all journaled (submit framing
        # happens at queue time): rebuild tx purely from the journal, or
        # those items would ride the wire twice.
        self.tx.clear()
        self._ctr.sessions_resumed += 1
        if ack_ctl is not None:
            self.tx.append(TxCtl(ack_ctl))
        replayed = 0
        for item in sess.journal:
            item.reset_for_replay()
            self.tx.append(item)
            replayed += 1
            if not isinstance(item, TxCtl) and item.counted \
                    and item.e2e_ord and self._ring is not None \
                    and self.tr_id:
                # swscope: this frame's ordinal was already recorded at
                # its first full transmission; the replay rewrites the
                # bytes (the receiver's seq dedup drops them if they
                # landed) -- mark it superseded, never recount it.
                self._ring.rec(swtrace.EV_E2E, item.e2e_ord, self.conn_id,
                               0, self.tr_id + ":sup")
        self._ctr.frames_replayed += replayed
        self._sess_drain_waiting()  # trim may have freed journal room
        if self.fc_ok:
            # Fresh credit window per incarnation; unSACKed rendezvous
            # sends re-announce; parked sends re-enter dispatch
            # (DESIGN.md §18 -- the journal already owns their bytes).
            self._fc_reset_resume()
            self._fc_drain_waiting(fires)
        if self.stripe is not None:
            # Un-SACKed striped sources re-dispatch wholesale (chunk 0
            # onward) across whatever lanes are live -- the per-message
            # journal contract; rails re-attach as the client re-dials.
            self.stripe.lanes = [ln for ln in self.stripe.lanes
                                 if ln.conn is self or ln.alive]
            self.rails = [r for r in self.rails if r.alive]
            self.stripe.redispatch_all(fires)
        tr = getattr(self.worker, "_trace", None)
        if tr is not None:
            tr.rec(swtrace.EV_SESS_RESUME, 0, self.conn_id, replayed)
        swtrace.flight_dump("session-resume", self.worker)
        self.worker._register_conn_io(self)
        self.kick_tx(fires)

    # -------------------------------------------------------- flow control
    #
    # Receiver-driven credit flow control + the RTS/CTS rendezvous path
    # (DESIGN.md §18; negotiated via the "fc" handshake key).  Sender
    # half below runs on the engine thread (send_data routes through it);
    # the receiver half hangs off _pump_frames and the matcher's
    # fc_release hook.

    def _fc_send(self, tag: int, payload, done, fail, owner, fires: list,
                 kick: bool):
        """send_data on an fc conn: gate eager sends on the peer's
        window, announce rendezvous sends via RTS.  Once anything is
        parked, EVERYTHING parks behind it -- FIFO arrival order at the
        receiver's matcher is part of the matching contract."""
        item = TxData(tag, payload, done, fail, owner, self._hists)
        if self.fc_waiting:
            item.t_park = time.perf_counter()
            self.fc_waiting.append(item)
            self._ctr.sends_parked += 1
            return item
        if item.rndv:
            self._fc_rts_announce(item, fires, kick)
            return item
        if not self._fc_admit(item.nbytes):
            item.t_park = time.perf_counter()
            self.fc_waiting.append(item)
            self._ctr.sends_parked += 1
            return item
        self._fc_dispatch_eager(item, fires, kick)
        return item

    def _fc_admit(self, nbytes: int) -> bool:
        """Debit the window, or refuse.  A fully-replenished (idle)
        window always admits one frame even when the payload exceeds it
        -- the §14 journal-backpressure rule: a single oversized payload
        must block later sends, never deadlock itself."""
        if self.fc_credits >= nbytes or self.fc_credits >= self.fc_window:
            self.fc_credits -= nbytes
            return True
        return False

    def _fc_dispatch_eager(self, item, fires: list, kick: bool) -> None:
        self.dirty = True
        self._data_counter += 1
        self._csum_arm(item)
        if self.sess is not None:
            self._sess_submit(item, fires, kick)
            return
        self.tx.append(item)
        if kick:
            self.kick_tx(fires)

    def _fc_rts_announce(self, item, fires: list, kick: bool) -> None:
        """Announce a rendezvous send: the payload stays pinned here and
        travels as ONE self-describing T_SDATA frame only after the
        receiver's CTS -- large transfers never consume window and never
        spill at the receiver.  The RTS ctl is per-incarnation (never
        seq-framed): a session resume re-announces every unSACKed entry
        instead of replaying it."""
        self.dirty = True
        self._data_counter += 1
        msg_id = frames.FC_MSG_BIT | self._fc_next_msg
        self._fc_next_msg += 1
        item.header = frames.pack_sdata_header(item.tag, msg_id, 0,
                                               item.nbytes, item.nbytes)
        self._csum_arm(item)  # covers header+sub-header+payload (§19)
        self.fc_rts[msg_id] = [item, "rts", item.tag]
        rts = TxCtl(frames.pack_rts(item.tag, msg_id, item.nbytes))
        self._csum_arm(rts)
        self.tx.append(rts)
        if kick:
            self.kick_tx(fires)

    def _on_credit(self, nbytes: int, fires: list) -> None:
        """Peer returned window (T_CREDIT): replenish and drain parked
        sends.  Clamped at the advertised window -- a wire-duplicated
        grant must never mint credit."""
        if not self.fc_ok:
            return  # stray grant on a non-fc conn: old peers cannot send it
        self.fc_credits = min(self.fc_window, self.fc_credits + nbytes)
        self._fc_drain_waiting(fires)

    def _fc_drain_waiting(self, fires: list) -> None:
        """Move parked sends into dispatch as grants restore the window
        (FIFO; rendezvous entries pass straight through to RTS)."""
        moved = False
        while self.fc_waiting:
            item = self.fc_waiting[0]
            if item.local_done:  # shed by a deadline while parked
                self.fc_waiting.popleft()
                item._pulse_unpark()
                continue
            if item.rndv:
                self.fc_waiting.popleft()
                item._pulse_unpark()
                self._fc_rts_announce(item, fires, kick=False)
                moved = True
                continue
            if not self._fc_admit(item.nbytes):
                break
            self.fc_waiting.popleft()
            item._pulse_unpark()
            self._fc_dispatch_eager(item, fires, kick=False)
            moved = True
        if moved:
            self.kick_tx(fires)

    def _on_cts(self, msg_id: int, fires: list) -> None:
        """Receiver granted the rendezvous: dispatch the pinned payload
        as its pre-built T_SDATA frame.  A duplicate CTS (resume races)
        is ignored -- only the "rts" state dispatches."""
        ent = self.fc_rts.get(msg_id)
        if ent is None or ent[1] != "rts":
            return
        ent[1] = "tx"
        item = ent[0]
        item.reset_for_replay()
        self.tx.append(item)
        self.kick_tx(fires)

    def _fc_on_sack(self, msg_id: int, fires: list) -> bool:
        """True when this SACK settled a §18 rendezvous send (the entry
        -- and with it the payload pin -- is dropped; the op completed
        locally at first byte, rndv semantics)."""
        return self.fc_rts.pop(msg_id, None) is not None

    def fc_rts_state(self, item):
        """The fc_rts state ("rts"/"tx") owning ``item``, or None --
        the deadline path's promised-send probe (core/engine.py)."""
        for ent in self.fc_rts.values():
            if ent[0] is item:
                return ent[1]
        return None

    def _fc_reset_resume(self) -> None:
        """Fresh window per incarnation (DESIGN.md §18): stale debits and
        grant obligations die with the old transport.  Journal-replayed
        DATA frames re-debit the fresh window (their replay WILL arrive,
        and the receiver grants duplicates too -- conservation), parked
        sends re-enter dispatch, and unSACKed rendezvous sends
        re-announce (the receiver's assembly/done-LRU dedups)."""
        self.fc_rx_gen += 1
        self.fc_unexp = 0
        self.fc_credits = self.fc_window
        if self.sess is not None:
            # Journal-replayed frames AND journal-backpressure-parked
            # frames (sess.waiting) both ship in this incarnation and
            # were admitted pre-suspend: re-debit both, or their wire
            # bytes would oversubscribe the fresh window.
            for it in list(self.sess.journal) + list(self.sess.waiting):
                if isinstance(it, TxData):
                    self.fc_credits -= it.nbytes
        for msg_id, ent in self.fc_rts.items():
            ent[1] = "rts"
            ent[0].reset_for_replay()
            rts = TxCtl(frames.pack_rts(ent[2], msg_id, ent[0].nbytes))
            self._csum_arm(rts)
            self.tx.append(rts)

    # --------------------------------------------------- flow control (rx)
    def fc_on_rts(self, tag: int, msg_id: int, total: int, fires: list) -> None:
        """An RTS descriptor arrived: register the rendezvous offer with
        the matcher through the devpull machinery (flush deferral,
        truncation drain, and force-start come with it); CTS goes out
        when a receive claims the record."""
        rx = self._stripe_rx_tbl()
        if msg_id in rx.done_ids:
            # Late re-announcement of a completed message: re-SACK so the
            # sender releases its pin.
            StripeRx.sack(self, msg_id, total, fires)
            return
        msg = self.fc_rx.get(msg_id)
        if msg is not None:
            if msg_id in rx.asms:
                # The CTS (or the delivery) died with an incarnation; the
                # assembly survived -- just re-CTS.
                self.send_ctl(frames.pack_cts(msg_id), fires)
            elif (msg.remote is not None
                  and (msg.posted is not None or msg.discard
                       or msg.remote.started)):
                # The CTS hop was consumed by a dead incarnation AFTER a
                # claim (or drain) consumed the record: no future
                # post_recv can re-fire it -- restart on the live conn
                # (fc_start_rx dedups against a stale queued hop via the
                # assembly table).
                msg.remote.started = True
                self.fc_start_rx(msg, fires)
            return
        handle = RtsHandle(self, msg_id, total, tag)
        with self.worker.lock:
            msg, f = self.worker.matcher.on_remote_message(tag, total, handle)
        fires.extend(f)
        handle.msg = msg
        self.fc_rx[msg_id] = msg
        self.remote_received(msg)
        if msg.discard:
            # Matched a too-small receive at announce time: the receive
            # already failed "truncated", but the sender still pins the
            # payload -- drain-CTS it so the pin (and any flush barrier)
            # releases, exactly like a truncated devpull descriptor.
            fires.append(lambda m=msg: m.remote.start(m))

    def fc_start_rx(self, msg, fires: list) -> None:
        """Engine-thread half of the CTS (RtsHandle.start hops here):
        choose the sink, pre-register the assembly under the sender's
        msg id, answer CTS.  The T_SDATA delivery then streams through
        the ordinary stripe RX path."""
        handle = msg.remote
        if handle is None or msg.complete:
            return
        rx = self._stripe_rx_tbl()
        if handle.msg_id in rx.asms:
            return  # already registered (a duplicate/stale hop)
        if not self.alive or self.sock is None:
            # Dead/suspended: this hop is consumed, so re-arm the handle
            # -- the resume re-announcement restarts it (fc_on_rts).
            handle.started = False
            return
        handle.started = True
        if not msg.discard and msg.posted is None and msg.spill is None:
            # Force-started by a flush barrier before any receive
            # matched: spill, like a drained devpull (exempt from the
            # window -- the sender's flush asked for residency here).
            msg.spill = bytearray(msg.length)
            msg.sink = memoryview(msg.spill)
        elif msg.posted is not None and msg.sink is None:
            pr = msg.posted
            if isinstance(pr.buf, memoryview):
                msg.sink = pr.buf
            else:
                msg.sink = pr.buf.host_staging()
        from .lane import StripeAsm

        rx.asms[handle.msg_id] = StripeAsm(handle.msg_id, handle.tag,
                                           msg.length, msg)
        self.send_ctl(frames.pack_cts(handle.msg_id), fires)

    # ------------------------------------------------- devpull rx tracking
    def remote_received(self, msg) -> None:
        self._remote_msgs.add(msg)

    def defer_flush_ack(self, seq: int) -> None:
        """Hold this barrier's ACK until the descriptors that PRECEDED it in
        the stream resolve.  Snapshot, not the live set: a descriptor
        arriving after the barrier must not extend the wait."""
        self._deferred_flush_acks.append((seq, set(self._remote_msgs)))

    def remote_resolved(self, msg, fires: list) -> None:
        """A descriptor's pull completed/failed/was discarded: release any
        FLUSH_ACKs whose snapshot it was the last unresolved member of."""
        self._remote_msgs.discard(msg)
        if not self._deferred_flush_acks:
            return
        ready = []
        remaining = []
        for seq, waiting in self._deferred_flush_acks:
            waiting.discard(msg)
            (remaining if waiting else ready).append((seq, waiting))
        self._deferred_flush_acks = remaining
        if self.alive:
            for seq, _ in ready:
                self.send_flush_ack(seq, fires)

    def _gather_tx(self) -> tuple[list, list]:
        """Collect unwritten views across queued items for one sendmsg pass
        (the multi-item extension of the header+payload ``_tx_writev``;
        mirrors the native engine's tcp_tx_gather).  Returns (views,
        [(item, offered_bytes)]); never batches past the sm switch point."""
        views: list = []
        spans: list = []
        take = 0
        for item in self.tx:
            if len(views) >= GATHER_IOV or take >= TX_CHUNK:
                break
            offered = 0
            for v in item.tx_views(TX_CHUNK - take):
                views.append(v)
                offered += len(v)
            take += offered
            if offered:
                spans.append((item, offered))
            if isinstance(item, StripeFeeder):
                # A feeder refills in place after its chunk completes, so
                # the byte budget must never span past it (the native
                # pump's front-pop accounting has the same rule -- keep
                # the two in lockstep).
                break
            if item.switch_after:
                break
            if offered < item.remaining:
                # Item not fully offered (byte budget, or a chunked payload
                # whose later chunks are not staged yet): nothing behind it
                # may ride this pass, or the later frame's bytes would land
                # inside this item's in-flight DATA payload.
                break
        return views, spans

    def kick_tx(self, fires: list) -> None:
        if not self.alive or self.sock is None:
            return  # dead, or session-suspended (resume re-kicks)
        t0 = self.sm_tx.tail if self.sm_active else 0
        blocked = False
        try:
            while self.tx:
                if isinstance(self.tx[0], StripeFeeder) \
                        and self.tx[0].remaining == 0:
                    # A feeder that ran the group dry (remaining re-checks
                    # the claim) must leave the queue, or the gather pump
                    # -- which never batches past a feeder -- would stall
                    # every frame queued behind it.
                    self.tx.popleft()
                    continue
                if self._tx_via_ring:
                    item = self.tx[0]
                    if not item.write(self, fires):
                        blocked = True
                        break
                    self.tx.popleft()
                    if not isinstance(item, TxCtl) and not item.counted:
                        item.counted = True
                        self._ctr.sends_completed += 1
                        self._tx_e2e(item)
                    continue
                # Socket: one gathered sendmsg per pass across queued items
                # -- a burst of small frames costs one syscall, and a large
                # payload's next chunk rides along with whatever control
                # frames queued behind it.
                views, spans = self._gather_tx()
                if not views:
                    break
                tw0 = time.perf_counter()
                self._ctr.io_syscalls += 1  # §23 runtime cost twin
                try:
                    n = self.sock.sendmsg(views)
                except BlockingIOError:
                    first = self.tx[0]
                    if isinstance(first, TxData):
                        first._maybe_local_complete(fires)
                    blocked = True
                    break
                ctr = self._ctr
                ctr.bytes_tx += n
                ctr.gather_passes += 1
                ctr.gather_items += len(views)
                perf.record_stage("tx", time.perf_counter() - tw0, n,
                                  self._scope)
                for item, offered in spans:
                    adv = min(n, offered)
                    if adv == 0:
                        break
                    item.advance(adv, fires)
                    n -= adv
                    if item.remaining == 0 and self.tx and self.tx[0] is item:
                        self.tx.popleft()
                        if not isinstance(item, TxCtl) and not item.counted:
                            item.counted = True
                            ctr.sends_completed += 1
                            self._tx_e2e(item)
                        if getattr(item, "switch_after", False):
                            # The sm switch point (HELLO_ACK) left the
                            # socket: every later item rides the ring, even
                            # those already queued.  _gather_tx stopped at
                            # this item, so no later bytes were sent.
                            self._tx_via_ring = True
        except (BrokenPipeError, ConnectionResetError, OSError):
            self.worker._conn_broken(self, fires)
            return
        except Exception:
            # Chunked D2H staging failed mid-message (host_chunk raised:
            # the array was deleted/donated after asend, or a device
            # runtime error).  The frame header already promised nbytes the
            # stream can no longer produce, so reset the connection (the
            # same discipline as a deadline on a started send) -- queued
            # ops fail with the stable "cancel" reason instead of the
            # whole engine emergency-closing.
            logger.exception("starway: TX staging failed; resetting connection")
            self.worker._conn_broken(self, fires)
            return
        if blocked:
            self._set_want_write(True)
            if self._tx_via_ring:
                # Blocked on the ring, not the socket (EPOLLOUT would spin).
                # Ask the peer to reply once it drains; the starving byte
                # doubles as the data doorbell for anything published above.
                self._doorbell(fires, DB_STARVING)
                return
        else:
            self._set_want_write(False)
            if self.sm_active and not self._tx_via_ring:
                # Pre-switch TCP bytes (the HELLO_ACK) fully drained: all
                # stream traffic from here on rides the ring.
                self._tx_via_ring = True
        if self.sm_active and self.sm_tx.tail != t0:
            self._doorbell(fires)

    def _set_want_write(self, want: bool) -> None:
        # ``want`` tracks the tx queue's need for the socket.  A ring block
        # never wants EPOLLOUT (the socket stays writable; the wakeup is the
        # peer's doorbell reply); queued doorbell bytes always do.
        self._tx_want_sock = want and not self._tx_via_ring
        self._sync_write_interest()

    def _sync_write_interest(self) -> None:
        want = self._tx_want_sock or bool(self._db_out)
        if want != self._want_write:
            self._want_write = want
            self.worker._update_conn_interest(self)

    def has_unfinished_data_tx(self) -> bool:
        for it in self.tx:
            if isinstance(it, TxData) and it.off < it.total:
                return True
            if isinstance(it, StripeFeeder) \
                    and getattr(it, "src", None) is not None:
                return True
        return False

    # ------------------------------------------------------------------ rx
    def _rx_read(self, target) -> int:
        """Read stream bytes from the active transport into ``target``.

        Raises BlockingIOError when nothing is available; returns 0 only on
        TCP EOF (the ring has no EOF -- peer death surfaces on the socket).
        """
        t0 = time.perf_counter()
        if self.sm_active:
            try:
                n = self.sm_rx.read_into(target)
            except SmCorrupt as e:
                # §19: a torn/corrupt ring slot, caught at dequeue before
                # its bytes could be parsed.  Mark the poison here (this
                # helper has no fires list) and let the caller's OSError
                # handler run _conn_broken -- mark_dead then reports the
                # stable "corrupt" reason.
                self._ctr.csum_fail += 1
                logger.warning("starway: integrity failure on conn %s: %s",
                               self.conn_id, e)
                self.poison_reason = REASON_CORRUPT
                if self.sess is None or self.sess.expired:
                    self.sess_fail_reason = REASON_CORRUPT
                raise
            if n == 0:
                raise BlockingIOError
            self.last_rx = time.monotonic()
            self._ctr.bytes_rx += n
            self._ctr.hot_copies += 1  # §23 sm ring take (one slot copy)
            perf.record_stage("rx", time.perf_counter() - t0, n, self._scope)
            return n
        self._ctr.io_syscalls += 1  # §23 runtime cost twin
        n = self.sock.recv_into(target)
        if n:
            self.last_rx = time.monotonic()
            self._ctr.bytes_rx += n
            perf.record_stage("rx", time.perf_counter() - t0, n, self._scope)
        return n

    def on_readable(self, fires: list) -> None:
        if not self.sm_active:
            self._pump_frames(fires)
            self._sess_maybe_ack(fires)  # piggybacked cumulative ACK
            return
        # sm mode: the socket carries only doorbells (and EOF/RST).  Drain
        # it, then pump the ring.  On EOF the peer is gone, but bytes it
        # published before dying are still in the ring: pump first, then
        # declare the conn broken (graceful close must deliver).
        eof = False
        starving = False
        while True:
            self._ctr.io_syscalls += 1  # §23 runtime cost twin
            try:
                b = self.sock.recv(4096)
            except BlockingIOError:
                break
            except (ConnectionResetError, OSError):
                eof = True
                break
            if not b:
                eof = True
                break
            self.last_rx = time.monotonic()  # doorbell bytes are proof of life
            if DB_STARVING in b:
                starving = True
        self._pump_frames(fires)
        if not self.alive:
            return
        if starving:
            # The peer's producer is asleep on a full ring.  The pump above
            # freed space (or it was already free); reply unconditionally --
            # our send comes after the head store, so by the time the peer's
            # recv returns, its view of the cursors is current.
            self._doorbell(fires)
        if self.tx:
            self.kick_tx(fires)  # the doorbell may mean tx-ring space freed
        if eof and self.alive:
            self._pump_frames(fires)
            self.worker._conn_broken(self, fires)

    def _pump_frames(self, fires: list) -> None:
        matcher = self.worker.matcher
        lock = self.worker.lock
        while self.alive:
            if self._rx_skip:
                # Duplicate sequenced frame: drain its payload to scratch
                # without touching the matcher (exactly-once delivery).
                if self._scratch is None:
                    self._scratch = bytearray(RX_CHUNK)
                target = memoryview(self._scratch)[: min(self._rx_skip, RX_CHUNK)]
                try:
                    n = self._rx_read(target)
                except BlockingIOError:
                    return
                except (ConnectionResetError, OSError):
                    self.worker._conn_broken(self, fires)
                    return
                if n == 0:
                    self.worker._conn_broken(self, fires)
                    return
                if self._csum_pend is not None:
                    self._csum_accum = frames.crc32c(target[:n],
                                                     self._csum_accum)
                self._rx_skip -= n
                if self._rx_skip == 0 and self._csum_pend is not None:
                    # A drained frame (duplicate seq / superseded chunk)
                    # ends here: verify for accounting only -- nothing
                    # was delivered, so a mismatch needs no recovery.
                    pend, self._csum_pend = self._csum_pend, None
                    if self._csum_accum != pend[0]:
                        self._ctr.csum_fail += 1
                continue
            if self._sdata is not None:
                # Striped-chunk sub-header (24 bytes: msg id, offset,
                # total) accumulating on this rail.
                stag, sub, got, blen = self._sdata
                try:
                    n = self._rx_read(memoryview(sub)[got:])
                except BlockingIOError:
                    return
                except (ConnectionResetError, OSError):
                    self.worker._conn_broken(self, fires)
                    return
                if n == 0:
                    self.worker._conn_broken(self, fires)
                    return
                if self._csum_pend is not None:
                    self._csum_accum = frames.crc32c(
                        memoryview(sub)[got:got + n], self._csum_accum)
                got += n
                if got < len(sub):
                    self._sdata = (stag, sub, got, blen)
                    continue
                self._sdata = None
                if (self._csum_pend is not None
                        and self._csum_accum != self._csum_pend[1]):
                    # Routing fields (header+sub-header) cannot be
                    # trusted: the stream framing itself is suspect, and
                    # a NACK would carry garbage ids -- poison instead.
                    self._corrupt(fires, "stripe sub-header checksum")
                    return
                msg_id, off, total = frames.SDATA_SUB.unpack(sub)
                chunk_len = blen - frames.SDATA_SUB_SIZE
                rx = self._stripe_rx_tbl()
                asm = rx.chunk_start(stag, msg_id, off, total, chunk_len,
                                     fires)
                if asm is None:
                    # Duplicate offset or already-completed message
                    # (rail-death resend / session replay): drain the
                    # chunk, re-SACK completed ids so the sender stops.
                    self._rx_skip = chunk_len
                    if msg_id in rx.done_ids:
                        rx.sack(self, msg_id, total, fires)
                    continue
                self._rx_stripe = (asm, off, chunk_len)
                self._rx_stripe_got = 0
                continue
            if self._rx_stripe is not None:
                asm, off, clen = self._rx_stripe
                got = self._rx_stripe_got
                remaining = clen - got
                m = asm.msg
                if m.discard or m.sink is None:
                    if self._scratch is None:
                        self._scratch = bytearray(RX_CHUNK)
                    target = memoryview(self._scratch)[: min(remaining, RX_CHUNK)]
                else:
                    pos = off + got
                    target = m.sink[pos: pos + min(remaining, RX_CHUNK)]
                try:
                    n = self._rx_read(target)
                except BlockingIOError:
                    return
                except (ConnectionResetError, OSError):
                    self.worker._conn_broken(self, fires)
                    return
                if n == 0:
                    self.worker._conn_broken(self, fires)
                    return
                if self._csum_pend is not None:
                    self._csum_accum = frames.crc32c(target[:n],
                                                     self._csum_accum)
                got += n
                if got < clen:
                    self._rx_stripe_got = got
                    continue
                self._rx_stripe = None
                self._rx_stripe_got = 0
                if self._csum_pend is not None:
                    pend, self._csum_pend = self._csum_pend, None
                    if self._csum_accum != pend[0]:
                        # Chunk payload corrupt, routing verified: NACK
                        # just this chunk (§19).  The offset was never
                        # recorded in the assembly, so the retransmit
                        # streams into the same sink region; the conn
                        # stays healthy.
                        self._ctr.csum_fail += 1
                        logger.warning(
                            "starway: corrupt striped chunk on conn %s "
                            "(msg %d off %d); requesting retransmit",
                            self.conn_id, asm.msg_id, off)
                        self.send_ctl(frames.pack_snack(asm.msg_id, off),
                                      fires)
                        continue
                self._stripe_rx_tbl().chunk_done(self, asm, off, clen, fires)
                continue
            m = self._rx_msg
            if m is not None:
                remaining = m.length - m.received
                if m.discard or m.sink is None:
                    if self._scratch is None:
                        self._scratch = bytearray(RX_CHUNK)
                    target = memoryview(self._scratch)[: min(remaining, RX_CHUNK)]
                else:
                    target = m.sink[m.received : m.received + min(remaining, RX_CHUNK)]
                try:
                    n = self._rx_read(target)
                except BlockingIOError:
                    return
                except (ConnectionResetError, OSError):
                    self.worker._conn_broken(self, fires)
                    return
                if n == 0:
                    self.worker._conn_broken(self, fires)
                    return
                if self._csum_pend is not None:
                    self._csum_accum = frames.crc32c(target[:n],
                                                     self._csum_accum)
                m.received += n
                if (m.progress is not None and not m.discard
                        and m.sink is not None):
                    # Device-sink overlap: fully-arrived chunks start their
                    # async H2D while the rest of the payload streams in
                    # (device.py DeviceRecvSink.staged; DESIGN.md §12).
                    m.progress(m.received)
                if m.received >= m.length:
                    if self._csum_pend is not None:
                        # Verified BEFORE the matcher completes the
                        # receive: corrupt bytes must never reach user
                        # code as good data (§19).  Poison -- the replay
                        # (sessions) rewrites the sink from the start.
                        pend, self._csum_pend = self._csum_pend, None
                        if self._csum_accum != pend[0]:
                            self._corrupt(fires, "payload checksum (DATA)")
                            return
                    with lock:
                        fires.extend(matcher.on_message_complete(m))
                    self._rx_msg = None
                    self._rx_e2e(m.length)
                    self._sess_commit()
                continue
            if self._ctl is not None:
                ftype, body, got, a = self._ctl
                try:
                    n = self._rx_read(memoryview(body)[got:])
                except BlockingIOError:
                    return
                except (ConnectionResetError, OSError):
                    self.worker._conn_broken(self, fires)
                    return
                if n == 0:
                    self.worker._conn_broken(self, fires)
                    return
                if self._csum_pend is not None:
                    self._csum_accum = frames.crc32c(
                        memoryview(body)[got:got + n], self._csum_accum)
                got += n
                if got < len(body):
                    self._ctl = (ftype, body, got, a)
                    continue
                self._ctl = None
                if self._csum_pend is not None:
                    pend, self._csum_pend = self._csum_pend, None
                    if self._csum_accum != pend[0]:
                        self._corrupt(fires, "control body checksum")
                        return
                # json.loads reads the bytearray directly: no full-body copy.
                # A body that is not a valid JSON OBJECT (bad syntax, a
                # nesting bomb, or the wrong shape -- unpack_json_body
                # raises ValueError for all three) is a protocol
                # violation on THIS conn, not an engine-thread
                # exception: an unhandled raise here escaped the event
                # loop and emergency-closed the whole worker (every conn
                # with it).  The native ctl dispatch breaks the conn on
                # the same non-object shapes; braced-but-invalid JSON is
                # the one residual asymmetry (its tolerant field
                # extractor cannot see syntax).
                try:
                    info = frames.unpack_json_body(body)
                except ValueError:
                    self.worker._conn_broken(self, fires)
                    return
                if ftype == frames.T_HELLO:
                    self.worker._on_hello(self, info, fires)
                elif ftype == frames.T_DEVPULL:
                    self.worker._on_devpull(self, a, info, fires)
                    self._rx_e2e(len(body))
                    self._sess_commit()
                elif ftype == frames.T_RTS:
                    self.worker._on_rts(self, a, info, fires)
                else:
                    self.worker._on_hello_ack(self, info, fires)
                continue
            # header state
            try:
                n = self._rx_read(memoryview(self._hdr)[self._hdr_got :])
            except BlockingIOError:
                return
            except (ConnectionResetError, OSError):
                self.worker._conn_broken(self, fires)
                return
            if n == 0:
                self.worker._conn_broken(self, fires)
                return
            if self._csum_pend is not None:
                # The header of the protected frame is covered too: a
                # corrupted length field must never desync the stream.
                self._csum_accum = frames.crc32c(
                    memoryview(self._hdr)[self._hdr_got:self._hdr_got + n],
                    self._csum_accum)
            self._hdr_got += n
            if self._hdr_got < frames.HEADER_SIZE:
                continue
            self._hdr_got = 0
            ftype, a, b = frames.unpack_header(self._hdr)
            if self._proto is not None:
                # swrefine: one protocol event per dispatched inbound
                # frame, BEFORE the §19 gate and the dispatch chain --
                # the monitor sees exactly what the parser saw
                # (DESIGN.md §22; the native pump_stream taps the same
                # point).
                self._proto.rec(swtrace.EV_PROTO, 0, self.conn_id, 0,
                                "rx:" + frames.FRAME_NAMES.get(ftype,
                                                               "OTHER"))
            if self.csum_ok:
                # §19 verification gate, BEFORE dispatch: arm on T_CSUM,
                # require one for every protected frame, and validate
                # routing fields the moment they are parsed.
                pend = self._csum_pend
                if ftype == frames.T_CSUM:
                    if pend is not None:
                        self._corrupt(fires, "nested checksum prefix")
                        return
                    # Only the low 32 bits are CRC (the native engine
                    # truncates to uint32_t; keeping the full u64 here
                    # made the engines disagree on adversarial prefixes
                    # -- wirefuzz corpus seed).
                    self._csum_pend = (a & 0xFFFFFFFF, b & 0xFFFFFFFF)
                    self._csum_accum = 0
                    continue
                if ftype not in _CSUM_EXEMPT:
                    if pend is None:
                        self._corrupt(fires, "frame without checksum")
                        return
                    if (ftype != frames.T_SDATA
                            and self._csum_accum != pend[1]):
                        self._corrupt(fires, "frame header checksum")
                        return
                    body_follows = (ftype == frames.T_SDATA
                                    or (ftype in _CSUM_BODY and b > 0))
                    if not body_follows:
                        # Header-only frame: the header IS the frame.
                        self._csum_pend = None
                        if self._csum_accum != pend[0]:
                            self._corrupt(fires, "frame checksum")
                            return
            if ftype == frames.T_DATA:
                if self._sess_drop:
                    self._sess_drop = False
                    if b:
                        self._rx_skip = b
                        if self.fc_ok:
                            # The dup was re-debited against the fresh
                            # window at the sender's resume: grant it
                            # back (no memory held -- credit
                            # conservation, DESIGN.md §18).
                            self.send_ctl(frames.pack_credit(b), fires)
                    continue
                overload = False
                spilled = False
                with lock:
                    msg, f = matcher.on_message_start(a, b)
                    fires.extend(f)
                    spilled = (b > 0 and not msg.discard
                               and msg.posted is None
                               and msg.spill is not None)
                    # Tracked only when §18 is in play (fc negotiated or
                    # the cap armed): the seed path must not pay an
                    # engine op per unexpected message.
                    if spilled and (self.fc_ok or self._unexp_cap):
                        # Unexpected spill: charge this conn's window
                        # accounting; the matcher returns the grant when
                        # the bytes leave the queue (fc_release).
                        matcher.fc_track(msg, self, self.fc_rx_gen, b)
                        self.fc_unexp += b
                        # Per-conn cap: the offender is the conn whose
                        # own un-granted residency crossed the line
                        # (total bound = cap x live conns), never an
                        # innocent peer spilling into a full queue.
                        overload = bool(self._unexp_cap
                                        and self.fc_unexp
                                        > self._unexp_cap)
                    if b == 0:
                        fires.extend(matcher.on_message_complete(msg))
                    else:
                        self._rx_msg = msg
                if overload:
                    # STARWAY_UNEXP_BYTES breaker: reset this conn
                    # instead of letting the process OOM (last resort
                    # for peers that never negotiated fc).
                    logger.warning(
                        "starway: unexpected-queue cap exceeded "
                        "(%d > %d); resetting conn %s",
                        self.fc_unexp, self._unexp_cap, self.conn_id)
                    self.worker._conn_broken(self, fires)
                    return
                if b == 0:
                    self._rx_e2e(0)
                    self._sess_commit()
                elif self.fc_ok and not spilled:
                    # Matched at header (streams into the posted buffer)
                    # or probe-discarded: no unexpected memory is held,
                    # so the sender's debit returns immediately.
                    self.send_ctl(frames.pack_credit(b), fires)
            elif ftype == frames.T_FLUSH:
                if self._sess_drop:
                    self._sess_drop = False
                    continue
                self._sess_commit()
                if self._remote_msgs:
                    # Unresolved pulls precede this barrier in the stream:
                    # defer the ACK until they land (the sender's flush must
                    # mean the payload is resident here), and force-start
                    # any still waiting for a matching receive.
                    self.defer_flush_ack(a)
                    self.worker._force_start_pulls(self, fires)
                else:
                    self.send_flush_ack(a, fires)
            elif ftype == frames.T_FLUSH_ACK:
                if self._sess_drop:
                    self._sess_drop = False
                    continue
                self._sess_commit()
                self.worker._on_flush_ack(self, a, fires)
            elif ftype == frames.T_SEQ:
                if not self._on_seq(a, fires):
                    return
            elif ftype == frames.T_ACK:
                if self.sess is not None:
                    self._on_ack(a, fires)
            elif ftype == frames.T_BYE:
                # Peer's clean local close on a session conn: the session
                # is over -- the imminent EOF must take the seed/keepalive
                # death contract (prompt "not connected", no fault dump),
                # not a grace-window suspend + redial.
                if self.sess is not None and not self.sess.expired:
                    self.sess.expired = True
                    getattr(self.worker, "_sessions", {}).pop(
                        self.sess.sid, None)
            elif ftype == frames.T_SDATA:
                # Striped chunk (DESIGN.md §17): the 24-byte sub-header
                # follows; a body not longer than it is a protocol
                # violation (no sender emits zero-length chunks, and a
                # zero-length read here stalled the sm transport forever
                # while TCP misread it as EOF -- wirefuzz corpus seed).
                if b <= frames.SDATA_SUB_SIZE:
                    self.worker._conn_broken(self, fires)
                    return
                self._sdata = (a, bytearray(frames.SDATA_SUB_SIZE), 0, b)
            elif ftype == frames.T_SACK:
                if not self._fc_on_sack(a, fires):
                    root = self.stripe_root()
                    if root.stripe is not None:
                        root.stripe.on_sack(a, fires)
            elif ftype == frames.T_SNACK:
                # §19 chunk-level retransmit request from the receiver.
                self._on_snack(a, b, fires)
            elif ftype == frames.T_CREDIT:
                self._on_credit(a, fires)
            elif ftype == frames.T_CTS:
                self._on_cts(a, fires)
            elif ftype == frames.T_PING:
                # Liveness probe: answer immediately.  _rx_read already
                # refreshed last_rx, so receiving PINGs also proves the
                # peer alive to us.  A timestamped PING gets its echo +
                # our own clock reading (the swscope sample channel).
                self.send_ctl(frames.pack_pong(a, time.perf_counter_ns()),
                              fires)
            elif ftype == frames.T_PONG:
                self._on_pong(a, b)  # proof of life recorded by _rx_read
            elif ftype in (frames.T_HELLO, frames.T_HELLO_ACK,
                           frames.T_DEVPULL, frames.T_RTS):
                # A ctl frame's JSON body is small and never empty; a
                # zero length used to issue a 0-byte read (EOF-alike on
                # TCP, a permanent stall on sm rings, a silent drop in
                # the C++ engine) and an unchecked length is a remote
                # allocation primitive -- both are protocol violations
                # now, in BOTH engines (frames.CTL_MAX; wirefuzz seeds).
                if b == 0 or b > frames.CTL_MAX:
                    self.worker._conn_broken(self, fires)
                    return
                if ftype == frames.T_DEVPULL and self._sess_drop:
                    self._sess_drop = False
                    self._rx_skip = b
                    continue
                self._ctl = (ftype, bytearray(b), 0, a)
            else:
                self.worker._conn_broken(self, fires)
                return

    # --------------------------------------------------------------- close
    def _cancel_tx_state(self, fires: list,
                         reason: str = REASON_CANCELLED,
                         count: bool = True) -> None:
        """Cancel every queued / journaled / parked tx item exactly once
        (cancel() is idempotent; journal entries may also sit in tx)."""
        items = list(self.tx)
        if self.sess is not None:
            items.extend(self.sess.journal)
            items.extend(self.sess.waiting)
            self.sess.journal.clear()
            self.sess.journal_bytes = 0
            self.sess.waiting.clear()
        if self.fc_waiting:
            # Flow-control-parked sends take the same fate as queued ones.
            items.extend(self.fc_waiting)
            self.fc_waiting.clear()
        if self.fc_rts:
            # Announced rendezvous sends: drop the pins, cancel the ops
            # (a delivery item may also sit in tx -- cancel is
            # idempotent, one count).
            items.extend(ent[0] for ent in self.fc_rts.values())
            self.fc_rts.clear()
        self.fc_rx.clear()  # dedup index only; the matcher owns the records
        for item in items:
            before = len(fires)
            item.cancel(fires, reason)
            if count and len(fires) > before:
                self._ctr.ops_cancelled += 1
        self.tx.clear()
        if self.stripe is not None:
            # Primary terminal teardown: un-SACKed striped sources take
            # the same fate as queued sends (counts ops_cancelled).
            self.stripe.cancel_all(fires, reason)
        if self.stripe_rx is not None:
            self.stripe_rx.purge()

    def close(self, fires: list) -> None:
        """Close at local shutdown.

        Unfinished tagged sends are cancelled and the socket is reset so the
        peer cannot observe a partial message as delivered (the reference's
        close-cancels-in-flight semantics, src/bindings/main.cpp:483-507).
        With no data in flight the close is graceful: kernel-buffered bytes
        still drain to the peer.
        """
        abort = self.has_unfinished_data_tx()
        if (self.alive and self.sock is not None and self.sess is not None
                and not self.sess.suspended and not self.sess.expired
                and not abort and (not self.tx or self.tx[0].off == 0)):
            # Clean close on a session conn: tell the peer the session is
            # over (T_BYE) so it fails over to the seed death contract
            # instead of suspending for the grace window.  Best-effort --
            # a lost BYE only costs the peer the grace-expiry fallback.
            try:
                bye = frames.pack_bye()
                if self.csum_ok:
                    bye = frames.pack_csum_for(bye) + bye
                self.sock.sendall(bye)
            except OSError:
                pass
        self._cancel_tx_state(fires)
        if self.alive:
            self.alive = False
            self.worker._unregister_conn_io(self)
            try:
                if self.sock is not None:
                    if abort:
                        self.sock.setsockopt(
                            socket.SOL_SOCKET,
                            socket.SO_LINGER,
                            socket_linger_struct(),
                        )
                    self.sock.close()
            except OSError:
                pass
            self.sock = None
        self._close_sm()

    def mark_dead(self, fires: list) -> None:
        if self.alive:
            self.alive = False
            self.worker._unregister_conn_io(self)
            # A §19 poison owns the cancel reason: in-flight ops report
            # "corrupt", not a generic cancel (tests/test_integrity.py).
            self._cancel_tx_state(fires,
                                  self.poison_reason or REASON_CANCELLED)
            if self._rx_msg is not None:
                with self.worker.lock:
                    self.worker.matcher.purge_inflight(self._rx_msg)
                self._rx_msg = None
            try:
                if self.sock is not None:
                    self.sock.close()
            except OSError:
                pass
            self.sock = None
        self._close_sm()

    def transports(self) -> list[tuple[str, str]]:
        if self.sm_negotiated:
            return [("shm", "sm")]
        dev = "lo" if self.remote_addr.startswith("127.") else "eth0"
        return [(dev, "tcp")]


def socket_linger_struct() -> bytes:
    import struct as _s

    return _s.pack("ii", 1, 0)  # l_onoff=1, l_linger=0 -> RST on close


class InprocConn(BaseConn):
    kind = "inproc"

    def __init__(self, worker, peer_worker_ref, mode: str):
        super().__init__(worker, mode)
        self.peer_worker_ref = peer_worker_ref  # weakref.ref
        self.peer_conn: Optional["InprocConn"] = None

    def send_data(self, tag: int, payload, done, fail, owner, fires: list,
                  kick: bool = True) -> None:
        # ``kick`` is the TcpConn deferred-push knob; in-process delivery
        # is synchronous, so there is nothing to defer.
        peer = self.peer_worker_ref()
        if not self.alive or peer is None or peer.status != state.RUNNING:
            if fail is not None:
                fires.append(lambda: fail(REASON_NOT_CONNECTED + " (peer closed)"))
            return
        with peer.lock:
            peer_fires = peer.matcher.deliver(tag, payload)
        fires.extend(peer_fires)
        nbytes = len(payload) if isinstance(payload, memoryview) else int(payload.nbytes)
        self._ctr.bytes_tx += nbytes
        self._ctr.sends_completed += 1
        # §25: synchronous delivery -- local completion at post (bucket 0).
        self._hists.send_local_us[0] += 1
        peer_ctr = getattr(peer, "counters", None)
        if peer_ctr is not None:
            peer_ctr.bytes_rx += nbytes
        if done is not None:
            fires.append(done)

    def send_flush(self, seq: int, fires: list) -> None:
        # In-process delivery is synchronous and FIFO on the engine thread:
        # by the time the flush op is processed every prior send has been
        # ingested by the peer's matcher, so the barrier is already met.
        self.flush_acked = seq
        self.worker._on_flush_ack(self, seq, fires)

    def close(self, fires: list) -> None:
        self.alive = False
        if self.peer_conn is not None:
            self.peer_conn.alive = False

    def mark_dead(self, fires: list) -> None:
        self.close(fires)

    def transports(self) -> list[tuple[str, str]]:
        return [("shm", "inproc")]
