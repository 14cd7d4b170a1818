"""TCP fault-injection proxy fabric.

Production communication stacks treat partial failure as a first-class
input: connections that die mid-frame, peers that accept and then go
silent, links that partition without an RST.  The reference repo never
exercises any of these (its failure tests kill whole processes); this
module makes them reproducible on loopback so the fault-tolerance layer
(deadlines, keepalive liveness, reconnect -- see DESIGN.md "Failure
semantics & deadlines") can be driven through real sockets in-process.

:class:`FaultProxy` sits between a starway client and server::

    server.listen("127.0.0.1", sport)
    proxy = FaultProxy("127.0.0.1", sport)        # transparent forwarder
    proxy.start()
    await client.aconnect("127.0.0.1", proxy.port)
    ...
    proxy.partition()   # both directions go silent; sockets stay open

Fault modes (constructor ``mode=``):

``forward``
    Transparent byte pump (the default).  Runtime faults are injected
    with :meth:`partition` / :meth:`heal`.
``delay``
    Forward with ``delay`` seconds of added latency per chunk.
``drop``
    Forward ``limit_bytes`` of client->server traffic, then hard-kill both
    sides with an RST (SO_LINGER 0) -- the mid-frame connection kill.
``truncate``
    Forward ``limit_bytes`` of client->server traffic, then FIN both
    sides -- the peer observes a clean EOF in the middle of a frame.
``blackhole``
    Accept the client, never dial the target, read and discard inbound
    bytes, send nothing -- the accept-then-silence failure (a wedged or
    firewalled peer).
``choke``
    Accept and forward, but drain client->server traffic at
    ``rate_bytes_per_s`` (small reads + proportional sleeps; the return
    path stays a transparent pipe).  The reproducible slow consumer:
    overload tests (DESIGN.md §18 flow control, bounded unexpected
    queues, deadline shedding) get a receiver that genuinely cannot keep
    up without real slow hardware or test-side sleeps.
``duplicate``
    Frame-aware c->s forwarding that sends every *sequenced* session unit
    (T_SEQ prefix + its frame, core/frames.py) past ``limit_bytes``
    TWICE -- the replayed-frame overlap a resilient-session receiver must
    drop by sequence number (``dup_frames_dropped``).  Handshake and
    unsequenced frames pass through untouched, so the mode is a no-op on
    seed-parity conns (they carry no T_SEQ frames at all).
``reorder``
    Frame-aware c->s forwarding that swaps ONE adjacent pair of sequenced
    units past ``limit_bytes`` (then forwards transparently).  The
    receiver sees a sequence gap it cannot repair in place, resets the
    conn, and the session layer's redial + replay-from-cumulative-ACK
    path runs end to end.
``corrupt``
    Frame-aware c->s forwarding that mutates matching units past
    ``limit_bytes`` -- the silent-data-corruption generator the §19
    integrity plane (``STARWAY_INTEGRITY``, DESIGN.md §19) is tested
    against.  Selection and mutation knobs:

    * ``corrupt_ftype`` -- wire frame type to target (e.g. 3 = DATA,
      12 = SDATA); ``None`` targets any frame that carries a body.
    * ``corrupt_where`` -- ``"payload"`` (default) flips inside the
      frame's body (for SDATA: past the 24-byte sub-header, so routing
      stays intact and the receiver answers T_SNACK); ``"header"`` flips
      inside the 17-byte header / sub-header region (routing corrupt:
      the receiver must poison the conn).
    * ``corrupt_kind`` -- ``"flip"`` (default) XORs one byte at
      ``corrupt_offset`` (relative to the chosen region; default mid);
      ``"truncate"`` deletes ``corrupt_bytes`` bytes there instead,
      desyncing the stream mid-frame.
    * ``corrupt_count`` -- units to mutate (default 1, then the pump is
      transparent again).

    Without integrity negotiated the corruption is SILENT -- bytes
    deliver as good data -- which is exactly the blindness the plane
    exists to remove.

``partition_after`` (bytes, any mode that forwards) auto-triggers
:meth:`partition` once that much client->server traffic has passed --
deterministic mid-stream silence without test-side sleeps.
:meth:`reset_mid_message` arms a byte-exact RST: the proxy forwards
client->server traffic up to an absolute byte offset (splitting a chunk
if needed, so the kill really lands mid-frame) and then hard-kills both
sides -- the deterministic connection-death-mid-transfer the session
resume tests are built on.

Threads: one acceptor plus two pumps per proxied connection, all daemons;
:meth:`stop` closes every socket and joins.  Loopback-only by design --
this is a test harness, not a production relay.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional

_CHUNK = 1 << 16

MODES = ("forward", "delay", "drop", "truncate", "blackhole", "duplicate",
         "reorder", "choke", "corrupt")

# Wire-format knowledge for the frame-aware modes (core/frames.py): 17-byte
# little-endian header {u8 type, u64 a, u64 b}; HELLO/HELLO_ACK/DATA/DEVPULL
# stream `b` payload bytes behind the header, everything else is bare.  A
# T_SEQ frame (9) is the session layer's sequence prefix and a T_CSUM
# frame (17) the §19 integrity prefix; both travel glued to the frame they
# announce -- the frame-aware modes treat [SEQ][CSUM][frame] as one unit.
_HDR = 17
_T_SEQ = 9
_T_SDATA = 12  # striped chunk: self-describing, dup/reorder-eligible
_T_CSUM = 17   # §19 integrity prefix: glues to the next frame
_PREFIX_TYPES = frozenset((_T_SEQ, _T_CSUM))
_SDATA_SUB = 24  # stripe sub-header behind an SDATA header (frames.py)
_BODY_TYPES = frozenset((1, 2, 3, 6, 12))  # HELLO, HELLO_ACK, DATA, DEVPULL, SDATA


class _ConnPair:
    """One proxied connection: the client-side socket and (unless
    blackholed) the upstream socket to the real server."""

    def __init__(self, downstream: socket.socket, upstream: Optional[socket.socket]):
        self.down = downstream
        self.up = upstream
        self.dead = False

    def kill(self, rst: bool) -> None:
        if self.dead:
            return
        self.dead = True
        for s in (self.down, self.up):
            if s is None:
                continue
            try:
                if rst:
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                 struct.pack("ii", 1, 0))
            except OSError:
                pass
            try:
                # shutdown() interrupts a pump thread blocked in recv();
                # close() alone does not and would strand it until the
                # join timeout.
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class FaultProxy:
    def __init__(self, target_host: str, target_port: int, mode: str = "forward",
                 *, listen_host: str = "127.0.0.1", delay: float = 0.0,
                 limit_bytes: int = 0, partition_after: Optional[int] = None,
                 rate_bytes_per_s: int = 64 * 1024,
                 corrupt_ftype: Optional[int] = None,
                 corrupt_where: str = "payload",
                 corrupt_kind: str = "flip",
                 corrupt_offset: Optional[int] = None,
                 corrupt_bytes: int = 1,
                 corrupt_count: int = 1):
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r}; expected one of {MODES}")
        if corrupt_where not in ("payload", "header"):
            raise ValueError(f"corrupt_where {corrupt_where!r}")
        if corrupt_kind not in ("flip", "truncate"):
            raise ValueError(f"corrupt_kind {corrupt_kind!r}")
        self.target = (target_host, target_port)
        self.mode = mode
        self.delay = delay
        self.rate = max(1, int(rate_bytes_per_s))
        self.limit_bytes = limit_bytes
        self.partition_after = partition_after
        self.corrupt_ftype = corrupt_ftype
        self.corrupt_where = corrupt_where
        self.corrupt_kind = corrupt_kind
        self.corrupt_offset = corrupt_offset
        self.corrupt_bytes = max(1, int(corrupt_bytes))
        self._corrupt_left = max(0, int(corrupt_count))
        self.corrupted_units = 0  # units actually mutated (test oracle)
        self._partitioned = threading.Event()
        self._stalled = threading.Event()
        self._stopping = threading.Event()
        self._lock = threading.Lock()
        self._pairs: list[_ConnPair] = []
        self._threads: list[threading.Thread] = []
        self._c2s_bytes = 0  # client->server bytes forwarded (fault triggers)
        self._reset_at: Optional[int] = None  # armed byte-exact RST offset
        self._reordered = False  # reorder mode fires its one swap only once
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, 0))
        self._listener.listen(64)
        self.port: int = self._listener.getsockname()[1]

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FaultProxy":
        t = threading.Thread(target=self._accept_loop, name="faultproxy-accept",
                             daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def __enter__(self) -> "FaultProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self) -> None:
        self._stopping.set()
        self._stalled.clear()  # release pumps parked in the stall loop
        try:
            self._listener.shutdown(socket.SHUT_RDWR)  # wake a blocked accept
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            pairs = list(self._pairs)
        for p in pairs:
            p.kill(rst=False)
        for t in self._threads:
            t.join(timeout=5)

    # ------------------------------------------------------ runtime faults
    def partition(self) -> None:
        """Go silent in both directions.  Sockets stay open: neither peer
        sees EOF or RST -- the network-partition / wedged-peer failure that
        only deadlines or keepalive liveness can detect."""
        self._partitioned.set()

    def heal(self) -> None:
        """Resume forwarding.  Bytes swallowed during the partition are
        gone (this is a byte pipe, not a retransmitting relay), so healing
        mid-message leaves the framed stream corrupt -- heal only between
        messages, or expect the engines to declare the conn broken."""
        self._partitioned.clear()

    def stall(self) -> None:
        """Stop READING from both sides (unlike :meth:`partition`, which
        keeps draining and discarding).  Kernel buffers back up and the
        peers' sockets wedge -- the backpressure failure that blocks even
        a send's first byte."""
        self._stalled.set()

    def unstall(self) -> None:
        self._stalled.clear()

    def kill_all(self, rst: bool = True) -> None:
        """Tear down every proxied connection now (RST by default)."""
        with self._lock:
            pairs = list(self._pairs)
        for p in pairs:
            p.kill(rst)

    def reset_mid_message(self, at_bytes: int) -> None:
        """Arm a byte-exact connection kill: forward client->server bytes
        up to absolute offset ``at_bytes`` (splitting the chunk that
        crosses it, so the RST genuinely lands mid-frame) then hard-kill
        both sides.  Single-shot: a reconnecting session pair pumps
        through undisturbed afterwards -- the deterministic
        death-mid-transfer the resume tests are built on."""
        self._reset_at = at_bytes

    @property
    def forwarded_bytes(self) -> int:
        return self._c2s_bytes

    # ------------------------------------------------------------ internals
    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                down, _ = self._listener.accept()
            except OSError:
                return
            down.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.mode == "blackhole":
                pair = _ConnPair(down, None)
                with self._lock:
                    self._pairs.append(pair)
                t = threading.Thread(target=self._blackhole_loop, args=(pair,),
                                     daemon=True)
                t.start()
                self._threads.append(t)
                continue
            try:
                up = socket.create_connection(self.target, timeout=5)
                up.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                down.close()
                continue
            pair = _ConnPair(down, up)
            with self._lock:
                self._pairs.append(pair)
            for src, dst, is_c2s in ((down, up, True), (up, down, False)):
                # duplicate/reorder/corrupt are frame-aware on the faulted
                # (c->s) direction only; the return path stays a byte pipe.
                fn = (self._pump_framed
                      if is_c2s and self.mode in ("duplicate", "reorder",
                                                  "corrupt")
                      else self._pump)
                t = threading.Thread(target=fn, args=(pair, src, dst, is_c2s),
                                     daemon=True)
                t.start()
                self._threads.append(t)

    def _blackhole_loop(self, pair: _ConnPair) -> None:
        # Accept-then-silence: drain inbound (so the client's kernel buffer
        # never backs up into a send-side signal), respond with nothing.
        while not self._stopping.is_set() and not pair.dead:
            try:
                if not pair.down.recv(_CHUNK):
                    break
            except OSError:
                break
        pair.kill(rst=False)

    def _pump(self, pair: _ConnPair, src: socket.socket, dst: socket.socket,
              is_c2s: bool) -> None:
        # choke (c->s only): small reads so the rate limit has fine
        # granularity; the proportional sleep after each forward is what
        # makes the drain rate real.
        choked = is_c2s and self.mode == "choke"
        chunk = min(_CHUNK, max(256, self.rate // 20)) if choked else _CHUNK
        while not self._stopping.is_set() and not pair.dead:
            while (self._stalled.is_set() and not self._stopping.is_set()
                   and not pair.dead):
                time.sleep(0.01)  # backpressure: let kernel buffers fill
            try:
                data = src.recv(chunk)
            except OSError:
                # One side died hard (RST): propagate to the other, as a
                # direct connection would -- a silent exit here would
                # leave the survivor connected to a dead pipe forever.
                if not self._partitioned.is_set():
                    pair.kill(rst=True)
                return
            # A pump already parked in recv() when stall() fired still
            # returns this chunk: HOLD it (don't forward, don't drop)
            # until unstalled, so the stall is byte-deterministic -- no
            # in-flight frame slips past the wedge.
            while (self._stalled.is_set() and not self._stopping.is_set()
                   and not pair.dead):
                time.sleep(0.01)
            if not data:
                if self._partitioned.is_set():
                    return  # a partition swallows EOFs too: pure silence
                # Clean EOF from one side: half-close towards the other so
                # graceful shutdowns still look graceful through the proxy.
                try:
                    dst.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                return
            if self._partitioned.is_set():
                continue  # swallowed: silence, not EOF
            if self.delay > 0:
                time.sleep(self.delay)
            if choked:
                time.sleep(len(data) / self.rate)
            if is_c2s and self._reset_at is not None:
                remaining = self._reset_at - self._c2s_bytes
                if len(data) >= remaining:
                    # Deliver exactly up to the armed offset, then RST:
                    # the kill lands mid-frame, byte-deterministically.
                    self._reset_at = None
                    if remaining > 0:
                        self._send_all(pair, dst, data[:remaining], is_c2s)
                    pair.kill(rst=True)
                    return
            if is_c2s and self.mode in ("drop", "truncate"):
                remaining = self.limit_bytes - self._c2s_bytes
                if remaining <= 0:
                    pair.kill(rst=self.mode == "drop")
                    return
                if len(data) > remaining:
                    data = data[:remaining]  # deliver the partial frame...
                    if not self._send_all(pair, dst, data, is_c2s):
                        return
                    pair.kill(rst=self.mode == "drop")  # ...then the fault
                    return
            if not self._send_all(pair, dst, data, is_c2s):
                return
            if (is_c2s and self.partition_after is not None
                    and self._c2s_bytes >= self.partition_after):
                self._partitioned.set()

    def _maybe_corrupt(self, unit: bytes, plen: int, ftype: int) -> bytes:
        """Corrupt-mode mutation of one assembled unit.  ``plen`` is the
        byte length of the glued SEQ/CSUM prefixes; the targeted frame's
        header starts there.  Mutates at most ``corrupt_count`` units."""
        if self._corrupt_left <= 0:
            return unit
        if self.corrupt_ftype is not None:
            if ftype != self.corrupt_ftype:
                return unit
        elif ftype not in (3, 6, 12):  # DATA / DEVPULL / SDATA
            return unit
        head_len = _HDR + (_SDATA_SUB if ftype == _T_SDATA else 0)
        if self.corrupt_where == "header":
            start, length = plen, min(head_len, len(unit) - plen)
        else:
            start = plen + head_len
            length = len(unit) - start
        if length <= 0:
            return unit
        rel = self.corrupt_offset if self.corrupt_offset is not None \
            else length // 2
        idx = start + max(0, min(length - 1, rel))
        out = bytearray(unit)
        if self.corrupt_kind == "flip":
            out[idx] ^= 0x20
        else:  # truncate: drop bytes mid-frame, desyncing the stream
            del out[idx : idx + self.corrupt_bytes]
        self._corrupt_left -= 1
        self.corrupted_units += 1
        return bytes(out)

    def _pump_framed(self, pair: _ConnPair, src: socket.socket,
                     dst: socket.socket, is_c2s: bool) -> None:
        """Frame-aware client->server pump for the duplicate/reorder/
        corrupt modes: reassembles the byte stream into wire units
        (header + payload, with T_SEQ/T_CSUM prefixes glued to the frame
        they announce) and injects the fault on eligible units past
        ``limit_bytes``.  Other traffic (handshake, liveness, ACKs)
        passes through untouched, so seed-parity conns see a transparent
        proxy."""
        buf = bytearray()
        held: list = []   # SEQ/CSUM prefix units awaiting their frame
        reorder_hold: Optional[bytes] = None
        try:
            src.settimeout(0.2)  # idle tick: a held swap must not hang a quiet stream
        except OSError:
            pass
        while not self._stopping.is_set() and not pair.dead:
            while (self._stalled.is_set() and not self._stopping.is_set()
                   and not pair.dead):
                time.sleep(0.01)
            try:
                data = src.recv(_CHUNK)
            except socket.timeout:
                if reorder_hold is not None:
                    # Nothing followed the held unit: flush it (the swap
                    # degenerates to a delay) so a trailing barrier frame
                    # cannot wedge the stream.
                    unit, reorder_hold = reorder_hold, None
                    if not self._forward_unit(pair, dst, unit, is_c2s):
                        return
                continue
            except OSError:
                # RST propagation, like the raw pump above.
                if not self._partitioned.is_set():
                    pair.kill(rst=True)
                return
            # Hold-not-forward on a stall that landed mid-recv, like the
            # raw pump above.
            while (self._stalled.is_set() and not self._stopping.is_set()
                   and not pair.dead):
                time.sleep(0.01)
            if not data:
                if self._partitioned.is_set():
                    return
                try:
                    dst.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                return
            if self._partitioned.is_set():
                continue
            buf += data
            while True:
                if len(buf) < _HDR:
                    break
                ftype = buf[0]
                blen = struct.unpack_from("<Q", buf, 9)[0]
                need = _HDR + (blen if ftype in _BODY_TYPES else 0)
                if len(buf) < need:
                    break
                unit = bytes(buf[:need])
                del buf[:need]
                if ftype in _PREFIX_TYPES:
                    held.append(unit)  # glue to the frame they announce
                    continue
                # dup/reorder eligibility: sequenced session units, or
                # self-describing striped chunks (offset-dedup'd,
                # DESIGN.md §17) -- the faults these modes exercise.
                sequenced = (any(u[0] == _T_SEQ for u in held)
                             or ftype == _T_SDATA)
                plen = sum(len(u) for u in held)
                if held:
                    unit = b"".join(held) + unit
                    held.clear()
                out = unit
                past = self._c2s_bytes >= self.limit_bytes
                if past and self.mode == "corrupt":
                    out = self._maybe_corrupt(unit, plen, ftype)
                elif sequenced and past and self.mode == "duplicate":
                    out = unit + unit  # replay overlap: receiver must dedup
                elif (sequenced and past and self.mode == "reorder"
                      and not self._reordered):
                    if reorder_hold is None:
                        reorder_hold = unit
                        continue  # hold; the NEXT sequenced unit goes first
                    out = unit + reorder_hold
                    reorder_hold = None
                    self._reordered = True
                if not self._forward_unit(pair, dst, out, is_c2s):
                    return

    def _forward_unit(self, pair: _ConnPair, dst: socket.socket, out: bytes,
                      is_c2s: bool) -> bool:
        """Forward one (possibly duplicated/swapped) wire unit from the
        framed pump, honouring the byte-level triggers the raw pump also
        implements: an armed :meth:`reset_mid_message` offset splits the
        unit so the RST lands byte-exactly, and ``partition_after``
        swallows everything past its threshold."""
        if self._reset_at is not None:
            remaining = self._reset_at - self._c2s_bytes
            if len(out) >= remaining:
                self._reset_at = None
                if remaining > 0:
                    self._send_all(pair, dst, out[:remaining], is_c2s)
                pair.kill(rst=True)
                return False
        if not self._send_all(pair, dst, out, is_c2s):
            return False
        if (self.partition_after is not None
                and self._c2s_bytes >= self.partition_after):
            self._partitioned.set()
        return True

    def _send_all(self, pair: _ConnPair, dst: socket.socket, data: bytes,
                  is_c2s: bool) -> bool:
        try:
            dst.sendall(data)
        except OSError:
            pair.kill(rst=False)
            return False
        if is_c2s:
            self._c2s_bytes += len(data)
        return True
