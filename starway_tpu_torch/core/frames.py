"""Wire protocol for the host (TCP / DCN-bootstrap) transport.

The reference gets its wire protocol for free from UCX tag matching
(``ucp_tag_send_nbx`` / ``ucp_tag_recv_nbx``, reference: src/bindings/main.cpp:370,404).
The TPU build has no tag-matching NIC, so the host transport speaks a small
framed protocol over a stream socket and the tag matcher lives in the worker
runtime (see core/matching.py).

Every frame starts with a fixed 17-byte little-endian header::

    u8  type
    u64 a
    u64 b

Frame types (fields a / b):

========= ============================ ======================================
type      a                            b
========= ============================ ======================================
HELLO     0                            length of JSON body that follows
HELLO_ACK 0                            length of JSON body that follows
DATA      sender tag                   payload length (bytes that follow)
FLUSH     flush sequence number        0
FLUSH_ACK flush sequence number        0
DEVPULL   sender tag                   length of JSON descriptor that follows
PING      sender tx time (ns; 0=none)  0
PONG      echoed PING tx time          responder tx time (ns)
SEQ       next session frame's seq     0
ACK       cumulative received seq      0
BYE       0                            0
SDATA     sender tag                   24-byte stripe sub-header + chunk
SACK      striped message id           echoed message total (bytes)
CREDIT    granted window bytes         0
RTS       sender tag                   length of JSON descriptor that follows
CTS       echoed rendezvous msg id     0
CSUM      next frame's full CRC32C     next frame's header(+sub) CRC32C
SNACK     corrupt chunk's msg id       corrupt chunk's offset (retransmit)
========= ============================ ======================================

PING / PONG are the *negotiated* peer-liveness probe (``"ka": "ok"``
offered in HELLO and confirmed in HELLO_ACK, like ``sm``/``devpull``):
when ``STARWAY_KEEPALIVE`` enables liveness detection (config.py), each
engine PINGs peers that have been silent for an interval and the peer
answers PONG; any inbound bytes count as proof of life.  A peer silent
for ``STARWAY_KEEPALIVE_MISSES`` intervals is declared dead.  Both
engines ignore unknown HELLO keys, so an old peer simply never confirms
``ka`` and is never PINGed -- all pairings interoperate.  On sm-upgraded
conns the probes ride the rings while the socket stays the doorbell +
liveness channel (core/shmring.py), so process death is still detected
instantly by EOF/RST and the PING path only covers silent wedges.

The probe pair doubles as the swscope clock-offset channel (DESIGN.md
§15): a PING may carry the sender's CLOCK_MONOTONIC timestamp in ``a``
(nanoseconds; 0 = plain liveness probe) and the PONG echoes it in ``a``
with the responder's own timestamp in ``b``.  The pinger then has an
NTP-style sample -- ``offset = t_responder - (t_tx + rtt/2)`` with error
``rtt/2`` -- recorded as an EV_CLOCK trace event so ``python -m
starway_tpu_torch.trace --merge`` can align rings from different processes
onto one timeline.  Old peers answer a timestamped PING with a zero
PONG (no sample, never an error), so all pairings interoperate.  When
tracing is armed the connector additionally sends one timestamped PING
right after the handshake, so clock samples exist even with keepalive
off.

``tr`` is the swscope end-to-end trace negotiation: a connector with
tracing armed (STARWAY_TRACE / STARWAY_FLIGHT_DIR) offers ``"tr":
"<16-hex trace-conn id>"`` in HELLO; an acceptor that is also tracing
confirms with ``"tr": "ok"`` and both sides adopt the id.  Each engine
then emits an EV_E2E trace event per DATA/DEVPULL frame -- tagged with
the trace-conn id, the direction, and a per-conn per-direction wire
ordinal (delivery is in-order per conn, so equal ordinals at the two
ends are the same message; no per-frame wire bytes needed).  Session
replays never double-count: the sender records an ordinal once at the
frame's first full transmission (a replayed already-counted frame emits
a ``:sup`` superseded marker instead), and the receiver's seq dedup
drops duplicate frames before they reach the ordinal counter.

DEVPULL is a *negotiated extension* (``"devpull": "ok"`` offered in HELLO
and confirmed in HELLO_ACK, like ``sm``): instead of streaming a device
payload's bytes, the sender registers the array with its PJRT transfer
server (``jax.experimental.transfer``) and sends this small descriptor
``{"u": uuid, "a": server_address, "n": nbytes, "s": shape, "d": dtype}``;
the receiver pulls the buffer device-to-device over the PJRT socket --
no host staging in the framework.  Both engines speak it: the Python
engine natively, the C++ engine by surfacing descriptors to its wrapper
(sw_engine.h "devpull").  A process that cannot pull (no jax, or backend
not up at handshake time) never negotiates the capability and peers fall
back to staged DATA frames, so all pairings interoperate (see device.py
TransferManager; the flush barrier covers pulls because the receiver
defers FLUSH_ACK until descriptors received before the FLUSH have
resolved).

HELLO is sent by the connector and carries ``{"worker_id", "mode", "name"}``
-- the analogue of the reference's worker-address Active-Message handshake
(AM id 0x7A, reference: src/bindings/main.cpp:25,292-334).  ``mode`` is
``"socket"`` or ``"address"``; in address mode the accepted endpoint reports
empty socket fields, mirroring the reference (README.md:141-143).

HELLO may additionally offer a same-host shared-memory upgrade
(``sm_key`` / ``sm_nonce`` / ``sm_ring`` -- see core/shmring.py); an
acceptor that successfully maps the segment confirms with ``"sm": "ok"``
in HELLO_ACK and both sides move the framed stream onto the rings, keeping
the socket as doorbell + liveness channel.  All extra values are JSON
strings so the native engine's minimal extractor can read them, and both
engines ignore unknown keys -- old and new peers interoperate, falling
back to plain TCP.  This mirrors UCX's transport negotiation
(``UCX_TLS`` including ``sm``; reference: benchmark.md:114-126).

SEQ / ACK belong to the *negotiated* resilient-session layer
(``STARWAY_SESSION``, offered as ``"sess": "ok"`` with a stable
``sess_id`` / ``sess_epoch`` / ``sess_ack`` triple in HELLO and confirmed
in HELLO_ACK -- all JSON strings, like the other extensions): on a
session conn every replayable frame (DATA / DEVPULL / FLUSH / FLUSH_ACK)
is preceded by a SEQ frame announcing its per-conn sequence number.  The
receiver tracks the cumulative in-order seq, drops any frame whose seq it
has already processed (exactly-once delivery across replays), and sends
cumulative ACKs -- piggybacked on each read pass and flushed by an idle
timer.  The sender keeps unacked frames in a bounded replay journal and,
after a reconnect handshake carrying the same ``sess_id``/``sess_epoch``,
replays everything past the peer's ``sess_ack``.  PING/PONG/ACK/handshake
frames are per-connection-incarnation and are never sequenced or
journaled.  BYE is the session goodbye: a peer closing *locally* on a
clean frame boundary sends it (best-effort) right before the FIN so the
survivor knows the session is over and takes the seed/keepalive death
contract immediately -- without it, EOF is indistinguishable from a
crash and the survivor would suspend for the full grace window.  A lost
BYE only costs the peer that grace-expiry fallback.  See DESIGN.md §14.

SDATA / SACK are the *negotiated* multi-rail striping plane (DESIGN.md
§17).  A connector started with ``STARWAY_RAILS=N`` offers
``"rails": "<N>"`` in the primary HELLO; a striping-capable acceptor
confirms ``"rails": "ok"`` and the connector dials N-1 extra TCP conns
whose HELLO carries ``"rail_of": "<primary worker_id>"`` -- the acceptor
attaches each to the existing endpoint (confirming ``"rail": "ok"``)
instead of creating a new one.  A send at or above
``STARWAY_STRIPE_THRESHOLD`` on a railed conn is then split at
``STARWAY_STRIPE_CHUNK`` granularity and each chunk travels as one SDATA
frame on whichever rail claims it first (completion-driven work
stealing): header ``a`` = sender tag, ``b`` = body length, and the body
opens with the 24-byte little-endian sub-header ``u64 msg_id, u64
offset, u64 total`` followed by the chunk bytes.  The receiver
reassembles by offset into one matcher message keyed by (rail group,
msg_id), drops duplicate offsets (chunks are idempotent, which is what
makes rail-death redistribution and session replay exactly-once), and
answers SACK (``a`` = msg_id, ``b`` = total) when the last byte lands --
the sender's signal to release the pinned payload.  Old peers never
negotiate ``rails`` and never see either frame; sub-threshold sends ride
ordinary DATA frames on the primary rail even when striping is on.

CREDIT / RTS / CTS are the *negotiated* receiver-driven flow-control
plane (DESIGN.md §18).  A peer started with ``STARWAY_FC_WINDOW=N``
offers ``"fc": "<N>"`` in HELLO -- "my unexpected-queue budget for your
eager traffic is N bytes"; an fc-capable acceptor confirms with its own
``"fc": "<M>"`` in HELLO_ACK and each direction is then governed by the
RECEIVER's advertised window.  The sender debits the window per eager
DATA payload and parks sends unframed-FIFO when it runs dry (one
oversized frame is admitted against an idle window so nothing
deadlocks); the receiver returns CREDIT grants (``a`` = bytes) as the
debited messages are matched into posted receives or drained, which is
what bounds receiver unexpected-queue memory to the window.  Sends
above the rendezvous threshold never consume window: the sender
announces them with a small RTS descriptor (``a`` = tag, JSON body
``{"m": msg_id, "n": total}`` -- the devpull-descriptor shape, and the
receiver queues it through the same matcher machinery), the receiver
answers CTS (``a`` = msg_id) once a matching receive claims it (or a
flush barrier forces it), and the payload then travels as one
self-describing T_SDATA frame routed into the pre-registered assembly
and SACKed at the last byte -- the sender pins the payload until that
SACK, so a session resume can safely re-announce it.  Old peers never
confirm ``fc`` and see none of the three frames; with the env unset the
HELLO is byte-identical to the seed.

CSUM / SNACK are the *negotiated* end-to-end integrity plane
(``STARWAY_INTEGRITY``, DESIGN.md §19).  A peer started with the knob
offers ``"csum": "1"`` in HELLO; an integrity-capable acceptor confirms
``"csum": "ok"`` and every subsequent framed message on the conn -- DATA,
ctl, striped chunks, everything except the handshake pair and the T_SEQ
session prefix -- is preceded by one T_CSUM frame: ``a`` is the CRC32C
(Castagnoli; :func:`crc32c`) over the next frame's entire header+body
bytes, ``b`` the CRC32C over just its header (plus the 24-byte sub-header
for T_SDATA).  The receiver verifies ``b`` the moment the routing fields
are parsed -- BEFORE the payload streams into a user buffer -- so a
corrupted length/offset can never desync the stream or scribble on a
verified region; ``a`` is verified at the frame's last byte.  The two
recovery paths: a corrupt striped T_SDATA chunk with an intact sub-header
answers T_SNACK (``a`` = msg id, ``b`` = chunk offset) and the sender
re-queues JUST that chunk through the §17 offset-dedup reassembly
(payloads are pinned until T_SACK, so the resend is always legal); any
other mismatch poisons the conn with the stable ``"corrupt"`` reason --
seed contract without sessions, suspend+replay with them.  Wrap order on
session conns is ``[T_SEQ][T_CSUM][frame]``: the checksum rides inside
the sequenced envelope and replays byte-identically from the journal.
Old peers never confirm ``csum`` and see neither frame; with the env
unset the HELLO is byte-identical to the seed.

FLUSH / FLUSH_ACK implement the delivery barrier: because the byte stream is
processed in order, a FLUSH_ACK for sequence *n* proves every DATA payload
enqueued before flush *n* has been fully ingested by the peer's matching
engine -- the semantics ``ucp_worker_flush_nbx`` provides in the reference
(src/bindings/main.cpp:432,1202; behaviour pinned by tests/test_basic.py:190-415).
"""

from __future__ import annotations

import ctypes
import json
import struct

HEADER = struct.Struct("<BQQ")
HEADER_SIZE = HEADER.size  # 17

T_HELLO = 1
T_HELLO_ACK = 2
T_DATA = 3
T_FLUSH = 4
T_FLUSH_ACK = 5
T_DEVPULL = 6
T_PING = 7
T_PONG = 8
T_SEQ = 9
T_ACK = 10
T_BYE = 11
T_SDATA = 12
T_SACK = 13
T_CREDIT = 14
T_RTS = 15
T_CTS = 16
T_CSUM = 17
T_SNACK = 18

# Canonical frame-name table for the swrefine protocol-event channel
# (DESIGN.md §22): ``rx:<NAME>``/``tx:<NAME>`` events and the protocol
# monitor automaton use exactly these names -- the T_* suffix, which is
# also the protomodel annotation vocabulary (analysis/protomodel.py
# KNOWN_INPUTS).  Cross-engine contract surface: the C++ engine carries
# the same table as ``proto_frame_name()`` in sw_engine.cpp, and the
# `refine` analysis pass diffs the two entry-by-entry (a frame type
# missing from either table, or mapped to a different name, is a merge-
# gate finding).  Types absent from the table render as "OTHER" -- the
# unknown-frame dispatch arm.
FRAME_NAMES = {
    T_HELLO: "HELLO",
    T_HELLO_ACK: "HELLO_ACK",
    T_DATA: "DATA",
    T_FLUSH: "FLUSH",
    T_FLUSH_ACK: "FLUSH_ACK",
    T_DEVPULL: "DEVPULL",
    T_PING: "PING",
    T_PONG: "PONG",
    T_SEQ: "SEQ",
    T_ACK: "ACK",
    T_BYE: "BYE",
    T_SDATA: "SDATA",
    T_SACK: "SACK",
    T_CREDIT: "CREDIT",
    T_RTS: "RTS",
    T_CTS: "CTS",
    T_CSUM: "CSUM",
    T_SNACK: "SNACK",
}

# Rendezvous (RTS/CTS) message-id namespace bit (DESIGN.md §18): fc msg
# ids carry the top bit so they can never collide with stripe msg ids on
# a railed+fc conn -- both families share the receiver's assembly table
# and completed-id LRU.  Cross-engine contract (FC_MSG_BIT in
# sw_engine.cpp).
FC_MSG_BIT = 1 << 63

# §19 per-frame checksum scope (DESIGN.md §19, §21): the frame types
# exempt from the negotiated T_CSUM prefix (the handshake pair predates
# negotiation; the T_SEQ session prefix glues OUTSIDE the envelope --
# wire order [SEQ][CSUM][frame]), and the types whose bytes continue past
# the 17-byte header (their full-frame CRC verifies at the last payload
# byte; every other protected type is header-only and verifies at
# dispatch).  Shared by the live parser (core/conn.py), the reference
# decoder below, and -- as kCsumExempt[]/kCsumBody[] -- the C++ engine's
# parser and decode harness; membership is cross-engine contract surface
# diffed by the `wirefuzz` analysis pass.
CSUM_EXEMPT = frozenset((T_HELLO, T_HELLO_ACK, T_SEQ))
CSUM_BODY = frozenset((T_DATA, T_DEVPULL, T_RTS))

# Upper bound on a control-frame JSON body (DESIGN.md §21).  The
# HELLO/HELLO_ACK/DEVPULL/RTS descriptors are tiny, but the engines
# allocate/accumulate `b` bytes for them, so an unchecked length field is
# a remote allocation primitive -- and a zero length is degenerate (the
# Python parser used to issue a 0-byte read that a TCP socket reports as
# EOF and an sm ring reports as idle: conn death on one transport, a
# silent permanent stall on the other, while the C++ engine silently
# dropped the frame).  A ctl frame announcing b == 0 or b > CTL_MAX is a
# protocol violation and breaks the conn in BOTH engines (CTL_MAX
# constexpr in sw_engine.cpp; wirefuzz corpus seeds pin both edges).
CTL_MAX = 1 << 20

#: Frame types that are exactly one 17-byte header on the wire.  T_CSUM
#: is deliberately absent: on a conn that never negotiated "csum" it is
#: an unknown frame (conn death), and on an integrity conn it is the
#: envelope the verification gate consumes before dispatch.
HEADER_ONLY = frozenset((T_FLUSH, T_FLUSH_ACK, T_PING, T_PONG, T_SEQ,
                         T_ACK, T_BYE, T_SACK, T_CREDIT, T_CTS, T_SNACK))

# Striped-DATA sub-header (DESIGN.md §17): u64 msg_id, u64 offset,
# u64 total -- little-endian, leading every SDATA body.  The 24-byte size
# is cross-engine contract surface (SDATA_SUB_SIZE in sw_engine.cpp,
# machine-checked by `python -m starway_tpu_torch.analysis`).
SDATA_SUB = struct.Struct("<QQQ")
SDATA_SUB_SIZE = SDATA_SUB.size  # 24


# ------------------------------------------------------------- integrity
#
# CRC32C (Castagnoli, the iSCSI/ext4 polynomial) is the integrity plane's
# checksum (DESIGN.md §19): the native engine computes it with the SSE4.2
# / ARMv8 CRC instructions (sw_crc32c, software slicing fallback), and
# the Python engine calls that same export through ctypes so both engines
# -- and both ends of a mixed pair -- agree bit-for-bit.  The pure-Python
# table below is the no-toolchain fallback; tests pin it against the
# native export and the standard check vector crc32c(b"123456789") ==
# 0xE3069283.  The chaining contract matches zlib.crc32: ``crc`` is the
# previous call's RESULT (the implementation re-inverts internally), so
# a payload can be folded incrementally chunk by chunk.

_CRC32C_POLY = 0x82F63B78
_crc_table: list | None = None
_crc_native = None  # ctypes fn, or False once probed absent


def _crc32c_table() -> list:
    global _crc_table
    if _crc_table is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
            tbl.append(c)
        _crc_table = tbl
    return _crc_table


def _crc32c_fn():
    """The native sw_crc32c export, or False.  Probed lazily and only
    against an already-built artifact -- the first checksum computes on
    the connection path, where a synchronous g++ build would stall it
    (the shmring.atomics(build=False) discipline)."""
    global _crc_native
    if _crc_native is None:
        try:
            from . import native

            fn = native.crc32c_fn(build=False)
        except Exception:
            fn = None
        _crc_native = fn if fn is not None else False
    return _crc_native


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data`` chained onto a previous result ``crc`` (zlib
    calling convention).  Accepts any C-contiguous buffer."""
    mv = data if isinstance(data, memoryview) else memoryview(data)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    n = len(mv)
    if n == 0:
        return crc & 0xFFFFFFFF
    fn = _crc32c_fn()
    if fn is not False:
        try:
            buf = (ctypes.c_ubyte * n).from_buffer(mv)
        except TypeError:
            # Read-only source.  A whole immutable buffer (bytes payloads,
            # packed ctl frames) crosses ctypes as a borrowed pointer --
            # no copy; only a read-only *slice* (rare, small spans) pays a
            # materialisation.
            base = getattr(mv, "obj", None)
            if isinstance(base, bytes) and len(base) == n:
                buf = base
            else:
                buf = bytes(mv)
        return fn(buf, n, crc & 0xFFFFFFFF)
    tbl = _crc32c_table()
    c = (crc & 0xFFFFFFFF) ^ 0xFFFFFFFF
    for b in bytes(mv):
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def pack_header(ftype: int, a: int, b: int) -> bytes:
    return HEADER.pack(ftype, a, b)


def unpack_header(buf) -> tuple[int, int, int]:
    return HEADER.unpack(buf)


def pack_hello(worker_id: str, mode: str, name: str = "", extra: dict | None = None) -> bytes:
    fields = {"worker_id": worker_id, "mode": mode, "name": name}
    if extra:
        fields.update(extra)
    body = json.dumps(fields, separators=(",", ":")).encode()
    return pack_header(T_HELLO, 0, len(body)) + body


def pack_hello_ack(worker_id: str, extra: dict | None = None) -> bytes:
    fields = {"worker_id": worker_id}
    if extra:
        fields.update(extra)
    body = json.dumps(fields, separators=(",", ":")).encode()
    return pack_header(T_HELLO_ACK, 0, len(body)) + body


def unpack_json_body(body) -> dict:
    """Parse a JSON control body straight from the accumulation buffer.

    ``json.loads`` reads ``bytes``/``bytearray`` directly, so the callers
    (core/conn.py's ctl parser, core/engine.py's handshake) pass their
    buffers as-is with no intermediate full-body ``bytes()`` copy; a
    ``memoryview`` is materialised here because json cannot read one."""
    if isinstance(body, memoryview):
        body = body.tobytes()
    try:
        info = json.loads(body)
    except RecursionError:
        # A nesting bomb (b"["*50000 fits well under CTL_MAX) must be a
        # protocol violation like any other malformed body, never an
        # engine-thread escape that emergency-closes the whole worker.
        raise ValueError("ctl body nesting too deep") from None
    if not isinstance(info, dict):
        # Every ctl body in the protocol is a JSON OBJECT; valid JSON of
        # the wrong shape ([] / "x" / 42) would otherwise raise from the
        # handlers' .get() field access off the event loop.  The native
        # engine enforces the same object shape at its ctl dispatch.
        raise ValueError("ctl body is not a JSON object")
    return info


def pack_data_header(tag: int, length: int) -> bytes:
    return pack_header(T_DATA, tag, length)


def pack_flush(seq: int) -> bytes:
    return pack_header(T_FLUSH, seq, 0)


def pack_flush_ack(seq: int) -> bytes:
    return pack_header(T_FLUSH_ACK, seq, 0)


def pack_ping(t_ns: int = 0) -> bytes:
    """Liveness probe; ``t_ns`` (CLOCK_MONOTONIC nanoseconds) arms the
    swscope clock-sample reply, 0 keeps the plain PR-1 probe."""
    return pack_header(T_PING, t_ns, 0)


def pack_pong(echo_ns: int = 0, t_ns: int = 0) -> bytes:
    """Probe answer: echo the PING's timestamp and stamp our own."""
    return pack_header(T_PONG, echo_ns, t_ns)


def pack_seq(seq: int) -> bytes:
    return pack_header(T_SEQ, seq, 0)


def pack_ack(cum_seq: int) -> bytes:
    return pack_header(T_ACK, cum_seq, 0)


def pack_bye() -> bytes:
    return pack_header(T_BYE, 0, 0)


def pack_sdata_header(tag: int, msg_id: int, offset: int, total: int,
                      chunk_len: int) -> bytes:
    """Header + sub-header of one striped chunk (payload bytes follow)."""
    return (pack_header(T_SDATA, tag, SDATA_SUB_SIZE + chunk_len)
            + SDATA_SUB.pack(msg_id, offset, total))


def pack_sack(msg_id: int, total: int) -> bytes:
    return pack_header(T_SACK, msg_id, total)


def pack_credit(nbytes: int) -> bytes:
    """Receiver-driven window grant: ``nbytes`` of eager budget returned
    to the sender (DESIGN.md §18)."""
    return pack_header(T_CREDIT, nbytes, 0)


def pack_rts(tag: int, msg_id: int, total: int) -> bytes:
    """Rendezvous announcement: a tiny descriptor instead of the payload
    (the devpull-descriptor shape; the receiver pulls via CTS)."""
    body = json.dumps({"m": msg_id, "n": total},
                      separators=(",", ":")).encode()
    return pack_header(T_RTS, tag, len(body)) + body


def pack_cts(msg_id: int) -> bytes:
    return pack_header(T_CTS, msg_id, 0)


def pack_snack(msg_id: int, offset: int) -> bytes:
    """Chunk-level retransmit request (DESIGN.md §19): the T_SDATA chunk
    at ``offset`` of ``msg_id`` failed payload verification; its routing
    sub-header verified, so only that chunk needs to ride again."""
    return pack_header(T_SNACK, msg_id, offset)


def pack_csum_for(frame_bytes, payload=None) -> bytes:
    """The T_CSUM prefix for one outgoing frame (DESIGN.md §19).

    ``frame_bytes`` is everything of the frame already materialised as
    bytes (header, plus any sub-header/JSON body); ``payload`` the
    remaining flat payload view, if any.  ``b`` (crc_head) covers the
    17-byte header -- plus the 24-byte stripe sub-header for T_SDATA --
    so the receiver validates routing fields before streaming the
    payload; ``a`` (crc_frame) covers every byte of the frame."""
    head_len = HEADER_SIZE
    if frame_bytes[0] == T_SDATA:
        head_len += SDATA_SUB_SIZE
    if head_len > len(frame_bytes):
        head_len = len(frame_bytes)
    ch = crc32c(frame_bytes[:head_len])
    cf = ch
    if len(frame_bytes) > head_len:
        cf = crc32c(frame_bytes[head_len:], cf)
    if payload is not None and len(payload):
        cf = crc32c(payload, cf)
    return pack_header(T_CSUM, cf, ch)


def pack_devpull(tag: int, desc: dict) -> bytes:
    body = json.dumps(desc, separators=(",", ":")).encode()
    return pack_header(T_DEVPULL, tag, len(body)) + body


# ------------------------------------------------- reference decoder
#
# The normative structural decoder for the framed stream: the exact
# accept/reject/short outcome of core/conn.py's `_pump_frames` parser
# (and the C++ engine's `pump_frames`), as one pure function over a flat
# byte buffer.  `python -m starway_tpu_torch.analysis` (the `wirefuzz` pass,
# DESIGN.md §21) feeds identical adversarial buffers to this function, to
# its own grammar-derived oracle, and to the native engine's
# `sw_wire_decode` export, and diffs the canonical outcome strings --
# any divergence is a cross-engine contract finding.  Keep this function
# in lockstep with `_pump_frames`: it IS the written-down decode
# contract ("two engines, one wire format", CLAUDE.md).

#: Cap on rendered frame entries (both engines truncate identically so
#: the canonical strings stay diffable on long streams).
DECODE_MAX_ENTRIES = 64


def fmt_decode(status: str, consumed: int, entries: list) -> str:
    """Canonical decode-outcome string: shared, byte-identical format
    between this module, analysis/wirefuzz.py's oracle, shmring's record
    decoder, and the native sw_wire_decode export."""
    shown = entries[:DECODE_MAX_ENTRIES]
    extra = len(entries) - len(shown)
    if extra > 0:
        shown.append(f"+{extra}")
    return f"{status} n={consumed} [" + " ".join(shown) + "]"


def decode_stream(data, csum: bool = False) -> str:
    """Decode one framed byte stream and return the canonical outcome.

    ``csum=True`` decodes under the negotiated §19 integrity plane (the
    T_CSUM envelope rules).  The outcome triple is (status, consumed,
    frames): status is ``ok`` (buffer ends on a frame boundary),
    ``short:<state>`` (mid-frame: more bytes would continue the stream),
    or ``reject(<reason>)`` (the engines poison/break the conn here --
    ``<reason>`` uses the engines' stable corruption phrases).
    ``n=<consumed>`` counts bytes of fully-processed frames; entries are
    ``type:a:b`` (T_SDATA adds ``:msg_id:off:total``; a corrupt striped
    chunk with verified routing renders the recoverable
    ``snack:msg_id:off`` event instead -- the §19 retransmit path, not a
    poison).  Never allocates from wire-controlled lengths."""
    buf = bytes(data)  # swcheck: allow(hotpath-copy): bounded fuzz/gate input, never a data path
    n = len(buf)
    pos = 0
    consumed = 0
    entries: list = []
    pend = None  # armed T_CSUM envelope: (crc_frame, crc_head)
    accum = 0

    def done(status: str) -> str:
        return fmt_decode(status, consumed, entries)

    while True:
        if pos + HEADER_SIZE > n:
            return done("ok" if pos == n else "short:header")
        hdr = buf[pos:pos + HEADER_SIZE]
        ftype, a, b = HEADER.unpack(hdr)
        if pend is not None:
            # The protected frame's header is covered too: a corrupted
            # length field must never desync the stream (§19).
            accum = crc32c(hdr, accum)
        pos += HEADER_SIZE
        if csum:
            # §19 verification gate, BEFORE dispatch (conn.py twin).
            if ftype == T_CSUM:
                if pend is not None:
                    return done("reject(nested checksum prefix)")
                # Engines keep only the low 32 bits (the CRC width).
                pend = (a & 0xFFFFFFFF, b & 0xFFFFFFFF)
                accum = 0
                entries.append(f"{ftype}:{a}:{b}")
                consumed = pos
                continue
            if ftype not in CSUM_EXEMPT:
                if pend is None:
                    return done("reject(frame without checksum)")
                if ftype != T_SDATA and accum != pend[1]:
                    return done("reject(frame header checksum)")
                body_follows = (ftype == T_SDATA
                                or (ftype in CSUM_BODY and b > 0))
                if not body_follows:
                    cf, pend = pend[0], None
                    if accum != cf:
                        return done("reject(frame checksum)")
        if ftype == T_SDATA:
            if b <= SDATA_SUB_SIZE:
                return done("reject(sdata sub-header)")
            if pos + SDATA_SUB_SIZE > n:
                return done("short:sub")
            sub = buf[pos:pos + SDATA_SUB_SIZE]
            if pend is not None:
                accum = crc32c(sub, accum)
                if accum != pend[1]:
                    return done("reject(stripe sub-header checksum)")
            msg_id, off, total = SDATA_SUB.unpack(sub)
            pos += SDATA_SUB_SIZE
            clen = b - SDATA_SUB_SIZE
            if pos + clen > n:
                return done("short:body")
            if pend is not None:
                accum = crc32c(buf[pos:pos + clen], accum)
                cf, pend = pend[0], None
                if accum != cf:
                    # Chunk payload corrupt, routing verified: the
                    # recoverable T_SNACK retransmit, conn stays healthy.
                    pos += clen
                    entries.append(f"snack:{msg_id}:{off}")
                    consumed = pos
                    continue
            pos += clen
            entries.append(f"{ftype}:{a}:{b}:{msg_id}:{off}:{total}")
            consumed = pos
            continue
        if ftype == T_DATA:
            if b:
                if pos + b > n:
                    return done("short:body")
                if pend is not None:
                    accum = crc32c(buf[pos:pos + b], accum)
                    cf, pend = pend[0], None
                    if accum != cf:
                        return done("reject(payload checksum (DATA))")
                pos += b
            entries.append(f"{ftype}:{a}:{b}")
            consumed = pos
            continue
        if ftype in (T_HELLO, T_HELLO_ACK, T_DEVPULL, T_RTS):
            if b == 0:
                return done("reject(zero control body)")
            if b > CTL_MAX:
                return done("reject(oversized control body)")
            if pos + b > n:
                return done("short:body")
            if pend is not None:
                # The ctl-completion verify consumes the envelope even
                # for the (nonsensical) exempt-frame-inside-envelope
                # shape -- both engines clear pend at any ctl body end.
                accum = crc32c(buf[pos:pos + b], accum)
                cf, pend = pend[0], None
                if accum != cf:
                    return done("reject(control body checksum)")
            pos += b
            entries.append(f"{ftype}:{a}:{b}")
            consumed = pos
            continue
        if ftype in HEADER_ONLY:
            entries.append(f"{ftype}:{a}:{b}")
            consumed = pos
            continue
        return done("reject(unknown frame type)")
