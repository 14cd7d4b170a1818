"""Shared-memory ring transport: the same-host fast path ("sm").

The reference's UCX layer negotiates a shared-memory transport between
same-host processes whenever ``UCX_TLS`` allows it (reference:
benchmark.md:114-126 lists ``sm`` among the transports; posix/sysv shm are
UCX's loopback default).  This module is the TPU build's equivalent: a
pair of SPSC byte rings in a ``/dev/shm`` segment, negotiated over the
existing HELLO/HELLO_ACK handshake (core/frames.py) and carrying the exact
same framed byte stream as the TCP path -- the frame parser cannot tell the
transports apart.  The TCP connection stays open as the doorbell + liveness
channel (peer death is still detected by EOF/RST; wakeups are 1-byte
writes), so no busy-polling is needed: both engines stay event-driven.

Segment layout (all little-endian, offsets in bytes)::

    0    u64  magic      0x31676e69726d7773  ("swmring1")
    8    u64  nonce      random; echoed in HELLO to authenticate the segment
    16   u64  ring_size  bytes per direction, power of two
    24..63    reserved
    64   ring 0 header (connector->acceptor direction)
           +0   u64 tail              producer cursor, free-running
           +8   u64 (reserved)        legacy producer_blocked flag, unused
           +64  u64 head              consumer cursor, free-running
    192  ring 1 header (acceptor->connector direction), same shape
    320..383  reserved
    384             ring 0 data [ring_size]
    384+ring_size   ring 1 data [ring_size]

``head``/``tail`` live on separate cache lines (the producer writes tail and
reads head; the consumer the reverse).  Cursors are free-running u64s:
``avail = tail - head``, ``free = ring_size - avail``; data index is
``cursor & (ring_size - 1)``.  On x86/CPython the pure-Python cursor ops
lean on TSO: aligned 8-byte stores are atomic and store-store ordered,
which is exactly the data-before-tail publication this protocol needs.  On
other architectures Python cannot fence, so every cursor access routes
through the native lib's ``sw_atomic_load_u64``/``sw_atomic_store_u64``
(acquire/release; see :func:`_use_portable_atomics`) — ``config.
sm_enabled()`` refuses sm only when that lib is unavailable too.  The C++
engine implements the same layout with real atomics throughout and
carries sm on any architecture.  This layout is the cross-engine
contract: any change here must land in both engines (CLAUDE.md "two
engines, one contract").

Integrity records (DESIGN.md §19): when both peers negotiated ``csum``
(``STARWAY_INTEGRITY``), each producer write becomes one *slot record*
inside the same byte ring::

    u32 len     payload bytes that follow
    u32 crc     CRC32C over (u64 slot seqno LE || payload bytes)

The slot seqno is an implicit free-running per-direction counter both
sides maintain, so a stale or replayed region of ring memory can never
verify; the checksum over the payload catches torn/partial writes (a
consumer observing a published tail whose data stores it cannot yet see,
e.g. on a weakly-ordered host, reads a record that fails verification
instead of silently delivering garbage).  Records are written atomically
-- header+payload copied, then one tail publication -- so ``readable()``
always covers whole records; a record is sized to whatever fits, so the
stream semantics above the ring are unchanged.  Verification happens at
dequeue: a mismatch raises :class:`SmCorrupt` and the conn poisons with
the stable ``"corrupt"`` reason (core/conn.py).  The 8-byte record
header (``REC_HDR``) is cross-engine contract surface (``SM_REC_HDR`` in
sw_engine.cpp, machine-checked by ``python -m starway_tpu_torch.analysis``).

Wakeup protocol: every cross-side wakeup rides the TCP socket, never shared
memory.  A producer that advances ``tail`` sends a doorbell byte (DB_DATA);
a producer that finds the ring full sends a *starving* byte (DB_STARVING)
and sleeps; the consumer, upon seeing a starving byte, drains the ring and
replies with a doorbell.  Because the signal is a send/recv syscall pair,
the sleeping side's next cursor read is ordered after the waking side's
cursor write (the kernel transition is a full barrier on both ends) -- the
classic store-load race of flag-based schemes cannot occur, in any
language, with no fence and no timed poll.  A doorbell that meets a full
socket buffer is queued and flushed on EPOLLOUT (core/conn.py), so the one
wakeup a sleeping producer depends on is never dropped.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import secrets
import struct

from . import frames

MAGIC = 0x31676E69726D7773  # b"swmring1" little-endian

_HDR = struct.Struct("<QQQ")  # magic, nonce, ring_size

GLOBAL_HDR = 64
RING_HDR = 128
DATA_OFF = GLOBAL_HDR + 2 * RING_HDR  # 384

OFF_TAIL = 0
OFF_HEAD = 64

# §19 integrity slot-record header: u32 payload len, u32 CRC32C(seqno ||
# payload) -- little-endian, leading every ring write when the conn
# negotiated "csum".  Cross-engine contract (SM_REC_HDR in sw_engine.cpp).
REC_HDR = 8
_REC = struct.Struct("<II")
_SEQ8 = struct.Struct("<Q")

SHM_DIR = "/dev/shm"

# 1 MiB keeps the ring + both working chunks cache-resident: measured on the
# dev box, 256K-1M rings stream at ~11-12 GB/s single-process while 4M+ rings
# fall to ~5 GB/s (DRAM eviction).  Large transfers are DRAM-bound anyway;
# small rings also bound the wakeup ping-pong granularity.
DEFAULT_RING = 1 << 20
MAX_RING = 1 << 30


def _use_portable_atomics() -> bool:
    """Route cursor accesses through the native lib's acquire/release
    atomics instead of raw mmap ops.  Needed off x86 (no TSO, Python can't
    fence); forceable on x86 via STARWAY_SM_FORCE_ATOMICS=1 so the
    portable path stays testable on this (x86) CI."""
    if os.environ.get("STARWAY_SM_FORCE_ATOMICS") == "1":
        return True
    import platform

    return platform.machine() not in ("x86_64", "AMD64")


def default_ring_size() -> int:
    raw = os.environ.get("STARWAY_SM_RING", "")
    if not raw:
        return DEFAULT_RING
    try:
        v = int(raw)
    except ValueError:
        return DEFAULT_RING
    # round up to a power of two within sane bounds
    v = max(4096, min(v, MAX_RING))
    return 1 << (v - 1).bit_length()


class SmCorrupt(OSError):
    """A §19 slot record failed verification at dequeue: torn write,
    bit-flip, or stale slot content.  The conn poisons ("corrupt")."""


class Ring:
    """One direction of the segment, viewed as a byte stream.

    Exactly one process calls :meth:`write` (the producer) and exactly one
    calls :meth:`read_into` (the consumer); both may inspect cursors.
    ``slotted`` (set via :meth:`ShmSegment.enable_integrity` once both
    peers negotiated ``csum``) switches both methods to the checksummed
    slot-record framing documented in the module docstring.
    """

    __slots__ = ("_u64", "_data", "size", "_hdr_idx", "_at", "_tail_addr",
                 "_head_addr", "slotted", "_tx_seq", "_rx_seq", "_rec_left",
                 "_rec_crc", "_rec_accum")

    def __init__(self, seg_mv: memoryview, hdr_off: int, data_off: int, size: int):
        self.slotted = False
        self._tx_seq = 0      # producer slot counter
        self._rx_seq = 0      # consumer slot counter
        self._rec_left = 0    # payload bytes left in the record being read
        self._rec_crc = 0
        self._rec_accum = 0
        # One u64 view over the whole segment: index = byte offset / 8.
        self._u64 = seg_mv.cast("B").cast("Q")
        self._data = seg_mv[data_off : data_off + size]
        self.size = size
        self._hdr_idx = hdr_off // 8
        self._at = None
        self._tail_addr = self._head_addr = 0
        if _use_portable_atomics():
            from . import native

            self._at = native.atomics()
            if self._at is None:
                # config.sm_enabled() refuses sm before it gets here; this
                # guards direct Ring constructions (tests, future callers).
                raise RuntimeError(
                    "sm on a non-TSO host needs the native lib's cursor "
                    "atomics (core/native.py:atomics)")
            # Address only -- the from_buffer export is dropped immediately
            # so it cannot pin the segment against close; the mapping (and
            # thus the address) outlives this Ring by construction.
            anchor = ctypes.c_char.from_buffer(seg_mv)
            base = ctypes.addressof(anchor)
            del anchor
            self._tail_addr = base + hdr_off + OFF_TAIL
            self._head_addr = base + hdr_off + OFF_HEAD

    # cursor accessors: on x86/CPython these are single aligned 8-byte mmap
    # ops (atomic + store-ordered under TSO); elsewhere they route through
    # the native acquire/release atomics (one memory-ordering contract with
    # the C++ engine's SmRing on the same segment).
    @property
    def tail(self) -> int:
        if self._at is not None:
            return self._at[0](self._tail_addr)
        return self._u64[self._hdr_idx + OFF_TAIL // 8]

    @tail.setter
    def tail(self, v: int) -> None:
        if self._at is not None:
            self._at[1](self._tail_addr, v)
            return
        self._u64[self._hdr_idx + OFF_TAIL // 8] = v

    @property
    def head(self) -> int:
        if self._at is not None:
            return self._at[0](self._head_addr)
        return self._u64[self._hdr_idx + OFF_HEAD // 8]

    @head.setter
    def head(self, v: int) -> None:
        if self._at is not None:
            self._at[1](self._head_addr, v)
            return
        self._u64[self._hdr_idx + OFF_HEAD // 8] = v

    def readable(self) -> int:
        return self.tail - self.head

    def free(self) -> int:
        return self.size - (self.tail - self.head)

    # ------------------------------------------------------------------ I/O
    def _put(self, cursor: int, src) -> None:
        """Copy ``src`` into the data area at ``cursor`` (wrapping); the
        caller publishes the tail afterwards."""
        n = len(src)
        idx = cursor & (self.size - 1)
        first = min(n, self.size - idx)
        self._data[idx : idx + first] = src[:first]
        if n > first:
            self._data[: n - first] = src[first:n]

    def _take(self, cursor: int, dst) -> None:
        """Copy ``len(dst)`` bytes out of the data area at ``cursor``
        (wrapping); the caller advances the head afterwards."""
        n = len(dst)
        idx = cursor & (self.size - 1)
        first = min(n, self.size - idx)
        dst[:first] = self._data[idx : idx + first]
        if n > first:
            dst[first:n] = self._data[: n - first]

    def write(self, src: memoryview) -> int:
        """Producer: append up to ``len(src)`` bytes; returns bytes written
        (0 when full).  Data is copied before the tail store publishes it.
        Slotted mode frames the accepted bytes as ONE checksummed record
        (header + payload, single tail publication: whole-record
        visibility)."""
        tail = self.tail
        free = self.size - (tail - self.head)
        if not self.slotted:
            n = min(len(src), free)
            if n <= 0:
                return 0
            self._put(tail, src[:n])
            self.tail = tail + n
            return n
        if free <= REC_HDR:
            return 0
        n = min(len(src), free - REC_HDR)
        if n <= 0:
            return 0
        body = src[:n]
        crc = frames.crc32c(body, frames.crc32c(_SEQ8.pack(self._tx_seq)))
        self._tx_seq += 1
        self._put(tail, _REC.pack(n, crc))
        self._put(tail + REC_HDR, body)
        self.tail = tail + REC_HDR + n
        return n

    def read_into(self, dst: memoryview) -> int:
        """Consumer: read up to ``len(dst)`` bytes; returns bytes read.
        Slotted mode walks the record framing, folds the payload CRC as
        bytes leave the ring, and raises :class:`SmCorrupt` at a record
        boundary whose checksum (over seqno + payload) does not verify --
        detection happens AT DEQUEUE, before the bytes can be parsed."""
        if not self.slotted:
            head = self.head
            n = min(len(dst), self.tail - head)
            if n <= 0:
                return 0
            self._take(head, dst[:n])
            self.head = head + n
            return n
        total = 0
        while total < len(dst):
            head = self.head
            avail = self.tail - head
            if self._rec_left == 0:
                if avail < REC_HDR:
                    break  # producers publish whole records: ring idle
                hdr = bytearray(REC_HDR)
                self._take(head, hdr)
                ln, crc = _REC.unpack(hdr)
                if ln == 0 or ln > self.size:
                    raise SmCorrupt("sm slot record header corrupt "
                                    f"(len={ln})")
                self.head = head + REC_HDR
                self._rec_left = ln
                self._rec_crc = crc
                self._rec_accum = frames.crc32c(_SEQ8.pack(self._rx_seq))
                self._rx_seq += 1
                continue
            n = min(len(dst) - total, self._rec_left, avail)
            if n <= 0:
                break
            out = dst[total : total + n]
            self._take(head, out)
            self._rec_accum = frames.crc32c(out, self._rec_accum)
            self.head = head + n
            self._rec_left -= n
            total += n
            if self._rec_left == 0 and self._rec_accum != self._rec_crc:
                raise SmCorrupt("sm slot record checksum mismatch "
                                f"(slot {self._rx_seq - 1})")
        return total

    def release(self) -> None:
        # Null the atomics path too: a post-close cursor access must raise
        # (like the mmap path's released-memoryview ValueError), not call
        # sw_atomic_load_u64 on an unmapped page and segfault the process.
        self._at = None
        self._tail_addr = self._head_addr = 0
        self._data.release()
        self._u64.release()


def decode_sm_records(data, ring_size: int = DEFAULT_RING) -> str:
    """Reference decoder for the §19 slot-record framing: the exact
    accept/reject/short outcome of :meth:`Ring.read_into`'s slotted walk
    (and the C++ engine's ``SmRing::read_into``) over a flat byte region,
    as one canonical string (frames.fmt_decode).  The slot seqno is the
    implicit free-running counter starting at 0, so a record lifted from
    a stale/replayed region of ring memory fails its checksum here
    exactly as it does at live dequeue.  Fed identical adversarial
    buffers by the `wirefuzz` analysis pass (mode ``smrec``) on both
    engines -- divergence is a contract finding (DESIGN.md §21)."""
    buf = bytes(data)  # swcheck: allow(hotpath-copy): bounded fuzz/gate input, never a data path
    n = len(buf)
    pos = 0
    consumed = 0
    seq = 0
    entries: list = []
    while True:
        if n - pos == 0:
            return frames.fmt_decode("ok", consumed, entries)
        if n - pos < REC_HDR:
            return frames.fmt_decode("short:rec-header", consumed, entries)
        ln, crc = _REC.unpack(buf[pos:pos + REC_HDR])
        if ln == 0 or ln > ring_size:
            # Garbled record header: SmCorrupt / -1 at live dequeue.
            return frames.fmt_decode("reject(sm record header)",
                                     consumed, entries)
        if pos + REC_HDR + ln > n:
            return frames.fmt_decode("short:rec-body", consumed, entries)
        accum = frames.crc32c(buf[pos + REC_HDR:pos + REC_HDR + ln],
                              frames.crc32c(_SEQ8.pack(seq)))
        if accum != crc:
            return frames.fmt_decode("reject(sm record checksum)",
                                     consumed, entries)
        seq += 1
        pos += REC_HDR + ln
        consumed = pos
        entries.append(f"r:{ln}")


class ShmSegment:
    """A mapped segment holding both rings of one connection.

    The connector *creates* (and offers the name in HELLO); the acceptor
    *attaches* and validates magic+nonce, then the name is unlinked by
    whichever side gets there first -- after both are mapped the name is
    dead weight and the pages live until the last mapping goes away.
    """

    __slots__ = ("key", "nonce", "ring_size", "_mm", "_mv", "rings", "creator")

    def __init__(self, key: str, nonce: int, ring_size: int, mm: mmap.mmap, creator: bool):
        self.key = key
        self.nonce = nonce
        self.ring_size = ring_size
        self._mm = mm
        self._mv = memoryview(mm)
        self.rings = (
            Ring(self._mv, GLOBAL_HDR, DATA_OFF, ring_size),
            Ring(self._mv, GLOBAL_HDR + RING_HDR, DATA_OFF + ring_size, ring_size),
        )
        self.creator = creator

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, key_hint: str, ring_size: int | None = None) -> "ShmSegment":
        size = ring_size or default_ring_size()
        if size & (size - 1):
            raise ValueError("ring size must be a power of two")
        # Mirror the attach-side validation: the hint feeds a /dev/shm path,
        # so strip anything that could escape the directory ('/', '..').
        key_hint = "".join(ch for ch in key_hint if ch.isalnum() or ch in "_-")
        key = f"sw-{key_hint}-{secrets.token_hex(4)}"
        path = os.path.join(SHM_DIR, key)
        total = DATA_OFF + 2 * size
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, total)
            mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        nonce = secrets.randbits(64)
        _HDR.pack_into(mm, 0, MAGIC, nonce, size)
        return cls(key, nonce, size, mm, creator=True)

    @classmethod
    def attach(cls, key: str, nonce: int, ring_size: int) -> "ShmSegment":
        """Map an offered segment; raises on any mismatch (caller falls back
        to TCP)."""
        if "/" in key or not key.startswith("sw-"):
            raise ValueError(f"bad sm key {key!r}")
        if ring_size & (ring_size - 1) or not 4096 <= ring_size <= MAX_RING:
            raise ValueError(f"bad sm ring size {ring_size}")
        path = os.path.join(SHM_DIR, key)
        total = DATA_OFF + 2 * ring_size
        fd = os.open(path, os.O_RDWR)
        try:
            st = os.fstat(fd)
            # /dev/shm is world-writable: only map segments our own uid
            # created, or a hostile local process could offer a file it can
            # truncate under us later (SIGBUS on the next ring access).
            if st.st_uid != os.geteuid():
                raise ValueError("sm segment owned by another uid")
            if st.st_size != total:
                raise ValueError("sm segment size mismatch")
            mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        magic, got_nonce, got_size = _HDR.unpack_from(mm, 0)
        if magic != MAGIC or got_nonce != nonce or got_size != ring_size:
            mm.close()
            raise ValueError("sm segment header mismatch")
        return cls(key, nonce, ring_size, mm, creator=False)

    def enable_integrity(self) -> None:
        """Switch both rings to §19 checksummed slot records.  Decided by
        the csum handshake and called before any ring byte flows -- both
        sides must agree or the framings cannot interoperate."""
        for r in self.rings:
            r.slotted = True

    def unlink(self) -> None:
        try:
            os.unlink(os.path.join(SHM_DIR, self.key))
        except OSError:
            pass

    def close(self) -> None:
        for r in self.rings:
            try:
                r.release()
            except Exception:
                pass
        try:
            self._mv.release()
        except Exception:
            pass
        try:
            self._mm.close()
        except Exception:
            pass

    # ------------------------------------------------------- role selection
    def tx_rx(self, creator: bool) -> tuple[Ring, Ring]:
        """(producer ring, consumer ring) for this side.  Ring 0 carries
        connector->acceptor traffic."""
        return (self.rings[0], self.rings[1]) if creator else (self.rings[1], self.rings[0])
