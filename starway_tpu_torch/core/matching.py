"""Host-side tag-matching engine.

The reference delegates tag matching to UCX: receives are posted on the
*worker* (any endpoint, fan-in) with a 64-bit tag + mask and matched against
incoming messages by the transport (``ucp_tag_recv_nbx`` with wildcard masks,
reference: src/bindings/main.cpp:404,1172; fan-in behaviour pinned by
tests/test_basic.py:526-554).  TPU interconnects have no tag matching, so the
matcher is a first-class component of the host runtime (SURVEY.md section 7,
"Hard parts").

Matching rule (UCX semantics): a posted receive ``(rtag, rmask)`` matches an
incoming message with tag ``stag`` iff ``(stag & rmask) == (rtag & rmask)``.
``rmask == 0`` is the wildcard used throughout the reference tests
(tests/test_basic.py:547).  Both posted receives and unexpected messages are
kept in FIFO order, matching UCX's ordering guarantees.

Receive targets and payloads are duck-typed so device (jax.Array) transfers
ride the same matcher with no jax dependency here:

* host target: writable ``memoryview``; host payload: ``memoryview``;
* device target: ``DeviceRecvSink`` (``nbytes`` / ``host_staging()`` /
  ``finalize_from_host()`` / ``accept_device()`` / optional
  ``accept_host()`` for complete-bytes-in-hand delivery, see device.py);
* device payload: ``DevicePayload`` (``nbytes`` / ``as_host_view()`` /
  ``.array``).

Threading: the matcher is owned by a Worker and guarded by the worker's lock.
All mutating methods return a list of zero-argument "fire" thunks (completed /
failed user callbacks); the caller must invoke them *after* releasing the
worker lock so user callbacks can re-enter the API without deadlocking.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

from ..errors import REASON_CANCELLED, REASON_TIMEOUT, REASON_TRUNCATED
from . import swtrace

DoneCb = Callable[[int, int], None]  # (sender_tag, length)
FailCb = Callable[[str], None]

# Reserved probe tag ("SW_PROBE"): messages sent with this exact tag are
# consumed and dropped by the matcher on arrival -- they never enter the
# unexpected queue and never match a receive, wildcard or not.  This is
# what perf.autocalibrate sends, so live link probing cannot pollute the
# peer's matching state.  The contract is shared with the native engine
# (native/sw_engine.cpp).
PROBE_TAG = 0x53575F50524F4245


def tags_match(stag: int, rtag: int, rmask: int) -> bool:
    return (stag & rmask) == (rtag & rmask)


def _size(target_or_payload) -> int:
    if isinstance(target_or_payload, memoryview):
        return len(target_or_payload)
    return int(target_or_payload.nbytes)


def _is_host(x) -> bool:
    return isinstance(x, memoryview)


class PostedRecv:
    """A receive posted by the application, waiting for a matching message.

    ``buf`` is a writable host memoryview or a DeviceRecvSink.
    """

    # __weakref__: deadline timers (core/engine.py) hold posted receives
    # weakly, so a settled receive's buffer is not pinned until its timer
    # would have fired.
    __slots__ = ("buf", "tag", "mask", "done", "fail", "claimed", "owner",
                 "t_post", "__weakref__")

    def __init__(self, buf, tag: int, mask: int, done: DoneCb, fail: FailCb, owner=None):
        self.buf = buf
        self.tag = tag
        self.mask = mask
        self.done = done
        self.fail = fail
        self.claimed = False  # an in-flight inbound message is streaming to us
        self.owner = owner  # keepalive for the python object owning buf
        self.t_post = time.perf_counter()  # swpulse recv_wait_us origin (§25)

    @property
    def size(self) -> int:
        return _size(self.buf)


class InboundMsg:
    """An inbound message whose header has arrived.

    ``sink`` is the memoryview payload bytes are streamed into: the posted
    receive buffer (or its device staging buffer) when a match existed at
    header time -- zero intermediate copy for host receives -- otherwise a
    spill ``bytearray`` (the analogue of UCX's unexpected queue).  Complete
    in-process device messages skip sinks entirely: the array reference is
    held in ``device_payload``.
    """

    __slots__ = ("tag", "length", "sink", "received", "posted", "complete",
                 "discard", "spill", "device_payload", "remote", "progress",
                 "fc_owner", "fc_gen", "fc_bytes", "born")

    def __init__(self, tag: int, length: int):
        self.tag = tag
        self.length = length
        self.born = time.perf_counter()  # swpulse stall-unexp age origin (§25)
        self.sink: Optional[memoryview] = None
        self.received = 0
        self.posted: Optional[PostedRecv] = None
        self.complete = False
        self.discard = False
        self.spill: Optional[bytearray] = None
        self.device_payload = None
        # Flow-control debt (DESIGN.md §18): a message spilled into the
        # unexpected queue on a TCP conn carries its origin conn +
        # incarnation generation + payload bytes, so the matcher can
        # return the window grant the moment the memory is released
        # (fc_release).  Zero/None on every other path.
        self.fc_owner = None
        self.fc_gen = 0
        self.fc_bytes = 0
        # Remote-pull handle (device.py RemoteMsg): the payload lives on the
        # sender's transfer server until pulled.  Duck-typed: the matcher
        # only ever calls ``remote.start(msg)`` via fire thunks.
        self.remote = None
        # Optional RX progress hook (device sinks streaming directly into
        # their staging buffer): the conn calls ``progress(received)`` after
        # each read so placement can overlap the remaining stream
        # (device.py DeviceRecvSink.staged).  Duck-typed; None for host
        # targets and spill buffers.
        self.progress = None


def _copy_complete(pr: PostedRecv, payload, length: int) -> None:
    """Move a fully-arrived payload into a posted receive target."""
    if _is_host(pr.buf):
        if _is_host(payload):
            pr.buf[:length] = payload
        else:  # device payload -> host buffer
            pr.buf[:length] = payload.as_host_view()
    else:
        if _is_host(payload):
            direct = getattr(pr.buf, "accept_host", None)
            if direct is not None:
                # Complete bytes in hand: the sink places them directly,
                # skipping the staging bounce where the target platform
                # allows (see DeviceRecvSink.accept_host).  Streamed
                # arrivals still use host_staging.
                direct(payload, length)
            else:
                staging = pr.buf.host_staging()
                staging[:length] = payload
                pr.buf.finalize_from_host(length)
        else:  # device -> device: direct HBM handoff / ICI copy
            pr.buf.accept_device(payload.array)


class TagMatcher:
    """Worker-level matcher: FIFO posted-receive list + FIFO unexpected queue."""

    def __init__(self) -> None:
        self.posted: deque[PostedRecv] = deque()
        self.unexpected: deque[InboundMsg] = deque()
        # Messages whose payload is still streaming in (for close-time cancel).
        self.inflight: set[InboundMsg] = set()
        # swtrace observability (DESIGN.md §13): the owning Worker swaps in
        # its own Counters (and, when tracing is on, its TraceRing) so
        # match/completion accounting lands per worker.  Ring appends are
        # GIL-atomic data writes -- unlike user callbacks, they are safe
        # under the worker lock the matcher runs beneath.
        self.counters = swtrace.Counters()
        self.hists = swtrace.Hists()  # swapped for the Worker's (§25)
        self.trace = None
        # Flow control (DESIGN.md §18): total payload bytes currently
        # held by unexpected spill buffers (the STARWAY_UNEXP_BYTES cap
        # surface), and the worker-installed grant hook -- called UNDER
        # the worker lock (it only enqueues an engine op, never runs
        # user code or touches conn I/O).
        self.unexp_bytes = 0
        self.fc_grant = None  # fn(conn, gen, nbytes) | None

    # ------------------------------------------------------- flow control
    def fc_track(self, msg: "InboundMsg", conn, gen: int, nbytes: int) -> None:
        """Charge a spilled unexpected message against its origin conn's
        window accounting.  Caller holds the worker lock."""
        msg.fc_owner = conn
        msg.fc_gen = gen
        msg.fc_bytes = nbytes
        self.unexp_bytes += nbytes

    def fc_release(self, msg: "InboundMsg") -> None:
        """The spilled message's bytes left the unexpected queue (matched,
        truncated-dropped, purged): return the grant.  Idempotent; caller
        holds the worker lock."""
        n = msg.fc_bytes
        if not n:
            return
        msg.fc_bytes = 0
        self.unexp_bytes -= n
        if self.unexp_bytes < 0:
            self.unexp_bytes = 0
        owner, msg.fc_owner = msg.fc_owner, None
        if self.fc_grant is not None and owner is not None:
            self.fc_grant(owner, msg.fc_gen, n)

    def _rec_match(self, tag: int, length: int) -> None:
        tr = self.trace
        if tr is not None:
            tr.rec(swtrace.EV_RECV_MATCH, tag, 0, length)

    def _pulse_wait(self, pr: PostedRecv) -> None:
        # swpulse (§25): post -> delivery latency of a completed receive.
        us = int((time.perf_counter() - pr.t_post) * 1e6)
        self.hists.recv_wait_us[swtrace.hist_bucket(us)] += 1

    # ------------------------------------------------------------------ post
    def post_recv(self, buf, tag: int, mask: int, done: DoneCb, fail: FailCb, owner=None) -> list:
        """Post a receive.  Returns fire thunks (may complete immediately
        against a fully-arrived unexpected message)."""
        return self.post_recv_pr(PostedRecv(buf, tag, mask, done, fail, owner))

    def post_recv_pr(self, pr: PostedRecv) -> list:
        """:meth:`post_recv` with a caller-built record, so the caller can
        keep the handle (the deadline timer in core/engine.py cancels
        through it via :meth:`expire_recv`)."""
        buf, tag, mask, done, fail = pr.buf, pr.tag, pr.mask, pr.done, pr.fail
        fires: list = []
        size = _size(buf)
        for msg in self.unexpected:
            if msg.posted is None and not msg.discard and tags_match(msg.tag, tag, mask):
                if msg.length > size:
                    self.unexpected.remove(msg)
                    self.fc_release(msg)
                    fires.append(lambda fail=fail: fail(REASON_TRUNCATED))
                    if msg.remote is not None and not msg.complete:
                        # Unpulled remote payload: drain-pull it so the
                        # sender's buffer is released and flush barriers
                        # waiting on the descriptor can resolve.
                        msg.discard = True
                        fires.append(lambda m=msg: m.remote.start(m))
                    return fires
                if msg.remote is not None and not msg.complete:
                    # Unpulled remote payload: claim it and start the pull
                    # (outside the lock -- fires run after release).
                    pr.claimed = True
                    msg.posted = pr
                    self.unexpected.remove(msg)
                    self.inflight.add(msg)
                    self._rec_match(msg.tag, msg.length)
                    fires.append(lambda m=msg: m.remote.start(m))
                    return fires
                if msg.complete:
                    self.unexpected.remove(msg)
                    self.fc_release(msg)
                    if msg.device_payload is not None:
                        _copy_complete(pr, msg.device_payload, msg.length)
                    else:
                        _copy_complete(pr, memoryview(msg.spill)[: msg.length] if msg.spill is not None else memoryview(b""), msg.length)
                    stag, length = msg.tag, msg.length
                    self._rec_match(stag, length)
                    self.counters.recvs_completed += 1
                    self._pulse_wait(pr)
                    fires.append(lambda done=done, stag=stag, length=length: done(stag, length))
                    return fires
                # In flight: claim it; payload keeps streaming into the spill
                # buffer and is copied on completion.
                pr.claimed = True
                msg.posted = pr
                self._rec_match(msg.tag, msg.length)
                return fires
        self.posted.append(pr)
        return fires

    # -------------------------------------------------------- inbound (tcp)
    def on_message_start(self, tag: int, length: int) -> tuple[InboundMsg, list]:
        """Header of an inbound streamed message arrived.  Chooses the sink.

        Returns the message record plus fire thunks (a truncation failure
        fires immediately, like UCS_ERR_MESSAGE_TRUNCATED in the reference).
        """
        fires: list = []
        msg = InboundMsg(tag, length)
        if tag == PROBE_TAG:
            msg.discard = True  # bytes drain to scratch, nothing is queued
            return msg, fires
        self.inflight.add(msg)
        for pr in self.posted:
            if not pr.claimed and tags_match(tag, pr.tag, pr.mask):
                if length > pr.size:
                    # UCS_ERR_MESSAGE_TRUNCATED analogue: fail the receive now;
                    # the connection still consumes the payload (sink=None =>
                    # conn streams the bytes into its scratch discard buffer).
                    self.posted.remove(pr)
                    fires.append(lambda pr=pr: pr.fail(REASON_TRUNCATED))
                    msg.discard = True
                    return msg, fires
                pr.claimed = True
                msg.posted = pr
                self.posted.remove(pr)
                self._rec_match(tag, length)
                if _is_host(pr.buf):
                    msg.sink = pr.buf
                else:
                    msg.sink = pr.buf.host_staging()
                    msg.progress = getattr(pr.buf, "staged", None)
                return msg, fires
        msg.spill = bytearray(length)
        msg.sink = memoryview(msg.spill)
        self.unexpected.append(msg)
        return msg, fires

    def on_message_complete(self, msg: InboundMsg) -> list:
        """All payload bytes of ``msg`` have been ingested."""
        fires: list = []
        msg.complete = True
        self.inflight.discard(msg)
        if msg.discard:
            return fires
        pr = msg.posted
        if pr is not None:
            if msg.spill is not None:
                # Claimed mid-flight while spilling: move spill -> target.
                _copy_complete(pr, memoryview(msg.spill)[: msg.length], msg.length)
                try:
                    self.unexpected.remove(msg)
                except ValueError:
                    pass
                self.fc_release(msg)
            elif not _is_host(pr.buf):
                # Streamed straight into the device sink's staging buffer.
                pr.buf.finalize_from_host(msg.length)
            self.counters.recvs_completed += 1
            self._pulse_wait(pr)
            fires.append(lambda pr=pr, m=msg: pr.done(m.tag, m.length))
        # else: stays in the unexpected queue until a matching recv is posted.
        return fires

    # ------------------------------------------------------- remote (pull)
    def on_remote_message(self, tag: int, length: int, remote) -> tuple[InboundMsg, list]:
        """A DEVPULL descriptor arrived: the payload stays on the sender's
        transfer server until pulled.  Matches like :meth:`on_message_start`
        but starts a pull (via fire thunk) instead of choosing a sink."""
        fires: list = []
        msg = InboundMsg(tag, length)
        msg.remote = remote
        if tag == PROBE_TAG:
            msg.discard = True  # engine drain-pulls it, result dropped
            return msg, fires
        for pr in self.posted:
            if not pr.claimed and tags_match(tag, pr.tag, pr.mask):
                if length > pr.size:
                    self.posted.remove(pr)
                    fires.append(lambda pr=pr: pr.fail(REASON_TRUNCATED))
                    msg.discard = True
                    return msg, fires
                pr.claimed = True
                msg.posted = pr
                self.posted.remove(pr)
                self.inflight.add(msg)
                self._rec_match(tag, length)
                fires.append(lambda m=msg: m.remote.start(m))
                return msg, fires
        self.unexpected.append(msg)
        return msg, fires

    def on_remote_complete(self, msg: InboundMsg, payload, error: Optional[str]) -> list:
        """The pull for ``msg`` resolved.  ``payload`` is a device-payload
        duck type (``.array`` / ``.nbytes`` / ``as_host_view``) on success.

        On failure a claimed receive stays pending -- the peer-death
        contract (the sender's server died mid-delivery); an unclaimed
        message is dropped."""
        fires: list = []
        self.inflight.discard(msg)
        if msg.discard:
            return fires
        if error is not None:
            msg.discard = True
            if msg.posted is None:
                try:
                    self.unexpected.remove(msg)
                except ValueError:
                    pass
            else:
                # The sender's transfer server died mid-delivery: re-arm the
                # claimed receive so it stays matchable and, at close, gets
                # the standard cancel sweep (never silently orphaned).
                pr = msg.posted
                msg.posted = None
                pr.claimed = False
                self.posted.append(pr)
            return fires
        msg.complete = True
        pr = msg.posted
        if pr is not None:
            _copy_complete(pr, payload, msg.length)
            self.counters.recvs_completed += 1
            self._pulse_wait(pr)
            fires.append(lambda pr=pr, m=msg: pr.done(m.tag, m.length))
        else:
            # Force-started by a flush barrier before any receive matched:
            # hold the pulled array; a later post_recv takes the normal
            # complete-device-payload path.
            msg.device_payload = payload
        return fires

    # ------------------------------------------------------ inproc delivery
    def deliver(self, tag: int, payload) -> list:
        """Deliver a complete message in one step (in-process fast path).

        ``payload`` is a host memoryview (single copy into the posted buffer)
        or a DevicePayload (direct array handoff -- the path ICI device
        transfers ride, no host serialization).
        """
        fires: list = []
        length = _size(payload)
        if tag == PROBE_TAG:
            return fires  # probe traffic is dropped, never queued
        for pr in self.posted:
            if not pr.claimed and tags_match(tag, pr.tag, pr.mask):
                self.posted.remove(pr)
                if length > pr.size:
                    fires.append(lambda pr=pr: pr.fail(REASON_TRUNCATED))
                    return fires
                _copy_complete(pr, payload, length)
                self._rec_match(tag, length)
                self.counters.recvs_completed += 1
                self._pulse_wait(pr)
                fires.append(lambda pr=pr, t=tag, n=length: pr.done(t, n))
                return fires
        msg = InboundMsg(tag, length)
        if _is_host(payload):
            msg.spill = bytearray(payload)
        else:
            # Keep the array reference; no host copy unless a host receive
            # eventually claims it.
            msg.device_payload = payload
        msg.complete = True
        self.unexpected.append(msg)
        return fires

    # -------------------------------------------------------- conn death
    def purge_inflight(self, msg: InboundMsg) -> None:
        """The connection streaming ``msg`` died mid-payload.

        An unclaimed partial must not sit in the unexpected queue where a
        future post_recv would claim it and hang, and must not shadow a
        complete message with the same tag from a live peer.  A partial
        already claimed by a posted receive stays claimed: that receive
        never completes, matching the reference's peer-death semantics
        (tests/test_basic.py:250-277).
        """
        if msg.complete:
            return
        msg.discard = True
        self.inflight.discard(msg)
        self.fc_release(msg)
        if msg.posted is None:
            try:
                self.unexpected.remove(msg)
            except ValueError:
                pass

    # ----------------------------------------------------------- deadlines
    def expire_recv(self, pr: PostedRecv) -> list:
        """A deadline expired on a posted receive: withdraw it and fail it
        with the stable ``"timed out"`` reason.

        No-op (empty list) when the receive already completed or failed.
        A receive claimed mid-stream reuses the :meth:`purge_inflight`
        discipline: the partial message is discarded (remaining payload
        bytes drain to the connection's scratch buffer, never into the
        caller's buffer), it can never re-enter matching, and the caller's
        buffer is immediately safe to repost.
        """
        fires: list = []
        try:
            self.posted.remove(pr)
        except ValueError:
            # Not queued: completed already, or claimed by an in-flight
            # message (streamed or remote-pull) that is still arriving.
            for msg in list(self.inflight):
                if msg.posted is pr and not msg.complete:
                    msg.posted = None
                    msg.sink = None  # remaining bytes drain to conn scratch
                    msg.progress = None
                    self.purge_inflight(msg)
                    break
            else:
                return fires
        fires.append(lambda pr=pr: pr.fail(REASON_TIMEOUT))
        return fires

    # ----------------------------------------------------- liveness expiry
    def fail_pending(self, reason: str) -> list:
        """Fail every pending posted receive (queued or claimed mid-stream)
        with ``reason``, leaving complete unexpected messages intact so
        already-delivered data can still satisfy future receives.  The
        peer-liveness sweep (core/engine.py) runs this when the last alive
        connection expires -- the keepalive-enabled replacement for "peer
        death leaves posted recvs pending"."""
        fires: list = []
        while self.posted:
            pr = self.posted.popleft()
            fires.append(lambda pr=pr, reason=reason: pr.fail(reason))
        for msg in list(self.inflight):
            if msg.posted is not None and not msg.complete:
                pr = msg.posted
                msg.posted = None
                msg.sink = None
                msg.progress = None
                self.purge_inflight(msg)
                fires.append(lambda pr=pr, reason=reason: pr.fail(reason))
        return fires

    # --------------------------------------------------------------- close
    def cancel_all(self) -> list:
        """Fail every pending posted receive with the cancel reason.

        Mirrors the reference's close-time ``ucp_request_cancel`` sweep
        (src/bindings/main.cpp:483-507); the reason string must contain
        "cancel" (tests/test_basic.py:638-663).
        """
        fires: list = []
        while self.posted:
            pr = self.posted.popleft()
            self.counters.ops_cancelled += 1
            fires.append(lambda pr=pr: pr.fail(REASON_CANCELLED))
        # In-flight claimed messages (streaming directly into a posted buffer
        # or claimed while spilling): their PostedRecv is no longer in
        # self.posted; fail them too.
        for msg in list(self.inflight):
            if msg.posted is not None and not msg.complete:
                pr = msg.posted
                msg.posted = None
                msg.discard = True
                self.counters.ops_cancelled += 1
                fires.append(lambda pr=pr: pr.fail(REASON_CANCELLED))
        self.inflight.clear()
        self.unexpected.clear()
        self.unexp_bytes = 0  # close wipes the queue; grants are moot
        return fires
