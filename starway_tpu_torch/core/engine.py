"""Worker engines: the progress/completion runtime behind Client and Server.

The reference dedicates one 100%-CPU busy-poll thread per Client/Server
(``start_working``, reference: src/bindings/main.cpp:361-468, 1126-1268) and
hands ops over capacity-1 spin channels (src/bindings/chan.hpp:84-119).  On a
TPU host the CPU belongs to XLA dispatch, so this build replaces that design
with one *event-driven* engine thread per worker: a ``selectors`` loop woken
by a socketpair when the application submits an op -- zero CPU when idle, same
ownership model (the engine thread is the only thread that touches sockets).

Submission is an unbounded FIFO deque rather than a capacity-1 rendezvous
slot; ordering guarantees are identical (ops of one worker execute in
submission order) and the application never blocks on submission.

Completion flows the same way as the reference: transport event -> engine
thread -> user callback (which typically trampolines into asyncio via
``loop.call_soon_threadsafe``; reference: src/starway/__init__.py:124-128).
All user callbacks are invoked outside the worker lock.
"""

from __future__ import annotations

import heapq
import itertools
import json
import logging
import random
import selectors
import socket
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Callable, Optional

from .. import config, perf
from ..errors import (
    REASON_CANCELLED,
    REASON_NOT_CONNECTED,
    REASON_SESSION_EXPIRED,
    REASON_TIMEOUT,
    StarwayStateError,
)
from . import fabric, frames, state, swtrace, telemetry
from .conn import InprocConn, TcpConn
from .lane import StripeSource
from .session import SessionState
from .endpoint import ServerEndpoint
from .matching import PostedRecv, TagMatcher

logger = logging.getLogger("starway_tpu_torch")


def _run_fires(fires) -> None:
    for f in fires:
        if f is None:
            continue
        try:
            f()
        except Exception:
            logger.exception("starway: user callback raised")


class FlushRec:
    """One outstanding flush barrier (worker- or endpoint-scoped).

    Completes when every targeted connection has acknowledged the flush
    sequence issued to it -- the analogue of ``ucp_worker_flush_nbx`` /
    ``ucp_ep_flush_nbx`` completion (reference: src/bindings/main.cpp:432,1202).
    """

    __slots__ = ("done", "fail", "waits", "stripe_waits", "completed", "born")

    def __init__(self, done, fail):
        self.done = done
        self.fail = fail
        # swpulse (§25): barrier birth stamp for the flush_us distribution
        # and the stall sentinel's outlived-threshold check.
        self.born = time.perf_counter()
        self.waits: dict = {}  # conn -> seq
        # Striped delivery rides SACKs, not per-rail FLUSH frames (rails
        # carry only chunk traffic): the barrier additionally waits until
        # every striped source submitted before it (msg_id <= watermark)
        # is SACKed (DESIGN.md §17).
        self.stripe_waits: dict = {}  # primary conn -> msg_id watermark
        self.completed = False


class Worker:
    kind = "worker"
    # The TX pump understands chunked payload duck types (TxData in
    # core/conn.py): device.py routes incremental device-to-host staging
    # through this engine only.  The native engine stages via a flat host
    # view instead (its ABI takes a raw pointer + length).
    supports_chunked_tx = True

    def __init__(self, name: str = ""):
        self.lock = threading.RLock()
        self.status = state.VOID
        self.worker_id = uuid.uuid4().hex
        self.name = name or self.worker_id[:8]
        self.matcher = TagMatcher()
        # swtrace observability (DESIGN.md §13): the counter registry is
        # always live (plain int increments); the trace ring and the
        # per-op callback wraps exist only when STARWAY_TRACE /
        # STARWAY_FLIGHT_DIR armed them -- the off path is one `is None`
        # check per op.
        self.counters = swtrace.Counters()
        # swpulse distributions (DESIGN.md §25): always live, like the
        # counters -- one clock read + one array increment per bump.
        self.hists = swtrace.Hists()
        # swpulse stall sentinel (§25): condition keys already alerted on,
        # so a wedge raises ONE alert until it clears (telemetry thread
        # calls stall_scan; empty and untouched unless STARWAY_STALL_MS).
        self._stall_seen: set = set()
        self._trace = swtrace.worker_ring()
        self._faulted = False
        self.matcher.counters = self.counters
        self.matcher.hists = self.hists
        self.matcher.trace = self._trace
        # §18 flow control: the matcher's grant hook runs under the
        # worker lock and only enqueues an engine op (conn TX is
        # engine-thread territory).
        self.matcher.fc_grant = self._fc_enqueue_grant
        self.stage_scope = perf.StageScope(ring=self._trace)
        swtrace.register_worker(self)
        telemetry.register_worker(self)
        self.ops: deque = deque()
        # Ops queued or currently executing on the engine thread.  When zero,
        # in-process sends/flushes may run inline on the caller thread (no
        # thread hop) without breaking FIFO ordering: submissions are
        # serialized by the caller, and nothing is concurrently draining.
        self._busy = 0
        self.conns: dict = {}  # conn_id -> conn
        self.flush_records: list[FlushRec] = []
        self.close_cb: Optional[Callable[[], None]] = None
        self.selector: Optional[selectors.BaseSelector] = None
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self.thread: Optional[threading.Thread] = None
        self._listener: Optional[socket.socket] = None
        # Deadline timers: heap of (monotonic deadline, seq, fn(fires)).
        # Armed from app threads under the lock; fired on the engine thread
        # (the selector timeout tracks the earliest entry).  Settled ops
        # leave their timer behind as a harmless no-op.
        self._timers: list = []
        self._timer_seq = itertools.count()
        # Peer-liveness keepalive (config.keepalive_interval); sampled at
        # engine start so one worker's lifetime sees one config.
        self._ka_interval = 0.0
        self._ka_misses = 3
        self.mode = "socket"
        self._address_blob: Optional[bytes] = None
        # PJRT transfer manager for cross-process device payloads
        # (device.py TransferManager); created lazily, dropped at close so
        # unpulled sends die with the worker (close-cancel contract).
        self._xfer_mgr = None

    # ------------------------------------------------------------ app side
    def _require_running(self) -> None:
        if self.status != state.RUNNING:
            raise StarwayStateError(
                f"starway {self.kind} is not in a running state "
                f"(status={state.NAMES[self.status]})"
            )

    # --------------------------------------------------------- observability
    @property
    def trace_label(self) -> str:
        return f"{self.kind}-{self.name}"

    def trace_events(self) -> list:
        """Snapshot of this worker's swtrace ring ([] when tracing off)."""
        return self._trace.snapshot() if self._trace is not None else []

    def counters_snapshot(self) -> dict:
        """This worker's counter registry, with the process-global
        counters (staging pool, reconnects) overlaid -- the same shape the
        native engine surfaces through ``sw_counters``."""
        return swtrace.merge_global_counters(self.counters.snapshot())

    def hists_snapshot(self) -> dict:
        """The §25 swpulse distributions: ``{name: [HIST_BUCKETS counts]}``
        in the shared HIST_NAMES vocabulary -- the same shape the native
        engine surfaces through ``sw_hists``.  Percentiles are derived at
        read time (swtrace.hist_summary)."""
        return self.hists.snapshot()

    def stall_scan(self, threshold_s: float, progressed: bool = False) -> list:
        """swpulse stall sentinel (DESIGN.md §25): flag no-progress
        conditions older than ``threshold_s``.  Called from the telemetry
        thread when STARWAY_STALL_MS armed it (never on the seed path);
        ``progressed`` means the worker's counters moved since the last
        scan, which clears every suspicion -- the sentinel flags *wedges*,
        not slowness.  Each NEW condition bumps ``stall_alerts`` and lands
        an EV_STALL event in the trace ring; a condition alerts once until
        it clears.  Returns structured report dicts."""
        now = time.perf_counter()
        reports: list = []
        with self.lock:
            live: set = set()
            if not progressed and self.status == state.RUNNING:
                for rec in self.flush_records:
                    age = now - rec.born
                    if age <= threshold_s:
                        continue
                    key = (swtrace.STALL_REASONS[0], id(rec))
                    live.add(key)
                    if key not in self._stall_seen:
                        reports.append({
                            "reason": swtrace.STALL_REASONS[0], "conn": 0,
                            "age_ms": int(age * 1e3),
                            "detail": f"flush barrier pending "
                                      f"{len(self.flush_records)} record(s)",
                        })
                for c in self.conns.values():
                    sess = getattr(c, "sess", None)
                    if sess is not None and sess.suspended:
                        continue  # §14 resume owns progress; not a wedge
                    fw = getattr(c, "fc_waiting", None)
                    if fw:
                        t0 = getattr(fw[0], "t_park", 0.0)
                        age = now - t0 if t0 else 0.0
                        if age > threshold_s:
                            key = (swtrace.STALL_REASONS[1], c.conn_id)
                            live.add(key)
                            if key not in self._stall_seen:
                                reports.append({
                                    "reason": swtrace.STALL_REASONS[1],
                                    "conn": c.conn_id,
                                    "age_ms": int(age * 1e3),
                                    "detail": f"{len(fw)} parked send(s), "
                                              f"no credit arrival",
                                })
                    grp = getattr(c, "stripe", None)
                    if grp is not None:
                        pinned = [s for s in grp.by_id.values()
                                  if not s.sacked and not s.failed
                                  and now - s.t_post > threshold_s]
                        if pinned:
                            key = (swtrace.STALL_REASONS[2], c.conn_id)
                            live.add(key)
                            if key not in self._stall_seen:
                                age = now - min(s.t_post for s in pinned)
                                reports.append({
                                    "reason": swtrace.STALL_REASONS[2],
                                    "conn": c.conn_id,
                                    "age_ms": int(age * 1e3),
                                    "detail": f"{len(pinned)} un-SACKed "
                                              f"stripe pin(s)",
                                })
                un = self.matcher.unexpected
                if un and now - un[0].born > threshold_s:
                    key = (swtrace.STALL_REASONS[3], 0)
                    live.add(key)
                    if key not in self._stall_seen:
                        reports.append({
                            "reason": swtrace.STALL_REASONS[3], "conn": 0,
                            "age_ms": int((now - un[0].born) * 1e3),
                            "detail": f"{len(un)} unexpected message(s) "
                                      f"unclaimed",
                        })
            self._stall_seen = live
            if reports:
                self.counters.stall_alerts += len(reports)
                tr = self._trace
                if tr is not None:
                    for r in reports:
                        tr.rec(swtrace.EV_STALL, 0, r["conn"], r["age_ms"],
                               r["reason"])
        for r in reports:
            r["worker"] = self.trace_label
        return reports

    def gauges_snapshot(self) -> dict:
        """Instantaneous per-conn gauges (telemetry.GAUGE_NAMES) plus the
        worker-level ``posted_recvs`` and the process-global staging-pool
        occupancy -- the shape the native engine surfaces through the
        ``sw_gauges`` ABI call (DESIGN.md §15).  Only the conn list and
        the posted count are read under the worker lock; the per-conn
        values are then read lock-free (telemetry.conn_gauges tolerates
        torn reads -- a skewed sample, never a crash).  Every gauge
        drains to 0 on an idle, flushed worker."""
        with self.lock:
            conns = list(self.conns.values())
            posted = len(self.matcher.posted)
        snap = {
            "conns": {c.conn_id: telemetry.conn_gauges(c) for c in conns},
            "posted_recvs": posted,
            # §24: native-only lever; this engine has no submission ring.
            "uring_depth": 0,
        }
        return telemetry.merge_global_gauges(snap)

    def post_recv(self, buf, tag: int, mask: int, done, fail, owner=None,
                  timeout: Optional[float] = None) -> None:
        tr = self._trace
        if tr is not None:
            nbytes = int(buf.nbytes if hasattr(buf, "nbytes") else len(buf))
            done, fail = swtrace.wrap_op(self, tr, swtrace.EV_RECV_DONE,
                                         tag, 0, nbytes, done, fail)
        pr = PostedRecv(buf, tag, mask, done, fail, owner)
        with self.lock:
            self._require_running()
            # Counted/recorded only once the submit is accepted (the C++
            # engine bumps after its status check too -- one accounting);
            # RECV_POST lands before the matcher can record RECV_MATCH.
            self.counters.recvs_posted += 1
            if tr is not None:
                tr.rec(swtrace.EV_RECV_POST, tag, 0, nbytes)
            fires = self.matcher.post_recv_pr(pr)
        if timeout is not None:
            # The timer holds the receive WEAKLY: the matcher is the only
            # strong owner while it pends, so a settled receive (and its
            # buffer) is collectable immediately and the late timer no-ops.
            ref = weakref.ref(pr)
            self._add_timer(timeout, lambda fires, r=ref: self._expire_recv_ref(r, fires))
        _run_fires(fires)

    def submit_send(self, conn, view, tag: int, done, fail, owner=None,
                    timeout: Optional[float] = None) -> None:
        nbytes = int(view.nbytes if hasattr(view, "nbytes") else len(view))
        tr = self._trace
        if tr is not None:
            cid = conn.conn_id if conn is not None else 0
            done, fail = swtrace.wrap_op(self, tr, swtrace.EV_SEND_DONE,
                                         tag, cid, nbytes, done, fail)
        inline = False
        with self.lock:
            self._require_running()
            self.counters.sends_posted += 1  # accepted-submit accounting
            self.hists.msg_bytes[swtrace.hist_bucket(nbytes)] += 1  # §25
            if tr is not None:
                tr.rec(swtrace.EV_SEND_POST, tag, cid, nbytes)
            if self._busy == 0 and conn is not None and conn.kind == "inproc" and conn.alive:
                inline = True
            else:
                self._busy += 1
                self.ops.append(("send", conn, view, tag, done, fail, owner, timeout))
        if inline:
            # Synchronous delivery: the op settles before a deadline could
            # ever be armed, so `timeout` is moot here.
            fires: list = []
            conn.send_data(tag, view, done, fail, owner, fires)
            _run_fires(fires)
            return
        self._wake()

    def submit_flush(self, done, fail, conns=None,
                     timeout: Optional[float] = None) -> None:
        tr = self._trace
        if tr is not None:
            done, fail = swtrace.wrap_op(self, tr, swtrace.EV_FLUSH_DONE,
                                         0, 0, 0, done, fail)
        inline = False
        with self.lock:
            self._require_running()
            self.counters.flushes_posted += 1  # accepted-submit accounting
            if tr is not None:
                tr.rec(swtrace.EV_FLUSH_POST)
            targets = conns if conns is not None else list(self.conns.values())
            # Inline only when the engine owns no TCP state at all: flush
            # bookkeeping (flush_records) is engine-thread territory
            # otherwise (TCP acks mutate it concurrently).
            if self._busy == 0 and all(c.kind == "inproc" for c in self.conns.values()):
                inline = True
            else:
                self._busy += 1
                self.ops.append(("flush", done, fail, conns, timeout))
        if inline:
            # All in-process traffic already delivered synchronously in
            # submission order: the barrier is trivially met.
            fires = []
            self._start_flush(done, fail, targets, fires, timeout)
            _run_fires(fires)
            return
        self._wake()

    def submit_devpull(self, conn, desc: dict, tag: int, done, fail, owner) -> None:
        """Queue a DEVPULL descriptor send (device.py decided the payload
        rides the pull path).  Always via the engine thread: descriptor
        ordering in the stream is what the flush barrier builds on."""
        from . import frames as _frames

        nbytes = int(desc.get("n", 0))
        tr = self._trace
        if tr is not None:
            cid = conn.conn_id if conn is not None else 0
            done, fail = swtrace.wrap_op(self, tr, swtrace.EV_SEND_DONE,
                                         tag, cid, nbytes, done, fail)
        data = _frames.pack_devpull(tag, desc)
        with self.lock:
            self._require_running()
            self.counters.sends_posted += 1  # accepted-submit accounting
            self.hists.msg_bytes[swtrace.hist_bucket(nbytes)] += 1  # §25
            if tr is not None:
                tr.rec(swtrace.EV_SEND_POST, tag, cid, nbytes)
            self._busy += 1
            self.ops.append(("devpull", conn, data, done, fail, owner))
        self._wake()

    def transfer_manager(self):
        """The worker's TransferManager, created on first use (None when
        the pull is disabled)."""
        from .. import device as _device

        with self.lock:
            if self._xfer_mgr is None:
                if _device.cudaipc_identity() is None:
                    return None
                self._xfer_mgr = _device.TransferManager(config.advertised_host())
            return self._xfer_mgr

    # -------------------------------------------------------- flow control
    def _fc_enqueue_grant(self, conn, gen: int, nbytes: int) -> None:
        """Matcher fc_release hook: hop the window grant onto the engine
        thread.  Reentrant-safe (the worker lock is an RLock; the hook
        fires from matcher paths already holding it)."""
        with self.lock:
            if self.status != state.RUNNING:
                return
            self._busy += 1
            self.ops.append(("fc_grant", conn, gen, nbytes))
        self._wake()

    def _on_rts(self, conn, tag: int, info: dict, fires) -> None:
        """A §18 rendezvous announcement arrived (conn.fc_on_rts owns the
        mechanics).  Malformed fields parse as a drop, never a raise on
        the engine thread (the _sess_int discipline)."""
        if not conn.fc_ok:
            return  # never negotiated: drop (protocol-violating peer)
        msg_id = self._sess_int(info.get("m", 0))
        total = self._sess_int(info.get("n", 0))
        if msg_id == 0:
            return
        conn.fc_on_rts(tag, msg_id, total, fires)

    # ------------------------------------------------------ devpull inbound
    def _on_devpull(self, conn, tag: int, desc: dict, fires) -> None:
        from .. import device as _device

        mgr = self.transfer_manager()
        if mgr is None:
            # We never advertised the capability; a peer sending DEVPULL
            # anyway gets the message dropped (descriptor unpullable here).
            return
        # Peer-supplied size: the _sess_int discipline (missing/garbled
        # parses as 0, like the C++ engine's json_num_field) -- a
        # malformed descriptor must not raise on the engine thread.
        nbytes = self._sess_int(desc.get("n", 0))
        remote = _device.RemoteMsg(desc, conn, mgr)
        with self.lock:
            msg, f = self.matcher.on_remote_message(tag, nbytes, remote)
        fires.extend(f)
        conn.remote_received(msg)
        if msg.discard:
            # Truncation: the receive already failed, but the sender's
            # transfer server still holds the array.  Drain-pull it (result
            # dropped by on_remote_complete) so the sender's memory is
            # released; resolution also releases any flush barriers.
            fires.append(lambda m=msg: m.remote.start(m))

    def _on_pull_done(self, msg, payload, error) -> None:
        """Completion callback from the TransferManager thread.

        Conn I/O (deferred flush ACKs) is engine-thread territory, so hop
        onto the engine via the op queue; a worker already closing only
        needs the matcher bookkeeping."""
        with self.lock:
            if self.status == state.RUNNING:
                self._busy += 1
                self.ops.append(("pull_done", msg, payload, error))
                queued = True
            else:
                fires = self.matcher.on_remote_complete(msg, payload, error)
                queued = False
        if queued:
            self._wake()
        else:
            _run_fires(fires)

    def _force_start_pulls(self, conn, fires) -> None:
        """A FLUSH barrier arrived with descriptors still waiting for a
        matching receive: pull them now (into spill arrays) so the ACK can
        truthfully mean "payloads resident here".  The posted/started reads
        race against app-thread claims, but start() is idempotent under the
        worker lock, so a duplicate thunk is a cheap no-op."""
        with self.lock:
            pending = [m for m in conn._remote_msgs
                       if m.posted is None and not m.remote.started]
        for msg in pending:
            fires.append(lambda m=msg: m.remote.start(m))

    def close(self, cb) -> None:
        if self._faulted:
            # Post-mortem snapshot before teardown wipes the state the
            # fault left behind (DESIGN.md §13 flight recorder).
            swtrace.flight_dump("close-after-fault", self)
        with self.lock:
            self._require_running()
            self.status = state.CLOSING
            self.close_cb = cb
        self._wake()

    def force_close(self) -> None:
        """Destructor path: initiate close without a callback and without
        joining (engine threads are daemons).  Must never hang or raise --
        the reference pins this with del + gc.collect()
        (tests/test_basic.py:666-686)."""
        with self.lock:
            if self.status not in (state.INIT, state.RUNNING):
                return
            self.status = state.CLOSING
            self.close_cb = None
        try:
            self._wake()
        except OSError:
            pass

    def get_worker_address(self) -> bytes:
        if self._address_blob is None:
            self._address_blob = json.dumps(
                {
                    "worker_id": self.worker_id,
                    "host": config.advertised_host(),
                    "port": 0,
                    "fabric": "starway-tpu",
                }
            ).encode()
        return self._address_blob

    def _perf_transport(self, conn) -> str:
        with self.lock:
            self._require_running()
            if conn is None:
                return "tcp"
            if getattr(conn, "sm_negotiated", False):
                return "sm"
            return conn.kind

    def evaluate_perf(self, conn, msg_size: int) -> float:
        # Per-endpoint first (live-calibrated, perf.autocalibrate[_ep]),
        # transport-class model otherwise.
        return perf.conn_estimate(conn, self._perf_transport(conn), msg_size)

    def evaluate_perf_detail(self, conn, msg_size: int) -> dict:
        detail = perf.conn_estimate_detail(conn, self._perf_transport(conn),
                                           msg_size, scope=self.stage_scope)
        detail["counters"] = self.counters_snapshot()
        detail["telemetry"] = telemetry.detail_for(self)
        return detail

    # --------------------------------------------------------- engine side
    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass  # wake buffer full => engine already has a pending wake

    def _start_thread(self) -> None:
        self.thread = threading.Thread(
            target=self._run, name=f"starway-{self.kind}-{self.name}", daemon=True
        )
        self.thread.start()

    def _run(self) -> None:
        try:
            self.selector = selectors.DefaultSelector()
            self.selector.register(self._wake_r, selectors.EVENT_READ, self._on_wake)
            self._ka_interval = config.keepalive_interval()
            self._ka_misses = config.keepalive_misses()
            if not self._setup():
                self._teardown_sockets()
                return
            if self._ka_interval > 0:
                self._add_timer(self._ka_interval, self._ka_tick)
            while True:
                with self.lock:
                    if self.status == state.CLOSING:
                        break
                    timeout = None
                    if self._timers:
                        timeout = max(0.0, self._timers[0][0] - time.monotonic())
                try:
                    events = self.selector.select(timeout)
                except OSError:
                    break
                # One fires batch per wakeup: every completion this pass
                # produces (I/O events, due timers, drained ops) is
                # delivered in a single sweep after all engine work, so a
                # burst of N completions crosses into user code -- and
                # through the api layer's asyncio trampoline -- as one
                # batch, not N wakeups (mirrors the native engine's
                # per-epoll-pass FireList).
                fires: list = []
                try:
                    for key, mask in events:
                        key.data(mask, fires)
                    self._run_timers(fires)
                    self._drain_ops(fires)
                finally:
                    # Deliver even when a later handler in the sweep
                    # raises: completions already collected belong to ops
                    # the matcher/tx queues no longer track, so dropping
                    # them would hang their futures past emergency close.
                    _run_fires(fires)
                # Drop the delivered batch before the next select blocks:
                # its completions reach the receives' buffers, which would
                # otherwise stay alive until the next wakeup.
                fires = None
            self._do_close()
        except Exception:
            logger.exception("starway: engine thread crashed; emergency close")
            swtrace.flight_dump("engine-crash", self)
            try:
                self._do_close()
            except Exception:
                pass

    def _setup(self) -> bool:
        raise NotImplementedError

    def _on_wake(self, mask, fires) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _drain_ops(self, fires: list) -> None:
        # Sends queue their tx items with the kick deferred, and every
        # touched conn is kicked ONCE after the whole backlog is queued:
        # a burst of small sends then leaves in single gathered sendmsg
        # passes instead of one syscall per op (core/conn.py _gather_tx).
        pending_kicks: set = set()
        try:
            while True:
                with self.lock:
                    if not self.ops or self.status != state.RUNNING:
                        return
                    op = self.ops.popleft()
                try:
                    self._process_op(op, fires, pending_kicks)
                finally:
                    with self.lock:
                        self._busy -= 1
        finally:
            for conn in pending_kicks:
                if conn.alive:
                    conn.kick_tx(fires)

    # ------------------------------------------------------------ deadlines
    def _add_timer(self, delay: float, fn) -> None:
        """Arm ``fn(fires)`` to run on the engine thread after ``delay``
        seconds.  Callable from any thread."""
        with self.lock:
            heapq.heappush(
                self._timers, (time.monotonic() + delay, next(self._timer_seq), fn)
            )
        self._wake()

    def _run_timers(self, fires: list) -> None:
        while True:
            with self.lock:
                if not self._timers or self._timers[0][0] > time.monotonic():
                    return
                if self.status != state.RUNNING:
                    return
                _, _, fn = heapq.heappop(self._timers)
            try:
                fn(fires)
            except Exception:
                logger.exception("starway: deadline timer raised")

    def _expire_recv_ref(self, ref, fires) -> None:
        pr = ref()
        if pr is None:
            return  # settled and collected: nothing to expire
        with self.lock:
            expired = self.matcher.expire_recv(pr)
        if expired:
            self.counters.ops_timed_out += 1
        fires.extend(expired)

    def _expire_send_ref(self, conn, ref, fires) -> None:
        item = ref()
        if item is None:
            return  # settled and collected
        self._expire_send(conn, item, fires)

    def _expire_send(self, conn, item, fires) -> None:
        """A deadline expired on a queued send.  An untouched item is
        withdrawn cleanly; one already partially on the wire cannot be
        unsent without corrupting the frame stream, so the conn is torn
        down (the UCX endpoint-error analogue)."""
        if isinstance(item, StripeSource):
            self._expire_stripe(conn, item, fires)
            return
        started = False
        shed = False
        with self.lock:
            if item.local_done:
                return  # settled (completed locally, or cancelled)
            # A sequenced session frame was already promised to the peer
            # (withdrawing it would leave a seq hole the receiver must
            # treat as a gap): expire it like a started send.  An
            # RTS-announced rendezvous send is promised the same way --
            # the receiver holds a record a silent withdrawal would wedge.
            started = (item.off > 0 or getattr(item, "sess_seq", 0) != 0
                       or (getattr(conn, "fc_ok", False)
                           and conn.fc_rts_state(item) is not None))
            sess = getattr(conn, "sess", None)
            if started and sess is not None and not sess.expired:
                # Live session, sequenced frame: the send is PROMISED.
                # The journal delivers it -- now, or via a replay after a
                # suspend -- so failing it "timed out" would lie about an
                # op the peer still receives (an app-level retry would
                # then duplicate the message), and tearing down a healthy
                # conn would force a needless resume cycle.  The op
                # completes late; only grace/epoch expiry may fail it
                # (DESIGN.md §14).  Deadlines can still fail a session
                # send while it is parked UNFRAMED by backpressure (no
                # seq assigned yet -- the clean-withdraw path below).
                return
            if not started:
                try:
                    conn.tx.remove(item)
                except ValueError:
                    # Session or flow-control backpressure may have
                    # parked it unframed.
                    sess = getattr(conn, "sess", None)
                    if sess is not None and item in sess.waiting:
                        sess.waiting.remove(item)
                    elif item in getattr(conn, "fc_waiting", ()):
                        # Deadline-aware load shedding (DESIGN.md §18):
                        # the receiver is saturated and this send's
                        # deadline arrived first -- fail it locally, the
                        # conn stays healthy.
                        conn.fc_waiting.remove(item)
                        shed = True
                    else:
                        return  # drained between checks
            item.local_done = True  # suppress the close-time cancel path
        self.counters.ops_timed_out += 1
        if shed:
            self.counters.sheds += 1
        if item.fail is not None:
            fires.append(lambda f=item.fail: f(REASON_TIMEOUT))
        if started:
            self._conn_broken(conn, fires)

    def _expire_stripe(self, conn, src, fires) -> None:
        """Deadline on a striped send (core/lane.py): an unstarted source
        withdraws cleanly; a started one has chunks promised on the wire,
        so the whole rail group resets -- unless a live session owns it
        (the per-message journal delivers it late, like any sequenced
        frame)."""
        with self.lock:
            if src.sacked or src.failed or src.local_done:
                return
            sess = getattr(conn, "sess", None)
            if src.started() and sess is not None and not sess.expired:
                return  # promised: re-dispatch at resume completes it late
        grp = getattr(conn, "stripe", None)
        if grp is None:
            return
        self.counters.ops_timed_out += 1
        if grp.expire(src, fires, REASON_TIMEOUT):
            self._conn_broken(conn, fires)

    def _expire_flush(self, rec, fires) -> None:
        if rec.completed:
            return
        rec.completed = True
        if rec in self.flush_records:
            self.flush_records.remove(rec)
        self.counters.ops_timed_out += 1
        if rec.fail is not None:
            fires.append(lambda f=rec.fail: f(REASON_TIMEOUT))

    # ------------------------------------------------------------ keepalive
    def _ka_tick(self, fires) -> None:
        """Recurring liveness sweep: PING quiet ka-negotiated conns, expire
        those silent past the miss window."""
        interval = self._ka_interval
        window = interval * self._ka_misses
        now = time.monotonic()
        with self.lock:
            conns = list(self.conns.values())
        expired = []
        for c in conns:
            if c.kind != "tcp" or not c.alive or not getattr(c, "ka_ok", False):
                continue
            if getattr(c, "sess", None) is not None and c.sess.suspended:
                continue  # no transport to probe; the grace timer governs
            if now - c.last_rx > window:
                expired.append(c)
            elif now - c.last_rx >= interval:
                c.send_ping(fires)
        for c in expired:
            self._conn_expired(c, fires)
        with self.lock:
            running = self.status == state.RUNNING
        if running:
            self._add_timer(interval, self._ka_tick)

    def _conn_expired(self, conn, fires) -> None:
        """Liveness window elapsed: declare the peer dead.  _conn_broken
        (liveness-active branch) fails the receive the conn was streaming
        into and, once no alive conns remain, every queued receive -- the
        keepalive-enabled replacement for recvs-pend-forever.  On a server
        with other live peers, queued (fan-in) receives stay postable."""
        logger.warning(
            "starway: peer %s liveness expired (%.3gs silent > %d x %.3gs)",
            conn.peer_name or conn.conn_id,
            time.monotonic() - conn.last_rx, self._ka_misses, self._ka_interval,
        )
        self.counters.ka_misses += 1
        self._conn_broken(conn, fires)

    def _process_op(self, op, fires, pending_kicks=None) -> None:
        if op[0] == "send":
            _, conn, view, tag, done, fail, owner, timeout = op
            if conn is None or not conn.alive:
                if fail is not None:
                    fires.append(lambda f=fail: f(REASON_NOT_CONNECTED))
                return
            defer = pending_kicks is not None and conn.kind != "inproc"
            item = conn.send_data(tag, view, done, fail, owner, fires,
                                  kick=not defer)
            if defer:
                pending_kicks.add(conn)
            if timeout is not None and item is not None and not item.local_done:
                # Weak, like the recv timer: the tx queue is the only
                # strong owner, so a drained send's payload is not pinned
                # for the rest of the timeout.
                ref = weakref.ref(item)
                self._add_timer(
                    timeout,
                    lambda fires, c=conn, r=ref: self._expire_send_ref(c, r, fires),
                )
        elif op[0] == "devpull":
            _, conn, data, done, fail, owner = op
            if conn is None or not conn.alive:
                if fail is not None:
                    fires.append(lambda f=fail: f(REASON_NOT_CONNECTED))
                return
            if pending_kicks is not None and conn.kind != "inproc":
                conn.send_devpull(data, done, fail, owner, fires, kick=False)
                pending_kicks.add(conn)
            else:
                conn.send_devpull(data, done, fail, owner, fires)
        elif op[0] == "pull_done":
            _, msg, payload, error = op
            with self.lock:
                fires.extend(self.matcher.on_remote_complete(msg, payload, error))
            msg.remote.conn.remote_resolved(msg, fires)
        elif op[0] == "fc_grant":
            _, conn, gen, nbytes = op
            if gen == conn.fc_rx_gen:
                conn.fc_unexp = max(0, conn.fc_unexp - nbytes)
                if conn.alive and conn.fc_ok and conn.sock is not None:
                    conn.send_ctl(frames.pack_credit(nbytes), fires)
        elif op[0] == "fc_cts":
            _, conn, msg = op
            conn.fc_start_rx(msg, fires)
        elif op[0] == "flush":
            _, done, fail, conns, timeout = op
            self._start_flush(done, fail, conns, fires, timeout)

    # -------------------------------------------------------------- flush
    def _start_flush(self, done, fail, conns, fires,
                     timeout: Optional[float] = None) -> None:
        with self.lock:
            candidates = conns if conns is not None else list(self.conns.values())
        # Secondary rails are never flush targets: they carry only chunk
        # traffic, and striped delivery is covered by the SACK waits below.
        candidates = [c for c in candidates
                      if getattr(c, "rail_parent", None) is None]
        # A dead connection with unacknowledged tagged data means the barrier
        # cannot truthfully complete: fail like a send on a dead endpoint
        # would, instead of passing vacuously.  An expired session or a §19
        # poison owns the reason (the native start_flush reads sess_fail the
        # same way).
        dead_dirty = [c for c in candidates if (not c.alive) and c.dirty]
        if dead_dirty:
            reason = next(
                (c.sess_fail_reason for c in dead_dirty
                 if getattr(c, "sess_fail_reason", None)),
                REASON_NOT_CONNECTED + " (peer reset before flush)")
            if fail is not None:
                fires.append(lambda f=fail, r=reason: f(r))
            return
        targets = [c for c in candidates if c.alive]
        rec = FlushRec(done, fail)
        for c in targets:
            rec.waits[c] = c.alloc_flush_seq()
            grp = getattr(c, "stripe", None)
            if grp is not None and grp.has_unsacked(grp.next_msg_id - 1):
                rec.stripe_waits[c] = grp.next_msg_id - 1
        self.flush_records.append(rec)
        for c in targets:
            c.send_flush(rec.waits[c], fires)
        self._try_complete_flush(rec, fires)
        if timeout is not None and not rec.completed:
            self._add_timer(timeout, lambda fires, r=rec: self._expire_flush(r, fires))

    def _on_flush_ack(self, conn, seq: int, fires) -> None:
        conn.flush_acked = max(conn.flush_acked, seq)
        if hasattr(conn, "on_flush_acked"):
            conn.on_flush_acked(seq)
        for rec in list(self.flush_records):
            self._try_complete_flush(rec, fires)

    def _on_stripe_sack(self, conn, fires) -> None:
        """A striped source was SACKed: barriers waiting on it may now
        complete (core/lane.py RailGroup.on_sack)."""
        for rec in list(self.flush_records):
            self._try_complete_flush(rec, fires)

    def _try_complete_flush(self, rec: FlushRec, fires) -> None:
        if rec.completed:
            return
        pending = [c for c, s in rec.waits.items() if c.flush_acked < s]
        dead = [c for c in pending if not c.alive]
        for c, watermark in rec.stripe_waits.items():
            grp = getattr(c, "stripe", None)
            if grp is not None and grp.has_unsacked(watermark):
                (pending if c.alive else dead).append(c)
        if dead:
            rec.completed = True
            if rec in self.flush_records:
                self.flush_records.remove(rec)
            # A session that expired (rather than a bare reset) owns the
            # failure reason: "session expired" instead of "not connected".
            reason = next(
                (c.sess_fail_reason for c in dead
                 if getattr(c, "sess_fail_reason", None)),
                REASON_NOT_CONNECTED + " (peer reset during flush)")
            if rec.fail is not None:
                fires.append(lambda f=rec.fail, r=reason: f(r))
        elif not pending:
            rec.completed = True
            if rec in self.flush_records:
                self.flush_records.remove(rec)
            self.counters.flushes_completed += 1
            us = int((time.perf_counter() - rec.born) * 1e6)
            self.hists.flush_us[swtrace.hist_bucket(us)] += 1  # §25
            if rec.done is not None:
                fires.append(rec.done)

    # ----------------------------------------------------------- conn mgmt
    def _register_conn_io(self, conn: TcpConn) -> None:
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if conn._want_write else 0)
        self.selector.register(
            conn.sock, events, lambda mask, fires, c=conn: self._on_conn_io(c, mask, fires)
        )
        conn._registered = True

    def _update_conn_interest(self, conn: TcpConn) -> None:
        if not conn._registered or self.selector is None:
            return
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if conn._want_write else 0)
        try:
            self.selector.modify(
                conn.sock, events, lambda mask, fires, c=conn: self._on_conn_io(c, mask, fires)
            )
        except (KeyError, ValueError, OSError):
            pass

    def _unregister_conn_io(self, conn: TcpConn) -> None:
        if getattr(conn, "_registered", False) and self.selector is not None:
            try:
                self.selector.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            conn._registered = False

    def _on_conn_io(self, conn: TcpConn, mask, fires) -> None:
        if mask & selectors.EVENT_WRITE:
            conn.on_writable(fires)
        if mask & selectors.EVENT_READ and conn.alive:
            conn.on_readable(fires)

    def _conn_broken(self, conn, fires) -> None:
        """Peer died / stream reset.  Pending posted receives stay pending
        (the reference's UCX workers never fail posted recvs on peer death;
        pinned by tests/test_basic.py:250-277) -- only flush barriers
        targeting the connection fail.

        With a live session (STARWAY_SESSION negotiated via "sess"), the
        conn SUSPENDS instead: queues/journal/flush bookkeeping survive,
        the client redials under backoff, and in-flight ops complete late
        after the resume replay (DESIGN.md §14).  Only session expiry
        (grace elapsed / epoch mismatch) falls back to failure, with the
        stable "session expired" reason.

        With liveness detection active (STARWAY_KEEPALIVE > 0) on a
        ka-negotiated conn, the user has opted out of recvs-pend-forever:
        whatever killed the conn (liveness expiry, RST, EOF), the receive
        it was streaming into fails, and once no alive conns remain every
        queued receive fails too -- stable "not connected" keyword."""
        was_alive = conn.alive
        if self._trace is not None and conn.alive:
            self._trace.rec(swtrace.EV_CONN_DOWN, 0, conn.conn_id)
        sess = getattr(conn, "sess", None)
        if (sess is not None and conn.alive and not sess.expired
                and not sess.suspended):
            with self.lock:
                running = self.status == state.RUNNING
            if running:
                self._sess_suspend(conn, fires)
                return
        if was_alive and getattr(conn, "_proto", None) is not None:
            # swrefine: terminal transport death (the suspend path above
            # records "lost" instead; DESIGN.md §22).
            conn._proto.rec(swtrace.EV_PROTO, 0, conn.conn_id, 0, "down")
        ka_live = (self._ka_interval > 0 and conn.alive
                   and getattr(conn, "ka_ok", False))
        stranded = None
        if ka_live:
            with self.lock:
                msg = getattr(conn, "_rx_msg", None)
                if msg is not None and msg.posted is not None and not msg.complete:
                    stranded = msg.posted
                    msg.posted = None  # mark_dead's purge drops the partial
        conn.mark_dead(fires)
        root = getattr(conn, "rail_parent", None)
        if root is not None:
            # A secondary lane died: the endpoint survives.  Its
            # claimed-but-unacked chunks re-queue onto the surviving
            # lanes (core/lane.py rail_lost; ``rail_resteals``).
            root.rails = [r for r in root.rails if r is not conn]
            if root.alive and root.stripe is not None:
                root.stripe.rail_lost(conn, fires)
        for r in list(getattr(conn, "rails", ())):
            # The primary died terminally: its rails are meaningless.
            if r.alive:
                self._conn_broken(r, fires)
        if ka_live:
            reason = REASON_NOT_CONNECTED + " (peer lost; liveness detection active)"
            if stranded is not None and stranded.fail is not None:
                fires.append(lambda f=stranded.fail, r=reason: f(r))
            with self.lock:
                if not any(c.alive for c in self.conns.values()):
                    fires.extend(self.matcher.fail_pending(reason))
        # Unclaimed, unstarted pull descriptors from the dead peer can never
        # resolve: drop them (a claimed one keeps its receive pending, the
        # peer-death contract; a started pull resolves on its own).
        remote_msgs = getattr(conn, "_remote_msgs", None)
        if remote_msgs:
            with self.lock:
                for msg in list(remote_msgs):
                    if msg.posted is None and not msg.remote.started:
                        msg.discard = True
                        try:
                            self.matcher.unexpected.remove(msg)
                        except ValueError:
                            pass
                        remote_msgs.discard(msg)
        getattr(self, "_half_open", set()).discard(conn)
        for rec in list(self.flush_records):
            self._try_complete_flush(rec, fires)

    # ------------------------------------------------------------- session
    @staticmethod
    def _sess_int(v) -> int:
        """Peer-supplied session integers (sess_ack) arrive as JSON
        strings; a malformed value must not raise on the engine thread
        (one bad handshake would emergency-close the whole worker).
        Junk parses as 0 -- replay everything, the receiver's dedup
        absorbs it (the C++ engine's strtoull does the same)."""
        try:
            return int(str(v))
        except (TypeError, ValueError):
            return 0

    def _sess_suspend(self, conn, fires) -> None:
        """A session-enabled conn lost its transport: suspend instead of
        cancelling.  The client side redials under backoff; the server
        side waits for the peer's resume dial; either side expires the
        session once the grace window elapses."""
        logger.warning(
            "starway: conn %s lost; session %s suspended (grace %.3gs)",
            conn.conn_id, conn.sess.sid[:8], conn.sess.grace)
        conn.suspend(fires)
        for r in list(getattr(conn, "rails", ())):
            # Rails are per-incarnation transports (like sm rings): the
            # resumed client re-dials them; un-SACKed striped sources
            # re-dispatch wholesale at resume (journal per-message).
            if r.alive:
                self._conn_broken(r, fires)
        self._add_timer(conn.sess.grace,
                        lambda fires, c=conn: self._sess_check_grace(c, fires))
        if self.kind == "client":
            self._add_timer(0.01,
                            lambda fires, c=conn: self._sess_redial(c, fires))

    def _sess_check_grace(self, conn, fires) -> None:
        sess = conn.sess
        if sess is None or sess.expired or not sess.suspended:
            return
        if time.monotonic() >= sess.deadline:
            self._sess_expire(conn, fires)

    def _sess_expire(self, conn, fires) -> None:
        """Terminal session failure: grace elapsed, or the peer answered a
        resume dial with a new epoch.  Everything that was riding out the
        outage fails with the stable "session expired" reason."""
        sess = conn.sess
        if sess is None or sess.expired:
            return
        sess.expired = True
        reason = REASON_SESSION_EXPIRED
        conn.sess_fail_reason = reason
        logger.warning("starway: session %s expired", sess.sid[:8])
        if self._trace is not None:
            self._trace.rec(swtrace.EV_SESS_EXPIRE, 0, conn.conn_id, 0, reason)
        if getattr(conn, "_proto", None) is not None:
            # swrefine: terminal expiry -- from `suspended` (grace
            # elapsed / epoch mismatch) or straight from `estab` (the
            # stale-epoch registration path, MONITOR_EXTRA in
            # analysis/refine.py; DESIGN.md §22).
            conn._proto.rec(swtrace.EV_PROTO, 0, conn.conn_id, 0, "expire")
        self._faulted = True
        swtrace.flight_dump("session-expired", self, reason)
        # count=True: the C++ engine bumps ops_cancelled per item it fails
        # at expiry (sess_cancel_terminal) -- the cross-engine counter
        # registry must agree for identical wire histories.
        conn._cancel_tx_state(fires, reason, count=True)
        conn.mark_dead(fires)
        getattr(self, "_sessions", {}).pop(sess.sid, None)
        # Session users opted into bounded failure (like the keepalive
        # contract): queued receives fail once no alive conns remain.
        with self.lock:
            if not any(c.alive for c in self.conns.values()):
                fires.extend(self.matcher.fail_pending(reason))
        for rec in list(self.flush_records):
            self._try_complete_flush(rec, fires)

    # --------------------------------------------------------------- hooks
    def _on_hello(self, conn, info, fires) -> None:  # pragma: no cover - server only
        pass

    def _on_hello_ack(self, conn, info, fires) -> None:  # pragma: no cover
        pass

    # --------------------------------------------------------------- close
    def _do_close(self) -> None:
        fires: list = []
        _fail_idx = {"send": 5, "devpull": 4, "flush": 2}
        with self.lock:
            while self.ops:
                op = self.ops.popleft()
                idx = _fail_idx.get(op[0])
                fail = op[idx] if idx is not None else None
                if fail is not None:
                    self.counters.ops_cancelled += 1
                    fires.append(lambda f=fail: f(REASON_CANCELLED))
            fires.extend(self.matcher.cancel_all())
            conns = list(self.conns.values())
            mgr, self._xfer_mgr = self._xfer_mgr, None
        if mgr is not None:
            # Dropping the transfer server cancels unpulled offers (the
            # close-cancels-in-flight contract for device sends).
            mgr.close()
        for rec in self.flush_records:
            if not rec.completed and rec.fail is not None:
                self.counters.ops_cancelled += 1
                fires.append(lambda f=rec.fail: f(REASON_CANCELLED))
        self.flush_records.clear()
        for c in conns:
            c.close(fires)
        for c in list(getattr(self, "_half_open", ())):
            c.mark_dead(fires)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        fabric.unregister(self)
        try:
            if self.selector is not None:
                self.selector.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        with self.lock:
            self.status = state.CLOSED
            cb = self.close_cb
            self.close_cb = None
        _run_fires(fires)
        # Park the ring's final contents for post-close consumers (bench
        # --trace reports run after the workers are gone).
        swtrace.retire(self)
        if cb is not None:
            try:
                cb()
            except Exception:
                logger.exception("starway: close callback raised")

    def _teardown_sockets(self) -> None:
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        try:
            if self.selector is not None:
                self.selector.close()
        except OSError:
            pass


class ClientWorker(Worker):
    """Engine behind ``starway_tpu_torch.Client`` (reference: struct Client,
    src/bindings/main.hpp:131-189; connect-once lifecycle main.cpp:552-585)."""

    kind = "client"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.primary_conn = None
        self._connect_cb = None
        self._connect_target = None
        self._connect_timeout: Optional[float] = None
        self._sess_target: Optional[tuple] = None  # (addr, port) for redials

    def connect(self, addr: str, port: int, cb,
                timeout: Optional[float] = None) -> None:
        with self.lock:
            if self.status != state.VOID:
                raise StarwayStateError(
                    "starway client supports a single connect "
                    f"(status={state.NAMES[self.status]})"
                )
            self.status = state.INIT
        self._connect_cb = cb
        self._connect_timeout = timeout
        self._connect_target = ("socket", addr, port, None)
        self._start_thread()

    def connect_address(self, blob: bytes, cb,
                        timeout: Optional[float] = None) -> None:
        info = frames.unpack_json_body(blob)
        with self.lock:
            if self.status != state.VOID:
                raise StarwayStateError(
                    "starway client supports a single connect "
                    f"(status={state.NAMES[self.status]})"
                )
            self.status = state.INIT
        self._connect_cb = cb
        self._connect_timeout = timeout
        self._connect_target = (
            "address",
            info.get("host", "127.0.0.1"),
            int(info.get("port", 0)),
            info.get("worker_id"),
        )
        self._start_thread()

    def _fail_connect(self, cb, reason: str) -> None:
        with self.lock:
            self.status = state.CLOSED
        self._teardown_sockets()
        if cb is not None:
            _run_fires([lambda: cb(reason)])

    def _setup(self) -> bool:
        mode, addr, port, wid = self._connect_target
        cb = self._connect_cb
        if config.inproc_enabled():
            target = fabric.lookup_worker_id(wid) if wid else fabric.lookup_sockaddr(addr, port)
            if target is not None and target is not self:
                try:
                    conn = target.attach_inproc(self, mode)
                except Exception as e:
                    self._fail_connect(cb, f"{REASON_NOT_CONNECTED}: {e}")
                    return False
                self.primary_conn = conn
                with self.lock:
                    self.conns[conn.conn_id] = conn
                    if self.status == state.INIT:
                        self.status = state.RUNNING
                fabric.register_worker(self)
                if self._trace is not None:
                    self._trace.rec(swtrace.EV_CONN_UP, 0, conn.conn_id)
                if cb is not None:
                    _run_fires([lambda: cb("")])
                return True
        # Real TCP path (cross-process / DCN bootstrap).  The HELLO offers a
        # same-host shared-memory upgrade when enabled; a peer that mapped
        # the segment confirms with "sm": "ok" (core/shmring.py).  A
        # session offer (STARWAY_SESSION) disables the sm upgrade: the
        # rings are a per-incarnation transport with no replay journal.
        sess_on = config.session_enabled()
        self._sess_target = (addr, port)
        sm_offer = None
        if config.sm_enabled() and not sess_on:
            try:
                from . import shmring

                sm_offer = shmring.ShmSegment.create(self.worker_id[:8])
            except Exception:
                sm_offer = None
        connect_timeout = self._connect_timeout or config.connect_timeout()
        try:
            extra = {"ka": "ok"}  # liveness capability, always offered
            # swscope end-to-end stitching (DESIGN.md §15): with tracing
            # armed, offer a fresh trace-conn id; a tracing acceptor
            # confirms with "tr": "ok" and both rings tag EV_E2E events
            # with it.
            tr_offer = ""
            if self._trace is not None:
                tr_offer = uuid.uuid4().hex[:16]
                extra["tr"] = tr_offer
            rails_n = config.stripe_rails()
            if rails_n > 1:
                # Multi-rail striping offer (DESIGN.md §17): a capable
                # acceptor confirms "rails": "ok" and we dial the extra
                # lanes right after the primary handshake.
                extra["rails"] = str(rails_n)
            fc_w = config.fc_window()
            if fc_w > 0:
                # Receiver-driven flow control offer (DESIGN.md §18):
                # the value is OUR unexpected-queue budget for the
                # peer's eager traffic; an fc-capable acceptor answers
                # with its own window.
                extra["fc"] = str(fc_w)
            integ = config.integrity_enabled()
            if integ:
                # End-to-end integrity offer (DESIGN.md §19): an
                # integrity-capable acceptor confirms "csum": "ok" and
                # every later frame on the conn is checksummed.
                extra["csum"] = "1"
            if sess_on:
                # Stable session id + epoch 0 (the acceptor assigns the
                # real epoch); sess_ack is our cumulative rx seq (0 new).
                extra.update(sess="ok", sess_id=self.worker_id,
                             sess_epoch="0", sess_ack="0")
            if sm_offer is not None:
                extra.update(
                    sm_key=sm_offer.key,
                    sm_nonce=f"{sm_offer.nonce:016x}",
                    sm_ring=str(sm_offer.ring_size),
                )
            from .. import device as _device

            if _device.devpull_supported():
                extra["devpull"] = "ok"
            if _device.cudaipc_identity() is not None:
                # The port's own pull (device.py): a key JAX peers and the
                # C++ engine ignore, so they never see its descriptors.
                extra["cudaipc"] = _device.cudaipc_identity()
            sock = socket.create_connection((addr, port), timeout=connect_timeout)
            sock.settimeout(connect_timeout)
            sock.sendall(frames.pack_hello(self.worker_id, mode, self.name, extra))
            hdr = _read_exact(sock, frames.HEADER_SIZE)
            ftype, _, blen = frames.unpack_header(hdr)
            if ftype != frames.T_HELLO_ACK:
                raise ConnectionError("unexpected frame during handshake")
            ack = frames.unpack_json_body(_read_exact(sock, blen))
        except Exception as e:
            if sm_offer is not None:
                sm_offer.unlink()
                sm_offer.close()
            self._fail_connect(cb, f"{REASON_NOT_CONNECTED}: {e}")
            return False
        conn = TcpConn(self, sock, mode, handshaken=True)
        conn.peer_name = ack.get("worker_id", "")
        peer_ipc = ack.get("cudaipc") if "cudaipc" in extra else None
        conn.cudaipc_peer = peer_ipc if isinstance(peer_ipc, str) else None
        conn.devpull_ok = (ack.get("devpull") == "ok"
                           or conn.cudaipc_peer is not None)
        conn.ka_ok = ack.get("ka") == "ok"
        conn.rails_ok = rails_n > 1 and ack.get("rails") == "ok"
        if fc_w > 0 and self._sess_int(ack.get("fc", 0)) > 0:
            conn.fc_ok = True
            conn.fc_window = conn.fc_credits = self._sess_int(ack["fc"])
        conn.csum_ok = integ and ack.get("csum") == "ok"
        if tr_offer and ack.get("tr") == "ok":
            conn.tr_id = tr_offer
        if sess_on and ack.get("sess") == "ok":
            conn.sess = SessionState(self.worker_id,
                                     str(ack.get("sess_epoch", "")))
        if sm_offer is not None:
            if ack.get("sm") == "ok":
                conn.adopt_sm(sm_offer, creator=True)
                if conn.csum_ok:
                    # §19: the rings carry checksummed slot records from
                    # the first byte (both sides enable at handshake).
                    sm_offer.enable_integrity()
            else:
                sm_offer.unlink()
                sm_offer.close()
        self.primary_conn = conn
        with self.lock:
            self.conns[conn.conn_id] = conn
            if self.status == state.INIT:
                self.status = state.RUNNING
        self._register_conn_io(conn)
        fabric.register_worker(self)
        if conn._proto is not None:
            # swrefine: the blocking handshake above IS the hello-sent
            # state -- HELLO written, HELLO_ACK consumed synchronously
            # before the conn object exists, so both events are recorded
            # here at its birth (DESIGN.md §22).
            conn._proto.rec(swtrace.EV_PROTO, 0, conn.conn_id, 0,
                            "st:hello-sent")
            conn._proto.rec(swtrace.EV_PROTO, 0, conn.conn_id, 0,
                            "rx:HELLO_ACK")
        if conn.rails_ok:
            self._dial_rails(conn, addr, port, rails_n - 1)
        if self._trace is not None:
            self._trace.rec(swtrace.EV_CONN_UP, 0, conn.conn_id)
        if conn.tr_id:
            # One-shot clock exchange at handshake (engine thread, before
            # the loop): a timestamped PING whose PONG yields the first
            # EV_CLOCK sample, so trace --merge can align this process's
            # ring with the peer's even when keepalive never fires.
            ping_fires: list = []
            conn.send_ping(ping_fires)
            _run_fires(ping_fires)
        if cb is not None:
            _run_fires([lambda: cb("")])
        return True

    # --------------------------------------------------------------- rails
    def _dial_rails(self, primary, addr: str, port: int, count: int) -> None:
        """Open ``count`` secondary lanes to the accepted endpoint
        (DESIGN.md §17).  Blocking dials on the engine thread, like the
        primary handshake; a failed rail is skipped -- striping simply
        runs over fewer lanes."""
        timeout = self._connect_timeout or config.connect_timeout()
        fires: list = []
        for i in range(count):
            sock = None
            try:
                sock = socket.create_connection((addr, port), timeout=timeout)
                sock.settimeout(timeout)
                extra = {"rail_of": self.worker_id, "rail_idx": str(i + 1),
                         "ka": "ok"}
                if config.integrity_enabled():
                    # §19: every lane of a railed conn checksums its own
                    # frames (chunks verify on the rail they rode).
                    extra["csum"] = "1"
                sock.sendall(frames.pack_hello(self.worker_id, "socket",
                                               self.name, extra))
                hdr = _read_exact(sock, frames.HEADER_SIZE)
                ftype, _, blen = frames.unpack_header(hdr)
                if ftype != frames.T_HELLO_ACK:
                    raise ConnectionError("unexpected frame during rail handshake")
                ack = frames.unpack_json_body(_read_exact(sock, blen))
                if ack.get("rail") != "ok":
                    raise ConnectionError("peer refused rail attach")
            except Exception as e:
                logger.warning("starway: rail %d dial failed (%s); striping "
                               "continues over fewer lanes", i + 1, e)
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                continue
            rail = TcpConn(self, sock, "socket", handshaken=True)
            rail.peer_name = primary.peer_name
            rail.ka_ok = ack.get("ka") == "ok"
            rail.csum_ok = (config.integrity_enabled()
                            and ack.get("csum") == "ok")
            primary.attach_rail(rail, fires)
            with self.lock:
                self.conns[rail.conn_id] = rail
            self._register_conn_io(rail)
            if rail._proto is not None:
                # swrefine: rails take the same blocking handshake as the
                # primary (DESIGN.md §22).
                rail._proto.rec(swtrace.EV_PROTO, 0, rail.conn_id, 0,
                                "st:hello-sent")
                rail._proto.rec(swtrace.EV_PROTO, 0, rail.conn_id, 0,
                                "rx:HELLO_ACK")
            if self._trace is not None:
                self._trace.rec(swtrace.EV_CONN_UP, 0, rail.conn_id)
        _run_fires(fires)

    # ------------------------------------------------------ session redial
    def _sess_redial(self, conn, fires) -> None:
        """One resume attempt for a suspended session (engine thread;
        scheduled by _sess_suspend and re-armed under exponential backoff
        with jitter -- the PR-1 reconnect shape, now transparent)."""
        sess = conn.sess
        with self.lock:
            running = self.status == state.RUNNING
        if not running or sess is None or sess.expired or not sess.suspended:
            return
        if time.monotonic() >= sess.deadline:
            self._sess_expire(conn, fires)
            return
        addr, port = self._sess_target
        try:
            sock, ack = self._sess_dial(addr, port, sess)
        except Exception as e:
            # NOT counted in swtrace.GLOBAL.reconnects: that counter is
            # api-layer aconnect retries, and the native engine's redial
            # path has no equivalent hook -- bumping it here would break
            # cross-engine counter parity for identical outages.
            delay = sess.redial_delay() * (0.5 + random.random() / 2)
            logger.debug("starway: session redial failed (%s); retry in %.3gs",
                         e, delay)
            self._add_timer(delay,
                            lambda fires, c=conn: self._sess_redial(c, fires))
            return
        if (ack.get("sess") != "ok"
                or str(ack.get("sess_epoch", "")) != sess.epoch):
            # The peer restarted (or forgot us): a new epoch is a new
            # session -- ours is expired, not resumable.
            try:
                sock.close()
            except OSError:
                pass
            self._sess_expire(conn, fires)
            return
        conn.resume(sock, self._sess_int(ack.get("sess_ack", "0")), fires)
        if conn.rails_ok:
            # Rails are per-incarnation: re-dial them now that the
            # session is back (striped sources already re-dispatched on
            # the primary; new lanes start stealing as they attach).
            self._dial_rails(conn, addr, port, config.stripe_rails() - 1)

    def _sess_dial(self, addr: str, port: int, sess) -> tuple:
        """One blocking resume dial + handshake (bounded by the connect
        timeout; the engine thread sleeps in backoff between attempts).
        Returns (socket, parsed HELLO_ACK dict); raises on failure."""
        timeout = self._connect_timeout or config.connect_timeout()
        extra = {"ka": "ok", "sess": "ok", "sess_id": sess.sid,
                 "sess_epoch": sess.epoch, "sess_ack": str(sess.rx_cum)}
        if config.integrity_enabled():
            # §19: re-offered per incarnation for wire-format consistency
            # (csum_ok is sticky on the session conn either way).
            extra["csum"] = "1"
        if config.fc_window() > 0:
            # Fresh credit window per incarnation (DESIGN.md §18): both
            # sides reset to their stored windows at resume; the key is
            # re-advertised for wire-format consistency.
            extra["fc"] = str(config.fc_window())
        from .. import device as _device

        if _device.devpull_supported():
            extra["devpull"] = "ok"
        if _device.cudaipc_identity() is not None:
            extra["cudaipc"] = _device.cudaipc_identity()
        mode = self._connect_target[0] if self._connect_target else "socket"
        sock = socket.create_connection((addr, port), timeout=timeout)
        try:
            sock.settimeout(timeout)
            sock.sendall(frames.pack_hello(self.worker_id, mode, self.name,
                                           extra))
            hdr = _read_exact(sock, frames.HEADER_SIZE)
            ftype, _, blen = frames.unpack_header(hdr)
            if ftype != frames.T_HELLO_ACK:
                raise ConnectionError("unexpected frame during session resume")
            ack = frames.unpack_json_body(_read_exact(sock, blen))
        except Exception:
            try:
                sock.close()
            except OSError:
                pass
            raise
        return sock, ack


class ServerWorker(Worker):
    """Engine behind ``starway_tpu_torch.Server`` (reference: struct Server,
    src/bindings/main.hpp:306-376; listen modes main.cpp:811-851,1063-1124)."""

    kind = "server"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.accept_cb = None
        self.eps: dict = {}  # conn_id -> ServerEndpoint
        # Accepted TCP conns whose HELLO has not arrived yet; they join
        # self.conns at handshake and must still be torn down at close.
        self._half_open: set = set()
        # Resilient sessions: sess_id -> conn (suspended conns wait here
        # for the peer's resume dial; see _sess_hello / DESIGN.md §14).
        self._sessions: dict = {}

    def set_accept_cb(self, cb) -> None:
        self.accept_cb = cb

    def listen(self, addr: str, port: int) -> None:
        with self.lock:
            if self.status != state.VOID:
                raise StarwayStateError(
                    f"starway server already listening or closed (status={state.NAMES[self.status]})"
                )
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                listener.bind((addr, port))
                listener.listen(512)
            except OSError:
                listener.close()
                raise
            listener.setblocking(False)
            self._listener = listener
            self.mode = "socket"
            self.status = state.RUNNING
            # Use the kernel-assigned port so listen(addr, 0) advertises a
            # connectable address.
            bound_port = listener.getsockname()[1]
            self._make_address_blob(addr, bound_port)
        fabric.register(self, addr, bound_port)
        self._start_thread()

    def listen_address(self) -> bytes:
        """Worker-address (listenerless in the reference) bootstrap mode.

        The reference returns serialized UCX worker-address bytes and relies
        on an out-of-band channel to move them (src/bindings/main.cpp:834-860).
        Here the blob carries the worker id plus host:port contact info; an
        in-process peer attaches directly through the fabric registry and a
        cross-process peer bootstraps over TCP (the DCN analogue).
        """
        with self.lock:
            if self.status != state.VOID:
                raise StarwayStateError(
                    f"starway server already listening or closed (status={state.NAMES[self.status]})"
                )
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind(("0.0.0.0", 0))
            listener.listen(512)
            listener.setblocking(False)
            self._listener = listener
            self.mode = "address"
            self.status = state.RUNNING
            self._make_address_blob(config.advertised_host(), listener.getsockname()[1])
        fabric.register_worker(self)
        self._start_thread()
        return self._address_blob

    def _make_address_blob(self, host: str, port: int) -> None:
        self._address_blob = json.dumps(
            {
                "worker_id": self.worker_id,
                "host": host if host not in ("0.0.0.0", "") else config.advertised_host(),
                "port": port,
                "fabric": "starway-tpu",
            }
        ).encode()

    def _setup(self) -> bool:
        self.selector.register(self._listener, selectors.EVENT_READ, self._on_accept)
        return True

    def _on_accept(self, mask, fires) -> None:
        while True:
            try:
                s, _ = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            conn = TcpConn(self, s, "socket", handshaken=False)
            if conn._proto is not None:
                # swrefine: accepted conns start in `estab` -- the
                # pre-HELLO accept state is folded into the same framed
                # dispatch (DESIGN.md §16, §22).
                conn._proto.rec(swtrace.EV_PROTO, 0, conn.conn_id, 0,
                                "st:estab")
            self._half_open.add(conn)
            self._register_conn_io(conn)
            # The connection joins self.conns once its HELLO arrives.

    def _on_hello(self, conn, info, fires) -> None:
        conn.peer_name = info.get("worker_id", "")
        mode = info.get("mode", "socket")
        conn.mode = mode
        if mode == "address":
            # Mirrors the reference: in worker-address mode endpoint socket
            # fields are empty (README.md:141-143).
            conn.local_addr = conn.remote_addr = ""
            conn.local_port = conn.remote_port = 0
        conn.handshaken = True
        self._half_open.discard(conn)
        if info.get("rail_of"):
            # Secondary-lane attach (DESIGN.md §17): adopt the conn into
            # the existing endpoint's rail set -- no new ServerEndpoint,
            # no accept callback, no sm/session negotiation.
            self._on_rail_hello(conn, str(info["rail_of"]), info, fires)
            return
        # Resilient-session handshake (config.py STARWAY_SESSION): a
        # resume dial adopts the new socket into the suspended conn; a
        # fresh offer registers a new session.  Session conns never take
        # the sm upgrade (the rings are per-incarnation, no replay).
        sess_offered = (config.session_enabled()
                        and info.get("sess") == "ok" and "sess_id" in info)
        if sess_offered and self._sess_hello(conn, info, fires):
            return  # resumed onto the suspended conn; this wrapper consumed
        # §19 integrity negotiation, decided BEFORE the sm adopt below:
        # the rings' slot-record framing must be agreed before any ring
        # byte flows.
        csum_on = config.integrity_enabled() and bool(info.get("csum"))
        conn.csum_ok = csum_on
        # Same-host shared-memory offer: map + validate the segment, confirm
        # in the ACK.  Any failure (different host, bad nonce, sm disabled)
        # silently stays on TCP.
        sm_seg = None
        if config.sm_enabled() and "sm_key" in info and not sess_offered:
            try:
                from . import shmring

                sm_seg = shmring.ShmSegment.attach(
                    str(info["sm_key"]),
                    int(str(info.get("sm_nonce", "0")), 16),
                    int(str(info.get("sm_ring", "0"))),
                )
            except Exception:
                sm_seg = None
        # Settle the transport before the endpoint becomes visible, but
        # register before the ACK goes out: by the time the client's connect
        # completes, list_clients() must already contain it.
        if sm_seg is not None:
            conn.adopt_sm(sm_seg, creator=False, defer_tx=True)
            if csum_on:
                sm_seg.enable_integrity()
        ep = ServerEndpoint(conn)
        with self.lock:
            self.conns[conn.conn_id] = conn
            self.eps[conn.conn_id] = ep
        ack_extra = {}
        if sm_seg is not None:
            ack_extra["sm"] = "ok"
        if info.get("ka") == "ok":
            # Liveness capability negotiated: both sides may PING and both
            # must PONG (activation stays per-process via STARWAY_KEEPALIVE).
            conn.ka_ok = True
            ack_extra["ka"] = "ok"
        if info.get("rails"):
            # Multi-rail striping capability: the connector will dial the
            # extra lanes (rail_of) right after this ACK.
            conn.rails_ok = True
            ack_extra["rails"] = "ok"
        fc_w = config.fc_window()
        if fc_w > 0 and self._sess_int(info.get("fc", 0)) > 0:
            # Receiver-driven flow control (DESIGN.md §18): adopt the
            # connector's advertised window for OUR sends, answer with
            # our own for its sends.
            conn.fc_ok = True
            conn.fc_window = conn.fc_credits = self._sess_int(info["fc"])
            ack_extra["fc"] = str(fc_w)
        if csum_on:
            ack_extra["csum"] = "ok"
        if self._trace is not None and info.get("tr"):
            # swscope stitching: adopt the connector's trace-conn id so
            # both rings tag this conn's EV_E2E events identically.
            conn.tr_id = str(info["tr"])
            ack_extra["tr"] = "ok"
        from .. import device as _device

        if info.get("devpull") == "ok" and _device.devpull_supported():
            conn.devpull_ok = True
            ack_extra["devpull"] = "ok"
        if (isinstance(info.get("cudaipc"), str)
                and _device.cudaipc_identity() is not None):
            conn.cudaipc_peer = info["cudaipc"]
            conn.devpull_ok = True
            ack_extra["cudaipc"] = _device.cudaipc_identity()
        if sess_offered:
            ack_extra.update(sess="ok", sess_epoch=conn.sess.epoch,
                             sess_ack="0")
        # The ACK is the transport switch point: marking it routes anything
        # queued behind it (e.g. sends from the accept callback) to the ring
        # even while the ACK itself is still draining to the socket.
        conn.send_ctl(frames.pack_hello_ack(self.worker_id, ack_extra or None),
                      fires, switch_after=sm_seg is not None)
        if self._trace is not None:
            self._trace.rec(swtrace.EV_CONN_UP, 0, conn.conn_id)
        if self.accept_cb is not None:
            fires.append(lambda ep=ep: self.accept_cb(ep))

    def _on_rail_hello(self, conn, rail_of: str, info, fires) -> None:
        """Attach an accepted conn as a secondary lane of the endpoint
        whose peer worker id is ``rail_of`` (the primary handshake
        confirmed ``"rails": "ok"`` moments earlier)."""
        primary = None
        with self.lock:
            for c in self.conns.values():
                if (c.kind == "tcp" and c.alive and c.handshaken
                        and c.peer_name == rail_of
                        and getattr(c, "rail_parent", None) is None):
                    primary = c
                    break
        if primary is None:
            # Raced the endpoint's death (or a bogus attach): answer
            # without "rail": "ok"; the dialer drops the socket.
            conn.send_ctl(frames.pack_hello_ack(self.worker_id, None), fires)
            return
        ack_extra = {"rail": "ok"}
        if info.get("ka") == "ok":
            conn.ka_ok = True
            ack_extra["ka"] = "ok"
        if config.integrity_enabled() and info.get("csum"):
            conn.csum_ok = True
            ack_extra["csum"] = "ok"
        with self.lock:
            self.conns[conn.conn_id] = conn
        # ACK first: attach_rail may dispatch a feeder and kick TX at
        # once (mid-stripe join), and SDATA bytes ahead of the HELLO_ACK
        # would make the dialer reject the rail (native on_rail_hello
        # has the same order).
        conn.send_ctl(frames.pack_hello_ack(self.worker_id, ack_extra), fires)
        primary.attach_rail(conn, fires)
        if self._trace is not None:
            self._trace.rec(swtrace.EV_CONN_UP, 0, conn.conn_id)

    def _sess_hello(self, conn, info, fires) -> bool:
        """Session half of the accept handshake.  Returns True when this
        dial RESUMED an existing suspended session (``conn`` -- the fresh
        accept wrapper -- was consumed: its socket moved onto the
        suspended conn); False when a new session was registered on
        ``conn`` and the normal accept path continues."""
        sid = str(info["sess_id"])
        req_epoch = str(info.get("sess_epoch", "0"))
        existing = self._sessions.get(sid)
        if (existing is not None and existing.sess is not None
                and not existing.sess.expired
                and existing.sess.epoch == req_epoch):
            if not existing.sess.suspended:
                # One-sided failure: the client saw its conn die and
                # redialed before this side noticed (no EOF yet, ka not
                # expired).  The resume dial itself proves the old
                # incarnation dead -- supersede it instead of expiring a
                # perfectly resumable session.
                self._sess_suspend(existing, fires)
            peer_ack = self._sess_int(info.get("sess_ack", "0"))
            self._unregister_conn_io(conn)
            sock, conn.sock = conn.sock, None
            conn.alive = False  # wrapper never entered self.conns
            ack_extra = {"sess": "ok", "sess_epoch": existing.sess.epoch,
                         "sess_ack": str(existing.sess.rx_cum)}
            if existing.ka_ok:
                ack_extra["ka"] = "ok"
            if existing.csum_ok:
                ack_extra["csum"] = "ok"
            if existing.devpull_ok and existing.cudaipc_peer is None:
                ack_extra["devpull"] = "ok"
            if existing.fc_ok:
                ack_extra["fc"] = str(config.fc_window() or
                                      existing.fc_window)
            existing.resume(
                sock, peer_ack, fires,
                ack_ctl=frames.pack_hello_ack(self.worker_id, ack_extra))
            return True
        if existing is not None and existing is not conn:
            # Same session id, stale epoch: the old incarnation can never
            # resume -- expire it before the new registration shadows it
            # in the registry.
            self._sess_expire(existing, fires)
        # New session: the acceptor assigns the epoch; a resuming client
        # that lands here sees the mismatch and expires its session.
        conn.sess = SessionState(sid, uuid.uuid4().hex[:8])
        self._sessions[sid] = conn
        return False

    def attach_inproc(self, client_worker, mode: str):
        """Attach a same-process client (called from the client's engine
        thread).  The analogue of the reference's reverse-endpoint creation in
        the AM handshake path (src/bindings/main.cpp:912-938) -- except the
        in-process conn pair is naturally full-duplex, so no reverse endpoint
        is needed."""
        server_side = InprocConn(self, weakref.ref(client_worker), mode)
        client_side = InprocConn(client_worker, weakref.ref(self), mode)
        server_side.peer_conn = client_side
        client_side.peer_conn = server_side
        server_side.peer_name = client_worker.worker_id
        client_side.peer_name = self.worker_id
        if mode == "socket" and self._listener is not None:
            try:
                la, lp = self._listener.getsockname()[:2]
                server_side.local_addr, server_side.local_port = la, lp
                server_side.remote_addr = "127.0.0.1"
            except OSError:
                pass
        ep = ServerEndpoint(server_side)
        with self.lock:
            if self.status != state.RUNNING:
                raise StarwayStateError("server is not in a running state")
            self.conns[server_side.conn_id] = server_side
            self.eps[server_side.conn_id] = ep
        if self._trace is not None:
            self._trace.rec(swtrace.EV_CONN_UP, 0, server_side.conn_id)
        if self.accept_cb is not None:
            _run_fires([lambda: self.accept_cb(ep)])
        return client_side

    def list_clients(self) -> set:
        with self.lock:
            return set(self.eps.values())


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    got = 0
    while got < n:
        r = sock.recv_into(memoryview(buf)[got:])
        if r == 0:
            raise ConnectionError("peer closed during handshake")
        got += r
    return buf
