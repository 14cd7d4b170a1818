"""swtrace: per-op lifecycle tracing, counter registry, flight recorder.

Observability spine of the host runtime (DESIGN.md §13).  Three pieces,
all spanning both engines:

* **Trace ring** -- a bounded per-worker event buffer recording each op's
  lifecycle (``recv_post`` -> ``recv_match`` -> ``recv_done``, ``send_post``
  -> ``send_done``, flush barriers, failures, connection churn, and the
  data-plane stage spans from perf.record_stage).  Opt-in via
  ``STARWAY_TRACE=1`` (or implicitly when ``STARWAY_FLIGHT_DIR`` is set);
  when off, every hot-path hook is a single ``is None`` check -- no per-op
  allocation, no syscall (pinned by tests/test_trace.py's overhead guard).
  Appends are single ``deque.append`` calls on a ``maxlen`` deque:
  GIL-atomic and lock-free, safe from any thread, and -- unlike user
  callbacks -- permitted while a worker lock is held (no user code runs).
  The C++ engine records the same event vocabulary into its own ring
  (native/sw_engine.cpp ``TraceRing``), surfaced through the ``sw_trace``
  ABI call.

* **Counter registry** -- the fixed ``COUNTER_NAMES`` vocabulary below,
  implemented identically in core/engine.py (``Worker.counters``) and
  native/sw_engine.cpp (``Counters`` + the ``sw_counters`` ABI call), and
  merged into ``evaluate_perf_detail()["counters"]``.  The vocabulary is
  part of the cross-engine contract: swcheck's ``contract-trace`` pass
  diffs it (and the ``EV_*`` event types) against the C++ sources, so a
  counter added to one engine only is a merge-gate finding.

* **Flight recorder** -- on the first op failure with a non-cancel reason,
  on engine emergency close, and on ``close()`` after a fault, the last-N
  trace events plus a counter snapshot are dumped to a JSON file under
  ``STARWAY_FLIGHT_DIR`` for post-mortem forensics (the fault paths of
  DESIGN.md §10).  One dump per (worker, trigger); dump failures are
  swallowed -- the recorder must never take the engine down with it.

Export tooling lives in starway_tpu_torch/trace.py (``python -m
starway_tpu_torch.trace``): ring/flight dumps -> Chrome ``trace_event`` JSON.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import weakref
from collections import deque
from pathlib import Path
from typing import Optional

from .. import config

# ------------------------------------------------------ event vocabulary
#
# Shared with the C++ engine (native/sw_engine.cpp kEv* literals); the
# mapping is mechanical (EV_SEND_POST <-> kEvSendPost) and machine-checked
# by `python -m starway_tpu_torch.analysis` (rule contract-trace).

EV_SEND_POST = "send_post"    # tagged send (or DEVPULL descriptor) submitted
EV_SEND_DONE = "send_done"    # send locally complete (eager: handed to
#                               transport; rndv: transmission begun)
EV_RECV_POST = "recv_post"    # receive posted on the worker
EV_RECV_MATCH = "recv_match"  # receive claimed an inbound message (or vice
#                               versa) in the matcher
EV_RECV_DONE = "recv_done"    # receive delivered (tag = sender tag)
EV_FLUSH_POST = "flush_post"  # delivery barrier submitted
EV_FLUSH_DONE = "flush_done"  # barrier acknowledged by every target conn
EV_OP_FAIL = "op_fail"        # any op failed; reason carried verbatim
EV_CONN_UP = "conn_up"        # connection handshaken / attached
EV_CONN_DOWN = "conn_down"    # connection broken (peer death / reset)
EV_STAGE = "stage_span"       # data-plane stage span (perf.record_stage):
#                               reason = stage name, dur = span seconds
EV_SESS_RESUME = "sess_resume"  # session conn resumed after a reconnect
#                               (conn = conn id; nbytes = frames replayed)
EV_SESS_EXPIRE = "sess_expire"  # session expired (grace elapsed / new epoch)
EV_E2E = "e2e"                # swscope end-to-end marker (DESIGN.md §15):
#                               tag = per-conn per-direction wire ordinal,
#                               reason = "<trace-conn id>:tx|rx|sup" --
#                               equal (id, ordinal) at the two ends of a
#                               conn is ONE message; trace --merge draws
#                               the send->recv flow from the pair.  ":sup"
#                               marks a session replay of an already-
#                               counted frame (superseded, not recounted).
EV_CLOCK = "clock_sample"     # swscope clock-offset sample from a
#                               timestamped PING/PONG round trip: reason =
#                               "<trace-conn id>:<offset_us>:<err_us>"
#                               (peer_clock ~= local_clock + offset).
EV_PROTO = "proto"            # swrefine protocol event (DESIGN.md §22):
#                               conn = conn id, reason = the canonical
#                               event -- "rx:<FRAME>" at inbound dispatch,
#                               "tx:<FRAME>" at ctl-plane handoff,
#                               "st:hello-sent"/"st:estab" at conn
#                               creation, "lost"/"resume"/"expire"/"down"
#                               for the lifecycle.  Armed only by
#                               STARWAY_PROTO_TRACE / STARWAY_MONITOR
#                               (proto_active below); analysis/refine.py
#                               replays the channel through the monitor
#                               automaton compiled from both engines'
#                               protocol state machines.
EV_STALL = "stall"            # swpulse stall-sentinel alert (DESIGN.md
#                               §25): conn = suspect conn id (0 = worker-
#                               wide), reason = one of STALL_REASONS.
#                               Armed only by STARWAY_STALL_MS.

# ----------------------------------------------------- counter vocabulary
#
# One name list, two implementations (engine.py Worker.counters and the
# C++ kCounterNames/Counters pair).  `staging_hits`/`staging_misses` and
# `reconnects` are PROCESS-GLOBAL (the staging pool and the api-layer
# reconnect loop are not per-worker); merge_global_counters overlays them
# onto every worker snapshot so one dict answers "what happened here".

COUNTER_NAMES = (
    "sends_posted",       # tagged sends + DEVPULL descriptors submitted
    "sends_completed",    # send payloads fully handed to a transport
    "recvs_posted",       # receives posted
    "recvs_completed",    # receives delivered
    "flushes_posted",     # flush barriers submitted
    "flushes_completed",  # flush barriers acknowledged
    "ops_timed_out",      # ops failed by a deadline (REASON_TIMEOUT)
    "ops_cancelled",      # ops cancelled by local close
    "bytes_tx",           # payload/frame bytes handed to transports
    "bytes_rx",           # payload/frame bytes read from transports
    "gather_passes",      # gathered sendmsg passes (TX pump)
    "gather_items",       # iovecs submitted across gathered passes
    "staging_hits",       # staging-pool buffer reuses (process-global)
    "staging_misses",     # staging-pool fresh allocations (process-global)
    "ka_misses",          # peers declared dead by keepalive liveness
    "reconnects",         # aconnect retry attempts (process-global)
    "sessions_resumed",   # session conns resumed after a reconnect
    "frames_replayed",    # journaled frames re-queued at session resume
    "dup_frames_dropped", # duplicate-seq frames dropped by the receiver
    "acks_tx",            # cumulative session ACK frames sent
    "acks_rx",            # cumulative session ACK frames received
    "stripe_chunks_tx",   # striped chunks fully handed to a lane (§17)
    "stripe_chunks_rx",   # striped chunks ingested into an assembly
    "rail_resteals",      # chunks re-queued off a dead rail onto survivors
    "sends_parked",       # sends parked by the §18 credit window
    "sheds",              # parked sends failed by deadline-aware shedding
    "csum_fail",          # §19 integrity verification failures detected
    "chunk_retx",         # §19 striped chunks retransmitted after a NACK
    "reshard_bytes",      # §20 swshard bytes staged through schedules
    #                       (process-global: the executor runs above the
    #                       workers, like the staging pool does)
    "reshard_rounds",     # §20 swshard schedule rounds executed
    "io_syscalls",        # §23 hot-path I/O syscalls issued
    #                       (send/sendmsg/recv/recv_into on the data path)
    "hot_copies",         # §23 hot-path payload byte-copies (sm ring
    #                       put/take; the tcp data path is copy-free)
    "uring_submits",      # §24 io_uring_enter batched-submit calls
    #                       (native-only lever; this engine declares the
    #                       name and leaves it 0, like staging_* on the
    #                       C++ side)
    "uring_sqes",         # §24 sendmsg SQEs landed through the ring
    "zc_sends",           # §24 MSG_ZEROCOPY payload sendmsg calls
    "zc_notifies",        # §24 zerocopy completion ranges drained from
    #                       the errqueue (COPIED fallbacks included)
    "busypoll_hits",      # §24 events harvested inside the spin window
    "stall_alerts",       # §25 stall-sentinel alerts raised (0 unless
    #                       STARWAY_STALL_MS armed the sentinel)
)


class Counters:
    """Fixed-vocabulary integer counters (one instance per worker, plus
    the process-global ``GLOBAL``).  Plain attribute increments: writers
    are effectively single-threaded per counter (submit counters on the
    app thread, data-plane counters on the engine thread), so the
    read-modify-write race window is theoretical; telemetry tolerates it.
    """

    __slots__ = COUNTER_NAMES

    def __init__(self):
        for name in COUNTER_NAMES:
            setattr(self, name, 0)

    def snapshot(self) -> dict:
        return {name: getattr(self, name) for name in COUNTER_NAMES}


# --------------------------------------------------- histogram vocabulary
#
# swpulse (DESIGN.md §25): always-on log-bucketed distributions, bumped
# unconditionally at the contract points in BOTH engines (engine.py /
# conn.py / matching.py / lane.py <-> native/sw_engine.cpp, surfaced
# through ``sw_hists`` <-> ``Worker.hists_snapshot``).  Like COUNTER_NAMES
# the vocabulary -- and the bucket layout -- is cross-engine contract
# surface diffed by swcheck's ``contract-pulse`` pass against
# ``kHistNames[]`` / ``kHistBuckets``.  One bump is one clock read + one
# integer increment into a fixed per-worker array: no allocation, no lock,
# no branch on the seed path (the arrays always exist).  Latencies are in
# MICROSECONDS, sizes in BYTES; bucket i holds values with bit_length i
# (0 -> bucket 0), so bucket boundaries are powers of two and percentiles
# are derived at read time from the bucket upper bounds (hist_percentiles).

HIST_NAMES = (
    "send_local_us",   # send post -> local completion (eager: handed to
    #                    transport; rndv: transmission begun -- the §10
    #                    local-completion contract, measured)
    "recv_wait_us",    # recv post -> matcher claim (posted-first waits;
    #                    unexpected-first matches at ~0)
    "flush_us",        # flush barrier post -> all-target acknowledgement
    "park_us",         # §18 credit-window park residency (parked ->
    #                    unparked or shed)
    "pin_us",          # payload pin residency: §17 stripe pinned -> SACKed
    #                    and §24 zerocopy pinned -> errqueue-released
    #                    (native lever; this engine records stripe only)
    "msg_bytes",       # payload size per posted send
)

#: Buckets per histogram; bucket i covers values of ``bit_length() == i``
#: (i.e. [2^(i-1), 2^i)), with bucket 0 = zero and the last bucket open.
HIST_BUCKETS = 64


def hist_bucket(value: int) -> int:
    """Log-bucket index for a nonnegative integer (negative clamps to 0)."""
    if value <= 0:
        return 0
    b = value.bit_length()
    return b if b < HIST_BUCKETS else HIST_BUCKETS - 1


class Hists:
    """Fixed-vocabulary log-bucket histograms (one instance per worker).
    Plain list-element increments under the GIL, same tolerance story as
    :class:`Counters`; the C++ twin uses relaxed atomics."""

    __slots__ = HIST_NAMES

    def __init__(self):
        for name in HIST_NAMES:
            setattr(self, name, [0] * HIST_BUCKETS)

    def snapshot(self) -> dict:
        return {name: list(getattr(self, name)) for name in HIST_NAMES}


def hist_percentiles(buckets) -> dict:
    """p50/p90/p99/p999 + count for one histogram, derived at read time.
    Each percentile reports the upper bound of the bucket the rank lands
    in (2^i - 1) -- an over-estimate by at most 2x, which is the log-
    bucket deal."""
    total = sum(buckets)
    out = {"count": total, "p50": 0, "p90": 0, "p99": 0, "p999": 0}
    if total == 0:
        return out
    targets = (("p50", 0.50), ("p90", 0.90), ("p99", 0.99), ("p999", 0.999))
    ti = 0
    seen = 0
    for i, n in enumerate(buckets):
        if not n:
            continue
        seen += n
        bound = (1 << i) - 1 if i else 0
        while ti < len(targets) and seen >= targets[ti][1] * total:
            out[targets[ti][0]] = bound
            ti += 1
        if ti == len(targets):
            break
    return out


def hist_summary(snapshot: dict) -> dict:
    """Percentile view of a ``hists_snapshot()`` dict -- the compact shape
    telemetry samples and the metrics viewer carry."""
    return {name: hist_percentiles(buckets)
            for name, buckets in snapshot.items()}


# ------------------------------------------------- stall-reason vocabulary
#
# swpulse sentinel (DESIGN.md §25): the no-progress conditions the
# detector can flag, carried verbatim as the EV_STALL event reason and in
# stall reports.  Cross-engine contract surface like the names above
# (kStallReasons[] in sw_engine.cpp, diffed by contract-pulse).

STALL_REASONS = (
    "stall-flush",     # a flush barrier outlived the threshold with no
    #                    counter progress behind it
    "stall-credit",    # §18 parked sends aged past the threshold with no
    #                    credit arrival
    "stall-pin",       # stripe/zerocopy/journal pins undrained with no
    #                    progress past the threshold
    "stall-unexp",     # unexpected-queue residency with no recv progress
    #                    past the threshold
)


#: Process-global counters (staging pool, api-layer reconnects).
GLOBAL = Counters()

_GLOBAL_NAMES = ("staging_hits", "staging_misses", "reconnects",
                 "reshard_bytes", "reshard_rounds")


def merge_global_counters(snap: dict) -> dict:
    """Overlay the process-global counters onto a worker snapshot."""
    for name in _GLOBAL_NAMES:
        snap[name] = getattr(GLOBAL, name)
    return snap


# ------------------------------------------------------------ trace ring


def active() -> bool:
    """Tracing hooks armed for new workers?  True when ``STARWAY_TRACE``
    is on, a flight directory is configured (the recorder needs the
    ring's last-N events even when nobody asked for a full trace), the
    swrefine protocol-event channel is armed (its events ride this ring,
    DESIGN.md §22), or the swpulse stall sentinel is armed (its EV_STALL
    alerts and the "last events" in stall reports need a ring to land in,
    DESIGN.md §25)."""
    return (config.trace_enabled() or bool(config.flight_dir())
            or config.proto_trace_enabled() or config.stall_ms() > 0)


def proto_active() -> bool:
    """swrefine protocol-event channel armed for new conns?  Kept
    separate from :func:`active` so plain STARWAY_TRACE runs keep their
    seed event streams (the proto channel adds one event per frame); the
    env-unset path stays a single ``is None`` check per frame."""
    return config.proto_trace_enabled()


class TraceRing:
    """Bounded per-worker event ring.

    Events are ``(t, ev, tag, conn, nbytes, reason, dur)`` tuples with
    ``t`` from ``time.perf_counter()`` (CLOCK_MONOTONIC -- the same epoch
    the C++ ring stamps with ``steady_clock``, so one process's rings
    share a timeline).  ``dur`` is nonzero only for EV_STAGE spans.
    """

    __slots__ = ("events",)

    def __init__(self, capacity: int):
        self.events: deque = deque(maxlen=max(16, int(capacity)))

    def rec(self, ev: str, tag: int = 0, conn: int = 0, nbytes: int = 0,
            reason: str = "", dur: float = 0.0) -> None:
        self.events.append(
            (time.perf_counter(), ev, tag, conn, nbytes, reason, dur))

    def snapshot(self) -> list:
        return list(self.events)


def worker_ring() -> Optional[TraceRing]:
    """A fresh ring for a new worker, or None when tracing is off (the
    worker then carries no per-op hooks at all)."""
    if not active():
        return None
    return TraceRing(config.trace_ring_size())


def wrap_op(worker, ring: TraceRing, done_ev: str, tag: int, conn: int,
            nbytes: int, done, fail):
    """Wrap an op's (done, fail) callbacks to record its terminal event
    (and arm the flight recorder on non-cancel failures).  Only called
    when tracing is active -- the off path never allocates these closures.
    """

    def traced_done(*args):
        if done_ev == EV_RECV_DONE and len(args) >= 2:
            ring.rec(done_ev, args[0], conn, args[1])
        else:
            ring.rec(done_ev, tag, conn, nbytes)
        if done is not None:
            done(*args)

    def traced_fail(reason: str):
        ring.rec(EV_OP_FAIL, tag, conn, nbytes, reason)
        if "cancel" not in reason.lower():
            worker._faulted = True
            flight_dump("op-failed", worker, reason)
        if fail is not None:
            fail(reason)

    return traced_done, traced_fail


# ---------------------------------------------------------- ring registry
#
# `python -m starway_tpu_torch.bench --trace` (and the trace CLI) need every
# ring the process produced, including workers already closed by the time
# the report is written.  Live workers are held weakly; closed workers
# snapshot their ring into a bounded retired list via retire().

_reg_lock = threading.Lock()
_live: list = []      # weakref.ref(worker)
_retired: list = []   # {"worker": label, "events": [...]}
_RETIRED_CAP = 64


def register_worker(worker) -> None:
    if not active():
        return
    with _reg_lock:
        _live.append(weakref.ref(worker))
        _live[:] = [r for r in _live if r() is not None]


def retire(worker) -> None:
    """Snapshot a closing worker's ring into the retired list so its
    events survive the worker object (bench reports run after close).
    With STARWAY_MONITOR armed this is also the automatic conformance
    checkpoint: the worker's protocol events replay through the monitor
    before the ring is retired (DESIGN.md §22)."""
    if not active() or getattr(worker, "_trace_retired", False):
        return
    worker._trace_retired = True
    try:
        events = worker.trace_events()
    except Exception:
        events = []
    if events and config.monitor_enabled():
        from . import monitor

        monitor.check_worker(worker, events)
    if not events:
        return
    try:
        hists = worker.hists_snapshot()
    except Exception:
        hists = {}
    with _reg_lock:
        _retired.append({"worker": worker.trace_label, "events": events,
                         "hists": hists})
        del _retired[:-_RETIRED_CAP]


def dump_all() -> list:
    """``[{"worker": label, "events": [...]}, ...]`` for every traced
    worker this process has seen (retired first, then live)."""
    with _reg_lock:
        out = list(_retired)
        live = [r() for r in _live]
    for w in live:
        if w is None or getattr(w, "_trace_retired", False):
            continue
        try:
            events = w.trace_events()
        except Exception:
            continue
        if events:
            try:
                hists = w.hists_snapshot()
            except Exception:
                hists = {}
            out.append({"worker": w.trace_label, "events": events,
                        "hists": hists})
    return out


def reset() -> None:
    """Drop registry state (test isolation)."""
    with _reg_lock:
        _live.clear()
        _retired.clear()


def write_ring_dump(path) -> Path:
    """Dump every traced worker's ring to one JSON file -- the per-process
    input ``python -m starway_tpu_torch.trace --merge`` stitches (each process
    of a distributed run writes one before exiting)."""
    payload = {
        "pid": os.getpid(),
        "time": time.time(),
        "workers": [
            {"worker": d["worker"], "events": [list(e) for e in d["events"]],
             # §25 swpulse distributions ride every ring dump so a
             # post-mortem (and trace --merge) keeps the percentile
             # picture next to the event timeline.
             "hists": d.get("hists", {})}
            for d in dump_all()
        ],
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload))
    return path


# -------------------------------------------------------- flight recorder

_flight_seq = itertools.count(1)


def flight_dump(trigger: str, worker, reason: str = "") -> Optional[Path]:
    """Dump the worker's last-N trace events + counter snapshot to
    ``STARWAY_FLIGHT_DIR`` (no-op when unset).  Once per (worker,
    trigger); never raises -- forensics must not add failure modes."""
    flight_dir = config.flight_dir()
    if not flight_dir:
        return None
    trigs = getattr(worker, "_flight_trigs", None)
    if trigs is None:
        trigs = worker._flight_trigs = set()
    if trigger in trigs:
        return None
    trigs.add(trigger)
    try:
        label = getattr(worker, "trace_label", "worker")
        try:
            events = worker.trace_events()
        except Exception:
            events = []
        try:
            counters = worker.counters_snapshot()
        except Exception:
            counters = {}
        try:
            hists = worker.hists_snapshot()
        except Exception:
            hists = {}
        # Telemetry trend + the per-conn gauge snapshot at trigger time:
        # a post-mortem then shows the queue/journal trajectory INTO the
        # failure, not just the instant (DESIGN.md §15).
        try:
            gauges = worker.gauges_snapshot()
        except Exception:
            gauges = {}
        try:
            from . import telemetry

            samples = telemetry.recent_samples()
        except Exception:
            samples = []
        payload = {
            "trigger": trigger,
            "worker": label,
            "reason": reason,
            "pid": os.getpid(),
            "time": time.time(),
            "counters": counters,
            "hists": hists,
            "gauges": gauges,
            "telemetry": samples,
            "events": [list(e) for e in events],
        }
        out_dir = Path(flight_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"flight-{label}-{os.getpid()}-{next(_flight_seq)}.json"
        path.write_text(json.dumps(payload, indent=1))
        return path
    except Exception:
        return None
