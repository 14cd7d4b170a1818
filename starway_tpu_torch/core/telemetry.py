"""swscope live telemetry plane: per-conn gauges + a periodic sampler.

The counter registry (core/swtrace.py) answers "what happened so far";
this module answers "what is happening NOW" (DESIGN.md §15).  Three
pieces:

* **Gauge vocabulary** -- the fixed per-conn ``GAUGE_NAMES`` below,
  implemented identically by the Python engine (``Worker.gauges_snapshot``
  computes them from live conn state under the GIL) and the C++ engine
  (rendered ON the engine thread and surfaced through the ``sw_gauges``
  ABI call, so no lock-free shadow state is needed).  Like the counter
  vocabulary it is cross-engine contract surface: swcheck's
  ``contract-trace`` pass diffs ``GAUGE_NAMES`` against ``kGaugeNames[]``.
  Two worker-level gauges ride alongside the per-conn dict:
  ``posted_recvs`` (receives queued in the matcher) and
  ``staging_pool_bytes`` (process-global device staging-pool occupancy,
  overlaid by this module the way the global counters are).

* **Sampler** -- off by default; armed by ``STARWAY_METRICS_INTERVAL``
  (or implicitly by ``STARWAY_METRICS_PATH`` / ``STARWAY_METRICS_ADDR``).
  A daemon thread snapshots every registered worker's counters + gauges
  into a bounded ring of timestamped samples (monotonic ``mono`` for
  ordering, wall ``t`` for humans), optionally appending each sample as a
  JSONL line and pushing it to connected live viewers (``python -m
  starway_tpu_torch.metrics``).  The per-op hot path never touches this module:
  workers register once at construction (and only when the sampler is
  armed), so metrics-off adds zero per-op work -- pinned by
  tests/test_telemetry.py's overhead guard next to the swtrace one.

* **Surfacing** -- ``evaluate_perf_detail()["telemetry"]`` carries the
  worker's current gauges + the recent sample window, and flight-recorder
  dumps embed the last samples so a post-mortem shows the queue/journal
  *trend* into the failure (core/swtrace.py flight_dump).
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
import weakref
from collections import deque
from typing import Optional

from .. import config
from . import swtrace

logger = logging.getLogger("starway_tpu_torch")

# ------------------------------------------------------- gauge vocabulary
#
# One name list, two implementations (Worker.gauges_snapshot in
# core/engine.py and the kGaugeNames/sw_gauges pair in sw_engine.cpp);
# machine-checked by `python -m starway_tpu_torch.analysis` (contract-trace).
# All are instantaneous per-conn values that drain to ZERO on an idle,
# flushed connection -- the invariant tests/test_telemetry.py pins.

GAUGE_NAMES = (
    "tx_queue_depth",   # items queued on the conn (incl. session-parked)
    "tx_queue_bytes",   # unwritten wire bytes across those items
    "inflight_sends",   # data items submitted but not yet fully on the wire
    "inflight_recvs",   # inbound payload streaming in + unresolved pulls
    "journal_bytes",    # session replay-journal residency (DESIGN.md §14)
    "journal_frames",   # journaled-but-unacked frames
    "stripe_pending",   # striped chunks assigned to this lane but not yet
    #                     fully written (primary rows add undisbursed
    #                     chunks; DESIGN.md §17 rail balance)
    "unexp_bytes",      # receiver-side unexpected-queue bytes this conn
    #                     has spilled and not yet granted back (§18;
    #                     populated only with fc or the cap armed -- the
    #                     seed path carries no accounting)
    "credits_avail",    # sender-side §18 credit remaining toward the peer
    #                     (0 when flow control is off or exhausted)
    "retx_pending",     # §19 NACK-requeued striped chunks not yet
    #                     rewritten (drains to 0 once every retransmit
    #                     is back on a lane; primary rows only)
    "zc_pending",       # §24 MSG_ZEROCOPY sends awaiting the kernel's
    #                     errqueue completion (native-only lever; this
    #                     engine declares the name and reports 0)
)


def _item_remaining(item) -> int:
    try:
        return int(item.remaining)
    except Exception:
        return 0


def _item_total(item) -> int:
    try:
        return int(item.total)
    except Exception:
        return len(getattr(item, "data", b""))


def conn_gauges(conn) -> dict:
    """GAUGE_NAMES snapshot for one Python-engine conn.  Reads live
    engine-thread state: every container is snapshotted via ``list()``
    (GIL-atomic for deques) and a torn read only skews one sample --
    telemetry tolerates that, the engine never does."""
    gauges = dict.fromkeys(GAUGE_NAMES, 0)
    tx = getattr(conn, "tx", None)
    if tx is None:  # inproc conns deliver synchronously: nothing queues
        return gauges
    from .conn import TxCtl  # local: telemetry must not import at module load

    try:
        items = list(tx)
        sess = getattr(conn, "sess", None)
        waiting = list(sess.waiting) if sess is not None else []
        waiting += list(getattr(conn, "fc_waiting", ()))  # §18 parked sends
        gauges["tx_queue_depth"] = len(items) + len(waiting)
        gauges["tx_queue_bytes"] = (
            sum(_item_remaining(i) for i in items)
            + sum(_item_total(i) for i in waiting))
        gauges["inflight_sends"] = (
            sum(1 for i in items
                if not isinstance(i, TxCtl) and _item_remaining(i) > 0)
            + sum(1 for i in waiting if not isinstance(i, TxCtl)))
        gauges["inflight_recvs"] = (
            (1 if getattr(conn, "_rx_msg", None) is not None else 0)
            + len(getattr(conn, "_remote_msgs", ())))
        if sess is not None:
            gauges["journal_bytes"] = int(sess.journal_bytes)
            gauges["journal_frames"] = len(sess.journal)
        from .lane import StripeFeeder  # local, like TxCtl above

        pending = sum(1 for i in items
                      if isinstance(i, StripeFeeder) and i.src is not None)
        grp = getattr(conn, "stripe", None)
        if grp is not None:
            pending += sum(len(s.pending) for s in grp.by_id.values()
                           if not s.sacked and not s.failed)
        gauges["stripe_pending"] = pending
        gauges["unexp_bytes"] = int(getattr(conn, "fc_unexp", 0))
        credits = int(getattr(conn, "fc_credits", 0))
        gauges["credits_avail"] = credits if credits > 0 else 0
        gauges["retx_pending"] = len(getattr(conn, "retx_offs", ()) or ())
    except Exception:
        pass  # a conn torn down mid-snapshot yields a partial sample
    return gauges


def staging_pool_bytes() -> int:
    """Process-global device staging-pool occupancy (device.py), overlaid
    onto every worker snapshot like the global counters are.  0 when the
    device layer has never loaded (no jax import from core/)."""
    import sys

    dev = sys.modules.get("starway_tpu_torch.device")
    if dev is None:
        return 0
    pool = getattr(dev, "_staging_pool", None)
    return int(getattr(pool, "_held", 0)) if pool is not None else 0


def _reshard_staging() -> dict:
    """Process-global swshard transfer-staging occupancy + high-water
    mark (reshard/executor.py; DESIGN.md §20's asserted memory bound).
    Zeros when the reshard layer has never loaded -- core/ must not
    import it (layering-reshard, the jax-rule twin)."""
    import sys

    ex = sys.modules.get("starway_tpu_torch.reshard.executor")
    if ex is None:
        return {"now": 0, "peak": 0}
    try:
        return ex.staging_snapshot()
    except Exception:
        return {"now": 0, "peak": 0}


def merge_global_gauges(snap: dict) -> dict:
    """Overlay the process-global gauges onto a worker snapshot (the
    native engine reports 0 for them, like its counter twin)."""
    snap["staging_pool_bytes"] = staging_pool_bytes()
    st = _reshard_staging()
    snap["reshard_staging_bytes"] = st["now"]
    snap["reshard_staging_peak"] = st["peak"]
    return snap


# --------------------------------------------------------------- sampler


def armed() -> bool:
    """Sampler armed for new workers?  Checked once per WORKER (at
    construction) -- never per op, so the off path is env-lookup-free on
    the data path (the PR-4 armed-state caching discipline)."""
    return (config.metrics_interval() > 0 or bool(config.metrics_path())
            or bool(config.metrics_addr()) or config.stall_ms() > 0)


def interval() -> float:
    """Effective sampling period: the env knob, or 1 s when only a
    path/addr (or the §25 stall sentinel) armed the sampler.  An armed
    sentinel caps the period at half its threshold so a wedge is
    detected within ~1.5x the configured STARWAY_STALL_MS."""
    iv = config.metrics_interval()
    iv = iv if iv > 0 else 1.0
    stall = config.stall_ms()
    if stall > 0:
        iv = min(iv, max(stall / 2e3, 0.01))
    return iv


_lock = threading.Lock()
# Serializes whole samples (stamp + ring append + emit): the daemon
# thread and explicit sample_now() callers (bench teardown, chaos
# scripts, tests) may overlap, and an unserialized pair could land in
# the ring/JSONL out of mono order -- the monotonicity consumers assert.
_sample_lock = threading.Lock()
_workers: list = []          # weakref.ref(worker), registration order
_samples: Optional[deque] = None   # bounded sample ring (armed runs only)
_thread: Optional[threading.Thread] = None
_stop = threading.Event()    # the CURRENT thread's stop flag (see _run)
_feed_clients: list = []     # sockets of live viewers
_feed_listener: Optional[socket.socket] = None


def register_worker(worker) -> None:
    """Called once per worker at construction (both engines).  No-op when
    the sampler is not armed -- the default path carries no registry."""
    if not armed():
        return
    global _samples
    with _lock:
        if _samples is None:
            _samples = deque(maxlen=config.metrics_ring_size())
        _workers.append(weakref.ref(worker))
        _workers[:] = [r for r in _workers if r() is not None]
    _ensure_thread()


def _live_workers() -> list:
    with _lock:
        refs = list(_workers)
    return [w for w in (r() for r in refs) if w is not None]


def sample_now() -> dict:
    """Take one sample across every registered worker, append it to the
    ring, and emit it (JSONL / live feed).  Also the test hook: samplers
    in tests call this directly instead of racing the thread -- the
    sample lock keeps the ring and the JSONL stream mono-ordered when
    they do overlap."""
    with _sample_lock:
        workers = {}
        for w in _live_workers():
            try:
                workers[w.trace_label] = {
                    "counters": w.counters_snapshot(),
                    "gauges": w.gauges_snapshot(),
                    # §25 swpulse: the compact percentile view, not the
                    # raw buckets -- samples stay JSONL-sized.
                    "hists": swtrace.hist_summary(w.hists_snapshot()),
                }
            except Exception:
                continue  # a worker mid-close yields no sample this tick
        sample = {"t": time.time(), "mono": time.perf_counter(),
                  "workers": workers}
        with _lock:
            if _samples is not None:
                _samples.append(sample)
        _emit(sample)
    return sample


def recent_samples(limit: int = 32) -> list:
    """The last ``limit`` samples (newest last); [] when the sampler was
    never armed.  Flight-recorder dumps embed this trend."""
    with _lock:
        if _samples is None:
            return []
        return list(_samples)[-limit:]


def detail_for(worker) -> dict:
    """The ``evaluate_perf_detail()["telemetry"]`` payload for one
    worker: its live gauges plus the recent sample window."""
    try:
        gauges = worker.gauges_snapshot()
    except Exception:
        gauges = {}
    return {
        "armed": armed(),
        "interval": interval() if armed() else 0.0,
        "gauges": gauges,
        "samples": recent_samples(),
    }


def reset() -> None:
    """Drop sampler state (test isolation).  The thread, if running,
    exits on its next tick."""
    global _samples, _thread, _feed_listener
    _stop.set()
    with _lock:
        _workers.clear()
        _samples = None
        _thread = None
        _stall_reports.clear()
        _stall_state.clear()
        listener, _feed_listener = _feed_listener, None
        clients = list(_feed_clients)
        _feed_clients.clear()
    for s in ([listener] if listener else []) + clients:
        try:
            s.close()
        except OSError:
            pass


# ------------------------------------------------------ §25 stall sentinel
#
# Armed only by STARWAY_STALL_MS (stall_ms() > 0): the sampler thread,
# once per tick, checks every registered worker for no-progress
# conditions.  Python workers expose the scan itself (Worker.stall_scan:
# flush barriers, credit parks, stripe pins, unexpected growth -- it
# bumps stall_alerts and records EV_STALL); the native engine
# self-detects inside its progress loop, so here its stall_alerts DELTA
# is what surfaces the report.  Either way the unified answer is a
# structured report (+ last ring events) in `_stall_reports`, a warning
# log line, and a §13 flight-recorder dump with the `stall` trigger.

_stall_reports: deque = deque(maxlen=64)
_stall_state = weakref.WeakKeyDictionary()  # worker -> (progress_sum, alerts)


def stall_reports(limit: int = 64) -> list:
    """The most recent stall-sentinel reports (newest last); [] unless
    STARWAY_STALL_MS armed the sentinel and a wedge was flagged."""
    with _lock:
        return list(_stall_reports)[-limit:]


def _progress_sum(counters: dict) -> int:
    """Monotone work signal: any counter moving between two ticks means
    the worker is progressing, not wedged.  stall_alerts itself is
    excluded (an alert must not read as progress)."""
    return sum(v for k, v in counters.items()
               if k != "stall_alerts" and isinstance(v, int))


def _stall_tick(threshold_s: float) -> None:
    for w in _live_workers():
        try:
            ctr = w.counters_snapshot()
        except Exception:
            continue
        sum_now = _progress_sum(ctr)
        alerts_now = int(ctr.get("stall_alerts", 0))
        prev = _stall_state.get(w)
        try:
            _stall_state[w] = (sum_now, alerts_now)
        except TypeError:
            continue  # un-weakrefable duck: no baseline, no scan
        if prev is None:
            continue  # first sight establishes the baseline only
        progressed = sum_now != prev[0]
        reports: list = []
        scan = getattr(w, "stall_scan", None)
        if scan is not None:
            try:
                reports = scan(threshold_s, progressed)
            except Exception:
                logger.debug("starway stall scan failed", exc_info=True)
        elif alerts_now > prev[1]:
            # Native worker: its run() loop already bumped stall_alerts
            # and recorded EV_STALL into the engine ring -- reshape the
            # ring records into the unified report.
            try:
                evs = [e for e in w.trace_events()
                       if e[1] == swtrace.EV_STALL]
            except Exception:
                evs = []
            for e in evs[-(alerts_now - prev[1]):]:
                reports.append({"worker": w.trace_label, "reason": e[5],
                                "conn": int(e[3]), "age_ms": int(e[4]),
                                "detail": "native stall sentinel"})
            if not reports:  # ring unarmed/wrapped: delta is the report
                reports.append({"worker": w.trace_label,
                                "reason": swtrace.STALL_REASONS[0],
                                "conn": 0, "age_ms": 0,
                                "detail": "native stall sentinel "
                                          "(ring unavailable)"})
        if not reports:
            continue
        try:
            tail = [list(e) for e in w.trace_events()[-8:]]
        except Exception:
            tail = []
        for r in reports:
            r.setdefault("worker", w.trace_label)
            r["events"] = tail  # last protocol/trace events from the ring
            with _lock:
                _stall_reports.append(r)
            logger.warning(
                "starway stall sentinel: %s on %s conn %s after %dms (%s)",
                r["reason"], r["worker"], r["conn"], r["age_ms"],
                r["detail"])
        swtrace.flight_dump("stall", w, reports[-1]["reason"])


# ---------------------------------------------------------- emit channels


def _emit(sample: dict) -> None:
    line = json.dumps(sample, separators=(",", ":")) + "\n"
    path = config.metrics_path()
    if path:
        try:
            with open(path, "a") as f:
                f.write(line)
        except OSError:
            logger.debug("starway telemetry: JSONL append failed", exc_info=True)
    with _lock:
        clients = list(_feed_clients)
    dead = []
    for s in clients:
        try:
            # Sockets are non-blocking: a viewer whose buffer is full is
            # dropped on the spot -- one stalled reader must never stall
            # the sampler (this runs under _sample_lock).
            s.sendall(line.encode())
        except (BlockingIOError, OSError):
            dead.append(s)
    if dead:
        with _lock:
            for s in dead:
                if s in _feed_clients:
                    _feed_clients.remove(s)
        for s in dead:
            try:
                s.close()
            except OSError:
                pass


def _ensure_thread() -> None:
    global _thread, _stop, _feed_listener
    with _lock:
        if _thread is not None and _thread.is_alive():
            return
        # Fresh stop event PER thread: reset() sets the old one and an
        # old thread mid-tick keeps its own (already-set) event, so a
        # re-arm can never revive it -- exactly one sampler runs.
        stop = threading.Event()
        _stop = stop
        addr = config.metrics_addr()
        if addr and _feed_listener is None:
            try:
                host, _, port = addr.rpartition(":")
                listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                listener.bind((host or "127.0.0.1", int(port)))
                listener.listen(8)
                # Non-blocking: _accept_feed_clients polls each tick; a
                # blocking accept would stretch the sampling period.
                listener.setblocking(False)
                _feed_listener = listener
            except (OSError, ValueError):
                logger.warning("starway telemetry: cannot listen on %s", addr)
        _thread = threading.Thread(target=_run, args=(stop,),
                                   name="starway-telemetry", daemon=True)
        _thread.start()


def _run(stop: threading.Event) -> None:
    # swcheck: allow(blocking-call): sampler daemon thread, never the engine thread
    while not stop.wait(interval()):
        try:
            if not _live_workers():
                continue  # every worker gone: idle tick, ring unchanged
            _accept_feed_clients()
            sample_now()
            stall = config.stall_ms()
            if stall > 0:
                _stall_tick(stall / 1e3)
        except Exception:
            logger.debug("starway telemetry tick failed", exc_info=True)


def _accept_feed_clients() -> None:
    listener = _feed_listener
    if listener is None:
        return
    while True:
        try:
            s, _ = listener.accept()
        except (socket.timeout, OSError):
            return
        s.setblocking(False)  # a stalled viewer is dropped, never waited on
        with _lock:
            _feed_clients.append(s)


# ---------------------------------------------------------- report helper


def summarize(samples: list) -> dict:
    """Time-series summary for the bench JSON report (--metrics): peaks
    and means of the load-bearing gauges across a run's samples."""
    n = 0
    peak_depth = peak_journal = peak_qbytes = 0
    sum_depth = 0
    for sample in samples:
        for wk in sample.get("workers", {}).values():
            for g in wk.get("gauges", {}).get("conns", {}).values():
                n += 1
                depth = int(g.get("tx_queue_depth", 0))
                sum_depth += depth
                peak_depth = max(peak_depth, depth)
                peak_qbytes = max(peak_qbytes, int(g.get("tx_queue_bytes", 0)))
                peak_journal = max(peak_journal, int(g.get("journal_bytes", 0)))
    return {
        "samples": len(samples),
        "conn_samples": n,
        "peak_tx_queue_depth": peak_depth,
        "mean_tx_queue_depth": (sum_depth / n) if n else 0.0,
        "peak_tx_queue_bytes": peak_qbytes,
        "peak_journal_bytes": peak_journal,
    }
