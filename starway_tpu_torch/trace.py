"""swtrace/swscope export: ring and flight dumps -> Chrome ``trace_event``.

Two modes (DESIGN.md §13 and §15):

* ``python -m starway_tpu_torch.trace dump1.json [...] -o out.json`` converts
  flight-recorder dumps (core/swtrace.py flight_dump) or per-process ring
  dumps (swtrace.write_ring_dump) into one Chrome/Perfetto-loadable
  trace; ``python -m starway_tpu_torch.bench --trace PATH`` uses
  :func:`write_chrome` directly on the live ring registry.

* ``python -m starway_tpu_torch.trace --merge procA.json procB.json -o out``
  stitches dumps from DIFFERENT processes into ONE clock-aligned trace:
  EV_CLOCK samples (timestamped PING/PONG round trips) build a
  per-process offset graph, every process's timestamps are shifted onto
  the first process's timeline, and paired EV_E2E ordinals become Chrome
  flow events connecting each message's send span to its recv span
  across processes.  A wire-vs-stage latency breakdown (message wall
  time between the two rings vs. the recorded EV_STAGE spans) prints
  alongside and lands in the output under ``"swscope"``.

Layout: one trace *process* per worker (pid = worker index, process_name
metadata carries the worker label), one *thread* per connection
INCARNATION -- tracks are keyed by (conn, epoch), where a session resume
(EV_SESS_RESUME) bumps the conn's epoch, so pre- and post-resume events
never interleave on one track (tid = conn id for epoch 0; resumed
incarnations get fresh synthetic tids, named "conn N epoch E").  tid 0
is the worker-wide track: posted receives are fan-in and have no conn
until matched.  Op lifecycles render as complete ("X") spans --
``send_post``..``send_done``, ``recv_post``..``recv_done``,
``flush_post``..``flush_done``, with ``op_fail`` closing whichever op it
matches -- stage spans (``stage_span`` events from perf.record_stage) as
"X" spans of their measured duration, and everything unpaired (matches,
E2E ordinals, connection churn) as instants.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import deque
from pathlib import Path
from typing import Iterable, Optional

from .core import swtrace
from .perf import percentile

# POST event -> (span kind, terminal event)
_POSTS = {
    swtrace.EV_SEND_POST: "send",
    swtrace.EV_RECV_POST: "recv",
    swtrace.EV_FLUSH_POST: "flush",
}
_DONES = {
    swtrace.EV_SEND_DONE: "send",
    swtrace.EV_RECV_DONE: "recv",
    swtrace.EV_FLUSH_DONE: "flush",
}

#: First synthetic tid handed to a resumed conn incarnation -- far above
#: any realistic per-process conn id, so epoch tracks never collide with
#: epoch-0 tracks (which keep tid = conn id).
_EPOCH_TID_BASE = 1_000_000


def _pop_start(open_spans: dict, kind: str, tag: int, fifo_fallback: bool):
    """The matching open span for a terminal event: exact (kind, tag)
    first; with ``fifo_fallback``, the oldest open span of that kind (a
    wildcard receive completes with the SENDER's tag, which may differ
    from the posted one).  Failure events carry the op's own posted tag,
    so they match exactly or not at all -- a fallback there would close
    an unrelated pending op's span."""
    q = open_spans.get((kind, tag))
    if q:
        return q.popleft()
    if not fifo_fallback:
        return None
    oldest_key, oldest = None, None
    for (k, t), dq in open_spans.items():
        if k != kind or not dq:
            continue
        if oldest is None or dq[0][0] < oldest[0]:
            oldest_key, oldest = (k, t), dq[0]
    if oldest_key is not None:
        return open_spans[oldest_key].popleft()
    return None


def chrome_events(label: str, events: Iterable, pid: int,
                  ts_shift: float = 0.0,
                  e2e_out: Optional[list] = None) -> list:
    """Chrome trace events for one worker's swtrace ring.  ``ts_shift``
    (seconds, from the --merge clock alignment) is added to every
    timestamp.  ``e2e_out``, when given, collects one
    ``(tcid, direction, ordinal, ts_us, tid, nbytes)`` entry per EV_E2E
    tx/rx event -- carrying the SAME (conn, epoch)-keyed tid the event
    renders on, so --merge flow arrows anchor to the track that actually
    holds the post-resume spans."""
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": label}}]
    # (conn, epoch) -> tid: a session resume starts a NEW track so the
    # two incarnations' events never interleave on one line.
    epochs: dict = {}
    tid_map: dict = {}
    tid_label: dict = {0: "worker"}
    next_epoch_tid = [_EPOCH_TID_BASE + pid * 10_000]

    def tid_of(conn: int) -> int:
        if conn == 0:
            return 0
        e = epochs.get(conn, 0)
        t = tid_map.get((conn, e))
        if t is None:
            if e == 0:
                t = conn
                tid_label[t] = f"conn {conn}"
            else:
                t = next_epoch_tid[0]
                next_epoch_tid[0] += 1
                tid_label[t] = f"conn {conn} epoch {e}"
            tid_map[(conn, e)] = t
        return t

    open_spans: dict = {}  # (kind, tag) -> deque[(ts_us, conn, nbytes)]
    for t, ev, tag, conn, nbytes, reason, dur in events:
        ts = (t + ts_shift) * 1e6
        if ev == swtrace.EV_SESS_RESUME:
            epochs[conn] = epochs.get(conn, 0) + 1
        if ev in _POSTS:
            tid_of(conn)
            open_spans.setdefault((_POSTS[ev], tag), deque()).append(
                (ts, conn, nbytes))
        elif ev in _DONES or ev == swtrace.EV_OP_FAIL:
            if ev == swtrace.EV_OP_FAIL:
                # A failure terminates the op whose posted tag it carries
                # (exact match only -- see _pop_start).
                start = None
                for kind in ("recv", "send", "flush"):
                    start = _pop_start(open_spans, kind, tag,
                                       fifo_fallback=False)
                    if start is not None:
                        break
                name = f"FAIL tag={tag:#x}"
            else:
                kind = _DONES[ev]
                start = _pop_start(open_spans, kind, tag,
                                   fifo_fallback=(kind == "recv"))
                name = f"{kind} tag={tag:#x}" if kind != "flush" else "flush"
            if start is None:
                out.append({"ph": "i", "name": name, "ts": ts, "pid": pid,
                            "tid": tid_of(conn), "s": "t",
                            "args": {"nbytes": nbytes, "reason": reason}})
                continue
            ts0, conn0, nb0 = start
            out.append({"ph": "X", "name": name, "ts": ts0,
                        "dur": max(0.0, ts - ts0), "pid": pid,
                        "tid": tid_of(conn or conn0),
                        "args": {"nbytes": nbytes or nb0, "reason": reason}})
        elif ev == swtrace.EV_STAGE:
            out.append({"ph": "X", "name": reason or "stage",
                        "ts": ts - dur * 1e6, "dur": max(0.0, dur * 1e6),
                        "pid": pid, "tid": tid_of(conn), "cat": "stage",
                        "args": {"nbytes": nbytes}})
        else:  # recv_match, conn churn, e2e, clock, anything future
            if e2e_out is not None and ev == swtrace.EV_E2E:
                tcid, _, direction = reason.rpartition(":")
                # "sx"/"sr" are the striped-message markers (DESIGN.md
                # §17): one per message on the primary, ordinal = msg id,
                # so the pair survives chunks landing on many rails.
                if tcid and direction in ("tx", "rx", "sx", "sr"):
                    e2e_out.append((tcid, direction, int(tag), ts,
                                    tid_of(conn), nbytes))
            out.append({"ph": "i", "name": ev, "ts": ts, "pid": pid,
                        "tid": tid_of(conn), "s": "t",
                        "args": {"tag": tag, "nbytes": nbytes,
                                 "reason": reason}})
    # Spans still open at dump time (ops pending when the ring was read).
    for (kind, tag), dq in open_spans.items():
        for ts0, conn0, nb0 in dq:
            out.append({"ph": "i", "name": f"pending {kind} tag={tag:#x}",
                        "ts": ts0, "pid": pid, "tid": tid_of(conn0), "s": "t",
                        "args": {"nbytes": nb0}})
    for tid, name in sorted(tid_label.items()):
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": name}})
    return out


def to_chrome(dumps: Iterable[dict]) -> dict:
    """``{"traceEvents": [...]}`` from ``[{"worker", "events"}, ...]``
    dumps (the shape of swtrace.dump_all() and of flight-recorder files).
    """
    trace_events: list = []
    for pid, dump in enumerate(dumps, start=1):
        trace_events.extend(
            chrome_events(dump.get("worker", f"worker-{pid}"),
                          dump.get("events", []), pid))
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome(dumps: Iterable[dict], path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_chrome(dumps), indent=1))
    return path


# --------------------------------------------------------------- --merge
#
# Cross-process stitching (DESIGN.md §15).  Inputs are per-process dumps;
# each worker's EV_CLOCK samples carry "tcid:offset_us:err_us" (peer ~=
# local + offset) and each data frame left one EV_E2E per end with
# "tcid:tx|rx" and a per-conn wire ordinal, so (tcid, ordinal) pairs the
# two halves of every message with no per-frame wire bytes.


def _normalize_dump(raw: dict, fallback_name: str) -> list:
    """One loaded JSON file -> [{"pid", "worker", "events", "hists"}, ...]
    (``hists``: the §25 swpulse buckets a ring dump / flight dump carries
    next to its events; {} on older dumps)."""
    if "workers" in raw:  # swtrace.write_ring_dump shape
        return [{"pid": raw.get("pid"), "worker": w.get("worker", "worker"),
                 "events": w.get("events", []),
                 "hists": w.get("hists", {})} for w in raw["workers"]]
    if "events" in raw:   # flight-recorder / single-ring shape
        return [{"pid": raw.get("pid"), "worker": raw.get("worker",
                                                          fallback_name),
                 "events": raw["events"], "hists": raw.get("hists", {})}]
    raise ValueError("not a swtrace dump (no 'events' or 'workers' key)")


def _tcid_of(reason: str) -> str:
    return reason.split(":", 1)[0] if ":" in reason else ""


def _clock_deltas(procs: dict) -> tuple[dict, list]:
    """Per-process timeline shift (seconds, onto the first process's
    clock) from the EV_CLOCK sample graph.  Returns (deltas, edges) --
    edges for the summary; processes unreachable through any clock edge
    keep delta 0 (unaligned, better than dropped)."""
    # Best sample per (proc, tcid): smallest error wins.
    samples: dict = {}   # (proc, tcid) -> (off_us, err_us)
    members: dict = {}   # tcid -> set of procs that saw it
    for pkey, workers in procs.items():
        for w in workers:
            for t, ev, tag, conn, nbytes, reason, dur in w["events"]:
                if ev not in (swtrace.EV_CLOCK, swtrace.EV_E2E):
                    continue
                tcid = _tcid_of(reason)
                if not tcid:
                    continue
                members.setdefault(tcid, set()).add(pkey)
                if ev == swtrace.EV_CLOCK:
                    parts = reason.split(":")
                    if len(parts) != 3:
                        continue
                    try:
                        off, err = int(parts[1]), int(parts[2])
                    except ValueError:
                        continue
                    cur = samples.get((pkey, tcid))
                    if cur is None or err < cur[1]:
                        samples[(pkey, tcid)] = (off, err)
    # proc graph: an edge per (sampling proc, peer proc) pair.
    adj: dict = {p: [] for p in procs}
    edges = []
    for (pkey, tcid), (off, err) in samples.items():
        for peer in members.get(tcid, ()):  # the conn's other end
            if peer == pkey:
                continue
            # t_peer ~= t_local + off
            adj[pkey].append((peer, off * 1e-6))
            adj[peer].append((pkey, -off * 1e-6))
            edges.append({"tcid": tcid, "from": str(pkey), "to": str(peer),
                          "offset_us": off, "err_us": err})
    deltas = {p: 0.0 for p in procs}
    seen: set = set()
    for root in procs:  # first process anchors its component
        if root in seen:
            continue
        seen.add(root)
        queue = [root]
        while queue:
            p = queue.pop()
            for q, off in adj.get(p, ()):
                if q in seen:
                    continue
                seen.add(q)
                # An event stamped t on q's clock happened at t - off on
                # p's clock (off = t_q - t_p for one instant).
                deltas[q] = deltas[p] - off
                queue.append(q)
    return deltas, edges


def merge_chrome(named_dumps: list) -> dict:
    """``[(name, raw_dict), ...]`` (one per input file) -> one
    clock-aligned Chrome doc with flow-connected send->recv spans and a
    ``"swscope"`` summary block."""
    procs: dict = {}  # proc key -> [{"pid","worker","events"}, ...]
    for i, (name, raw) in enumerate(named_dumps):
        for w in _normalize_dump(raw, name):
            pkey = w["pid"] if w["pid"] is not None else f"file-{i}"
            procs.setdefault(pkey, []).append(w)
    deltas, edges = _clock_deltas(procs)

    trace_events: list = []
    # tcid -> dir -> worker pid -> {ordinal: (ts_us, tid, nbytes)}.
    # Keyed per END (worker pid) because a bidirectional conn carries an
    # independent ordinal sequence per direction per end: tx ordinal n
    # from end A pairs with rx ordinal n at the OTHER end only.
    e2e: dict = {}
    stage_durs: dict = {}
    pulse: dict = {}  # per-worker §25 percentile view carried through
    pid = 0
    for pkey, workers in procs.items():
        shift = deltas[pkey]
        for w in workers:
            pid += 1
            label = f"{pkey}/{w['worker']}"
            if w.get("hists"):
                pulse[label] = swtrace.hist_summary(w["hists"])
            sink: list = []
            trace_events.extend(
                chrome_events(label, w["events"], pid, ts_shift=shift,
                              e2e_out=sink))
            for tcid, direction, ordinal, ts_us, tid, nbytes in sink:
                e2e.setdefault(tcid, {}).setdefault(direction, {}) \
                   .setdefault(pid, {})[ordinal] = (ts_us, tid, nbytes)
            for t, ev, tag, conn, nbytes, reason, dur in w["events"]:
                if ev == swtrace.EV_STAGE and dur > 0:
                    stage_durs.setdefault(reason, []).append(dur)

    # Flow events: one arrow per (tcid, ordinal) recorded as tx at one
    # end and rx at a different end.
    flow_id = 0
    wire_lat: list = []
    wire_bytes = 0
    for tcid, dirs in sorted(e2e.items()):
      # Stream ordinals pair tx<->rx; striped msg-id ordinals pair the
      # sx<->sr markers -- independent namespaces on the same trace conn.
      for tx_dir, rx_dir in (("tx", "rx"), ("sx", "sr")):
        for tx_pid, txs in sorted(dirs.get(tx_dir, {}).items()):
            rxs: dict = {}  # ordinal -> (ts_us, rx_pid, tid)
            for rx_pid, m in dirs.get(rx_dir, {}).items():
                if rx_pid != tx_pid:  # never pair an end with itself
                    for ordinal, (ts_us, tid, _nb) in m.items():
                        rxs[ordinal] = (ts_us, rx_pid, tid)
            for ordinal, (tx_ts, tx_tid, nbytes) in sorted(txs.items()):
                rx = rxs.get(ordinal)
                if rx is None:
                    continue  # still in flight (or the rx ring wrapped)
                rx_ts, rx_pid, rx_tid = rx
                flow_id += 1
                trace_events.append({"ph": "s", "cat": "swscope",
                                     "name": "e2e", "id": flow_id,
                                     "ts": tx_ts, "pid": tx_pid,
                                     "tid": tx_tid})
                trace_events.append({"ph": "f", "bp": "e", "cat": "swscope",
                                     "name": "e2e", "id": flow_id,
                                     "ts": rx_ts, "pid": rx_pid,
                                     "tid": rx_tid})
                wire_lat.append((rx_ts - tx_ts) * 1e-6)
                wire_bytes += nbytes

    wire_lat.sort()
    summary = {
        "processes": len(procs),
        "clock_edges": edges,
        "pairs": len(wire_lat),
        "bytes_paired": wire_bytes,
        "wire_us": {
            "p50": percentile(wire_lat, 50) * 1e6 if wire_lat else 0.0,
            "p90": percentile(wire_lat, 90) * 1e6 if wire_lat else 0.0,
            "p99": percentile(wire_lat, 99) * 1e6 if wire_lat else 0.0,
        },
        "stage_us": {
            name: {"count": len(xs),
                   "p50": percentile(sorted(xs), 50) * 1e6,
                   "p90": percentile(sorted(xs), 90) * 1e6}
            for name, xs in sorted(stage_durs.items())
        },
        # §25 swpulse: each dump's distributions survive the merge as
        # their per-worker percentile view (hists ride write_ring_dump).
        "pulse": pulse,
    }
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "swscope": summary}


def _print_merge_summary(summary: dict) -> None:
    print(f"[swscope] {summary['processes']} process(es), "
          f"{summary['pairs']} send->recv pair(s), "
          f"{summary['bytes_paired']} payload bytes paired")
    for e in summary["clock_edges"]:
        print(f"  clock {e['from']} -> {e['to']}: offset "
              f"{e['offset_us']}us (+/-{e['err_us']}us) via {e['tcid']}")
    w = summary["wire_us"]
    if summary["pairs"]:
        print(f"  wire (send-done -> recv-done): p50={w['p50']:.1f}us "
              f"p90={w['p90']:.1f}us p99={w['p99']:.1f}us")
    for name, s in summary["stage_us"].items():
        print(f"  stage {name}: n={s['count']} p50={s['p50']:.1f}us "
              f"p90={s['p90']:.1f}us")
    if summary["pairs"] and summary["stage_us"]:
        # The gap between wire time and summed stage medians is the
        # serialization/scheduling slack the §12 pipeline can still hide.
        staged = sum(s["p50"] for s in summary["stage_us"].values())
        print(f"  wire-vs-stage: p50 wire {w['p50']:.1f}us vs "
              f"{staged:.1f}us summed stage p50s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m starway_tpu_torch.trace",
        description="Convert swtrace dumps to Chrome trace_event JSON "
                    "(open in Perfetto / chrome://tracing).  With --merge, "
                    "stitch per-process ring dumps into ONE clock-aligned "
                    "trace with send->recv flow arrows (swscope).")
    p.add_argument("inputs", nargs="+", type=Path,
                   help="flight-recorder dumps (STARWAY_FLIGHT_DIR) or "
                        "ring dumps (swtrace.write_ring_dump)")
    p.add_argument("-o", "--output", type=Path, default=Path("swtrace.json"))
    p.add_argument("--merge", action="store_true",
                   help="treat inputs as dumps from different processes: "
                        "align clocks via EV_CLOCK samples and connect "
                        "EV_E2E ordinal pairs with Chrome flow events")
    args = p.parse_args(argv)
    named = []
    for path in args.inputs:
        raw = json.loads(path.read_text())
        if "events" not in raw and "workers" not in raw:
            print(f"{path}: not a swtrace dump (no 'events'/'workers' key)",
                  file=sys.stderr)
            return 1
        named.append((path.stem, raw))
    args.output.parent.mkdir(parents=True, exist_ok=True)
    if args.merge:
        doc = merge_chrome(named)
        args.output.write_text(json.dumps(doc, indent=1))
        _print_merge_summary(doc["swscope"])
        n = len(doc["traceEvents"])
        print(f"wrote {args.output} ({n} events from {len(named)} dump(s))")
        return 0
    dumps = []
    for name, raw in named:
        dumps.extend(_normalize_dump(raw, name))
    out = write_chrome(dumps, args.output)
    n = sum(len(d.get("events", [])) for d in dumps)
    print(f"wrote {out} ({n} events from {len(dumps)} dump(s))")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
