"""swscope telemetry viewer: ``python -m starway_tpu_torch.metrics <path|addr>``.

Renders the sampler's JSONL stream (core/telemetry.py; armed via
``STARWAY_METRICS_INTERVAL`` / ``STARWAY_METRICS_PATH`` /
``STARWAY_METRICS_ADDR``) as a top-like live table: one row per
(worker, conn) with the per-conn gauges, plus per-worker counter rates
computed between consecutive samples.

Sources:

* a **path** -- the ``STARWAY_METRICS_PATH`` JSONL file; followed
  tail -f style (default) or summarized once (``--once``, also the mode
  tests drive).
* an **addr** -- ``host:port`` of a live sampler feed
  (``STARWAY_METRICS_ADDR``); samples render as they arrive.
"""

from __future__ import annotations

import argparse
import json
import re
import socket
import sys
import time
from pathlib import Path
from typing import Iterator, Optional

_ADDR_RE = re.compile(r"^[\w.\-]*:\d+$")

# Counters whose per-second rate is worth a column (the rest are visible
# in evaluate_perf_detail / flight dumps).
_RATE_COUNTERS = ("sends_completed", "recvs_completed", "bytes_tx",
                  "bytes_rx", "sessions_resumed")


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


def _fmt_us(n: float) -> str:
    if n < 1000:
        return f"{n:.0f}us"
    if n < 1e6:
        return f"{n / 1e3:.1f}ms"
    return f"{n / 1e6:.1f}s"


def _hist_lines(wk: dict) -> list:
    """swpulse percentile rows (DESIGN.md §25): one line per histogram
    that has samples.  ``hists`` carries the telemetry-sample percentile
    shape (hist_summary); `_us` names render as durations, the rest as
    sizes."""
    lines = []
    for name, h in sorted(wk.get("hists", {}).items()):
        count = int(h.get("count", 0))
        if not count:
            continue
        fmt = _fmt_us if name.endswith("_us") else _fmt_bytes
        lines.append(
            f"    {name}: n={count} " + " ".join(
                f"{p}={fmt(h.get(p, 0))}"
                for p in ("p50", "p90", "p99", "p999")))
    return lines


def render(sample: dict, prev: Optional[dict] = None) -> str:
    """One sample -> a text block (rates need the previous sample)."""
    lines = [time.strftime("%H:%M:%S", time.localtime(sample.get("t", 0)))
             + f"  ({len(sample.get('workers', {}))} worker(s))"]
    dt = 0.0
    if prev is not None:
        dt = float(sample.get("mono", 0)) - float(prev.get("mono", 0))
    for label, wk in sorted(sample.get("workers", {}).items()):
        ctr = wk.get("counters", {})
        parts = [f"  {label}:"]
        if prev is not None and dt > 0:
            pctr = prev.get("workers", {}).get(label, {}).get("counters", {})
            for name in _RATE_COUNTERS:
                rate = (ctr.get(name, 0) - pctr.get(name, 0)) / dt
                if rate:
                    val = (_fmt_bytes(rate) + "/s" if name.startswith("bytes")
                           else f"{rate:.0f}/s")
                    parts.append(f"{name}={val}")
        else:
            for name in _RATE_COUNTERS:
                if ctr.get(name):
                    parts.append(f"{name}={ctr[name]}")
        stalls = ctr.get("stall_alerts", 0)
        if stalls:
            parts.append(f"STALL_ALERTS={stalls}")
        gauges = wk.get("gauges", {})
        posted = gauges.get("posted_recvs", 0)
        if posted:
            parts.append(f"posted_recvs={posted}")
        pool = gauges.get("staging_pool_bytes", 0)
        if pool:
            parts.append(f"staging_pool={_fmt_bytes(pool)}")
        lines.append(" ".join(parts))
        lines.extend(_hist_lines(wk))
        for cid, g in sorted(gauges.get("conns", {}).items(),
                             key=lambda kv: str(kv[0])):
            busy = {k: v for k, v in g.items() if v}
            cols = " ".join(
                f"{k}={_fmt_bytes(v) if 'bytes' in k else v}"
                for k, v in busy.items()) or "idle"
            lines.append(f"    conn {cid}: {cols}")
    return "\n".join(lines)


def _iter_path(path: Path, follow: bool) -> Iterator[dict]:
    with open(path) as f:
        while True:
            line = f.readline()
            if line:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue
            elif follow:
                # swcheck: allow(blocking-call): viewer CLI tails on its own app thread, no engine in-process
                time.sleep(0.2)
            else:
                return


def _iter_addr(addr: str) -> Iterator[dict]:
    host, _, port = addr.rpartition(":")
    # swcheck: allow(blocking-call): viewer CLI dials the feed on its own app thread and may wait for it
    with socket.create_connection((host or "127.0.0.1", int(port))) as s:
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if line.strip():
                    try:
                        yield json.loads(line)
                    except ValueError:
                        continue


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m starway_tpu_torch.metrics",
        description="Top-like viewer for swscope telemetry samples "
                    "(STARWAY_METRICS_PATH JSONL, or the live "
                    "STARWAY_METRICS_ADDR feed).")
    p.add_argument("source",
                   help="JSONL sample file, or host:port of a live feed")
    p.add_argument("--once", action="store_true",
                   help="read everything available, print the latest "
                        "sample + run summary, and exit (no follow)")
    args = p.parse_args(argv)

    is_addr = bool(_ADDR_RE.match(args.source))
    if is_addr:
        samples: Iterator[dict] = _iter_addr(args.source)
        follow = not args.once
    else:
        path = Path(args.source)
        if not path.exists():
            print(f"{path}: no such file", file=sys.stderr)
            return 1
        follow = not args.once
        samples = _iter_path(path, follow)

    prev = None
    history: list = []
    try:
        for sample in samples:
            if follow:
                sys.stdout.write("\x1b[2J\x1b[H" + render(sample, prev) + "\n")
                sys.stdout.flush()
            else:
                history.append(sample)
                if is_addr:
                    # A live feed never EOFs: --once means one snapshot.
                    break
            prev = sample
    except KeyboardInterrupt:
        pass
    if args.once:
        if not history:
            print("no samples", file=sys.stderr)
            return 1
        before = history[-2] if len(history) > 1 else None
        print(render(history[-1], before))
        from .core.telemetry import summarize

        summary = summarize(history)
        print(f"-- {len(history)} sample(s); peak tx depth "
              f"{summary['peak_tx_queue_depth']}, peak journal "
              f"{_fmt_bytes(summary['peak_journal_bytes'])}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
