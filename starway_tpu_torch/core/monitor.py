"""swrefine runtime conformance monitor (DESIGN.md §22).

The thin in-process half of the swrefine plane: with ``STARWAY_MONITOR=1``
every traced worker's protocol-event channel (swtrace ``EV_PROTO``;
emitted identically by both engines) is replayed through the protocol
monitor automaton that ``analysis/refine.py`` compiles from the engines'
own extracted state machines -- the same automaton the static gate runs
against the checked-in event corpus.  A divergence here means the running
engine and the verified model disagree: it is recorded, the §13 flight
recorder dumps, and ``assert_clean()`` fails the run hard (the chaos
soaks call it every run; ``swtrace.retire`` checks each worker
automatically at close).

This module is deliberately tiny: the automaton, the event grammar, and
the replay semantics live in ``starway_tpu_torch.analysis.refine`` (stdlib-only,
imported lazily and only when the monitor is armed) so the gate and the
runtime can never drift apart -- one monitor, two drivers.  Off path
(env unset): nothing here is ever imported by the data plane.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from .. import config

logger = logging.getLogger("starway_tpu_torch")

_lock = threading.Lock()
_violations: list = []
_seen_keys: set = set()  # dedup: retire-checked rings reappear in check_all
_witnessed: set = set()
_monitor = None  # compiled refine.Monitor, or False once compile failed


def active() -> bool:
    return config.monitor_enabled()


def _compiled():
    """The compiled monitor automaton (one per process; the model is
    static).  Compile failure disables checking for the process -- the
    monitor must never take a soak down with a tooling error -- but is
    loudly logged (a silent None would be a vacuous pass)."""
    global _monitor
    with _lock:
        if _monitor is None:
            try:
                from ..analysis import refine

                mon, problems = refine.compile_monitor(runtime=True)
                for p in problems:
                    logger.warning("starway: monitor compile: %s", p)
                _monitor = mon if mon is not None else False
            except Exception as e:  # pragma: no cover - tooling failure
                logger.error("starway: protocol monitor unavailable: %s", e)
                _monitor = False
        return _monitor or None


def check_events(events, label: str = "") -> list:
    """Replay one ring's events (swtrace 7-tuples) through the monitor;
    record and return any violations.  Safe on non-proto rings (no
    EV_PROTO events = nothing to check)."""
    mon = _compiled()
    if mon is None:
        return []
    viols, seen = mon.replay(events, label=label)
    fresh = []
    with _lock:
        _witnessed.update(seen)
        for v in viols:
            # One divergence, one record: a ring checked at worker
            # retirement shows up again in check_all()'s dump_all sweep.
            key = (v.label, v.conn, v.index, v.cls, v.message)
            if key not in _seen_keys:
                _seen_keys.add(key)
                _violations.append(v)
                fresh.append(v)
    for v in fresh:
        logger.error("starway: protocol monitor violation: %s", v.render())
    return fresh


def check_worker(worker, events=None) -> list:
    """Replay one worker's ring; on violation, dump the §13 flight
    recorder so the divergence ships with its surrounding evidence."""
    if not active():
        return []
    if events is None:
        try:
            events = worker.trace_events()
        except Exception:
            return []
    label = getattr(worker, "trace_label", "worker")
    viols = check_events(events, label=label)
    if viols:
        from . import swtrace

        worker._faulted = True
        swtrace.flight_dump("monitor-violation", worker, viols[0].render())
    return viols


def check_all() -> list:
    """Replay every traced ring this process has seen (live + retired) --
    the chaos soaks' per-run conformance checkpoint."""
    if not active():
        return []
    from . import swtrace

    out = []
    for dump in swtrace.dump_all():
        out.extend(check_events(dump["events"], label=dump["worker"]))
    return out


def violations() -> list:
    with _lock:
        return list(_violations)


def witnessed() -> set:
    """Model transitions witnessed by every ring checked so far (the
    runtime side of refine's transition-coverage accounting)."""
    with _lock:
        return set(_witnessed)


def assert_clean() -> None:
    """Fail hard on any recorded violation (soaks call this last)."""
    viols = violations()
    if viols:
        raise AssertionError(
            "protocol monitor violations:\n"
            + "\n".join(v.render() for v in viols))


def reset() -> None:
    """Drop recorded state (test isolation).  The compiled automaton is
    kept -- the model does not change within a process."""
    with _lock:
        _violations.clear()
        _seen_keys.clear()
        _witnessed.clear()
