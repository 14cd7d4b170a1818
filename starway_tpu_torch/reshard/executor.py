"""swshard executor: run a compiled Plan over the Client/Server fabric.

The executor is deliberately dumb: the :class:`~.plan.Plan` already fixed
*what* moves, *when* (rounds), and *under which tag*; this module just
drives one participant's share of it over duck-typed **ports** (anything
with ``asend(buf, tag)`` / ``arecv(buf, tag, mask)`` / ``aflush()`` --
parallel/dp_exchange.py's ``ClientPort``/``ServerPort`` fit as-is), with
a **flush barrier between rounds** so the §20 staging bound holds: at
any instant one host stages at most one outgoing and one incoming
transfer (<= 2 x plan.budget = O(shard)), plus at most one early-arrived
transfer in the matcher's unexpected queue when a peer runs a round
ahead.

Data moves as flat uint8 host buffers by default; the jax adapter
(reshard/api.py) swaps in device payloads/sinks through the optional
``make_payload``/``make_sink``/``consume_sink`` hooks, which is how a
schedule rides the device plane (and devpull, when the conn negotiated
it) without this module importing jax -- the same duck-typed boundary
core/ keeps with device.py (analysis rule ``layering-reshard``).

Observability: each executed round records a ``reshard_round`` stage
span (perf.record_stage -> EV_STAGE when tracing is armed), the
process-global ``reshard_bytes``/``reshard_rounds`` counters advance
(core/swtrace.py GLOBAL -- overlaid onto every worker snapshot like the
staging-pool counters), and live staging occupancy is exported through
the ``reshard_staging_bytes``/``reshard_staging_peak`` gauges
(core/telemetry.py merge_global_gauges).
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Callable, Mapping, Optional

from .plan import Plan, box_nbytes

__all__ = ["execute", "staging_snapshot", "reset_staging_peak", "FULL_MASK"]

FULL_MASK = (1 << 64) - 1


# ------------------------------------------------------- staging accounting
#
# Process-global (schedules may run on several event loops at once): the
# live bytes all in-flight transfers have staged, plus the high-water
# mark -- the gauge the §20 acceptance bound is asserted against.

class _Staging:
    def __init__(self):
        self._lock = threading.Lock()
        self.now = 0
        self.peak = 0

    def add(self, n: int) -> None:
        with self._lock:
            self.now += n
            if self.now > self.peak:
                self.peak = self.now

    def sub(self, n: int) -> None:
        with self._lock:
            self.now -= n


_staging = _Staging()


def staging_snapshot() -> dict:
    """{"now": bytes, "peak": bytes} across every schedule this process
    has executed (telemetry overlays these as reshard_staging_*)."""
    with _staging._lock:
        return {"now": _staging.now, "peak": _staging.peak}


def reset_staging_peak() -> None:
    """Reset the high-water mark (bench/test isolation)."""
    with _staging._lock:
        _staging.peak = _staging.now


# ----------------------------------------------------------------- executor


def _default_payload(transfer, plan: Plan, read_box: Callable):
    """Host path: one flat uint8 buffer, pieces concatenated in order."""
    import numpy as np

    buf = np.empty(transfer.nbytes, dtype=np.uint8)
    off = 0
    for p in transfer.pieces:
        nb = box_nbytes(p.box, plan.itemsize)
        buf[off:off + nb] = read_box(p.box)
        off += nb
    return buf


def _default_sink(transfer, plan: Plan):
    import numpy as np

    return np.empty(transfer.nbytes, dtype=np.uint8)


def _default_consume(transfer, plan: Plan, sink, write_box: Callable) -> None:
    import numpy as np

    view = memoryview(np.ascontiguousarray(sink)).cast("B")
    off = 0
    for p in transfer.pieces:
        nb = box_nbytes(p.box, plan.itemsize)
        write_box(p.box, view[off:off + nb])
        off += nb


async def execute(plan: Plan, rank: int, ports: Mapping,
                  read_box: Callable, write_box: Callable, *,
                  tag_of: Optional[Callable] = None,
                  make_payload: Optional[Callable] = None,
                  make_sink: Optional[Callable] = None,
                  consume_sink: Optional[Callable] = None,
                  round_timeout: Optional[float] = None) -> dict:
    """Run ``rank``'s share of ``plan`` over ``ports`` ({rank: port}).

    ``read_box(box) -> flat uint8 buffer`` supplies local source bytes
    (global coordinates); ``write_box(box, view)`` lands received (or
    locally copied) bytes.  ``tag_of(transfer) -> int`` maps a transfer
    to its wire tag (default: the raw ``tag_off`` -- pass a
    :class:`~.tags.TagLease`'s ``data_tag`` for collision-free tags).
    ``round_timeout`` bounds each round's completion (a dead peer then
    surfaces as that round's failure instead of a hang).  A timed-out
    round may leave receives posted in the matcher (the §10 contract:
    peer death leaves posted recvs pending) -- retry a failed schedule
    on a FRESH lease, never by re-leasing the same slot, so orphaned
    receives can't steal the retry's transfers (tags.lease() rotates
    auto-assigned slots for exactly this reason).

    Returns ``{"rounds": executed, "tx_bytes": ..., "rx_bytes": ...,
    "peak_staging": ..., "seconds": ...}`` -- ``peak_staging`` is THIS
    invocation's own staging high-water (the process-global gauge
    aggregates every concurrent schedule and role).
    """
    from .. import perf
    from ..core import swtrace

    tag_fn = tag_of if tag_of is not None else (lambda t: t.tag_off)
    pay_fn = make_payload or (lambda t: _default_payload(t, plan, read_box))
    sink_fn = make_sink or (lambda t: _default_sink(t, plan))
    eat_fn = consume_sink or (
        lambda t, s: _default_consume(t, plan, s, write_box))

    # Local copies first: they share no round budget (no staging, no
    # wire) and unblock nothing -- but doing them up front means a
    # schedule with zero network pieces completes without touching ports.
    for p in plan.local_pieces.get(rank, ()):
        write_box(p.box, read_box(p.box))

    t_start = time.perf_counter()
    tx_bytes = rx_bytes = 0
    executed = 0
    my_peak = 0  # THIS invocation's staging high-water (the global
    #              gauge aggregates every concurrent schedule/role)
    for rnd in range(plan.rounds):
        sends = plan.sends_for(rank, rnd)
        recvs = plan.recvs_for(rank, rnd)
        if not sends and not recvs:
            continue
        t0 = time.perf_counter()
        rnd_bytes = sum(t.nbytes for t in sends + recvs)
        my_peak = max(my_peak, rnd_bytes)
        _staging.add(rnd_bytes)
        try:
            # Payloads and sinks are materialised BEFORE anything is
            # posted: a payload-build failure (a box no local shard
            # covers, an allocator error) must surface with zero ops in
            # flight -- a receive posted ahead of a failed build would
            # strand in the matcher holding its sink, and a retried
            # schedule reusing the tag would feed it (the contract:
            # nothing posted unless the whole round's inputs exist).
            payloads = [(t, pay_fn(t)) for t in sends]
            sinks = [(t, sink_fn(t)) for t in recvs]
            ops = []
            # Receives first: posted before the payload can arrive in the
            # common case, keeping early-round traffic off the
            # unexpected queue (§18's matched fast path).
            ops.extend(ports[t.src].arecv(sink, tag_fn(t), FULL_MASK)
                       for t, sink in sinks)
            ops.extend(ports[t.dst].asend(buf, tag_fn(t))
                       for t, buf in payloads)
            gathered = asyncio.gather(*ops)
            if round_timeout is not None:
                await asyncio.wait_for(gathered, round_timeout)
            else:
                await gathered
            # Flush barrier: sends are only LOCALLY complete -- the
            # barrier promises delivery, which is what licenses dropping
            # the staged payloads and starting the next round.
            flushed = set()
            for t in sends:
                if id(ports[t.dst]) not in flushed:
                    flushed.add(id(ports[t.dst]))
                    await ports[t.dst].aflush()
            for t, sink in sinks:
                eat_fn(t, sink)
            del payloads, sinks
        finally:
            _staging.sub(rnd_bytes)
        tx_bytes += sum(t.nbytes for t in sends)
        rx_bytes += sum(t.nbytes for t in recvs)
        executed += 1
        dt = time.perf_counter() - t0
        perf.record_stage("reshard_round", dt, rnd_bytes)
        swtrace.GLOBAL.reshard_rounds += 1
        swtrace.GLOBAL.reshard_bytes += rnd_bytes
    return {
        "rounds": executed,
        "tx_bytes": tx_bytes,
        "rx_bytes": rx_bytes,
        "peak_staging": my_peak,
        "seconds": time.perf_counter() - t_start,
    }
