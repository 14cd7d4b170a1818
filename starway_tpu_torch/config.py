"""Environment-driven configuration.

The reference is configured purely through environment variables and CLI flags
(reference: SURVEY.md section 5 "Config / flag system"; src/starway/__init__.py:14,
benchmark.md:114-126 for ``UCX_TLS``).  The TPU build mirrors that shape:

``STARWAY_TLS``
    Comma-separated transport preference list, analogous to ``UCX_TLS``.
    Known transports: ``inproc`` (same-process fast path, what ICI device
    transfers ride on), ``sm`` (same-host shared-memory rings negotiated
    over the TCP handshake, see core/shmring.py -- the analogue of UCX's
    posix/sysv shm transport), ``tcp`` (cross-process / DCN bootstrap
    path), ``ici`` / ``dcn`` (accepted for the JAX package's device
    plane; the torch device plane selects nothing by them).  Default:
    all enabled.

``STARWAY_SM_RING``
    Per-direction shared-memory ring size in bytes (rounded up to a power
    of two; default 1 MiB -- sized to stay cache-resident, see
    core/shmring.py).

``STARWAY_HOST``
    Routable host address advertised in worker-address blobs (default
    ``127.0.0.1``).

``STARWAY_RNDV_THRESHOLD``
    Payload size in bytes above which sends switch from eager (local
    completion = fully handed to the transport) to rendezvous-style streaming
    (local completion = transmission begun; delivery requires ``aflush``).
    Mirrors UCX eager/RNDV split (reference: src/bindings/main.cpp:954-980).

``STARWAY_NATIVE``
    "1" (default) = use the C++ engine extension when built, "0" = force the
    pure-Python engine.

``STARWAY_BACKEND``
    Device-plane backend: ``auto`` (default), ``tpu``, or ``cpu``.

``STARWAY_DEVPULL``
    "1" (default) = negotiate the PJRT transfer-server pull path for device
    payloads crossing processes (device-to-device, no host staging --
    see device.py TransferManager); "0" = always stage via the framed
    stream.

``STARWAY_DEVPULL_MIN``
    Minimum device payload size in bytes to use the pull path (default
    65536); smaller payloads ride the framed stream, where one small copy
    beats a pull round-trip.

``STARWAY_DECODE_STREAM``
    "1" (default) = the decode-attention kernel's streaming variant
    (double-buffered manual DMA, ops/pallas_decode.py); "0" = the
    grid-pipelined variant — the escape hatch if the manual-DMA lowering
    misbehaves on a backend it has not been measured on.

``STARWAY_SM_FORCE_ATOMICS``
    "1" = route the Python sm ring's cursor ops through the native lib's
    acquire/release atomics even on x86 (the off-x86 code path, made
    testable on x86 CI; see core/shmring.py).

``STARWAY_CHUNK``
    Data-plane pipelining granularity in bytes (default 256 KiB; 0
    disables pipelining).  Device payloads crossing the framed stream are
    staged device-to-host one chunk at a time so the D2H of chunk k+1
    overlaps the transport write of chunk k, and receive-side host-to-
    device placement of completed chunks overlaps the remaining stream
    reads (DESIGN.md §12).  Also sizes the reusable host staging-buffer
    pool that replaces per-transfer allocation.

``STARWAY_CONNECT_TIMEOUT``
    Per-attempt connect + handshake deadline in seconds (default 3.0).
    Both engines honour it; ``aconnect(..., timeout=)`` overrides it per
    call on the Python engine.  Mirrors UCX's ``UCX_..._TIMEOUT`` knobs
    replacing what used to be a hard-coded constant in core/engine.py.

``STARWAY_KEEPALIVE``
    Peer-liveness keepalive interval in seconds (default 0 = disabled,
    matching the reference contract "peer death leaves posted recvs
    pending").  When > 0 and both peers negotiated ``"ka": "ok"`` in the
    handshake, each engine PINGs idle peers every interval and declares a
    peer dead after ``STARWAY_KEEPALIVE_MISSES`` silent intervals: the
    conn is torn down, its in-flight matcher state purged, and pending
    receives fail with the stable ``"not connected"`` keyword.  The
    analogue of UCX's ``UCX_KEEPALIVE_INTERVAL`` / err-handling mode.

``STARWAY_KEEPALIVE_MISSES``
    Silent keepalive intervals tolerated before a peer is declared dead
    (default 3).

``STARWAY_SESSION``
    "1" = negotiate the resilient-session layer (off by default for seed
    parity).  Session-enabled Client<->Server pairs survive connection
    death mid-transfer: HELLO carries a stable session id + epoch, every
    eager DATA/ctl frame is sequence-numbered (frames.py T_SEQ), receivers
    ACK cumulatively (T_ACK) and drop duplicate seqs, senders keep a
    bounded replay journal of unacked frames, and on conn death the client
    transparently redials (exponential backoff) and both sides replay from
    the peer's cumulative ACK -- in-flight asend/arecv/aflush complete
    late instead of failing.  Only session expiry
    (``STARWAY_SESSION_GRACE`` exceeded, or the peer answers the resume
    handshake with a new epoch) fails them, with the stable
    ``"session expired"`` reason.  See DESIGN.md §14.

``STARWAY_SESSION_JOURNAL_BYTES``
    Replay-journal cap per connection direction in bytes (default 16 MiB).
    When unacknowledged journaled frames reach the cap, further sends
    *block* (they park unframed and drain as ACKs free space) instead of
    growing the journal without bound.

``STARWAY_SESSION_GRACE``
    Seconds a dead session-enabled connection may stay resumable (default
    30).  Past the grace window the session expires: suspended ops fail
    with ``"session expired"`` and the seed failure contract applies from
    then on.

``STARWAY_RAILS``
    Number of parallel transport lanes ("rails") a client opens to each
    server (default 1).  With N > 1 the primary HELLO offers
    ``"rails": "<N>"``; a striping-capable acceptor confirms
    ``"rails": "ok"`` and the connector dials N-1 extra TCP conns, each
    attached to the primary endpoint via the ``"rail_of"`` handshake key
    (no new server endpoint is created).  Rails are the stripe targets of
    the multi-rail data plane (DESIGN.md §17); an old peer simply never
    confirms and the extra dials are skipped -- all pairings interoperate.
    On a same-host sm-upgraded primary the extra rails stay on TCP, so
    one message can ride sm and tcp concurrently.

``STARWAY_STRIPE_THRESHOLD``
    Payload size in bytes at or above which a send on a railed connection
    is striped: split at ``STARWAY_STRIPE_CHUNK`` granularity, the chunks
    dispatched across every live rail with completion-driven work
    stealing, and reassembled by offset at the receiver (wire frame
    T_SDATA, core/frames.py).  Default 0 = striping off (seed parity:
    every send rides exactly one lane).  Striped sends use rendezvous
    local-completion semantics regardless of size and the payload is
    pinned by reference until the receiver's T_SACK -- delivery, as
    always, is promised only by ``aflush``.

``STARWAY_STRIPE_CHUNK``
    Stripe granularity in bytes (default: 4x the ``STARWAY_CHUNK`` §12
    staging granularity = 1 MiB, the measured sweet spot on the 1-core
    dev box -- smaller chunks pay a sendmsg per chunk, larger ones
    starve the work stealing; floor 4 KiB).  Each chunk is an
    independent self-describing frame (msg id, offset, total), which is
    what makes chunk-level work stealing, rail-death redistribution, and
    receiver-side offset dedup possible.

``STARWAY_STRIPE_WEIGHTED``
    "1" = lane-weighted tail claiming (default off).  The stripe
    scheduler always tracks a per-lane EWMA of delivered throughput
    (bytes of each completed chunk over its claim-to-written wall time);
    with the knob armed, a lane whose EWMA has fallen below half the
    fastest live lane's *declines to steal one of the last chunks* of a
    message (the tail, where a slow lane's final chunk IS the message's
    completion time), leaving it for a faster lane's next refill.
    Dispatch-time claims are never declined, so a chunk can never
    strand: the fastest live lane never declines, and every requeue path
    re-feeds all lanes unconditionally.  Both engines implement the
    identical policy.  See DESIGN.md §17.

``STARWAY_FC_WINDOW``
    Receiver-driven flow-control window in bytes (default 0 = off, seed
    parity).  When > 0 the handshake offers ``"fc": "<bytes>"`` and, once
    both peers confirm, each direction's eager traffic is governed by the
    RECEIVER's advertised window: the sender debits it per eager DATA
    payload, parks sends unframed-FIFO when it runs dry (block, never
    OOM; one oversized frame is admitted against an idle window so a
    single payload above the window cannot deadlock), and the receiver
    returns T_CREDIT grants as unexpected messages are matched or
    drained.  Sends above ``STARWAY_RNDV_THRESHOLD`` switch to the
    receiver-pulled RTS/CTS path and never consume window.  A parked
    send with a ``timeout=`` deadline is shed locally with the stable
    ``"timed out"`` reason (overload degrades to op timeouts, not conn
    or process death).  See DESIGN.md §18.

``STARWAY_UNEXP_BYTES``
    Per-connection ceiling on unexpected-queue payload bytes (default
    0 = unbounded, seed parity).  A last-resort overload breaker for
    peers that never negotiated ``fc``: a connection whose own
    un-granted spill crosses the cap is reset instead of letting the
    process OOM (total residency is bounded by cap x live conns, and
    the offender -- never an innocent peer -- takes the reset).  With
    ``fc`` negotiated the credit window keeps well-behaved peers under
    the cap.

``STARWAY_INTEGRITY``
    "1" = negotiate the end-to-end data-integrity plane (off by default
    for seed parity: no ``"csum"`` handshake key, no T_CSUM/T_SNACK
    frames, byte-stream sm rings).  Once both peers confirm ``csum``,
    every framed message is preceded by a T_CSUM frame carrying a CRC32C
    over the frame's header+payload (plus a header-only CRC so routing
    fields are validated before the payload streams into user buffers),
    and sm ring writes become per-slot records with a seqno+checksum
    trailer so torn/partial writes are detected at dequeue.  Verification
    failures are *recoverable*: a corrupt striped T_SDATA chunk is NACKed
    (T_SNACK) and only that chunk retransmits; a corrupt non-striped
    frame poisons the conn with the stable ``"corrupt"`` reason -- which
    without sessions takes the §10 failure contract and with
    ``STARWAY_SESSION=1`` suspends + replays so ops still complete
    exactly-once with verified bytes.  See DESIGN.md §19.

``STARWAY_TRACE``
    "1" = record per-op lifecycle events (posted/matched/completed/
    failed, stage spans, connection churn) into a bounded per-worker ring
    in BOTH engines (core/swtrace.py, native sw_trace).  Default off:
    the hot path then carries a single ``is None`` check per op -- no
    allocation, no syscall.  Export with ``python -m starway_tpu_torch.trace``
    or ``python -m starway_tpu_torch.bench --trace PATH`` (Chrome/Perfetto).

``STARWAY_PROTO_TRACE``
    "1" = additionally record the swrefine protocol-event channel
    (DESIGN.md §22) into the same ring, in BOTH engines: one ``EV_PROTO``
    event per dispatched inbound frame (``rx:<FRAME>``), per ctl-plane
    frame handed to a transport (``tx:<FRAME>``), plus the conn lifecycle
    (``st:hello-sent``/``st:estab`` at creation, ``lost``/``resume``/
    ``expire``/``down``).  ``python -m starway_tpu_torch.analysis refine
    --replay <ring dump>`` replays the channel through the protocol
    monitor automaton compiled from the engines' own state machines.
    Default off; setting it arms the trace ring even without
    STARWAY_TRACE.  The seed path (env unset) emits zero protocol events
    -- one ``is None`` check per frame, pinned by test.

``STARWAY_MONITOR``
    "1" = runtime conformance checking (swrefine, DESIGN.md §22): implies
    STARWAY_PROTO_TRACE, and every traced worker's protocol events are
    replayed through the monitor automaton in-process at worker
    retirement (plus on demand via ``core.monitor.check_all()`` -- the
    chaos soaks call it every run).  A violation records the divergence,
    dumps the §13 flight recorder, and fails the soak hard
    (``monitor.assert_clean()``).  Default off.

``STARWAY_TRACE_RING``
    Trace ring capacity in events per worker (default 4096; min 16).

``STARWAY_FLIGHT_DIR``
    Directory for flight-recorder dumps.  When set, the first op failure
    with a non-cancel reason, an engine emergency close, and a close
    after a fault each dump the worker's last-N trace events + counter
    snapshot as JSON there (post-mortem forensics, DESIGN.md §13).
    Setting it implicitly arms the trace ring even without STARWAY_TRACE.

``STARWAY_METRICS_INTERVAL``
    swscope live-telemetry sampling period in seconds (default 0 =
    sampler off, DESIGN.md §15).  When > 0, a daemon thread snapshots
    every worker's counter registry plus the per-conn gauges (TX queue
    depth/bytes, in-flight sends/recvs, session journal residency,
    staging-pool occupancy -- core/telemetry.py GAUGE_NAMES; native side
    via the ``sw_gauges`` ABI call) into a bounded ring of timestamped
    samples, surfaced through ``evaluate_perf_detail()["telemetry"]``
    and flight-recorder dumps.  The off path adds no per-op work: the
    sampler is a background thread, armed per worker at construction.

``STARWAY_METRICS_PATH``
    JSONL file the sampler appends each sample to (one JSON object per
    line).  Setting it arms the sampler even without
    STARWAY_METRICS_INTERVAL (at the 1 s default period).  View live or
    post-hoc with ``python -m starway_tpu_torch.metrics <path>``.

``STARWAY_METRICS_ADDR``
    ``host:port`` for the sampler's live feed listener: each connecting
    viewer (``python -m starway_tpu_torch.metrics host:port``) receives the
    JSONL sample stream as it is produced.  Also arms the sampler.

``STARWAY_METRICS_RING``
    In-memory telemetry sample ring capacity (default 512; min 16).
"""

from __future__ import annotations

import os

__all__ = [
    "transports_enabled",
    "advertised_host",
    "rndv_threshold",
    "chunk_bytes",
    "use_native",
    "device_backend",
    "devpull_enabled",
    "devpull_threshold",
    "decode_stream_enabled",
    "connect_timeout",
    "keepalive_interval",
    "keepalive_misses",
    "session_enabled",
    "session_journal_bytes",
    "session_grace",
    "stripe_rails",
    "stripe_threshold",
    "stripe_chunk",
    "stripe_weighted",
    "fc_window",
    "unexp_cap",
    "integrity_enabled",
    "trace_enabled",
    "proto_trace_enabled",
    "monitor_enabled",
    "trace_ring_size",
    "flight_dir",
    "metrics_interval",
    "metrics_path",
    "metrics_addr",
    "metrics_ring_size",
    "stall_ms",
]


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def transports_enabled() -> list[str]:
    raw = _env("STARWAY_TLS", "inproc,sm,tcp,ici,dcn")
    return [t.strip() for t in raw.split(",") if t.strip()]


def inproc_enabled() -> bool:
    return "inproc" in transports_enabled()


def sm_enabled() -> bool:
    # The pure-Python ring relies on x86-TSO store ordering for its
    # data-before-tail publication (core/shmring.py); ARM permits
    # store-store reordering and Python cannot fence.  Off x86 the ring
    # routes every cursor access through the native lib's acquire/release
    # atomics instead (shmring._use_portable_atomics) -- sm is only
    # refused when that lib is unavailable too.  CPython is still required
    # either way: the ring's data copies go through memoryview slices
    # whose program-order guarantees a JIT (PyPy, future CPython tiers)
    # may not preserve.  (The C++ engine uses real atomics throughout and
    # carries sm on any architecture/runtime.)
    import platform

    if platform.python_implementation() != "CPython":
        return False
    if "sm" not in transports_enabled():
        return False
    if platform.machine() not in ("x86_64", "AMD64"):
        from .core import native

        # build=False: this probe sits on the connection-setup path; a
        # missing lib means "no sm this process", never a g++ build.
        return native.atomics(build=False) is not None
    return True


def advertised_host() -> str:
    return _env("STARWAY_HOST", "127.0.0.1")


def devpull_enabled() -> bool:
    return _env("STARWAY_DEVPULL", "1") != "0"


def decode_stream_enabled() -> bool:
    return _env("STARWAY_DECODE_STREAM", "1") != "0"


def devpull_threshold() -> int:
    return int(_env("STARWAY_DEVPULL_MIN", str(64 * 1024)))


def rndv_threshold() -> int:
    return int(_env("STARWAY_RNDV_THRESHOLD", str(8 * 1024 * 1024)))


def chunk_bytes() -> int:
    """Data-plane pipelining granularity (STARWAY_CHUNK); 0 disables
    chunked staging and the receive-side placement overlap."""
    try:
        v = int(_env("STARWAY_CHUNK", str(256 * 1024)))
    except ValueError:
        return 256 * 1024
    return v if v > 0 else 0


def connect_timeout() -> float:
    try:
        v = float(_env("STARWAY_CONNECT_TIMEOUT", "3.0"))
    except ValueError:
        return 3.0
    return v if v > 0 else 3.0


def keepalive_interval() -> float:
    """Seconds between liveness PINGs; 0 (the default) disables detection
    entirely -- reference parity: peer death leaves posted recvs pending."""
    try:
        v = float(_env("STARWAY_KEEPALIVE", "0"))
    except ValueError:
        return 0.0
    return v if v > 0 else 0.0


def keepalive_misses() -> int:
    try:
        v = int(_env("STARWAY_KEEPALIVE_MISSES", "3"))
    except ValueError:
        return 3
    return v if v > 0 else 3


def session_enabled() -> bool:
    """Resilient-session layer (STARWAY_SESSION); off by default --
    seed parity: a dropped conn cancels every in-flight op."""
    return _env("STARWAY_SESSION", "0") not in ("", "0")


def session_journal_bytes() -> int:
    """Replay-journal cap per conn direction (STARWAY_SESSION_JOURNAL_BYTES);
    sends block (park unframed) when unacked journaled bytes reach it."""
    try:
        v = int(_env("STARWAY_SESSION_JOURNAL_BYTES", str(16 * 1024 * 1024)))
    except ValueError:
        return 16 * 1024 * 1024
    return max(4096, v)


def session_grace() -> float:
    """Seconds a dead session conn stays resumable (STARWAY_SESSION_GRACE);
    past it the session expires and ops fail with "session expired"."""
    try:
        v = float(_env("STARWAY_SESSION_GRACE", "30"))
    except ValueError:
        return 30.0
    return v if v > 0 else 30.0


def stripe_rails() -> int:
    """Parallel transport lanes per client connection (STARWAY_RAILS);
    1 (the default) keeps the single-conn seed topology."""
    try:
        v = int(_env("STARWAY_RAILS", "1"))
    except ValueError:
        return 1
    return max(1, min(16, v))


def stripe_threshold() -> int:
    """Payload bytes at/above which railed sends stripe
    (STARWAY_STRIPE_THRESHOLD); 0 (the default) disables striping."""
    try:
        v = int(_env("STARWAY_STRIPE_THRESHOLD", "0"))
    except ValueError:
        return 0
    return v if v > 0 else 0


def stripe_chunk() -> int:
    """Stripe granularity in bytes (STARWAY_STRIPE_CHUNK; defaults to 4x
    the §12 STARWAY_CHUNK staging granularity = 1 MiB)."""
    raw = _env("STARWAY_STRIPE_CHUNK", "")
    if raw:
        try:
            return max(4096, int(raw))
        except ValueError:
            pass
    return max(4096, 4 * (chunk_bytes() or 256 * 1024))


def stripe_weighted() -> bool:
    """Lane-weighted tail claiming (STARWAY_STRIPE_WEIGHTED); off by
    default -- pure work stealing, the PR-8 behaviour."""
    return _env("STARWAY_STRIPE_WEIGHTED", "0") not in ("", "0")


def fc_window() -> int:
    """Receiver credit window in bytes (STARWAY_FC_WINDOW); 0 (the
    default) disables flow control entirely -- seed parity: no "fc"
    handshake key, no T_CREDIT/T_RTS/T_CTS frames."""
    try:
        v = int(_env("STARWAY_FC_WINDOW", "0"))
    except ValueError:
        return 0
    return v if v > 0 else 0


def unexp_cap() -> int:
    """Hard unexpected-queue byte ceiling (STARWAY_UNEXP_BYTES); 0 (the
    default) keeps the seed's unbounded queue."""
    try:
        v = int(_env("STARWAY_UNEXP_BYTES", "0"))
    except ValueError:
        return 0
    return v if v > 0 else 0


def integrity_enabled() -> bool:
    """End-to-end integrity plane (STARWAY_INTEGRITY); off by default --
    seed parity: no "csum" handshake key, no checksum frames on the wire."""
    return _env("STARWAY_INTEGRITY", "0") not in ("", "0")


def trace_enabled() -> bool:
    """Per-op lifecycle tracing (STARWAY_TRACE); off by default -- the
    tracing-off hot path must stay allocation-free (DESIGN.md §13)."""
    return _env("STARWAY_TRACE", "0") not in ("", "0")


def proto_trace_enabled() -> bool:
    """swrefine protocol-event channel (STARWAY_PROTO_TRACE; implied by
    STARWAY_MONITOR); off by default -- the seed path emits no protocol
    events and pays one ``is None`` check per frame (DESIGN.md §22)."""
    return (_env("STARWAY_PROTO_TRACE", "0") not in ("", "0")
            or monitor_enabled())


def monitor_enabled() -> bool:
    """In-process protocol-monitor checking (STARWAY_MONITOR); off by
    default.  Implies the protocol-event channel (DESIGN.md §22)."""
    return _env("STARWAY_MONITOR", "0") not in ("", "0")


def trace_ring_size() -> int:
    """Trace ring capacity in events per worker (STARWAY_TRACE_RING)."""
    try:
        v = int(_env("STARWAY_TRACE_RING", "4096"))
    except ValueError:
        return 4096
    return max(16, v)


def flight_dir() -> str:
    """Flight-recorder output directory (STARWAY_FLIGHT_DIR); empty =
    recorder disabled."""
    return _env("STARWAY_FLIGHT_DIR", "")


def metrics_interval() -> float:
    """swscope sampler period in seconds (STARWAY_METRICS_INTERVAL);
    0 (the default) disables the sampler thread.  A metrics path/addr
    with no explicit interval samples at 1 s."""
    try:
        v = float(_env("STARWAY_METRICS_INTERVAL", "0"))
    except ValueError:
        return 0.0
    return v if v > 0 else 0.0


def metrics_path() -> str:
    """JSONL telemetry emitter path (STARWAY_METRICS_PATH); empty = off."""
    return _env("STARWAY_METRICS_PATH", "")


def metrics_addr() -> str:
    """host:port for the live telemetry feed (STARWAY_METRICS_ADDR);
    empty = no listener."""
    return _env("STARWAY_METRICS_ADDR", "")


def metrics_ring_size() -> int:
    """In-memory telemetry sample ring capacity (STARWAY_METRICS_RING)."""
    try:
        v = int(_env("STARWAY_METRICS_RING", "512"))
    except ValueError:
        return 512
    return max(16, v)


def stall_ms() -> float:
    """swpulse stall-sentinel threshold in milliseconds (STARWAY_STALL_MS);
    0 (the default) disables the sentinel entirely -- the seed path takes
    zero sentinel branches (DESIGN.md §25)."""
    try:
        v = float(_env("STARWAY_STALL_MS", "0"))
    except ValueError:
        return 0.0
    return v if v > 0 else 0.0


def use_native() -> bool:
    return _env("STARWAY_NATIVE", "1") == "1"


def device_backend() -> str:
    return _env("STARWAY_BACKEND", "auto")
