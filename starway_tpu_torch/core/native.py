"""ctypes bridge to the C++ native engine (native/sw_engine.cpp).

The C ABI this module mirrors is declared authoritatively in
``native/sw_engine.h`` — the analogue of the reference's hand-written type
stub (src/starway/_bindings.pyi), documenting every function, callback
signature, and buffer-lifetime rule crossing the language boundary.  Keep
``load()``'s argtypes in lockstep with that header.

Presents the same worker protocol as the pure-Python engine
(core/engine.py): ``NativeClientWorker`` / ``NativeServerWorker`` with
``submit_send`` / ``post_recv`` / ``submit_flush`` / ``close`` / endpoint
introspection, so the api layer swaps engines transparently.  The native
engine covers the host paths -- TCP and the negotiated same-host
shared-memory rings (``sm``, core/shmring.py) -- speaking the same wire
protocol as the Python engine, so mixed-engine processes interoperate over
either.  The in-process fast path stays in Python, which is why native
selection requires inproc-free mode (``STARWAY_TLS=tcp`` or ``tcp,sm``,
plus ``STARWAY_NATIVE=1``).  Cross-process device payloads ride the
negotiated PJRT pull extension: ALL matching lives in the engine
(descriptor records share its FIFO unexpected stream with staged DATA, so
same-tag ordering matches the Python engine); the engine surfaces
descriptors and claim events through ``sw_set_devpull``'s two callbacks
and this wrapper runs the pulls (the engine cannot -- they need a live
JAX runtime), releasing deferred flush barriers via
``sw_devpull_resolved`` (see sw_engine.h "devpull" and DESIGN.md §7).

Lifetime/GIL notes: callbacks cross from the engine thread through ctypes
trampolines, which acquire the GIL.  Each pending op holds its Python buffer
and callbacks in a registry keyed by an integer handle passed through the
C ``ctx`` pointer, so nothing is garbage-collected mid-flight.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import threading
import uuid
import weakref
from typing import Optional

from .. import config, perf
from ..errors import StarwayStateError
from . import state, swtrace, telemetry
from .engine import logger

_lib = None
_lib_err: Optional[str] = None

_DONE_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_FAIL_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_char_p)
_RECV_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64)
_ACCEPT_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint64)
_STATUS_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_char_p)
_DEVPULL_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint64,
                               ctypes.c_uint64, ctypes.POINTER(ctypes.c_char),
                               ctypes.c_uint64, ctypes.c_uint64,
                               ctypes.c_int, ctypes.c_uint64)
_DEVPULL_CLAIM_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint64,
                                     ctypes.c_uint64, ctypes.c_int)
_EVENT_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_uint64)


def load() -> Optional[ctypes.CDLL]:
    """Load (building on first use) the native engine; None if unavailable."""
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        from .. import native_build

        path = native_build.ensure_built()
        lib = ctypes.CDLL(str(path))
        lib.sw_version.restype = ctypes.c_char_p
        lib.sw_client_new.restype = ctypes.c_void_p
        lib.sw_client_new.argtypes = [ctypes.c_char_p]
        lib.sw_server_new.restype = ctypes.c_void_p
        lib.sw_server_new.argtypes = [ctypes.c_char_p]
        lib.sw_client_connect.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            _STATUS_CB, ctypes.c_void_p,
        ]
        lib.sw_server_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.sw_server_set_accept_cb.argtypes = [ctypes.c_void_p, _ACCEPT_CB, ctypes.c_void_p]
        lib.sw_send.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_uint64, _DONE_CB, _FAIL_CB, ctypes.c_void_p,
            _DONE_CB, ctypes.c_void_p, ctypes.c_double,
        ]
        lib.sw_recv.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, _RECV_CB, _FAIL_CB, ctypes.c_void_p,
            ctypes.c_double,
        ]
        lib.sw_flush.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, _DONE_CB, _FAIL_CB,
            ctypes.c_void_p, ctypes.c_double,
        ]
        lib.sw_close.argtypes = [ctypes.c_void_p, _DONE_CB, ctypes.c_void_p]
        lib.sw_status.argtypes = [ctypes.c_void_p]
        lib.sw_primary_conn.argtypes = [ctypes.c_void_p]
        lib.sw_primary_conn.restype = ctypes.c_uint64
        lib.sw_list_conns.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int
        ]
        lib.sw_conn_info.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int
        ]
        lib.sw_counters.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
        ]
        lib.sw_trace.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
        ]
        lib.sw_gauges.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
        ]
        lib.sw_hists.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
        ]
        lib.sw_free.argtypes = [ctypes.c_void_p]
        lib.sw_set_devpull.argtypes = [
            ctypes.c_void_p, ctypes.c_int, _DEVPULL_CB, _DEVPULL_CLAIM_CB,
            ctypes.c_void_p,
        ]
        lib.sw_devpull_resolved.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int
        ]
        lib.sw_devpull_purge.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.sw_send_devpull.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, _DONE_CB, _FAIL_CB, ctypes.c_void_p,
        ]
        lib.sw_set_event_cb.argtypes = [
            ctypes.c_void_p, _EVENT_CB, ctypes.c_void_p
        ]
        # Optional (older .so builds lack them): portable sm cursor atomics
        # for the Python engine on non-TSO architectures (core/shmring.py).
        if hasattr(lib, "sw_atomic_load_u64"):
            lib.sw_atomic_load_u64.argtypes = [ctypes.c_void_p]
            lib.sw_atomic_load_u64.restype = ctypes.c_uint64
            lib.sw_atomic_store_u64.argtypes = [ctypes.c_void_p,
                                                ctypes.c_uint64]
        # Optional: hardware CRC32C for the §19 integrity plane -- the
        # Python engine checksums through the same export the C++ engine
        # uses internally, so mixed pairs agree bit-for-bit
        # (core/frames.py crc32c).
        if hasattr(lib, "sw_crc32c"):
            lib.sw_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                      ctypes.c_uint32]
            lib.sw_crc32c.restype = ctypes.c_uint32
        # Optional: the §21 swcompose differential decode harness -- a
        # pure structural decoder the wirefuzz analysis pass diffs
        # against frames.decode_stream byte-for-byte.
        if hasattr(lib, "sw_wire_decode"):
            lib.sw_wire_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int
            ]
        # Optional: the §24 swfast capability probe (bit0 io_uring, bit1
        # MSG_ZEROCOPY, bit2 busy-poll) -- which opt-in hot-path levers
        # this build+kernel can actually engage (tests/test_fast.py and
        # the CI capability check consume it).
        if hasattr(lib, "sw_fast_probe"):
            lib.sw_fast_probe.argtypes = []
            lib.sw_fast_probe.restype = ctypes.c_uint64
        _lib = lib
    except Exception as e:  # toolchain/build failure => Python engine
        _lib_err = str(e)
        logger.debug("starway native engine unavailable: %s", e)
    return _lib


def available() -> bool:
    return load() is not None


def fast_probe() -> int:
    """§24 swfast capability bitmask: bit0 io_uring (runtime probe OK),
    bit1 MSG_ZEROCOPY, bit2 bounded busy-poll.  0 when the native lib is
    absent or predates the probe."""
    lib = load()
    if lib is None or not hasattr(lib, "sw_fast_probe"):
        return 0
    return int(lib.sw_fast_probe())


def atomics(build: bool = True) -> Optional[tuple]:
    """(load_acquire_u64, store_release_u64) ctypes fns, or None (no
    native lib, or an old build without them).  Used by core/shmring.py to
    carry sm on non-x86 hosts.

    ``build=False``: only use an ALREADY-BUILT artifact — never compile.
    The sm capability probe runs on the connection-setup path, where a
    synchronous g++ build (or a slow failed one) would stall the first
    connect of every fresh process."""
    global _lib
    if _lib is None and _lib_err is None and not build:
        from .. import native_build

        if native_build.prebuilt() is None:
            return None
    lib = load()
    if lib is None or not hasattr(lib, "sw_atomic_load_u64"):
        return None
    return lib.sw_atomic_load_u64, lib.sw_atomic_store_u64


def crc32c_fn(build: bool = True):
    """The native ``sw_crc32c`` ctypes fn (hardware CRC32C with software
    fallback inside the engine), or None.  ``build=False`` mirrors
    :func:`atomics`: only an already-built artifact -- the first checksum
    computes on the connection path, where a synchronous g++ build would
    stall the handshake (core/frames.py falls back to its pure-Python
    table)."""
    global _lib
    if _lib is None and _lib_err is None and not build:
        from .. import native_build

        if native_build.prebuilt() is None:
            return None
    lib = load()
    if lib is None or not hasattr(lib, "sw_crc32c"):
        return None
    return lib.sw_crc32c


# ----------------------------------------------------------- op registry

_op_ids = itertools.count(1)
_ops: dict[int, tuple] = {}
_ops_lock = threading.Lock()


def _register(*payload) -> int:
    key = next(_op_ids)
    with _ops_lock:
        _ops[key] = payload
    return key


def _take(key: int):
    with _ops_lock:
        return _ops.pop(key, None)


def _peek(key: int):
    with _ops_lock:
        return _ops.get(key)


@_DONE_CB
def _on_done(ctx):
    rec = _take(ctx)
    if rec and rec[0] is not None:
        try:
            rec[0]()
        except Exception:
            logger.exception("starway native done callback raised")


@_FAIL_CB
def _on_fail(ctx, reason):
    rec = _take(ctx)
    if rec and rec[1] is not None:
        try:
            rec[1]((reason or b"").decode())
        except Exception:
            logger.exception("starway native fail callback raised")


@_RECV_CB
def _on_recv(ctx, sender_tag, length):
    rec = _take(ctx)
    if rec and rec[0] is not None:
        try:
            rec[0](int(sender_tag), int(length))
        except Exception:
            logger.exception("starway native recv callback raised")


@_DONE_CB
def _on_release(ctx):
    # Buffer-keepalive release: the engine is finished with the payload
    # (fully written or cancelled).  Fired separately from the op's done
    # callback because rendezvous sends complete locally at header-write
    # while the payload keeps streaming.
    _take(ctx)


@_STATUS_CB
def _on_status(ctx, status):
    rec = _take(ctx)
    if rec and rec[0] is not None:
        try:
            rec[0]((status or b"").decode())
        except Exception:
            logger.exception("starway native status callback raised")


@_ACCEPT_CB
def _on_accept(ctx, conn_id):
    rec = _peek(ctx)  # persistent registration: not popped
    if rec and rec[0] is not None:
        try:
            rec[0](int(conn_id))
        except Exception:
            logger.exception("starway native accept callback raised")


@_DEVPULL_CB
def _on_devpull(ctx, conn_id, tag, body, length, msg_id, rc, recv_ctx):
    rec = _peek(ctx)  # persistent registration: not popped
    if rec and rec[0] is not None:
        try:
            rec[0](int(conn_id), int(tag),
                   ctypes.string_at(body, int(length)), int(msg_id),
                   int(rc), int(recv_ctx))
        except Exception:
            logger.exception("starway native devpull callback raised")


@_DEVPULL_CLAIM_CB
def _on_devpull_claim(ctx, remote_id, recv_ctx, flags):
    rec = _peek(ctx)  # persistent registration: not popped
    if rec and rec[1] is not None:
        try:
            rec[1](int(remote_id), int(recv_ctx), int(flags))
        except Exception:
            logger.exception("starway native devpull claim callback raised")


@_EVENT_CB
def _on_event(ctx, event, conn_id):
    rec = _peek(ctx)  # persistent registration: not popped
    if rec and rec[0] is not None:
        try:
            rec[0]((event or b"").decode(), int(conn_id))
        except Exception:
            logger.exception("starway native event callback raised")


def _is_device_sink(obj) -> bool:
    return obj is not None and hasattr(obj, "devbuf") and hasattr(obj, "accept_device")


def _timeout_s(timeout) -> float:
    """Map an optional per-op deadline to the C ABI sentinel (<= 0 = no
    deadline).  A caller-passed 0/negative timeout means "already expired"
    on the Python engine, so it becomes a minimal positive deadline here
    instead of silently disabling the clock (two engines, one contract)."""
    if timeout is None:
        return 0.0
    t = float(timeout)
    return t if t > 0 else 1e-9


# ------------------------------------------------------------- endpoints


class NativeConn:
    """Lightweight stand-in for the Python engine's conn objects: carries
    the native conn id plus lazily-fetched metadata."""

    kind = "tcp"

    def __init__(self, worker: "NativeWorkerBase", conn_id: int):
        self.worker = worker
        self.conn_id = conn_id
        self._transports: Optional[list[tuple[str, str]]] = None
        self._devpull: Optional[bool] = None

    def _info(self) -> dict:
        lib = load()
        buf = ctypes.create_string_buffer(512)
        n = lib.sw_conn_info(self.worker._h, self.conn_id, buf, 512)
        if n <= 0:
            return {}
        return json.loads(buf.value.decode())

    @property
    def peer_name(self) -> str:
        return self._info().get("name", "")

    @property
    def alive(self) -> bool:
        return bool(self._info().get("alive", 0))

    @property
    def mode(self) -> str:
        return self._info().get("mode", "socket")

    @property
    def local_addr(self) -> str:
        return self._info().get("local_addr", "")

    @property
    def local_port(self) -> int:
        return int(self._info().get("local_port", 0))

    @property
    def remote_addr(self) -> str:
        return self._info().get("remote_addr", "")

    @property
    def remote_port(self) -> int:
        return int(self._info().get("remote_port", 0))

    def transports(self) -> list[tuple[str, str]]:
        # The transport is fixed at handshake time: memoize so per-message
        # callers (evaluate_perf) pay the FFI round-trip once.
        if self._transports is None:
            if self._info().get("transport") == "sm":
                self._transports = [("shm", "sm")]
            else:
                dev = "lo" if self.remote_addr.startswith("127.") else "eth0"
                self._transports = [(dev, "tcp+native")]
        return self._transports

    @property
    def devpull_ok(self) -> bool:
        # Handshake-fixed, like the transport: memoize the FFI round-trip.
        if self._devpull is None:
            self._devpull = bool(self._info().get("devpull", 0))
        return self._devpull

    @property
    def rail_count(self) -> int:
        """Secondary lanes attached to this (primary) conn (DESIGN.md
        §17); live value, not memoized -- rails can die and re-attach."""
        return int(self._info().get("rails", 0))


# --------------------------------------------------------------- workers


class _PendingPull:
    """Receiver-side record for one surfaced DEVPULL descriptor (native
    engine analogue of the Python engine's matcher-held remote msgs)."""

    __slots__ = ("desc", "conn_id", "msg_id", "tag", "nbytes", "claimed",
                 "array", "failed", "discard", "resolved")

    def __init__(self, desc: dict, conn_id: int, msg_id: int, tag: int):
        self.desc = desc
        self.conn_id = conn_id
        self.msg_id = msg_id
        self.tag = tag
        self.nbytes = int(desc["n"])
        self.claimed = None  # (user_done, fail, mv_or_None, sink_or_None)
        self.array = None    # pulled payload (complete, unclaimed)
        self.failed = False
        self.discard = False
        # The claimed receive's terminal outcome fired (done at pull
        # completion, or cancel at close) -- whoever sets it first wins,
        # under _devpull_lock, so a pull landing during close cannot
        # double-resolve the future.
        self.resolved = False


class NativeWorkerBase:
    kind = "worker"

    def __init__(self):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native engine unavailable: {_lib_err}")
        self._lib = lib
        self.worker_id = uuid.uuid4().hex
        self._h = None
        self._address_blob: Optional[bytes] = None
        self._conn_cache: dict[int, NativeConn] = {}
        # devpull extension state (sw_engine.h "devpull"): the engine owns
        # the wire + matching; this wrapper owns the pulls.
        self._devpull_key: Optional[int] = None
        self._xfer_mgr = None
        # msg_id -> entry for every surfaced descriptor.  Matching lives in
        # the ENGINE (descriptor records share its FIFO unexpected stream);
        # this wrapper only runs pulls and completes claimed receives.
        self._devpull_entries: dict[int, _PendingPull] = {}
        self._devpull_claimed: list[_PendingPull] = []
        self._devpull_lock = threading.Lock()
        # swtrace observability (DESIGN.md §13): lifecycle events and the
        # counter registry live in the ENGINE (TraceRing / Counters in
        # sw_engine.cpp, pulled through sw_trace / sw_counters); the
        # wrapper adds the per-worker stage scope (device placement runs
        # in Python) and the flight-recorder fault triggers.
        self._faulted = False
        # Armed-state cached at construction, like the Python engine's
        # self._trace: the off path must stay env-lookup-free per op.
        self._swtrace_on = swtrace.active()
        self.stage_scope = perf.StageScope()
        self._event_key: Optional[int] = None
        swtrace.register_worker(self)
        telemetry.register_worker(self)

    # ------------------------------------------------------ session events
    def _install_events(self) -> None:
        """Register the engine-event callback (sw_set_event_cb): session
        resume / expiry are flight-recorder dump triggers (DESIGN.md §14)
        and the resume events recorded in the engine's trace ring must
        reach the post-mortem dump.  Armed only when swtrace is active --
        the default path takes no per-event trampoline."""
        if not self._swtrace_on or not config.session_enabled():
            return
        wself = weakref.ref(self)

        def dispatch(event: str, conn_id: int) -> None:
            s = wself()
            if s is None:
                return
            if event == "session-expired":
                s._faulted = True
            swtrace.flight_dump(event, s)

        self._event_key = _register(dispatch, None)
        self._lib.sw_set_event_cb(self._h, _on_event, self._event_key)

    # --------------------------------------------------------- observability
    @property
    def trace_label(self) -> str:
        return f"{self.kind}-{self.worker_id[:8]}"

    def trace_events(self) -> list:
        """The engine-side swtrace ring, pulled through ``sw_trace`` and
        reshaped to the Python ring's event tuples ([] when tracing off
        or the handle is gone)."""
        if self._h is None:
            return []
        cap = 256 + 224 * config.trace_ring_size()
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.sw_trace(self._h, buf, cap)
        if n <= 0:
            return []
        try:
            raw = json.loads(buf.value.decode(errors="replace"))
        except ValueError:
            return []
        return [(e.get("t", 0.0), e.get("ev", ""), int(e.get("tag", 0)),
                 int(e.get("conn", 0)), int(e.get("n", 0)),
                 e.get("reason", ""), 0.0) for e in raw]

    def counters_snapshot(self) -> dict:
        """The engine's counter registry (``sw_counters``) in the shared
        COUNTER_NAMES vocabulary, with the process-global counters
        (staging pool, reconnects) overlaid -- same shape as the Python
        engine's ``Worker.counters_snapshot``."""
        snap = {name: 0 for name in swtrace.COUNTER_NAMES}
        if self._h is not None:
            buf = ctypes.create_string_buffer(2048)
            n = self._lib.sw_counters(self._h, buf, 2048)
            if n > 0:
                try:
                    for key, val in json.loads(buf.value.decode()).items():
                        if key in snap:
                            snap[key] = int(val)
                except ValueError:
                    pass
        return swtrace.merge_global_counters(snap)

    def hists_snapshot(self) -> dict:
        """swpulse (DESIGN.md §25): the engine's log-bucket histograms
        (``sw_hists``) in the shared HIST_NAMES vocabulary -- same shape
        as the Python engine's ``Worker.hists_snapshot`` (name -> 64
        bucket counts)."""
        snap = {name: [0] * swtrace.HIST_BUCKETS
                for name in swtrace.HIST_NAMES}
        if self._h is not None:
            cap = 16384
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.sw_hists(self._h, buf, cap)
            if n > 0:
                try:
                    for key, row in json.loads(buf.value.decode()).items():
                        if key in snap and len(row) == swtrace.HIST_BUCKETS:
                            snap[key] = [int(v) for v in row]
                except (ValueError, TypeError):
                    pass
        return snap

    def gauges_snapshot(self) -> dict:
        """The engine's live per-conn gauges (``sw_gauges``; rendered on
        the engine thread) with the process-global staging-pool occupancy
        overlaid -- same shape as the Python engine's
        ``Worker.gauges_snapshot`` (DESIGN.md §15)."""
        snap: dict = {"conns": {}, "posted_recvs": 0, "uring_depth": 0}
        if self._h is not None:
            cap = 65536
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.sw_gauges(self._h, buf, cap)
            if n < -1:
                # Snapshot outgrew the buffer (-n = needed bytes); retry
                # sized with headroom for conns added meanwhile.
                cap = -n + 4096
                buf = ctypes.create_string_buffer(cap)
                n = self._lib.sw_gauges(self._h, buf, cap)
            if n > 0:
                try:
                    raw = json.loads(buf.value.decode())
                    snap["posted_recvs"] = int(raw.get("posted_recvs", 0))
                    # §24: submission-ring depth, 0 when the uring core
                    # is dark (seed parity) or the build predates it.
                    snap["uring_depth"] = int(raw.get("uring_depth", 0))
                    snap["conns"] = {
                        int(cid): {k: int(v) for k, v in g.items()}
                        for cid, g in raw.get("conns", {}).items()
                    }
                except (ValueError, TypeError):
                    pass
        return telemetry.merge_global_gauges(snap)

    def _flight_fail(self, fail):
        """Wrap an op's fail callback with the flight-recorder trigger
        (first non-cancel failure dumps).  Identity when tracing/flight
        are off -- no per-op closure on the default path."""
        if not self._swtrace_on:
            return fail
        wself = weakref.ref(self)

        def traced_fail(reason: str):
            s = wself()
            if s is not None and "cancel" not in reason.lower():
                s._faulted = True
                swtrace.flight_dump("op-failed", s, reason)
            if fail is not None:
                fail(reason)

        return traced_fail

    @property
    def status(self) -> int:
        if self._h is None:
            return state.VOID
        return int(self._lib.sw_status(self._h))

    def _require_running(self) -> None:
        if self.status != state.RUNNING:
            raise StarwayStateError(
                f"starway {self.kind} is not in a running state "
                f"(status={state.NAMES.get(self.status, self.status)})"
            )

    def _conn(self, conn_id: int) -> NativeConn:
        c = self._conn_cache.get(conn_id)
        if c is None:
            c = self._conn_cache[conn_id] = NativeConn(self, conn_id)
        return c

    # ------------------------------------------------------------- ops
    @staticmethod
    def _mv_pointer(mv: memoryview):
        """(address, keepalive) for a flat memoryview.  Writable views are
        zero-copy; readonly payloads (bytes) take one copy."""
        if len(mv) == 0:
            return 0, None
        if not mv.readonly:
            keep = ctypes.c_char.from_buffer(mv)
            return ctypes.addressof(keep), keep
        keep = (ctypes.c_char * len(mv)).from_buffer_copy(mv)
        return ctypes.addressof(keep), keep

    # ---------------------------------------------------------- devpull
    def _install_devpull(self) -> None:
        """Register the descriptor callback + advertise capability; called
        before listen/connect (the handshake carries the negotiation).
        Advertised only when the jax backend is already up -- same
        semantics as the Python engine's handshake probe."""
        from .. import device as _device

        if not _device.devpull_supported():
            return
        wself = weakref.ref(self)

        def dispatch(conn_id, tag, body, msg_id, rc, recv_ctx):
            s = wself()
            if s is not None:
                s._on_devpull_native(conn_id, tag, body, msg_id, rc, recv_ctx)

        def dispatch_claim(remote_id, recv_ctx, flags):
            s = wself()
            if s is not None:
                s._on_devpull_claim_native(remote_id, recv_ctx, flags)

        self._devpull_key = _register(dispatch, dispatch_claim)
        self._lib.sw_set_devpull(self._h, 1, _on_devpull, _on_devpull_claim,
                                 self._devpull_key)

    def transfer_manager(self):
        from .. import device as _device

        with self._devpull_lock:
            if self._xfer_mgr is None:
                if not _device.devpull_supported():
                    return None
                self._xfer_mgr = _device.TransferManager(config.advertised_host())
            return self._xfer_mgr

    @staticmethod
    def _claim_from_rec(entry: _PendingPull, rec) -> None:
        # rec = (done_wrapped, fail, mv, owner, keep, user_done)
        user_done = rec[5] if len(rec) > 5 else rec[0]
        owner = rec[3]
        sink = owner if _is_device_sink(owner) else None
        entry.claimed = (user_done, rec[1], None if sink else rec[2], sink)

    def _on_devpull_native(self, conn_id: int, tag: int, body: bytes,
                           msg_id: int, rc: int, recv_ctx: int) -> None:
        """Engine-thread callback: a descriptor arrived and the ENGINE
        already matched it (rc 1 claimed / -1 truncated / 0 queued in its
        FIFO unexpected stream).  Pull EAGERLY whatever the outcome -- the
        sender's buffer must be released and a flush barrier behind the
        descriptor must be able to complete (the engine withholds the
        FLUSH_ACK until sw_devpull_resolved)."""
        fail_trunc = None
        try:
            desc = json.loads(body.decode())
            entry = _PendingPull(desc, conn_id, msg_id, tag)
            with self._devpull_lock:
                self._devpull_entries[msg_id] = entry
            if rc != 0:
                rec = _take(recv_ctx)
                if rc == -1:
                    entry.discard = True  # drain pull releases the sender
                    fail_trunc = rec[1] if rec is not None else None
                elif rec is not None:
                    with self._devpull_lock:
                        self._claim_from_rec(entry, rec)
                        self._devpull_claimed.append(entry)
        except Exception:
            logger.exception("starway devpull descriptor handling failed")
            # The engine may have queued a record for this descriptor; it
            # has no wrapper entry, so it must not eat a future receive.
            self._lib.sw_devpull_purge(self._h, msg_id)
            self._lib.sw_devpull_resolved(self._h, conn_id, msg_id, 0)
            return
        if fail_trunc is not None:
            from ..errors import REASON_TRUNCATED

            try:
                fail_trunc(REASON_TRUNCATED)
            except Exception:
                logger.exception("starway devpull truncation callback raised")
        self._start_pull(entry)

    def _on_devpull_claim_native(self, remote_id: int, recv_ctx: int,
                                 flags: int) -> None:
        """A later receive claimed a queued descriptor record inside the
        engine's matcher (or was failed there for truncation, flags=1)."""
        complete_now = None
        with self._devpull_lock:
            entry = self._devpull_entries.get(remote_id)
        if entry is None:
            # Stale claim (record outlived its wrapper entry -- descriptor
            # handling failed, or the worker is closing): cancel the
            # receive rather than orphan it.
            rec = _take(recv_ctx) if recv_ctx else None
            if rec is not None and rec[1] is not None:
                from ..errors import REASON_CANCELLED

                try:
                    rec[1](REASON_CANCELLED)
                except Exception:
                    logger.exception("starway devpull cancel callback raised")
            return
        if flags == 1:
            # Engine fired the receive's truncation failure and consumed
            # the record; no claim will ever arrive for this entry.
            with self._devpull_lock:
                entry.discard = True
                self._devpull_entries.pop(entry.msg_id, None)
            return
        rec = _take(recv_ctx)
        if rec is None:
            return
        with self._devpull_lock:
            self._claim_from_rec(entry, rec)
            if entry.array is not None and not entry.resolved:
                entry.resolved = True
                complete_now = entry.array
            else:
                # Pull outstanding -- or failed, in which case the receive
                # stays pending (peer-death semantics) until the close
                # sweep cancels it.
                self._devpull_claimed.append(entry)
        if complete_now is not None:
            self._finish_entry(entry, complete_now)

    def _start_pull(self, entry: _PendingPull) -> None:
        mgr = self.transfer_manager()
        if mgr is None:
            self._pull_failed(entry, "transfer server unavailable")
            return
        device = None
        if entry.claimed is not None and entry.claimed[3] is not None:
            device = entry.claimed[3].devbuf.device
        mgr.pull(entry.desc, device,
                 lambda arr, e=entry: self._pull_done(e, arr),
                 lambda err, e=entry: self._pull_failed(e, err))

    def _pull_done(self, entry: _PendingPull, arr) -> None:
        try:
            with self._devpull_lock:
                entry.array = arr
                deliver = entry.claimed is not None and not entry.resolved \
                    and not entry.discard
                if deliver:
                    entry.resolved = True
                if entry.discard:
                    self._devpull_entries.pop(entry.msg_id, None)
            if deliver:
                self._finish_entry(entry, arr)
            # Unclaimed entries keep the array; the engine's matcher still
            # holds the record and a later receive claims it.
        finally:
            self._lib.sw_devpull_resolved(self._h, entry.conn_id,
                                          entry.msg_id, 1)

    def _finish_entry(self, entry: _PendingPull, arr) -> None:
        """Deliver a pulled payload into its claimed receive.  Never called
        under _devpull_lock (user callbacks re-enter the API)."""
        import numpy as np

        try:
            user_done, _fail, mv, sink = entry.claimed
            if sink is not None:
                sink.accept_device(arr)
            elif mv is not None:
                host = np.asarray(arr).view(np.uint8).reshape(-1)
                mv[: entry.nbytes] = memoryview(host)[: entry.nbytes]
            with self._devpull_lock:
                if entry in self._devpull_claimed:
                    self._devpull_claimed.remove(entry)
                self._devpull_entries.pop(entry.msg_id, None)
            if user_done is not None:
                user_done(entry.tag, entry.nbytes)
        except Exception:
            logger.exception("starway devpull completion failed")

    def _pull_failed(self, entry: _PendingPull, err: str) -> None:
        logger.warning("starway devpull pull failed: %s", err)
        purge = False
        with self._devpull_lock:
            entry.failed = True
            purge = entry.claimed is None
        if purge:
            # Remove the engine matcher's queued record so it cannot eat
            # future receives.  The wrapper entry stays in the dict: a
            # claim racing the purge then finds a failed entry and its
            # receive goes pending (peer-death semantics) instead of being
            # silently dropped; the dict entry is reclaimed at close.
            self._lib.sw_devpull_purge(self._h, entry.msg_id)
        # A claimed receive stays pending (peer-death semantics) until the
        # close sweep cancels it (_drop_devpull).
        self._lib.sw_devpull_resolved(self._h, entry.conn_id, entry.msg_id, 0)

    def submit_devpull(self, conn, desc: dict, tag: int, done, fail,
                       owner=None) -> None:
        self._require_running()
        conn_id = conn.conn_id if isinstance(conn, NativeConn) else 0
        body = json.dumps(desc, separators=(",", ":")).encode()
        key = _register(done, self._flight_fail(fail), owner)
        rc = self._lib.sw_send_devpull(self._h, conn_id, tag, body, len(body),
                                       _on_done, _on_fail, key)
        if rc != 0:
            _take(key)
            raise StarwayStateError("starway native send rejected (not running)")

    def submit_send(self, conn, view, tag: int, done, fail, owner=None,
                    timeout=None) -> None:
        self._require_running()
        conn_id = conn.conn_id if isinstance(conn, NativeConn) else 0
        mv = memoryview(view)
        addr, keep = self._mv_pointer(mv)
        key = _register(done, self._flight_fail(fail))
        # The payload must outlive the op past local completion (rndv sends
        # stream after `done` fires); the engine's release callback is the
        # only thing allowed to drop this reference.
        rel_key = _register(None, None, mv, owner, keep)
        rc = self._lib.sw_send(self._h, conn_id, addr, len(mv), tag,
                               _on_done, _on_fail, key, _on_release, rel_key,
                               _timeout_s(timeout))
        if rc != 0:
            _take(key)
            _take(rel_key)
            raise StarwayStateError("starway native send rejected (not running)")

    def post_recv(self, buf, tag: int, mask: int, done, fail, owner=None,
                  timeout=None) -> None:
        self._require_running()
        user_done = done
        if isinstance(buf, memoryview):
            mv = buf
        else:
            mv = buf.host_staging()  # DeviceRecvSink
            inner_done = done

            def done(st, ln, _sink=buf, _cb=inner_done):
                _sink.finalize_from_host(ln)
                _cb(st, ln)

        if mv.readonly:
            raise TypeError("receive buffer must be writable")
        addr, keep = self._mv_pointer(mv)
        # Slot 5 (user_done) lets a devpull claim complete the receive via
        # the device path instead of the staging-wrapped `done`.
        key = _register(done, self._flight_fail(fail), mv, owner, keep,
                        user_done)
        rc = self._lib.sw_recv(self._h, addr, len(mv), tag, mask, _on_recv,
                               _on_fail, key, _timeout_s(timeout))
        if rc != 0:
            _take(key)
            raise StarwayStateError("starway native recv rejected (not running)")

    def submit_flush(self, done, fail, conns=None, timeout=None) -> None:
        self._require_running()
        key = _register(done, self._flight_fail(fail))
        t = _timeout_s(timeout)
        if conns:
            conn_id = conns[0].conn_id if isinstance(conns[0], NativeConn) else 0
            rc = self._lib.sw_flush(self._h, conn_id, 1, _on_done, _on_fail, key, t)
        else:
            rc = self._lib.sw_flush(self._h, 0, 0, _on_done, _on_fail, key, t)
        if rc != 0:
            _take(key)
            raise StarwayStateError("starway native flush rejected (not running)")

    def close(self, cb) -> None:
        self._require_running()
        if self._faulted:
            # Post-mortem snapshot before teardown (DESIGN.md §13).
            swtrace.flight_dump("close-after-fault", self)

        def cb_devpull_cleanup(_cb=cb):
            # Park the engine ring's final contents for post-close
            # consumers; the handle stays valid until sw_free.
            swtrace.retire(self)
            self._drop_devpull()
            if _cb is not None:
                _cb()

        key = _register(cb_devpull_cleanup, None)
        rc = self._lib.sw_close(self._h, _on_done, key)
        if rc != 0:
            _take(key)
            raise StarwayStateError(
                f"starway {self.kind} is not in a running state (native close rejected)"
            )

    def _drop_devpull(self) -> None:
        if self._event_key is not None:
            _take(self._event_key)
            self._event_key = None
        if self._devpull_key is not None:
            _take(self._devpull_key)
            self._devpull_key = None
        with self._devpull_lock:
            mgr, self._xfer_mgr = self._xfer_mgr, None
            self._devpull_entries.clear()
            cancelled = [e for e in self._devpull_claimed if not e.resolved]
            for e in cancelled:
                e.resolved = True
            self._devpull_claimed.clear()
        # Claimed receives whose pull never landed get the standard close
        # cancel (they were removed from the C++ matcher, so its own
        # cancel sweep cannot reach them).
        if cancelled:
            from ..errors import REASON_CANCELLED

            for e in cancelled:
                fail = e.claimed[1]
                if fail is not None:
                    try:
                        fail(REASON_CANCELLED)
                    except Exception:
                        logger.exception("starway devpull cancel callback raised")
        if mgr is not None:
            # Dropping the transfer server cancels unpulled offers (the
            # close-cancels-in-flight contract for device sends).
            mgr.close()

    def force_close(self) -> None:
        pass  # sw_free in __del__ handles signalling

    def get_worker_address(self) -> bytes:
        if self._address_blob is None:
            self._address_blob = json.dumps(
                {"worker_id": self.worker_id, "host": config.advertised_host(),
                 "port": 0, "fabric": "starway-tpu"}
            ).encode()
        return self._address_blob

    def _perf_transport(self, conn) -> str:
        self._require_running()
        if isinstance(conn, NativeConn) and conn.transports() == [("shm", "sm")]:
            return "sm"
        return "tcp"

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

    def __del__(self):
        try:
            swtrace.retire(self)
        except Exception:
            pass
        try:
            self._drop_devpull()
        except Exception:
            pass
        try:
            if self._h is not None:
                self._lib.sw_free(self._h)
                self._h = None
        except Exception:
            pass


class NativeClientWorker(NativeWorkerBase):
    kind = "client"

    def __init__(self):
        super().__init__()
        self._h = self._lib.sw_client_new(self.worker_id.encode())
        self._connected = False

    @property
    def primary_conn(self) -> Optional[NativeConn]:
        cid = int(self._lib.sw_primary_conn(self._h))
        return self._conn(cid) if cid else None

    def _do_connect(self, host: str, port: int, mode: str, cb) -> None:
        if self.status != state.VOID:
            raise StarwayStateError(
                "starway client supports a single connect "
                f"(status={state.NAMES.get(self.status, self.status)})"
            )
        self._install_devpull()
        self._install_events()
        key = _register(cb, None)
        rc = self._lib.sw_client_connect(
            self._h, host.encode(), port, mode.encode(), _on_status, key
        )
        if rc != 0:
            _take(key)
            raise StarwayStateError("starway client supports a single connect")

    def connect(self, addr: str, port: int, cb, timeout=None) -> None:
        # Per-call timeout override rides the env knob on the native engine
        # (the C engine samples STARWAY_CONNECT_TIMEOUT at connect); the api
        # layer additionally bounds the attempt with asyncio.wait_for.
        del timeout
        self._do_connect(addr, port, "socket", cb)

    def connect_address(self, blob: bytes, cb, timeout=None) -> None:
        del timeout
        from . import frames

        info = frames.unpack_json_body(blob)
        self._do_connect(info.get("host", "127.0.0.1"), int(info.get("port", 0)),
                         "address", cb)


class NativeServerWorker(NativeWorkerBase):
    kind = "server"

    def __init__(self):
        super().__init__()
        self._h = self._lib.sw_server_new(self.worker_id.encode())
        self._accept_key: Optional[int] = None
        self._eps: dict[int, object] = {}
        self._eps_lock = threading.Lock()
        self._user_accept_cb = None

    def set_accept_cb(self, cb) -> None:
        self._user_accept_cb = cb

    def _on_native_accept(self, conn_id: int) -> None:
        from .endpoint import ServerEndpoint

        ep = ServerEndpoint(self._conn(conn_id))
        with self._eps_lock:
            self._eps[conn_id] = ep
        if self._user_accept_cb is not None:
            self._user_accept_cb(ep)

    def _install_accept(self) -> None:
        # Weakref dispatch: the persistent registry entry must not keep the
        # worker alive (it would never be GC'd and sw_free never called).
        wself = weakref.ref(self)

        def dispatch(conn_id: int) -> None:
            s = wself()
            if s is not None:
                s._on_native_accept(conn_id)

        self._accept_key = _register(dispatch, None)
        self._lib.sw_server_set_accept_cb(self._h, _on_accept, self._accept_key)

    def _drop_accept(self) -> None:
        if self._accept_key is not None:
            _take(self._accept_key)
            self._accept_key = None

    def close(self, cb) -> None:
        def cb_and_cleanup():
            self._drop_accept()
            if cb is not None:
                cb()

        super().close(cb_and_cleanup)

    def __del__(self):
        try:
            self._drop_accept()
        except Exception:
            pass
        try:
            super().__del__()
        except Exception:
            pass

    def listen(self, addr: str, port: int) -> None:
        if self.status != state.VOID:
            raise StarwayStateError("starway server already listening or closed")
        self._install_accept()
        self._install_devpull()
        self._install_events()
        rc = int(self._lib.sw_server_listen(self._h, addr.encode(), port))
        if rc <= 0:
            raise OSError(-rc, f"native listen failed on {addr}:{port}")
        self._address_blob = json.dumps(
            {"worker_id": self.worker_id,
             "host": addr if addr not in ("0.0.0.0", "") else config.advertised_host(),
             "port": rc, "fabric": "starway-tpu"}
        ).encode()

    def listen_address(self) -> bytes:
        if self.status != state.VOID:
            raise StarwayStateError("starway server already listening or closed")
        self._install_accept()
        self._install_devpull()
        self._install_events()
        rc = int(self._lib.sw_server_listen(self._h, b"0.0.0.0", 0))
        if rc <= 0:
            raise OSError(-rc, "native listen_address failed")
        self._address_blob = json.dumps(
            {"worker_id": self.worker_id, "host": config.advertised_host(),
             "port": rc, "fabric": "starway-tpu"}
        ).encode()
        return self._address_blob

    def list_clients(self) -> set:
        with self._eps_lock:
            return set(self._eps.values())
