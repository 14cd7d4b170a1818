"""Public asyncio API: ``Server`` and ``Client``.

The exact contract of the reference's Python layer
(src/starway/__init__.py:71-348 and src/starway/_bindings.pyi): callback-style
``send``/``recv``/``flush`` plus future-style ``asend``/``arecv``/``aflush``
variants, dual bootstrap (socket listener / worker-address bytes), endpoint
introspection, and ``evaluate_perf``.  Completion callbacks run on the engine
thread and trampoline into asyncio with ``loop.call_soon_threadsafe``
(reference: src/starway/__init__.py:124-128).

Buffers: 1-D ``uint8`` NumPy arrays are the host path (zero-copy, the buffer
must outlive the operation -- reference: src/bindings/main.hpp:55-59).
Non-uint8 arrays are value-cast to uint8 via a copy, matching nanobind's
implicit ndarray conversion in the reference bindings.  ``torch.Tensor`` and
:class:`~starway_tpu_torch.device.DeviceBuffer` payloads take the device plane (see
device.py).
"""

from __future__ import annotations

import asyncio
import logging
import random
import threading
import weakref
from collections import deque
from typing import Callable, Optional

import numpy as np

from . import config
from .core import swtrace
from .core.endpoint import ServerEndpoint
from .core.engine import ClientWorker, ServerWorker
from .errors import REASON_TIMEOUT

logger = logging.getLogger("starway_tpu_torch")


def _use_native_engine() -> bool:
    """The C++ engine serves the pure-TCP mode (STARWAY_TLS=tcp); the
    in-process fast path and device handoff need the Python engine."""
    if not config.use_native() or config.inproc_enabled():
        return False
    from .core import native

    return native.available()


def _new_client_worker():
    if _use_native_engine():
        from .core.native import NativeClientWorker

        return NativeClientWorker()
    return ClientWorker()


def _new_server_worker():
    if _use_native_engine():
        from .core.native import NativeServerWorker

        return NativeServerWorker()
    return ServerWorker()

_U64_MASK = (1 << 64) - 1


_device_mod = None


def _is_device_payload(buffer) -> bool:
    global _device_mod
    if _device_mod is None:
        from . import device as _device_mod_local

        _device_mod = _device_mod_local
    return _device_mod.is_device_payload(buffer)


def _send_view(buffer):
    """Coerce a send payload to (keepalive, flat uint8 memoryview)."""
    if isinstance(buffer, np.ndarray):
        arr = buffer
        if arr.dtype != np.uint8:
            # nanobind-style implicit conversion: value-cast copy.
            arr = np.ascontiguousarray(arr).astype(np.uint8)
        elif not arr.flags["C_CONTIGUOUS"]:
            arr = np.ascontiguousarray(arr)
        return arr, memoryview(arr).cast("B")
    if isinstance(buffer, (bytes, bytearray, memoryview)):
        return buffer, memoryview(buffer).cast("B")
    raise TypeError(
        f"unsupported send buffer type {type(buffer)!r}; expected numpy uint8 "
        "array, bytes-like, torch.Tensor, or DeviceBuffer"
    )


def _recv_view(buffer):
    """Coerce a receive target to (keepalive, writable flat uint8 memoryview)."""
    if isinstance(buffer, np.ndarray):
        if buffer.dtype != np.uint8:
            raise TypeError("receive buffer must be a uint8 ndarray")
        if not buffer.flags["C_CONTIGUOUS"]:
            raise TypeError("receive buffer must be C-contiguous")
        if not buffer.flags["WRITEABLE"]:
            raise TypeError("receive buffer must be writable")
        return buffer, memoryview(buffer).cast("B")
    if isinstance(buffer, (bytearray, memoryview)):
        mv = memoryview(buffer).cast("B")
        if mv.readonly:
            raise TypeError("receive buffer must be writable")
        return buffer, mv
    raise TypeError(
        f"unsupported receive buffer type {type(buffer)!r}; expected numpy "
        "uint8 array, bytearray, or DeviceBuffer"
    )


def _tag(tag: int) -> int:
    return int(tag) & _U64_MASK


class _CompletionTrampoline:
    """Per-loop batcher for cross-thread completions.

    Engine threads deliver completions in bursts (one fires sweep per
    engine wakeup); paying one ``call_soon_threadsafe`` -- a self-pipe
    write plus a scheduler pass -- *per completion* made an N-op burst
    cost N wakeups.  This trampoline queues the completions and schedules
    exactly one drain per burst: the first submission after an empty
    queue pays the hop, the rest ride it.  FIFO order is preserved.
    """

    # The loop is held WEAKLY: this object is the value keyed by the loop
    # in a WeakKeyDictionary, and a strong value->key reference would keep
    # every event loop (and this trampoline) alive forever.
    __slots__ = ("_loop_ref", "_lock", "_pending", "_scheduled")

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop_ref = weakref.ref(loop)
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self._scheduled = False

    def submit(self, apply) -> None:
        loop = self._loop_ref()
        if loop is None or loop.is_closed():
            # Closed/collected loop: drop, like the pre-batching
            # call_soon_threadsafe path did -- and clear any backlog a
            # drain scheduled-but-never-run left behind, so _scheduled
            # cannot stick True and pin the dead loop via _pending.
            with self._lock:
                self._scheduled = False
                self._pending.clear()
            return
        with self._lock:
            self._pending.append(apply)
            if self._scheduled:
                return
            self._scheduled = True
        try:
            loop.call_soon_threadsafe(self._drain)
        except RuntimeError:
            # Lost the race with loop close: same drop contract.
            with self._lock:
                self._scheduled = False
                self._pending.clear()

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._scheduled = False
                    return
                batch = list(self._pending)
                self._pending.clear()
            for apply in batch:
                try:
                    apply()
                except Exception:
                    logger.exception("starway: completion callback raised")


_trampolines: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_trampolines_lock = threading.Lock()


def _loop_trampoline(loop: asyncio.AbstractEventLoop) -> _CompletionTrampoline:
    with _trampolines_lock:
        tramp = _trampolines.get(loop)
        if tramp is None:
            tramp = _trampolines[loop] = _CompletionTrampoline(loop)
        return tramp


def _future_pair(loop: Optional[asyncio.AbstractEventLoop], result_factory=None):
    """Build (future, done_cb, fail_cb) bridging completions to asyncio.

    Completions from engine threads hop via the per-loop trampoline --
    one ``call_soon_threadsafe`` per burst, not per op (reference hops per
    op: src/starway/__init__.py:124-128).  Completions fired on the loop
    thread itself (the in-process inline fast path) resolve directly --
    no self-pipe write, no extra scheduler pass.
    """
    if loop is None:
        loop = asyncio.get_running_loop()
    fut: asyncio.Future = asyncio.Future(loop=loop)

    def _safe(call, *args):
        def apply():
            if not fut.done():
                call(*args)

        # Same-loop detection via thread id: CPython's BaseEventLoop pins
        # `_thread_id` while running, and threading.get_ident() is ~100x
        # cheaper than asyncio.get_running_loop() on virtualised hosts
        # (measured 7 us/call on this box -- it was the single largest
        # non-copy cost of the in-process pingpong).  Loop implementations
        # without the attribute fall back to the get_running_loop probe.
        tid = getattr(loop, "_thread_id", False)
        if tid is False:
            try:
                same = asyncio.get_running_loop() is loop
            except RuntimeError:
                same = False
        else:
            same = tid is not None and tid == threading.get_ident()
        if same:
            apply()
            return
        _loop_trampoline(loop).submit(apply)

    def done(*args):
        _safe(fut.set_result, result_factory(*args) if result_factory else None)

    def fail(reason: str):
        _safe(fut.set_exception, Exception(reason))

    return fut, done, fail


class Server:
    """Accepting side.  Reference: class Server, src/starway/__init__.py:71-209."""

    def __init__(self):
        self._server = _new_server_worker()

    # --------------------------------------------------------------- listen
    def listen(self, addr: str, port: int) -> None:
        self._server.listen(addr, port)

    def listen_address(self) -> bytes:
        return self._server.listen_address()

    def set_accept_cb(self, on_accept: Callable[[ServerEndpoint], None]) -> None:
        self._server.set_accept_cb(on_accept)

    def get_worker_address(self) -> bytes:
        return self._server.get_worker_address()

    def list_clients(self) -> set[ServerEndpoint]:
        return self._server.list_clients()

    # ---------------------------------------------------------------- close
    def aclose(self, loop: Optional[asyncio.AbstractEventLoop] = None):
        fut, done, _ = _future_pair(loop)

        def close_cb():
            logger.debug("starway server closed")
            done()

        self._server.close(close_cb)
        return fut

    # ----------------------------------------------------------------- send
    def send(self, client_ep: ServerEndpoint, buffer, tag: int,
             done_callback: Callable[[], None], fail_callback: Callable[[str], None],
             timeout: Optional[float] = None) -> None:
        """``timeout`` (seconds) bounds local completion: an unsettled send
        fails with the stable ``"timed out"`` reason.  Host payloads only;
        device-plane (torch.Tensor) sends have their own transfer
        lifecycle (device.py)."""
        if _is_device_payload(buffer):
            from . import device

            device.send_device(self._server, client_ep._conn, buffer, _tag(tag),
                               done_callback, fail_callback)
            return
        owner, view = _send_view(buffer)
        self._server.submit_send(client_ep._conn, view, _tag(tag),
                                 done_callback, fail_callback, owner,
                                 timeout=timeout)

    def asend(self, client_ep: ServerEndpoint, buffer, tag: int,
              loop: Optional[asyncio.AbstractEventLoop] = None,
              timeout: Optional[float] = None):
        fut, done, fail = _future_pair(loop)
        self.send(client_ep, buffer, tag, done, fail, timeout=timeout)
        return fut

    # ----------------------------------------------------------------- recv
    def recv(self, buffer, tag: int, tag_mask: int,
             done_callback: Callable[[int, int], None],
             fail_callback: Callable[[str], None],
             timeout: Optional[float] = None) -> None:
        """``timeout`` (seconds) bounds completion: an unmatched (or
        mid-stream) receive fails with ``"timed out"`` and its buffer is
        immediately safe to repost.  Host buffers only (see send)."""
        if _is_device_payload(buffer):
            from . import device

            device.post_device_recv(self._server, buffer, _tag(tag), _tag(tag_mask),
                                    done_callback, fail_callback)
            return
        owner, view = _recv_view(buffer)
        self._server.post_recv(view, _tag(tag), _tag(tag_mask),
                               done_callback, fail_callback, owner,
                               timeout=timeout)

    def arecv(self, buffer, tag: int, tag_mask: int,
              loop: Optional[asyncio.AbstractEventLoop] = None,
              timeout: Optional[float] = None):
        fut, done, fail = _future_pair(loop, result_factory=lambda st, ln: (st, ln))
        self.recv(buffer, tag, tag_mask, done, fail, timeout=timeout)
        return fut

    # ---------------------------------------------------------------- flush
    def flush(self, done_callback: Callable[[], None],
              fail_callback: Callable[[str], None],
              timeout: Optional[float] = None) -> None:
        self._server.submit_flush(done_callback, fail_callback, timeout=timeout)

    def aflush(self, loop: Optional[asyncio.AbstractEventLoop] = None,
               timeout: Optional[float] = None):
        fut, done, fail = _future_pair(loop)
        self.flush(done, fail, timeout=timeout)
        return fut

    def flush_ep(self, client_ep: ServerEndpoint, done_callback: Callable[[], None],
                 fail_callback: Callable[[str], None],
                 timeout: Optional[float] = None) -> None:
        self._server.submit_flush(done_callback, fail_callback, [client_ep._conn],
                                  timeout=timeout)

    def aflush_ep(self, client_ep: ServerEndpoint,
                  loop: Optional[asyncio.AbstractEventLoop] = None,
                  timeout: Optional[float] = None):
        fut, done, fail = _future_pair(loop)
        self.flush_ep(client_ep, done, fail, timeout=timeout)
        return fut

    # ------------------------------------------------------------ telemetry
    def evaluate_perf(self, client_ep: ServerEndpoint, msg_size: int) -> float:
        return self._server.evaluate_perf(client_ep._conn, msg_size)

    def evaluate_perf_detail(self, client_ep: ServerEndpoint,
                             msg_size: int) -> dict:
        """:meth:`evaluate_perf` plus ``calibrated``/``source`` honesty
        fields — a live per-endpoint fit, a live class fit, and a
        spec-sheet prior all say which they are (perf.py)."""
        return self._server.evaluate_perf_detail(client_ep._conn, msg_size)

    def __del__(self):
        try:
            self._server.force_close()
        except Exception:
            pass


class Client:
    """Connecting side.  Reference: class Client, src/starway/__init__.py:212-348."""

    def __init__(self):
        self._client = _new_client_worker()

    # -------------------------------------------------------------- connect
    def _aconnect_once(self, target, loop, timeout):
        """One connect attempt on the current (fresh) worker; returns an
        awaitable resolving to None or raising Exception(reason)."""
        fut, done, fail = _future_pair(loop)

        def connection_cb(status: str):
            if status == "":
                logger.debug("starway client connected to %s", target)
                done()
            else:
                fail(status)

        if isinstance(target, bytes):
            self._client.connect_address(target, connection_cb, timeout=timeout)
        else:
            addr, port = target
            self._client.connect(addr, port, connection_cb, timeout=timeout)
        return fut

    def _aconnect(self, target, loop, timeout, retries, backoff):
        """Connect with optional per-attempt ``timeout`` and ``retries``
        failed attempts retried under exponential backoff + jitter.  Workers
        are connect-once (the reference contract), so every retry swaps in a
        fresh engine worker -- callers never observe the churn.
        """
        if retries == 0 and timeout is None:
            return self._aconnect_once(target, loop, None)

        async def attempt_loop():
            last: Exception = Exception("connect: no attempt made")
            for attempt in range(retries + 1):
                if attempt > 0:
                    # Reconnect-attempt accounting is process-global by
                    # nature: every retry burns the old worker, so no
                    # single worker's registry could carry it.
                    swtrace.GLOBAL.reconnects += 1
                    # Exponential backoff, full jitter in [delay/2, delay]:
                    # a fleet of clients chasing one restarted server must
                    # not reconnect in lockstep.
                    delay = backoff * (2 ** (attempt - 1))
                    await asyncio.sleep(delay * (0.5 + random.random() / 2))
                    # Connect-once: fresh engine per attempt.  The burnt
                    # worker is force-closed, not just dropped -- a
                    # wait_for-expired attempt may still complete its
                    # handshake in the background and would otherwise leak
                    # a live engine thread + a ghost conn on the server.
                    old, self._client = self._client, _new_client_worker()
                    try:
                        old.force_close()
                    except Exception:
                        pass
                fut = self._aconnect_once(target, loop, timeout)
                try:
                    if timeout is not None:
                        await asyncio.wait_for(fut, timeout)
                    else:
                        await fut
                    return
                except asyncio.TimeoutError:
                    last = Exception(f"{REASON_TIMEOUT} (connect attempt {attempt + 1})")
                except Exception as e:  # "not connected: ..." from the engine
                    last = e
            # Out of attempts: retire the final burnt worker too (its
            # engine may still finish the handshake in the background) and
            # leave a fresh VOID worker so the Client can aconnect again.
            burnt, self._client = self._client, _new_client_worker()
            try:
                burnt.force_close()
            except Exception:
                pass
            raise last

        coro = attempt_loop()
        try:
            # Schedule eagerly when a loop is running: the return value then
            # behaves like the no-retry path's Future (connect underway
            # without an await, add_done_callback available).
            return asyncio.ensure_future(coro)
        except RuntimeError:
            return coro  # no running loop: caller awaits to drive it

    def aconnect(self, addr: str, port: int,
                 loop: Optional[asyncio.AbstractEventLoop] = None,
                 timeout: Optional[float] = None,
                 retries: int = 0, backoff: float = 0.5):
        """Connect to ``addr:port``.

        ``timeout`` bounds each attempt (default: the
        ``STARWAY_CONNECT_TIMEOUT`` knob, see config.py); ``retries`` extra
        attempts run under exponential backoff (base ``backoff`` seconds)
        with jitter.  Failure raises with a stable reason keyword:
        ``"not connected"`` (refused / reset / handshake failure) or
        ``"timed out"`` (deadline elapsed).
        """
        return self._aconnect((addr, port), loop, timeout, retries, backoff)

    def aconnect_address(self, remote_address: bytes,
                         loop: Optional[asyncio.AbstractEventLoop] = None,
                         timeout: Optional[float] = None,
                         retries: int = 0, backoff: float = 0.5):
        return self._aconnect(bytes(remote_address), loop, timeout, retries, backoff)

    def get_worker_address(self) -> bytes:
        return self._client.get_worker_address()

    # ---------------------------------------------------------------- close
    def aclose(self, loop: Optional[asyncio.AbstractEventLoop] = None):
        fut, done, _ = _future_pair(loop)

        def close_cb():
            logger.debug("starway client closed")
            done()

        self._client.close(close_cb)
        return fut

    # ----------------------------------------------------------------- send
    def send(self, buffer, tag: int, done_callback: Callable[[], None],
             fail_callback: Callable[[str], None],
             timeout: Optional[float] = None) -> None:
        """``timeout`` (seconds) bounds local completion (host payloads;
        see Server.send)."""
        if _is_device_payload(buffer):
            from . import device

            device.send_device(self._client, self._client.primary_conn, buffer,
                               _tag(tag), done_callback, fail_callback)
            return
        owner, view = _send_view(buffer)
        self._client.submit_send(self._client.primary_conn, view, _tag(tag),
                                 done_callback, fail_callback, owner,
                                 timeout=timeout)

    def asend(self, buffer, tag: int,
              loop: Optional[asyncio.AbstractEventLoop] = None,
              timeout: Optional[float] = None):
        fut, done, fail = _future_pair(loop)
        self.send(buffer, tag, done, fail, timeout=timeout)
        return fut

    # ----------------------------------------------------------------- recv
    def recv(self, buffer, tag: int, tag_mask: int,
             done_callback: Callable[[int, int], None],
             fail_callback: Callable[[str], None],
             timeout: Optional[float] = None) -> None:
        """``timeout`` (seconds) fails an unmatched receive with
        ``"timed out"``; the buffer is immediately safe to repost."""
        if _is_device_payload(buffer):
            from . import device

            device.post_device_recv(self._client, buffer, _tag(tag), _tag(tag_mask),
                                    done_callback, fail_callback)
            return
        owner, view = _recv_view(buffer)
        self._client.post_recv(view, _tag(tag), _tag(tag_mask),
                               done_callback, fail_callback, owner,
                               timeout=timeout)

    def arecv(self, buffer, tag: int, tag_mask: int,
              loop: Optional[asyncio.AbstractEventLoop] = None,
              timeout: Optional[float] = None):
        fut, done, fail = _future_pair(loop, result_factory=lambda st, ln: (st, ln))
        self.recv(buffer, tag, tag_mask, done, fail, timeout=timeout)
        return fut

    # ---------------------------------------------------------------- flush
    def flush(self, done_callback: Callable[[], None],
              fail_callback: Callable[[str], None],
              timeout: Optional[float] = None) -> None:
        self._client.submit_flush(done_callback, fail_callback, timeout=timeout)

    def aflush(self, loop: Optional[asyncio.AbstractEventLoop] = None,
               timeout: Optional[float] = None):
        fut, done, fail = _future_pair(loop)
        self.flush(done, fail, timeout=timeout)
        return fut

    # ------------------------------------------------------------ telemetry
    def evaluate_perf(self, msg_size: int) -> float:
        return self._client.evaluate_perf(self._client.primary_conn, msg_size)

    def evaluate_perf_detail(self, msg_size: int) -> dict:
        """:meth:`evaluate_perf` plus ``calibrated``/``source`` honesty
        fields (perf.py)."""
        return self._client.evaluate_perf_detail(self._client.primary_conn,
                                                 msg_size)

    def __del__(self):
        try:
            self._client.force_close()
        except Exception:
            pass
