"""The engine worker contract — typed interface both engines implement.

This is the TPU build's equivalent of the reference's hand-written type stub
``src/starway/_bindings.pyi`` (SURVEY component #15): the contract the public
Python layer (:mod:`starway_tpu_torch.api`) codes against.  The reference pins its
nanobind surface with a ``.pyi``; here the same role is played by structural
:class:`typing.Protocol` classes, which a test can additionally *enforce*
against both implementations (the reference's stub was unchecked).

Two implementations must satisfy these protocols and stay interoperable on
the wire (core/frames.py):

* the pure-Python event-loop engine (``core/engine.py``), and
* the C++ epoll engine behind a ctypes bridge (``native/sw_engine.cpp`` +
  ``core/native.py``).

Callback conventions (reference: src/starway/_bindings.pyi:30-90):

* ``done_callback`` for sends/flushes takes no arguments.
* ``done_callback`` for recvs takes ``(sender_tag, length)``.
* ``fail_callback`` takes a single ``reason`` string; cancellation reasons
  contain the substring ``"cancel"`` (pinned by tests/test_basic.py);
  deadline expiry reasons contain ``"timed out"`` (tests/test_faults.py).
* Connect callbacks take a status string, ``""`` meaning success.
* Callbacks may be invoked from the engine thread but never while any worker
  lock is held.
* ``timeout`` (seconds, ``None`` = unbounded) is an optional per-op
  deadline both engines honour: an op not settled when it fires fails with
  the stable ``"timed out"`` keyword and releases its transport/matcher
  resources (a timed-out receive's buffer is immediately repostable).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Protocol, runtime_checkable

#: Send/flush completion: no arguments.
DoneCallback = Callable[[], None]
#: Recv completion: (sender_tag, length).
RecvDoneCallback = Callable[[int, int], None]
#: Failure: human-readable reason (contains "cancel" when cancelled).
FailCallback = Callable[[str], None]
#: Connect result: "" on success, reason string on failure.
ConnectCallback = Callable[[str], None]


@runtime_checkable
class ConnectionLike(Protocol):
    """A peer connection as seen by the matcher and endpoint layer.

    Reference analogue: the ``ucp_ep_h`` + attribute snapshot inside
    ``ServerEndpoint`` (src/bindings/main.hpp:292-304).

    All identity fields are *read attributes* — plain data attributes on the
    Python engine's ``BaseConn`` (core/conn.py), properties on the native
    engine's ``NativeConn`` (core/native.py).  Only ``transports()`` is a
    method (endpoint.py calls it as one).
    """

    conn_id: int
    peer_name: str
    alive: bool
    mode: str
    local_addr: str
    local_port: int
    remote_addr: str
    remote_port: int

    def transports(self) -> list[tuple[str, str]]: ...


@runtime_checkable
class WorkerProtocol(Protocol):
    """Operations shared by client and server workers.

    Reference analogue: the common surface of ``_bindings.Client`` /
    ``_bindings.Server`` (src/starway/_bindings.pyi:23-90).
    """

    def submit_send(self, conn, view, tag: int,
                    done: DoneCallback, fail: FailCallback,
                    owner=None, timeout: Optional[float] = None) -> None: ...

    def post_recv(self, buf, tag: int, mask: int,
                  done: RecvDoneCallback, fail: FailCallback,
                  owner=None, timeout: Optional[float] = None) -> None: ...

    def submit_flush(self, done: DoneCallback, fail: FailCallback,
                     conns: Optional[Iterable] = None,
                     timeout: Optional[float] = None) -> None: ...

    def close(self, cb: DoneCallback) -> None: ...

    def force_close(self) -> None: ...

    def get_worker_address(self) -> bytes: ...

    def evaluate_perf(self, conn, msg_size: int) -> float: ...

    def evaluate_perf_detail(self, conn, msg_size: int) -> dict: ...


@runtime_checkable
class ClientWorkerProtocol(WorkerProtocol, Protocol):
    """Connecting-side worker (reference: _bindings.pyi:60-90)."""

    @property
    def primary_conn(self): ...

    def connect(self, addr: str, port: int, cb: ConnectCallback,
                timeout: Optional[float] = None) -> None: ...

    def connect_address(self, blob: bytes, cb: ConnectCallback,
                        timeout: Optional[float] = None) -> None: ...


@runtime_checkable
class ServerWorkerProtocol(WorkerProtocol, Protocol):
    """Accepting-side worker (reference: _bindings.pyi:23-58)."""

    def listen(self, addr: str, port: int) -> None: ...

    def listen_address(self) -> bytes: ...

    def set_accept_cb(self, cb) -> None: ...

    def list_clients(self) -> set: ...


__all__ = [
    "ConnectionLike",
    "WorkerProtocol",
    "ClientWorkerProtocol",
    "ServerWorkerProtocol",
    "DoneCallback",
    "RecvDoneCallback",
    "FailCallback",
    "ConnectCallback",
]
