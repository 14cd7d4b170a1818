"""Process-local fabric registry for the in-process fast path.

The reference's loopback tests run two UCX workers in one process and UCX
negotiates a shared-memory transport between them (SURVEY.md section 4).  The
TPU build makes that path explicit: servers register their listen coordinates
here, and a client connecting to a registered address attaches directly --
messages then move with a single memcpy (host buffers) or a device-to-device
ICI transfer (jax.Array buffers) with no socket in between.

Disable with ``STARWAY_TLS`` not containing ``inproc`` to force the real TCP
path even within one process (useful for transport tests).
"""

from __future__ import annotations

import threading
import weakref

_lock = threading.Lock()
_by_sockaddr: dict[tuple[str, int], "weakref.ReferenceType"] = {}
_by_worker_id: dict[str, "weakref.ReferenceType"] = {}

_WILDCARDS = ("0.0.0.0", "::", "")


def register(worker, addr: str, port: int) -> None:
    ref = weakref.ref(worker)
    with _lock:
        _by_worker_id[worker.worker_id] = ref
        if port:
            _by_sockaddr[(addr, port)] = ref
            if addr in _WILDCARDS:
                _by_sockaddr[("127.0.0.1", port)] = ref


def register_worker(worker) -> None:
    with _lock:
        _by_worker_id[worker.worker_id] = weakref.ref(worker)


def unregister(worker) -> None:
    with _lock:
        _by_worker_id.pop(worker.worker_id, None)
        dead = [k for k, ref in _by_sockaddr.items() if ref() is worker or ref() is None]
        for k in dead:
            _by_sockaddr.pop(k, None)


def lookup_sockaddr(addr: str, port: int):
    with _lock:
        ref = _by_sockaddr.get((addr, port))
        if ref is None and addr == "localhost":
            ref = _by_sockaddr.get(("127.0.0.1", port))
        return ref() if ref is not None else None


def lookup_worker_id(worker_id: str):
    with _lock:
        ref = _by_worker_id.get(worker_id)
        return ref() if ref is not None else None
