"""ServerEndpoint: introspectable snapshot of an accepted peer.

Mirrors the reference's ``ServerEndpoint`` (src/bindings/main.hpp:292-304,
src/starway/_bindings.pyi:10-21): name, local/remote socket coordinates (empty
in worker-address mode, README.md:141-143), and negotiated transports via
``view_transports()``.  Instances are hashable and ordered so they can live in
sets and round-trip through Python, like the reference's ``std::set`` registry
ordered by endpoint pointer (src/bindings/main.cpp:796-809).

The reference stores dangling ``char const*`` views for name/addr (a noted
defect, SURVEY.md "Reference defects"); here everything is owned ``str``.
"""

from __future__ import annotations


class ServerEndpoint:
    __slots__ = ("_conn",)

    def __init__(self, conn):
        self._conn = conn

    @property
    def name(self) -> str:
        return self._conn.peer_name

    @property
    def local_addr(self) -> str:
        return self._conn.local_addr

    @property
    def local_port(self) -> int:
        return self._conn.local_port

    @property
    def remote_addr(self) -> str:
        return self._conn.remote_addr

    @property
    def remote_port(self) -> int:
        return self._conn.remote_port

    def view_transports(self) -> list[tuple[str, str]]:
        """Negotiated (device, transport) pairs, e.g. ``[("shm", "inproc")]``
        or ``[("lo", "tcp")]``; the device plane reports ``("cuda:N", ...)``.
        Analogue of the reference's up-to-8 ``(device, transport)`` pairs
        (src/bindings/main.cpp:796-804)."""
        return self._conn.transports()

    def __hash__(self) -> int:
        return hash(self._conn.conn_id)

    def __eq__(self, other) -> bool:
        return isinstance(other, ServerEndpoint) and other._conn.conn_id == self._conn.conn_id

    def __lt__(self, other: "ServerEndpoint") -> bool:
        return self._conn.conn_id < other._conn.conn_id

    def __repr__(self) -> str:
        return (
            f"<ServerEndpoint name={self.name!r} remote={self.remote_addr}:{self.remote_port} "
            f"transports={self.view_transports()}>"
        )
