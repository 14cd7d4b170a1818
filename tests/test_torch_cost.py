"""The port's swcost runtime twin: the port's engines held to the port's
static cost ledger (the twin of tests/test_cost.py).

The ``cost`` gate leg pins per-path syscall/copy/alloc/lock SITE counts
for both of the port's engines in analysis/cost_budgets.txt
(``python -m starway_tpu_torch.analysis``); these tests pin the other
half of the conformance loop: driving a canonical eager op sequence over
all four engine pairings and checking the ``io_syscalls``/``hot_copies``
counter deltas against the extractor's own site vectors.  The bounds are
DERIVED from the extraction at runtime, so the coupling cuts both ways:
extraction going stale (zero sites while the counters move) fails here,
and instrumentation going dark (sites present, counters frozen) fails
here -- neither can pass vacuously.

Seed darkness: the twin is a pair of unconditional counter increments at
sites that already maintain ``bytes_tx``/``bytes_rx`` -- no new branch,
no wire bytes, no handshake key (HELLO parity pinned below).
"""

import asyncio
import json
import socket
from pathlib import Path

import numpy as np
import pytest

from starway_tpu_torch import Client, Server
from starway_tpu_torch.core import frames, swtrace

pytestmark = pytest.mark.asyncio

REPO = Path(__file__).resolve().parents[1]
ADDR = "127.0.0.1"
MASK = (1 << 64) - 1
ENGINES = ["python", "native"]

#: Canonical op sequence: K eager sends of NBYTES each, plus one flush.
K, NBYTES = 8, 4096

#: Dynamic ceiling per extracted syscall site: the pumps loop (a recv
#: drains until EAGAIN, a gather retries on partial writes), so one
#: static site executes a small multiple of times per op.  Generous on
#: purpose -- the *static* budget is the precise ratchet; this bound
#: only has to catch an instrumentation/extraction split, not a
#: one-syscall drift.
EXECS_PER_SITE = 8
BASE_SLACK = 64  # handshake, doorbells, keepalive, the flush frame


def _native_available() -> bool:
    from starway_tpu_torch.core import native

    return native.available()


def _static_vectors():
    from starway_tpu_torch.analysis import clear_caches, cost

    clear_caches()
    vectors, vacuity = cost.extract(REPO)
    assert vacuity == [], [f.render() for f in vacuity]
    return vectors


def _sites(vectors, engine: str, metric: str, paths=None) -> int:
    return sum(v for (e, p, m), v in vectors.items()
               if e == engine and m == metric
               and (paths is None or p in paths))


def _env(monkeypatch):
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_DEVPULL", "0")
    monkeypatch.delenv("STARWAY_TRACE", raising=False)
    monkeypatch.delenv("STARWAY_FLIGHT_DIR", raising=False)
    swtrace.reset()


async def _drive(server, client):
    sinks = [np.empty(NBYTES, dtype=np.uint8) for _ in range(K)]
    futs = [server.arecv(b, 0x600 + i, MASK) for i, b in enumerate(sinks)]
    await asyncio.sleep(0.05)
    await asyncio.gather(
        *(client.asend(np.full(NBYTES, i + 1, dtype=np.uint8), 0x600 + i)
          for i in range(K)))
    await asyncio.gather(*futs)
    await client.aflush()


@pytest.mark.parametrize("server_engine", ENGINES)
@pytest.mark.parametrize("client_engine", ENGINES)
async def test_counter_twin_matches_static_ledger(port, monkeypatch,
                                                  client_engine,
                                                  server_engine):
    """All four pairings: the canonical eager sequence moves io_syscalls
    within the extraction-derived envelope, keeps hot_copies at the
    ledger's tcp prediction (zero -- the tcp data path is copy-free), and
    populates the §25 swpulse histograms without adding a ledger site."""
    if "native" in (client_engine, server_engine) and not _native_available():
        pytest.skip("native engine unavailable")
    vectors = _static_vectors()
    ce = "cpp" if client_engine == "native" else "py"
    se = "cpp" if server_engine == "native" else "py"

    _env(monkeypatch)
    monkeypatch.setenv("STARWAY_NATIVE",
                       "1" if server_engine == "native" else "0")
    server = Server()
    server.listen(ADDR, port)
    monkeypatch.setenv("STARWAY_NATIVE",
                       "1" if client_engine == "native" else "0")
    client = Client()
    await client.aconnect(ADDR, port)
    try:
        await _drive(server, client)
        cs = client._client.counters_snapshot()
        ss = server._server.counters_snapshot()
        ch = client._client.hists_snapshot()
        sh = server._server.hists_snapshot()
    finally:
        await client.aclose()
        await server.aclose()

    # The twin rides the shared vocabulary on both engines.
    for snap in (cs, ss):
        assert "io_syscalls" in snap and "hot_copies" in snap

    # swpulse (DESIGN.md §25) rides the SAME certified hot path without
    # moving the §23 ledger: the gate's cost leg pins zero new sites, so
    # conformance here is "the histograms populated anyway" -- on all
    # four pairings, in the one shared shape.
    for snap in (ch, sh):
        assert sorted(snap) == sorted(swtrace.HIST_NAMES)
        assert all(len(row) == swtrace.HIST_BUCKETS for row in snap.values())
    assert sum(ch["send_local_us"]) >= K, ch
    assert sum(ch["msg_bytes"]) >= K, ch
    assert sum(ch["flush_us"]) >= 1, ch
    assert sum(sh["recv_wait_us"]) >= K, sh

    for engine, snap, role in ((ce, cs, "client"), (se, ss, "server")):
        sites = _sites(vectors, engine, "syscalls")
        got = snap["io_syscalls"]
        if sites == 0:
            # Extraction sees no syscall sites: the counters must agree,
            # or the site table went stale (the non-vacuity direction).
            assert got == 0, (
                f"{role} ({engine}): io_syscalls moved to {got} but the "
                "static extraction finds zero syscall sites -- "
                "analysis/cost.py's tables are stale")
        else:
            assert got >= 1, (
                f"{role} ({engine}): {sites} static syscall sites but "
                "io_syscalls never moved -- the §23 runtime twin is dark")
            bound = K * sites * EXECS_PER_SITE + BASE_SLACK
            assert got <= bound, (
                f"{role} ({engine}): io_syscalls={got} exceeds the "
                f"extraction-derived envelope {bound} (K={K} ops x "
                f"{sites} sites x {EXECS_PER_SITE} execs + {BASE_SLACK})")
        # tcp transport: the ledger pins zero copy sites on the eager
        # tcp path, so the dynamic twin must not move either.
        tcp_copy_sites = _sites(vectors, engine, "copies",
                                paths=("eager_tx", "eager_rx", "dispatch"))
        assert tcp_copy_sites == 0, (
            f"{engine}: the eager tcp path grew a copy site -- the "
            "cost gate should have caught this in cost_budgets.txt")
        assert snap["hot_copies"] == 0, (
            f"{role} ({engine}): hot_copies={snap['hot_copies']} on a "
            "pure-tcp run -- the tcp data path is pinned copy-free")


@pytest.mark.parametrize("engine", ENGINES)
async def test_counter_twin_sm_copies(port, monkeypatch, engine):
    """Over the sm ring the same sequence pays exactly the ledger's
    copy asymmetry: hot_copies moves on both ends (ring put/take are
    real byte copies), matching the nonzero sm_enqueue/sm_dequeue copy
    rows that the tcp paths do not have."""
    import platform

    if platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("python sm transport requires x86-64")
    if engine == "native" and not _native_available():
        pytest.skip("native engine unavailable")
    vectors = _static_vectors()
    e = "cpp" if engine == "native" else "py"
    assert _sites(vectors, e, "copies", paths=("sm_enqueue",)) > 0
    assert _sites(vectors, e, "copies", paths=("sm_dequeue",)) > 0

    _env(monkeypatch)
    monkeypatch.setenv("STARWAY_TLS", "tcp,sm")
    monkeypatch.setenv("STARWAY_NATIVE", "1" if engine == "native" else "0")
    server = Server()
    server.listen(ADDR, port)
    client = Client()
    await client.aconnect(ADDR, port)
    try:
        await _drive(server, client)
        cs = client._client.counters_snapshot()
        ss = server._server.counters_snapshot()
    finally:
        await client.aclose()
        await server.aclose()

    assert cs["hot_copies"] >= 1, (
        "sender on sm: ring put never counted -- the §23 copy twin is "
        f"dark ({cs})")
    assert ss["hot_copies"] >= 1, (
        "receiver on sm: ring take never counted -- the §23 copy twin "
        f"is dark ({ss})")


async def test_seed_path_stays_dark(port):
    """The runtime twin adds NO wire surface: the HELLO carries no new
    key (counters are not negotiated -- both engines always count), and
    the counter names land in the one shared vocabulary instead of a
    side channel."""
    assert "io_syscalls" in swtrace.COUNTER_NAMES
    assert "hot_copies" in swtrace.COUNTER_NAMES

    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((ADDR, port))
    listener.listen(4)
    client = Client()
    try:
        fut = client.aconnect(ADDR, port)
        conn, _ = listener.accept()
        conn.settimeout(10)
        hdr = b""
        while len(hdr) < frames.HEADER_SIZE:
            hdr += conn.recv(frames.HEADER_SIZE - len(hdr))
        ftype, _a, blen = frames.unpack_header(hdr)
        assert ftype == frames.T_HELLO
        body = b""
        while len(body) < blen:
            body += conn.recv(blen - len(body))
        conn.sendall(frames.pack_hello_ack("seedpeer"))
        await asyncio.wait_for(fut, 30)
        conn.close()
        hello = json.loads(body.decode())
    finally:
        listener.close()
        try:
            await asyncio.wait_for(client.aclose(), 10)
        except Exception:
            pass
    assert not any("cost" in k or "syscall" in k or "copies" in k
                   for k in hello), hello
