"""The fault-tolerance tests of tests/test_faults.py, run on the port.

Every tier-1 scenario of the JAX package's suite (the slow soak aside),
on ``starway_tpu_torch``'s ``Server``/``Client`` and its copy of the fault
proxy (:class:`starway_tpu_torch.testing.faults.FaultProxy`), on both
engines and the mixed engine pairings: deadlines, mid-frame drops and
truncation, keepalive liveness, reconnect, the frame-aware session modes,
the corrupt mode and malformed control frames.  One case more crosses the
packages: a JAX peer against a port peer through the proxy with the
keepalive on, both directions, each answering the other's PINGs until a
partition kills the link on both sides.

Wall-clock bounds are deliberately loose: they prove "bounded, not hung",
not latency.
"""

import asyncio
import time

import numpy as np
import pytest

from starway_tpu_torch import Client, Server
from starway_tpu_torch.testing.faults import FaultProxy

pytestmark = pytest.mark.asyncio

ADDR = "127.0.0.1"


@pytest.fixture(params=["py", "native"])
def engine(request, monkeypatch):
    """Both engines behind the one worker contract.  Workers
    sample the env at construction, so this must run before Server()/
    Client() are built."""
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    if request.param == "native":
        from starway_tpu_torch.core import native

        if not native.available():
            pytest.skip("native engine unavailable (no toolchain)")
        monkeypatch.setenv("STARWAY_NATIVE", "1")
    else:
        monkeypatch.setenv("STARWAY_NATIVE", "0")
    return request.param


async def _aclose_all(*objs):
    for o in objs:
        try:
            await asyncio.wait_for(o.aclose(), timeout=10)
        except Exception:
            pass


async def _roundtrip(client, server, tag, n=64):
    buf = np.zeros(n, dtype=np.uint8)
    fut = server.arecv(buf, tag, (1 << 64) - 1)
    await client.asend((np.arange(n) % 256).astype(np.uint8), tag)
    stag, ln = await asyncio.wait_for(fut, timeout=15)
    assert stag == tag and ln == n
    np.testing.assert_array_equal(buf, (np.arange(n) % 256).astype(np.uint8))


# --------------------------------------------------------------- deadlines


async def test_recv_timeout_and_repost(engine, port):
    """An unmatched arecv with a deadline fails "timed out" and its buffer
    is immediately safe to repost (the regression the matcher's
    expire/purge path pins)."""
    server = Server()
    server.listen(ADDR, port)
    client = Client()
    await client.aconnect(ADDR, port)
    try:
        buf = np.zeros(128, dtype=np.uint8)
        t0 = time.monotonic()
        with pytest.raises(Exception) as e:
            await asyncio.wait_for(server.arecv(buf, 0x5, (1 << 64) - 1, timeout=0.4),
                                   timeout=10)
        assert "timed out" in str(e.value).lower()
        assert time.monotonic() - t0 < 5.0
        # Repost the SAME buffer: the matcher must have fully released it.
        fut = server.arecv(buf, 0x5, (1 << 64) - 1)
        await client.asend(np.arange(128, dtype=np.uint8), 0x5)
        _, ln = await asyncio.wait_for(fut, timeout=15)
        assert ln == 128
        np.testing.assert_array_equal(buf, np.arange(128, dtype=np.uint8))
    finally:
        await _aclose_all(client, server)


async def test_recv_timeout_midstream_partition(engine, port):
    """A receive claimed by a message that stalls mid-stream (link
    partitioned inside the frame) still honours its deadline, and the
    partial never lands in the caller's buffer as a completion."""
    server = Server()
    server.listen(ADDR, port)
    proxy = FaultProxy(ADDR, port, partition_after=100_000).start()
    client = Client()
    await client.aconnect(ADDR, proxy.port)
    try:
        n = 1 << 20  # eager (default rndv threshold is 8 MiB)
        buf = np.zeros(n, dtype=np.uint8)
        fut = server.arecv(buf, 0x6, (1 << 64) - 1, timeout=0.6)
        await client.asend(np.ones(n, dtype=np.uint8), 0x6)
        t0 = time.monotonic()
        with pytest.raises(Exception) as e:
            await asyncio.wait_for(fut, timeout=15)
        assert "timed out" in str(e.value).lower()
        assert time.monotonic() - t0 < 10.0
    finally:
        await _aclose_all(client, server)
        proxy.stop()


async def test_partition_flush_timeout(engine, port):
    """A flush whose FLUSH_ACK is swallowed by a partition fails "timed
    out" at its deadline instead of hanging forever."""
    server = Server()
    server.listen(ADDR, port)
    proxy = FaultProxy(ADDR, port).start()
    client = Client()
    await client.aconnect(ADDR, proxy.port)
    try:
        await _roundtrip(client, server, 0x1)
        proxy.partition()
        await client.asend(np.arange(256, dtype=np.uint8), 0x2)  # eager, local
        t0 = time.monotonic()
        with pytest.raises(Exception) as e:
            await asyncio.wait_for(client.aflush(timeout=0.6), timeout=15)
        assert "timed out" in str(e.value).lower()
        assert time.monotonic() - t0 < 10.0
    finally:
        await _aclose_all(client, server)
        proxy.stop()


async def test_send_timeout_wedged_socket(engine, port, monkeypatch):
    """A send that cannot even begin transmission (socket wedged behind a
    stalled peer) fails "timed out" and is withdrawn without corrupting
    the stream (the in-front rendezvous send keeps its place)."""
    monkeypatch.setenv("STARWAY_RNDV_THRESHOLD", str(1 << 20))
    server = Server()
    server.listen(ADDR, port)
    proxy = FaultProxy(ADDR, port).start()
    client = Client()
    await client.aconnect(ADDR, proxy.port)
    try:
        await _roundtrip(client, server, 0x1)
        proxy.partition()
        proxy.stall()
        # Fill the kernel pipe: rndv send completes locally at header write
        # and then wedges mid-payload at the queue front.
        big = np.zeros(64 << 20, dtype=np.uint8)
        await asyncio.wait_for(client.asend(big, 0x2), timeout=30)
        t0 = time.monotonic()
        with pytest.raises(Exception) as e:
            await asyncio.wait_for(
                client.asend(np.arange(64, dtype=np.uint8), 0x3, timeout=0.5),
                timeout=15)
        assert "timed out" in str(e.value).lower()
        assert time.monotonic() - t0 < 10.0
    finally:
        await _aclose_all(client, server)
        proxy.stop()


# --------------------------------------------------- hard connection faults


async def test_drop_midframe_fails_flush(engine, port):
    """Mid-frame RST: the sender's flush fails with a stable keyword
    instead of hanging; the receiver's claimed partial never completes."""
    server = Server()
    server.listen(ADDR, port)
    proxy = FaultProxy(ADDR, port, mode="drop", limit_bytes=300_000).start()
    client = Client()
    await client.aconnect(ADDR, proxy.port)
    try:
        n = 1 << 20
        sink = np.zeros(n, dtype=np.uint8)
        recv_done = []
        server.recv(sink, 0x9, (1 << 64) - 1,
                    lambda t, ln: recv_done.append("done"),
                    lambda r: recv_done.append(r))
        await client.asend(np.ones(n, dtype=np.uint8), 0x9)
        with pytest.raises(Exception) as e:
            await asyncio.wait_for(client.aflush(timeout=10), timeout=30)
        msg = str(e.value).lower()
        assert "not connected" in msg or "cancel" in msg or "timed out" in msg
        await asyncio.sleep(0.3)
        assert not recv_done  # claimed partial stays pending (seed contract)
    finally:
        await _aclose_all(client, server)
        proxy.stop()


async def test_truncate_midframe_breaks_conn(engine, port):
    """Clean EOF in the middle of a frame: the conn is declared broken and
    a dirty flush fails instead of passing vacuously."""
    server = Server()
    server.listen(ADDR, port)
    proxy = FaultProxy(ADDR, port, mode="truncate", limit_bytes=200_000).start()
    client = Client()
    await client.aconnect(ADDR, proxy.port)
    try:
        await client.asend(np.ones(1 << 20, dtype=np.uint8), 0xA)
        with pytest.raises(Exception) as e:
            await asyncio.wait_for(client.aflush(timeout=10), timeout=30)
        msg = str(e.value).lower()
        assert "not connected" in msg or "cancel" in msg or "timed out" in msg
    finally:
        await _aclose_all(client, server)
        proxy.stop()


# ---------------------------------------------------------------- liveness


async def test_keepalive_partition_fails_recv(engine, port, monkeypatch):
    """A partitioned (silent, no RST) peer is declared dead after the
    keepalive window and pending receives fail "not connected" -- bounded
    by ~2x the configured window, not forever."""
    monkeypatch.setenv("STARWAY_KEEPALIVE", "0.15")
    monkeypatch.setenv("STARWAY_KEEPALIVE_MISSES", "2")
    server = Server()
    server.listen(ADDR, port)
    proxy = FaultProxy(ADDR, port).start()
    client = Client()
    await client.aconnect(ADDR, proxy.port)
    try:
        await _roundtrip(client, server, 0x1)
        fut = client.arecv(np.zeros(64, dtype=np.uint8), 0x2, (1 << 64) - 1)
        await asyncio.sleep(0)  # recv posted before the lights go out
        proxy.partition()
        t0 = time.monotonic()
        with pytest.raises(Exception) as e:
            await asyncio.wait_for(fut, timeout=20)
        assert "not connected" in str(e.value).lower()
        # window = interval * misses = 0.3s; generous 1-core bound.
        assert time.monotonic() - t0 < 10.0
    finally:
        await _aclose_all(client, server)
        proxy.stop()


async def test_keepalive_off_seed_parity(engine, port):
    """With keepalive unset (the default), a partitioned peer leaves posted
    receives pending -- the seed contract (tests/test_basic.py) unchanged."""
    server = Server()
    server.listen(ADDR, port)
    proxy = FaultProxy(ADDR, port).start()
    client = Client()
    await client.aconnect(ADDR, proxy.port)
    try:
        await _roundtrip(client, server, 0x1)
        outcome = []
        client.recv(np.zeros(64, dtype=np.uint8), 0x2, (1 << 64) - 1,
                    lambda t, ln: outcome.append("done"),
                    lambda r: outcome.append(r))
        proxy.partition()
        await asyncio.sleep(1.0)
        assert not outcome  # still pending: no liveness, no deadline
    finally:
        await _aclose_all(client, server)
        proxy.stop()


@pytest.mark.parametrize(
    "server_native,client_native",
    [(False, True), (True, False)],
    ids=["py-server/native-client", "native-server/py-client"],
)
async def test_keepalive_mixed_engine_interop(port, monkeypatch,
                                              server_native, client_native):
    """PING/PONG is a cross-engine wire contract: mixed pairings must (a)
    keep a healthy-but-idle conn alive across several keepalive windows --
    each engine answering the other's PINGs -- and (b) both declare death
    after a partition (satellite: the test_sm_engine_interop pattern for
    the ka extension, exercised in both directions)."""
    from starway_tpu_torch.core import native

    if not native.available():
        pytest.skip("native engine unavailable (no toolchain)")
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    # Wide-enough liveness window for a loaded 1-core tier-1 process: a
    # starved engine thread must not miss a whole window and declare a
    # healthy peer dead mid-test (noted load-flaky at 0.15s x 2).
    monkeypatch.setenv("STARWAY_KEEPALIVE", "0.3")
    monkeypatch.setenv("STARWAY_KEEPALIVE_MISSES", "4")
    monkeypatch.setenv("STARWAY_NATIVE", "1" if server_native else "0")
    server = Server()
    server.listen(ADDR, port)
    monkeypatch.setenv("STARWAY_NATIVE", "1" if client_native else "0")
    client = Client()
    proxy = FaultProxy(ADDR, port).start()
    await client.aconnect(ADDR, proxy.port)
    try:
        await _roundtrip(client, server, 0x1)
        # Idle across > misses * interval: only PONGs keep the link alive.
        await asyncio.sleep(1.5)
        await _roundtrip(client, server, 0x2)  # both directions still deliver
        # Now the partition: both sides must detect death, so the client's
        # pending receive AND the server's pending receive fail.
        cfut = client.arecv(np.zeros(64, dtype=np.uint8), 0x3, (1 << 64) - 1)
        sfut = server.arecv(np.zeros(64, dtype=np.uint8), 0x4, (1 << 64) - 1)
        await asyncio.sleep(0)
        proxy.partition()
        for fut in (cfut, sfut):
            with pytest.raises(Exception) as e:
                await asyncio.wait_for(fut, timeout=20)
            assert "not connected" in str(e.value).lower()
    finally:
        await _aclose_all(client, server)
        proxy.stop()


# --------------------------------------------------------------- reconnect


async def test_connect_retries_backoff(engine, port):
    """aconnect(retries=, backoff=): a server that comes up late is reached
    by the retry loop (fresh connect-once worker per attempt)."""
    client = Client()
    server = Server()

    async def late_listen():
        await asyncio.sleep(0.4)
        server.listen(ADDR, port)

    task = asyncio.ensure_future(late_listen())
    try:
        await asyncio.wait_for(
            client.aconnect(ADDR, port, retries=6, backoff=0.1), timeout=30)
        await _roundtrip(client, server, 0x1)
    finally:
        await task
        await _aclose_all(client, server)


async def test_connect_timeout_configurable(engine, port, monkeypatch):
    """STARWAY_CONNECT_TIMEOUT bounds a handshake against an accept-then-
    silent peer (blackhole) in both engines -- replacing the old hard-coded
    3 s constant."""
    monkeypatch.setenv("STARWAY_CONNECT_TIMEOUT", "0.4")
    proxy = FaultProxy(ADDR, 1, mode="blackhole").start()  # target never dialed
    client = Client()
    t0 = time.monotonic()
    with pytest.raises(Exception) as e:
        await asyncio.wait_for(client.aconnect(ADDR, proxy.port), timeout=20)
    assert "not connected" in str(e.value).lower()
    assert time.monotonic() - t0 < 10.0
    proxy.stop()


async def test_connect_timeout_param_and_retries_exhaust(port):
    """Per-call aconnect(timeout=) overrides the knob; exhausted retries
    surface the last failure with a stable keyword."""
    proxy = FaultProxy(ADDR, 1, mode="blackhole").start()
    client = Client()
    t0 = time.monotonic()
    with pytest.raises(Exception) as e:
        await asyncio.wait_for(
            client.aconnect(ADDR, proxy.port, timeout=0.3, retries=1, backoff=0.1),
            timeout=20)
    msg = str(e.value).lower()
    assert "timed out" in msg or "not connected" in msg
    assert time.monotonic() - t0 < 10.0
    proxy.stop()


# ------------------------------------------ frame-aware session fault modes
#
# duplicate / reorder / reset_mid_message are the injection primitives the
# resilient-session layer's dedup/replay paths are tested with
# (tests/test_session.py drives session-enabled pairs through them).  Here:
# the modes themselves -- frame-aware forwarding must be TRANSPARENT on a
# seed-parity conn (no T_SEQ frames, so there is nothing to duplicate or
# swap), and the byte-exact reset must land exactly where it was armed.


@pytest.mark.parametrize("mode", ["duplicate", "reorder"])
async def test_framed_modes_transparent_without_session(engine, port, mode):
    """Without the session opt-in no frame is sequenced, so the
    frame-aware pump forwards everything untouched: deliveries are
    exactly-once and in order through the reassembling proxy (including a
    payload larger than the proxy's read chunk)."""
    server = Server()
    server.listen(ADDR, port)
    proxy = FaultProxy(ADDR, port, mode=mode).start()
    client = Client()
    await client.aconnect(ADDR, proxy.port)
    try:
        for tag in range(5):
            await _roundtrip(client, server, tag)
        big = 1 << 20  # reassembled across many 64 KiB proxy reads
        sink = np.zeros(big, dtype=np.uint8)
        fut = server.arecv(sink, 0x40, (1 << 64) - 1)
        await client.asend(np.full(big, 7, dtype=np.uint8), 0x40)
        await asyncio.wait_for(client.aflush(), timeout=30)
        _, ln = await asyncio.wait_for(fut, timeout=30)
        assert ln == big and sink[0] == 7 and sink[-1] == 7
    finally:
        await _aclose_all(client, server)
        proxy.stop()


async def test_reset_mid_message_kills_at_exact_byte(engine, port):
    """reset_mid_message(at) forwards client->server traffic up to
    EXACTLY the armed absolute offset -- splitting the chunk that crosses
    it, so the RST genuinely lands mid-frame -- then hard-kills both
    sides (the deterministic death-mid-transfer the session resume tests
    are built on).  On a seed-parity pair the kill is just the usual
    mid-frame fault: the dirty flush fails with a stable keyword."""
    server = Server()
    server.listen(ADDR, port)
    proxy = FaultProxy(ADDR, port).start()
    client = Client()
    await client.aconnect(ADDR, proxy.port)
    try:
        await _roundtrip(client, server, 0x1)  # handshake + one delivery
        at = proxy.forwarded_bytes + 2000  # inside the next 1 MiB payload
        proxy.reset_mid_message(at)
        recv_done = []
        server.recv(np.zeros(1 << 20, dtype=np.uint8), 0x2, (1 << 64) - 1,
                    lambda t, ln: recv_done.append("done"),
                    lambda r: recv_done.append(r))
        # The RST lands 2000 bytes into the 1 MiB frame: depending on how
        # much the kernel buffered first, the send itself and/or the dirty
        # flush fails -- always with a stable keyword, never a hang (and
        # the flush may pass vacuously if the dead conn was already
        # reaped before the barrier was posted).
        for op in (client.asend(np.ones(1 << 20, dtype=np.uint8), 0x2),
                   client.aflush(timeout=10)):
            try:
                await asyncio.wait_for(op, timeout=30)
            except Exception as e:
                msg = str(e).lower()
                assert ("not connected" in msg or "cancel" in msg
                        or "timed out" in msg), msg
        assert proxy.forwarded_bytes == at, (proxy.forwarded_bytes, at)
        await asyncio.sleep(0.3)
        assert not recv_done  # 2000 bytes of 1 MiB: claimed partial pends
    finally:
        await _aclose_all(client, server)
        proxy.stop()


# ------------------------------------------------------------ corrupt mode
#
# The silent-data-corruption generator the §19 integrity plane is tested
# against (tests/test_integrity.py drives integrity-negotiated pairs
# through it).  Here: the mode's own mechanics against raw sockets --
# selector targeting, byte-exact flips, truncation, and single-shot
# transparency afterwards.


def _proxy_roundtrip_frames(proxy_port, target_listener, frames_out):
    """Push crafted wire frames through a proxy c->s and return what the
    'server' side receives."""
    import socket as _socket

    cli = _socket.create_connection((ADDR, proxy_port), timeout=5)
    try:
        up, _addr = target_listener.accept()
        up.settimeout(5)
        cli.sendall(frames_out)
        got = b""
        while len(got) < len(frames_out):
            chunk = up.recv(65536)
            if not chunk:
                break
            got += chunk
        up.close()
        return got
    finally:
        cli.close()


def test_corrupt_mode_flips_one_byte_of_selected_frame(port):
    """corrupt/flip mutates exactly one byte of the first matching frame
    (by type, in the chosen region) and forwards everything else
    verbatim -- single-shot: later matching frames pass untouched."""
    import socket as _socket

    from starway_tpu_torch.core import frames as _frames

    listener = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    listener.bind((ADDR, port))
    listener.listen(4)
    proxy = FaultProxy(ADDR, port, mode="corrupt", corrupt_ftype=3,
                       corrupt_where="payload", corrupt_offset=2).start()
    try:
        payload = bytes(range(32))
        data1 = _frames.pack_data_header(7, len(payload)) + payload
        ping = _frames.pack_ping(0)
        data2 = _frames.pack_data_header(8, len(payload)) + payload
        wire = ping + data1 + data2
        got = _proxy_roundtrip_frames(proxy.port, listener, wire)
        assert len(got) == len(wire)
        assert got[: len(ping)] == ping  # non-matching type untouched
        d1 = got[len(ping): len(ping) + len(data1)]
        assert d1[:_frames.HEADER_SIZE] == data1[:_frames.HEADER_SIZE]
        flipped = [i for i in range(len(payload))
                   if d1[_frames.HEADER_SIZE + i] != payload[i]]
        assert flipped == [2], flipped  # corrupt_offset=2, one byte
        assert got[len(ping) + len(data1):] == data2  # single-shot
        assert proxy.corrupted_units == 1
    finally:
        proxy.stop()
        listener.close()


def test_corrupt_mode_header_and_truncate(port):
    """corrupt_where="header" flips inside the 17-byte header region;
    corrupt_kind="truncate" deletes bytes mid-frame (the stream-desync
    fault).  Selection still keys on the original frame type."""
    import socket as _socket

    from starway_tpu_torch.core import frames as _frames

    listener = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    listener.bind((ADDR, port))
    listener.listen(4)
    payload = bytes(range(48))
    data = _frames.pack_data_header(9, len(payload)) + payload
    proxy = FaultProxy(ADDR, port, mode="corrupt", corrupt_ftype=3,
                       corrupt_where="header", corrupt_offset=3).start()
    try:
        got = _proxy_roundtrip_frames(proxy.port, listener, data)
        assert len(got) == len(data)
        assert got[3] != data[3] and got[_frames.HEADER_SIZE:] == payload
    finally:
        proxy.stop()
        listener.close()
    listener = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    listener.bind((ADDR, 0))
    listener.listen(4)
    tport = listener.getsockname()[1]
    proxy = FaultProxy(ADDR, tport, mode="corrupt", corrupt_ftype=3,
                       corrupt_kind="truncate", corrupt_bytes=5).start()
    try:
        cli = _socket.create_connection((ADDR, proxy.port), timeout=5)
        up, _ = listener.accept()
        up.settimeout(5)
        cli.sendall(data + _frames.pack_ping(0))
        want = len(data) - 5 + _frames.HEADER_SIZE
        got = b""
        while len(got) < want:
            chunk = up.recv(65536)
            if not chunk:
                break
            got += chunk
        assert len(got) == want, (len(got), want)  # 5 bytes vanished
        assert proxy.corrupted_units == 1
        cli.close()
        up.close()
    finally:
        proxy.stop()
        listener.close()


def test_corrupt_mode_glues_csum_prefix(port):
    """A [CSUM][frame] unit stays glued through the framed pump, and the
    flip lands in the FRAME's payload -- never in the prefix -- so the
    receiver sees a checksum that truthfully disagrees with the bytes."""
    import socket as _socket

    from starway_tpu_torch.core import frames as _frames

    listener = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    listener.bind((ADDR, port))
    listener.listen(4)
    proxy = FaultProxy(ADDR, port, mode="corrupt", corrupt_ftype=3).start()
    try:
        payload = bytes(range(64))
        hdr = _frames.pack_data_header(5, len(payload))
        unit = _frames.pack_csum_for(hdr, memoryview(payload)) + hdr + payload
        got = _proxy_roundtrip_frames(proxy.port, listener, unit)
        assert len(got) == len(unit)
        pre_len = _frames.HEADER_SIZE
        assert got[:pre_len] == unit[:pre_len]            # prefix intact
        assert got[pre_len: 2 * pre_len] == hdr           # header intact
        assert got[2 * pre_len:] != payload               # payload flipped
        assert proxy.corrupted_units == 1
    finally:
        proxy.stop()
        listener.close()


async def test_wrong_shape_ctl_body_does_not_kill_worker(engine, port):
    """A ctl frame whose body is not a JSON OBJECT -- valid JSON of the
    wrong shape (``[]``), a ``[``*50k nesting bomb (RecursionError out
    of json.loads, NOT a ValueError), or not JSON at all -- is a
    protocol violation on THAT conn only (the wirefuzz hardening):
    the Python engine used to let the parse/field access raise off the
    event loop and emergency-close the whole worker (every conn with
    it).  Both engines now break the conn on non-object shapes -- the
    C++ brace check also rejects b"{]" (last non-ws byte is not "}") --
    while braced-but-invalid JSON like b"{,}" is the documented residual
    asymmetry (C++'s per-field extractor shrugs where json.loads
    raises), so that case asserts py-only.  Either way the worker must
    keep serving."""
    import socket as _socket

    from starway_tpu_torch.core import frames as _frames

    server = Server()
    server.listen(ADDR, port)
    raws = []
    client = Client()
    try:
        bodies = [b"[]", b'"x"', b"[" * 50000, b"{]"]
        if engine == "py":
            bodies.append(b"{,}")  # braced but invalid: py-only reject
        for body in bodies:
            raw = _socket.create_connection((ADDR, port), timeout=10)
            raw.settimeout(10)
            raw.sendall(_frames.pack_header(_frames.T_HELLO, 0, len(body))
                        + body)
            raws.append(raw)
        # The offending conns are torn down (EOF), never answered.
        for raw in raws:
            assert raw.recv(1) == b"", "bad-ctl conn not closed"
        # The worker survived: a well-formed client still round-trips.
        await asyncio.wait_for(client.aconnect(ADDR, port), 15)
        await _roundtrip(client, server, tag=0x77)
    finally:
        for raw in raws:
            try:
                raw.close()
            except OSError:
                pass
        await _aclose_all(client, server)


# ------------------------------------------------------- across packages


@pytest.mark.parametrize("native", [False, True], ids=["py", "native"])
@pytest.mark.parametrize("server_pkg", ["jax", "port"],
                         ids=["jax-server/port-client",
                              "port-server/jax-client"])
async def test_keepalive_across_packages(port, monkeypatch, server_pkg,
                                         native):
    """PING/PONG between a JAX peer and a port peer through the port's
    proxy: an idle link survives several keepalive windows (each package
    answers the other's PINGs), data flows both ways, and a partition
    fails both sides' pending receives "not connected"."""
    import starway_tpu
    import starway_tpu_torch
    from starway_tpu.core import native as jax_native
    from starway_tpu_torch.core import native as port_native

    if native and not (jax_native.available() and port_native.available()):
        pytest.skip("native engine unavailable (no toolchain)")
    pkgs = {"jax": starway_tpu, "port": starway_tpu_torch}
    client_pkg = "port" if server_pkg == "jax" else "jax"
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "1" if native else "0")
    monkeypatch.setenv("STARWAY_KEEPALIVE", "0.3")
    monkeypatch.setenv("STARWAY_KEEPALIVE_MISSES", "4")
    server = pkgs[server_pkg].Server()
    server.listen(ADDR, port)
    client = pkgs[client_pkg].Client()
    proxy = FaultProxy(ADDR, port).start()
    await client.aconnect(ADDR, proxy.port)
    try:
        await _roundtrip(client, server, 0x1)
        await asyncio.sleep(1.5)
        await _roundtrip(client, server, 0x2)
        cfut = client.arecv(np.zeros(64, dtype=np.uint8), 0x3, (1 << 64) - 1)
        sfut = server.arecv(np.zeros(64, dtype=np.uint8), 0x4, (1 << 64) - 1)
        await asyncio.sleep(0)
        proxy.partition()
        for fut in (cfut, sfut):
            with pytest.raises(Exception) as e:
                await asyncio.wait_for(fut, timeout=20)
            assert "not connected" in str(e.value).lower()
    finally:
        await _aclose_all(client, server)
        proxy.stop()
