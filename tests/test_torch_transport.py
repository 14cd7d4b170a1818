"""The transport contract of tests/test_basic.py, run on the port.

Every behaviour of the JAX package's integration suite, on
``starway_tpu_torch``'s own host runtime, under the same five transport
configurations (in-process, Python tcp, Python sm, C++ tcp, C++ sm).  The
flush children spawned across real process boundaries import only the
port (tests/torch_port_util.py asserts it in each child)."""

import asyncio
import contextlib
import gc
import multiprocessing as mp

import numpy as np
import pytest

from starway_tpu_torch import Client, Server, perf
from torch_port_util import (transport_child_client_send,
                             transport_child_server_send)

pytestmark = pytest.mark.asyncio

SERVER_ADDR = "127.0.0.1"

INFLIGHT_BYTES = 1 << 30  # 1 GiB: must be big enough to be "on the flight"



@pytest.fixture(params=["inproc", "tcp", "sm", "native", "native-sm"])
def transport(request, monkeypatch):
    """Five data planes behind one contract: in-process fast path, Python
    TCP engine, shared-memory rings negotiated over TCP (Python and C++
    engines), C++ native TCP engine (parity-tested by the same suite)."""
    if request.param == "tcp":
        monkeypatch.setenv("STARWAY_TLS", "tcp")
        monkeypatch.setenv("STARWAY_NATIVE", "0")
    elif request.param == "sm":
        import platform

        if platform.machine() not in ("x86_64", "AMD64"):
            # The Python ring needs TSO (config.sm_enabled gates it); don't
            # silently rerun the tcp path under an sm label.
            pytest.skip("python sm transport requires x86-64")
        monkeypatch.setenv("STARWAY_TLS", "tcp,sm")
        monkeypatch.setenv("STARWAY_NATIVE", "0")
    elif request.param in ("native", "native-sm"):
        from starway_tpu_torch.core import native

        if not native.available():
            pytest.skip("native engine unavailable (no toolchain)")
        monkeypatch.setenv("STARWAY_TLS", "tcp" if request.param == "native" else "tcp,sm")
        monkeypatch.setenv("STARWAY_NATIVE", "1")
    return request.param


@contextlib.asynccontextmanager
async def gen_server_client(port):
    server = Server()
    client = Client()
    server.listen(SERVER_ADDR, port)
    await client.aconnect(SERVER_ADDR, port)
    try:
        yield server, client
    finally:
        await client.aclose()
        await server.aclose()


async def _connect_retry(addr, port, attempts=60, delay=0.25) -> Client:
    """Connect with retries: spawned peer processes need time to come up.
    Clients are connect-once (reference: src/bindings/main.cpp:552-566), so
    each attempt uses a fresh Client."""
    for i in range(attempts):
        client = Client()
        try:
            await client.aconnect(addr, port)
            return client
        except Exception:
            if i == attempts - 1:
                raise
            await asyncio.sleep(delay)
    raise RuntimeError("unreachable")


# ==============================================================================
# Basic functionality
# ==============================================================================


async def test_server_listen_client_connect_close(port, transport):
    server = Server()
    client = Client()
    server.listen(SERVER_ADDR, port)
    await client.aconnect(SERVER_ADDR, port)

    assert len(server.list_clients()) == 1

    await client.aclose()
    # Endpoint registry keeps closed peers (reference behaviour,
    # tests/test_basic.py:43-58).
    assert len(server.list_clients()) == 1

    await server.aclose()


async def test_worker_address_connection_roundtrip():
    server = Server()
    server_address = server.listen_address()
    assert isinstance(server_address, bytes)
    assert server.get_worker_address() == server_address

    client = Client()
    await client.aconnect_address(server_address)

    for _ in range(100):
        if server.list_clients():
            break
        await asyncio.sleep(0.01)
    client_list = server.list_clients()
    assert len(client_list) == 1
    client_ep = next(iter(client_list))

    send_buf = np.arange(16, dtype=np.uint8)
    recv_buf_client = np.zeros_like(send_buf)
    recv_task = client.arecv(recv_buf_client, 0, 0)
    await asyncio.sleep(0.01)
    await server.asend(client_ep, send_buf, 1)
    sender_tag, length = await recv_task
    assert sender_tag == 1 and length == len(send_buf)
    np.testing.assert_array_equal(send_buf, recv_buf_client)

    recv_buf_server = np.zeros_like(send_buf)
    recv_task = server.arecv(recv_buf_server, 0, 0)
    await asyncio.sleep(0.01)
    await client.asend(send_buf, 2)
    sender_tag, length = await recv_task
    assert sender_tag == 2 and length == len(send_buf)
    np.testing.assert_array_equal(send_buf, recv_buf_server)

    assert isinstance(client.get_worker_address(), bytes)

    await client.aclose()
    await server.aclose()


async def test_worker_address_accept_callback_invoked():
    server = Server()
    accept_event = asyncio.Event()
    accepted = []
    loop = asyncio.get_running_loop()

    def accept_cb(ep):
        accepted.append(ep)
        loop.call_soon_threadsafe(accept_event.set)

    server.set_accept_cb(accept_cb)
    address = server.listen_address()
    client = Client()
    await client.aconnect_address(address)
    await asyncio.wait_for(accept_event.wait(), timeout=2.0)

    assert len(accepted) == 1
    assert len(server.list_clients()) == 1

    await client.aclose()
    await server.aclose()


async def test_worker_address_multiple_clients():
    server = Server()
    address = server.listen_address()
    clients = [Client() for _ in range(3)]
    try:
        await asyncio.gather(*(c.aconnect_address(address) for c in clients))
        for _ in range(200):
            if len(server.list_clients()) >= len(clients):
                break
            await asyncio.sleep(0.01)
        assert len(server.list_clients()) >= len(clients)
    finally:
        await asyncio.gather(*(c.aclose() for c in clients), return_exceptions=True)
        await server.aclose()


async def test_client_to_server_send_recv(port, transport):
    async with gen_server_client(port) as (server, client):
        send_buf = np.arange(10, dtype=np.uint8)
        recv_buf = np.zeros(10, dtype=np.uint8)

        recv_task = server.arecv(recv_buf, 0, 0)
        await asyncio.sleep(0.01)
        await client.asend(send_buf, 1)
        sender_tag, length = await recv_task

        assert sender_tag == 1 and length == len(send_buf)
        np.testing.assert_array_equal(send_buf, recv_buf)


async def test_server_to_client_send_recv(port, transport):
    async with gen_server_client(port) as (server, client):
        send_buf = np.arange(20, dtype=np.uint8)
        recv_buf = np.zeros(20, dtype=np.uint8)

        client_ep = server.list_clients().pop()
        recv_task = client.arecv(recv_buf, 0, 0)
        await asyncio.sleep(0.01)
        await server.asend(client_ep, send_buf, 2)
        sender_tag, length = await recv_task

        assert sender_tag == 2 and length == len(send_buf)
        np.testing.assert_array_equal(send_buf, recv_buf)


# ==============================================================================
# Flush semantics across real process boundaries
# (reference: tests/test_basic.py:190-415; "multi-node without a real cluster")
# ==============================================================================


@pytest.mark.parametrize("use_flush_ep", [False, True])
async def test_server_send_without_flush_bad(port, use_flush_ep):
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=transport_child_server_send, args=(port, False, use_flush_ep), daemon=True)
    p.start()
    client = await _connect_retry(SERVER_ADDR, port)
    recv_buf = np.zeros(INFLIGHT_BYTES, dtype=np.uint8)
    done = False

    def done_callback(sender_tag, length):
        nonlocal done
        done = True

    def fail_callback(error):
        nonlocal done
        done = True

    client.recv(recv_buf, 0, 0, done_callback, fail_callback)
    await asyncio.sleep(1.5)
    assert not done
    await client.aclose()
    p.kill()
    p.join()
    p.close()


@pytest.mark.parametrize("use_flush_ep", [False, True])
async def test_server_send_with_flush_good(port, use_flush_ep):
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=transport_child_server_send, args=(port, True, use_flush_ep), daemon=True)
    p.start()
    client = await _connect_retry(SERVER_ADDR, port)
    recv_buf = np.zeros(INFLIGHT_BYTES, dtype=np.uint8)
    recv_future = client.arecv(recv_buf, 0, 0)
    await recv_future
    p.join()
    await client.aclose()
    p.close()


async def test_client_send_without_flush_bad(port):
    server = Server()
    server.listen(SERVER_ADDR, port)
    connected = asyncio.Event()
    loop = asyncio.get_running_loop()
    server.set_accept_cb(lambda ep: loop.call_soon_threadsafe(connected.set))

    ctx = mp.get_context("spawn")
    p = ctx.Process(target=transport_child_client_send, args=(port, False), daemon=True)
    p.start()
    await connected.wait()
    recv_buf = np.zeros(INFLIGHT_BYTES, dtype=np.uint8)
    done = False

    def done_callback(sender_tag, length):
        nonlocal done
        done = True

    def fail_callback(error):
        nonlocal done
        done = True

    server.recv(recv_buf, 0, 0, done_callback, fail_callback)
    await asyncio.sleep(1.5)
    assert not done
    p.kill()
    p.join()
    p.close()
    await server.aclose()


async def test_client_send_with_flush_good(port):
    server = Server()
    server.listen(SERVER_ADDR, port)
    connected = asyncio.Event()
    loop = asyncio.get_running_loop()
    server.set_accept_cb(lambda ep: loop.call_soon_threadsafe(connected.set))

    ctx = mp.get_context("spawn")
    p = ctx.Process(target=transport_child_client_send, args=(port, True), daemon=True)
    p.start()
    await connected.wait()
    recv_buf = np.zeros(INFLIGHT_BYTES, dtype=np.uint8)
    recv_future = server.arecv(recv_buf, 0, 0)
    await recv_future
    p.join()
    p.close()
    await server.aclose()


# ==============================================================================
# Integrity / telemetry
# ==============================================================================


@pytest.mark.parametrize("size", [1, 1024, 4096])
async def test_message_integrity_various_sizes(port, size, transport):
    async with gen_server_client(port) as (server, client):
        send_buf = np.random.randint(0, 256, size, dtype=np.uint8)
        recv_buf = np.zeros(size, dtype=np.uint8)
        client_ep = server.list_clients().pop()

        recv_task = server.arecv(recv_buf, 0, 0)
        await client.asend(send_buf, 3)
        _, length = await recv_task
        assert length == size
        np.testing.assert_array_equal(send_buf, recv_buf)

        recv_buf.fill(0)
        recv_task = client.arecv(recv_buf, 0, 0)
        await server.asend(client_ep, send_buf, 4)
        _, length = await recv_task
        assert length == size
        np.testing.assert_array_equal(send_buf, recv_buf)


async def test_evaluate_perf(port):
    client = Client()
    server = Server()
    server.listen(SERVER_ADDR, port)
    await client.aconnect(SERVER_ADDR, port)

    for msg in [1, 1024, 1024 * 1024, 1024 * 1024 * 50, 1024 * 1024 * 1024]:
        assert client.evaluate_perf(msg) > 0
        assert server.evaluate_perf(server.list_clients().pop(), msg) > 0

    await client.aclose()
    await server.aclose()


# ==============================================================================
# State management and error handling
# ==============================================================================


async def test_client_op_before_connect():
    client = Client()
    buf = np.zeros(1, dtype=np.uint8)
    with pytest.raises(Exception):
        await client.asend(buf, 0)
    with pytest.raises(Exception):
        await client.arecv(buf, 0, 0)
    with pytest.raises(Exception):
        await client.aclose()


async def test_server_op_before_listen():
    server = Server()
    buf = np.zeros(1, dtype=np.uint8)
    with pytest.raises(Exception):
        await server.arecv(buf, 0, 0)
    with pytest.raises(Exception):
        await server.aclose()


async def test_double_connect_or_listen(port):
    server = Server()
    server.listen(SERVER_ADDR, port)
    with pytest.raises(Exception):
        server.listen(SERVER_ADDR, port)

    client = Client()
    await client.aconnect(SERVER_ADDR, port)
    with pytest.raises(Exception):
        await client.aconnect(SERVER_ADDR, port)

    await client.aclose()
    await server.aclose()


async def test_double_close(port):
    client = Client()
    server = Server()
    server.listen(SERVER_ADDR, port)
    await client.aconnect(SERVER_ADDR, port)
    await client.aclose()
    await server.aclose()
    with pytest.raises(RuntimeError):
        await client.aclose()
    with pytest.raises(RuntimeError):
        await server.aclose()


async def test_connect_to_dead_server(port):
    client = Client()
    with pytest.raises(Exception) as e_info:
        await asyncio.wait_for(client.aconnect(SERVER_ADDR, port), timeout=5)
    assert "not connected" in str(e_info.value)


# ==============================================================================
# Concurrency and stress
# ==============================================================================


async def test_multiple_clients(port, transport):
    server = Server()
    server.listen(SERVER_ADDR, port)
    await asyncio.sleep(0.1)

    num_clients = 5
    clients = [Client() for _ in range(num_clients)]
    await asyncio.gather(*(c.aconnect(SERVER_ADDR, port) for c in clients))

    await asyncio.sleep(0.2)
    assert len(server.list_clients()) == num_clients

    await asyncio.gather(
        *(c.asend(np.array([i], dtype=np.uint8), i) for i, c in enumerate(clients))
    )

    recv_buf = np.zeros(1, dtype=np.uint8)
    recv_tags = set()
    for _ in range(num_clients):
        tag, _ = await server.arecv(recv_buf, 0, 0)
        recv_tags.add(tag)
    assert recv_tags == set(range(num_clients))

    await asyncio.gather(*(c.aclose() for c in clients))
    await server.aclose()


async def test_concurrent_send_recv(port, transport):
    async with gen_server_client(port) as (server, client):
        n = 50
        sends = [client.asend(np.array([i]), i) for i in range(n)]
        recvs = [server.arecv(np.zeros(1, dtype=np.uint8), 0, 0) for _ in range(n)]
        results = await asyncio.gather(*sends, *recvs)
        received_tags = {r[0] for r in results if isinstance(r, tuple)}
        assert received_tags == set(range(n))


async def _bidirectional(port, n):
    async with gen_server_client(port) as (server, client):
        client_ep = server.list_clients().pop()

        server_sends = [server.asend(client_ep, np.array([i]), 100 + i) for i in range(n)]
        client_recvs = [client.arecv(np.zeros(1, dtype=np.uint8), 0, 0) for _ in range(n)]
        client_sends = [client.asend(np.array([i]), 200 + i) for i in range(n)]
        server_recvs = [server.arecv(np.zeros(1, dtype=np.uint8), 0, 0) for _ in range(n)]

        results = await asyncio.gather(*server_sends, *client_recvs, *client_sends, *server_recvs)
        client_tags = {r[0] for r in results[n : 2 * n] if r is not None}
        server_tags = {r[0] for r in results[3 * n :] if r is not None}
        assert client_tags == set(range(100, 100 + n))
        assert server_tags == set(range(200, 200 + n))


async def test_bidirectional_traffic(port, transport):
    # Moderate storm for the tier-1 process: the 2000-op variant below is
    # load-flaky when the whole suite shares this 1-core box (noted in
    # CHANGES PR 8), so the full-size storm runs @slow and tier-1 keeps a
    # size that exercises the same fan-in/bidirectional machinery.
    await _bidirectional(port, 600)


@pytest.mark.slow
async def test_bidirectional_traffic_storm(port, transport):
    await _bidirectional(port, 2000)


async def test_rapid_connect_close_client(port, transport):
    server = Server()
    server.listen(SERVER_ADDR, port)

    num_cycles = 10
    buf = np.zeros(1, dtype=np.uint8)
    buf2 = np.zeros(1, dtype=np.uint8)

    async def once():
        client = Client()
        await client.aconnect(SERVER_ADDR, port)
        await client.asend(buf, 1)
        await client.aclose()

    await asyncio.gather(
        *[once() for _ in range(num_cycles)],
        *[server.arecv(buf2, 0, 0) for _ in range(num_cycles)],
    )
    await server.aclose()


# ==============================================================================
# Resource management and lifetime
# ==============================================================================


async def test_shutdown_with_in_flight_ops(port):
    server = Server()
    server.listen(SERVER_ADDR, port)
    client = Client()
    await client.aconnect(SERVER_ADDR, port)

    recv_buf = np.ones(64 * 1024 * 1024, dtype=np.uint8)

    async def safe():
        try:
            await client.arecv(recv_buf, 999, 0)
        except Exception as e:
            assert "cancel" in str(e)

    future = asyncio.create_task(safe())
    await asyncio.sleep(0.01)
    await client.aclose()
    await future
    await server.aclose()


async def test_implicit_destruction_without_close(port):
    # Destructors must be robust: no hang, no crash
    # (reference: tests/test_basic.py:666-686).
    server = Server()
    server.listen(SERVER_ADDR, port)
    client = Client()
    await client.aconnect(SERVER_ADDR, port)

    del server
    del client
    gc.collect()
    await asyncio.sleep(0.5)
    assert True


# ==============================================================================
# evaluate_perf's link model: the card's device classes
# ==============================================================================


@pytest.fixture
def perf_table_guard():
    """calibrate() mutates the process-global class table; restore it."""
    saved = (dict(perf.LINK_MODELS), dict(perf.PROVENANCE),
             set(perf.CALIBRATED))
    yield
    for table, old in zip((perf.LINK_MODELS, perf.PROVENANCE,
                           perf.CALIBRATED), saved):
        table.clear()
        table.update(old)


def test_perf_estimate_positive_and_monotone():
    for t in ("inproc", "sm", "tcp", "h2d", "d2h", "p2p", "unknown"):
        assert 0 < perf.estimate(t, 1) < perf.estimate(t, 1 << 30)


def test_perf_device_classes_are_uncalibrated_priors(perf_table_guard):
    """The card's link classes replace the TPU's: no ici/dcn entry, and
    each prior says it is uncalibrated until a live fit replaces it."""
    assert not {"ici", "dcn"} & set(perf.LINK_MODELS)
    for t in ("h2d", "d2h", "p2p"):
        d = perf.estimate_detail(t, 1 << 20)
        assert d["calibrated"] is False
        assert d["source"].startswith("prior: uncalibrated")
        assert "TPU" not in d["source"] and "v5e" not in d["source"]
    alpha, beta = 8e-6, 25e9
    samples = [(n, alpha + n / beta) for n in (1024, 1 << 16, 1 << 20)]
    perf.calibrate("h2d", samples)
    d = perf.estimate_detail("h2d", 1 << 20)
    assert d["calibrated"] is True and "live class fit" in d["source"]
    assert d["beta"] == pytest.approx(beta, rel=0.05)
    assert perf.estimate_detail("d2h", 1 << 20)["calibrated"] is False
