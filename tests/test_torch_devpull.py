"""The port's device pull on CPU tensors: the twins of tests/test_devpull.py.

Two port workers over a real socket in one process, on either engine (the
C++ one is the port's copy, which speaks ``cudaipc`` as the Python one
does), negotiate the pull under the port's own HELLO key (``cudaipc``)
and take the process-wide route: the sender's snapshot waits in a table
until the receiver takes it.
That route carries CPU tensors as well, so the whole lifecycle runs here:
the pull, the flush barrier that waits for it (and force-starts it), the
truncation drain, same-tag FIFO order with staged messages, a host-buffer
receive and close.  Across processes a CPU tensor is host memory and
rides staged frames; the CUDA IPC route is held on the card by
tests/test_torch_devpull_cuda.py."""

import asyncio
import gc
import multiprocessing
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from starway_tpu_torch import Client, DeviceBuffer, Server, device

pytestmark = pytest.mark.asyncio

ADDR = "127.0.0.1"
MASK = (1 << 64) - 1
N = 1 << 20  # 1 MiB: above STARWAY_DEVPULL_MIN
CPU = "cpu"


@pytest.fixture(autouse=True)
def _force_tcp(monkeypatch):
    # The inproc fast path would bypass the wire; the pull is a wire
    # feature, negotiated by the Python engine.
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")


def _native_available() -> bool:
    from starway_tpu_torch.core import native

    return native.available()


async def _pair(port):
    server = Server()
    client = Client()
    server.listen(ADDR, port)
    await client.aconnect(ADDR, port)
    for _ in range(400):
        if server.list_clients():
            break
        await asyncio.sleep(0.005)
    return server, client


def _pulls(worker) -> dict:
    mgr = worker._client.transfer_manager() if hasattr(worker, "_client") \
        else worker._server.transfer_manager()
    return dict(mgr.counts) if mgr is not None else {}


def test_pull_route_by_peer_identity():
    me = device.cudaipc_identity()
    host, boot, pid = me.rsplit("|", 2)
    cpu = torch.zeros(4)
    card = SimpleNamespace(device=torch.device("cuda", 0))  # a card's tensor
    assert device.pull_route(me, cpu) == "local"
    assert device.pull_route(f"{host}|{boot}|{int(pid) + 1}", cpu) is None
    assert device.pull_route(f"other-host|{boot}|{pid}", cpu) is None
    assert device.pull_route(f"{host}|another-boot|{pid}", cpu) is None
    assert device.pull_route(None, cpu) is None
    assert device.pull_route("garbled", cpu) is None
    # a card's tensor: CUDA IPC to another process of this host and boot
    assert device.pull_route(f"{host}|{boot}|{int(pid) + 1}", card) == "ipc"
    assert device.pull_route(me, card) == "local"
    assert device.pull_route(f"other-host|{boot}|{pid}", card) is None


async def test_handshake_negotiates_cudaipc_not_devpull(port):
    server, client = await _pair(port)
    try:
        ep = server.list_clients().pop()
        for conn in (client._client.primary_conn, ep._conn):
            assert conn.devpull_ok
            assert conn.cudaipc_peer == device.cudaipc_identity()
        assert not device.devpull_supported()
    finally:
        await client.aclose()
        await server.aclose()


async def test_devpull_same_host_two_workers(port):
    """Two workers over a real socket in one process: the payload arrives
    by the pull (the sender's snapshot), not host staging, and the sender
    may overwrite its tensor as soon as the send completes."""
    server, client = await _pair(port)
    try:
        src = torch.arange(N, dtype=torch.int64).to(torch.uint8)
        want = src.clone()
        sink = DeviceBuffer((N,), torch.uint8, device=CPU)
        ptr = sink.array.data_ptr()
        recv_fut = server.arecv(sink, 0x77, MASK)
        await asyncio.sleep(0.05)
        await client.asend(src, 0x77)
        src.fill_(0xEE)
        del src
        gc.collect()
        tag, length = await recv_fut

        assert (tag, length) == (0x77, N)
        assert sink.last_transport == "device"
        assert sink.array.data_ptr() == ptr
        assert torch.equal(sink.array, want)
        assert _pulls(client)["offered_local"] == 1
        assert _pulls(server)["pulled_local"] == 1
    finally:
        await client.aclose()
        await server.aclose()


async def test_devpull_flush_covers_pull(port):
    """aflush completes only once the receiver has pulled: after flush +
    close the payload is resident at the receiver although no receive was
    posted (the FLUSH barrier force-started the pull)."""
    server, client = await _pair(port)
    try:
        await client.asend(torch.full((N,), 7, dtype=torch.uint8), 0x88)
        await client.aflush()
        assert _pulls(server)["pulled_local"] == 1
        await client.aclose()

        sink = DeviceBuffer((N,), torch.uint8, device=CPU)
        tag, length = await asyncio.wait_for(server.arecv(sink, 0x88, MASK), 10)
        assert (tag, length) == (0x88, N)
        assert sink.last_transport == "device"
        assert bool((sink.array == 7).all())
    finally:
        await server.aclose()


async def test_devpull_disabled_falls_back_to_staging(port, monkeypatch):
    monkeypatch.setenv("STARWAY_DEVPULL", "0")
    server, client = await _pair(port)
    try:
        assert not client._client.primary_conn.devpull_ok
        assert client._client.primary_conn.cudaipc_peer is None
        src = torch.arange(N, dtype=torch.int64).to(torch.uint8)
        sink = DeviceBuffer((N,), torch.uint8, device=CPU)
        recv_fut = server.arecv(sink, 0x99, MASK)
        await asyncio.sleep(0.05)
        await client.asend(src, 0x99)
        tag, length = await recv_fut
        assert (tag, length) == (0x99, N)
        assert sink.last_transport == "staged"
        assert torch.equal(sink.array, src)
    finally:
        await client.aclose()
        await server.aclose()


async def test_devpull_below_threshold_is_staged(port, monkeypatch):
    monkeypatch.setenv("STARWAY_DEVPULL_MIN", str(N + 1))
    server, client = await _pair(port)
    try:
        src = torch.arange(N, dtype=torch.int64).to(torch.uint8)
        sink = DeviceBuffer((N,), torch.uint8, device=CPU)
        recv_fut = server.arecv(sink, 0x9A, MASK)
        await client.asend(src, 0x9A)
        assert await recv_fut == (0x9A, N)
        assert sink.last_transport == "staged"
        assert torch.equal(sink.array, src)
        assert _pulls(client).get("offered_local", 0) == 0
    finally:
        await client.aclose()
        await server.aclose()


async def test_devpull_host_buffer_recv(port):
    """A plain host-byte receive matching a pulled payload still
    delivers (PulledPayload.as_host_view)."""
    server, client = await _pair(port)
    try:
        src = torch.arange(N, dtype=torch.int64).to(torch.uint8)
        buf = np.zeros(N, dtype=np.uint8)
        recv_fut = server.arecv(buf, 0xAA, MASK)
        await asyncio.sleep(0.05)
        await client.asend(src, 0xAA)
        tag, length = await asyncio.wait_for(recv_fut, 10)
        assert (tag, length) == (0xAA, N)
        np.testing.assert_array_equal(buf, src.numpy())
        assert _pulls(server)["pulled_local"] == 1
    finally:
        await client.aclose()
        await server.aclose()


async def test_devpull_host_buffer_recv_native(port, monkeypatch):
    """The same on the C++ engine: its wrapper copies the pulled payload
    into the host receive (PulledPayload.as_host_view), posted before the
    descriptor arrives or claiming it from the unexpected queue."""
    if not _native_available():
        pytest.skip("native engine unavailable")
    monkeypatch.setenv("STARWAY_NATIVE", "1")
    server, client = await _pair(port)
    try:
        for tag, posted_first in ((0xAC, True), (0xAD, False)):
            src = torch.arange(N, dtype=torch.int64).to(torch.uint8) + tag
            buf = np.zeros(N, dtype=np.uint8)
            if posted_first:
                recv_fut = server.arecv(buf, tag, MASK)
            await client.asend(src, tag)
            await client.aflush()
            if not posted_first:
                recv_fut = server.arecv(buf, tag, MASK)
            assert await asyncio.wait_for(recv_fut, 10) == (tag, N)
            np.testing.assert_array_equal(buf, src.numpy())
        assert _pulls(server)["pulled_local"] == 2
    finally:
        await client.aclose()
        await server.aclose()


async def test_devpull_bf16_payload(port):
    """A typed payload crosses as bytes: a bf16 tensor lands bit for bit
    in a bf16 sink, and the descriptor names its shape and dtype."""
    server, client = await _pair(port)
    try:
        bits = torch.from_numpy(np.random.default_rng(3).integers(
            0, 1 << 16, (512, 1024), dtype=np.uint16).astype(np.int16))
        src = bits.view(torch.bfloat16)
        sink = DeviceBuffer((512, 1024), torch.bfloat16, device=CPU)
        fut = server.arecv(sink, 0xAB, MASK)
        await client.asend(src, 0xAB)
        assert await fut == (0xAB, src.numel() * 2)
        assert sink.last_transport == "device"
        assert torch.equal(sink.array.view(torch.int16), bits)
    finally:
        await client.aclose()
        await server.aclose()


@pytest.mark.parametrize(
    "server_native,client_native",
    [(False, False), (True, True), (True, False), (False, True)],
    ids=["py/py", "native/native", "native-server/py-client",
         "py-server/native-client"])
async def test_devpull_engine_matrix(port, monkeypatch, server_native,
                                     client_native):
    """Every pairing of the two engines negotiates "cudaipc" and pulls,
    as the JAX twin's pairings pull under "devpull": the same bytes and
    (tag, length), landed by the device path, on all four."""
    if (server_native or client_native) and not _native_available():
        pytest.skip("native engine unavailable (no toolchain)")
    monkeypatch.setenv("STARWAY_NATIVE", "1" if server_native else "0")
    server = Server()
    server.listen(ADDR, port)
    monkeypatch.setenv("STARWAY_NATIVE", "1" if client_native else "0")
    client = Client()
    await client.aconnect(ADDR, port)
    want = "device"
    for _ in range(400):
        if server.list_clients():
            break
        await asyncio.sleep(0.005)
    try:
        for conn in (client._client.primary_conn,
                     server.list_clients().pop()._conn):
            assert conn.devpull_ok
            assert conn.cudaipc_peer == device.cudaipc_identity()
        src = torch.arange(N, dtype=torch.int64).to(torch.uint8)
        sink = DeviceBuffer((N,), torch.uint8, device=CPU)
        recv_fut = server.arecv(sink, 0x66, MASK)
        await asyncio.sleep(0.05)
        await client.asend(src, 0x66)
        assert await asyncio.wait_for(recv_fut, 15) == (0x66, N)
        assert sink.last_transport == want
        assert torch.equal(sink.array, src)

        # unexpected, then posted, behind a flush barrier
        await client.asend(torch.full((N,), 9, dtype=torch.uint8), 0x67)
        await client.aflush()
        sink2 = DeviceBuffer((N,), torch.uint8, device=CPU)
        assert await asyncio.wait_for(server.arecv(sink2, 0x67, MASK),
                                      15) == (0x67, N)
        assert bool((sink2.array == 9).all())
        assert sink2.last_transport == want

        # flush then close: the payload survives the sender's close
        await client.asend(torch.full((N,), 11, dtype=torch.uint8), 0x68)
        await client.aflush()
        await client.aclose()
        sink3 = DeviceBuffer((N,), torch.uint8, device=CPU)
        assert await asyncio.wait_for(server.arecv(sink3, 0x68, MASK),
                                      15) == (0x68, N)
        assert bool((sink3.array == 11).all())
    finally:
        try:
            await client.aclose()
        except Exception:
            pass  # already closed by the last phase
        await server.aclose()


@pytest.mark.parametrize("native", [False, True], ids=["py", "native"])
async def test_devpull_same_tag_fifo_with_staged(port, monkeypatch, native):
    """A staged message sent before a pulled one on the same tag is
    received first: descriptors sit in the one unexpected FIFO."""
    if native:
        if not _native_available():
            pytest.skip("native engine unavailable")
        monkeypatch.setenv("STARWAY_NATIVE", "1")
    server, client = await _pair(port)
    try:
        small = np.full(1024, 3, dtype=np.uint8)  # below the threshold
        await client.asend(small, 0xD1)
        await client.aflush()
        await client.asend(torch.full((N,), 4, dtype=torch.uint8), 0xD1)
        await client.aflush()

        buf = np.zeros(N, dtype=np.uint8)
        tag, n1 = await asyncio.wait_for(server.arecv(buf, 0xD1, MASK), 10)
        assert (tag, n1) == (0xD1, 1024), "staged message must arrive first"
        np.testing.assert_array_equal(buf[:1024], small)

        sink = DeviceBuffer((N,), torch.uint8, device=CPU)
        tag, n2 = await asyncio.wait_for(server.arecv(sink, 0xD1, MASK), 10)
        assert (tag, n2) == (0xD1, N)
        assert bool((sink.array == 4).all())
        assert sink.last_transport == "device"
    finally:
        await client.aclose()
        await server.aclose()


@pytest.mark.parametrize("native", [False, True], ids=["py", "native"])
@pytest.mark.parametrize("recv_first", [True, False],
                         ids=["recv-first", "descriptor-first"])
async def test_devpull_truncation(port, monkeypatch, native, recv_first):
    """A too-small receive fails "truncated" whether it was posted before
    the descriptor arrived or claims it from the unexpected queue, and the
    payload is drain-pulled: the sender's offer is released and a later
    flush barrier completes."""
    if native:
        if not _native_available():
            pytest.skip("native engine unavailable")
        monkeypatch.setenv("STARWAY_NATIVE", "1")
    server, client = await _pair(port)
    try:
        small = np.zeros(1024, dtype=np.uint8)
        big = torch.full((N,), 5, dtype=torch.uint8)
        if recv_first:
            recv_fut = server.arecv(small, 0xE1, MASK)
            await asyncio.sleep(0.05)
            await client.asend(big, 0xE1)
        else:
            # no flush before the receive: the truncation path itself must
            # drain-pull the payload, or the barrier below hangs
            await client.asend(big, 0xE1)
            await asyncio.sleep(0.2)
            recv_fut = server.arecv(small, 0xE1, MASK)
        with pytest.raises(Exception, match="[Tt]runcat"):
            await asyncio.wait_for(recv_fut, 10)
        await asyncio.wait_for(client.aflush(), 10)
        assert _pulls(server)["pulled_local"] == 1
        assert not device._local_offers
    finally:
        await client.aclose()
        await server.aclose()


async def test_devpull_flush_not_blocked_by_later_send(port):
    """The FLUSH barrier waits only for descriptors that preceded it."""
    server, client = await _pair(port)
    try:
        await client.asend(torch.full((N,), 1, dtype=torch.uint8), 0xC1)
        flush_fut = client.aflush()
        await asyncio.sleep(0.02)
        await client.asend(torch.full((N,), 2, dtype=torch.uint8), 0xC2)
        await asyncio.wait_for(flush_fut, 10)

        sink = DeviceBuffer((N,), torch.uint8, device=CPU)
        assert await asyncio.wait_for(server.arecv(sink, 0xC1, MASK),
                                      10) == (0xC1, N)
        assert bool((sink.array == 1).all())
    finally:
        await client.aclose()
        await server.aclose()


async def test_devpull_close_drops_unpulled_offers(port):
    """Unpulled offers die with the sender's worker: its table entries go,
    and the receiver, which never claimed the descriptor, drops it when
    the connection dies."""
    server, client = await _pair(port)
    try:
        ep = server.list_clients().pop()
        await client.asend(torch.full((N,), 6, dtype=torch.uint8), 0xF1)
        for _ in range(400):
            if server._server.matcher.unexpected:
                break
            await asyncio.sleep(0.005)
        uids = list(device._local_offers)
        assert uids and server._server.matcher.unexpected[0].remote
        await client.aclose()
        assert not set(uids) & set(device._local_offers)
        for _ in range(400):
            if not ep._conn.alive:
                break
            await asyncio.sleep(0.005)
        await asyncio.sleep(0.05)
        assert not ep._conn._remote_msgs
        assert not server._server.matcher.unexpected
    finally:
        await server.aclose()


async def test_devpull_close_drops_unpulled_offers_native(port, monkeypatch):
    """The same on a C++-engine sender: its close drops the offers a
    Python-engine receiver had not pulled yet (that engine pulls when a
    receive claims the descriptor; the C++ engine pulls each descriptor
    as it arrives, so an offer to it is never left unpulled)."""
    if not _native_available():
        pytest.skip("native engine unavailable")
    server = Server()
    server.listen(ADDR, port)
    monkeypatch.setenv("STARWAY_NATIVE", "1")
    client = Client()
    await client.aconnect(ADDR, port)
    try:
        for _ in range(400):
            if server.list_clients():
                break
            await asyncio.sleep(0.005)
        ep = server.list_clients().pop()
        assert client._client.primary_conn.cudaipc_peer is not None
        await client.asend(torch.full((N,), 6, dtype=torch.uint8), 0xF3)
        for _ in range(400):
            if server._server.matcher.unexpected:
                break
            await asyncio.sleep(0.005)
        uids = list(device._local_offers)
        assert uids and server._server.matcher.unexpected[0].remote
        assert _pulls(client)["offered_local"] == 1
        await client.aclose()
        assert not set(uids) & set(device._local_offers)
        for _ in range(400):
            if not ep._conn.alive:
                break
            await asyncio.sleep(0.005)
        await asyncio.sleep(0.05)
        assert not ep._conn._remote_msgs
        assert not server._server.matcher.unexpected
    finally:
        await server.aclose()


async def test_devpull_pull_of_a_dropped_offer_fails_loudly(port, caplog):
    """A descriptor whose offer is gone fails its pull with a logged
    error; the claimed receive stays pending (the peer-death contract)
    and the close sweep cancels it."""
    server, client = await _pair(port)
    try:
        await client.asend(torch.full((N,), 8, dtype=torch.uint8), 0xF2)
        await asyncio.sleep(0.1)
        device._local_offers.clear()  # as if the sender had closed
        fut = server.arecv(DeviceBuffer((N,), torch.uint8, device=CPU),
                           0xF2, MASK)
        for _ in range(200):
            if "device pull failed" in caplog.text:
                break
            await asyncio.sleep(0.01)
        assert "no longer offers" in caplog.text
        assert not fut.done()
    finally:
        await client.aclose()
        await server.aclose()
    with pytest.raises(Exception, match="cancel"):
        await fut


# --------------------------------------------------------- multiprocess


def _child_send_cpu_tensor(port, flush_then_close):
    import asyncio
    import os

    os.environ["STARWAY_TLS"] = "tcp"
    os.environ["STARWAY_NATIVE"] = "0"
    import torch

    from starway_tpu_torch import Client

    async def run():
        client = Client()
        for _ in range(120):
            try:
                await client.aconnect("127.0.0.1", port)
                break
            except Exception:
                client = Client()
                await asyncio.sleep(0.1)
        conn = client._client.primary_conn
        assert conn.devpull_ok and conn.cudaipc_peer is not None
        await client.asend(torch.arange(N, dtype=torch.int64).to(torch.uint8),
                           0xBB)
        await client.aflush()
        await client.aclose()

    asyncio.run(run())


async def test_cross_process_cpu_tensor_is_staged(port):
    """Across processes a CPU tensor is host memory: no route reaches the
    peer, so the send rides staged frames, bytes exact, although both
    sides negotiated the pull."""
    ctx = multiprocessing.get_context("spawn")
    proc = ctx.Process(target=_child_send_cpu_tensor, args=(port, True),
                       daemon=True)
    server = Server()
    server.listen(ADDR, port)
    proc.start()
    try:
        sink = DeviceBuffer((N,), torch.uint8, device=CPU)
        tag, length = await asyncio.wait_for(server.arecv(sink, 0xBB, MASK),
                                             60)
        assert (tag, length) == (0xBB, N)
        assert sink.last_transport == "staged"
        assert torch.equal(sink.array,
                           torch.arange(N, dtype=torch.int64).to(torch.uint8))
        await asyncio.get_running_loop().run_in_executor(None, proc.join, 60)
        assert proc.exitcode == 0
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(5)
        await server.aclose()


async def test_pulled_receive_keeps_no_reference_to_its_sink(port):
    """Once a pulled receive has completed and the caller drops its sink,
    nothing of the port keeps the sink (and its tensor) alive -- not the
    manager's thread while it waits for the next pull, whose last task
    reached the sink through its message's posted receive.  A receiver
    would otherwise hold a payload-sized tensor until its next pull."""
    import weakref

    server, client = await _pair(port)
    try:
        sink = DeviceBuffer((N,), torch.uint8, device=CPU)
        fut = server.arecv(sink, 0x21, MASK)
        await client.asend(torch.full((N,), 7, dtype=torch.uint8), 0x21)
        await client.aflush()
        assert await fut == (0x21, N)
        assert sink.last_transport == "device"
        assert bool((sink.array == 7).all())
        alive = [weakref.ref(sink), weakref.ref(sink.array)]
        del sink, fut
        for _ in range(200):
            gc.collect()
            if all(ref() is None for ref in alive):
                break
            await asyncio.sleep(0.005)
        assert [ref() is None for ref in alive] == [True, True]
    finally:
        await client.aclose()
        await server.aclose()


async def test_pulled_receive_keeps_no_reference_to_its_sink_native(
        port, monkeypatch):
    """The same on the C++ engine: once its pulled receive completed,
    neither the wrapper's descriptor records (claimed or unclaimed) nor
    the manager's thread nor a pull's closure keeps the dropped sink."""
    import weakref

    if not _native_available():
        pytest.skip("native engine unavailable")
    monkeypatch.setenv("STARWAY_NATIVE", "1")
    server, client = await _pair(port)
    try:
        for sink_first in (True, False):
            sink = DeviceBuffer((N,), torch.uint8, device=CPU)
            if sink_first:
                fut = server.arecv(sink, 0x22, MASK)
            await client.asend(torch.full((N,), 7, dtype=torch.uint8), 0x22)
            await client.aflush()
            if not sink_first:
                fut = server.arecv(sink, 0x22, MASK)
            assert await fut == (0x22, N)
            assert sink.last_transport == "device"
            assert bool((sink.array == 7).all())
            alive = [weakref.ref(sink), weakref.ref(sink.array)]
            del sink, fut
            for _ in range(200):
                gc.collect()
                if all(ref() is None for ref in alive):
                    break
                await asyncio.sleep(0.005)
            assert [ref() is None for ref in alive] == [True, True]
            worker = server._server
            assert not worker._devpull_entries
            assert not worker._devpull_claimed
        assert _pulls(server)["pulled_local"] == 2
    finally:
        await client.aclose()
        await server.aclose()
