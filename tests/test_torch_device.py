"""The port's device plane on CPU tensors: the twins of tests/test_device.py
and tests/test_dataplane.py, and the rules a mutable tensor adds.

Every ``torch.Tensor`` is a device payload, as every ``jax.Array`` is in
the JAX package, so the device plane runs here on CPU tensors.  The chunked
receive placement is armed only for ``cuda`` targets; the tests that
exercise it force it on, as tests/test_dataplane.py does.  Beyond the
twins: a receive writes in place (a shorter one leaves the tail alone), an
in-process send copies once into a posted receive and snapshots only a
message that parks, a staging buffer is recycled only after the event of
the last copy reading it, and dtypes map from torch, numpy and JAX names
alike."""

import asyncio
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from starway_tpu_torch import Client, DeviceBuffer, Server, device, perf
from starway_tpu_torch.errors import REASON_TRUNCATED

pytestmark = pytest.mark.asyncio

ADDR = "127.0.0.1"
MASK = (1 << 64) - 1
CPU = "cpu"


@pytest.fixture(params=["inproc", "tcp"])
def transport(request, monkeypatch):
    if request.param == "tcp":
        monkeypatch.setenv("STARWAY_TLS", "tcp")
    return request.param


async def _pair(port):
    server = Server()
    client = Client()
    server.listen(ADDR, port)
    await client.aconnect(ADDR, port)
    for _ in range(200):
        if server.list_clients():
            break
        await asyncio.sleep(0.005)
    return server, client, server.list_clients().pop()


def _force_tcp(monkeypatch, *, native: bool, chunk: int | None = None):
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    # exercise the framed stream, as tests/test_dataplane.py does: a pull
    # (tests/test_torch_devpull.py) would carry the payload instead
    monkeypatch.setenv("STARWAY_DEVPULL", "0")
    monkeypatch.setenv("STARWAY_NATIVE", "1" if native else "0")
    if chunk is not None:
        monkeypatch.setenv("STARWAY_CHUNK", str(chunk))


def _random_bytes(n, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8))


# ------------------------------------------- twins of tests/test_device.py


async def test_device_to_device_transfer(port, transport):
    server, client, _ep = await _pair(port)
    try:
        src = torch.arange(2048, dtype=torch.float32)
        sink = DeviceBuffer((2048,), torch.float32, device=CPU)
        ptr = sink.array.data_ptr()

        recv_fut = server.arecv(sink, 7, MASK)
        await asyncio.sleep(0.01)
        await client.asend(src, 7)
        tag, length = await recv_fut

        assert (tag, length) == (7, 2048 * 4)
        assert sink.array.device.type == "cpu"
        assert sink.array.data_ptr() == ptr
        assert sink.last_transport == ("device" if transport == "inproc"
                                       else "staged")
        assert torch.equal(sink.array, src)
    finally:
        await client.aclose()
        await server.aclose()


async def test_device_to_host_transfer(port, transport):
    server, client, _ep = await _pair(port)
    try:
        src = torch.arange(512, dtype=torch.int32).to(torch.uint8)
        host_sink = np.zeros(512, dtype=np.uint8)

        recv_fut = server.arecv(host_sink, 9, MASK)
        await asyncio.sleep(0.01)
        await client.asend(src, 9)
        tag, length = await recv_fut

        assert (tag, length) == (9, 512)
        np.testing.assert_array_equal(host_sink, src.numpy())
    finally:
        await client.aclose()
        await server.aclose()


async def test_host_to_device_transfer(port, transport):
    server, client, _ep = await _pair(port)
    try:
        src = np.random.randint(0, 255, 1024, dtype=np.uint8)
        sink = DeviceBuffer((256,), torch.float32, device=CPU)
        assert sink.nbytes == 1024

        recv_fut = server.arecv(sink, 11, MASK)
        await asyncio.sleep(0.01)
        await client.asend(src, 11)
        tag, length = await recv_fut

        assert (tag, length) == (11, 1024)
        np.testing.assert_array_equal(sink.array.numpy(),
                                      src.view(np.float32).reshape(256))
    finally:
        await client.aclose()
        await server.aclose()


async def test_host_to_device_inline_snapshots(port):
    """accept_host copies: mutating the sender's buffer after send
    completion must not change the delivered tensor."""
    server, client, _ep = await _pair(port)
    try:
        src = np.arange(1024, dtype=np.uint8) % 251
        want = src.copy()
        sink = DeviceBuffer((1024,), torch.uint8, device=CPU)
        recv_fut = server.arecv(sink, 12, MASK)
        await asyncio.sleep(0.01)
        await client.asend(src, 12)
        await recv_fut
        src[:] = 0  # sender reuses its buffer post-completion
        np.testing.assert_array_equal(sink.array.numpy(), want)
    finally:
        await client.aclose()
        await server.aclose()


async def test_device_unexpected_then_post(port):
    """A device message arriving before the recv is posted parks in the
    unexpected queue as a device snapshot (no host copy)."""
    server, client, _ep = await _pair(port)
    try:
        src = torch.full((64,), 3.5, dtype=torch.bfloat16)
        await client.asend(src, 21)
        await asyncio.sleep(0.05)

        sink = DeviceBuffer((64,), torch.bfloat16, device=CPU)
        tag, length = await server.arecv(sink, 21, MASK)
        assert (tag, length) == (21, 128)
        assert sink.last_transport == "device"
        assert torch.equal(sink.array, src)
    finally:
        await client.aclose()
        await server.aclose()


async def test_server_to_client_device_send(port):
    server, client, ep = await _pair(port)
    try:
        src = torch.linspace(0, 1, 128, dtype=torch.float32)
        sink = DeviceBuffer.like(src, device=CPU)

        recv_fut = client.arecv(sink, 13, MASK)
        await asyncio.sleep(0.01)
        await server.asend(ep, src, 13)
        tag, length = await recv_fut
        assert (tag, length) == (13, 512)
        assert torch.equal(sink.array, src)
    finally:
        await client.aclose()
        await server.aclose()


async def test_devicebuffer_send_side(port):
    """A DeviceBuffer holding a tensor can itself be the send payload."""
    server, client, _ep = await _pair(port)
    try:
        holder = DeviceBuffer((32,), torch.int32,
                              array=torch.arange(32, dtype=torch.int32))
        host_sink = np.zeros(32 * 4, dtype=np.uint8)
        recv_fut = server.arecv(host_sink, 15, MASK)
        await asyncio.sleep(0.01)
        await client.asend(holder, 15)
        tag, length = await recv_fut
        assert (tag, length) == (15, 128)
        np.testing.assert_array_equal(host_sink.view(np.int32),
                                      np.arange(32, dtype=np.int32))
    finally:
        await client.aclose()
        await server.aclose()


# ---------------------------------------- twins of tests/test_dataplane.py


@pytest.mark.parametrize("engine", ["python", "native"])
async def test_completion_batch_single_trampoline_hop(port, monkeypatch,
                                                      engine):
    """A burst of N engine-thread completions reaches asyncio in O(1)
    call_soon_threadsafe hops, on both engines."""
    if engine == "native":
        from starway_tpu_torch.core import native

        if not native.available():
            pytest.skip("native engine unavailable")
    _force_tcp(monkeypatch, native=(engine == "native"))
    server, client, _ep = await _pair(port)
    loop = asyncio.get_running_loop()
    try:
        n_ops = 32
        sinks = [np.empty(256, dtype=np.uint8) for _ in range(n_ops)]
        recv_futs = [server.arecv(b, 0x900 + i, MASK)
                     for i, b in enumerate(sinks)]
        await asyncio.sleep(0.1)  # recvs posted on the engine

        hops = {"n": 0}
        orig = loop.call_soon_threadsafe

        def counting(cb, *args):
            hops["n"] += 1
            return orig(cb, *args)

        monkeypatch.setattr(loop, "call_soon_threadsafe", counting)
        payloads = [np.full(256, i % 251, dtype=np.uint8)
                    for i in range(n_ops)]
        send_futs = [client.asend(p, 0x900 + i)
                     for i, p in enumerate(payloads)]
        time.sleep(0.5)  # every completion piles up behind one drain
        await asyncio.gather(*send_futs, *recv_futs)
        monkeypatch.setattr(loop, "call_soon_threadsafe", orig)

        assert 1 <= hops["n"] <= n_ops // 4, hops
        for i, b in enumerate(sinks):
            np.testing.assert_array_equal(b, payloads[i])
    finally:
        await client.aclose()
        await server.aclose()


async def test_chunked_send_overlaps_staging(port, monkeypatch):
    """A device payload on the framed stream stages chunk by chunk
    (DevicePayload.host_chunk) instead of one full-payload copy."""
    _force_tcp(monkeypatch, native=False, chunk=64 * 1024)
    calls: list = []
    orig = device.DevicePayload.host_chunk

    def spy(self, pos):
        calls.append(pos)
        return orig(self, pos)

    monkeypatch.setattr(device.DevicePayload, "host_chunk", spy)
    server, client, _ep = await _pair(port)
    try:
        src = torch.arange(256 * 1024, dtype=torch.float32)
        sink = DeviceBuffer((256 * 1024,), torch.float32, device=CPU)
        recv_fut = server.arecv(sink, 31, MASK)
        await asyncio.sleep(0.01)
        await client.asend(src, 31)
        tag, length = await recv_fut
        assert (tag, length) == (31, 1 << 20)
        assert torch.equal(sink.array, src)
        chunks_touched = {pos // (64 * 1024) for pos in calls}
        assert len(chunks_touched) >= 2, calls[:8]
    finally:
        await client.aclose()
        await server.aclose()


async def test_chunked_send_with_queued_frames_behind(port, monkeypatch):
    """A chunked payload + a second send + a flush, queued in one burst,
    deliver both payloads intact and complete the flush."""
    _force_tcp(monkeypatch, native=False, chunk=64 * 1024)
    server, client, _ep = await _pair(port)
    try:
        src = torch.arange(256 * 1024, dtype=torch.float32)
        tail = np.random.randint(0, 255, 2048, dtype=np.uint8)
        sink = DeviceBuffer((256 * 1024,), torch.float32, device=CPU)
        tail_sink = np.empty(2048, dtype=np.uint8)
        f1 = server.arecv(sink, 61, MASK)
        f2 = server.arecv(tail_sink, 62, MASK)
        await asyncio.sleep(0.01)
        s1 = client.asend(src, 61)
        s2 = client.asend(tail, 62)
        fl = client.aflush()
        await asyncio.gather(s1, s2, fl, f1, f2)
        assert torch.equal(sink.array, src)
        np.testing.assert_array_equal(tail_sink, tail)
    finally:
        await client.aclose()
        await server.aclose()


async def test_chunked_send_over_sm_ring(port, monkeypatch):
    """The chunked payload protocol also feeds the sm ring's TX path."""
    monkeypatch.setenv("STARWAY_TLS", "sm,tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    monkeypatch.setenv("STARWAY_CHUNK", str(64 * 1024))
    server, client, _ep = await _pair(port)
    try:
        src = torch.arange(128 * 1024, dtype=torch.float32)  # 8 chunks
        sink = DeviceBuffer((128 * 1024,), torch.float32, device=CPU)
        recv_fut = server.arecv(sink, 33, MASK)
        await asyncio.sleep(0.01)
        await client.asend(src, 33)
        tag, length = await recv_fut
        assert (tag, length) == (33, 512 * 1024)
        assert torch.equal(sink.array, src)
    finally:
        await client.aclose()
        await server.aclose()


async def test_chunked_recv_placement_overlap(port, monkeypatch):
    """With the overlap gate forced open (it is cuda-only by default),
    completed chunks are copied into the sink mid-stream, each into its
    slice of the same tensor."""
    _force_tcp(monkeypatch, native=False, chunk=64 * 1024)
    monkeypatch.setattr(device, "_rx_overlap_ok", lambda dev: dev is not None)
    placed: list = []
    orig = device.DeviceRecvSink._place_chunk

    def spy(self, off, nbytes):
        placed.append((off, nbytes))
        return orig(self, off, nbytes)

    monkeypatch.setattr(device.DeviceRecvSink, "_place_chunk", spy)
    server, client, _ep = await _pair(port)
    try:
        src = np.random.randint(0, 255, 512 * 1024, dtype=np.uint8)
        sink = DeviceBuffer((128 * 1024,), torch.float32, device=CPU)
        ptr = sink.array.data_ptr()
        recv_fut = server.arecv(sink, 35, MASK)
        await asyncio.sleep(0.01)
        await client.asend(src, 35)
        tag, length = await recv_fut
        assert (tag, length) == (35, src.nbytes)
        assert placed == [(k * 65536, 65536) for k in range(8)]
        assert sink.last_transport == "staged"
        assert sink.array.data_ptr() == ptr
        np.testing.assert_array_equal(sink.array.numpy(),
                                      src.view(np.float32))
    finally:
        await client.aclose()
        await server.aclose()


async def test_staging_pool_recycles_buffers(port, monkeypatch):
    """The second streamed receive of a size reuses the first's staging
    buffer (pool hit)."""
    _force_tcp(monkeypatch, native=False)
    server, client, _ep = await _pair(port)
    try:
        nbytes = 96 * 1024 + 512  # unlikely to collide with other suites
        src = np.random.randint(0, 255, nbytes, dtype=np.uint8)
        hits0 = device._staging_pool.hits
        for i in range(2):
            sink = DeviceBuffer((nbytes,), torch.uint8, device=CPU)
            recv_fut = server.arecv(sink, 40 + i, MASK)
            await asyncio.sleep(0.01)
            await client.asend(src, 40 + i)
            await recv_fut
            np.testing.assert_array_equal(sink.array.numpy(), src)
        assert device._staging_pool.hits > hits0
    finally:
        await client.aclose()
        await server.aclose()


async def test_small_send_burst_gathered_in_order(port, monkeypatch):
    """A burst of small sends coalesces through the gathered sendmsg pump
    and still delivers every payload, with tx/rx telemetry recorded."""
    _force_tcp(monkeypatch, native=False)
    server, client, _ep = await _pair(port)
    try:
        perf.stage_reset()
        n_msgs = 64
        sinks = [np.empty(128, dtype=np.uint8) for _ in range(n_msgs)]
        recv_futs = [server.arecv(b, 0x700 + i, MASK)
                     for i, b in enumerate(sinks)]
        await asyncio.sleep(0.05)
        payloads = [np.full(128, (i * 7) % 251, dtype=np.uint8)
                    for i in range(n_msgs)]
        await asyncio.gather(
            *(client.asend(p, 0x700 + i) for i, p in enumerate(payloads)))
        await asyncio.gather(*recv_futs)
        await client.aflush()
        for i, b in enumerate(sinks):
            np.testing.assert_array_equal(b, payloads[i])
        snap = perf.stage_snapshot()
        assert snap.get("tx", {}).get("count", 0) > 0, snap
        assert snap.get("rx", {}).get("count", 0) > 0, snap
        assert snap["tx"]["count"] < n_msgs, snap["tx"]
        assert snap["tx"]["bytes"] >= n_msgs * 128
    finally:
        await client.aclose()
        await server.aclose()


async def test_evaluate_perf_detail_reports_stages(port, monkeypatch):
    _force_tcp(monkeypatch, native=False)
    server, client, _ep = await _pair(port)
    try:
        detail = client.evaluate_perf_detail(1 << 20)
        assert "stages" in detail and isinstance(detail["stages"], dict)
    finally:
        await client.aclose()
        await server.aclose()


# ------------------------------------------------- what a tensor adds


@pytest.mark.parametrize("chunked", [False, True])
async def test_partial_receive_writes_in_place(port, transport, monkeypatch,
                                               chunked):
    """A receive shorter than the buffer fills the first ``length`` bytes
    of the tensor's flat uint8 view and leaves the rest alone; the tensor
    is never replaced."""
    if chunked:
        monkeypatch.setenv("STARWAY_CHUNK", str(4096))
        monkeypatch.setattr(device, "_rx_overlap_ok",
                            lambda dev: dev is not None)
    server, client, _ep = await _pair(port)
    try:
        sink = DeviceBuffer((4096,), torch.float32, device=CPU)
        sink.array.fill_(7.0)
        ptr = sink.array.data_ptr()
        flat = sink.array.view(torch.uint8)
        rest = flat[10002:].clone()
        src = _random_bytes(10002, seed=1)
        recv_fut = server.arecv(sink, 5, MASK)
        await asyncio.sleep(0.01)
        await client.asend(src, 5)
        assert await recv_fut == (5, 10002)
        assert sink.array.data_ptr() == ptr
        assert torch.equal(flat[:10002], src)
        assert torch.equal(flat[10002:], rest)
    finally:
        await client.aclose()
        await server.aclose()


@pytest.mark.parametrize("nbytes", [4096, 1 << 20, 9 << 20])
async def test_overwrite_after_send_delivers_the_original(port, transport,
                                                          nbytes):
    """Send completion licenses the sender to overwrite its tensor: the
    in-process path parks a snapshot, the wire stages a host copy (9 MiB
    is past the rendezvous threshold, where completion comes before the
    bytes are on the wire)."""
    server, client, _ep = await _pair(port)
    try:
        src = _random_bytes(nbytes, seed=2)
        want = src.clone()
        await client.asend(src, 17)
        src.zero_()
        sink = DeviceBuffer((nbytes,), torch.uint8, device=CPU)
        assert await server.arecv(sink, 17, MASK) == (17, nbytes)
        assert torch.equal(sink.array, want)
    finally:
        await client.aclose()
        await server.aclose()


# case -> (receive posted before the send, target, sink bytes short of the
# payload): "alias" receives into the sender's own memory.
INPROC_CASES = {
    "posted-sink": (True, "sink", 0),
    "posted-host": (True, "host", 0),
    "posted-host-bounced": (True, "host", 0),
    "parked-sink": (False, "sink", 0),
    "parked-host": (False, "host", 0),
    "alias-sink": (True, "alias-sink", 0),
    "alias-host": (True, "alias-host", 0),
    "truncated-posted": (True, "sink", 1),
    "truncated-parked": (False, "sink", 1),
}


@pytest.mark.parametrize("case", sorted(INPROC_CASES))
async def test_inproc_device_send_copies_once(port, monkeypatch, case):
    """An in-process device send to a posted receive makes one copy,
    straight into the receive's memory, ordered after the events of both
    posts, and no snapshot; a message that parks is snapshotted once when
    it parks and copied from the snapshot when claimed; a target sharing
    the sender's memory gets the snapshot too; a truncated receive copies
    nothing.  A small copy into pageable host memory on the card goes
    through a pooled pinned buffer: still one copy of the device plane
    (forced here on CPU tensors).  The sender zeroes its tensor as soon as the send completes
    (but where it is the target): every receive still holds the original,
    and ``last_transport`` says "device" wherever a sink received."""
    posted, target, short = INPROC_CASES[case]
    copies, snapshots = [], []
    real_copy, real_snapshot = device._copy, device.DevicePayload.snapshot

    def count_copy(dst, src, role, *after):
        copies.append(after)
        return real_copy(dst, src, role, *after)

    def count_snapshot(self):
        snapshots.append(self)
        return real_snapshot(self)

    marks = iter(range(1, 100))  # stand-ins for the events of the posts
    monkeypatch.setattr(device, "_copy", count_copy)
    monkeypatch.setattr(device.DevicePayload, "snapshot", count_snapshot)
    monkeypatch.setattr(device, "_posted_event", lambda t: next(marks))
    if case.endswith("bounced"):
        pool = device._StagingPool()
        monkeypatch.setattr(device, "_staging_pool", pool)
        monkeypatch.setattr(device, "_d2h_bounce", lambda src, dst: True)
    n = 4096
    server, client, _ep = await _pair(port)
    try:
        src = _random_bytes(n, seed=3)
        want = src.clone()
        if target == "sink":
            sink = DeviceBuffer((n - short,), torch.uint8, device=CPU)
            sink.array.fill_(9)
            out = sink.array
        elif target == "host":
            sink = out = np.zeros(n, dtype=np.uint8)
        elif target == "alias-sink":
            sink = DeviceBuffer((n,), torch.uint8, array=src)
            out = sink.array
        else:  # alias-host: a host view of the sender's own memory
            sink = out = src.numpy()
        before = torch.as_tensor(out).clone()
        if posted:
            fut = server.arecv(sink, 30, MASK)  # its post takes mark 1
        await client.asend(src, 30)  # mark 2 into a posted sink, else 1
        if not target.startswith("alias"):  # an alias's sink is the sender
            src.zero_()
        parked = (len(copies), len(snapshots))
        if not posted:
            fut = server.arecv(sink, 30, MASK)
        if short:
            with pytest.raises(Exception, match=REASON_TRUNCATED):
                await fut
            assert torch.equal(torch.as_tensor(out), before)
            assert (len(copies), len(snapshots)) == parked
            assert sink.last_transport is None
            assert parked == ((0, 0) if posted else (1, 1))
            return
        assert await fut == (30, n)
        assert torch.equal(torch.as_tensor(out), want)
        if case.endswith("bounced"):  # the buffer went back to the pool
            assert (pool.misses, pool.hits) == (1, 0)
            assert pool.get(n) is not None and pool.hits == 1
        if target in ("sink", "alias-sink"):
            assert sink.last_transport == "device"
        if posted and not target.startswith("alias"):
            assert (len(copies), len(snapshots)) == (1, 0)
            # the delivery waits on the send's post and, into a sink, on
            # the receive's
            assert sorted(e for e in copies[0] if e is not None) == (
                [1, 2] if target == "sink" else [1])
        else:
            assert (len(copies), len(snapshots)) == (2, 1)
            # a parked send snapshots before it completes; a posted one is
            # delivered by then
            assert parked == ((2, 1) if posted else (1, 1))
    finally:
        await client.aclose()
        await server.aclose()


class _Event:
    """Stands in for a CUDA event: ``query()`` is True once ``done``."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        pass


def test_staging_pool_recycles_only_after_the_event():
    pool = device._StagingPool(cap_bytes=1 << 20)
    buf = pool.get(4096)
    assert (pool.hits, pool.misses) == (0, 1)
    ev = _Event()
    pool.put(buf, ev)
    assert pool.inflight == 1 and pool._held == 0
    other = pool.get(4096)  # the copy still reads `buf`: a fresh buffer
    assert other is not buf and (pool.hits, pool.misses) == (0, 2)
    ev.done = True
    assert pool.get(4096) is buf  # reaped once its event completed
    assert pool.inflight == 0 and (pool.hits, pool.misses) == (1, 2)
    pool.put(other)  # no copy in flight: recycled at once
    assert pool._held == 4096 and pool.get(4096) is other


async def test_sink_returns_staging_with_its_last_copy_event(port,
                                                             monkeypatch):
    """A streamed receive hands its staging buffer back with the event of
    the last copy that reads it; the buffer is reused only once that
    event has completed."""
    _force_tcp(monkeypatch, native=False, chunk=64 * 1024)
    monkeypatch.setattr(device, "_rx_overlap_ok", lambda dev: dev is not None)
    pool = device._StagingPool()
    monkeypatch.setattr(device, "_staging_pool", pool)
    events = []
    real_copy = device._copy

    def copy(dst, src, role, after=None):
        real_copy(dst, src, role, after)
        if role != "rx":  # the sender's copies to host memory
            return None
        events.append(_Event())
        return events[-1]

    monkeypatch.setattr(device, "_copy", copy)
    server, client, _ep = await _pair(port)
    try:
        src = _random_bytes(256 * 1024, seed=3)
        sink = DeviceBuffer((256 * 1024,), torch.uint8, device=CPU)
        fut = server.arecv(sink, 23, MASK)
        await client.asend(src, 23)
        await fut
        assert torch.equal(sink.array, src)
        assert len(events) == 4  # four 64 KiB chunks, one copy each
        assert pool.inflight == 1 and pool.hits == 0
        fut = server.arecv(sink, 24, MASK)
        await client.asend(src, 24)
        await fut
        assert pool.hits == 0 and pool.misses == 2  # still in flight
        for ev in events:
            ev.done = True
        fut = server.arecv(sink, 25, MASK)
        await client.asend(src, 25)
        await fut
        assert pool.hits == 1
    finally:
        await client.aclose()
        await server.aclose()


@pytest.mark.parametrize("dtype, want", [
    (torch.bfloat16, torch.bfloat16), (jnp.bfloat16, torch.bfloat16),
    ("bfloat16", torch.bfloat16), (np.float32, torch.float32),
    (np.dtype("int8"), torch.int8), (jnp.int32, torch.int32),
    ("float16", torch.float16), (bool, torch.bool)])
def test_dtype_mapping(dtype, want):
    buf = DeviceBuffer((2, 3), dtype, device=CPU)
    assert buf.dtype == want and buf.array.dtype == want
    assert buf.nbytes == 6 * want.itemsize


def test_dtype_mapping_refuses_what_torch_lacks():
    with pytest.raises(TypeError):
        DeviceBuffer((2,), "not_a_dtype", device=CPU)
    with pytest.raises(ValueError):
        DeviceBuffer((2,), torch.float32,
                     array=torch.zeros(3, dtype=torch.float32))


async def test_bf16_payload_crosses_bit_for_bit(port, transport):
    """bf16 reaches the wire as its flat uint8 view and lands in a bf16
    sink bit for bit, NaN payloads and signed zeros included."""
    server, client, ep = await _pair(port)
    try:
        bits = _random_bytes(2 * 3000, seed=4).view(torch.int16)
        src = bits.view(torch.bfloat16).reshape(3, 1000)
        sink = DeviceBuffer((3, 1000), torch.bfloat16, device=CPU)
        fut = server.arecv(sink, 19, MASK)
        await client.asend(src, 19)
        assert await fut == (19, 6000)
        assert torch.equal(sink.array.view(torch.int16), bits.reshape(3, 1000))
        back = DeviceBuffer.like(src)
        fut = client.arecv(back, 20, MASK)
        await server.asend(ep, sink, 20)
        await fut
        assert torch.equal(back.array.view(torch.int16), bits.reshape(3, 1000))
    finally:
        await client.aclose()
        await server.aclose()


# ------------------------------------- send_device's session, integrity and
# stripe branches: a journaled (session), checksummed (integrity) or
# striped send takes the flat host snapshot instead of the chunked
# pipeline; a pull bypasses all three.

BRANCH_SETTINGS = {
    "session": {"STARWAY_SESSION": "1"},
    "integrity": {"STARWAY_INTEGRITY": "1"},
    "stripe": {"STARWAY_RAILS": "3", "STARWAY_STRIPE_THRESHOLD": "1048576"},
}
BRANCH_BYTES = 3_000_000  # past the stripe threshold, under rendezvous


@pytest.mark.parametrize("setting", sorted(BRANCH_SETTINGS))
@pytest.mark.parametrize("pull", [False, True], ids=["staged", "pull"])
@pytest.mark.parametrize("engine", ["python", "native"])
async def test_device_send_branches_exact_both_ways(port, monkeypatch,
                                                    engine, pull, setting):
    """A 3 MB tensor over tcp each way under STARWAY_SESSION=1,
    STARWAY_INTEGRITY=1, or three rails striped above 1 MiB: the sink
    holds exactly the bytes sent, although the sender overwrote its
    tensor as soon as the send completed (the receive is posted only
    afterwards).  Both engines pull when the pull is on (the C++ engine's
    copy negotiates "cudaipc" as the Python engine does)."""
    if engine == "native":
        from starway_tpu_torch.core import native

        if not native.available():
            pytest.skip("native engine unavailable (no toolchain)")
    _force_tcp(monkeypatch, native=engine == "native")
    monkeypatch.setenv("STARWAY_DEVPULL", "1" if pull else "0")
    for name, value in BRANCH_SETTINGS[setting].items():
        monkeypatch.setenv(name, value)
    server, client, ep = await _pair(port)
    want_route = "device" if pull else "staged"
    try:
        if engine == "python":
            # The branch under test is the one negotiated on the conn.
            conns = list(client._client.conns.values())
            armed = {"session": lambda c: c.sess is not None,
                     "integrity": lambda c: bool(c.csum_ok),
                     "stripe": lambda c: bool(c.rails)}[setting]
            assert conns and any(armed(c) for c in conns)
        for seed, (send, recv) in enumerate((
                (lambda t, tag: client.asend(t, tag), server.arecv),
                (lambda t, tag: server.asend(ep, t, tag), client.arecv))):
            src = _random_bytes(BRANCH_BYTES, seed=10 + seed)
            want = src.clone()
            await send(src, 40 + seed)
            src.zero_()
            sink = DeviceBuffer((BRANCH_BYTES,), torch.uint8, device=CPU)
            ptr = sink.array.data_ptr()
            got = await asyncio.wait_for(recv(sink, 40 + seed, MASK), 60)
            assert got == (40 + seed, BRANCH_BYTES)
            assert sink.array.data_ptr() == ptr
            assert torch.equal(sink.array, want)
            assert sink.last_transport == want_route
    finally:
        await client.aclose()
        await server.aclose()


@pytest.mark.parametrize("engine", ["python", "native"])
async def test_completed_receive_keeps_no_reference_to_its_sink(
        port, monkeypatch, engine):
    """Once a staged receive has completed and the caller drops its sink,
    the transport keeps no reference to it: the engine thread drops each
    delivered batch of completions before it waits for the next event,
    so a payload-sized tensor is not held until the next wakeup."""
    import gc
    import weakref

    if engine == "native":
        from starway_tpu_torch.core import native

        if not native.available():
            pytest.skip("native engine unavailable (no toolchain)")
    _force_tcp(monkeypatch, native=engine == "native")
    server, client, _ep = await _pair(port)
    try:
        sink = DeviceBuffer((1 << 20,), torch.uint8, device=CPU)
        fut = server.arecv(sink, 0x23, MASK)
        await client.asend(torch.full((1 << 20,), 5, dtype=torch.uint8),
                           0x23)
        await client.aflush()
        assert await fut == (0x23, 1 << 20)
        assert sink.last_transport == "staged"
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
