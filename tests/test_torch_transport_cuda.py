"""The transport's device plane on the card (cuda:0).

Every test here needs an NVIDIA GPU: each carries the ``cuda`` marker and
skips without a card.  Run them on a GPU machine with

    STARWAY_TEST_REAL_TPU=1 python -m pytest -m cuda tests/test_torch_transport_cuda.py

(the variable keeps tests/conftest.py from importing jax).  They hold what
CPU tensors cannot show: stream order on both sides of a transfer, pinned
staging and its recycling after the copies' events, and the device <->
device and host <-> device paths on the card, in process and on the wire.
"""

import asyncio

import numpy as np
import pytest
import torch

from starway_tpu_torch import Client, DeviceBuffer, Server, device

pytestmark = [pytest.mark.cuda, pytest.mark.asyncio]

ADDR = "127.0.0.1"
MASK = (1 << 64) - 1
SPIN = 40_000_000  # torch.cuda._sleep cycles: ~20 ms queued on the stream


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device plane's copies run on "
                    "CUDA streams")
    return torch.device("cuda:0")


@pytest.fixture(params=["inproc", "tcp", "sm", "native"])
def transport(request, monkeypatch):
    if request.param == "native":
        from starway_tpu_torch.core import native

        if not native.available():
            pytest.skip("native engine unavailable (no toolchain)")
    tls = {"inproc": "inproc,tcp", "tcp": "tcp", "sm": "tcp,sm",
           "native": "tcp"}[request.param]
    monkeypatch.setenv("STARWAY_TLS", tls)
    monkeypatch.setenv("STARWAY_NATIVE",
                       "1" if request.param == "native" else "0")
    return request.param


async def _pair(port):
    server = Server()
    client = Client()
    server.listen(ADDR, port)
    await client.aconnect(ADDR, port)
    for _ in range(400):
        if server.list_clients():
            break
        await asyncio.sleep(0.005)
    return server, client, server.list_clients().pop()


def _random(nbytes, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                         generator=gen).to(dev)


@pytest.mark.parametrize("nbytes", [4096, (1 << 20) + 3, 9 << 20])
async def test_device_to_device_on_the_card(port, dev, transport, nbytes):
    server, client, ep = await _pair(port)
    try:
        src = _random(nbytes, dev, seed=nbytes)
        sink = DeviceBuffer((nbytes,), torch.uint8, device=dev)
        back = DeviceBuffer((nbytes,), torch.uint8, device=dev)
        ptrs = (sink.array.data_ptr(), back.array.data_ptr())
        fut = server.arecv(sink, 1, MASK)
        await client.asend(src, 1)
        assert await fut == (1, nbytes)
        fut = client.arecv(back, 2, MASK)
        await server.asend(ep, sink, 2)
        assert await fut == (2, nbytes)
        assert torch.equal(sink.array, src) and torch.equal(back.array, src)
        assert (sink.array.data_ptr(), back.array.data_ptr()) == ptrs
        want = "device" if transport == "inproc" else "staged"
        assert sink.last_transport == back.last_transport == want
    finally:
        await client.aclose()
        await server.aclose()


async def test_host_to_device_and_back(port, dev, transport):
    server, client, ep = await _pair(port)
    try:
        src = np.random.default_rng(1).integers(0, 256, 1 << 20,
                                                dtype=np.uint8)
        sink = DeviceBuffer((1 << 18,), torch.float32, device=dev)
        fut = server.arecv(sink, 3, MASK)
        await client.asend(src, 3)
        assert await fut == (3, 1 << 20)
        assert np.array_equal(sink.array.cpu().view(torch.uint8).numpy(), src)
        host = np.zeros(1 << 20, dtype=np.uint8)
        fut = client.arecv(host, 4, MASK)
        await server.asend(ep, sink, 4)
        assert await fut == (4, 1 << 20)
        assert np.array_equal(host, src)
    finally:
        await client.aclose()
        await server.aclose()


async def test_send_and_receive_follow_the_callers_stream(port, dev,
                                                          transport):
    """The payload is written by a kernel queued behind a spin on the
    current stream and sent with no synchronize; the sink is written by
    such a kernel just before the receive is posted.  The sink must end
    up holding the payload's new values."""
    server, client, _ep = await _pair(port)
    try:
        payload = torch.zeros(1 << 20, dtype=torch.float32, device=dev)
        sink = DeviceBuffer((1 << 20,), torch.float32, device=dev)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN)
        sink.array.fill_(-1.0)
        fut = server.arecv(sink, 5, MASK)
        torch.cuda._sleep(SPIN)
        payload.fill_(3.0)
        await client.asend(payload, 5)
        await fut
        assert bool((sink.array == 3.0).all())
    finally:
        await client.aclose()
        await server.aclose()


@pytest.mark.parametrize("nbytes", [1 << 20, 9 << 20])
async def test_overwrite_after_send(port, dev, transport, nbytes):
    server, client, _ep = await _pair(port)
    try:
        src = _random(nbytes, dev, seed=7)
        want = src.clone()
        await client.asend(src, 6)
        src.zero_()
        sink = DeviceBuffer((nbytes,), torch.uint8, device=dev)
        assert await server.arecv(sink, 6, MASK) == (6, nbytes)
        assert torch.equal(sink.array, want)
    finally:
        await client.aclose()
        await server.aclose()


async def test_bf16_on_the_card(port, dev, transport):
    server, client, _ep = await _pair(port)
    try:
        x = torch.randn(3, 1000, device=dev).to(torch.bfloat16)
        sink = DeviceBuffer((3, 1000), torch.bfloat16, device=dev)
        fut = server.arecv(sink, 8, MASK)
        await client.asend(x, 8)
        assert await fut == (8, 6000)
        assert torch.equal(sink.array, x)
    finally:
        await client.aclose()
        await server.aclose()


def test_staging_for_a_card_is_pinned(dev):
    sink = device.DeviceRecvSink(DeviceBuffer((1 << 20,), torch.uint8,
                                              device=dev))
    sink.host_staging()
    assert sink._staging.is_pinned()
    sink.finalize_from_host(1 << 20)
    cpu_sink = device.DeviceRecvSink(DeviceBuffer((1 << 20,), torch.uint8,
                                                  device="cpu"))
    cpu_sink.host_staging()
    assert not cpu_sink._staging.is_pinned()
    cpu_sink.finalize_from_host(1 << 20)
    host, event = device.DevicePayload(_random(1 << 20, dev))._to_host(
        0, 1 << 20)
    event.synchronize()
    assert host.is_pinned()


async def test_pinned_staging_recycles_after_its_copies(port, dev,
                                                        monkeypatch):
    """A streamed receive on the card returns its pinned staging buffer
    with the last copy's event; once that has completed (a receive
    completes only then) the next receive of the size reuses it."""
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    pool = device._StagingPool()
    monkeypatch.setattr(device, "_staging_pool", pool)
    server, client, _ep = await _pair(port)
    try:
        src = _random(1 << 20, dev, seed=9)
        for i in range(3):
            sink = DeviceBuffer((1 << 20,), torch.uint8, device=dev)
            fut = server.arecv(sink, 10 + i, MASK)
            await client.asend(src, 10 + i)
            await fut
            assert torch.equal(sink.array, src)
        again = pool.get(1 << 20, pinned=True)  # reaps the last one too
        assert (pool.misses, pool.hits, pool.inflight) == (1, 3, 0)
        assert again.is_pinned()
    finally:
        await client.aclose()
        await server.aclose()
