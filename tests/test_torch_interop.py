"""A JAX peer against a port peer on one wire.

The two packages keep separate host runtimes (the port has its own copy of
``core/``, its own fabric registry and its own build of the C++ engine), so
a JAX ``Client`` meets a port ``Server`` only over a real transport: tcp or
the sm rings negotiated over it.  Held exactly: the bytes, ``(sender_tag,
length)`` and the failure reasons, on both engines and in both directions;
neither the JAX package's ``devpull`` nor the port's own ``cudaipc`` is
negotiated between the packages, so device payloads cross as staged
frames.  Following tests/test_sm.py's engine interop,
one set of cases also crosses a real process boundary."""

import asyncio
import multiprocessing as mp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import starway_tpu
import starway_tpu_torch

pytestmark = pytest.mark.asyncio

ADDR = "127.0.0.1"
MASK = (1 << 64) - 1
SIZES = [1, 4096, (1 << 20) + 3, 4 << 20]
PKGS = {"jax": starway_tpu, "port": starway_tpu_torch}


def _native_available() -> bool:
    from starway_tpu.core import native as jax_native
    from starway_tpu_torch.core import native as port_native

    return jax_native.available() and port_native.available()


def _engines(monkeypatch, native: bool):
    if native and not _native_available():
        pytest.skip("native engine unavailable (no toolchain)")
    monkeypatch.setenv("STARWAY_NATIVE", "1" if native else "0")


async def _pair(monkeypatch, port, server_pkg, client_pkg, server_native,
                client_native):
    """A Server of one package and a Client of the other (or the same),
    each on the engine asked for (STARWAY_NATIVE is read per worker)."""
    _engines(monkeypatch, server_native)
    server = PKGS[server_pkg].Server()
    server.listen(ADDR, port)
    _engines(monkeypatch, client_native)
    client = PKGS[client_pkg].Client()
    await client.aconnect(ADDR, port)
    for _ in range(400):
        if server.list_clients():
            break
        await asyncio.sleep(0.005)
    return server, client, server.list_clients().pop()


def _payload(pkg, data: np.ndarray):
    """The same bytes as a device payload of ``pkg``: a jax.Array on the
    CPU device or a CPU tensor."""
    if pkg == "jax":
        return jnp.asarray(data)
    return torch.from_numpy(data.copy())


def _sink(pkg, shape, dtype):
    if pkg == "jax":
        return starway_tpu.DeviceBuffer(shape, dtype,
                                        device=jax.devices()[0])
    return starway_tpu_torch.DeviceBuffer(shape, dtype, device="cpu")


def _sink_bytes(pkg, sink) -> bytes:
    if pkg == "jax":
        return np.asarray(sink.array).tobytes()
    return sink.array.view(torch.uint8).numpy().tobytes()


@pytest.fixture(params=["tcp", "sm"])
def wire(request, monkeypatch):
    monkeypatch.setenv("STARWAY_TLS", "tcp" if request.param == "tcp"
                       else "tcp,sm")
    return request.param


@pytest.mark.parametrize("server_native", [False, True],
                         ids=["srv-py", "srv-native"])
@pytest.mark.parametrize("client_native", [False, True],
                         ids=["cli-py", "cli-native"])
@pytest.mark.parametrize("server_pkg, client_pkg",
                         [("port", "jax"), ("jax", "port")])
async def test_bytes_and_tags_cross_packages(port, monkeypatch, wire,
                                             server_pkg, client_pkg,
                                             server_native, client_native):
    jnp.zeros(1).block_until_ready()
    # The JAX peer offers devpull (its backend is up); the port never acks.
    assert starway_tpu.device.devpull_supported()
    assert not starway_tpu_torch.device.devpull_supported()
    server, client, ep = await _pair(monkeypatch, port, server_pkg,
                                     client_pkg, server_native,
                                     client_native)
    try:
        if wire == "sm":
            assert ep.view_transports() == [("shm", "sm")]
        # devpull is never acknowledged between a port peer and a JAX peer
        assert not client._client.primary_conn.devpull_ok
        assert not ep._conn.devpull_ok
        rng = np.random.default_rng(len(server_pkg) + 2 * server_native
                                    + 4 * client_native)
        tag = 0x100
        for nbytes in SIZES:
            data = rng.integers(0, 256, nbytes, dtype=np.uint8)
            for sender, send, recv_pkg, recv in (
                    (client_pkg, client.asend, server_pkg, server.arecv),
                    (server_pkg, lambda b, t: server.asend(ep, b, t),
                     client_pkg, client.arecv)):
                # host payload -> host buffer, device payload -> device sink
                host = np.zeros(nbytes, dtype=np.uint8)
                fut = recv(host, 0, 0)
                await send(data, tag)
                assert await fut == (tag, nbytes)
                assert host.tobytes() == data.tobytes()
                tag += 1
                sink = _sink(recv_pkg, (nbytes,), np.uint8)
                fut = recv(sink, tag, MASK)
                await send(_payload(sender, data), tag)
                assert await fut == (tag, nbytes)
                assert _sink_bytes(recv_pkg, sink) == data.tobytes()
                assert sink.last_transport == "staged"
                tag += 1
    finally:
        await client.aclose()
        await server.aclose()


@pytest.mark.parametrize("native", [False, True], ids=["py", "native"])
@pytest.mark.parametrize("server_pkg, client_pkg",
                         [("port", "jax"), ("jax", "port")])
async def test_no_pull_is_negotiated_across_packages(port, monkeypatch,
                                                     server_pkg, client_pkg,
                                                     native):
    """The JAX peer, its backend up, offers "devpull"; the port's Python
    engine offers its own "cudaipc".  Between the packages neither is
    acknowledged, on either engine, so device payloads above
    STARWAY_DEVPULL_MIN ride staged frames both ways: the same bytes and
    (tag, length) as ever."""
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    jnp.zeros(1).block_until_ready()
    assert starway_tpu.device.devpull_supported()
    assert starway_tpu_torch.device.cudaipc_identity() is not None
    server, client, ep = await _pair(monkeypatch, port, server_pkg,
                                     client_pkg, native, native)
    try:
        for conn in (client._client.primary_conn, ep._conn):
            assert not conn.devpull_ok
            assert getattr(conn, "cudaipc_peer", None) is None
        rng = np.random.default_rng(11 + native)
        for tag, nbytes in ((0x300, 1 << 20), (0x301, (4 << 20) + 5)):
            data = rng.integers(0, 256, nbytes, dtype=np.uint8)
            for sender, send, recv_pkg, recv in (
                    (client_pkg, client.asend, server_pkg, server.arecv),
                    (server_pkg, lambda b, t: server.asend(ep, b, t),
                     client_pkg, client.arecv)):
                sink = _sink(recv_pkg, (nbytes,), np.uint8)
                fut = recv(sink, tag, MASK)
                await send(_payload(sender, data), tag)
                assert await fut == (tag, nbytes)
                assert _sink_bytes(recv_pkg, sink) == data.tobytes()
                assert sink.last_transport == "staged"
    finally:
        await client.aclose()
        await server.aclose()


@pytest.mark.parametrize("server_pkg, client_pkg",
                         [("port", "jax"), ("jax", "port")])
async def test_bf16_crosses_packages_bit_for_bit(port, monkeypatch,
                                                 server_pkg, client_pkg):
    """A jnp.bfloat16 array lands in a torch.bfloat16 sink bit for bit,
    and back."""
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    server, client, ep = await _pair(monkeypatch, port, server_pkg,
                                     client_pkg, False, False)
    try:
        bits = np.random.default_rng(5).integers(
            0, 1 << 16, (3, 1000), dtype=np.uint16)
        arr = jnp.asarray(bits).view(jnp.bfloat16)
        ten = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
        for src, dst_pkg in ((arr, "port"), (ten, "jax")):
            sink = _sink(dst_pkg, (3, 1000), jnp.bfloat16)
            if dst_pkg == server_pkg:
                fut = server.arecv(sink, 9, MASK)
                await client.asend(src, 9)
            else:
                fut = client.arecv(sink, 9, MASK)
                await server.asend(ep, src, 9)
            assert await fut == (9, 6000)
            assert _sink_bytes(dst_pkg, sink) == bits.tobytes()
    finally:
        await client.aclose()
        await server.aclose()


async def _failure_reasons(monkeypatch, port, server_pkg, client_pkg,
                           native) -> list:
    """(truncation, timeout, cancel-on-close) reasons of one pairing."""
    server, client, ep = await _pair(monkeypatch, port, server_pkg,
                                     client_pkg, native, native)
    reasons = []
    try:
        small = np.zeros(10, dtype=np.uint8)
        fut = server.arecv(small, 0, 0)
        await asyncio.sleep(0.05)
        await client.asend(np.ones(100, dtype=np.uint8), 1)
        with pytest.raises(Exception) as e:
            await fut
        reasons.append(str(e.value))
        with pytest.raises(Exception) as e:
            await server.arecv(small, 77, MASK, timeout=0.2)
        reasons.append(str(e.value))
        fut = client.arecv(np.zeros(8, dtype=np.uint8), 99, MASK)
        await asyncio.sleep(0.05)
        await client.aclose()
        with pytest.raises(Exception) as e:
            await fut
        reasons.append(str(e.value))
    finally:
        await server.aclose()
    return reasons


@pytest.mark.parametrize("native", [False, True], ids=["py", "native"])
@pytest.mark.parametrize("server_pkg, client_pkg",
                         [("port", "jax"), ("jax", "port"), ("port", "port")])
async def test_failure_reasons_match_across_packages(port, port2, monkeypatch,
                                                     server_pkg, client_pkg,
                                                     native):
    """Truncation, timeout and cancel-on-close fail with the JAX package's
    own reasons, word for word."""
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    want = await _failure_reasons(monkeypatch, port, "jax", "jax", native)
    for word, reason in zip(("truncat", "timed out", "cancel"), want):
        assert word in reason
    assert await _failure_reasons(monkeypatch, port2, server_pkg, client_pkg,
                                  native) == want


def _child_echo(port, pkg, native):
    """Spawned peer: a Client of ``pkg`` over tcp,sm that receives one 32
    MiB host payload and sends it back with tag 0x8."""
    import os

    os.environ["STARWAY_TLS"] = "tcp,sm"
    os.environ["STARWAY_NATIVE"] = "1" if native else "0"
    import importlib

    Client = importlib.import_module(pkg).Client

    async def run():
        client = None
        for i in range(120):
            client = Client()
            try:
                await client.aconnect(ADDR, port)
                break
            except Exception:
                if i == 119:
                    raise
                await asyncio.sleep(0.25)
        buf = np.zeros(32 << 20, dtype=np.uint8)
        tag, length = await client.arecv(buf, 0x7, MASK)
        assert (tag, length) == (0x7, 32 << 20)
        await client.asend(buf, 0x8)
        await client.aflush()
        await client.aclose()

    asyncio.run(run())


@pytest.mark.parametrize("server_pkg, server_native, client_native", [
    ("port", False, True), ("port", True, False),
    ("jax", False, True), ("jax", True, False)])
async def test_cross_process_sm_interop(port, monkeypatch, server_pkg,
                                        server_native, client_native):
    """A server of one package and a spawned client of the other negotiate
    sm across a real process boundary and move 32 MiB both ways."""
    if (server_native or client_native) and not _native_available():
        pytest.skip("native engine unavailable (no toolchain)")
    monkeypatch.setenv("STARWAY_TLS", "tcp,sm")
    monkeypatch.setenv("STARWAY_NATIVE", "1" if server_native else "0")
    client_pkg = "starway_tpu" if server_pkg == "port" else "starway_tpu_torch"
    server = PKGS[server_pkg].Server()
    server.listen(ADDR, port)
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=_child_echo, args=(port, client_pkg,
                                              client_native), daemon=True)
    p.start()
    try:
        for _ in range(3000):
            if server.list_clients():
                break
            await asyncio.sleep(0.01)
        ep = next(iter(server.list_clients()))
        assert ep.view_transports() == [("shm", "sm")]
        data = (np.arange(32 << 20) % 251).astype(np.uint8)
        back = np.zeros(32 << 20, dtype=np.uint8)
        fut = server.arecv(back, 0x8, MASK)
        await server.asend(ep, data, 0x7)
        assert await fut == (0x8, 32 << 20)
        np.testing.assert_array_equal(back, data)
        p.join(120)
        assert p.exitcode == 0
    finally:
        if p.is_alive():
            p.kill()
            p.join()
        await server.aclose()
