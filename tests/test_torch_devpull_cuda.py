"""The port's device pull on the card: CUDA IPC between processes, and the
process-wide route between two workers of one process.

Every test here needs an NVIDIA GPU: each carries the ``cuda`` marker and
skips without a card.  Run them on a GPU machine with

    STARWAY_TEST_REAL_TPU=1 python -m pytest -m cuda tests/test_torch_devpull_cuda.py

(the variable keeps tests/conftest.py from importing jax).  The peers are
``spawn``ed children over tcp on the Python engine, on the same card, and
once both sides on the C++ engine."""

import asyncio
import gc
import multiprocessing
import os

import pytest
import torch

from starway_tpu_torch import Client, DeviceBuffer, Server

pytestmark = [pytest.mark.cuda, pytest.mark.asyncio]

ADDR = "127.0.0.1"
MASK = (1 << 64) - 1
N = 4 << 20
BYE = 0xC9


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA IPC opens a card's memory")
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    return torch.device("cuda:0")


def _pattern(n: int, dev, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n,), dtype=torch.uint8,
                         generator=gen).to(dev)


def _bf16(dev) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1)
    return torch.randn(512, 1000, generator=gen).to(torch.bfloat16).to(dev)


def _mgr(worker):
    inner = getattr(worker, "_client", None) or worker._server
    return inner.transfer_manager()


async def _connect(port) -> Client:
    for _ in range(240):
        client = Client()
        try:
            await client.aconnect(ADDR, port)
            return client
        except Exception:
            await asyncio.sleep(0.25)
    raise AssertionError("the peer never came up")


async def _wait_bye(recv) -> None:
    import numpy as np

    await recv(np.zeros(1, dtype=np.uint8), BYE, MASK)


def _child(port: int, mode: str, q, native: str = "0") -> None:
    """A spawned peer on cuda:0 over tcp (the Python engine unless
    ``native`` is "1").

    * ``send``: connects; sends the pattern (then overwrites it at once)
      and a bf16 tensor; receives the pattern back, checks it arrived by
      the pull, and reports; closes on the parent's bye.
    * ``flush-close``: connects, sends the pattern, flushes, closes and
      exits before the parent posts its receive.
    * ``truncate``: listens; its too-small receive of the parent's payload
      must fail "truncated", which it reports at once; closes on the bye.
    * ``idle``: listens, receives nothing; closes on the bye."""
    os.environ["STARWAY_TLS"] = "tcp"
    os.environ["STARWAY_NATIVE"] = native
    import numpy as np

    dev = torch.device("cuda:0")

    async def run():
        if mode in ("send", "flush-close"):
            client = await _connect(port)
            src = _pattern(N, dev)
            await client.asend(src, 0xB1)
            src.zero_()  # the send completed: the snapshot went instead
            if mode == "flush-close":
                await client.aflush()
                await client.aclose()
                return "ok"
            await client.asend(_bf16(dev), 0xB3)
            back = DeviceBuffer((N,), torch.uint8, device=dev)
            await client.arecv(back, 0xB2, MASK)
            ok = (torch.equal(back.array, _pattern(N, dev, seed=2))
                  and back.last_transport == "device"
                  and _mgr(client).counts["pulled_ipc"] == 1)
            await _wait_bye(client.arecv)
            await client.aclose()
            return "ok" if ok else f"bad receive {back.last_transport}"
        server = Server()
        server.listen(ADDR, port)
        q.put("listening")
        for _ in range(4000):
            if server.list_clients():
                break
            await asyncio.sleep(0.005)
        if mode == "truncate":
            try:
                await server.arecv(np.zeros(1024, dtype=np.uint8), 0xC1,
                                   MASK)
                q.put("the too-small receive succeeded")
            except Exception as e:  # noqa: BLE001
                q.put("ok" if "runcat" in str(e) else str(e))
        await _wait_bye(server.arecv)
        await server.aclose()
        return "closed"

    q.put(asyncio.run(run()))


def _spawn(port, mode, native="0"):
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_child, args=(port, mode, q, native),
                    daemon=True)
    p.start()
    return p, q


async def _get(q, timeout=120):
    return await asyncio.get_running_loop().run_in_executor(
        None, lambda: q.get(timeout=timeout))


def _finish(p):
    p.join(60)
    if p.is_alive():
        p.kill()
        p.join()


async def test_ipc_pull_both_ways_with_a_spawned_child(port, dev):
    """The child's payload reaches the parent by a CUDA IPC pull, whole
    although the child overwrote its tensor right after the send
    completed; a bf16 tensor lands bit for bit; the parent's payload
    reaches the child the same way."""
    await _pull_both_ways(port, dev, "0")


async def test_ipc_pull_both_ways_on_the_cpp_engine(port, dev,
                                                    monkeypatch):
    """The same with both sides on the C++ engine, whose copy negotiates
    "cudaipc": every payload is pulled over CUDA IPC."""
    monkeypatch.setenv("STARWAY_NATIVE", "1")
    await _pull_both_ways(port, dev, "1")


async def _pull_both_ways(port, dev, native: str):
    server = Server()
    server.listen(ADDR, port)
    p, q = _spawn(port, "send", native)
    try:
        sink = DeviceBuffer((N,), torch.uint8, device=dev)
        assert await asyncio.wait_for(server.arecv(sink, 0xB1, MASK),
                                      120) == (0xB1, N)
        assert torch.equal(sink.array, _pattern(N, dev))
        assert sink.last_transport == "device"
        want = _bf16(dev)
        bsink = DeviceBuffer.like(want)
        assert await server.arecv(bsink, 0xB3, MASK) == (0xB3, want.numel() * 2)
        assert torch.equal(bsink.array, want)
        assert _mgr(server).counts["pulled_ipc"] == 2
        ep = server.list_clients().pop()
        await server.asend(ep, _pattern(N, dev, seed=2), 0xB2)
        assert _mgr(server).counts["offered_ipc"] == 1
        await server.asend(ep, torch.ones(1, dtype=torch.uint8).numpy(), BYE)
        await server.aflush()
        assert await _get(q) == "ok"
    finally:
        await server.aclose()
        _finish(p)


async def test_ipc_flush_close_exit(port, dev):
    """The sender flushes, closes and exits before the receive is posted:
    the FLUSH barrier pulled the payload first, so it is delivered."""
    server = Server()
    server.listen(ADDR, port)
    p, q = _spawn(port, "flush-close")
    try:
        assert await _get(q) == "ok"
        await asyncio.get_running_loop().run_in_executor(None, p.join, 60)
        assert p.exitcode == 0
        sink = DeviceBuffer((N,), torch.uint8, device=dev)
        assert await asyncio.wait_for(server.arecv(sink, 0xB1, MASK),
                                      10) == (0xB1, N)
        assert torch.equal(sink.array, _pattern(N, dev))
        assert sink.last_transport == "device"
    finally:
        await server.aclose()
        _finish(p)


@pytest.mark.parametrize("mode", ["truncate", "idle"])
async def test_sender_memory_returns_to_baseline(port, dev, mode):
    """After a truncated receive (which drain-pulls) or a close with an
    unpulled offer (which revokes it), the sender's allocated memory is
    back at its baseline once ipc_collect() has run."""
    p, q = _spawn(port, mode)
    try:
        assert await _get(q) == "listening"
        client = await _connect(port)
        src = _pattern(N, dev)
        gc.collect()
        torch.cuda.ipc_collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        await client.asend(src, 0xC1)
        assert _mgr(client).counts["offered_ipc"] == 1
        if mode == "truncate":
            await asyncio.wait_for(client.aflush(), 30)  # covers the drain
            assert await _get(q) == "ok"
        # no flush after the bye: a FLUSH barrier would pull the offer
        await client.asend(torch.ones(1, dtype=torch.uint8).numpy(), BYE)
        await asyncio.sleep(0.2)
        await client.aclose()
        gc.collect()
        torch.cuda.ipc_collect()
        assert torch.cuda.memory_allocated(dev) == base
    finally:
        _finish(p)


async def test_local_route_between_two_workers_on_the_card(port, dev):
    """Two workers of one process over tcp: the process-wide route hands
    the snapshot over on the card; the sender may overwrite its tensor
    once the send completed."""
    server = Server()
    client = Client()
    server.listen(ADDR, port)
    await client.aconnect(ADDR, port)
    try:
        src = _pattern(N, dev, seed=4)
        want = src.clone()
        sink = DeviceBuffer((N,), torch.uint8, device=dev)
        await client.asend(src, 0xD1)
        src.zero_()
        assert await server.arecv(sink, 0xD1, MASK) == (0xD1, N)
        assert torch.equal(sink.array, want)
        assert sink.last_transport == "device"
        assert _mgr(server).counts["pulled_local"] == 1
    finally:
        await client.aclose()
        await server.aclose()
