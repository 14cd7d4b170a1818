"""``redistribute()`` on the card: a local retile over 8 slots of one
card, and two ranks of one process over tcp on both engines, via device
payloads that ride the pull's process-wide route.

Every test here needs an NVIDIA GPU: each carries the ``cuda`` marker and
skips without a card.  Run them on a GPU machine with

    STARWAY_TEST_REAL_TPU=1 python -m pytest -m cuda tests/test_torch_reshard_cuda.py

(the variable keeps tests/conftest.py from importing jax)."""

import asyncio

import pytest
import torch

from starway_tpu_torch import Client, Server
from starway_tpu_torch.parallel.dp_exchange import ServerPort
from starway_tpu_torch.reshard import (ArrayRef, ShardedTensor, SlotMesh,
                                       SlotSharding, lease, redistribute)

pytestmark = [pytest.mark.cuda, pytest.mark.asyncio]

ADDR = "127.0.0.1"


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the shards live on the card")
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    return torch.device("cuda:0")


def _source(shape, dev) -> torch.Tensor:
    gen = torch.Generator().manual_seed(3)
    return torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)


def _check(res, sharding, full) -> None:
    boxes = sharding.indices_map(full.shape)
    assert res.shards and set(res.shards) <= set(sharding.slots)
    for slot, t in res.shards.items():
        want = full[tuple(slice(lo, hi) for lo, hi in boxes[slot])]
        assert t.device == slot.device
        assert torch.equal(t.view(torch.int16),
                           want.contiguous().view(torch.int16))


async def test_local_retile_on_the_card(dev):
    full = _source((1024, 512), dev)
    mesh = SlotMesh({"x": 8}, devices=dev)
    dst = SlotSharding(mesh, (None, "x"))
    res = await redistribute(
        ShardedTensor.from_tensor(full, SlotSharding(mesh, ("x", None))),
        dst, via="device")
    _check(res, dst, full)
    assert res.stats["tx_bytes"] == 0


@pytest.mark.parametrize("native", ["0", "1"], ids=["python", "native"])
async def test_two_ranks_via_device_on_the_card(port, dev, monkeypatch,
                                                native):
    monkeypatch.setenv("STARWAY_NATIVE", native)
    monkeypatch.setenv("STARWAY_DEVPULL_MIN", "1")
    full = _source((1024, 512), dev)
    src = SlotSharding(SlotMesh({"x": 4}, devices=dev, ranks=0), ("x", None))
    dst = SlotSharding(SlotMesh({"x": 4}, devices=dev, ranks=1), (None, "x"))
    server = Server()
    server.listen(ADDR, port)
    client = Client()
    try:
        await asyncio.wait_for(client.aconnect(ADDR, port), 30)
        with lease() as L:
            _, res1 = await asyncio.gather(
                redistribute(ShardedTensor.from_tensor(full, src), None,
                             {1: client}, rank=0, lease=L, via="device"),
                redistribute(ArrayRef(full.shape, torch.bfloat16), dst,
                             {0: ServerPort(server)}, rank=1, lease=L,
                             via="device"))
        _check(res1, dst, full)
        mgr = server._server.transfer_manager()
        assert mgr.counts["pulled_local"] == res1.stats["rounds"] == 4
    finally:
        await client.aclose()
        await server.aclose()
