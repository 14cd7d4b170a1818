"""Measure the five configurations of ``BASELINE.json`` on the port's
transport and device plane, and print the markdown table of
``BASELINE.md``.

The port's twin of ``scripts/collect_baseline.py``: the same five
configurations, each through ``starway_tpu_torch`` with its tensors on
the card (``cuda:0`` by default):

1. a pingpong sweep of 4 B - 1 MiB over loopback, a device tensor sent
   into a ``DeviceBuffer``;
2. eight clients fanning in to one server by tag (1 KiB messages);
3. the worker-address bootstrap (``aconnect_address``);
4. a 1 GiB all-to-all shuffle over an 8-slot mesh axis
   (``parallel.make_shuffle``; the eight slots on the one device);
5. a Llama gradient tree moved across the DP boundary
   (``send_pytree`` / ``recv_pytree``).

It writes no file.  Without a card it refuses, unless asked for the CPU
(``--device cpu``, or ``REHEARSAL=1``).  ``--quick`` cuts the iteration
counts and the shuffle to 64 MiB (the check that every configuration
runs; its figures are not the baseline's).

    python scripts/torch/collect_baseline.py [--device cuda:0] [--quick]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch

MASK = (1 << 64) - 1


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


async def _pair():
    from starway_tpu_torch import Client, Server

    server = Server()
    server.listen("127.0.0.1", 0)
    client = Client()
    await client.aconnect_address(server.get_worker_address())
    for _ in range(200):
        if server.list_clients():
            return server, client, server.list_clients().pop()
        await asyncio.sleep(0.005)
    raise RuntimeError("the server saw no client")


async def config1_pingpong_sweep(dev, iters: int) -> tuple:
    """Pingpong 4 B - 1 MiB over loopback, device tensors both ways."""
    from starway_tpu_torch import DeviceBuffer

    server, client, ep = await _pair()
    out = []
    for size in (4, 1024, 64 * 1024, 1 << 20):
        buf = torch.full((size,), 0xA5, dtype=torch.uint8, device=dev)
        sink = DeviceBuffer((size,), torch.uint8, device=dev)
        back = DeviceBuffer((size,), torch.uint8, device=dev)
        warm = max(iters // 6, 1)
        rtts = []
        for i in range(iters + warm):
            t0 = time.perf_counter()
            f = server.arecv(sink, 1, MASK)
            await client.asend(buf, 1)
            await f
            f2 = client.arecv(back, 2, MASK)
            await server.asend(ep, sink.array, 2)
            await f2
            if i >= warm:
                rtts.append(time.perf_counter() - t0)
        if not torch.equal(back.array, buf):
            raise AssertionError(f"{size} B: the pingpong changed the bytes")
        p50 = statistics.median(rtts)
        out.append(f"{size}B: rtt_p50={p50 * 1e6:.0f}us "
                   f"({2 * size / p50 / 1e9:.2f} GB/s)")
    await client.aclose()
    await server.aclose()
    return ("config 1: pingpong sweep 4B-1MB (loopback, inproc, "
            f"{dev.type} tensors)", "; ".join(out))


async def config2_fanin(dev, n_msgs: int) -> tuple:
    """One server, eight clients, tag-routed fan-in of 1 KiB messages."""
    from starway_tpu_torch import Client, DeviceBuffer, Server

    server = Server()
    server.listen("127.0.0.1", 0)
    addr = server.get_worker_address()
    clients = []
    for _ in range(8):
        c = Client()
        await c.aconnect_address(addr)
        clients.append(c)
    payloads = [torch.full((1024,), i, dtype=torch.uint8, device=dev)
                for i in range(8)]
    sinks = [DeviceBuffer((1024,), torch.uint8, device=dev)
             for _ in range(8)]
    t0 = time.perf_counter()
    for _ in range(n_msgs):
        recvs = [server.arecv(sinks[i], i, MASK) for i in range(8)]
        sends = [c.asend(payloads[i], i) for i, c in enumerate(clients)]
        await asyncio.gather(*sends, *recvs)
    dt = time.perf_counter() - t0
    if not all(torch.equal(s.array, p) for s, p in zip(sinks, payloads)):
        raise AssertionError("a message reached another tag's sink")
    total = 8 * n_msgs
    for c in clients:
        await c.aclose()
    await server.aclose()
    return ("config 2: 8-client tag-matched fan-in (1KiB msgs)",
            f"{total / dt:.0f} msgs/s, {total * 1024 / dt / 1e6:.1f} MB/s")


async def config3_worker_address(n: int) -> tuple:
    """Worker-address bootstrap latency."""
    from starway_tpu_torch import Client, Server

    times = []
    for _ in range(n):
        server = Server()
        blob = server.listen_address()
        t0 = time.perf_counter()
        client = Client()
        await client.aconnect_address(blob)
        times.append(time.perf_counter() - t0)
        await client.aclose()
        await server.aclose()
    return ("config 3: worker-address bootstrap (aconnect_address)",
            f"connect p50 = {statistics.median(times) * 1e3:.2f} ms")


def config4_shuffle(dev, total_bytes: int, iters: int) -> tuple:
    """An all-to-all shuffle of ``total_bytes`` of float32 over an 8-slot
    mesh axis, every slot on ``dev``."""
    from starway_tpu_torch.parallel import make_mesh, make_shuffle
    from starway_tpu_torch.parallel.sharding import local_shards, shard_array

    mesh = make_mesh({"x": 8}, device=dev)
    s, b = 64, 16
    d = total_bytes // 4 // (s * b)
    x = torch.arange(s * b * d, dtype=torch.float32).reshape(s, b, d)
    shards = local_shards(shard_array(mesh, x, "x"))
    del x
    shuffle = make_shuffle(mesh, "x")
    out = shuffle(shards)
    _sync(dev)
    want = torch.arange(s * b * d, dtype=torch.float32).reshape(
        s, b, d)[:, :b // 8]
    if not torch.equal(out[0].cpu(), want):
        raise AssertionError("the shuffle's first block is not the tensor's")
    del out, want
    t0 = time.perf_counter()
    for _ in range(iters):
        shuffle(shards)
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    nbytes = s * b * d * 4
    return (f"config 4: {nbytes / 2 ** 30:.2f}GiB all-to-all shuffle (8-slot "
            f"mesh on {dev}, collectives.all_to_all)",
            f"{nbytes / 1e9:.2f} GB in {dt * 1e3:.0f} ms = "
            f"{nbytes / dt / 1e9:.2f} GB/s")


async def config5_dp_exchange(dev, iters: int) -> tuple:
    """A Llama gradient tree moved across the DP boundary."""
    from starway_tpu_torch.models import LlamaConfig, init_params
    from starway_tpu_torch.parallel import (ClientPort, ServerPort,
                                            recv_pytree, send_pytree)
    from starway_tpu_torch.utils.tree import tree_leaves

    cfg = LlamaConfig.preset("debug", n_layers=4, d_model=512, d_ff=1024)
    params = init_params(cfg, seed=0, device=dev)
    leaves = tree_leaves(params)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    server, client, _ep = await _pair()
    got = None
    t0 = time.perf_counter()
    for _ in range(iters):
        send = asyncio.ensure_future(send_pytree(ClientPort(client), params,
                                                 base_tag=0x8000))
        got = await recv_pytree(ServerPort(server), like=params,
                                base_tag=0x8000)
        await send
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(got), leaves)):
        raise AssertionError("the received tree differs from the sent one")
    await client.aclose()
    await server.aclose()
    return (f"config 5: Llama grad pytree DP transfer ({nbytes / 1e6:.0f} "
            f"MB, {len(leaves)} leaves)",
            f"{dt * 1e3:.0f} ms/transfer = {nbytes / dt / 1e9:.2f} GB/s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0",
                    help="where the tensors live (default cuda:0; cpu runs "
                         "without a card)")
    ap.add_argument("--quick", action="store_true",
                    help="short runs and a 64 MiB shuffle")
    ap.add_argument("--json", action="store_true",
                    help="also print the table as one JSON row "
                         "(metric baseline_configs; scripts/torch/"
                         "onchip_refresh.sh records it)")
    args = ap.parse_args(argv)
    if os.environ.get("REHEARSAL") == "1":
        args.device, args.quick = "cpu", True
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("collect_baseline: no CUDA device; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    q = args.quick
    rows = [asyncio.run(config1_pingpong_sweep(dev, 30 if q else 250)),
            asyncio.run(config2_fanin(dev, 20 if q else 200)),
            asyncio.run(config3_worker_address(3 if q else 10)),
            config4_shuffle(dev, (64 << 20) if q else (1 << 30), 3),
            asyncio.run(config5_dp_exchange(dev, 2 if q else 5))]
    print("\n| Config | Measured |")
    print("|---|---|")
    for name, val in rows:
        print(f"| {name} | {val} |")
    if args.json:
        card = "cpu"
        if dev.type == "cuda":
            from starway_tpu_torch.utils.cuda_timing import card_name

            card = card_name()
        print(json.dumps({"metric": "baseline_configs", "value": len(rows),
                          "unit": "configs", "quick": q, "card": card,
                          "device": str(dev),
                          "configs": {name: val for name, val in rows}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
