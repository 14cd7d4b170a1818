"""Headline: a 1 MiB device-buffer pingpong through asend/arecv.

    python -m starway_tpu_torch.headline

The twin of the JAX package's root ``bench.py``: the pingpong bandwidth of a
1 MiB payload moved through the framework's ``asend``/``arecv`` path,
against the raw copy the same hardware does without the framework.
``vs_baseline`` is ``framework_gbps / (0.9 * raw_gbps)``: >= 1.0 means the
north-star target (>= 90% of the raw link bandwidth on a 1 MiB pingpong)
is met.  It prints one JSON line with bench.py's keys.

With two cards the pingpong crosses them (``cuda:0`` <-> ``cuda:1``); with
one it is a host <-> ``cuda:0`` round trip; with none it runs on CPU
tensors and says ``"fallback": true``.  The raw copy is ``Tensor.to(dst)``
followed by ``torch.cuda.synchronize()``.

Framework and raw iterations are interleaved (one of each per pass):
allocator and cache state drift between separate phases, so measuring
them back to back is the only way the ratio reflects the framework rather
than the phase.
"""

from __future__ import annotations

import asyncio
import json
import os
import statistics
import time

import numpy as np
import torch

MSG_BYTES = 1 << 20
WARMUP = 10
ITERS = 50
MASK = (1 << 64) - 1
PING, PONG = 0x51, 0x52


async def connect_pair():
    """A listening Server and a Client connected to it through its worker
    address; returns (server, client, endpoint).  The connection is
    in-process unless STARWAY_TLS leaves ``inproc`` out."""
    from . import Client, Server

    server = Server()
    client = Client()
    server.listen("127.0.0.1", 0)
    await client.aconnect_address(server.get_worker_address())
    for _ in range(400):
        if server.list_clients():
            break
        await asyncio.sleep(0.005)
    return server, client, server.list_clients().pop()


def _sync(*devices) -> None:
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


async def pingpong(server, client, ep, nbytes: int, src: torch.device,
                   dst: torch.device, host: bool, warmup: int = WARMUP,
                   iters: int = ITERS, seed: int = 0):
    """Interleaved framework/raw pingpong of ``nbytes``; returns the
    framework and raw round-trip seconds of the ``iters`` timed passes.

    ``host=False``: a tensor on ``src`` goes to a DeviceBuffer on ``dst``
    and the sink's tensor comes back into a DeviceBuffer on ``src``; raw is
    ``.to(dst)`` and back.  ``host=True``: a host buffer goes to a
    DeviceBuffer on ``dst`` and the sink comes back into a host buffer;
    raw is the host tensor ``.to(dst)`` and back to the host.  After the
    timed passes both buffers are cleared and one more pass must bring the
    payload back byte for byte, into the same memory."""
    from . import DeviceBuffer

    gen = torch.Generator().manual_seed(seed)
    data = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, generator=gen)
    sink = DeviceBuffer((nbytes,), torch.uint8, device=dst)
    if host:
        payload = data.numpy()
        ret = np.empty(nbytes, dtype=np.uint8)
        back_to = sink
    else:
        payload = data.to(src)
        ret = DeviceBuffer((nbytes,), torch.uint8, device=src)
        back_to = sink.array
    _sync(src, dst)

    async def fw_iter() -> float:
        t0 = time.perf_counter()
        srv_fut = server.arecv(sink, PING, MASK)
        cli_fut = client.arecv(ret, PONG, MASK)
        await client.asend(payload, PING)
        await srv_fut
        await server.asend(ep, back_to, PONG)
        await cli_fut
        return time.perf_counter() - t0

    def raw_iter() -> float:
        t0 = time.perf_counter()
        there = (data if host else payload).to(dst, copy=True)
        _sync(dst)
        there.to("cpu" if host else src, copy=True)
        _sync(src)
        return time.perf_counter() - t0

    fw, raw = [], []
    for i in range(warmup + iters):
        fw_dt = await fw_iter()
        raw_dt = raw_iter()
        if i >= warmup:
            fw.append(fw_dt)
            raw.append(raw_dt)

    sink_ptr = sink.array.data_ptr()
    sink.array.zero_()
    if host:
        ret[:] = 0
    else:
        ret_ptr = ret.array.data_ptr()
        ret.array.zero_()
    await fw_iter()
    got = torch.from_numpy(ret) if host else ret.array.cpu()
    if not (torch.equal(sink.array.cpu(), data) and torch.equal(got, data)):
        raise AssertionError(f"{nbytes} B pingpong: the bytes that came back "
                             f"differ from those sent")
    if sink.array.data_ptr() != sink_ptr or (
            not host and ret.array.data_ptr() != ret_ptr):
        raise AssertionError("a receive moved its DeviceBuffer's tensor")
    return fw, raw


def summary(fw: list, raw: list, nbytes: int) -> dict:
    """p50/p99 round trips in us, GB/s both ways and vs_baseline."""
    from .perf import percentile

    fw_p50, raw_p50 = statistics.median(fw), statistics.median(raw)
    fw_gbps = 2 * nbytes / fw_p50 / 1e9
    raw_gbps = 2 * nbytes / raw_p50 / 1e9
    return {
        "bytes": nbytes,
        "fw_p50_us": fw_p50 * 1e6,
        "fw_p99_us": percentile(sorted(fw), 99) * 1e6,
        "raw_p50_us": raw_p50 * 1e6,
        "fw_gbps": fw_gbps,
        "raw_gbps": raw_gbps,
        "vs_baseline": fw_gbps / (0.9 * raw_gbps),
    }


def active_levers() -> list:
    """The native engine's opt-in hot-path levers armed for this process
    by env, so a result row is self-describing."""
    levers = []
    if os.environ.get("STARWAY_IOURING") == "1":
        levers.append("uring")
    if os.environ.get("STARWAY_ZEROCOPY") == "1":
        levers.append("zerocopy")
    try:
        if int(os.environ.get("STARWAY_BUSYPOLL_US", "0")) > 0:
            levers.append(f"busypoll:{int(os.environ['STARWAY_BUSYPOLL_US'])}")
    except ValueError:
        pass
    return levers


def stage_summary() -> str:
    """Average us per recorded sample of each stage (stage = D2H, tx, rx,
    place = H2D), over the process since the last reset."""
    from . import perf

    snap = perf.stage_snapshot()
    parts = []
    for name in ("stage", "tx", "rx", "place"):
        s = snap.get(name)
        if s and s["count"]:
            parts.append(f"{name}:{s['seconds'] / s['count'] * 1e6:.0f}us")
    return ",".join(parts) if parts else "none"


async def run() -> dict:
    """The headline pingpong on the devices at hand; returns the JSON
    object ``main`` prints."""
    from . import perf
    from .core import swtrace

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    fallback = n_cards == 0
    if n_cards >= 2:
        src, dst, host = torch.device("cuda:0"), torch.device("cuda:1"), False
    else:
        src = dst = torch.device("cuda:0" if n_cards else "cpu")
        host = True
    server, client, ep = await connect_pair()
    try:
        perf.stage_reset()
        fw, raw = await pingpong(server, client, ep, MSG_BYTES, src, dst, host)
        pulse = swtrace.hist_summary(client._client.hists_snapshot())
    finally:
        await client.aclose()
        await server.aclose()
    s = summary(fw, raw, MSG_BYTES)
    fw_sorted = sorted(fw)
    where = "device-to-device" if not host else "host-to-device"
    return {
        "metric": "1MiB torch.Tensor pingpong bandwidth via asend/arecv "
                  f"({where}, {max(n_cards, 1)} dev "
                  f"{dst if not fallback else 'cpu'}, p50 of {len(fw)} "
                  f"interleaved iters; raw={s['raw_gbps']:.2f}GB/s "
                  f"p10/p50/p90_rtt={perf.percentile(fw_sorted, 10) * 1e6:.0f}/"
                  f"{s['fw_p50_us']:.0f}/"
                  f"{perf.percentile(fw_sorted, 90) * 1e6:.0f}us "
                  f"stages={stage_summary()}"
                  f"{'; CPU FALLBACK: no CUDA device' if fallback else ''})",
        "value": round(s["fw_gbps"], 3),
        "unit": "GB/s",
        "vs_baseline": round(s["vs_baseline"], 3),
        "fallback": fallback,
        "levers": active_levers(),
        "hists": pulse,
    }


def main() -> None:
    print(json.dumps(asyncio.run(run())), flush=True)


if __name__ == "__main__":
    main()
