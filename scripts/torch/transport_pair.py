"""Paired times of the transport's in-process device send: the headline (a
1 MiB pingpong through ``asend``/``arecv``, host <-> cuda:0 on one card,
against the raw copy) and the in-process sweep of ``chip_smoke.py``'s
transport phase (host <-> cuda:0 and cuda:0 <-> cuda:0, 4 KiB-64 MiB, the
phase's passes at each size), on the Python engine's ``inproc``
connection.  Only the public entry points are called
(``headline.run``, ``headline.pingpong``, ``headline.summary``), so the
script times whichever tree's package it is pointed at:

    python scripts/torch/transport_pair.py --tree .           # one JSON line
    python scripts/torch/transport_pair.py --against PARENT --repeats 5
    python scripts/torch/transport_pair.py --steps            # the split

``--against`` runs this tree and the tree at PARENT (a checkout of the
parent commit, e.g. ``git archive`` unpacked under the ignored
``build/``) in alternating processes, ABBA order (parent, this, this,
parent, ...), ``--repeats`` times each, on one card, and prints every
run's line and then the medians of each tree: the pingpong is host-bound
and spreads from run to run, so only an interleaved pair compares.

``--steps`` splits this tree's 1 MiB host <-> cuda:0 round trip into its
parts by the host clock, medians in microseconds a round trip: the two
``arecv`` posts, each ``asend`` call (in process the delivery runs inside
it) and each ``await``; inside the sends, the events recorded at the
posts, each copy's enqueue and each wait for a copy's event.  It also
times the host calls a transfer makes, alone, and the copy between the
card and a pageable host buffer by route, both ways, 4 KiB-64 MiB: one
copy straight into or out of it, a pooled pinned bounce with a host
memcpy, and the raw copy.  Needs a CUDA card;
``--device cpu`` rehearses every mode on CPU tensors, whose times mean
nothing.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# chip_smoke.py's sweep: sizes and (warmup, timed) passes
SWEEP_SIZES = [4 << 10, 64 << 10, 1 << 20, 4 << 20, 16 << 20, 64 << 20]


def sweep_iters(nbytes: int) -> tuple:
    if nbytes <= 1 << 20:
        return 5, 30
    return (2, 10) if nbytes <= 16 << 20 else (1, 5)


def _inproc() -> None:
    os.environ["STARWAY_TLS"] = "inproc,sm,tcp"
    os.environ["STARWAY_NATIVE"] = "0"
    os.environ["STARWAY_DEVPULL"] = "0"


def _card(device: str) -> str:
    if device == "cpu":
        return "cpu (a rehearsal)"
    from starway_tpu_torch.utils.cuda_timing import card_name

    return card_name()


def measure(tree: str, device: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    _inproc()
    import torch

    from starway_tpu_torch import headline

    dev = torch.device("cuda:0" if device == "cuda" else "cpu")
    rows = []
    summary = headline.summary

    def kept(fw, raw, nbytes):
        row = summary(fw, raw, nbytes)
        rows.append(row)
        return row

    headline.summary = kept
    head = asyncio.run(headline.run(device))
    headline.summary = summary
    out = {"card": _card(device), "headline": {
        "value": head["value"], "vs_baseline": head["vs_baseline"],
        "fw_p50_us": rows[-1]["fw_p50_us"], "fw_p99_us": rows[-1]["fw_p99_us"],
        "raw_p50_us": rows[-1]["raw_p50_us"]}}

    async def sweep():
        server, client, ep = await headline.connect_pair()
        try:
            for nbytes in SWEEP_SIZES:
                warm, iters = sweep_iters(nbytes)
                for host in (False, True):
                    fw, raw = await headline.pingpong(
                        server, client, ep, nbytes, dev, dev, host, warm,
                        iters, seed=nbytes)
                    mode = "host" if host else "device"
                    out[f"{mode}_{nbytes}"] = summary(fw, raw, nbytes)
        finally:
            await client.aclose()
            await server.aclose()

    asyncio.run(sweep())
    return out


class _Clock:
    """Host seconds spent in wrapped callables, by label, with the label
    of the enclosing step prefixed to the copies and waits inside it."""

    def __init__(self):
        self.total = defaultdict(float)
        self.step = ""

    def wrap(self, owner, name: str, label: str, step: bool = False):
        inner = getattr(owner, name)

        def timed(*args, **kwargs):
            outer = self.step
            if step:
                self.step = label
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                key = label if step else f"{self.step or 'other'}.{label}"
                self.total[key] += time.perf_counter() - t0
                self.step = outer

        setattr(owner, name, timed)


async def _split(dev, nbytes: int, warmup: int, iters: int) -> dict:
    import numpy as np
    import torch

    from starway_tpu_torch import DeviceBuffer, device, headline

    clock = _Clock()
    clock.wrap(device, "_posted_event", "event")
    clock.wrap(device, "_copy", "enqueue")
    clock.wrap(torch.cuda.Event, "synchronize", "wait")
    clock.wrap(device.DeviceRecvSink, "accept_host", "h2d", step=True)
    clock.wrap(device.DevicePayload, "copy_into", "d2h", step=True)
    server, client, ep = await headline.connect_pair()
    data = np.random.default_rng(0).integers(0, 256, nbytes, dtype=np.uint8)
    sink = DeviceBuffer((nbytes,), torch.uint8, device=dev)
    ret = np.empty(nbytes, dtype=np.uint8)
    parts = defaultdict(list)
    try:
        for i in range(warmup + iters):
            clock.total.clear()
            t = [time.perf_counter()]
            srv = server.arecv(sink, 0x51, headline.MASK)
            cli = client.arecv(ret, 0x52, headline.MASK)
            t.append(time.perf_counter())
            sent = client.asend(data, 0x51)
            t.append(time.perf_counter())
            await sent
            await srv
            t.append(time.perf_counter())
            back = server.asend(ep, sink, 0x52)
            t.append(time.perf_counter())
            await back
            await cli
            t.append(time.perf_counter())
            if i < warmup:
                continue
            for name, a, b in (("post_both", 0, 1), ("asend_ping", 1, 2),
                               ("await_ping", 2, 3), ("asend_pong", 3, 4),
                               ("await_pong", 4, 5), ("round_trip", 0, 5)):
                parts[name].append(t[b] - t[a])
            for key, sec in clock.total.items():
                parts[key].append(sec)
        if not np.array_equal(ret, data):
            raise AssertionError("the split's pingpong brought back other "
                                 "bytes")
    finally:
        await client.aclose()
        await server.aclose()
    return {k: statistics.median(v) * 1e6 for k, v in sorted(parts.items())}


ROUTE_SIZES = [4 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20,
               64 << 20]


def _routes(dev, sizes, trials: int, iters: int) -> dict:
    """Median us of one copy between the card and a pageable host buffer
    of each size, by route: ``straight`` (one copy on the side stream
    straight into or out of the pageable buffer), ``bounce`` (through a
    pooled pinned buffer and a host memcpy) and ``raw`` (``Tensor.to``,
    the headline's yardstick), both ways.  The routes alternate within
    each trial, in a rotated order; each trial's median is kept, and the
    medians of the trials are reported with their spread."""
    import numpy as np
    import torch

    from starway_tpu_torch import device

    def sync(event=None):
        if event is not None:
            event.synchronize()
        elif dev.type == "cuda":
            torch.cuda.synchronize()

    pinned = dev.type == "cuda"
    out = {}
    for nbytes in sizes:
        src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        host = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                      dtype=np.uint8)
        back = np.empty(nbytes, dtype=np.uint8)
        hview, bview = memoryview(host), memoryview(back)

        def d2h_straight():
            sync(device._copy(device._host_bytes(bview, nbytes), src, "tx"))

        def d2h_bounce():
            buf = device._staging_pool.get(nbytes, pinned=pinned)
            sync(device._copy(buf, src, "tx"))
            bview[:nbytes] = memoryview(buf.numpy())
            device._staging_pool.put(buf)

        def d2h_raw():
            src.to("cpu", copy=True)
            sync()

        def h2d_straight():
            sync(device._copy(dst, device._host_bytes(hview, nbytes), "rx"))

        def h2d_bounce():
            buf = device._staging_pool.get(nbytes, pinned=pinned)
            memoryview(buf.numpy())[:nbytes] = hview
            event = device._copy(dst, buf, "rx")
            device._staging_pool.put(buf, event)
            sync(event)

        def h2d_raw():
            torch.from_numpy(host).to(dev, copy=True)
            sync()

        routes = (("d2h_straight", d2h_straight), ("d2h_bounce", d2h_bounce),
                  ("d2h_raw", d2h_raw), ("h2d_straight", h2d_straight),
                  ("h2d_bounce", h2d_bounce), ("h2d_raw", h2d_raw))
        per = {name: [] for name, _ in routes}
        n = max(3, iters if nbytes <= 1 << 20 else iters // 8)
        for trial in range(trials):
            k = trial % len(routes)
            for name, fn in routes[k:] + routes[:k]:
                times = []
                for i in range(n + 3):
                    t0 = time.perf_counter()
                    fn()
                    if i >= 3:
                        times.append(time.perf_counter() - t0)
                per[name].append(statistics.median(times) * 1e6)
        if not (np.array_equal(back, src.cpu().numpy())
                and np.array_equal(dst.cpu().numpy(), host)):
            raise AssertionError(f"a route copied other bytes at {nbytes} B")
        out[str(nbytes)] = {name: {"median": statistics.median(v),
                                   "min": min(v), "max": max(v)}
                            for name, v in per.items()}
    return out


def _primitives(dev, iters: int) -> dict:
    """Median us of each host call a transfer of the device plane makes,
    alone: an event created and recorded, a wait on a completed event, a
    stream query, entering and leaving a side stream, ``record_stream``,
    a 4 KiB copy's enqueue, a CPU tensor aliasing a host buffer."""
    import numpy as np
    import torch

    from starway_tpu_torch import device

    if dev.type != "cuda":
        return {}
    side = device._side_stream(dev, "rx")
    a = torch.empty(4096, dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)
    done = torch.cuda.Event()
    done.record(side)
    done.synchronize()
    view = memoryview(np.empty(1 << 20, dtype=np.uint8))

    def record():
        torch.cuda.Event().record(torch.cuda.current_stream(dev))

    def enter_side():
        with torch.cuda.stream(side):
            pass

    def enqueue():
        with torch.cuda.stream(side):
            b.copy_(a, non_blocking=True)

    calls = (("event_record", record), ("event_wait_done", done.synchronize),
             ("stream_query",
              lambda: torch.cuda.current_stream(dev).query()),
             ("posted_event", lambda: device._posted_event(a)),
             ("enter_side_stream", enter_side),
             ("record_stream", lambda: a.record_stream(side)),
             ("copy_4KiB_enqueue", enqueue),
             ("host_alias_1MiB", lambda: device._host_bytes(view, 1 << 20)))
    out = {}
    for name, fn in calls:
        times = []
        for i in range(iters + 20):
            t0 = time.perf_counter()
            fn()
            if i >= 20:
                times.append(time.perf_counter() - t0)
        out[name] = statistics.median(times) * 1e6
    torch.cuda.synchronize()
    return out


def steps(iters: int, device: str) -> dict:
    sys.path.insert(0, HERE)
    _inproc()
    import torch

    dev = torch.device("cuda:0" if device == "cuda" else "cpu")
    out = {"card": _card(device),
           "split_1MiB_us": asyncio.run(_split(dev, 1 << 20, 10, iters)),
           "primitives_us": _primitives(dev, iters)}
    out["routes_us"] = _routes(dev, ROUTE_SIZES, 5, iters // 4)
    return out


def alternate(parent: str, repeats: int, device: str) -> int:
    runs = {"parent": [], "this": []}
    order = []
    for i in range(repeats):
        order += ["parent", "this"] if i % 2 == 0 else ["this", "parent"]
    for label in order:
        tree = parent if label == "parent" else HERE
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree, "--device", device],
                           capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-2000:], r.stderr[-3000:], file=sys.stderr)
            return r.returncode
        line = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": label, **line}), flush=True)
        runs[label].append(line)
    summary = {}
    for label, rs in runs.items():
        summary[label] = {
            row: {key: statistics.median(r[row][key] for r in rs)
                  for key in rs[0][row] if key != "mode"}
            for row in rs[0] if row != "card"}
    print(json.dumps({"medians": summary, "repeats": repeats,
                      "card": runs["this"][0]["card"]}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="time this tree's package, one JSON line")
    ap.add_argument("--against", default=None,
                    help="a parent tree: alternate it with this one")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--steps", action="store_true",
                    help="split this tree's 1 MiB round trip into its parts")
    ap.add_argument("--iters", type=int, default=200,
                    help="timed round trips of --steps")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal on CPU tensors")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("transport_pair: no CUDA device; it times the transport on "
              "the card", file=sys.stderr)
        return 2
    if args.against:
        return alternate(args.against, args.repeats, args.device)
    if args.steps:
        print(json.dumps(steps(args.iters, args.device)), flush=True)
        return 0
    print(json.dumps(measure(args.tree or ".", args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
