"""Benchmark scenarios.

Re-implements the reference's four-scenario suite (reference:
src/starway/benchmarks/scenarios.py, benchmark.md:48-102) with the same
names, default configs, and metric keys so results are comparable:

* ``large-array``     -- one-way bandwidth, single large buffer
* ``small-messages``  -- many small concurrent messages
* ``pingpong-flag``   -- 1-byte round-trip latency
* ``streaming-duplex``-- bidirectional medium-chunk streaming

Design differs from the reference (paired free functions) by making each
scenario a class with ``run_client`` / ``run_server`` coroutines; payloads may
be host numpy arrays (default) or ``torch.uint8`` tensors on the card
(``payload="device"``, on :data:`PAYLOAD_DEVICE`), the device plane's path.

Tag space (compatible with the reference constants):
control 0x1AA0-0x1AA2, data 0x2B00-0x2B31.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping

import numpy as np


def _encode_ctl(payload: Mapping[str, Any]) -> np.ndarray:
    raw = json.dumps(payload, separators=(",", ":"), sort_keys=True).encode()
    return np.frombuffer(raw, dtype=np.uint8).copy()


def _decode_ctl(buffer: np.ndarray, length: int) -> dict:
    return json.loads(bytes(memoryview(buffer)[:length]).decode())

TAG_MASK: int = (1 << 64) - 1

CONTROL_TAG = 0x1AA0
READY_TAG = 0x1AA1
DONE_TAG = 0x1AA2

LARGE_DATA_TAG = 0x2B00
SMALL_DATA_TAG = 0x2B10
SMALL_ACK_TAG = 0x2B11
FLAG_PING_TAG = 0x2B20
FLAG_PONG_TAG = 0x2B21
STREAM_UP_TAG = 0x2B30
STREAM_DOWN_TAG = 0x2B31
STRIPED_DATA_TAG = 0x2B40
FLOOD_DATA_TAG = 0x2B50
FLOOD_STATS_TAG = 0x2B51
RESHARD_STATS_TAG = 0x2B60
#: swshard schedules address their transfers inside the reserved
#: 0xE5<<56 namespace (reshard/tags.py); the scenario pins lease slot 11
#: on both roles -- the shared-coordinate contract.
RESHARD_LEASE_SLOT = 11


@dataclass
class ScenarioResult:
    """Metrics + optional per-iteration samples for one scenario run
    (reference: ScenarioResult, src/starway/benchmarks/scenarios.py:42-57)."""

    name: str
    metrics: Dict[str, float]
    samples: Dict[str, List[float]] = field(default_factory=dict)
    config: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self, include_samples: bool = True) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "metrics": self.metrics, "config": self.config}
        if include_samples:
            out["samples"] = self.samples
        return out


def _pct(values_us: np.ndarray, q: float) -> float:
    return float(np.percentile(values_us, q)) if len(values_us) else 0.0


#: Where ``payload="device"`` buffers live: ``cuda:0``, or the CPU only when
#: the caller asks for it (``python -m starway_tpu_torch.bench --device cpu``).
PAYLOAD_DEVICE = "cuda:0"


def _make_payload(size: int, fill: int, kind: str):
    """Host numpy buffer or a torch.uint8 tensor on PAYLOAD_DEVICE."""
    if kind == "device":
        import torch

        return torch.full((size,), fill % 256, dtype=torch.uint8,
                          device=PAYLOAD_DEVICE)
    return np.full(size, fill % 256, dtype=np.uint8)


def _make_sink(size: int, kind: str):
    if kind == "device":
        from ..device import DeviceBuffer

        return DeviceBuffer((size,), np.uint8, device=PAYLOAD_DEVICE)
    return np.empty(size, dtype=np.uint8)


class Scenario:
    """Base: a named scenario with defaults; subclasses implement the client
    (measuring) and server (echo/sink) coroutines."""

    name: str = ""
    description: str = ""
    defaults: Dict[str, Any] = {}

    def config(self, overrides: Mapping[str, Any]) -> Dict[str, Any]:
        cfg = dict(self.defaults)
        cfg.update({k: v for k, v in overrides.items() if v is not None})
        return cfg

    async def run_client(self, ctx, overrides: Mapping[str, Any]) -> ScenarioResult:
        raise NotImplementedError

    async def run_server(self, ctx, overrides: Mapping[str, Any]) -> None:
        raise NotImplementedError


class LargeArray(Scenario):
    name = "large-array"
    description = "Measure one-way bandwidth by transferring a single large buffer."
    defaults = {"message_bytes": 1 << 30, "warmup": 1, "iterations": 3, "payload": "host"}

    async def run_client(self, ctx, overrides) -> ScenarioResult:
        cfg = self.config(overrides)
        size, warmup, iters = int(cfg["message_bytes"]), int(cfg["warmup"]), int(cfg["iterations"])
        payload = _make_payload(size, 0x5A, cfg.get("payload", "host"))
        secs: list[float] = []
        gbps: list[float] = []
        for i in range(warmup + iters):
            t0 = time.perf_counter()
            await ctx.client.asend(payload, LARGE_DATA_TAG)
            await ctx.flush()
            dt = time.perf_counter() - t0
            if i >= warmup:
                secs.append(dt)
                if dt > 0:
                    gbps.append(size / dt / 1e9)
        total = sum(secs)
        return ScenarioResult(
            name=self.name,
            metrics={
                "total_seconds": total,
                "avg_seconds_per_iter": total / iters if iters else 0.0,
                "avg_gbps": (size * iters / total / 1e9) if total > 0 else 0.0,
                "best_gbps": max(gbps) if gbps else 0.0,
                "worst_gbps": min(gbps) if gbps else 0.0,
            },
            samples={"duration_seconds": secs, "per_iter_gbps": gbps},
            config=cfg,
        )

    async def run_server(self, ctx, overrides) -> None:
        cfg = self.config(overrides)
        size, total = int(cfg["message_bytes"]), int(cfg["warmup"]) + int(cfg["iterations"])
        sink = _make_sink(size, cfg.get("payload", "host"))
        await ctx.signal_ready()
        for _ in range(total):
            await ctx.server.arecv(sink, LARGE_DATA_TAG, ctx.tag_mask)
        await ctx.flush_endpoint()


class SmallMessages(Scenario):
    name = "small-messages"
    description = "Stress many small messages with configurable concurrency."
    defaults = {"message_bytes": 1024, "warmup_batches": 2, "iterations": 10, "concurrency": 64}

    async def run_client(self, ctx, overrides) -> ScenarioResult:
        cfg = self.config(overrides)
        size = int(cfg["message_bytes"])
        warmup, iters = int(cfg["warmup_batches"]), int(cfg["iterations"])
        conc = int(cfg["concurrency"])
        payloads = [np.full(size, i % 251, dtype=np.uint8) for i in range(conc)]
        batch_secs: list[float] = []
        per_msg: list[float] = []
        for b in range(warmup + iters):
            t0 = time.perf_counter()
            await asyncio.gather(*(ctx.client.asend(p, SMALL_DATA_TAG) for p in payloads))
            await ctx.flush()
            dt = time.perf_counter() - t0
            if b >= warmup:
                batch_secs.append(dt)
                if conc:
                    per_msg.append(dt / conc)
        total = sum(batch_secs)
        nmsg = iters * conc
        lat_us = np.asarray(per_msg) * 1e6
        return ScenarioResult(
            name=self.name,
            metrics={
                "total_seconds": total,
                "messages_per_second": nmsg / total if total > 0 else 0.0,
                "bandwidth_gbps": size * nmsg / total / 1e9 if total > 0 else 0.0,
                "latency_p50_us": _pct(lat_us, 50),
                "latency_p95_us": _pct(lat_us, 95),
            },
            samples={"batch_duration_seconds": batch_secs, "avg_latency_seconds": per_msg},
            config=cfg,
        )

    async def run_server(self, ctx, overrides) -> None:
        cfg = self.config(overrides)
        size = int(cfg["message_bytes"])
        batches = int(cfg["warmup_batches"]) + int(cfg["iterations"])
        conc = int(cfg["concurrency"])
        sinks = [np.empty(size, dtype=np.uint8) for _ in range(conc)]
        await ctx.signal_ready()
        for _ in range(batches):
            await asyncio.gather(*(ctx.server.arecv(s, SMALL_DATA_TAG, ctx.tag_mask) for s in sinks))
        await ctx.flush_endpoint()


class PingpongFlag(Scenario):
    name = "pingpong-flag"
    description = "Round-trip a single-byte control flag to capture latency."
    defaults = {"warmup": 100, "iterations": 1000}

    async def run_client(self, ctx, overrides) -> ScenarioResult:
        cfg = self.config(overrides)
        warmup, iters = int(cfg["warmup"]), int(cfg["iterations"])
        ping = np.ones(1, dtype=np.uint8)
        pong = np.zeros(1, dtype=np.uint8)
        rtts: list[float] = []
        for i in range(warmup + iters):
            pong_fut = ctx.client.arecv(pong, FLAG_PONG_TAG, ctx.tag_mask)
            t0 = time.perf_counter()
            await ctx.client.asend(ping, FLAG_PING_TAG)
            await pong_fut
            if i >= warmup:
                rtts.append(time.perf_counter() - t0)
        await ctx.flush()
        us = np.asarray(rtts) * 1e6
        avg = float(np.mean(us)) if len(us) else 0.0
        return ScenarioResult(
            name=self.name,
            metrics={
                "avg_rtt_us": avg,
                "median_rtt_us": float(np.median(us)) if len(us) else 0.0,
                "min_rtt_us": float(np.min(us)) if len(us) else 0.0,
                "max_rtt_us": float(np.max(us)) if len(us) else 0.0,
                "avg_one_way_us": avg / 2.0,
            },
            samples={"rtt_seconds": rtts},
            config=cfg,
        )

    async def run_server(self, ctx, overrides) -> None:
        cfg = self.config(overrides)
        total = int(cfg["warmup"]) + int(cfg["iterations"])
        sink = np.zeros(1, dtype=np.uint8)
        ack = np.ones(1, dtype=np.uint8)
        await ctx.signal_ready()
        for _ in range(total):
            await ctx.server.arecv(sink, FLAG_PING_TAG, ctx.tag_mask)
            await ctx.server.asend(ctx.endpoint, ack, FLAG_PONG_TAG)
        await ctx.flush_endpoint()


class StreamingDuplex(Scenario):
    name = "streaming-duplex"
    description = "Bidirectional medium-sized streaming in both directions."
    defaults = {"message_bytes": 4 * 1024 * 1024, "warmup": 8, "iterations": 64, "payload": "host"}

    async def run_client(self, ctx, overrides) -> ScenarioResult:
        cfg = self.config(overrides)
        size = int(cfg["message_bytes"])
        warmup, iters = int(cfg["warmup"]), int(cfg["iterations"])
        up = _make_payload(size, 0x7B, cfg.get("payload", "host"))
        down = _make_sink(size, cfg.get("payload", "host"))
        secs: list[float] = []
        for i in range(warmup + iters):
            down_fut = ctx.client.arecv(down, STREAM_DOWN_TAG, ctx.tag_mask)
            t0 = time.perf_counter()
            await asyncio.gather(ctx.client.asend(up, STREAM_UP_TAG), down_fut)
            dt = time.perf_counter() - t0
            if i >= warmup:
                secs.append(dt)
        await ctx.flush()
        total = sum(secs)
        one_way = size * iters
        per_dir = one_way / total / 1e9 if total > 0 else 0.0
        return ScenarioResult(
            name=self.name,
            metrics={
                "total_seconds": total,
                "avg_seconds_per_iter": total / iters if iters else 0.0,
                "client_to_server_gbps": per_dir,
                "server_to_client_gbps": per_dir,
                "aggregate_gbps": 2 * per_dir,
            },
            samples={"iteration_seconds": secs},
            config=cfg,
        )

    async def run_server(self, ctx, overrides) -> None:
        cfg = self.config(overrides)
        size = int(cfg["message_bytes"])
        total = int(cfg["warmup"]) + int(cfg["iterations"])
        down = _make_payload(size, 0x3C, cfg.get("payload", "host"))
        up = _make_sink(size, cfg.get("payload", "host"))
        await ctx.signal_ready()
        for _ in range(total):
            await asyncio.gather(
                ctx.server.arecv(up, STREAM_UP_TAG, ctx.tag_mask),
                ctx.server.asend(ctx.endpoint, down, STREAM_DOWN_TAG),
            )
        await ctx.flush_endpoint()


class Striped(Scenario):
    """Multi-rail striped throughput (DESIGN.md §17): one-way transfer of
    large messages with the stripe scheduler armed (``--rails N`` sets
    ``STARWAY_RAILS`` before the workers are built; the conn then carries
    N lanes).  ``paired=True`` is the built-in paired-ratio mode: every
    iteration measures a striping-OFF baseline and a striping-ON transfer
    back to back over the SAME connection (``STARWAY_STRIPE_THRESHOLD``
    is read per send, so the toggle is one env flip), which cancels the
    1.5-6 GB/s box noise that otherwise needs hand-run interleaving
    (BENCHMARK.md)."""

    name = "striped"
    description = "Striped large-message throughput across the rail set (optionally HEAD/new paired)."
    defaults = {"message_bytes": 8 << 20, "warmup": 2, "iterations": 10,
                "payload": "host", "paired": False}

    @staticmethod
    def _thr_env():
        import os

        return os.environ.get("STARWAY_STRIPE_THRESHOLD", "")

    @staticmethod
    def _set_thr(val: str) -> None:
        import os

        if val:
            os.environ["STARWAY_STRIPE_THRESHOLD"] = val
        else:
            os.environ.pop("STARWAY_STRIPE_THRESHOLD", None)

    async def run_client(self, ctx, overrides) -> ScenarioResult:
        cfg = self.config(overrides)
        size = int(cfg["message_bytes"])
        warmup, iters = int(cfg["warmup"]), int(cfg["iterations"])
        paired = bool(cfg.get("paired"))
        payload = _make_payload(size, 0x5B, cfg.get("payload", "host"))
        armed = self._thr_env() or str(1 << 20)

        async def one(thr: str) -> float:
            self._set_thr(thr)
            try:
                t0 = time.perf_counter()
                await ctx.client.asend(payload, STRIPED_DATA_TAG)
                await ctx.flush()
                return time.perf_counter() - t0
            finally:
                self._set_thr(armed)

        striped: list[float] = []
        base: list[float] = []
        for i in range(warmup + iters):
            if paired:
                b = await one("0")       # HEAD config: single lane
                s = await one(armed)     # new config: striped
                if i >= warmup:
                    base.append(b)
                    striped.append(s)
            else:
                s = await one(armed)
                if i >= warmup:
                    striped.append(s)
        gbps = [size / dt / 1e9 for dt in striped if dt > 0]
        metrics = {
            "striped_gbps_p50": float(np.median(gbps)) if gbps else 0.0,
            "striped_seconds_total": sum(striped),
        }
        samples = {"striped_seconds": striped}
        if paired:
            base_gbps = [size / dt / 1e9 for dt in base if dt > 0]
            ratios = [b / s for b, s in zip(base, striped) if s > 0]
            metrics.update(
                baseline_gbps_p50=(float(np.median(base_gbps))
                                   if base_gbps else 0.0),
                paired_ratio_p50=float(np.median(ratios)) if ratios else 0.0,
                paired_ratio_min=min(ratios) if ratios else 0.0,
                paired_ratio_max=max(ratios) if ratios else 0.0,
            )
            samples["baseline_seconds"] = base
            samples["paired_ratios"] = ratios
        return ScenarioResult(name=self.name, metrics=metrics,
                              samples=samples, config=cfg)

    async def run_server(self, ctx, overrides) -> None:
        cfg = self.config(overrides)
        size = int(cfg["message_bytes"])
        total = int(cfg["warmup"]) + int(cfg["iterations"])
        if bool(cfg.get("paired")):
            total *= 2
        sink = _make_sink(size, cfg.get("payload", "host"))
        await ctx.signal_ready()
        for _ in range(total):
            await ctx.server.arecv(sink, STRIPED_DATA_TAG, ctx.tag_mask)
        await ctx.flush_endpoint()


class Flooded(Scenario):
    """Overload robustness (DESIGN.md §18): a burst of unmatched eager
    sends against a peer that posts its receives LATE.  With
    ``STARWAY_FC_WINDOW`` set the receiver's unexpected-queue residency
    stays bounded by the window (``peak_unexp_bytes``, sampled live on
    the receiving worker while the flood is in flight) and the sender
    parks (``sends_parked``); with it unset the queue grows with the
    whole burst -- run the CLI once with and once without the env to see
    bounded-vs-unbounded receiver memory.  ``paired=True``
    (``--paired-baseline``) interleaves a MATCHED phase (receives posted
    before the burst) with every flood iteration over the same conn, so
    one run also shows that flow control adds no measurable cost to the
    matched-recv fast path (``matched_msgs_per_s`` with fc on vs a run
    with it off)."""

    name = "flooded"
    description = "Unmatched-send overload: bounded receiver memory + matched fast-path cost (DESIGN.md §18)."
    defaults = {"message_bytes": 16 << 10, "messages": 96, "warmup": 1,
                "iterations": 4, "hold_s": 0.4, "paired": False}

    async def run_client(self, ctx, overrides) -> ScenarioResult:
        cfg = self.config(overrides)
        size, nmsg = int(cfg["message_bytes"]), int(cfg["messages"])
        warmup, iters = int(cfg["warmup"]), int(cfg["iterations"])
        paired = bool(cfg.get("paired"))
        payloads = [np.full(size, i % 251, dtype=np.uint8)
                    for i in range(nmsg)]
        stats_buf = np.zeros(4096, dtype=np.uint8)
        flood_secs: list[float] = []
        matched_secs: list[float] = []
        peaks: list[int] = []
        for it in range(warmup + iters):
            stats_fut = ctx.client.arecv(stats_buf, FLOOD_STATS_TAG,
                                         ctx.tag_mask)
            t0 = time.perf_counter()
            await asyncio.gather(
                *(ctx.client.asend(p, FLOOD_DATA_TAG) for p in payloads))
            _, ln = await stats_fut
            await ctx.flush()
            dt = time.perf_counter() - t0
            stats = _decode_ctl(stats_buf, ln)
            if it >= warmup:
                flood_secs.append(dt)
                peaks.append(int(stats.get("peak", 0)))
            if paired:
                # Matched phase: the server posts first and GOes us.
                _, ln = await ctx.client.arecv(stats_buf, FLOOD_STATS_TAG,
                                               ctx.tag_mask)
                t0 = time.perf_counter()
                await asyncio.gather(
                    *(ctx.client.asend(p, FLOOD_DATA_TAG) for p in payloads))
                await ctx.flush()
                if it >= warmup:
                    matched_secs.append(time.perf_counter() - t0)
        metrics = {
            "peak_unexp_bytes": max(peaks) if peaks else 0,
            "flood_seconds_p50": float(np.median(flood_secs))
            if flood_secs else 0.0,
            "flood_msgs_per_s": (nmsg / float(np.median(flood_secs)))
            if flood_secs else 0.0,
        }
        samples = {"flood_seconds": flood_secs,
                   "peak_unexp_bytes": [float(p) for p in peaks]}
        if paired:
            metrics["matched_seconds_p50"] = (float(np.median(matched_secs))
                                              if matched_secs else 0.0)
            metrics["matched_msgs_per_s"] = (
                nmsg / float(np.median(matched_secs)) if matched_secs else 0.0)
            samples["matched_seconds"] = matched_secs
        return ScenarioResult(name=self.name, metrics=metrics,
                              samples=samples, config=cfg)

    async def run_server(self, ctx, overrides) -> None:
        cfg = self.config(overrides)
        size, nmsg = int(cfg["message_bytes"]), int(cfg["messages"])
        total = int(cfg["warmup"]) + int(cfg["iterations"])
        hold = float(cfg["hold_s"])
        paired = bool(cfg.get("paired"))
        sinks = [np.empty(size, dtype=np.uint8) for _ in range(nmsg)]
        worker = ctx.server._server

        def unexp_now() -> int:
            g = worker.gauges_snapshot()
            return sum(int(c.get("unexp_bytes", 0))
                       for c in g.get("conns", {}).values())

        await ctx.signal_ready()
        for _ in range(total):
            # Flood phase: hold the receives back and sample residency.
            peak = 0
            deadline = time.perf_counter() + hold
            while time.perf_counter() < deadline:
                peak = max(peak, unexp_now())
                await asyncio.sleep(0.02)
            recvs = [ctx.server.arecv(s, FLOOD_DATA_TAG, ctx.tag_mask)
                     for s in sinks]
            await ctx.server.asend(ctx.endpoint, _encode_ctl({"peak": peak}),
                                   FLOOD_STATS_TAG)
            await asyncio.gather(*recvs)
            if paired:
                # Matched phase: receives first, then GO.
                recvs = [ctx.server.arecv(s, FLOOD_DATA_TAG, ctx.tag_mask)
                         for s in sinks]
                await ctx.server.asend(ctx.endpoint, _encode_ctl({"go": 1}),
                                       FLOOD_STATS_TAG)
                await asyncio.gather(*recvs)
        await ctx.flush_endpoint()


class Reshard(Scenario):
    """swshard array redistribution (DESIGN.md §20): the measuring side
    (rank 0) owns an N-byte array row-sharded into ``blocks`` shards,
    the sink side (rank 1) wants it column-sharded -- the transposed-
    ownership retile every piece of the array must cross for.  The
    planner compiles the block intersections into rounds of <=budget
    transfers and the executor drives them with flush barriers between
    rounds, so peak staging per role stays O(shard) = O(N/blocks), not
    O(N) -- ``peak_staging_bytes`` (the live reshard_staging gauge) vs
    ``staging_bound_bytes`` in the metrics shows the §20 memory bound
    holding at full bandwidth.  Host numpy path: the schedule machinery
    itself imports no array library."""

    name = "reshard"
    description = "Sharding->sharding redistribution: GB/s under the O(shard) staging bound (DESIGN.md §20)."
    defaults = {"message_bytes": 256 << 20, "blocks": 8, "warmup": 1,
                "iterations": 3}

    @staticmethod
    def _specs(size: int, blocks: int):
        from ..reshard import Block, ShardSpec

        rows = int(blocks)
        cols = max(rows, int(size) // rows)
        shape = (rows, cols)  # one row per source shard
        src = ShardSpec(shape, 1, [
            Block(0, ((r, r + 1), (0, cols))) for r in range(rows)])
        step = cols // rows
        edges = [c * step for c in range(rows)] + [cols]
        dst = ShardSpec(shape, 1, [
            Block(1, ((0, rows), (edges[c], edges[c + 1])))
            for c in range(rows)])
        return shape, src, dst

    @staticmethod
    def _lease():
        from ..reshard import tags

        # Direct construction (no registry acquire): both roles -- which
        # share one process in loopback -- coordinate on the same slot.
        return tags.TagLease(RESHARD_LEASE_SLOT)

    async def run_client(self, ctx, overrides) -> ScenarioResult:
        from ..reshard import build_plan, executor

        cfg = self.config(overrides)
        size, blocks = int(cfg["message_bytes"]), int(cfg["blocks"])
        warmup, iters = int(cfg["warmup"]), int(cfg["iterations"])
        shape, src, dst = self._specs(size, blocks)
        plan = build_plan(src, dst)
        lease = self._lease()
        # Tiled 0..250 pattern with no multi-GiB uint64 temporaries (the
        # scenario's selling point is bounded staging; its own setup
        # must not allocate O(8 x array)).
        data = np.resize(np.arange(251, dtype=np.uint8),
                         shape[0] * shape[1]).reshape(shape)

        def read_box(box):
            (r0, r1), (c0, c1) = box
            return np.ascontiguousarray(data[r0:r1, c0:c1]).reshape(-1)

        def write_box(box, view):  # rank 0 is a pure sender
            raise AssertionError("unexpected receive on the source rank")

        stats_buf = np.zeros(4096, dtype=np.uint8)
        secs: list[float] = []
        peaks: list[int] = []
        rounds = 0
        for i in range(warmup + iters):
            stats_fut = ctx.client.arecv(stats_buf, RESHARD_STATS_TAG,
                                         ctx.tag_mask)
            t0 = time.perf_counter()
            st = await executor.execute(
                plan, 0, {1: ctx.client}, read_box, write_box,
                tag_of=lambda t: lease.data_tag(t.tag_off))
            _, ln = await stats_fut
            dt = time.perf_counter() - t0
            peer = _decode_ctl(stats_buf, ln)
            if i >= warmup:
                secs.append(dt)
                rounds = st["rounds"]
                # Worst single ROLE's own high-water: per-invocation
                # peaks, not the process-global gauge -- in loopback
                # both roles share one process and would double-count.
                peaks.append(max(int(st["peak_staging"]),
                                 int(peer.get("peak", 0))))
        await ctx.flush()
        total = sum(secs)
        moved = plan.total_wire_nbytes()
        return ScenarioResult(
            name=self.name,
            metrics={
                "total_seconds": total,
                "avg_seconds_per_iter": total / iters if iters else 0.0,
                "avg_gbps": (moved * iters / total / 1e9) if total > 0 else 0.0,
                "rounds": rounds,
                "transfers": len(plan.transfers),
                "wire_bytes_per_iter": moved,
                "peak_staging_bytes": max(peaks) if peaks else 0,
                "staging_bound_bytes": 2 * plan.budget,
            },
            samples={"duration_seconds": secs,
                     "peak_staging_bytes": [float(p) for p in peaks]},
            config=cfg,
        )

    class _SinkPort:
        """Endpoint-bound server port (dp_exchange.ServerPort's shape,
        local so this module stays importable without jax)."""

        def __init__(self, server, endpoint):
            self._s = server
            self._ep = endpoint

        def asend(self, buf, tag):
            return self._s.asend(self._ep, buf, tag)

        def arecv(self, buf, tag, mask):
            return self._s.arecv(buf, tag, mask)

        def aflush(self):
            return self._s.aflush_ep(self._ep)

    async def run_server(self, ctx, overrides) -> None:
        from ..reshard import build_plan, executor

        cfg = self.config(overrides)
        size, blocks = int(cfg["message_bytes"]), int(cfg["blocks"])
        total = int(cfg["warmup"]) + int(cfg["iterations"])
        shape, src, dst = self._specs(size, blocks)
        plan = build_plan(src, dst)
        lease = self._lease()
        out = np.empty(shape, dtype=np.uint8)

        def read_box(box):  # rank 1 is a pure receiver
            raise AssertionError("unexpected send from the sink rank")

        def write_box(box, view):
            (r0, r1), (c0, c1) = box
            out[r0:r1, c0:c1] = np.frombuffer(view, dtype=np.uint8).reshape(
                (r1 - r0, c1 - c0))

        port = self._SinkPort(ctx.server, ctx.endpoint)
        await ctx.signal_ready()
        for _ in range(total):
            st = await executor.execute(
                plan, 1, {0: port}, read_box, write_box,
                tag_of=lambda t: lease.data_tag(t.tag_off))
            await ctx.server.asend(
                ctx.endpoint, _encode_ctl({"peak": int(st["peak_staging"])}),
                RESHARD_STATS_TAG)
        # Cheap correctness pin: the received retile is the source pattern.
        want = np.resize(np.arange(251, dtype=np.uint8),
                         shape[0] * shape[1]).reshape(shape)
        if not np.array_equal(out, want):
            raise AssertionError("reshard scenario: received retile corrupt")
        await ctx.flush_endpoint()


# Back-compat aliases matching the reference's registry surface.
ScenarioDefinition = Scenario

SCENARIOS: Dict[str, Scenario] = {
    s.name: s for s in (LargeArray(), SmallMessages(), PingpongFlag(),
                        StreamingDuplex(), Striped(), Flooded(), Reshard())
}

__all__ = [
    "SCENARIOS",
    "Scenario",
    "ScenarioDefinition",
    "ScenarioResult",
    "CONTROL_TAG",
    "READY_TAG",
    "DONE_TAG",
    "TAG_MASK",
]
