"""Benchmark CLI: ``python -m starway_tpu_torch.bench``.

Same surface as the reference CLI (src/starway/bench.py): roles
``server`` / ``client`` / ``loopback``, socket or worker-address bootstrap
(hex-encoded blob), per-scenario overrides with K/M/G size suffixes, JSON
control frames over tagged messages, and a JSON report with optional
per-iteration traces.  ``--tls`` maps to ``STARWAY_TLS`` (the reference's
``UCX_TLS`` analogue, benchmark.md:114-126).

The control protocol is unchanged in shape: the client drives, sending a JSON
frame on CONTROL_TAG naming the scenario + overrides; the server replies on
READY_TAG, runs its half, then signals DONE_TAG.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np

_SIZE_SUFFIXES = {
    "kib": 1 << 10, "kb": 1 << 10, "ki": 1 << 10, "k": 1 << 10,
    "mib": 1 << 20, "mb": 1 << 20, "mi": 1 << 20, "m": 1 << 20,
    "gib": 1 << 30, "gb": 1 << 30, "gi": 1 << 30, "g": 1 << 30,
}


def parse_size(value: str) -> int:
    """Parse '512M', '1g', '4096' into bytes (reference: bench.py:29-49)."""
    text = value.strip().lower().replace("_", "")
    for suffix in sorted(_SIZE_SUFFIXES, key=len, reverse=True):
        if text.endswith(suffix):
            return int(float(text[: -len(suffix)]) * _SIZE_SUFFIXES[suffix])
    return int(float(text))


def parse_worker_address(value: str) -> bytes:
    return bytes.fromhex(value.replace(":", "").replace(" ", "").strip())


def _encode_ctl(payload: Mapping[str, Any]) -> np.ndarray:
    raw = json.dumps(payload, separators=(",", ":"), sort_keys=True).encode()
    return np.frombuffer(raw, dtype=np.uint8).copy()


def _decode_ctl(buffer: np.ndarray, length: int) -> dict:
    # swcheck: allow(hotpath-copy): a bench control message (a small JSON body), not a payload
    return json.loads(bytes(memoryview(buffer)[:length]).decode())


def build_parser() -> argparse.ArgumentParser:
    from .benchmarks import list_scenarios

    p = argparse.ArgumentParser(description="starway-tpu benchmark suite")
    p.add_argument("--role", choices=("server", "client", "loopback"), required=True)
    p.add_argument("--addr", default="0.0.0.0", help="Server listen address (socket mode).")
    p.add_argument("--port", type=int, default=17777, help="TCP port for socket mode.")
    p.add_argument("--server-host", default="127.0.0.1", help="Server hostname (client role).")
    p.add_argument("--listen-mode", choices=("socket", "worker"), default="socket")
    p.add_argument("--connect-mode", choices=("socket", "worker"), default="socket")
    p.add_argument("--worker-address", help="Hex-encoded worker address blob for connect-mode=worker.")
    p.add_argument("--tls", help="Transport list written to STARWAY_TLS (e.g. 'tcp' or 'inproc,tcp').")
    p.add_argument(
        "--payload", choices=("host", "device"),
        help="Buffer kind for large-array/streaming-duplex: host numpy (default) or torch.uint8 tensors on the card.",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Where device payloads live: cuda:0 (default; refused without "
             "a card) or, only when asked, the CPU (also STARWAY_BENCH_CPU=1).",
    )
    p.add_argument("--scenarios", nargs="*", help="Scenarios to run (default: all). Options: " + ", ".join(list_scenarios()))
    p.add_argument("--large-bytes", type=parse_size)
    p.add_argument("--large-iterations", type=int)
    p.add_argument("--large-warmup", type=int)
    p.add_argument("--small-bytes", type=parse_size)
    p.add_argument("--small-iterations", type=int)
    p.add_argument("--small-warmup", type=int)
    p.add_argument("--small-concurrency", type=int)
    p.add_argument("--flag-iterations", type=int)
    p.add_argument("--flag-warmup", type=int)
    p.add_argument("--stream-bytes", type=parse_size)
    p.add_argument("--stream-iterations", type=int)
    p.add_argument("--stream-warmup", type=int)
    p.add_argument("--striped-bytes", type=parse_size)
    p.add_argument("--striped-iterations", type=int)
    p.add_argument("--striped-warmup", type=int)
    p.add_argument("--flood-bytes", type=parse_size)
    p.add_argument("--flood-messages", type=int)
    p.add_argument("--flood-iterations", type=int)
    p.add_argument(
        "--reshard-bytes", type=parse_size, metavar="BYTES",
        help="Array size for the 'reshard' scenario (redistributed whole "
             "each iteration under the §20 O(shard) staging bound).",
    )
    p.add_argument("--reshard-blocks", type=int, metavar="N",
                   help="Shards per side for the 'reshard' scenario "
                        "(row-sharded source -> column-sharded sink).")
    p.add_argument("--reshard-iterations", type=int)
    p.add_argument("--reshard-warmup", type=int)
    p.add_argument(
        "--fc-window", type=parse_size, metavar="BYTES",
        help="Arm §18 receiver-driven flow control (STARWAY_FC_WINDOW) for "
             "the run; see the 'flooded' scenario (DESIGN.md §18).",
    )
    p.add_argument(
        "--rails", type=int, metavar="N",
        help="Open N transport lanes per connection (STARWAY_RAILS) and arm "
             "multi-rail striping (STARWAY_STRIPE_THRESHOLD defaults to 1 MiB "
             "when unset); see the 'striped' scenario (DESIGN.md §17).",
    )
    p.add_argument(
        "--uring", action="store_true",
        help="Arm the §24 io_uring batched-TX lever (STARWAY_IOURING=1); "
             "native engine only, silently falls back to epoll when the "
             "kernel probe fails.",
    )
    p.add_argument(
        "--zerocopy", action="store_true",
        help="Arm the §24 MSG_ZEROCOPY lever (STARWAY_ZEROCOPY=1) for "
             ">= rndv-threshold payloads; native engine only.",
    )
    p.add_argument(
        "--busypoll", type=int, metavar="US",
        help="Arm the §24 bounded busy-poll lever (STARWAY_BUSYPOLL_US): "
             "spin up to US microseconds after the last event before "
             "blocking; native engine only.",
    )
    p.add_argument(
        "--paired-baseline", action="store_true",
        help="Striped scenario only: interleave a striping-OFF baseline with "
             "every striping-ON iteration in ONE process/connection and "
             "report the per-pair ratio -- the box-noise-immune methodology "
             "from BENCHMARK.md, now built in.",
    )
    p.add_argument("--output", type=Path, help="Path to write the JSON report.")
    p.add_argument("--store-trace", action="store_true", help="Include per-iteration samples in the report.")
    p.add_argument(
        "--trace", type=Path, metavar="PATH",
        help="Enable swtrace (STARWAY_TRACE=1) for the run and write a "
             "Chrome trace_event JSON here (open in Perfetto); the printed "
             "report gains a p-tile stage breakdown.",
    )
    p.add_argument(
        "--metrics", type=Path, metavar="PATH",
        help="Arm the swscope telemetry sampler (STARWAY_METRICS_PATH) for "
             "the run, appending JSONL samples here; the JSON report gains "
             "a 'telemetry' time-series summary (peak/mean queue depth, "
             "journal high-water).  View with python -m starway_tpu_torch.metrics.",
    )
    return p


_OVERRIDE_KEYS = {
    "large-array": [("large_bytes", "message_bytes"), ("large_iterations", "iterations"), ("large_warmup", "warmup")],
    "small-messages": [
        ("small_bytes", "message_bytes"), ("small_iterations", "iterations"),
        ("small_warmup", "warmup_batches"), ("small_concurrency", "concurrency"),
    ],
    "pingpong-flag": [("flag_iterations", "iterations"), ("flag_warmup", "warmup")],
    "streaming-duplex": [("stream_bytes", "message_bytes"), ("stream_iterations", "iterations"), ("stream_warmup", "warmup")],
    "striped": [("striped_bytes", "message_bytes"), ("striped_iterations", "iterations"), ("striped_warmup", "warmup")],
    "flooded": [("flood_bytes", "message_bytes"), ("flood_messages", "messages"), ("flood_iterations", "iterations")],
    "reshard": [
        ("reshard_bytes", "message_bytes"), ("reshard_blocks", "blocks"),
        ("reshard_iterations", "iterations"), ("reshard_warmup", "warmup"),
    ],
}


def scenario_plan(args: argparse.Namespace) -> list[tuple[str, dict[str, Any]]]:
    from .benchmarks import list_scenarios
    from .benchmarks.scenarios import SCENARIOS

    requested: Sequence[str]
    if not args.scenarios or (len(args.scenarios) == 1 and args.scenarios[0].lower() == "all"):
        requested = list_scenarios()
    else:
        requested = args.scenarios
    plan = []
    for name in requested:
        if name not in SCENARIOS:
            raise ValueError(f"Unknown scenario '{name}'. Available: {', '.join(list_scenarios())}")
        overrides = {}
        for arg_name, cfg_key in _OVERRIDE_KEYS.get(name, []):
            val = getattr(args, arg_name, None)
            if val is not None:
                overrides[cfg_key] = val
        if getattr(args, "payload", None) and name in ("large-array", "streaming-duplex"):
            overrides["payload"] = args.payload
        if name in ("striped", "flooded") and getattr(args, "paired_baseline",
                                                     False):
            overrides["paired"] = True
        plan.append((name, overrides))
    return plan


class ClientSideContext:
    """What scenarios see on the measuring side."""

    def __init__(self, client):
        from .benchmarks.scenarios import TAG_MASK

        self.client = client
        self.tag_mask = TAG_MASK
        self._ready = np.zeros(1, dtype=np.uint8)
        self._done = np.zeros(1, dtype=np.uint8)

    async def send_control(self, payload: Mapping[str, Any]) -> None:
        from .benchmarks.scenarios import CONTROL_TAG

        await self.client.asend(_encode_ctl(payload), CONTROL_TAG)
        await self.flush()

    async def wait_ready(self) -> None:
        from .benchmarks.scenarios import READY_TAG

        await self.client.arecv(self._ready, READY_TAG, self.tag_mask)

    async def wait_done(self) -> None:
        from .benchmarks.scenarios import DONE_TAG

        await self.client.arecv(self._done, DONE_TAG, self.tag_mask)

    async def flush(self) -> None:
        await self.client.aflush()


class ServerSideContext:
    """What scenarios see on the echo/sink side."""

    def __init__(self, server, endpoint):
        from .benchmarks.scenarios import TAG_MASK

        self.server = server
        self.endpoint = endpoint
        self.tag_mask = TAG_MASK

    async def recv_control(self, max_bytes: int = 4096) -> dict:
        from .benchmarks.scenarios import CONTROL_TAG

        buf = np.empty(max_bytes, dtype=np.uint8)
        _, length = await self.server.arecv(buf, CONTROL_TAG, self.tag_mask)
        return _decode_ctl(buf, length)

    async def signal_ready(self) -> None:
        from .benchmarks.scenarios import READY_TAG

        await self.server.asend(self.endpoint, np.ones(1, dtype=np.uint8), READY_TAG)

    async def signal_done(self) -> None:
        from .benchmarks.scenarios import DONE_TAG

        await self.server.asend(self.endpoint, np.ones(1, dtype=np.uint8), DONE_TAG)

    async def flush_endpoint(self) -> None:
        await self.server.aflush_ep(self.endpoint)


async def run_client(args: argparse.Namespace) -> list:
    from . import Client
    from .benchmarks import get_scenario

    client = Client()
    results = []
    try:
        if args.connect_mode == "worker":
            if not args.worker_address:
                raise ValueError("--worker-address required for connect-mode=worker")
            blob = parse_worker_address(args.worker_address)
            await client.aconnect_address(blob)
            print(f"[client] Connected via worker address ({len(blob)} bytes).")
        else:
            await client.aconnect(args.server_host, args.port)
            print(f"[client] Connected to {args.server_host}:{args.port}.")

        ctx = ClientSideContext(client)
        for name, overrides in scenario_plan(args):
            print(f"[client] Starting scenario '{name}' with overrides {overrides or 'defaults'}.")
            await ctx.send_control({"scenario": name, "config": overrides})
            await ctx.wait_ready()
            result = await get_scenario(name).run_client(ctx, overrides)
            results.append(result)
            await ctx.wait_done()
            print(f"[client] Completed '{name}'.")
        try:
            await ctx.send_control({"scenario": "__shutdown__"})
            await ctx.flush()
        except Exception:
            # The server closes the moment it sees the shutdown frame, so the
            # flush ACK legitimately races the peer's close; a reset here
            # means the frame arrived (or the peer died — either way, done).
            pass
    finally:
        try:
            await client.aclose()
        except Exception:
            pass  # close-before-connect must not mask the original error
    return results


async def run_server(args: argparse.Namespace, address_publish: "asyncio.Future | None" = None) -> None:
    from . import Server
    from .benchmarks import get_scenario
    from .benchmarks.scenarios import SCENARIOS

    server = Server()
    loop = asyncio.get_running_loop()
    accepted: asyncio.Queue = asyncio.Queue()
    server.set_accept_cb(lambda ep: loop.call_soon_threadsafe(accepted.put_nowait, ep))

    if args.listen_mode == "worker":
        blob = server.listen_address()
        print(f"[server] Listening via worker address: {blob.hex()}")
        if address_publish is not None and not address_publish.done():
            address_publish.set_result(blob)
    else:
        server.listen(args.addr, args.port)
        print(f"[server] Listening on {args.addr}:{args.port}")
        if address_publish is not None and not address_publish.done():
            address_publish.set_result(None)

    endpoint = await accepted.get()
    print("[server] Client accepted.")
    ctx = ServerSideContext(server, endpoint)
    try:
        while True:
            control = await ctx.recv_control()
            name = control.get("scenario")
            if name == "__shutdown__":
                print("[server] Shutdown request received.")
                break
            if name not in SCENARIOS:
                raise ValueError(f"Unknown scenario '{name}' from client.")
            overrides = control.get("config", {})
            print(f"[server] Running scenario '{name}'.")
            await get_scenario(name).run_server(ctx, overrides)
            await ctx.signal_done()
            print(f"[server] Scenario '{name}' completed.")
    finally:
        await server.aclose()
        print("[server] Closed.")


async def run_loopback(args: argparse.Namespace) -> list:
    """Single-process client+server, the cheapest distributed simulation
    (reference: bench.py:359-381).  In worker listen mode the runtime-minted
    address blob is wired to the client automatically."""
    addr_fut: asyncio.Future = asyncio.get_running_loop().create_future()
    server_task = asyncio.create_task(run_server(args, addr_fut))

    # A server that dies before (or while) the client is running must fail
    # the loopback, not hang it: before this guard, an exception raised in
    # run_server prior to resolving addr_fut (e.g. an ImportError) left the
    # `await addr_fut` below pending forever.
    def _server_done(t: asyncio.Task) -> None:
        if addr_fut.done() or t.cancelled():
            return
        exc = t.exception()
        addr_fut.set_exception(
            exc if exc is not None
            else RuntimeError("bench server exited before listening"))

    server_task.add_done_callback(_server_done)

    client_task = None
    try:
        blob = await addr_fut
        if blob is not None:
            args.connect_mode = "worker"
            args.worker_address = blob.hex()
        client_task = asyncio.create_task(run_client(args))
        done, _ = await asyncio.wait(
            {client_task, server_task}, return_when=asyncio.FIRST_COMPLETED)
        if client_task not in done:
            # Surface a server FAILURE immediately (otherwise the client
            # would hang on a dead peer).  A clean server exit is normal
            # here: it means the client's __shutdown__ was processed and
            # the client is wrapping up -- keep waiting for its results.
            server_task.result()
        results = await client_task
        await server_task  # late server errors still surface
        return results
    except BaseException:
        for t in (client_task, server_task):
            if t is not None:
                t.cancel()
        for t in (client_task, server_task):
            if t is not None:
                try:
                    await t
                except BaseException:
                    pass
        raise


def _dump_trace(args: argparse.Namespace) -> "dict | None":
    """Write the Chrome trace for --trace runs and print the p-tile stage
    breakdown from the recorded EV_STAGE spans.  Returns the ring dumps'
    per-stage p-tiles for the JSON report (None when --trace is off)."""
    from . import trace as trace_mod
    from .core import swtrace
    from .perf import percentile as _percentile

    dumps = swtrace.dump_all()
    path = trace_mod.write_chrome(dumps, args.trace)
    n_events = sum(len(d["events"]) for d in dumps)
    print(f"\nChrome trace written to {path} ({n_events} events, "
          f"{len(dumps)} worker(s)); open in Perfetto or chrome://tracing")
    durs: dict[str, list] = {}
    for dump in dumps:
        for ev in dump["events"]:
            if ev[1] == swtrace.EV_STAGE and ev[6] > 0:
                durs.setdefault(ev[5], []).append(ev[6])
    if not durs:
        # Stage spans are recorded by the Python data plane; a pure native
        # run still gets op spans, just no stage breakdown.
        return None
    print("[stage p-tiles] (us per recorded span; stage=D2H tx/rx=transport "
          "place=H2D)")
    ptiles = {}
    for name in sorted(durs):
        xs = sorted(durs[name])
        p50, p90, p99 = (_percentile(xs, 50) * 1e6, _percentile(xs, 90) * 1e6,
                         _percentile(xs, 99) * 1e6)
        ptiles[name] = {"count": len(xs), "p50_us": p50, "p90_us": p90,
                        "p99_us": p99}
        print(f"  {name}: n={len(xs)} p50={p50:.1f}us p90={p90:.1f}us "
              f"p99={p99:.1f}us")
    return ptiles


def active_levers() -> list:
    """The §24 swfast levers armed for this process, by env (covers both
    the CLI flags and direct env arming) -- recorded in every JSON report
    so a result row is self-describing."""
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


def dump_results(results, args: argparse.Namespace) -> None:
    from . import perf
    from .benchmarks import get_scenario

    if not results:
        print("No results collected.")
        return
    print("\n=== Benchmark Results ===")
    for result in results:
        print(f"\n[{result.name}] {get_scenario(result.name).description}")
        for key, value in result.metrics.items():
            print(f"  {key}: {value:.6f}" if isinstance(value, float) else f"  {key}: {value}")
    stages = perf.stage_snapshot()
    if stages:
        print("\n[pipeline stages] (this process, whole run; "
              "stage=D2H tx/rx=transport place=H2D)")
        for name, s in sorted(stages.items()):
            avg_us = s["seconds"] / s["count"] * 1e6 if s["count"] else 0.0
            print(f"  {name}: n={s['count']} avg={avg_us:.1f}us "
                  f"bytes={s['bytes']} ({s['gbps']:.2f} GB/s)")
    stage_ptiles = _dump_trace(args) if args.trace else None
    if args.output:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        report = {
            "timestamp": time.time(),
            "transport": os.environ.get("STARWAY_TLS"),
            # §24: which swfast levers this run armed ([] = seed path).
            "levers": active_levers(),
            "scenarios": [r.to_dict(include_samples=args.store_trace) for r in results],
            # Per-stage pipeline telemetry (DESIGN.md §12): loopback runs
            # see both sides; client-role runs see the client's half.
            "stages": stages,
        }
        if args.trace:
            report["trace"] = str(args.trace)
            if stage_ptiles:
                report["stage_ptiles"] = stage_ptiles
        if args.metrics:
            report["metrics"] = str(args.metrics)
            report["telemetry"] = _telemetry_summary()
        args.output.write_text(json.dumps(report, indent=2))
        print(f"\nJSON results written to {args.output}")
    elif args.metrics:
        _telemetry_summary()


def _telemetry_summary() -> dict:
    """Close the --metrics run: one final sample (so the last counter
    deltas land in the JSONL) and the whole-run gauge summary."""
    from .core import telemetry

    telemetry.sample_now()
    summary = telemetry.summarize(
        telemetry.recent_samples(config_metrics_window()))
    print(f"[telemetry] {summary['samples']} sample(s); peak tx queue depth "
          f"{summary['peak_tx_queue_depth']}, peak journal bytes "
          f"{summary['peak_journal_bytes']}")
    return summary


def config_metrics_window() -> int:
    from . import config

    return config.metrics_ring_size()


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.tls:
        os.environ["STARWAY_TLS"] = args.tls
    if args.rails:
        # Rails negotiate at connect, so the env must be set before any
        # worker is built; the threshold default arms striping for the
        # 'striped' scenario's >= 1 MiB messages.
        os.environ["STARWAY_RAILS"] = str(max(1, args.rails))
        os.environ.setdefault("STARWAY_STRIPE_THRESHOLD", str(1 << 20))
    if args.fc_window:
        # Flow control negotiates at connect too (the "fc" handshake key).
        os.environ["STARWAY_FC_WINDOW"] = str(args.fc_window)
    # §24 swfast levers: engine-local (no handshake surface), but sampled
    # once at worker start -- so land the envs before any worker exists.
    if args.uring:
        os.environ["STARWAY_IOURING"] = "1"
    if args.zerocopy:
        os.environ["STARWAY_ZEROCOPY"] = "1"
    if args.busypoll:
        os.environ["STARWAY_BUSYPOLL_US"] = str(max(0, args.busypoll))
    if args.trace:
        # Must land before any worker is created: rings are armed per
        # worker at construction (core/swtrace.py).
        os.environ["STARWAY_TRACE"] = "1"
    if args.metrics:
        # Same construction-time rule for the sampler registry
        # (core/telemetry.py register_worker).  Start the file fresh:
        # the emitter appends, and stale samples from an earlier run
        # would break the per-process mono ordering consumers assert.
        try:
            args.metrics.unlink()
        except OSError:
            pass
        os.environ["STARWAY_METRICS_PATH"] = str(args.metrics)
        os.environ.setdefault("STARWAY_METRICS_INTERVAL", "0.25")
    from .benchmarks import scenarios
    from .headline import cpu_requested

    if cpu_requested(args.device):
        scenarios.PAYLOAD_DEVICE = "cpu"
    elif getattr(args, "payload", None) == "device":
        import torch

        if not torch.cuda.is_available():
            print("bench: --payload device needs a CUDA device; pass "
                  "--device cpu (or STARWAY_BENCH_CPU=1) to run on CPU "
                  "tensors", file=sys.stderr)
            return 2

    if args.role == "server":
        asyncio.run(run_server(args))
        return 0
    if args.role == "client":
        results = asyncio.run(run_client(args))
        dump_results(results, args)
        return 0
    if args.role == "loopback":
        results = asyncio.run(run_loopback(args))
        dump_results(results, args)
        return 0
    raise ValueError(f"Unknown role {args.role}")


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
