"""session-chaos smoke: a loopback pair through FaultProxy under periodic
connection resets, with swtrace counters as the exactly-once oracle.

The CI twin of tests/test_session.py::test_session_chaos_soak (which is
the @slow long variant): every cycle posts a burst of arecv/asend, kills
the proxied connection mid-burst with an RST, and the resilient-session
layer (STARWAY_SESSION=1, DESIGN.md §14) must redial + replay so that
every posted asend/arecv/aflush completes exactly once -- the server's
``recvs_completed`` counter equals the total posted, at least one
``sessions_resumed`` is recorded, no duplicate delivery escapes the
``dup_frames_dropped`` dedup, and no op fails.

Runs on both engines (the env is sampled at worker construction, so the
roles can differ):

    python scripts/torch/session_chaos.py --server-engine native --client-engine py

Progress is LIVE: the swscope telemetry sampler (core/telemetry.py,
DESIGN.md §15) is armed for the run and every cycle prints the current
resume count and session-journal residency from its latest sample -- a
stalled chaos run shows where it stalled, not just a missing final line.

Exit 0 and one JSON result line on success; non-zero with a diagnostic on
any lost, duplicated, or failed op.
"""

import argparse
import asyncio
import json
import os
import sys
import time

# Runnable straight from a checkout (CI, release_smoke's sdist tree).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _parse():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--server-engine", choices=("py", "native"), default="py")
    ap.add_argument("--client-engine", choices=("py", "native"), default="py")
    ap.add_argument("--cycles", type=int, default=4,
                    help="kill/resume cycles (default 4)")
    ap.add_argument("--n", type=int, default=15,
                    help="ops per cycle (default 15)")
    ap.add_argument("--size", type=int, default=4096,
                    help="payload bytes per op (default 4096)")
    ap.add_argument("--corrupt", action="store_true",
                    help="mixed corruption soak (ISSUE 11, DESIGN.md §19): "
                         "STARWAY_INTEGRITY=1 + sessions + fc + rails, "
                         "driven through a corrupt-mode FaultProxy that "
                         "bit-flips eager DATA frames AND striped chunks "
                         "while connections are periodically killed; "
                         "oracle: every op completes exactly once with "
                         "byte-exact payloads, every flip is detected "
                         "(csum_fail), chunk flips recover by retransmit "
                         "and frame flips by suspend+replay")
    ap.add_argument("--overload", action="store_true",
                    help="many-client overload soak (DESIGN.md §18): "
                         "--clients concurrent senders against ONE server, "
                         "mixed fast/slow receivers, periodic kills; swtrace "
                         "counters + gauges are the no-OOM / exactly-once "
                         "oracle")
    ap.add_argument("--clients", type=int, default=8,
                    help="overload mode: concurrent client workers (default 8)")
    ap.add_argument("--slow-every", type=int, default=3,
                    help="overload mode: every k-th client's receives post "
                         "LATE (a slow consumer; default 3)")
    ap.add_argument("--fc-window", type=int, default=64 * 1024,
                    help="overload mode: STARWAY_FC_WINDOW bytes (default 64Ki)")
    return ap.parse_args()


def _monitor_check(report: dict) -> bool:
    """swrefine conformance checkpoint (DESIGN.md §22): with
    STARWAY_MONITOR=1 every chaos schedule is also a model<->code
    conformance check -- replay every traced ring through the protocol
    monitor and fail the soak hard on any divergence (the violation's
    flight dump + ring land under STARWAY_FLIGHT_DIR for CI artifacts)."""
    from starway_tpu_torch.core import monitor, swtrace

    if not monitor.active():
        return True
    monitor.check_all()
    viols = monitor.violations()
    report["monitor_violations"] = len(viols)
    report["monitor_witnessed"] = len(monitor.witnessed())
    if viols:
        flight = os.environ.get("STARWAY_FLIGHT_DIR")
        if flight:
            swtrace.write_ring_dump(
                os.path.join(flight, f"monitor-rings-{os.getpid()}.json"))
        for v in viols:
            print(f"MONITOR VIOLATION: {v.render()}", file=sys.stderr)
        return False
    return True


def _print_live(cycle: int, total: int, sample: dict) -> None:
    """One progress line per cycle, read from the sampler's snapshot (the
    same JSONL shape STARWAY_METRICS_PATH emits)."""
    resumes = replayed = journal = 0
    for wk in sample.get("workers", {}).values():
        ctr = wk.get("counters", {})
        resumes += ctr.get("sessions_resumed", 0)
        replayed += ctr.get("frames_replayed", 0)
        for g in wk.get("gauges", {}).get("conns", {}).values():
            journal += g.get("journal_bytes", 0)
    print(f"[cycle {cycle}] ops={total} resumes={resumes} "
          f"replayed={replayed} journal_bytes={journal}",
          file=sys.stderr, flush=True)


async def _main(args) -> int:
    # Env before any worker is built: workers sample it at construction.
    os.environ["STARWAY_TLS"] = "tcp"
    os.environ["STARWAY_SESSION"] = "1"
    os.environ.setdefault("STARWAY_SESSION_GRACE", "30")
    # Arm the swscope sampler so progress prints come from live samples.
    os.environ.setdefault("STARWAY_METRICS_INTERVAL", "0.25")
    # swpulse sentinel (DESIGN.md §25): every chaos schedule doubles as a
    # liveness check -- kills + resumes are PROGRESS, so a healthy soak
    # must end with zero stall_alerts (asserted in the oracle below).
    os.environ.setdefault("STARWAY_STALL_MS", "5000")

    import socket

    import numpy as np

    from starway_tpu_torch import Client, Server
    from starway_tpu_torch.core import telemetry
    from starway_tpu_torch.testing.faults import FaultProxy

    with socket.socket() as s:  # a free loopback port for the server
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ["STARWAY_NATIVE"] = "1" if args.server_engine == "native" else "0"
    server = Server()
    server.listen("127.0.0.1", port)
    proxy = FaultProxy("127.0.0.1", port).start()
    os.environ["STARWAY_NATIVE"] = "1" if args.client_engine == "native" else "0"
    client = Client()
    await client.aconnect("127.0.0.1", proxy.port)

    total = 0
    t0 = time.monotonic()
    try:
        for cycle in range(args.cycles):
            n, size, tag0 = args.n, args.size, cycle * 1000
            bufs = [np.zeros(size, dtype=np.uint8) for _ in range(n)]
            recvs = [server.arecv(bufs[i], tag0 + i, (1 << 64) - 1)
                     for i in range(n)]
            sends = []
            for i in range(n):
                sends.append(client.asend(
                    np.full(size, (tag0 + i) % 251, dtype=np.uint8), tag0 + i))
                if i == n // 2:
                    await asyncio.sleep(0.2)  # let part of the burst fly
                    proxy.kill_all(rst=True)  # the periodic conn reset
            await asyncio.wait_for(asyncio.gather(*sends), timeout=60)
            await asyncio.wait_for(client.aflush(), timeout=60)
            res = await asyncio.wait_for(asyncio.gather(*recvs), timeout=60)
            for i, (stag, ln) in enumerate(res):
                assert stag == tag0 + i and ln == size, (cycle, i, stag, ln)
                assert bufs[i][0] == (tag0 + i) % 251, (cycle, i)
                assert bufs[i][-1] == (tag0 + i) % 251, (cycle, i)
            total += n
            _print_live(cycle, total, telemetry.sample_now())

        ss = server._server.counters_snapshot()
        cs = client._client.counters_snapshot()
        report = {
            "server_engine": args.server_engine,
            "client_engine": args.client_engine,
            "cycles": args.cycles,
            "ops": total,
            "elapsed_s": round(time.monotonic() - t0, 3),
            "recvs_completed": ss["recvs_completed"],
            "sessions_resumed": cs["sessions_resumed"] + ss["sessions_resumed"],
            "frames_replayed": cs["frames_replayed"],
            "dup_frames_dropped": ss["dup_frames_dropped"],
            "ops_failed": cs["ops_timed_out"] + ss["ops_timed_out"],
            "stall_alerts": cs["stall_alerts"] + ss["stall_alerts"],
        }
        # The exactly-once oracle: each posted recv completed ONCE (the
        # matcher never double-fires a future, so == total also rules out
        # duplicate delivery), and the outage was ridden through by
        # resume, not by fresh conns.  The §25 sentinel doubles as the
        # liveness oracle: a schedule that completes must never have
        # tripped a stall alert along the way.
        ok = (ss["recvs_completed"] == total
              and report["sessions_resumed"] >= 1
              and report["stall_alerts"] == 0)
        ok = _monitor_check(report) and ok
        report["ok"] = ok
        print(json.dumps(report))
        return 0 if ok else 1
    finally:
        for obj in (client, server):
            try:
                await asyncio.wait_for(obj.aclose(), timeout=10)
            except Exception:
                pass
        proxy.stop()


async def _corrupt_soak(args) -> int:
    """Corruption chaos (ISSUE 11): integrity + sessions + fc + rails all
    on, a corrupt-mode proxy flipping bits in whatever body frames pass
    (eager DATA -> poison + suspend + replay; striped T_SDATA -> T_SNACK
    single-chunk retransmit), and periodic mid-burst kills layered on
    top.  Oracle: every posted op completes exactly once with byte-exact
    payloads, every injected flip was DETECTED (csum_fail + chunk_retx
    cover the injected count -- silent corruption is the one inadmissible
    outcome), and resumes covered the kills."""
    os.environ["STARWAY_TLS"] = "tcp"
    os.environ["STARWAY_SESSION"] = "1"
    os.environ["STARWAY_INTEGRITY"] = "1"
    os.environ.setdefault("STARWAY_SESSION_GRACE", "30")
    os.environ["STARWAY_FC_WINDOW"] = str(args.fc_window)
    os.environ["STARWAY_RAILS"] = "2"
    os.environ["STARWAY_STRIPE_THRESHOLD"] = str(1 << 20)
    os.environ["STARWAY_STRIPE_CHUNK"] = str(256 << 10)
    os.environ.setdefault("STARWAY_METRICS_INTERVAL", "0.25")
    os.environ.setdefault("STARWAY_STALL_MS", "5000")  # §25 liveness oracle

    import socket

    import numpy as np

    from starway_tpu_torch import Client, Server
    from starway_tpu_torch.core import telemetry
    from starway_tpu_torch.testing.faults import FaultProxy

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ["STARWAY_NATIVE"] = "1" if args.server_engine == "native" else "0"
    server = Server()
    server.listen("127.0.0.1", port)
    # Phase 1 targets striped T_SDATA chunks (the NACK/retransmit path);
    # after half the cycles the selector flips to eager DATA frames (the
    # poison/suspend/replay path).  Payload-region flips only -- header
    # flips are the poison-always path, covered by tests/test_integrity.py.
    # Capped at one flip per cycle so late resumes see a clean pipe.
    proxy = FaultProxy("127.0.0.1", port, mode="corrupt", corrupt_ftype=12,
                       corrupt_count=max(1, args.cycles // 2)).start()
    os.environ["STARWAY_NATIVE"] = "1" if args.client_engine == "native" else "0"
    client = Client()
    await client.aconnect("127.0.0.1", proxy.port)

    total = 0
    t0 = time.monotonic()
    big_n = 2 << 20
    big = (np.arange(big_n, dtype=np.uint64) % 251).astype(np.uint8)
    try:
        for cycle in range(args.cycles):
            n, size, tag0 = args.n, args.size, cycle * 1000
            bufs = [np.zeros(size, dtype=np.uint8) for _ in range(n)]
            recvs = [server.arecv(bufs[i], tag0 + i, (1 << 64) - 1)
                     for i in range(n)]
            sink = np.zeros(big_n, dtype=np.uint8)
            bigrecv = server.arecv(sink, tag0 + 999, (1 << 64) - 1)
            sends = [client.asend(
                np.full(size, (tag0 + i) % 251, dtype=np.uint8), tag0 + i)
                for i in range(n)]
            bigsend = client.asend(big, tag0 + 999)  # striped across rails
            if cycle % 2 == 1:
                await asyncio.sleep(0.15)
                proxy.kill_all(rst=True)  # kills layered over corruption
            if cycle == args.cycles // 2:
                # Phase 2: retarget the live proxy at eager DATA frames.
                proxy.corrupt_ftype = 3
                proxy._corrupt_left = args.cycles - args.cycles // 2
            await asyncio.wait_for(asyncio.gather(*sends, bigsend), 90)
            await asyncio.wait_for(client.aflush(), 90)
            await asyncio.wait_for(asyncio.gather(*recvs, bigrecv), 90)
            for i in range(n):
                assert bufs[i][0] == (tag0 + i) % 251, (cycle, i)
                assert bufs[i][-1] == (tag0 + i) % 251, (cycle, i)
            assert (sink == big).all(), f"cycle {cycle}: striped corrupt"
            total += n + 1
            _print_live(cycle, total, telemetry.sample_now())

        ss = server._server.counters_snapshot()
        cs = client._client.counters_snapshot()
        detected = ss["csum_fail"] + cs["csum_fail"]
        retx = cs["chunk_retx"] + ss["chunk_retx"]
        report = {
            "mode": "corrupt",
            "server_engine": args.server_engine,
            "client_engine": args.client_engine,
            "cycles": args.cycles,
            "ops": total,
            "elapsed_s": round(time.monotonic() - t0, 3),
            "recvs_completed": ss["recvs_completed"],
            "flips_injected": proxy.corrupted_units,
            "csum_fail": detected,
            "chunk_retx": retx,
            "sessions_resumed": cs["sessions_resumed"] + ss["sessions_resumed"],
            "stall_alerts": cs["stall_alerts"] + ss["stall_alerts"],
        }
        # The inadmissible outcome is SILENT corruption -- pinned by the
        # byte-exact payload asserts above.  Detection counts are
        # evidence the plane is live (>=1; a flip whose frame died with
        # a killed conn is legitimately never completed, so flips and
        # detections need not match 1:1 under mixed kills), and resumes
        # prove the kills were ridden out.
        ok = (ss["recvs_completed"] == total
              and proxy.corrupted_units >= 1
              and detected >= 1
              and retx >= 1
              and report["sessions_resumed"] >= 1
              and report["stall_alerts"] == 0)
        ok = _monitor_check(report) and ok
        report["ok"] = ok
        print(json.dumps(report))
        return 0 if ok else 1
    finally:
        for obj in (client, server):
            try:
                await asyncio.wait_for(obj.aclose(), timeout=10)
            except Exception:
                pass
        proxy.stop()


async def _overload(args) -> int:
    """Many-client overload soak (ISSUE 9 satellite): dozens of client
    workers flood ONE server through per-client FaultProxies with the §18
    credit window armed; every --slow-every'th client's receives post
    late (slow consumer), and each cycle kills a rotating subset of
    connections mid-burst.  Oracle: every op completes exactly once
    (recvs_completed == posted), resumes cover the kills, and the
    telemetry samples never show unexpected-queue residency above
    clients x window -- bounded, not OOM."""
    os.environ["STARWAY_TLS"] = "tcp"
    os.environ["STARWAY_SESSION"] = "1"
    os.environ.setdefault("STARWAY_SESSION_GRACE", "30")
    os.environ["STARWAY_FC_WINDOW"] = str(args.fc_window)
    os.environ.setdefault("STARWAY_METRICS_INTERVAL", "0.25")
    os.environ.setdefault("STARWAY_STALL_MS", "5000")  # §25 liveness oracle

    import random
    import socket

    import numpy as np

    from starway_tpu_torch import Client, Server
    from starway_tpu_torch.core import telemetry
    from starway_tpu_torch.testing.faults import FaultProxy

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ["STARWAY_NATIVE"] = "1" if args.server_engine == "native" else "0"
    server = Server()
    server.listen("127.0.0.1", port)
    os.environ["STARWAY_NATIVE"] = "1" if args.client_engine == "native" else "0"
    proxies = [FaultProxy("127.0.0.1", port).start()
               for _ in range(args.clients)]
    clients = []
    for p in proxies:
        c = Client()
        await c.aconnect("127.0.0.1", p.port)
        clients.append(c)

    rng = random.Random(0xC0FFEE)
    total = 0
    kills = 0
    peak_unexp = 0
    t0 = time.monotonic()
    try:
        for cycle in range(args.cycles):
            n, size = args.n, args.size
            sends = []
            recvs = []
            bufs = []
            for ci, c in enumerate(clients):
                tag0 = (cycle * len(clients) + ci) * 1000
                for i in range(n):
                    sends.append(c.asend(
                        np.full(size, (tag0 + i) % 251, dtype=np.uint8),
                        tag0 + i))

                async def post_recvs(ci=ci, tag0=tag0):
                    if args.slow_every and ci % args.slow_every == 0:
                        await asyncio.sleep(0.5)  # the slow consumer
                    for i in range(n):
                        buf = np.zeros(size, dtype=np.uint8)
                        bufs.append((tag0 + i, buf))
                        recvs.append(server.arecv(buf, tag0 + i,
                                                  (1 << 64) - 1))

                asyncio.ensure_future(post_recvs())
            await asyncio.sleep(0.1)
            for p in rng.sample(proxies, max(1, len(proxies) // 3)):
                p.kill_all(rst=True)  # the periodic mid-burst kill
                kills += 1
            await asyncio.wait_for(asyncio.gather(*sends), timeout=120)
            for _ in range(200):
                if len(recvs) == len(clients) * n:
                    break
                await asyncio.sleep(0.05)
            res = await asyncio.wait_for(asyncio.gather(*recvs), timeout=120)
            assert len(res) == len(clients) * n
            for tag, buf in bufs:
                assert buf[0] == tag % 251 and buf[-1] == tag % 251, tag
            total += len(res)
            sample = telemetry.sample_now()
            for wk in sample.get("workers", {}).values():
                for g in wk.get("gauges", {}).get("conns", {}).values():
                    peak_unexp = max(peak_unexp, g.get("unexp_bytes", 0))
            _print_live(cycle, total, sample)

        await asyncio.wait_for(
            asyncio.gather(*(c.aflush() for c in clients)), timeout=120)
        ss = server._server.counters_snapshot()
        resumes = ss["sessions_resumed"] + sum(
            c._client.counters_snapshot()["sessions_resumed"]
            for c in clients)
        parked = sum(c._client.counters_snapshot()["sends_parked"]
                     for c in clients)
        bound = args.fc_window  # per-conn bound: the §18 window
        report = {
            "mode": "overload",
            "server_engine": args.server_engine,
            "client_engine": args.client_engine,
            "clients": args.clients,
            "cycles": args.cycles,
            "ops": total,
            "kills": kills,
            "elapsed_s": round(time.monotonic() - t0, 3),
            "recvs_completed": ss["recvs_completed"],
            "sessions_resumed": resumes,
            "sends_parked": parked,
            "peak_unexp_bytes": peak_unexp,
            "unexp_bound": bound,
            "stall_alerts": ss["stall_alerts"] + sum(
                c._client.counters_snapshot()["stall_alerts"]
                for c in clients),
        }
        ok = (ss["recvs_completed"] == total and resumes >= 1
              and peak_unexp <= bound
              and report["stall_alerts"] == 0)
        ok = _monitor_check(report) and ok
        report["ok"] = ok
        print(json.dumps(report))
        return 0 if ok else 1
    finally:
        for obj in clients + [server]:
            try:
                await asyncio.wait_for(obj.aclose(), timeout=10)
            except Exception:
                pass
        for p in proxies:
            p.stop()


if __name__ == "__main__":
    _args = _parse()
    if _args.corrupt:
        sys.exit(asyncio.run(_corrupt_soak(_args)))
    sys.exit(asyncio.run(_overload(_args) if _args.overload
                         else _main(_args)))
