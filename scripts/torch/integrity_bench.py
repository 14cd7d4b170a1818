"""Paired-run integrity-overhead gate (ISSUE 11; DESIGN.md §19).

The §19 plane is negotiated at handshake, so it cannot be flipped inside
one worker pair the way the striped paired-baseline mode flips its
per-send threshold -- instead this script interleaves WHOLE loopback
bench runs: OFF, ON, OFF, ON, ... (fresh subprocess per run, so every
run handshakes from scratch and the box's throughput drift hits both
arms equally, the PR-3/PR-8 interleaved-pairs discipline).  Each run is
``python -m starway_tpu_torch.bench --role loopback --scenarios
streaming-duplex`` on the native engine; the report is the per-pair
ON/OFF throughput ratio distribution plus the medians.

Gate (BENCHMARK.md): the default --gate 0.70 is the THIS-BOX regression
bar for the tcp config -- the 1-core dev box is compute-saturated, so
the full two-CRC-passes-per-byte cost shows as ~18% p50 throughput loss
there (table in BENCHMARK.md); a ratio below the bar means the checksum
path itself regressed (e.g. the 3-way interleave was lost), not that
the plane got "more expensive".  The ISSUE 11 <5% target describes a
wire-limited host where the CRC fits the idle CPU margin: enforce it
there with --gate 0.95.

    python scripts/torch/integrity_bench.py [--pairs 5] [--stream-bytes 4M]
    python scripts/torch/integrity_bench.py --json out.json

Exit 0 when the gate holds, 1 otherwise (noisy-box override: rerun).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _free_port() -> int:
    """A free loopback port, bound and released (the bench CLI's
    default port would collide with another run on the host)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_run(integrity: bool, args) -> float:
    """One fresh loopback streaming run; returns aggregate_gbps."""
    env = dict(os.environ)
    env["STARWAY_NATIVE"] = "0" if args.engine == "py" else "1"
    env["STARWAY_TLS"] = args.tls
    if integrity:
        env["STARWAY_INTEGRITY"] = "1"
    else:
        env.pop("STARWAY_INTEGRITY", None)
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        out = f.name
    try:
        cmd = [sys.executable, "-m", "starway_tpu_torch.bench", "--role", "loopback",
               "--scenarios", "streaming-duplex",
               "--stream-bytes", args.stream_bytes,
               "--stream-iterations", str(args.iterations),
               "--stream-warmup", str(args.warmup),
               "--port", str(_free_port()),
               "--output", out]
        subprocess.run(cmd, check=True, env=env, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL, timeout=600)
        with open(out) as fh:
            report = json.load(fh)
        sc = next(s for s in report["scenarios"]
                  if s["name"] == "streaming-duplex")
        return float(sc["metrics"]["aggregate_gbps"])
    finally:
        try:
            os.unlink(out)
        except OSError:
            pass


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=5,
                    help="interleaved OFF/ON run pairs (default 5)")
    ap.add_argument("--stream-bytes", default="4M")
    ap.add_argument("--iterations", type=int, default=48)
    ap.add_argument("--warmup", type=int, default=6)
    ap.add_argument("--engine", choices=("native", "py"), default="native")
    ap.add_argument("--tls", default="tcp",
                    help="STARWAY_TLS for both runs (default tcp; use "
                         "'tcp,sm' to gate the slotted-ring path)")
    ap.add_argument("--gate", type=float, default=0.70,
                    help="minimum acceptable median ON/OFF ratio (0.70 = "
                         "this-box compute-saturated bar; use 0.95 on a "
                         "wire-limited host -- see BENCHMARK.md)")
    ap.add_argument("--json", help="write the full report here")
    args = ap.parse_args()

    offs, ons, ratios = [], [], []
    for i in range(args.pairs):
        off = _one_run(False, args)
        on = _one_run(True, args)
        offs.append(off)
        ons.append(on)
        ratios.append(on / off if off > 0 else 0.0)
        print(f"[pair {i}] off={off:.3f} GB/s  on={on:.3f} GB/s  "
              f"ratio={ratios[-1]:.3f}", file=sys.stderr, flush=True)
    report = {
        "engine": args.engine,
        "tls": args.tls,
        "stream_bytes": args.stream_bytes,
        "pairs": args.pairs,
        "off_gbps": offs,
        "on_gbps": ons,
        "ratios": [round(r, 4) for r in ratios],
        "off_gbps_p50": round(statistics.median(offs), 4),
        "on_gbps_p50": round(statistics.median(ons), 4),
        "ratio_p50": round(statistics.median(ratios), 4),
        "ratio_min": round(min(ratios), 4),
        "ratio_max": round(max(ratios), 4),
        "gate": args.gate,
    }
    report["ok"] = report["ratio_p50"] >= args.gate
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
