"""Interleaved paired-ratio bench runner (ISSUE 17; the reusable form of
scripts/integrity_bench.py's discipline).

Compares two bench configurations A ("baseline") and B ("candidate") by
interleaving WHOLE fresh-subprocess loopback runs -- A, B, A, B, ... --
so the box's throughput drift hits both arms equally (the PR-3/PR-8
paired discipline).  Each arm is ``python -m starway_tpu_torch.bench --role
loopback`` with that arm's env overlay; the report is the per-pair B/A
metric ratio distribution, its p50, and a two-sided sign test on the
pair directions (stdlib ``math.comb`` -- no scipy), emitted as ONE JSON
line on stdout, integrity_bench-style.

Arms differ only by env (that is how every starway plane is armed:
STARWAY_INTEGRITY, STARWAY_FC_WINDOW, STARWAY_RAILS, STARWAY_NATIVE...),
so A-vs-B is expressed as env overlays::

    # integrity overhead, native engine (the integrity_bench scenario):
    python scripts/torch/paired_bench.py --pairs 5 --gate 0.70 \
        --b-env STARWAY_INTEGRITY=1

    # HEAD-vs-baseline engine comparison on the same checkout:
    python scripts/torch/paired_bench.py --a-env STARWAY_NATIVE=0 \
        --b-env STARWAY_NATIVE=1 --scenario streaming-duplex

    # extra bench flags ride through verbatim (= form: argparse would
    # otherwise eat the leading dashes):
    python scripts/torch/paired_bench.py --b-env STARWAY_FC_WINDOW=1M \
        --bench-arg=--stream-bytes --bench-arg=8M

A ``--a-env``/``--b-env`` of ``KEY=VAL`` sets, bare ``KEY`` unsets (so a
plane armed in the outer environment can be the *baseline* arm).  The
metric is read from the named scenario's report entry (default
``aggregate_gbps``); ``--gate R`` turns the run into a pass/fail check
on ratio p50 (exit 1 below it), otherwise exit 0 -- the nightly CI job
runs ungated and uploads the JSON line as an artifact for trend eyes.

The sign test answers "is B consistently on one side of A?" without a
variance model: under H0 (no difference) each pair's direction is a
fair coin, so ``p_sign`` is the two-sided binomial tail of the observed
split.  With the default 5 pairs the floor is p=0.0625 -- treat small-n
p-values as a smell, not a verdict, and rerun with --pairs 10+ before
believing a regression.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _apply_env(base: dict, specs: list) -> dict:
    env = dict(base)
    for spec in specs or ():
        if "=" in spec:
            key, val = spec.split("=", 1)
            env[key] = val
        else:
            env.pop(spec, None)
    return env


def _free_port() -> int:
    """A free loopback port, bound and released (the bench CLI's
    default port would collide with another run on the host)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_run(env: dict, args) -> float:
    """One fresh loopback bench run; returns the chosen scenario metric."""
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        out = f.name
    try:
        cmd = [sys.executable, "-m", "starway_tpu_torch.bench", "--role", "loopback",
               "--scenarios", args.scenario,
               "--port", str(_free_port()),
               "--output", out] + (args.bench_arg or [])
        subprocess.run(cmd, check=True, env=env, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL, timeout=args.run_timeout)
        with open(out) as fh:
            report = json.load(fh)
        sc = next(s for s in report["scenarios"] if s["name"] == args.scenario)
        v = sc["metrics"].get(args.metric)
        if v is None:
            raise SystemExit(
                f"paired_bench: scenario {args.scenario!r} has no metric "
                f"{args.metric!r}; available: {sorted(sc['metrics'])}")
        return float(v)
    finally:
        try:
            os.unlink(out)
        except OSError:
            pass


def _sign_test_p(ratios: list) -> float:
    """Two-sided sign test: P(split at least this lopsided | fair coin),
    ties (ratio exactly 1.0) discarded per the classical test."""
    n = sum(1 for r in ratios if r != 1.0)
    if n == 0:
        return 1.0
    k = sum(1 for r in ratios if r > 1.0)
    tail = min(k, n - k)
    p = 2.0 * sum(math.comb(n, i) for i in range(tail + 1)) / (2.0 ** n)
    return min(1.0, p)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=5,
                    help="interleaved A/B run pairs (default 5)")
    ap.add_argument("--scenario", default="streaming-duplex",
                    help="bench scenario to run (default streaming-duplex)")
    ap.add_argument("--metric", default="aggregate_gbps",
                    help="scenario metric to ratio (default aggregate_gbps; "
                         "e.g. median_rtt_us for pingpong-flag)")
    ap.add_argument("--higher-is-better", dest="higher", default=True,
                    action="store_true",
                    help="B/A ratio >= gate passes (default; throughput)")
    ap.add_argument("--lower-is-better", dest="higher", action="store_false",
                    help="invert the ratio as A/B so the gate still reads "
                         "'>= gate passes' (latency metrics)")
    ap.add_argument("--a-env", action="append", metavar="KEY[=VAL]",
                    help="baseline-arm env overlay (repeatable; bare KEY "
                         "unsets)")
    ap.add_argument("--b-env", action="append", metavar="KEY[=VAL]",
                    help="candidate-arm env overlay (repeatable; bare KEY "
                         "unsets)")
    ap.add_argument("--bench-arg", action="append", metavar="ARG",
                    help="extra argv passed to both arms' bench runs "
                         "(repeatable; use the = form for dashed values: "
                         "--bench-arg=--stream-bytes --bench-arg=8M)")
    ap.add_argument("--gate", type=float, default=None,
                    help="minimum acceptable ratio p50; omitted = report "
                         "only, always exit 0")
    ap.add_argument("--run-timeout", type=int, default=600,
                    help="per-run subprocess timeout seconds (default 600)")
    ap.add_argument("--json", help="also write the report here")
    args = ap.parse_args()

    base = dict(os.environ)
    env_a = _apply_env(base, args.a_env)
    env_b = _apply_env(base, args.b_env)

    a_vals, b_vals, ratios = [], [], []
    for i in range(args.pairs):
        a = _one_run(env_a, args)
        b = _one_run(env_b, args)
        a_vals.append(a)
        b_vals.append(b)
        if args.higher:
            ratios.append(b / a if a > 0 else 0.0)
        else:
            ratios.append(a / b if b > 0 else 0.0)
        print(f"[pair {i}] a={a:.4f}  b={b:.4f}  ratio={ratios[-1]:.4f}",
              file=sys.stderr, flush=True)

    report = {
        "scenario": args.scenario,
        "metric": args.metric,
        "higher_is_better": args.higher,
        "pairs": args.pairs,
        "a_env": args.a_env or [],
        "b_env": args.b_env or [],
        "a_values": [round(v, 6) for v in a_vals],
        "b_values": [round(v, 6) for v in b_vals],
        "ratios": [round(r, 4) for r in ratios],
        "a_p50": round(statistics.median(a_vals), 6),
        "b_p50": round(statistics.median(b_vals), 6),
        "ratio_p50": round(statistics.median(ratios), 4),
        "ratio_min": round(min(ratios), 4),
        "ratio_max": round(max(ratios), 4),
        "p_sign": round(_sign_test_p(ratios), 4),
        "gate": args.gate,
    }
    report["ok"] = args.gate is None or report["ratio_p50"] >= args.gate
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
