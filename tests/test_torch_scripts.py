"""The port's copies of the transport's soak and bench scripts
(scripts/torch/session_chaos.py, paired_bench.py, integrity_bench.py;
tests/test_torch_copies.py holds them to their originals): each runs on
the port and prints the original's one JSON result line.  Short soaks:
the session soak on both engines (the server on each), the corruption
soak, and the session soak under the protocol monitor
(``STARWAY_MONITOR=1``: no violation); one pair of each bench's arms
(``python -m starway_tpu_torch.bench``).  The long overload soak is the
twin of tests/test_fc.py's ``test_overload_soak_script`` and, like it,
slow."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts" / "torch"


def run_script(name: str, *args: str, env=None, timeout: int = 120) -> dict:
    """``scripts/torch/<name>.py *args`` from the repo root; its JSON result
    line, after an exit of 0."""
    r = subprocess.run([sys.executable, str(SCRIPTS / f"{name}.py"), *args],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=REPO, env=dict(os.environ, **(env or {})))
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("server,client", [("py", "py"), ("native", "py")])
def test_session_chaos_soak(server, client):
    if "native" in (server, client):
        from starway_tpu_torch.core import native

        if not native.available():
            pytest.skip("native engine unavailable (no toolchain)")
    report = run_script("session_chaos", "--cycles", "2", "--n", "5",
                        "--server-engine", server, "--client-engine", client)
    assert report["ok"] is True
    assert (report["server_engine"], report["client_engine"]) == (server,
                                                                  client)
    assert report["recvs_completed"] == report["ops"] == 10
    assert report["sessions_resumed"] >= 1
    assert report["ops_failed"] == 0 and report["stall_alerts"] == 0


def test_session_chaos_corrupt_soak():
    report = run_script("session_chaos", "--cycles", "2", "--n", "5",
                        "--corrupt")
    assert report["ok"] is True and report["mode"] == "corrupt"
    assert report["recvs_completed"] == report["ops"] == 12
    assert report["csum_fail"] >= 1 and report["chunk_retx"] >= 1
    assert report["flips_injected"] >= 1


def test_session_chaos_under_the_monitor():
    """STARWAY_MONITOR=1: every traced ring replays through the port's
    protocol monitor (core/monitor.py) with no violation."""
    report = run_script("session_chaos", "--cycles", "2", "--n", "5",
                        env={"STARWAY_MONITOR": "1"})
    assert report["ok"] is True
    assert report["monitor_violations"] == 0
    assert report["monitor_witnessed"] > 0


def test_paired_bench_one_pair():
    report = run_script("paired_bench", "--pairs", "1", timeout=300)
    assert set(report) == {
        "scenario", "metric", "higher_is_better", "pairs", "a_env", "b_env",
        "a_values", "b_values", "ratios", "a_p50", "b_p50", "ratio_p50",
        "ratio_min", "ratio_max", "p_sign", "gate", "ok"}
    assert report["scenario"] == "streaming-duplex" and report["pairs"] == 1
    assert report["a_values"][0] > 0 and report["b_values"][0] > 0


def test_integrity_bench_one_pair():
    """One OFF/ON pair; the gate is opened (0) so that the host's load
    cannot fail a check of the script's run and its report."""
    from starway_tpu_torch.core import native

    if not native.available():
        pytest.skip("native engine unavailable (no toolchain)")
    report = run_script("integrity_bench", "--pairs", "1", "--gate", "0",
                        timeout=300)
    assert set(report) == {
        "engine", "tls", "stream_bytes", "pairs", "off_gbps", "on_gbps",
        "ratios", "off_gbps_p50", "on_gbps_p50", "ratio_p50", "ratio_min",
        "ratio_max", "gate", "ok"}
    assert report["ok"] is True and report["engine"] == "native"
    assert report["off_gbps"][0] > 0 and report["on_gbps"][0] > 0


@pytest.mark.slow
def test_overload_soak_script():
    """The many-client overload soak (scripts/torch/session_chaos.py
    --overload) passes its own oracle end to end."""
    report = run_script("session_chaos", "--overload", "--clients", "10",
                        "--cycles", "3", "--n", "10", timeout=600)
    assert report["ok"] and report["peak_unexp_bytes"] <= report[
        "unexp_bound"]
