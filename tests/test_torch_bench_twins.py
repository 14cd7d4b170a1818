"""The port's twins of scripts/kernel_bench.py and
scripts/collect_baseline.py on the CPU, and the refusals of the five
script twins without a card.

Every ``--which`` name of the original (the keys of its ``REHEARSAL_KW``)
is a row of the twin, with rehearsal sizes of its own.  A rehearsal
(``STARWAY_BENCH_REHEARSAL=1``) of the twin's cheapest rows prints one
JSON row each through the plain versions, ``check`` one row for each of
the nine kernels within its tolerance (the plain version against itself
here: the rehearsal checks shapes and the row's code path, the card
checks numbers).  Without a card and without ``--device cpu`` (or the
rehearsal) every twin refuses: no row is printed and the exit code is
not 0.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TWINS = REPO / "scripts" / "torch"
NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="the refusal shows only without a card")


def _dict_keys(path: Path, name: str) -> list:
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == name):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"{path} has no {name}")


def _twin():
    spec = importlib.util.spec_from_file_location(
        "kernel_bench_twin", TWINS / "kernel_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_row_of_the_original_has_a_twin():
    original = _dict_keys(REPO / "scripts" / "kernel_bench.py",
                          "REHEARSAL_KW")
    twin = _twin()
    assert len(original) == 25
    assert list(twin.REHEARSAL_KW) == original
    assert list(twin.BENCHES) == _dict_keys(REPO / "scripts" /
                                            "kernel_bench.py", "BENCHES")
    assert set(twin.HEAVY) <= set(twin.BENCHES)


def _run(args, env=None, timeout=240):
    return subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, **(env or {})})


def test_rehearsal_prints_one_row_each():
    names = ["matmul", "flash_stock", "decode", "decode_lax", "decode_paged",
             "gemv_int8", "check"]
    r = _run([str(TWINS / "kernel_bench.py"), "--which", ",".join(names)],
             {"STARWAY_BENCH_REHEARSAL": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    rows = [json.loads(line) for line in r.stdout.splitlines()]
    assert [row["metric"] for row in rows[:6]] == [
        "matmul_ceiling_tflops", "flash_fwd_stock_tflops",
        "decode_ours_us_per_token", "decode_lax_us_per_token",
        "decode_paged_us_per_token", "gemv_int8_speedup"]
    checks = rows[6:]
    assert len(checks) == 9 and all(c["ok"] for c in checks), checks
    assert [c["detail"].split()[0] for c in checks] == [
        f"#{n}" for n in range(1, 10)]
    for row in rows:
        assert "error" not in row and row["device"] == "cpu", row
        assert row["card"].startswith("cpu"), row


def test_collect_baseline_on_the_cpu():
    """The five configurations at --quick sizes: the table's five rows and
    one JSON row naming them."""
    r = _run([str(TWINS / "collect_baseline.py"), "--device", "cpu",
              "--quick", "--json"])
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.strip().splitlines()
    table = [line for line in lines if line.startswith("| config ")]
    assert len(table) == 5, r.stdout
    row = json.loads(lines[-1])
    assert row["metric"] == "baseline_configs" and row["value"] == 5
    assert [name.split(":")[0] for name in row["configs"]] == [
        f"config {n}" for n in range(1, 6)]


@NO_CARD
@pytest.mark.parametrize("args", [
    ["kernel_bench.py", "--which", "matmul"],
    ["collect_baseline.py"],
    ["release_smoke.sh"],
], ids=["kernel_bench", "collect_baseline", "release_smoke"])
def test_twins_refuse_without_a_card(args, tmp_path):
    if args[0].endswith(".sh"):
        cmd = ["bash", str(TWINS / args[0]), str(tmp_path / "work")]
    else:
        cmd = [sys.executable, str(TWINS / args[0]), *args[1:]]
    env = {k: v for k, v in os.environ.items()
           if k not in ("STARWAY_BENCH_REHEARSAL", "REHEARSAL")}
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=120, env=env)
    assert r.returncode == 2, r.stdout + r.stderr
    assert "no CUDA device" in r.stderr
    assert '"metric"' not in r.stdout and "| config" not in r.stdout
    assert not (tmp_path / "work").exists()


@NO_CARD
def test_watchdog_waits_for_the_card(tmp_path):
    """Without a card the probe fails: one pass logs it, leaves no running
    marker and starts no queue."""
    watch = tmp_path / "watch"
    r = subprocess.run(["bash", str(TWINS / "gpu_watchdog.sh")], cwd=REPO,
                       capture_output=True, text=True, timeout=180,
                       env={**os.environ, "ONCE": "1",
                            "WATCH_DIR": str(watch)})
    assert r.returncode == 1, r.stdout + r.stderr
    assert "card not answering" in (watch / "gpu_watchdog.log").read_text()
    assert not (watch / "gpu_refresh_running").exists()
    assert not (watch / "gpu_alive").exists()
    assert not (watch / "onchip_rows.json").exists()
