"""Queue mechanics of scripts/torch/onchip_refresh.sh, the twin of
tests/test_rehearsal.py: the real script driven with a stub ``python`` on
PATH (its probes answer at once, its bench calls run a given body), so
that

* a row killed by its timeout still keeps every row it printed before,
  beside an error row naming the timeout;
* a rerun skips a row whose success row is recorded and reruns a row that
  has only an error row;
* ``ROWS=none`` runs nothing.

The full queue's CPU rehearsal (``REHEARSAL=1``, the real kernel bench at
its scaled sizes) runs out of band; its cheapest rows run in
tests/test_torch_bench_twins.py.
"""

import json
import os
import stat
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "torch" / "onchip_refresh.sh"


def _write_stub(tmp_path: Path, bench_body: str) -> dict:
    """A ``python`` first on PATH: probes (``-c``, ``-``) succeed at once;
    the bench's calls run ``bench_body``.  Returns the script's env."""
    stub = tmp_path / "bin" / "python"
    stub.parent.mkdir(parents=True, exist_ok=True)
    stub.write_text(f"""#!/bin/bash
case "$1" in
  -|-c) exit 0 ;;
esac
# scripts/torch/kernel_bench.py --which <row> ...
{bench_body}
""")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ)
    env["PATH"] = f"{stub.parent}:{env['PATH']}"
    env.pop("FORCE", None)
    env.pop("REHEARSAL", None)
    return env


def _rows(out: Path) -> list:
    return [json.loads(line) for line in out.read_text().splitlines()
            if line.strip()]


def test_timed_out_row_keeps_partial_rows(tmp_path):
    """Rows printed before the row's timeout kills it land in OUT, beside
    an rc=124 error row."""
    env = _write_stub(tmp_path, """
echo '{"metric": "decode_split1_us", "value": 10.0, "unit": "us"}'
echo '{"metric": "decode_split2_us", "value": 9.0, "unit": "us"}'
sleep 60   # the summary row never arrives
""")
    env["ROWS"] = "decode_tune"
    # The long rows take ROW_TIMEOUT_LARGE, so that a ROW_TIMEOUT meant for
    # the others never cuts their headroom.
    env["ROW_TIMEOUT_LARGE"] = "3"
    out = tmp_path / "rows.json"
    r = subprocess.run(["bash", str(SCRIPT), str(out)], env=env,
                       capture_output=True, text=True, timeout=120)
    rows = _rows(out)
    partial = [x for x in rows if x["metric"].startswith("decode_split")]
    errors = [x for x in rows if "error" in x]
    assert len(partial) == 2, (rows, r.stderr)
    assert len(errors) == 1 and "rc=124" in errors[0]["error"], rows


def test_resume_skips_success_reruns_error(tmp_path):
    """A recorded success row skips its section; an error row does not."""
    env = _write_stub(tmp_path, """
echo '{"metric": "decode_best_config", "value": 4, "unit": "splits"}'
""")
    env["ROWS"] = "decode_tune"
    out = tmp_path / "rows.json"
    out.write_text(
        '{"metric": "decode_best_config", "error": "rc=124 (old run)"}\n')
    r1 = subprocess.run(["bash", str(SCRIPT), str(out)], env=env,
                        capture_output=True, text=True, timeout=120)
    rows = _rows(out)
    assert any("error" not in x and x["metric"] == "decode_best_config"
               for x in rows), (rows, r1.stderr)

    n_before = len(rows)
    r2 = subprocess.run(["bash", str(SCRIPT), str(out)], env=env,
                        capture_output=True, text=True, timeout=120)
    assert len(_rows(out)) == n_before, r2.stderr
    assert "already measured; skip" in r2.stderr


def test_rows_filter_excludes_everything_else(tmp_path):
    """ROWS=none runs no section at all."""
    env = _write_stub(tmp_path, "echo should-not-run >&2; exit 1")
    env["ROWS"] = "none"
    out = tmp_path / "rows.json"
    r = subprocess.run(["bash", str(SCRIPT), str(out)], env=env,
                       capture_output=True, text=True, timeout=60)
    assert _rows(out) == [], r.stderr
    assert "should-not-run" not in r.stderr
