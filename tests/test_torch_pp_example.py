"""Smoke run of examples/torch/pp_training.py, the port's twin of
examples/pp_training.py: plain and interleaved 1F1B train the same tiny
model on the CPU for 2 steps (over pp, and over pp x dp) with matching,
falling losses, in a process that imports nothing of JAX."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "examples" / "torch" / "pp_training.py"


@pytest.mark.parametrize("extra", [[], ["--dp"]], ids=["pp", "pp-dp"])
def test_pp_training_example_runs_on_the_cpu(extra):
    code = ("import runpy, sys\n"
            f"sys.argv = [{str(SCRIPT)!r}, '--device', 'cpu', '--steps', "
            f"'2'] + {extra!r}\n"
            f"runpy.run_path({str(SCRIPT)!r}, run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'starway_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "plain 1F1B" in r.stdout and "interleaved x2" in r.stdout
    assert "matching losses" in r.stdout
    mesh = "{'pp': 2, 'dp': 2}" if extra else "{'pp': 2}"
    assert f"mesh={mesh}" in r.stdout
