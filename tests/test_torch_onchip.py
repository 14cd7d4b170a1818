"""The kernel bench twin on the card, the twin of tests/test_onchip.py:
``scripts/torch/kernel_bench.py --which check`` holds the nine kernels
against their plain versions on the card, and the ``serve`` row's
``generate()`` throughput is recorded.  Both run in a child process (the
kernels build there) and need an NVIDIA GPU:

    STARWAY_TEST_REAL_TPU=1 python -m pytest -m cuda tests/test_torch_onchip.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

BENCH = Path(__file__).resolve().parent.parent / "scripts" / "torch" / \
    "kernel_bench.py"


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def _kernel_bench(which: str, timeout: int = 900):
    out = subprocess.run([sys.executable, str(BENCH), "--which", which],
                         capture_output=True, text=True, timeout=timeout)
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    return out, rows


def test_onchip_kernel_numerics():
    """One row for each of the nine kernels, every one within its
    tolerance."""
    out, rows = _kernel_bench("check")
    assert out.returncode == 0, f"on-card checks failed:\n{out.stdout}\n" \
                                f"{out.stderr}"
    assert len(rows) == 9 and all(r["ok"] for r in rows), rows
    assert all(r["card"] and r["device"] == "cuda:0" for r in rows), rows


def test_onchip_serve_throughput():
    """``generate()`` decode tokens/s of the 8-layer d1024 model: a loose
    floor that catches the serving path falling off a cliff (a host sync
    per layer, a lost kernel), not a percentage."""
    out, rows = _kernel_bench("serve", timeout=1200)
    assert rows and "error" not in rows[-1], f"{rows}\n{out.stderr}"
    row = rows[-1]
    assert row["metric"] == "serve_llama_b1_tokens_per_s"
    assert row["value"] > 100, row
