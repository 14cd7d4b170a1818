"""The port's twins of the transport examples (examples/torch/pingpong.py,
cancel_on_close.py, throughput.py, all_to_all_p2p.py, device_pull.py) on
the CPU, at small sizes, in fresh processes that must end with nothing of
JAX imported: every byte received equals what was sent (the
twins check their sinks themselves), the cancelled receive gives the
JAX package's reason for the same pending receive, and the cross-process
payload arrives ``"staged"`` (CPU tensors ride staged frames; on the card
it must arrive ``"device"``, chip_smoke.py phase 28).  Without a card
and without ``--device cpu`` every twin refuses to run."""

import asyncio
import json
import re
from pathlib import Path

import numpy as np
import pytest

import starway_tpu
from torch_port_util import assert_refused, run_twins, twin_output

REPO = Path(__file__).resolve().parent.parent
TWINS = ["pingpong", "cancel_on_close", "throughput", "all_to_all_p2p",
         "device_pull"]


@pytest.fixture(scope="module")
def runs():
    """The five twins refusing without a card, then on the CPU at small
    sizes, one after another in one fresh process (pingpong's tcp run last:
    ``--tls`` sets the process's STARWAY_TLS)."""
    return run_twins(REPO, [(f"refuse-{name}", name, []) for name in TWINS] + [
        ("pingpong", "pingpong", ["--device", "cpu", "--max-size", "64K"]),
        ("cancel_on_close", "cancel_on_close", ["--device", "cpu"]),
        ("throughput", "throughput", ["--device", "cpu", "--count", "2",
                                      "--size", "1M"]),
        ("all_to_all_p2p", "all_to_all_p2p", ["--device", "cpu", "--ranks",
                                              "3", "--chunk", "4K"]),
        ("device_pull", "device_pull", ["--device", "cpu", "--size", "1M"]),
        ("pingpong-tcp", "pingpong", ["--device", "cpu", "--max-size", "64K",
                                      "--tls", "tcp"])])


@pytest.mark.parametrize("run", ["pingpong", "pingpong-tcp"],
                         ids=["inproc", "tcp"])
def test_pingpong_sweeps_exact_bytes(runs, run):
    rows = [line.split() for line in twin_output(runs, run).splitlines()[1:]]
    assert [int(r[0]) for r in rows] == [1, 16, 256, 4096, 65536]
    for r in rows:
        assert float(r[1]) > 0 and float(r[2]) > 0  # estimate, measured


def _jax_cancel_reason() -> str:
    """The JAX package's reason for the example's pending receive, cancelled
    by closing its client (examples/cancel_on_close.py's calls)."""

    async def run() -> str:
        server = starway_tpu.Server()
        server.listen("127.0.0.1", 0)
        port = json.loads(server.get_worker_address())["port"]
        client = starway_tpu.Client()
        await client.aconnect("127.0.0.1", port)
        sink = np.empty(1024, dtype=np.uint8)
        task = asyncio.ensure_future(
            client.arecv(sink, tag=999, tag_mask=(1 << 64) - 1))
        await asyncio.sleep(0.05)
        await client.aclose()
        try:
            await task
        except Exception as e:
            return str(e)
        finally:
            await server.aclose()
        raise AssertionError("the JAX package's receive completed")

    return asyncio.run(run())


def test_cancel_on_close_reason_matches_jax(runs):
    out = twin_output(runs, "cancel_on_close")
    m = re.search(r"^recv failed as expected: (.*)$", out, re.M)
    assert m, out
    want = _jax_cancel_reason()
    assert "cancel" in want
    assert m.group(1) == want
    assert out.splitlines()[-1] == "done"


def test_throughput_delivers_every_payload(runs):
    out = twin_output(runs, "throughput")
    assert re.fullmatch(r"2 x 1048576 bytes in [\d.]+s -> [\d.]+ GB/s "
                        r"aggregate", out.strip()), out


def test_all_to_all_routes_every_chunk(runs):
    out = twin_output(runs, "all_to_all_p2p")
    assert re.fullmatch(r"all-to-all ok: 3 ranks x 4096 B chunks, 0\.0 MB "
                        r"moved in [\d.]+ ms \([\d.]+ GB/s aggregate\)",
                        out.strip()), out


def test_device_pull_arrives_staged_on_the_cpu(runs):
    out = twin_output(runs, "device_pull")
    assert re.search(r"^received 1048576 bytes via 'staged' in [\d.]+s "
                     r"\(includes peer startup\) content_ok=True$", out,
                     re.M), out
    assert "CUDA IPC pulls on the receiver: 0" in out


@pytest.mark.parametrize("name", TWINS)
def test_twin_refuses_without_a_card(runs, name):
    """Without a card and without --device cpu the twin stops with a
    message: it never carries on on the CPU."""
    assert_refused(runs, f"refuse-{name}")
