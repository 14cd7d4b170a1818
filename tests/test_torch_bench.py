"""The port's bench CLI, its seven scenarios, the telemetry viewer and the
trace export, on the CPU.

``python -m starway_tpu_torch.bench`` is a copy of the JAX package's bench
CLI (held line for line by tests/test_torch_copies.py) whose device
payloads are tensors: on ``cuda:0``, or on the CPU only when asked
(``--device cpu``).  Here: every scenario in loopback at small sizes with
host payloads and with CPU-tensor payloads, the JSON report's keys against
the JAX CLI's, the two CLIs driving each other over tcp (the control
frames are JSON on tags), the refusal of ``--payload device`` and of the
headline without a card, and the twins of tests/test_trace.py's export
cases and tests/test_telemetry.py's ``metrics`` cases on the port's
copies."""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import starway_tpu.bench as jax_bench
from starway_tpu_torch import (Client, DeviceBuffer, Server, bench, metrics,
                               trace)
from starway_tpu_torch.benchmarks import list_scenarios, scenarios
from starway_tpu_torch.core import swtrace, telemetry

REPO = Path(__file__).resolve().parent.parent
ADDR = "127.0.0.1"
MASK = (1 << 64) - 1

SMALL = ["--large-bytes", "64K", "--large-iterations", "2",
         "--large-warmup", "1", "--small-bytes", "64",
         "--small-iterations", "2", "--small-warmup", "1",
         "--small-concurrency", "4", "--flag-iterations", "10",
         "--flag-warmup", "2", "--stream-bytes", "64K",
         "--stream-iterations", "4", "--stream-warmup", "1",
         "--striped-bytes", "64K", "--striped-iterations", "2",
         "--striped-warmup", "1", "--flood-bytes", "4K",
         "--flood-messages", "8", "--flood-iterations", "1",
         "--reshard-bytes", "64K", "--reshard-blocks", "4",
         "--reshard-iterations", "1", "--reshard-warmup", "0"]

# Keys the CLI may write into the environment: registered so that
# monkeypatch restores them after each in-process run.
CLI_ENV = ["STARWAY_TLS", "STARWAY_RAILS", "STARWAY_STRIPE_THRESHOLD",
           "STARWAY_FC_WINDOW", "STARWAY_IOURING", "STARWAY_ZEROCOPY",
           "STARWAY_BUSYPOLL_US", "STARWAY_TRACE", "STARWAY_METRICS_PATH",
           "STARWAY_METRICS_INTERVAL", "STARWAY_BENCH_CPU"]


@pytest.fixture
def cli_env(monkeypatch):
    for key in CLI_ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    monkeypatch.setattr(scenarios, "PAYLOAD_DEVICE", scenarios.PAYLOAD_DEVICE)
    return monkeypatch


def _run(port, tmp_path, *extra, module=bench, name="report.json") -> dict:
    out = tmp_path / name
    rc = module.main(["--role", "loopback", "--port", str(port),
                      "--tls", "tcp", *SMALL, "--output", str(out),
                      *extra])
    assert rc == 0
    return json.loads(out.read_text())


def test_the_seven_scenarios():
    assert list_scenarios() == ["large-array", "small-messages",
                                "pingpong-flag", "streaming-duplex",
                                "striped", "flooded", "reshard"]


@pytest.mark.parametrize("payload", ["host", "device"])
def test_loopback_runs_every_scenario(port, tmp_path, cli_env, payload):
    extra = ["--payload", payload] + (["--device", "cpu"]
                                      if payload == "device" else [])
    report = _run(port, tmp_path, *extra)
    got = [r["name"] for r in report["scenarios"]]
    assert got == list_scenarios()
    for r in report["scenarios"]:
        assert r["metrics"], r["name"]
        if r["name"] in ("large-array", "streaming-duplex"):
            assert r["config"]["payload"] == payload
    assert report["transport"] == "tcp" and report["levers"] == []
    if payload == "device":
        assert scenarios.PAYLOAD_DEVICE == "cpu"


def test_report_keys_match_the_jax_cli(port, port2, tmp_path, cli_env):
    def keys(report):
        return (sorted(report),
                [(r["name"], sorted(r), sorted(r["metrics"]))
                 for r in report["scenarios"]])

    flags = ["--scenarios", "pingpong-flag", "large-array", "reshard",
             "--store-trace"]
    ours = _run(port, tmp_path, *flags)
    theirs = _run(port2, tmp_path, *flags, module=jax_bench, name="jax.json")
    assert keys(ours) == keys(theirs)


def test_device_payload_is_a_tensor_where_asked(cli_env):
    cli_env.setattr(scenarios, "PAYLOAD_DEVICE", "cpu")
    t = scenarios._make_payload(16, 0x15A, "device")
    assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8
    assert t.device.type == "cpu" and int(t[0]) == 0x5A
    sink = scenarios._make_sink(16, "device")
    assert isinstance(sink, DeviceBuffer) and sink.device.type == "cpu"
    assert isinstance(scenarios._make_payload(16, 1, "host"), np.ndarray)


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_the_two_clis_drive_each_other(port, monkeypatch, cli_env,
                                       server_pkg):
    """A client of one package drives a server of the other over tcp:
    the control frames (JSON on CONTROL_TAG / READY_TAG / DONE_TAG) and
    the scenarios' data tags are one protocol."""
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    srv_mod, cli_mod = ((bench, jax_bench) if server_pkg == "port"
                        else (jax_bench, bench))
    common = ["--port", str(port), *SMALL, "--scenarios", "pingpong-flag",
              "small-messages", "large-array", "streaming-duplex"]
    s_args = srv_mod.build_parser().parse_args(["--role", "server",
                                                "--addr", ADDR, *common])
    c_args = cli_mod.build_parser().parse_args(["--role", "client",
                                                *common])

    async def both():
        server = asyncio.create_task(srv_mod.run_server(s_args))
        await asyncio.sleep(0.1)
        results = await asyncio.wait_for(cli_mod.run_client(c_args), 120)
        await asyncio.wait_for(server, 30)
        return results

    results = asyncio.run(both())
    assert [r.name for r in results] == ["pingpong-flag", "small-messages",
                                         "large-array", "streaming-duplex"]
    assert all(v >= 0 for r in results for v in r.metrics.values()
               if isinstance(v, (int, float)))


def _cli(args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "STARWAY_BENCH_CPU"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a GPU is present: the default device is valid")
def test_entry_points_refuse_the_cpu_unless_asked(port):
    r = _cli(["starway_tpu_torch.headline"])
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr
    r = _cli(["starway_tpu_torch.bench", "--role", "loopback", "--port",
              str(port), "--payload", "device", "--scenarios",
              "large-array"])
    assert r.returncode != 0 and "Benchmark Results" not in r.stdout
    assert "needs a CUDA device" in r.stderr
    for args, env in ((["--device", "cpu"], None),
                      ([], {"STARWAY_BENCH_CPU": "1"})):
        r = _cli(["starway_tpu_torch.headline", *args], env)
        assert r.returncode == 0, r.stderr[-2000:]
        line = json.loads(r.stdout.strip().splitlines()[-1])
        assert line["fallback"] is True and line["value"] > 0


def test_headline_on_a_card_is_not_a_fallback(monkeypatch):
    from starway_tpu_torch import headline

    monkeypatch.delenv("STARWAY_BENCH_CPU", raising=False)
    assert not headline.cpu_requested()
    assert headline.cpu_requested("cpu")
    monkeypatch.setenv("STARWAY_BENCH_CPU", "1")
    assert headline.cpu_requested()
    monkeypatch.setenv("STARWAY_BUSYPOLL_US", "50")
    assert bench.active_levers() == ["busypoll:50"]


# ------------------------------- twins of tests/test_trace.py's export cases


def _trace_env(monkeypatch):
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    monkeypatch.setenv("STARWAY_DEVPULL", "0")
    monkeypatch.setenv("STARWAY_TRACE", "1")
    monkeypatch.delenv("STARWAY_FLIGHT_DIR", raising=False)
    swtrace.reset()


async def _pair(port):
    server = Server()
    client = Client()
    server.listen(ADDR, port)
    await client.aconnect(ADDR, port)
    for _ in range(200):
        if server.list_clients():
            break
        await asyncio.sleep(0.005)
    return server, client


async def _one_message(port, nbytes: int, tag: int):
    server, client = await _pair(port)
    try:
        sink = np.empty(nbytes, dtype=np.uint8)
        fut = server.arecv(sink, tag, MASK)
        await asyncio.sleep(0.05)
        await client.asend(np.ones(nbytes, dtype=np.uint8), tag)
        await fut
        await client.aflush()
    finally:
        await client.aclose()
        await server.aclose()


@pytest.mark.asyncio
async def test_chrome_export_spans_per_conn(port, monkeypatch, tmp_path):
    _trace_env(monkeypatch)
    await _one_message(port, 2048, 3)
    dumps = swtrace.dump_all()
    assert len(dumps) >= 2, [d["worker"] for d in dumps]
    doc = json.loads(trace.write_chrome(dumps, tmp_path / "t.json")
                     .read_text())
    events = doc["traceEvents"]
    assert events
    for e in events:
        assert {"name", "ph", "pid", "tid"} <= set(e), e
        if e["ph"] != "M":
            assert "ts" in e and e["ts"] >= 0, e
        if e["ph"] == "X":
            assert e["dur"] >= 0, e
    spans = [e for e in events if e["ph"] == "X"]
    assert any(e["name"].startswith("send tag=") for e in spans), spans
    assert any(e["name"].startswith("recv tag=") for e in spans), spans
    assert any(e["tid"] != 0 for e in spans
               if e["name"].startswith("send tag=")), spans
    dump_file = tmp_path / "ring.json"
    dump_file.write_text(json.dumps(
        {"worker": "w", "events": [list(ev) for ev in dumps[0]["events"]]}))
    assert trace.main([str(dump_file), "-o", str(tmp_path / "cli.json")]) == 0
    assert json.loads((tmp_path / "cli.json").read_text())["traceEvents"]


@pytest.mark.asyncio
async def test_merge_clock_alignment_sign_convention():
    tc = "deadbeef00000000"
    dump_b = {"pid": 222, "workers": [{"worker": "B", "events": [
        [12.0, "e2e", 1, 7, 4096, tc + ":tx", 0.0],
        [11.5, "clock_sample", 0, 7, 0, f"{tc}:-2000000:10", 0.0],
    ]}]}
    dump_a = {"pid": 111, "workers": [{"worker": "A", "events": [
        [10.000050, "e2e", 1, 3, 4096, tc + ":rx", 0.0],
    ]}]}
    doc = trace.merge_chrome([("a", dump_a), ("b", dump_b)])
    assert doc["swscope"]["pairs"] == 1
    assert doc["swscope"]["clock_edges"][0]["offset_us"] == -2000000
    assert abs(doc["swscope"]["wire_us"]["p50"] - 50.0) < 1.0
    s = [e for e in doc["traceEvents"] if e.get("ph") == "s"]
    f = [e for e in doc["traceEvents"] if e.get("ph") == "f"]
    assert len(s) == len(f) == 1
    assert abs((f[0]["ts"] - s[0]["ts"]) - 50.0) < 1.0


@pytest.mark.asyncio
async def test_merge_ring_dump_cli_single_mode(tmp_path, port, monkeypatch):
    _trace_env(monkeypatch)
    await _one_message(port, 1024, 4)
    dump = swtrace.write_ring_dump(tmp_path / "ring.json")
    assert trace.main([str(dump), "-o", str(tmp_path / "chrome.json")]) == 0
    doc = json.loads((tmp_path / "chrome.json").read_text())
    assert any(e["ph"] == "X" for e in doc["traceEvents"])


@pytest.mark.asyncio
async def test_device_payload_stage_spans_in_trace(port, monkeypatch):
    """Staged tensor transfers record their stage spans (D2H "stage" on
    the sender, H2D "place" on the receiver) in the owning worker's
    ring."""
    _trace_env(monkeypatch)
    monkeypatch.setenv("STARWAY_CHUNK", str(64 * 1024))
    server, client = await _pair(port)
    try:
        src = torch.arange(64 * 1024, dtype=torch.float32)
        sink = DeviceBuffer((64 * 1024,), torch.float32, device="cpu")
        fut = server.arecv(sink, 21, MASK)
        await asyncio.sleep(0.05)
        await client.asend(src, 21)
        await fut
        cli = {e[5] for e in client._client.trace_events()
               if e[1] == swtrace.EV_STAGE}
        srv = {e[5] for e in server._server.trace_events()
               if e[1] == swtrace.EV_STAGE}
        assert "stage" in cli, cli
        assert "place" in srv, srv
        assert torch.equal(sink.array, src)
    finally:
        await client.aclose()
        await server.aclose()


# ------------------------- twins of tests/test_telemetry.py's metrics cases


@pytest.mark.asyncio
async def test_jsonl_emitter_and_metrics_cli(port, monkeypatch, tmp_path,
                                             capsys):
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    monkeypatch.setenv("STARWAY_DEVPULL", "0")
    monkeypatch.delenv("STARWAY_TRACE", raising=False)
    monkeypatch.delenv("STARWAY_METRICS_ADDR", raising=False)
    monkeypatch.setenv("STARWAY_METRICS_INTERVAL", "3600")
    out = tmp_path / "samples.jsonl"
    monkeypatch.setenv("STARWAY_METRICS_PATH", str(out))
    swtrace.reset()
    telemetry.reset()
    server, client = await _pair(port)
    try:
        sink = np.empty(4096, dtype=np.uint8)
        fut = server.arecv(sink, 7, MASK)
        await asyncio.sleep(0.05)
        telemetry.sample_now()
        await client.asend(np.ones(4096, dtype=np.uint8), 7)
        await fut
        await client.aflush()
        telemetry.sample_now()
    finally:
        await client.aclose()
        await server.aclose()
        telemetry.reset()
    lines = [json.loads(l) for l in out.read_text().splitlines() if l.strip()]
    assert len(lines) == 2
    assert [s["mono"] for s in lines] == sorted(s["mono"] for s in lines)
    sender = next(wk for lbl, wk in lines[-1]["workers"].items()
                  if lbl.startswith("client-"))
    assert sorted(sender["hists"]) == sorted(swtrace.HIST_NAMES)
    assert sender["hists"]["msg_bytes"]["p50"] >= 4095

    assert metrics.main([str(out), "--once"]) == 0
    printed = capsys.readouterr().out
    assert "2 sample(s)" in printed
    assert "client-" in printed and "server-" in printed
    assert "msg_bytes: n=" in printed and "p999=" in printed
    assert metrics.main([str(tmp_path / "absent.jsonl"), "--once"]) == 1


def test_bench_metrics_file_renders_with_metrics_once(port, tmp_path,
                                                      capsys):
    out = tmp_path / "bench_metrics.jsonl"
    report_path = tmp_path / "bench_report.json"
    r = _cli(["starway_tpu_torch.bench", "--role", "loopback", "--port",
              str(port), "--scenarios", "pingpong-flag",
              "--flag-iterations", "8", "--flag-warmup", "2", "--metrics",
              str(out), "--output", str(report_path)],
             {"STARWAY_METRICS_PATH": "", "STARWAY_METRICS_INTERVAL": "0.25"})
    assert r.returncode == 0, r.stderr[-2000:]
    report = json.loads(report_path.read_text())
    assert report["metrics"] == str(out) and "telemetry" in report
    lines = [json.loads(l) for l in out.read_text().splitlines()
             if l.strip()]
    assert lines and all("workers" in s and "mono" in s for s in lines)
    assert metrics.main([str(out), "--once"]) == 0
    assert f"{len(lines)} sample(s)" in capsys.readouterr().out
