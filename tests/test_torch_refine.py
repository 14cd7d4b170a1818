"""The runtime protocol monitor (``STARWAY_MONITOR=1``) on the port, the
twin of the monitor-plane tests of tests/test_refine.py.

``starway_tpu_torch/core/monitor.py`` compiles its automaton from the
port's own copy of the analysis core (``starway_tpu_torch/analysis``),
which extracts the protocol machine from the port's engine sources,
its copy of the C++ engine (``starway_tpu_torch/native/sw_engine.cpp``)
included.  Here: the compiled model equals the JAX package's (the port's
``cudaipc`` HELLO key adds no transition), real rings of both engines
replay clean, device payloads (pulled on both engines) included, a
doctored divergence fails hard with a flight dump,
worker retirement checks automatically, and the monitor stays dark when
off."""

from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest
import torch

from starway_tpu_torch import Client, DeviceBuffer, Server
from starway_tpu_torch.analysis import refine
from starway_tpu_torch.core import monitor, swtrace

ADDR = "127.0.0.1"


def _native_available() -> bool:
    from starway_tpu_torch.core import native

    return native.available()


def _env(monkeypatch, *, native: bool, proto: bool = True,
         monitor_on: bool = False, flight=None, devpull: bool = False):
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "1" if native else "0")
    monkeypatch.setenv("STARWAY_DEVPULL", "1" if devpull else "0")
    monkeypatch.setenv("STARWAY_DEVPULL_MIN", "1")
    for name, on in (("STARWAY_PROTO_TRACE", proto),
                     ("STARWAY_MONITOR", monitor_on)):
        if on:
            monkeypatch.setenv(name, "1")
        else:
            monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("STARWAY_TRACE", raising=False)
    if flight is not None:
        monkeypatch.setenv("STARWAY_FLIGHT_DIR", str(flight))
    else:
        monkeypatch.delenv("STARWAY_FLIGHT_DIR", raising=False)
    swtrace.reset()
    monitor.reset()


async def _exchange(port, n=4, device=False, transport=None):
    """n tagged messages client -> server and a flush; with ``device``,
    CPU tensors into DeviceBuffer sinks (the device plane's path), each
    of which must land by ``transport`` when given."""
    server = Server()
    client = Client()
    server.listen(ADDR, port)
    await client.aconnect(ADDR, port)
    if device:
        sinks = [DeviceBuffer((256,), torch.uint8, device="cpu")
                 for _ in range(n)]
        payloads = [torch.full((256,), i + 1, dtype=torch.uint8)
                    for i in range(n)]
    else:
        sinks = [np.zeros(256, dtype=np.uint8) for _ in range(n)]
        payloads = [np.full(256, i + 1, dtype=np.uint8) for i in range(n)]
    recvs = [server.arecv(sinks[i], 100 + i, (1 << 64) - 1)
             for i in range(n)]
    await asyncio.gather(*(client.asend(p, 100 + i)
                           for i, p in enumerate(payloads)))
    await client.aflush()
    await asyncio.gather(*recvs)
    for i, sink in enumerate(sinks):
        got = sink.array if device else torch.from_numpy(sink)
        assert bool((got == i + 1).all())
        if transport is not None:
            assert sink.last_transport == transport
    await client.aclose()
    await server.aclose()


def test_port_monitor_compiles_the_reference_model():
    """The automaton compiled from the port's sources has exactly the JAX
    package's transitions, with no compile problem: the port's engine
    copies (and their cudaipc HELLO key) conform to one protocol model."""
    from starway_tpu.analysis import refine as jax_refine

    mon, problems = refine.compile_monitor(runtime=True)
    ref, ref_problems = jax_refine.compile_monitor(runtime=True)
    assert problems == [] and ref_problems == []
    assert mon is not None and len(mon.transitions) >= 20
    assert {k: set(v) for k, v in mon.transitions.items()} == {
        k: set(v) for k, v in ref.transitions.items()}


def test_port_gate_pass_is_clean_on_the_port_tree():
    """refine's static pass over the port's tree: the frame-name
    vocabulary of the port's frames.py against the C++ engine, the event
    corpus replayed, every transition witnessed -- no finding."""
    root = refine.Path(__file__).resolve().parent.parent
    assert [f.render() for f in refine.run(root)] == []


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
async def test_real_rings_replay_clean(port, monkeypatch, engine, device):
    """Both engines' rings, with host and device payloads, replay through
    the port's monitor without divergence."""
    if engine == "native" and not _native_available():
        pytest.skip("native engine not built")
    _env(monkeypatch, native=engine == "native")
    await _exchange(port, device=device)
    dumps = swtrace.dump_all()
    assert any(e[1] == swtrace.EV_PROTO for d in dumps for e in d["events"])
    mon, problems = refine.compile_monitor()
    assert mon is not None, problems
    witnessed = set()
    for d in dumps:
        viols, seen = mon.replay(d["events"], label=d["worker"])
        assert viols == [], [v.render() for v in viols]
        witnessed |= seen
    for key in (("hello-sent", "HELLO_ACK"), ("estab", "HELLO"),
                ("estab", "DATA"), ("estab", "FLUSH"),
                ("estab", "FLUSH_ACK")):
        assert key in witnessed, (key, sorted(witnessed))


# ------------------------------------------------- STARWAY_MONITOR plane


@pytest.mark.parametrize("devpull", [False, True], ids=["staged", "pull"])
async def test_monitor_mode_clean_run(port, monkeypatch, devpull):
    """STARWAY_MONITOR=1: workers are checked in-process at retirement;
    a conforming run (device payloads staged, or pulled under the
    negotiated cudaipc key) records no violation and real coverage."""
    _env(monkeypatch, native=False, monitor_on=True, devpull=devpull)
    await _exchange(port, device=True,
                    transport="device" if devpull else "staged")
    monitor.check_all()
    assert monitor.violations() == []
    # A pulled payload rides a DEVPULL descriptor frame instead of DATA.
    assert ("estab", "DEVPULL" if devpull else "DATA") in monitor.witnessed()
    monitor.assert_clean()


async def test_monitor_mode_clean_run_native_pull(port, monkeypatch):
    """The same on the C++ engine, whose copy negotiates cudaipc: pulled
    payloads ride DEVPULL frames, and its ring replays clean."""
    if not _native_available():
        pytest.skip("native engine not built")
    _env(monkeypatch, native=True, monitor_on=True, devpull=True)
    await _exchange(port, device=True, transport="device")
    monitor.check_all()
    assert monitor.violations() == []
    assert ("estab", "DEVPULL") in monitor.witnessed()
    monitor.assert_clean()


async def test_monitor_violation_fails_hard_and_dumps_flight(
        port, monkeypatch, tmp_path):
    """A divergent ring recorded under STARWAY_MONITOR turns into a hard
    failure with the flight recorder dumped alongside."""
    flight = tmp_path / "flight"
    _env(monkeypatch, native=False, monitor_on=True, flight=flight)
    server = Server()
    client = Client()
    server.listen(ADDR, port)
    await client.aconnect(ADDR, port)
    await client.asend(np.zeros(64, dtype=np.uint8), 1)
    await client.aflush()
    worker = server._server
    worker._trace.rec(swtrace.EV_PROTO, 0, 424242, 0, "st:estab")
    worker._trace.rec(swtrace.EV_PROTO, 0, 424242, 0, "resume")
    viols = monitor.check_worker(worker)
    assert viols and viols[0].cls == "no-transition"
    with pytest.raises(AssertionError, match="no-transition"):
        monitor.assert_clean()
    dumps = list(flight.glob("flight-*.json"))
    assert dumps, "monitor violation must dump the flight recorder"
    payload = json.loads(dumps[0].read_text())
    assert payload["trigger"] == "monitor-violation"
    await client.aclose()
    await server.aclose()


async def test_monitor_checks_at_worker_retirement(port, monkeypatch):
    """swtrace.retire (worker close) is an automatic checkpoint: a
    divergence in the ring is recorded without anyone calling
    check_all."""
    _env(monkeypatch, native=False, monitor_on=True)
    server = Server()
    client = Client()
    server.listen(ADDR, port)
    await client.aconnect(ADDR, port)
    await client.asend(np.zeros(64, dtype=np.uint8), 1)
    await client.aflush()
    client._client._trace.rec(swtrace.EV_PROTO, 0, 979797, 0, "st:estab")
    client._client._trace.rec(swtrace.EV_PROTO, 0, 979797, 0, "lost")
    client._client._trace.rec(swtrace.EV_PROTO, 0, 979797, 0, "lost")
    await client.aclose()
    await server.aclose()
    assert monitor.violations(), "retirement checkpoint missed the ring"
    assert monitor.violations()[0].cls == "no-transition"


def test_monitor_off_is_dark(monkeypatch):
    monkeypatch.delenv("STARWAY_MONITOR", raising=False)
    monkeypatch.delenv("STARWAY_PROTO_TRACE", raising=False)
    monitor.reset()
    assert not monitor.active()
    assert monitor.check_all() == []
    monitor.assert_clean()
