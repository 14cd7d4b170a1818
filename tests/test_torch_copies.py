"""The port's copies of the JAX package's host runtime stay copies.

``starway_tpu_torch`` keeps its own copy of every module of the JAX
package's transport that imports no JAX (``errors``, ``config``, ``perf``,
``api`` and all of ``core/``), of its bench CLI and scenarios (``bench``,
``benchmarks/``, whose device payloads become tensors), of its telemetry
viewer and trace export (``metrics``, ``trace``), of the reshard
planner and executor (``reshard/`` but ``api.py``, which imports JAX), of
the analysis core that the runtime protocol monitor compiles
(``analysis/{base,py_model,protomodel,refine}.py`` and
``refine_corpus.txt``) and of the fault proxy (``testing/``).  Each equals
its original after the package rename, except in the named edits below,
so the proofs that the JAX package's analysis gate makes of the originals
(it scans ``starway_tpu/`` only) hold for the copies too.  The rename
leaves references to the gate itself (``starway_tpu.analysis``) pointing
at the JAX package, which owns it; it turns the source paths that the
analysis copies read (``starway_tpu/core/...``) into the port's, which
``test_analysis_reads_the_ports_sources`` pins site by site."""

import difflib
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "starway_tpu"
PORT_PKG = REPO / "starway_tpu_torch"
RENAME = re.compile(r"\bstarway_tpu\b(?!\.analysis)")

CORE = sorted(p.name for p in (JAX_PKG / "core").glob("*.py"))

# file -> [(original lines after the rename, the port's lines)]
EDITS = {
    'config.py': [
        (# config.py:13-14
         '    path), ``ici`` / ``dcn`` (device-plane selectors used by the device\n'
         '    layer).  Default: all enabled.\n',
         "    path), ``ici`` / ``dcn`` (accepted for the JAX package's device\n"
         '    plane; the torch device plane selects nothing by them).  Default:\n'
         '    all enabled.\n'),
    ],
    'perf.py': [
        (# perf.py:5-8
         'as seconds-to-transfer-msg_size.  The TPU build replaces it with an explicit\n'
         'alpha-beta link model per transport (SURVEY.md section 5 "Tracing /\n'
         'profiling": "keep an evaluate_perf analogue backed by an ICI/DCN link\n'
         'model")::\n',
         'as seconds-to-transfer-msg_size.  This package replaces it with an\n'
         'explicit alpha-beta link model per transport::\n'),
        (# perf.py:12-14
         'Default betas reflect TPU v5e-class hardware (ICI ~45 GB/s per link\n'
         'direction, DCN ~12.5 GB/s per host NIC) and measured host-loopback numbers;\n'
         'calibrate with :func:`calibrate` from observed samples.\n',
         "The host classes (``inproc``, ``sm``, ``tcp``) keep the JAX package's\n"
         "host-loopback priors.  The card's device classes -- ``h2d`` and ``d2h``\n"
         '(pinned host memory over PCIe) and ``p2p`` (card to card) -- start as\n'
         "uncalibrated priors from the links' published rates and say so in their\n"
         'provenance until :func:`calibrate` replaces them with a live fit.\n'),
        (# perf.py:150-151
         '    "ici": (1.0e-6, 45.0e9),  # v5e ICI per-link, one direction\n'
         '    "dcn": (50.0e-6, 12.5e9),  # cross-slice data-center network\n',
         '    "h2d": (10.0e-6, 64.0e9),  # pinned host -> card, PCIe Gen5 x16\n'
         '    "d2h": (10.0e-6, 64.0e9),  # card -> pinned host, PCIe Gen5 x16\n'
         '    "p2p": (10.0e-6, 450.0e9),  # card -> card, NVLink 4, one direction\n'),
        (# perf.py:161-165
         '    "ici": "prior: TPU v5e ICI ~45 GB/s per link per direction (public "\n'
         '           "v5e system specs; 4x ICI links/chip) — no live ICI probe has "\n'
         '           "ever run in this process",\n'
         '    "dcn": "prior: ~100 Gbps-class host NIC (12.5 GB/s) cross-slice "\n'
         '           "estimate — no live DCN probe has ever run in this process",\n',
         '    "h2d": "prior: uncalibrated — PCIe Gen5 x16 bus rate (64 GB/s per "\n'
         '           "direction) — no live H2D probe has run in this process",\n'
         '    "d2h": "prior: uncalibrated — PCIe Gen5 x16 bus rate (64 GB/s per "\n'
         '           "direction) — no live D2H probe has run in this process",\n'
         '    "p2p": "prior: uncalibrated — NVLink 4 data-sheet rate (450 GB/s per "\n'
         '           "direction) — no live card-to-card probe has run in this "\n'
         '           "process",\n'),
    ],
    'api.py': [
        (# api.py:14-14
         'implicit ndarray conversion in the reference bindings.  ``jax.Array`` and\n',
         'implicit ndarray conversion in the reference bindings.  ``torch.Tensor`` and\n'),
        (# api.py:94-94
         '        "array, bytes-like, jax.Array, or DeviceBuffer"\n',
         '        "array, bytes-like, torch.Tensor, or DeviceBuffer"\n'),
        (# api.py:281-282
         '        device-plane (jax.Array) sends ride the PJRT pull path, which has\n'
         '        its own transfer lifecycle (device.py)."""\n',
         '        device-plane (torch.Tensor) sends have their own transfer\n'
         '        lifecycle (device.py)."""\n'),
    ],
    'core/engine.py': [
        (# core/engine.py:404-412
         '    def transfer_manager(self):\n'
         '        """The worker\'s TransferManager, created on first use (None when\n'
         '        the PJRT transfer API is unavailable)."""\n'
         '        from .. import device as _device\n'
         '\n'
         '        with self.lock:\n'
         '            if self._xfer_mgr is None:\n'
         '                if not _device.devpull_supported():\n'
         '                    return None\n',
         '    def transfer_manager(self):\n'
         '        """The worker\'s TransferManager, created on first use (None when\n'
         '        the pull is disabled)."""\n'
         '        from .. import device as _device\n'
         '\n'
         '        with self.lock:\n'
         '            if self._xfer_mgr is None:\n'
         '                if _device.cudaipc_identity() is None:\n'
         '                    return None\n'),
        (# core/engine.py:1352-1354
         '            if _device.devpull_supported():\n'
         '                extra["devpull"] = "ok"\n'
         '            sock = socket.create_connection((addr, port), timeout=connect_timeout)\n',
         '            if _device.devpull_supported():\n'
         '                extra["devpull"] = "ok"\n'
         '            if _device.cudaipc_identity() is not None:\n'
         "                # The port's own pull (device.py): a key JAX peers and the\n"
         '                # C++ engine ignore, so they never see its descriptors.\n'
         '                extra["cudaipc"] = _device.cudaipc_identity()\n'
         '            sock = socket.create_connection((addr, port), timeout=connect_timeout)\n'),
        (# core/engine.py:1370-1370
         '        conn.devpull_ok = ack.get("devpull") == "ok"\n',
         '        peer_ipc = ack.get("cudaipc") if "cudaipc" in extra else None\n'
         '        conn.cudaipc_peer = peer_ipc if isinstance(peer_ipc, str) else None\n'
         '        conn.devpull_ok = (ack.get("devpull") == "ok"\n'
         '                           or conn.cudaipc_peer is not None)\n'),
        (# core/engine.py:1543-1545
         '        if _device.devpull_supported():\n'
         '            extra["devpull"] = "ok"\n'
         '        mode = self._connect_target[0] if self._connect_target else "socket"\n',
         '        if _device.devpull_supported():\n'
         '            extra["devpull"] = "ok"\n'
         '        if _device.cudaipc_identity() is not None:\n'
         '            extra["cudaipc"] = _device.cudaipc_identity()\n'
         '        mode = self._connect_target[0] if self._connect_target else "socket"\n'),
        (# core/engine.py:1754-1756
         '        if info.get("devpull") == "ok" and _device.devpull_supported():\n'
         '            conn.devpull_ok = True\n'
         '            ack_extra["devpull"] = "ok"\n',
         '        if info.get("devpull") == "ok" and _device.devpull_supported():\n'
         '            conn.devpull_ok = True\n'
         '            ack_extra["devpull"] = "ok"\n'
         '        if (isinstance(info.get("cudaipc"), str)\n'
         '                and _device.cudaipc_identity() is not None):\n'
         '            conn.cudaipc_peer = info["cudaipc"]\n'
         '            conn.devpull_ok = True\n'
         '            ack_extra["cudaipc"] = _device.cudaipc_identity()\n'),
        (# core/engine.py:608-609
         '                    _run_fires(fires)\n'
         '            self._do_close()\n',
         '                    _run_fires(fires)\n'
         '                # Drop the delivered batch before the next select blocks:\n'
         '                # its completions reach the receives\' buffers, which would\n'
         '                # otherwise stay alive until the next wakeup.\n'
         '                fires = None\n'
         '            self._do_close()\n'),
        (# core/engine.py:1834-1835
         '            if existing.devpull_ok:\n'
         '                ack_extra["devpull"] = "ok"\n',
         '            if existing.devpull_ok and existing.cudaipc_peer is None:\n'
         '                ack_extra["devpull"] = "ok"\n'),
    ],
    'core/conn.py': [
        (# core/conn.py:509-510
         '        self.devpull_ok = False\n'
         '        self._remote_msgs: set = set()\n',
         '        self.devpull_ok = False\n'
         '        # The peer\'s "cudaipc" value (device.py) when the port\'s own pull\n'
         '        # was negotiated instead; None otherwise.\n'
         '        self.cudaipc_peer = None\n'
         '        self._remote_msgs: set = set()\n'),
    ],
    'benchmarks/scenarios.py': [
        (# benchmarks/scenarios.py:13-15
         'scenario a class with ``run_client`` / ``run_server`` coroutines; payloads may\n'
         'be host numpy arrays (default) or device jax.Arrays (``payload="device"``),\n'
         'which is the TPU-native headline path.\n',
         'scenario a class with ``run_client`` / ``run_server`` coroutines; payloads may\n'
         'be host numpy arrays (default) or ``torch.uint8`` tensors on the card\n'
         '(``payload="device"``, on :data:`PAYLOAD_DEVICE`), the device plane\'s path.\n'),
        (# benchmarks/scenarios.py:84-98
         'def _make_payload(size: int, fill: int, kind: str):\n'
         '    """Host numpy buffer or a device jax.Array (the TPU-native path)."""\n'
         '    if kind == "device":\n'
         '        import jax.numpy as jnp\n'
         '\n'
         '        return jnp.full((size,), fill % 256, dtype=jnp.uint8)\n'
         '    return np.full(size, fill % 256, dtype=np.uint8)\n'
         '\n'
         '\n'
         'def _make_sink(size: int, kind: str):\n'
         '    if kind == "device":\n'
         '        from ..device import DeviceBuffer\n'
         '\n'
         '        return DeviceBuffer((size,), np.uint8)\n'
         '    return np.empty(size, dtype=np.uint8)\n',
         '#: Where ``payload="device"`` buffers live: ``cuda:0``, or the CPU only when\n'
         '#: the caller asks for it (``python -m starway_tpu_torch.bench --device cpu``).\n'
         'PAYLOAD_DEVICE = "cuda:0"\n'
         '\n'
         '\n'
         'def _make_payload(size: int, fill: int, kind: str):\n'
         '    """Host numpy buffer or a torch.uint8 tensor on PAYLOAD_DEVICE."""\n'
         '    if kind == "device":\n'
         '        import torch\n'
         '\n'
         '        return torch.full((size,), fill % 256, dtype=torch.uint8,\n'
         '                          device=PAYLOAD_DEVICE)\n'
         '    return np.full(size, fill % 256, dtype=np.uint8)\n'
         '\n'
         '\n'
         'def _make_sink(size: int, kind: str):\n'
         '    if kind == "device":\n'
         '        from ..device import DeviceBuffer\n'
         '\n'
         '        return DeviceBuffer((size,), np.uint8, device=PAYLOAD_DEVICE)\n'
         '    return np.empty(size, dtype=np.uint8)\n'),
        (# benchmarks/scenarios.py:527-528
         '    holding at full bandwidth.  Host numpy path: the schedule machinery\n'
         '    itself is jax-free; jax arrays enter via reshard.redistribute()."""\n',
         '    holding at full bandwidth.  Host numpy path: the schedule machinery\n'
         '    itself imports no array library."""\n'),
    ],
    'bench.py': [
        (# bench.py:71-72
         '        help="Buffer kind for large-array/streaming-duplex: host numpy (default) or jax.Array device buffers.",\n'
         '    )\n',
         '        help="Buffer kind for large-array/streaming-duplex: host numpy (default) or torch.uint8 tensors on the card.",\n'
         '    )\n'
         '    p.add_argument(\n'
         '        "--device", choices=("cuda", "cpu"), default="cuda",\n'
         '        help="Where device payloads live: cuda:0 (default; refused without "\n'
         '             "a card) or, only when asked, the CPU (also STARWAY_BENCH_CPU=1).",\n'
         '    )\n'),
        (# bench.py:553-559
         '    if getattr(args, "payload", None) == "device":\n'
         '        # devpull is only advertised in the handshake once the jax backend\n'
         '        # is up (the handshake never initialises one); device-payload runs\n'
         '        # should measure the pull path, so bring it up before connecting.\n'
         '        import jax\n'
         '\n'
         '        jax.devices()\n',
         '    from .benchmarks import scenarios\n'
         '    from .headline import cpu_requested\n'
         '\n'
         '    if cpu_requested(args.device):\n'
         '        scenarios.PAYLOAD_DEVICE = "cpu"\n'
         '    elif getattr(args, "payload", None) == "device":\n'
         '        import torch\n'
         '\n'
         '        if not torch.cuda.is_available():\n'
         '            print("bench: --payload device needs a CUDA device; pass "\n'
         '                  "--device cpu (or STARWAY_BENCH_CPU=1) to run on CPU "\n'
         '                  "tensors", file=sys.stderr)\n'
         '            return 2\n'),
    ],
    'core/endpoint.py': [
        (# core/endpoint.py:45-45
         '        or ``[("lo", "tcp")]``; the device plane reports ``("tpu:N", "ici")``.\n',
         '        or ``[("lo", "tcp")]``; the device plane reports ``("cuda:N", ...)``.\n'),
    ],
}

COPIES = ["errors.py", "config.py", "perf.py", "api.py"] + [
    f"core/{name}" for name in CORE] + [
    "bench.py", "metrics.py", "trace.py", "benchmarks/__init__.py",
    "benchmarks/scenarios.py"] + [
    f"reshard/{name}" for name in ("__init__.py", "plan.py", "tags.py",
                                   "executor.py")] + [
    f"analysis/{name}" for name in ("base.py", "py_model.py",
                                    "protomodel.py", "refine.py",
                                    "refine_corpus.txt")] + [
    "testing/__init__.py", "testing/faults.py"]

# The source paths the analysis copies read, by the original's line: each
# names the port's file, so the monitor checks the port's own engine.
# native/sw_engine.cpp stays as it is (refine.py:288-297): the port builds
# that same engine (native_build.py).
READ_SITES = {
    "analysis/protomodel.py": {
        287: '"starway_tpu_torch/core/conn.py"',
        288: '"starway_tpu_torch/core/engine.py"'},
    "analysis/py_model.py": {
        152: 'root / "starway_tpu_torch" / "core"',
        154: '"starway_tpu_torch/core/frames.py"',
        155: '"starway_tpu_torch/core/shmring.py"',
        156: '"starway_tpu_torch/core/conn.py"',
        157: '"starway_tpu_torch/core/native.py"',
        158: '"starway_tpu_torch/core/engine.py"',
        159: '"starway_tpu_torch/errors.py"',
        160: '"starway_tpu_torch/core/swtrace.py"',
        161: '"starway_tpu_torch/core/telemetry.py"'},
    "analysis/refine.py": {
        288: "root = Path(__file__).resolve().parents[2]",
        292: 'cpp_path = root / "native" / "sw_engine.cpp"',
        311: '"starway_tpu_torch/core/frames.py"',
        383: '"starway_tpu_torch/core/frames.py"',
        437: '"starway_tpu_torch/core/conn.py"'},
}


def _expected(rel: str) -> str:
    text = RENAME.sub("starway_tpu_torch", (JAX_PKG / rel).read_text())
    for old, new in EDITS.get(rel, ()):
        assert text.count(old) == 1, f"{rel}: the edited original moved"
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_original(rel):
    want = _expected(rel)
    got = (PORT_PKG / rel).read_text()
    diff = "".join(difflib.unified_diff(
        want.splitlines(True), got.splitlines(True),
        f"starway_tpu/{rel} (renamed, edited)", f"starway_tpu_torch/{rel}"))
    assert got == want, diff


def test_every_core_module_is_copied():
    assert sorted(p.name for p in (PORT_PKG / "core").glob("*.py")) == CORE
    assert len(CORE) == 16


@pytest.mark.parametrize("rel", sorted(READ_SITES))
def test_analysis_reads_the_ports_sources(rel):
    lines = (PORT_PKG / rel).read_text().splitlines()
    for lineno, text in READ_SITES[rel].items():
        assert text in lines[lineno - 1], (rel, lineno, lines[lineno - 1])
        path = text.split('"')[1] if text.count('"') == 2 else None
        if path and "/" in path:
            assert (REPO / path).is_file(), path
