"""The port's copies of the JAX package's host runtime stay copies.

``starway_tpu_torch`` keeps its own copy of every module of the JAX
package's transport that imports no JAX (``errors``, ``config``, ``perf``,
``api`` and all of ``core/``), of its bench CLI and scenarios (``bench``,
``benchmarks/``, whose device payloads become tensors), of its telemetry
viewer and trace export (``metrics``, ``trace``), of the reshard
planner and executor (``reshard/`` but ``api.py``, which imports JAX and
which the port writes its own), of the analysis core that the runtime
protocol monitor compiles (``analysis/{base,py_model,protomodel,refine}.py``
and ``refine_corpus.txt``) and of the fault proxy (``testing/``).  Each
equals its original after the package rename, except in the named edits
below, so the proofs that the JAX package's analysis gate makes of the
originals (it scans ``starway_tpu/`` only) hold for the copies too.  The
rename leaves references to the gate itself (``starway_tpu.analysis``)
pointing at the JAX package, which owns it; it turns the source paths that
the analysis copies read (``starway_tpu/core/...``) into the port's, which
``test_analysis_reads_the_ports_sources`` pins site by site.

The C++ engine is copied too (``starway_tpu_torch/native/sw_engine.{cpp,h}``
from ``native/``): a C++ file has no package rename, so each of its
differences is a named entry of ``NATIVE_EDITS``."""

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

EDITS.update({
    'core/native.py': [
        (# core/native.py:1-1
         '"""ctypes bridge to the C++ native engine (native/sw_engine.cpp).\n',
         '"""ctypes bridge to the C++ native engine (native/sw_engine.cpp, built from\n'
         "this package's copy, starway_tpu_torch/native/sw_engine.cpp).\n"),
        (# core/native.py:19-25
         'plus ``STARWAY_NATIVE=1``).  Cross-process device payloads ride the\n'
         'negotiated PJRT pull extension: ALL matching lives in the engine\n'
         '(descriptor records share its FIFO unexpected stream with staged DATA, so\n'
         'same-tag ordering matches the Python engine); the engine surfaces\n'
         "descriptors and claim events through ``sw_set_devpull``'s two callbacks\n"
         'and this wrapper runs the pulls (the engine cannot -- they need a live\n'
         'JAX runtime), releasing deferred flush barriers via\n'
         '``sw_devpull_resolved`` (see sw_engine.h "devpull" and DESIGN.md §7).\n',
         'plus ``STARWAY_NATIVE=1``).  Cross-process device payloads ride the\n'
         'pull, negotiated under the port\'s "cudaipc" HELLO key (device.py):\n'
         'ALL matching lives in the engine (descriptor records share its FIFO\n'
         'unexpected stream with staged DATA, so same-tag ordering matches the\n'
         'Python engine); the engine surfaces descriptors and claim events\n'
         "through ``sw_set_devpull``'s two callbacks and this wrapper runs the\n"
         "pulls on device.py's TransferManager (the engine cannot -- they need\n"
         'torch), releasing deferred flush barriers via ``sw_devpull_resolved``\n'
         '(see sw_engine.h "devpull" and DESIGN.md §7).\n'),
        (# core/native.py:124-127
         '        lib.sw_set_devpull.argtypes = [\n'
         '            ctypes.c_void_p, ctypes.c_int, _DEVPULL_CB, _DEVPULL_CLAIM_CB,\n'
         '            ctypes.c_void_p,\n'
         '        ]\n',
         '        lib.sw_set_devpull.argtypes = [\n'
         '            ctypes.c_void_p, ctypes.c_int, _DEVPULL_CB, _DEVPULL_CLAIM_CB,\n'
         '            ctypes.c_void_p,\n'
         '        ]\n'
         '        lib.sw_set_cudaipc.argtypes = [ctypes.c_void_p, ctypes.c_char_p]\n'),
        (# core/native.py:373-379
         '        self._devpull: Optional[bool] = None\n'
         '\n'
         '    def _info(self) -> dict:\n'
         '        lib = load()\n'
         '        buf = ctypes.create_string_buffer(512)\n'
         '        n = lib.sw_conn_info(self.worker._h, self.conn_id, buf, 512)\n',
         '        self._devpull: Optional[bool] = None\n'
         '        self._cudaipc_peer: Optional[str] = None\n'
         '\n'
         '    def _info(self) -> dict:\n'
         '        lib = load()\n'
         '        buf = ctypes.create_string_buffer(1024)\n'
         '        n = lib.sw_conn_info(self.worker._h, self.conn_id, buf, 1024)\n'),
        (# core/native.py:422-427
         '    @property\n'
         '    def devpull_ok(self) -> bool:\n'
         '        # Handshake-fixed, like the transport: memoize the FFI round-trip.\n'
         '        if self._devpull is None:\n'
         '            self._devpull = bool(self._info().get("devpull", 0))\n'
         '        return self._devpull\n',
         '    @property\n'
         '    def devpull_ok(self) -> bool:\n'
         '        # Handshake-fixed, like the transport: memoize the FFI round-trip.\n'
         '        if self._devpull is None:\n'
         '            info = self._info()\n'
         '            self._cudaipc_peer = info.get("cudaipc") or None\n'
         '            self._devpull = bool(info.get("devpull", 0))\n'
         '        return self._devpull\n'
         '\n'
         '    @property\n'
         '    def cudaipc_peer(self) -> Optional[str]:\n'
         '        """The peer\'s "cudaipc" value when the pull was negotiated\n'
         '        (device.py routes each offer by it), else None."""\n'
         '        return self._cudaipc_peer if self.devpull_ok else None\n'),
        (# core/native.py:666-673
         '        """Register the descriptor callback + advertise capability; called\n'
         '        before listen/connect (the handshake carries the negotiation).\n'
         '        Advertised only when the jax backend is already up -- same\n'
         '        semantics as the Python engine\'s handshake probe."""\n'
         '        from .. import device as _device\n'
         '\n'
         '        if not _device.devpull_supported():\n'
         '            return\n',
         '        """Register the descriptor callback + advertise capability; called\n'
         '        before listen/connect (the handshake carries the negotiation).\n'
         '        Advertised under "cudaipc" with this process\'s identity unless\n'
         '        STARWAY_DEVPULL=0 -- the Python engine\'s handshake offer."""\n'
         '        from .. import device as _device\n'
         '\n'
         '        identity = _device.cudaipc_identity()\n'
         '        if identity is None:\n'
         '            return\n'),
        (# core/native.py:686-688
         '        self._devpull_key = _register(dispatch, dispatch_claim)\n'
         '        self._lib.sw_set_devpull(self._h, 1, _on_devpull, _on_devpull_claim,\n',
         '        self._devpull_key = _register(dispatch, dispatch_claim)\n'
         '        self._lib.sw_set_cudaipc(self._h, identity.encode())\n'
         '        self._lib.sw_set_devpull(self._h, 1, _on_devpull, _on_devpull_claim,\n'),
        (# core/native.py:694-696
         '            if self._xfer_mgr is None:\n'
         '                if not _device.devpull_supported():\n'
         '                    return None\n',
         '            if self._xfer_mgr is None:\n'
         '                if _device.cudaipc_identity() is None:\n'
         '                    return None\n'),
        (# core/native.py:798-800
         '        mgr.pull(entry.desc, device,\n'
         '                 lambda arr, e=entry: self._pull_done(e, arr),\n'
         '                 lambda err, e=entry: self._pull_failed(e, err))\n',
         '        mgr.pull(entry.desc, device,\n'
         '                 lambda arr, e=entry: self._pull_done(e, arr),\n'
         '                 lambda err, e=entry: self._pull_failed(e, err),\n'
         '                 self.stage_scope)\n'),
        (# core/native.py:822-831
         '        under _devpull_lock (user callbacks re-enter the API)."""\n'
         '        import numpy as np\n'
         '\n'
         '        try:\n'
         '            user_done, _fail, mv, sink = entry.claimed\n'
         '            if sink is not None:\n'
         '                sink.accept_device(arr)\n'
         '            elif mv is not None:\n'
         '                host = np.asarray(arr).view(np.uint8).reshape(-1)\n'
         '                mv[: entry.nbytes] = memoryview(host)[: entry.nbytes]\n',
         '        under _devpull_lock (user callbacks re-enter the API)."""\n'
         '        from ..device import PulledPayload\n'
         '\n'
         '        try:\n'
         '            user_done, _fail, mv, sink = entry.claimed\n'
         '            if sink is not None:\n'
         '                sink.accept_device(arr)\n'
         '            elif mv is not None:\n'
         '                host = PulledPayload(arr).as_host_view()\n'
         '                mv[: entry.nbytes] = host[: entry.nbytes]\n'),
    ],
    'reshard/__init__.py': [
        (# reshard/__init__.py:11-14
         'reserved namespace that cannot collide with user tags.  The jax face --\n'
         '``redistribute()`` / ``ArrayRef`` / ``spec_from_sharding`` -- lives in\n'
         'api.py, the only module here allowed to import jax (analysis rule\n'
         '``layering-reshard``).\n',
         'reserved namespace that cannot collide with user tags.  The torch face --\n'
         '``redistribute()`` / ``ArrayRef`` / ``spec_from_sharding`` and the\n'
         "sharding descriptions they take (``SlotMesh``, ``SlotSharding``,\n"
         "``ShardedTensor``, a DTensor's mesh and placements) -- lives in api.py,\n"
         'the only module here that imports torch.\n'),
        (# reshard/__init__.py:29-34
         'def __getattr__(name):\n'
         '    # jax-importing names resolve lazily so `import starway_tpu_torch.reshard`\n'
         '    # stays cheap (and possible) in jax-free processes.\n'
         '    if name in ("redistribute", "ArrayRef", "ReshardResult",\n'
         '                "spec_from_sharding", "default_rank_of"):\n',
         'def __getattr__(name):\n'
         '    # torch-importing names resolve lazily so `import\n'
         '    # starway_tpu_torch.reshard` stays cheap for the planner alone.\n'
         '    if name in ("redistribute", "ArrayRef", "ReshardResult",\n'
         '                "spec_from_sharding", "default_rank_of", "Slot",\n'
         '                "SlotMesh", "SlotSharding", "ShardedTensor"):\n'),
        (# reshard/__init__.py:45-46
         '    "redistribute", "ArrayRef", "ReshardResult", "spec_from_sharding",\n'
         '    "default_rank_of",\n',
         '    "redistribute", "ArrayRef", "ReshardResult", "spec_from_sharding",\n'
         '    "default_rank_of", "Slot", "SlotMesh", "SlotSharding", "ShardedTensor",\n'),
    ],
    'analysis/protomodel.py': [
        (# analysis/protomodel.py:311-311
         '    relfile = "native/sw_engine.cpp"\n',
         '    relfile = "starway_tpu_torch/native/sw_engine.cpp"\n'),
        (# analysis/protomodel.py:361-363
         '    if not cpp.transitions:\n'
         '        out.append(Finding(\n'
         '            "native/sw_engine.cpp", 1, "proto-state",\n',
         '    if not cpp.transitions:\n'
         '        out.append(Finding(\n'
         '            "starway_tpu_torch/native/sw_engine.cpp", 1, "proto-state",\n'),
    ],
    'analysis/refine.py': [
        (# analysis/refine.py:292-292
         '    cpp_path = root / "native" / "sw_engine.cpp"\n',
         '    cpp_path = root / "starway_tpu_torch" / "native" / "sw_engine.cpp"\n'),
        (# analysis/refine.py:349-349
         '    rel = "native/sw_engine.cpp"\n',
         '    rel = "starway_tpu_torch/native/sw_engine.cpp"\n'),
        (# analysis/refine.py:384-384
         '    f_cpp = "native/sw_engine.cpp"\n',
         '    f_cpp = "starway_tpu_torch/native/sw_engine.cpp"\n'),
    ],
})

# The port's copy of the C++ engine (native/ -> starway_tpu_torch/native/):
# the pull is negotiated under "cudaipc" (the peer's identity, kept per
# conn and reported by sw_conn_info), never under "devpull".
NATIVE_EDITS = {
    'sw_engine.cpp': [
        (# sw_engine.cpp:1-2
         '// starway-tpu native host engine (C++20).\n'
         '//\n',
         '// starway-tpu native host engine (C++20).\n'
         '//\n'
         "// The PyTorch port's copy of native/sw_engine.cpp.  It differs in one\n"
         '// respect: the device pull is negotiated under the HELLO key "cudaipc",\n'
         "// whose value is the process's identity (host|boot|pid, given by\n"
         '// sw_set_cudaipc), and never under "devpull", whose peers send PJRT\n'
         '// descriptors that the port cannot pull.  Descriptor frames, matching\n'
         "// and flush deferral are the original's.\n"
         '//\n'),
        (# sw_engine.cpp:1926-1927
         '  bool devpull_ok = false;\n'
         '  // Peer-liveness keepalive',
         '  bool devpull_ok = false;\n'
         '  // The peer\'s "cudaipc" value when the pull was negotiated.\n'
         '  std::string cudaipc_peer;\n'
         '  // Peer-liveness keepalive'),
        (# sw_engine.cpp:2181-2182
         '  bool devpull_advertise = false;\n'
         '  sw_devpull_cb devpull_cb = nullptr;\n',
         '  bool devpull_advertise = false;\n'
         '  std::string cudaipc_id;  // this process\'s "cudaipc" value\n'
         '  sw_devpull_cb devpull_cb = nullptr;\n'),
        (# sw_engine.cpp:3204-3205
         '                        "\\"";\n'
         '    if (devpull_advertise) hello += ", \\"devpull\\": \\"ok\\"";\n',
         '                        "\\"";\n'
         '    if (devpull_advertise)\n'
         '      hello += ", \\"cudaipc\\": \\"" + cudaipc_id + "\\"";\n'),
        (# sw_engine.cpp:3252-3252
         '          (existing->devpull_ok ? ", \\"devpull\\": \\"ok\\"" : "") +\n',
         '          (existing->devpull_ok ? ", \\"cudaipc\\": \\"" + cudaipc_id + "\\""\n'
         '                                : "") +\n'),
        (# sw_engine.cpp:5494-5495
         '    if (devpull_advertise && json_field(body, "devpull") == "ok")\n'
         '      c->devpull_ok = true;\n',
         '    if (devpull_advertise && !json_field(body, "cudaipc").empty()) {\n'
         '      c->cudaipc_peer = json_field(body, "cudaipc");\n'
         '      c->devpull_ok = true;\n'
         '    }\n'),
        (# sw_engine.cpp:5523-5523
         '                      (c->devpull_ok ? ", \\"devpull\\": \\"ok\\"" : "") +\n',
         '                      (c->devpull_ok ? ", \\"cudaipc\\": \\"" + cudaipc_id + "\\""\n'
         '                                     : "") +\n'),
        (# sw_engine.cpp:6317-6318
         '    if (devpull_advertise) hello += ", \\"devpull\\": \\"ok\\"";\n'
         '    hello += ", \\"ka\\": \\"ok\\"";',
         '    if (devpull_advertise)\n'
         '      hello += ", \\"cudaipc\\": \\"" + cudaipc_id + "\\"";\n'
         '    hello += ", \\"ka\\": \\"ok\\"";'),
        (# sw_engine.cpp:6397-6397
         '    c->devpull_ok = devpull_advertise && json_field(ack_body, "devpull") == "ok";\n',
         '    if (devpull_advertise) c->cudaipc_peer = json_field(ack_body, "cudaipc");\n'
         '    c->devpull_ok = !c->cudaipc_peer.empty();\n'),
        (# sw_engine.cpp:6888-6889
         '  w->devpull_cb_ctx = ctx;\n'
         '}\n',
         '  w->devpull_cb_ctx = ctx;\n'
         '}\n'
         '\n'
         'void sw_set_cudaipc(void* h, const char* identity) {\n'
         '  Worker* w = W(h);\n'
         '  std::lock_guard<std::mutex> g(w->mu);\n'
         '  w->cudaipc_id = identity ? identity : "";\n'
         '}\n'),
        (# sw_engine.cpp:7061-7071
         '  char buf[512];\n'
         '  int n = snprintf(buf, sizeof(buf),\n'
         '                   "{\\"name\\": \\"%s\\", \\"mode\\": \\"%s\\", \\"alive\\": %d, "\n'
         '                   "\\"local_addr\\": \\"%s\\", \\"local_port\\": %d, "\n'
         '                   "\\"remote_addr\\": \\"%s\\", \\"remote_port\\": %d, "\n'
         '                   "\\"transport\\": \\"%s\\", \\"devpull\\": %d, \\"rails\\": %d}",\n'
         '                   c->peer_name.c_str(), c->mode.c_str(), c->alive ? 1 : 0,\n'
         '                   c->local_addr.c_str(), c->local_port,\n'
         '                   c->remote_addr.c_str(), c->remote_port,\n'
         '                   c->sm_negotiated ? "sm" : "tcp", c->devpull_ok ? 1 : 0,\n'
         '                   (int)c->rails.size());\n',
         '  char buf[1024];\n'
         '  int n = snprintf(buf, sizeof(buf),\n'
         '                   "{\\"name\\": \\"%s\\", \\"mode\\": \\"%s\\", \\"alive\\": %d, "\n'
         '                   "\\"local_addr\\": \\"%s\\", \\"local_port\\": %d, "\n'
         '                   "\\"remote_addr\\": \\"%s\\", \\"remote_port\\": %d, "\n'
         '                   "\\"transport\\": \\"%s\\", \\"devpull\\": %d, \\"rails\\": %d, "\n'
         '                   "\\"cudaipc\\": \\"%s\\"}",\n'
         '                   c->peer_name.c_str(), c->mode.c_str(), c->alive ? 1 : 0,\n'
         '                   c->local_addr.c_str(), c->local_port,\n'
         '                   c->remote_addr.c_str(), c->remote_port,\n'
         '                   c->sm_negotiated ? "sm" : "tcp", c->devpull_ok ? 1 : 0,\n'
         '                   (int)c->rails.size(), c->cudaipc_peer.c_str());\n'),
    ],
    'sw_engine.h': [
        (# sw_engine.h:242-247
         ' * PJRT transfer-server pull extension (wire: T_DEVPULL, see\n'
         ' * core/frames.py).  The engine owns the wire + matching; the embedder\n'
         ' * (core/native.py) owns the pulls, since they need a live JAX runtime.\n'
         ' *\n'
         ' * Setup: call sw_set_devpull BEFORE listen/connect.  When `advertise` is\n'
         ' * non-zero the handshake offers/accepts "devpull".  ALL matching lives in\n',
         ' * The device pull extension (wire: T_DEVPULL, see core/frames.py).  The\n'
         " * engine owns the wire + matching; the embedder (the port's\n"
         ' * core/native.py) owns the pulls, which run on torch (CUDA IPC).\n'
         ' *\n'
         ' * Setup: call sw_set_cudaipc and sw_set_devpull BEFORE listen/connect.\n'
         ' * When `advertise` is non-zero the handshake offers/accepts "cudaipc"\n'
         ' * with the identity sw_set_cudaipc gave (never "devpull": a JAX peer\n'
         " * would send PJRT descriptors); sw_conn_info reports the peer's value\n"
         ' * as "cudaipc" (empty when not negotiated).  ALL matching lives in\n'),
        (# sw_engine.h:282-283
         'void sw_set_devpull(void* h, int advertise, sw_devpull_cb cb,\n'
         '                    sw_devpull_claim_cb claim_cb, void* ctx);\n',
         'void sw_set_devpull(void* h, int advertise, sw_devpull_cb cb,\n'
         '                    sw_devpull_claim_cb claim_cb, void* ctx);\n'
         '\n'
         "/* This process's \"cudaipc\" HELLO value (host|boot|pid; the port's\n"
         ' * device.py cudaipc_identity()), copied by the engine. */\n'
         'void sw_set_cudaipc(void* h, const char* identity);\n'),
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
# names the port's file, so the monitor checks the port's own engines --
# the C++ one too, its copy under starway_tpu_torch/native/ being what
# native_build.py builds.
READ_SITES = {
    "analysis/protomodel.py": {
        311: '"starway_tpu_torch/native/sw_engine.cpp"',
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
        292: 'root / "starway_tpu_torch" / "native" / "sw_engine.cpp"',
        311: '"starway_tpu_torch/core/frames.py"',
        349: '"starway_tpu_torch/native/sw_engine.cpp"',
        383: '"starway_tpu_torch/core/frames.py"',
        384: '"starway_tpu_torch/native/sw_engine.cpp"',
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


def _expected_native(name: str) -> str:
    text = (REPO / "native" / name).read_text()
    for old, new in NATIVE_EDITS[name]:
        assert text.count(old) == 1, f"native/{name}: the edited original moved"
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("name", sorted(NATIVE_EDITS))
def test_engine_copy_equals_its_original(name):
    want = _expected_native(name)
    got = (PORT_PKG / "native" / name).read_text()
    diff = "".join(difflib.unified_diff(
        want.splitlines(True), got.splitlines(True),
        f"native/{name} (edited)", f"starway_tpu_torch/native/{name}"))
    assert got == want, diff


def test_engine_copy_never_speaks_devpull():
    """The copy offers and acknowledges "cudaipc" only: no HELLO or ACK it
    writes carries "devpull", so a JAX peer never sends it PJRT
    descriptors."""
    text = (PORT_PKG / "native" / "sw_engine.cpp").read_text()
    assert '\\"devpull\\": \\"ok\\"' not in text
    assert 'json_field(body, "devpull")' not in text
    assert 'json_field(ack_body, "devpull")' not in text
    assert text.count('\\"cudaipc\\": \\"" + cudaipc_id') == 4


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
