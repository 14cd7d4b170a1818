"""The port's copies of the JAX package's host runtime stay copies.

``starway_tpu_torch`` keeps its own copy of every module of the JAX
package's transport that imports no JAX (``errors``, ``config``, ``perf``,
``api`` and all of ``core/``), of its bench CLI and scenarios (``bench``,
``benchmarks/``, whose device payloads become tensors), of its telemetry
viewer and trace export (``metrics``, ``trace``), of the reshard
planner and executor (``reshard/`` but ``api.py``, which imports JAX and
which the port writes its own), of the whole static-analysis gate
(``analysis/``, its twelve passes, the CLI and its three data files:
``python -m starway_tpu_torch.analysis`` checks the port's own tree) and
of the fault proxy (``testing/``).  Each equals its original after the
package rename, except in the named edits below, so the gate the port
runs on its copies is the JAX package's gate, pointed at the port.  The
rename turns the source paths that the analysis copies read
(``starway_tpu/core/...``) into the port's, which
``test_analysis_reads_the_ports_sources`` pins site by site; the engine
copy's paths (``native/`` at the root in the original) are named edits.
The swcost ledger (``analysis/cost_budgets.txt``) is re-pinned from the
port's engines, so it is held row by row against the original's.

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
RENAME = re.compile(r"\bstarway_tpu\b")

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
        (# core/engine.py:978-981: a failed write suspends a session's conn
         # (alive, its socket dropped) and the read half of the same event
         # read from None, crashing the engine thread (the port's repair;
         # tests/test_torch_reshard.py's conn-kill case went red on it).
         '        if mask & selectors.EVENT_WRITE:\n'
         '            conn.on_writable(fires)\n'
         '        if mask & selectors.EVENT_READ and conn.alive:\n'
         '            conn.on_readable(fires)\n',
         '        # A conn without a socket is a suspended session: it stays alive\n'
         '        # while it waits for its redial.  Its socket may go within this\n'
         "        # very call (a failed write suspends it) or earlier in the\n"
         "        # selector's batch, and the stale readiness must not be acted on.\n"
         '        if mask & selectors.EVENT_WRITE and conn.sock is not None:\n'
         '            conn.on_writable(fires)\n'
         '        if mask & selectors.EVENT_READ and conn.alive and conn.sock is not None:\n'
         '            conn.on_readable(fires)\n'),
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
    # The in-process device send copies once, straight into a posted
    # receive (DevicePayload.copy_into), and snapshots only a message that
    # parks (DevicePayload.snapshot): the JAX package hands an immutable
    # array over and needs neither.
    'core/matching.py': [
        (# core/matching.py:24-25 (the device payload's duck type)
         '* device payload: ``DevicePayload`` (``nbytes`` / ``as_host_view()`` /\n'
         '  ``.array``).\n',
         '* device payload: ``DevicePayload`` (``nbytes`` / ``as_host_view()`` /\n'
         '  ``.array``; optional ``copy_into()`` for one copy straight into a posted\n'
         '  target and ``snapshot()`` for a message that parks, see device.py).\n'),
        (# core/matching.py:142 (_copy_complete: the one-copy delivery)
         '    \"\"\"Move a fully-arrived payload into a posted receive target.\"\"\"\n'
         '    if _is_host(pr.buf):\n',
         '    \"\"\"Move a fully-arrived payload into a posted receive target.\"\"\"\n'
         '    direct = getattr(payload, "copy_into", None)\n'
         '    if direct is not None:\n'
         '        # The payload writes the target itself: one copy, ordered after\n'
         '        # both posts and complete on return (DevicePayload.copy_into).\n'
         '        direct(pr.buf, length)\n'
         '        return\n'
         '    if _is_host(pr.buf):\n'),
        (# core/matching.py:442-444 (deliver: the snapshot at park time)
         '            # Keep the array reference; no host copy unless a host receive\n'
         '            # eventually claims it.\n'
         '            msg.device_payload = payload\n',
         '            # Keep the array reference; no host copy unless a host receive\n'
         '            # eventually claims it.  A payload that can snapshot itself does\n'
         '            # so now, before the send completes: the sender may overwrite\n'
         '            # its tensor from then on (DevicePayload.snapshot).\n'
         '            park = getattr(payload, "snapshot", None)\n'
         '            msg.device_payload = payload if park is None else park()\n'),
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
        (# bench.py:53-53: the port's gate lints bench.py (base.py's
         # LINT_EXTRA_FILES); its one copy is a control message's.
         'def _decode_ctl(buffer: np.ndarray, length: int) -> dict:\n',
         'def _decode_ctl(buffer: np.ndarray, length: int) -> dict:\n'
         '    # swcheck: allow(hotpath-copy): a bench control message (a small JSON body), not a payload\n'),
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

# The analysis gate on the port's tree: the root is where the port and
# its engine copy stand (no root-level native/ or starway_tpu/ needed); every
# pass reads the engine copy under starway_tpu_torch/native/; the lint surface
# gains the port's own top-level runtime modules and the markers/waiver scan
# takes the port's tests (tests/test_torch_*.py); the device pull is
# negotiated under "cudaipc"; the framework core/ and reshard/ must not bind
# is torch (jax stays banned); wirefuzz's native leg runs the port's build
# (native_build.py) of the tree under check, and a leg that cannot run is a
# finding.
EDITS.update({
    'analysis/base.py': [
        (# analysis/base.py:88-88
         '        if (p / "starway_tpu_torch").is_dir() and (p / "native").is_dir():\n',
         '        if (p / "starway_tpu_torch" / "native").is_dir():\n'),
        (# analysis/base.py:91-92
         '        "swcheck: cannot locate the repo root (need starway_tpu_torch/ and "\n'
         '        "native/ side by side); pass --root"\n',
         '        "swcheck: cannot locate the repo root (need starway_tpu_torch/ "\n'
         '        "with its engine copy, starway_tpu_torch/native/); pass --root"\n'),
        (# analysis/base.py:238-238
         'LINT_EXTRA_FILES = ("starway_tpu_torch/metrics.py",)\n',
         "#: The port's own top-level runtime modules join it: the device plane's\n"
         '#: pull and its staging threads (device.py), the headline and pull-step\n'
         '#: probes, the engine build and the bench CLI.\n'
         'LINT_EXTRA_FILES = ("starway_tpu_torch/metrics.py",\n'
         '                    "starway_tpu_torch/device.py",\n'
         '                    "starway_tpu_torch/headline.py",\n'
         '                    "starway_tpu_torch/ipc_steps.py",\n'
         '                    "starway_tpu_torch/native_build.py",\n'
         '                    "starway_tpu_torch/bench.py")\n'),
        (# analysis/base.py:257-258
         '        root / "native" / "sw_engine.h",\n'
         '        root / "native" / "sw_engine.cpp",\n',
         '        root / "starway_tpu_torch" / "native" / "sw_engine.h",\n'
         '        root / "starway_tpu_torch" / "native" / "sw_engine.cpp",\n'),
        (# analysis/base.py:282-282
         '    return sorted(tests.glob("test_*.py"))\n',
         "    # The port's own tests: the JAX package's gate scans the rest.\n"
         '    return sorted(tests.glob("test_torch_*.py"))\n'),
    ],
    'analysis/contract.py': [
        (# analysis/contract.py:53-54
         '# negotiation (DESIGN.md §19).\n'
         '_HANDSHAKE_KEYS = ["ka", "sm", "devpull", "sess", "tr", "rails", "rail_of",\n',
         "# negotiation (DESIGN.md §19).  The port's engines negotiate their device\n"
         '# pull under "cudaipc" (device.py\'s identity), never under "devpull".\n'
         '_HANDSHAKE_KEYS = ["ka", "sm", "cudaipc", "sess", "tr", "rails", "rail_of",\n'),
    ],
    'analysis/layering.py': [
        (# analysis/layering.py:5-5
         '* **core/ imports no jax** (``layering-jax``).  The matcher and\n',
         '* **core/ imports no torch and no jax** (``layering-jax``).  The matcher and\n'),
        (# analysis/layering.py:9-11
         "  unimportable in jax-free processes (the wheel's test-command imports\n"
         '  core.native with only numpy installed) and couple the engine to the\n'
         '  device plane.\n',
         '  unimportable in torch-free processes (core.native runs with only\n'
         '  numpy installed) and couple the engine to the device plane.\n'),
        (# analysis/layering.py:15-17
         '  and under reshard/ only ``api.py`` -- the jax adapter -- may import\n'
         '  jax, so the planner/executor stay runnable in jax-free processes the\n'
         '  same way core/ does.\n',
         '  and under reshard/ only ``api.py`` -- the torch adapter -- may import\n'
         '  torch (and none of them jax), so the planner/executor stay runnable\n'
         '  in torch-free processes the same way core/ does.\n'),
        (# analysis/layering.py:27-28
         '#: The one reshard/ module allowed to bind jax (the adapter) -- exact\n'
         '#: repo-relative path, so a nested helper named api.py is NOT exempt.\n',
         '#: The one reshard/ module allowed to bind the framework (the adapter) --\n'
         '#: exact repo-relative path, so a nested helper named api.py is NOT exempt.\n'),
        (# analysis/layering.py:29-31
         'RESHARD_JAX_OK = ("starway_tpu_torch/reshard/api.py",)\n'
         '\n'
         '\n',
         'RESHARD_JAX_OK = ("starway_tpu_torch/reshard/api.py",)\n'
         '\n'
         "#: The framework these rules guard is the port's, torch; jax (the JAX\n"
         "#: package's) may be bound by none of these modules, the adapter included.\n"
         "#: The rule names stay the JAX gate's so waivers and --rules line up.\n"
         'FRAMEWORKS = ("torch", "jax")\n'
         '\n'),
        (# analysis/layering.py:32-33
         'def _is_jax(module: str) -> bool:\n'
         '    return module == "jax" or module.startswith("jax.")\n',
         '\n'
         'def _is_jax(module: str, frameworks=FRAMEWORKS) -> bool:\n'
         '    return any(module == m or module.startswith(m + ".") for m in frameworks)\n'),
        (# analysis/layering.py:112-113
         '        if relpath in RESHARD_JAX_OK:\n'
         '            continue\n',
         '        banned = ("jax",) if relpath in RESHARD_JAX_OK else FRAMEWORKS\n'),
        (# analysis/layering.py:119-123
         '            if isinstance(node, ast.Import):\n'
         '                for alias in node.names:\n'
         '                    if _is_jax(alias.name):\n'
         '                        out.append(Finding(\n'
         '                            relpath, node.lineno, "layering-reshard",\n',
         '            if isinstance(node, ast.Import):\n'
         '                for alias in node.names:\n'
         '                    if _is_jax(alias.name, banned):\n'
         '                        out.append(Finding(\n'
         '                            relpath, node.lineno, "layering-reshard",\n'),
        (# analysis/layering.py:125-125
         '                            "-- only the api.py adapter may bind jax; the "\n',
         '                            "-- only the api.py adapter may bind torch; the "\n'),
        (# analysis/layering.py:126-129
         '                            "planner/executor stay jax-free (DESIGN.md §20)"))\n'
         '            elif isinstance(node, ast.ImportFrom):\n'
         '                if node.level == 0 and node.module and _is_jax(node.module):\n'
         '                    out.append(Finding(\n',
         '                            "planner/executor stay jax-free (DESIGN.md §20)"))\n'
         '            elif isinstance(node, ast.ImportFrom):\n'
         '                if (node.level == 0 and node.module\n'
         '                        and _is_jax(node.module, banned)):\n'
         '                    out.append(Finding(\n'),
        (# analysis/layering.py:133-133
         '                        "may bind jax (DESIGN.md §20)"))\n',
         '                        "may bind torch (DESIGN.md §20)"))\n'),
    ],
    'analysis/wirefuzz.py': [
        (# analysis/wirefuzz.py:19-21
         "3. the native engine's ``sw_wire_decode`` export, when the tree's built\n"
         "   artifact is present (skipped quietly in a bare venv -- the repo's CI\n"
         '   gate and test suite always have it).\n',
         "3. the native engine's ``sw_wire_decode`` export, from the tree's own\n"
         '   copy of the engine built by ``native_build``\n'
         "   (``build/starway_tpu_torch/_sw_native.so`` under the tree's root); an\n"
         '   engine that cannot be built or loaded is a finding, never a skip.\n'),
        (# analysis/wirefuzz.py:529-529
         '_NATIVE_CACHE: dict = {}\n',
         '_NATIVE_CACHE: dict = {}\n'
         '#: artifact path -> why it could not be loaded (the wire-diff finding).\n'
         '_NATIVE_ERRORS: dict = {}\n'),
        (# analysis/wirefuzz.py:533-535
         '    """The tree\'s built engine artifact with the sw_wire_decode export,\n'
         '    or None (fresh checkout / bare venv / pre-§21 build)."""\n'
         '    so = root / "starway_tpu_torch" / "_sw_native.so"\n',
         '    """The tree\'s engine artifact with the sw_wire_decode export, built\n'
         "    from the tree's own engine copy by native_build when it is missing\n"
         '    or older than its sources; None when it cannot be built or loaded,\n'
         '    with the reason in _NATIVE_ERRORS."""\n'
         '    from .. import native_build\n'
         '\n'
         '    so = native_build.artifact(root)\n'),
        (# analysis/wirefuzz.py:540-550
         '    if so.is_file():\n'
         '        try:\n'
         '            cand = ctypes.CDLL(str(so))\n'
         '            if hasattr(cand, "sw_wire_decode"):\n'
         '                cand.sw_wire_decode.argtypes = [\n'
         '                    ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,\n'
         '                    ctypes.c_char_p, ctypes.c_int,\n'
         '                ]\n'
         '                lib = cand\n'
         '        except OSError:\n'
         '            lib = None\n',
         '    try:\n'
         '        native_build.ensure_built(root=root)\n'
         '        cand = ctypes.CDLL(str(so))\n'
         '        if hasattr(cand, "sw_wire_decode"):\n'
         '            cand.sw_wire_decode.argtypes = [\n'
         '                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,\n'
         '                ctypes.c_char_p, ctypes.c_int,\n'
         '            ]\n'
         '            lib = cand\n'
         '        else:\n'
         '            _NATIVE_ERRORS[key] = "the artifact has no sw_wire_decode export"\n'
         '    except (OSError, RuntimeError) as e:\n'
         '        _NATIVE_ERRORS[key] = str(e)\n'),
        (# analysis/wirefuzz.py:748-748
         '                "native/sw_engine.cpp", 1, "wire-diff",\n',
         '                "starway_tpu_torch/native/sw_engine.cpp", 1, "wire-diff",\n'),
        (# analysis/wirefuzz.py:780-780
         '        counts["native"] = lib is not None\n',
         '        counts["native"] = lib is not None\n'
         '        if lib is None:\n'
         '            from .. import native_build\n'
         '\n'
         '            so = native_build.artifact(root)\n'
         '            out.append(Finding(\n'
         '                "starway_tpu_torch/native/sw_engine.cpp", 1, "wire-diff",\n'
         '                f"the native leg cannot run: {so} "\n'
         '                f"({_NATIVE_ERRORS.get(str(so), \'not loaded\')}) -- only "\n'
         '                "two of the three decoders would be diffed"))\n'),
    ],
    'analysis/cpp_model.py': [
        (# analysis/cpp_model.py:76-77
         '    cpp_file: str = "native/sw_engine.cpp"\n'
         '    h_file: str = "native/sw_engine.h"\n',
         '    cpp_file: str = "starway_tpu_torch/native/sw_engine.cpp"\n'
         '    h_file: str = "starway_tpu_torch/native/sw_engine.h"\n'),
        (# analysis/cpp_model.py:154-155
         '    cpp_path = root / "native" / "sw_engine.cpp"\n'
         '    h_path = root / "native" / "sw_engine.h"\n',
         '    cpp_path = root / "starway_tpu_torch" / "native" / "sw_engine.cpp"\n'
         '    h_path = root / "starway_tpu_torch" / "native" / "sw_engine.h"\n'),
    ],
    'analysis/concurrency.py': [
        (# analysis/concurrency.py:411-411
         '    path = root / "native" / "sw_engine.cpp"\n',
         '    path = root / "starway_tpu_torch" / "native" / "sw_engine.cpp"\n'),
        (# analysis/concurrency.py:414-414
         '    relpath = "native/sw_engine.cpp"\n',
         '    relpath = "starway_tpu_torch/native/sw_engine.cpp"\n'),
    ],
    'analysis/cost.py': [
        (# analysis/cost.py:55-55
         'F_CPP = "native/sw_engine.cpp"\n',
         'F_CPP = "starway_tpu_torch/native/sw_engine.cpp"\n'),
    ],
    'analysis/taint.py': [
        (# analysis/taint.py:53-53
         'F_CPP = "native/sw_engine.cpp"\n',
         'F_CPP = "starway_tpu_torch/native/sw_engine.cpp"\n'),
    ],
    'analysis/__init__.py': [
        (# analysis/__init__.py:8-8
         '  ``core/engine.py``-side sources and ``native/sw_engine.{h,cpp}``\n',
         '  ``core/engine.py``-side sources and the engine copy,\n'
         '  ``starway_tpu_torch/native/sw_engine.{h,cpp}``\n'),
        (# analysis/__init__.py:15-15
         '* **layering** -- no jax imports under core/.\n',
         '* **layering** -- no torch (and no jax) imports under core/.\n'),
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
    f"analysis/{name}" for name in (
        "__init__.py", "__main__.py", "base.py", "compose.py",
        "concurrency.py", "contract.py", "cost.py", "cpp_model.py",
        "explore.py", "hotpath.py", "layering.py", "markers.py",
        "protomodel.py", "py_model.py", "refine.py", "taint.py",
        "wirefuzz.py", "refine_corpus.txt", "wirefuzz_corpus.txt")] + [
    "testing/__init__.py", "testing/faults.py"]

# The transport's soak and bench scripts, copied to scripts/torch/ with the
# package renamed: each drives the port's transport (the soaks) or its
# bench CLI (``python -m starway_tpu_torch.bench``).  Their text is the
# originals' word for word, but for these named edits: the repo root one
# directory further up, the scripts' own paths in their usage lines, no
# JAX platform pinned for the bench runs (the port imports no JAX), and
# each bench run on a free port that the OS picks (the original's runs all
# take the bench CLI's default 17777, so two runs on one host at once
# collide).
_FREE_PORT = (
    "def _free_port() -> int:\n"
    '    """A free loopback port, bound and released (the bench CLI\'s\n'
    '    default port would collide with another run on the host)."""\n'
    "    import socket\n"
    "\n"
    "    with socket.socket() as s:\n"
    '        s.bind(("127.0.0.1", 0))\n'
    "        return s.getsockname()[1]\n"
    "\n"
    "\n")
_ROOT_UP2 = ("sys.path.insert(0, os.path.dirname(os.path.dirname("
             "os.path.abspath(__file__))))\n")
_ROOT_UP3 = ("sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(\n"
             "    os.path.abspath(__file__)))))\n")
SCRIPT_EDITS = {
    "session_chaos.py": [
        (_ROOT_UP2, _ROOT_UP3),
        ('    python scripts/session_chaos.py --server-engine native',
         '    python scripts/torch/session_chaos.py --server-engine native'),
    ],
    "paired_bench.py": [
        (_ROOT_UP2, _ROOT_UP3),
        ('    python scripts/paired_bench.py --pairs 5 --gate 0.70',
         '    python scripts/torch/paired_bench.py --pairs 5 --gate 0.70'),
        ('    python scripts/paired_bench.py --a-env STARWAY_NATIVE=0',
         '    python scripts/torch/paired_bench.py --a-env STARWAY_NATIVE=0'),
        ('    python scripts/paired_bench.py --b-env STARWAY_FC_WINDOW=1M',
         '    python scripts/torch/paired_bench.py --b-env STARWAY_FC_WINDOW=1M'),
        ('    base.setdefault("JAX_PLATFORMS", "cpu")\n', ''),
        ('def _one_run(env: dict, args) -> float:\n',
         _FREE_PORT + 'def _one_run(env: dict, args) -> float:\n'),
        ('               "--scenarios", args.scenario,\n'
         '               "--output", out] + (args.bench_arg or [])\n',
         '               "--scenarios", args.scenario,\n'
         '               "--port", str(_free_port()),\n'
         '               "--output", out] + (args.bench_arg or [])\n'),
    ],
    "integrity_bench.py": [
        (_ROOT_UP2, _ROOT_UP3),
        ('    python scripts/integrity_bench.py [--pairs 5]',
         '    python scripts/torch/integrity_bench.py [--pairs 5]'),
        ('    python scripts/integrity_bench.py --json out.json',
         '    python scripts/torch/integrity_bench.py --json out.json'),
        ('    env["JAX_PLATFORMS"] = "cpu"\n', ''),
        ('def _one_run(integrity: bool, args) -> float:\n',
         _FREE_PORT + 'def _one_run(integrity: bool, args) -> float:\n'),
        ('               "--stream-warmup", str(args.warmup),\n'
         '               "--output", out]\n',
         '               "--stream-warmup", str(args.warmup),\n'
         '               "--port", str(_free_port()),\n'
         '               "--output", out]\n'),
    ],
}


# The source paths the analysis copies read, by the port's line: each
# names the port's file, so the monitor and the gate check the port's own
# engines -- the C++ one too, its copy under starway_tpu_torch/native/ being
# what native_build.py builds.
READ_SITES = {
    "analysis/base.py": {
        227: 'root / "starway_tpu_torch" / "core"',
        241: '"starway_tpu_torch/metrics.py"',
        242: '"starway_tpu_torch/device.py"',
        243: '"starway_tpu_torch/headline.py"',
        244: '"starway_tpu_torch/ipc_steps.py"',
        245: '"starway_tpu_torch/native_build.py"',
        246: '"starway_tpu_torch/bench.py"',
        264: 'root / "starway_tpu_torch" / "errors.py"',
        265: 'root / "starway_tpu_torch" / "native" / "sw_engine.h"',
        266: 'root / "starway_tpu_torch" / "native" / "sw_engine.cpp"',
        268: '"starway_tpu_torch" / "analysis" / "cost_budgets.txt"',
        271: 'root / "starway_tpu_torch").glob("*.py")',
        274: '(root / "starway_tpu_torch" / "reshard")',
        291: 'tests.glob("test_torch_*.py")'},
    "analysis/cpp_model.py": {
        76: '"starway_tpu_torch/native/sw_engine.cpp"',
        77: '"starway_tpu_torch/native/sw_engine.h"',
        154: 'root / "starway_tpu_torch" / "native" / "sw_engine.cpp"',
        155: 'root / "starway_tpu_torch" / "native" / "sw_engine.h"'},
    "analysis/concurrency.py": {
        411: 'root / "starway_tpu_torch" / "native" / "sw_engine.cpp"',
        414: '"starway_tpu_torch/native/sw_engine.cpp"',
        563: 'root / "starway_tpu_torch" / "core" / "conn.py"',
        566: '"starway_tpu_torch/core/conn.py"',
        845: 'root / "starway_tpu_torch"'},
    "analysis/cost.py": {
        52: '"starway_tpu_torch/core/conn.py"',
        53: '"starway_tpu_torch/core/shmring.py"',
        54: '"starway_tpu_torch/core/lane.py"',
        55: '"starway_tpu_torch/native/sw_engine.cpp"',
        426: '"starway_tpu_torch/analysis/cost_budgets.txt"'},
    "analysis/taint.py": {
        51: '"starway_tpu_torch/core/conn.py"',
        52: '"starway_tpu_torch/core/shmring.py"',
        53: '"starway_tpu_torch/native/sw_engine.cpp"'},
    "analysis/wirefuzz.py": {
        131: '"starway_tpu_torch/core/frames.py"',
        193: '"starway_tpu_torch/core/shmring.py"',
        285: '"starway_tpu_torch/core/conn.py"',
        513: 'root / "starway_tpu_torch" / "core"',
        542: "native_build.artifact(root)",
        665: '"starway_tpu_torch" / "analysis" / "wirefuzz_corpus.txt"',
        677: '"starway_tpu_torch/analysis/wirefuzz_corpus.txt"',
        757: '"starway_tpu_torch/native/sw_engine.cpp"'},
    "analysis/layering.py": {
        28: '"starway_tpu_torch/reshard/api.py"',
        60: 'root / "starway_tpu_torch" / "reshard"'},
    "analysis/explore.py": {433: '"starway_tpu_torch/core/session.py"'},
    "analysis/compose.py": {480: '"starway_tpu_torch/core/lane.py"'},
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


def _expected_script(name: str) -> str:
    text = RENAME.sub("starway_tpu_torch",
                      (REPO / "scripts" / name).read_text())
    for old, new in SCRIPT_EDITS[name]:
        assert text.count(old) == 1, f"scripts/{name}: the edited original moved"
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("name", sorted(SCRIPT_EDITS))
def test_script_copy_equals_its_original(name):
    want = _expected_script(name)
    got = (REPO / "scripts" / "torch" / name).read_text()
    diff = "".join(difflib.unified_diff(
        want.splitlines(True), got.splitlines(True),
        f"scripts/{name} (renamed, edited)", f"scripts/torch/{name}"))
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


def _ledger_rows(path: Path) -> dict:
    rows = {}
    for line in path.read_text().splitlines():
        s = line.strip()
        if s and not s.startswith("#"):
            engine, pname, metric, value = s.split()[:4]
            rows[(engine, pname, metric)] = int(value)
    return rows


#: Rows of the port's swcost ledger that differ from the JAX package's, by
#: (engine, path, metric) -> the port edit that explains the difference.
#: None today: the port's edits (the "cudaipc" negotiation, the suspended
#: conn's readiness guard, the dropped fires batch) add no hot-path site.
LEDGER_DIFFERS: dict = {}


def test_cost_ledger_holds_row_by_row():
    """The port's ledger is re-pinned from the port's engines
    (``python -m starway_tpu_torch.analysis cost --write-budgets``); each
    row equals the JAX ledger's row for the same path, but where named."""
    port = _ledger_rows(PORT_PKG / "analysis" / "cost_budgets.txt")
    jax_rows = _ledger_rows(JAX_PKG / "analysis" / "cost_budgets.txt")
    assert set(port) == set(jax_rows)
    differ = {k for k in port if port[k] != jax_rows[k]}
    assert differ == set(LEDGER_DIFFERS), sorted(differ)
    header = RENAME.sub("starway_tpu_torch", (
        JAX_PKG / "analysis" / "cost_budgets.txt").read_text()).split("\n\n")[0]
    assert (PORT_PKG / "analysis" / "cost_budgets.txt").read_text().startswith(
        header)
