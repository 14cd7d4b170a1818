"""The port's copies of the JAX package's host runtime stay copies.

``starway_tpu_torch`` keeps its own copy of every module of the JAX
package's transport that imports no JAX (``errors``, ``config``, ``perf``,
``api`` and all of ``core/``).  Each equals its original after the package
rename, except in the named edits below, so the proofs that the JAX
package's analysis gate makes of the originals (it scans ``starway_tpu/``
only) hold for the copies too.  The rename leaves references to the gate
itself (``starway_tpu.analysis``) pointing at the JAX package, which owns
it."""

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
    'core/endpoint.py': [
        (# core/endpoint.py:45-45
         '        or ``[("lo", "tcp")]``; the device plane reports ``("tpu:N", "ici")``.\n',
         '        or ``[("lo", "tcp")]``; the device plane reports ``("cuda:N", ...)``.\n'),
    ],
}

COPIES = ["errors.py", "config.py", "perf.py", "api.py"] + [
    f"core/{name}" for name in CORE]


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
