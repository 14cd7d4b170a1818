"""Shared fixture of the port's analysis-gate tests (tests/test_torch_swcheck_*.py).

Each case seeds the contract surface of BOTH packages into tmpdir -- the
port's (``starway_tpu_torch/core/``, ``errors.py``, the lint-surface
extras and the engine copy under ``starway_tpu_torch/native/``) and the
JAX package's (``starway_tpu/core/``, ``errors.py``, ``metrics.py`` and
``native/``) -- applies one mutation to both, and runs each package's gate
on its own tree.  The port's gate must fire the rule at a real
``file:line``, and the JAX gate must fire the same rule on the same
mutation: the JAX package's gate is the reference the port is held to.

A mutation names its files by a logical path: ``pkg/...`` is the package
(``starway_tpu_torch/`` or ``starway_tpu/``), ``native/...`` the engine
sources (``starway_tpu_torch/native/`` or ``native/``).  Seeded text is
written in the port's spelling and renamed for the JAX tree.  Each case
runs only the pass that owns the rule it checks (``PASS_OF``); the few
"the tree is clean" and CLI cases run all twelve.

The port's seeded tree carries the port's built engine
(``build/starway_tpu_torch/_sw_native.so``, newer than its sources), so
wirefuzz runs its native leg on it; a case that mutates the engine source
makes the artifact stale and the gate rebuilds the mutated engine.  The
JAX package's seeded tree carries no build, as in tests/test_swcheck.py.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path

from starway_tpu import analysis as jax_analysis
from starway_tpu_torch import analysis as port_analysis
from starway_tpu_torch import native_build

REPO = Path(__file__).resolve().parents[1]

# The waiver comments are assembled from halves so the text-based waiver
# scanner does not see live waivers inside the test files.
SWA = "# swcheck" + ": allow"

#: The pass that owns each rule (bad-waiver comes from run_all's audit,
#: which every pass selection runs).
PASS_OF = {
    **{r: "contract" for r in port_analysis.RULES if r.startswith("contract-")},
    "callback-under-lock": "concurrency", "blocking-call": "concurrency",
    "reachable-blocking": "concurrency", "lock-order": "concurrency",
    "duck-attr": "concurrency", "lint-coverage": "concurrency",
    "layering-jax": "layering", "layering-reshard": "layering",
    "marker-slow": "markers", "hotpath-copy": "hotpath",
    "proto-state": "protomodel", "proto-explore": "explore",
    "proto-compose": "compose", "wire-diff": "wirefuzz",
    "taint-integrity": "taint", "refine": "refine",
    "monitor-coverage": "refine", "cost-budget": "cost",
    "cost-model": "cost", "cost-site": "cost", "bad-waiver": "layering",
}


class Layout:
    def __init__(self, pkg: str, native: str, analysis):
        self.pkg = pkg
        self.native = native
        self.analysis = analysis

    def rel(self, logical: str) -> str:
        head, _, tail = logical.partition("/")
        if head == "pkg":
            return f"{self.pkg}/{tail}"
        if head == "native":
            return f"{self.native}/{tail}"
        return logical

    def text(self, s: str) -> str:
        return s if self.pkg == PORT.pkg else re.sub(
            r"\bstarway_tpu_torch\b", self.pkg, s)


PORT = Layout("starway_tpu_torch", "starway_tpu_torch/native", port_analysis)
JAX = Layout("starway_tpu", "native", jax_analysis)


def _seed_port(root: Path) -> None:
    pkg = root / "starway_tpu_torch"
    shutil.copytree(REPO / "starway_tpu_torch" / "core", pkg / "core",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(REPO / "starway_tpu_torch" / "errors.py", pkg / "errors.py")
    # The declared lint-surface extras: a seeded tree without them would
    # trip the lint-coverage missing-file check by design.
    for rel_ in port_analysis.base.LINT_EXTRA_FILES:
        shutil.copy2(REPO / rel_, root / rel_)
    (pkg / "native").mkdir()
    for name in ("sw_engine.h", "sw_engine.cpp"):
        shutil.copy2(REPO / "starway_tpu_torch" / "native" / name,
                     pkg / "native" / name)
    built = native_build.ensure_built()
    dst = native_build.artifact(root)
    dst.parent.mkdir(parents=True)
    shutil.copy2(built, dst)
    os.utime(dst)  # newer than the copied sources: fresh until mutated


def _seed_jax(root: Path) -> None:
    shutil.copytree(REPO / "starway_tpu" / "core", root / "starway_tpu" / "core",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("errors.py", "metrics.py"):
        (root / "starway_tpu" / name).write_text(
            (REPO / "starway_tpu" / name).read_text())
    (root / "native").mkdir()
    for name in ("sw_engine.h", "sw_engine.cpp"):
        (root / "native" / name).write_text((REPO / "native" / name).read_text())


def engine_version(layout: Layout = PORT) -> str:
    """The engine's version string as sw_version() returns it."""
    text = (REPO / layout.native / "sw_engine.cpp").read_text()
    m = re.search(r'sw_version\(\)\s*\{\s*return "([^"]+)"', text)
    assert m, "sw_version() not found"
    return m.group(1)


def ledger_row(engine: str, path: str, metric: str,
               layout: Layout = PORT) -> str:
    """The ledger's row for (engine, path, metric), as the file pads it."""
    text = (REPO / layout.pkg / "analysis" / "cost_budgets.txt").read_text()
    for line in text.splitlines():
        if line.split()[:3] == [engine, path, metric]:
            return line
    raise AssertionError(f"no ledger row {engine} {path} {metric}")


class Twin:
    """The port's seeded tree and the JAX package's, mutated together."""

    def __init__(self, tmp_path: Path):
        self.roots = {PORT: tmp_path / "port", JAX: tmp_path / "jax"}
        _seed_port(self.roots[PORT])
        _seed_jax(self.roots[JAX])
        self._cache: dict = {}

    @property
    def root(self) -> Path:
        """The port's seeded root."""
        return self.roots[PORT]

    def path(self, logical: str, layout: Layout = PORT) -> Path:
        return self.roots[layout] / layout.rel(logical)

    # -------------------------------------------------------- mutations
    def modify(self, logical: str, fn) -> None:
        """Rewrite the file on both trees through ``fn(text) -> text``."""
        self._cache.clear()
        for layout, root in self.roots.items():
            p = root / layout.rel(logical)
            p.parent.mkdir(parents=True, exist_ok=True)
            text = p.read_text() if p.exists() else ""
            new = fn(text)
            assert new != text, f"fixture drift: {logical} unchanged"
            p.write_text(new)

    def edit(self, logical: str, old: str, new: str) -> None:
        def fn(text):
            assert old in text, f"fixture drift: {old!r} not in {logical}"
            return text.replace(old, new, 1)
        self.modify(logical, fn)

    def write(self, logical: str, text: str, jax_text=None) -> None:
        """Write a file (in the port's spelling, renamed for the JAX tree,
        or ``jax_text`` there) into both trees."""
        self._cache.clear()
        for layout, root in self.roots.items():
            p = root / layout.rel(logical)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(jax_text if layout is JAX and jax_text is not None
                         else layout.text(text))

    def unlink(self, logical: str) -> None:
        self._cache.clear()
        for layout, root in self.roots.items():
            (root / layout.rel(logical)).unlink()

    # ------------------------------------------------------------ gates
    def run_all(self, passes=None, layout: Layout = PORT) -> list:
        key = (layout.pkg, tuple(passes) if passes else None)
        if key not in self._cache:
            self._cache[key] = layout.analysis.run_all(self.roots[layout],
                                                       passes)
        return self._cache[key]

    def _hits(self, rule, passes, layout) -> list:
        passes = passes or [PASS_OF[rule]]
        return [f for f in self.run_all(passes, layout) if f.rule == rule]

    def findings(self, rule: str, passes=None, parity: bool = True) -> list:
        """The port gate's findings of ``rule``; with ``parity`` the JAX
        gate fires the rule on its tree exactly when the port's does."""
        hits = self._hits(rule, passes, PORT)
        if parity:
            ref = self._hits(rule, passes, JAX)
            assert bool(hits) == bool(ref), (
                f"[{rule}] port gate: {[f.render() for f in hits]}; "
                f"JAX gate: {[f.render() for f in ref]}")
        return hits

    def caught(self, rule: str, needle: str, in_file: str,
               passes=None) -> None:
        """Both gates fire ``rule`` with ``needle`` in a message; the
        port's anchors at a real line of ``in_file``."""
        for layout in (PORT, JAX):
            hits = self._hits(rule, passes, layout)
            assert hits, f"rule {rule} did not fire ({layout.pkg} gate)"
            hit = next((f for f in hits if needle in f.message), None)
            assert hit is not None, (
                f"no [{rule}] finding of the {layout.pkg} gate mentions "
                f"{needle!r}: {hits}")
            assert hit.line > 0 and hit.file.endswith(in_file), hit.render()
            assert f"{hit.file}:{hit.line}: [{rule}]" in hit.render()
            if layout is PORT:
                assert hit.file.startswith("starway_tpu_torch/") or \
                    hit.file.startswith("tests/test_torch_"), hit.render()
