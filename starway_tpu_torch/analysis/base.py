"""Shared plumbing for the swcheck passes: findings, waivers, repo layout.

Everything in starway_tpu_torch/analysis is stdlib-only (ast/re/struct/pathlib):
the checker must run in a bare CI venv and inside release_smoke.sh before
any dependency is installed, and it must be runnable against a *copy* of
the tree (tests/test_swcheck.py seeds violations into tmpdir mutations),
so no pass may import the modules it checks -- sources are parsed, never
executed.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional

#: Every rule a finding may carry (and a waiver may name).  Kept in one
#: place so --rules output, waiver validation, and the docs stay in sync.
RULES = {
    "contract-frames": "frame-type constants differ between engines",
    "contract-header": "wire header pack size differs between engines",
    "contract-shm": "shared-memory ring layout differs between engines",
    "contract-doorbell": "doorbell byte values differ between engines",
    "contract-abi": "sw_engine.h ABI vs core/native.py ctypes signatures",
    "contract-reason": "stable failure-reason strings drifted",
    "contract-handshake": "negotiated handshake key missing on one side",
    "contract-version": "native engine version string drifted",
    "contract-doctable": "frames.py docstring frame table drifted",
    "contract-trace": "swtrace event/counter vocabulary differs between engines",
    "contract-pulse": "swpulse histogram/stall vocabulary or bucket "
                      "resolution differs between engines",
    "callback-under-lock": "user callback invoked while holding a worker lock",
    "blocking-call": "blocking call reachable on the engine thread",
    "reachable-blocking": "blocking call reachable while a worker lock is held",
    "lock-order": "lock acquisition order forms a cycle (deadlock risk)",
    "duck-attr": "attribute read unsatisfied by a duck-typed protocol member",
    "lint-coverage": "runtime module outside the swcheck lint surface",
    "proto-state": "protocol state machines of the two engines disagree",
    "proto-explore": "session-model invariant violated under a fault schedule",
    "proto-compose": "composed-plane invariant (sessions x striping x fc x "
                     "integrity) violated under a fault schedule",
    "wire-diff": "frame/record decoders diverge between the engines (or "
                 "from the contract-derived oracle) on identical bytes",
    "taint-integrity": "payload bytes can reach a user buffer or callback "
                       "before the §19 CRC verify dominates them",
    "refine": "model<->code conformance broken: protocol-event vocabulary "
              "drifted, or a pinned event history diverges from the "
              "monitor compiled from the engines' own state machines",
    "monitor-coverage": "a protocol-model transition no pinned run ever "
                        "witnesses (stale model arm or dead code)",
    "cost-budget": "hot-path cost vector drifted from its "
                   "analysis/cost_budgets.txt pin (over = regression; "
                   "under = lower the pin to ratchet it in)",
    "cost-model": "swcost extraction stale: an anchor function, rx arm, "
                  "ledger row, or runtime-twin counter site is gone",
    "cost-site": "hot-path syscall/copy/alloc/lock site excluded from the "
                 "swcost ledger (waiver target; counted otherwise)",
    "layering-jax": "jax imported under core/ (device.py owns that boundary)",
    "layering-reshard": "reshard/-above-core/ boundary crossed (core/ "
                        "imports reshard, or jax bound outside reshard/api.py)",
    "marker-slow": "multi-GiB test payload without a `slow` marker",
    "hotpath-copy": "full-payload bytes()/.tobytes() copy on a core/ data path",
    "bad-waiver": "swcheck waiver without a justification string",
    "parse-error": "a scanned Python file does not parse",
}


@dataclass
class Finding:
    file: str  # repo-relative, /-separated
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


def find_root(start: Optional[str] = None) -> Path:
    """Resolve the repo root: --root wins, else cwd or the tree this
    installed/checked-out package lives in (parent of starway_tpu_torch/)."""
    if start is not None:
        return Path(start).resolve()
    candidates = [Path.cwd(), Path(__file__).resolve().parents[2]]
    for p in candidates:
        if (p / "starway_tpu_torch" / "native").is_dir():
            return p
    raise SystemExit(
        "swcheck: cannot locate the repo root (need starway_tpu_torch/ "
        "with its engine copy, starway_tpu_torch/native/); pass --root"
    )


def rel(root: Path, path: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


# Parse-once cache, cleared per run_all invocation: the gate runs many
# passes over the same small file set, and before this cache every pass
# re-read and re-parsed each source (the `explore` pass put the repeated
# cost over budget on the 1-core box).  Keyed by resolved path; safe
# because passes only *walk* trees, never mutate them.
_TEXT_CACHE: dict = {}
_TREE_CACHE: dict = {}


def clear_caches() -> None:
    _TEXT_CACHE.clear()
    _TREE_CACHE.clear()


def read_text(path: Path) -> str:
    key = str(path)
    if key not in _TEXT_CACHE:
        _TEXT_CACHE[key] = path.read_text(encoding="utf-8", errors="replace")
    return _TEXT_CACHE[key]


# --------------------------------------------------------------- waivers

_WAIVER_RE = re.compile(
    r"(?:#|//|/\*)\s*swcheck:\s*allow\(([\w\-, ]+)\)(?::\s*(.*?))?\s*(?:\*/\s*)?$"
)


def _waivers_on_line(text_lines: list[str], lineno: int) -> list[tuple[set, str, int]]:
    """Waiver comments attached to ``lineno`` (1-based): the line itself or
    the line directly above it.  Yields (rules, justification, waiver_line)."""
    out = []
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(text_lines):
            m = _WAIVER_RE.search(text_lines[ln - 1])
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                out.append((rules, (m.group(2) or "").strip(), ln))
    return out


def apply_waivers(root: Path, findings: Iterable[Finding]) -> list[Finding]:
    """Suppress findings carrying an explicit justified waiver.  A waiver
    naming the rule but missing the ``: why`` justification does NOT
    suppress -- it turns into a bad-waiver finding (the policy: every
    exception is written down)."""
    out: list[Finding] = []
    cache: dict[str, list[str]] = {}
    for f in findings:
        path = root / f.file
        if f.file not in cache:
            try:
                cache[f.file] = read_text(path).splitlines()
            except OSError:
                cache[f.file] = []
        waived = False
        for rules, why, waiver_line in _waivers_on_line(cache[f.file], f.line):
            if f.rule in rules:
                if why:
                    waived = True
                else:
                    # Anchored at the WAIVER's line with scan_bad_waivers'
                    # exact wording, so run_all's dedupe collapses the pair
                    # into one finding per bad waiver.
                    out.append(Finding(
                        f.file, waiver_line, "bad-waiver",
                        "waiver has no justification "
                        "(use `# swcheck: allow(rule): why`)",
                    ))
                    waived = True  # the original is replaced, not doubled
                break
        if not waived:
            out.append(f)
    return out


def scan_bad_waivers(root: Path, files: Iterable[Path]) -> list[Finding]:
    """Any waiver comment anywhere in the scanned set with an unknown rule
    name or an empty justification is itself a finding: waivers are part
    of the contract surface and must stay auditable."""
    out: list[Finding] = []
    for path in files:
        try:
            lines = read_text(path).splitlines()
        except OSError:
            continue
        for i, line in enumerate(lines, 1):
            m = _WAIVER_RE.search(line)
            if m is None:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            why = (m.group(2) or "").strip()
            unknown = rules - set(RULES)
            if unknown:
                out.append(Finding(
                    rel(root, path), i, "bad-waiver",
                    f"waiver names unknown rule(s) {sorted(unknown)}",
                ))
            elif not why:
                out.append(Finding(
                    rel(root, path), i, "bad-waiver",
                    "waiver has no justification "
                    "(use `# swcheck: allow(rule): why`)",
                ))
    return out


def parse_or_finding(path: Path, relpath: str):
    """(ast.Module, None) or (None, Finding): every lint pass reports an
    unparseable file under the shared ``parse-error`` rule with identical
    wording, so a pass run standalone cannot skip the file vacuously and
    run_all's dedupe collapses the cross-pass copies into one finding."""
    key = str(path)
    if key not in _TREE_CACHE:
        try:
            _TREE_CACHE[key] = (ast.parse(read_text(path)), None)
        except SyntaxError as e:
            _TREE_CACHE[key] = (None, Finding(
                relpath, e.lineno or 1, "parse-error",
                f"file does not parse: {e.msg}"))
    return _TREE_CACHE[key]


def core_py_files(root: Path) -> list[Path]:
    core = root / "starway_tpu_torch" / "core"
    if not core.is_dir():
        return []
    return sorted(p for p in core.rglob("*.py") if "__pycache__" not in p.parts)


#: Runtime modules OUTSIDE core/ that the concurrency/hotpath lints must
#: still police (they run threads or tail sockets next to the engine).
#: The `lint-coverage` check (analysis/concurrency.py) flags a top-level
#: module that grows a policed primitive without joining this list --
#: the gap core/session.py-era passes had for starway_tpu_torch/metrics.py.
#: The port's own top-level runtime modules join it: the device plane's
#: pull and its staging threads (device.py), the headline and pull-step
#: probes, the engine build and the bench CLI.
LINT_EXTRA_FILES = ("starway_tpu_torch/metrics.py",
                    "starway_tpu_torch/device.py",
                    "starway_tpu_torch/headline.py",
                    "starway_tpu_torch/ipc_steps.py",
                    "starway_tpu_torch/native_build.py",
                    "starway_tpu_torch/bench.py")


def lint_py_files(root: Path) -> list[Path]:
    """The full lint surface: every core/ module plus the declared
    extras.  A declared extra that is missing on disk is reported by the
    `lint-coverage` check, not silently skipped."""
    return core_py_files(root) + [
        root / rel_ for rel_ in LINT_EXTRA_FILES if (root / rel_).is_file()
    ]


def waiver_audit_files(root: Path) -> list[Path]:
    """Every file a finding can anchor to (so every file a waiver is
    honoured in): core/, tests/, plus the contract surface outside core/
    -- errors.py and the native sources.  A bad waiver anywhere in this
    set must be reported, not silently ignored."""
    extra = [
        root / "starway_tpu_torch" / "errors.py",
        root / "starway_tpu_torch" / "native" / "sw_engine.h",
        root / "starway_tpu_torch" / "native" / "sw_engine.cpp",
        # The swcost ledger carries in-place cost-budget waivers.
        root / "starway_tpu_torch" / "analysis" / "cost_budgets.txt",
    ]
    extra += [root / rel_ for rel_ in LINT_EXTRA_FILES]
    extra += sorted((root / "starway_tpu_torch").glob("*.py"))
    # reshard/ carries the layering-reshard rule, so its waivers must be
    # auditable too (rglob: nested modules are lint surface like core/'s).
    extra += sorted(p for p in (root / "starway_tpu_torch" / "reshard").rglob("*.py")
                    if "__pycache__" not in p.parts)
    seen: set = set()
    out = []
    for p in core_py_files(root) + test_files(root) + [p for p in extra
                                                       if p.is_file()]:
        if str(p) not in seen:
            seen.add(str(p))
            out.append(p)
    return out


def test_files(root: Path) -> list[Path]:
    tests = root / "tests"
    if not tests.is_dir():
        return []
    # The port's own tests: the JAX package's gate scans the rest.
    return sorted(tests.glob("test_torch_*.py"))
