"""Extract the C++ side of the two-engine contract from native sources.

Deliberately lightweight: the native tree is plain C++17 with C-style
declarations in the extern "C" header, so regexes over comment-stripped
text are enough -- no compiler needed (swcheck must run in a bare venv).
The extraction surface is part of the contract: constants must stay
``constexpr`` initialisations, reason strings ``const char* kName = "...";``,
and ABI declarations single-statement prototypes in sw_engine.h (see
DESIGN.md §11 for the add-a-constant recipe).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .base import read_text


def _strip_comments(text: str) -> str:
    """Remove // and /* */ comments, preserving line numbers (block
    comments are replaced by their newlines)."""

    def _block(m: re.Match) -> str:
        return "\n" * m.group(0).count("\n")

    text = re.sub(r"/\*.*?\*/", _block, text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    return text


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


_INT_SUFFIX = re.compile(r"(?<=[0-9a-fA-FxX])(?:[uU][lL]{0,2}|[lL]{1,2}[uU]?)\b")


def _eval_cpp_int(expr: str, env: dict) -> Optional[int]:
    """Evaluate a constexpr initialiser: ints (with u/l suffixes), hex,
    shifts, + * parentheses, and previously-extracted constant names."""
    expr = _INT_SUFFIX.sub("", expr.strip())
    if not re.fullmatch(r"[\w\s+\-*()<>x]+", expr):
        return None
    try:
        return int(eval(expr, {"__builtins__": {}}, dict(env)))  # noqa: S307
    except Exception:
        return None


@dataclass
class CppFunc:
    name: str
    ret: str                 # normalised C type, e.g. "char*", "int", "void"
    args: list               # normalised C types; [] for (void)
    line: int


@dataclass
class CppModel:
    constants: dict = field(default_factory=dict)   # name -> (int, line)
    reasons: dict = field(default_factory=dict)     # kName -> (str, line)
    trace_events: dict = field(default_factory=dict)  # kEv* -> (str, line)
    counter_names: Optional[tuple] = None           # (list[str], line)
    gauge_names: Optional[tuple] = None             # (list[str], line)
    hist_names: Optional[tuple] = None              # (list[str], line)
    stall_reasons: Optional[tuple] = None           # (list[str], line)
    version: Optional[tuple] = None                 # (str, line) from .cpp
    header_version: Optional[tuple] = None          # (str, line) from .h
    functions: dict = field(default_factory=dict)   # name -> CppFunc (.h)
    callbacks: dict = field(default_factory=dict)   # typedef -> CppFunc (.h)
    cpp_text: str = ""
    cpp_code: str = ""   # comment-stripped: literals that survive are CODE
    cpp_file: str = "starway_tpu_torch/native/sw_engine.cpp"
    h_file: str = "starway_tpu_torch/native/sw_engine.h"


_CONSTEXPR_RE = re.compile(
    r"(?:static\s+)?constexpr\s+(?:uint8_t|uint16_t|uint32_t|uint64_t|int|size_t|unsigned)\s+"
    r"([^;=]+=[^;]+);"
)

_REASON_RE = re.compile(r'const\s+char\s*\*\s*(k\w+)\s*=\s*"([^"]*)"\s*;')

# const char* kCounterNames[] = {"a", "b", ...}; -- the swtrace counter
# vocabulary (contract-trace pairs it with core/swtrace.py COUNTER_NAMES).
_COUNTERS_RE = re.compile(
    r"const\s+char\s*\*\s*kCounterNames\s*\[\s*\]\s*=\s*\{([^}]*)\}", re.S
)

# const char* kGaugeNames[] = {"a", ...}; -- the swscope per-conn gauge
# vocabulary (contract-trace pairs it with core/telemetry.py GAUGE_NAMES).
_GAUGES_RE = re.compile(
    r"const\s+char\s*\*\s*kGaugeNames\s*\[\s*\]\s*=\s*\{([^}]*)\}", re.S
)

# const char* kHistNames[] = {"a", ...}; -- the swpulse histogram
# vocabulary (contract-pulse pairs it with core/swtrace.py HIST_NAMES).
_HISTS_RE = re.compile(
    r"const\s+char\s*\*\s*kHistNames\s*\[\s*\]\s*=\s*\{([^}]*)\}", re.S
)

# const char* kStallReasons[] = {"stall-flush", ...}; -- the swpulse
# sentinel vocabulary (contract-pulse pairs it with STALL_REASONS).
_STALLS_RE = re.compile(
    r"const\s+char\s*\*\s*kStallReasons\s*\[\s*\]\s*=\s*\{([^}]*)\}", re.S
)

_VERSION_RE = re.compile(
    r'const\s+char\s*\*\s*sw_version\s*\(\s*\)\s*\{\s*return\s*"([^"]+)"\s*;'
)

_HDR_VERSION_RE = re.compile(r'swcheck:\s*engine-version\s*"([^"]+)"')

_TYPEDEF_RE = re.compile(
    r"typedef\s+(\w[\w\s\*]*?)\(\s*\*\s*(sw_\w+)\s*\)\s*\(([^)]*)\)\s*;", re.S
)

# No leading anchor: an anchor character (`;` of the previous declaration)
# would be consumed by each match and make finditer skip every other
# prototype.  The `sw_\w+(` shape is specific enough on its own -- no
# parameter in this header is itself a call expression.
_FUNC_RE = re.compile(
    r"((?:const\s+)?\w+\s*\**)\s*\b(sw_\w+)\s*\(([^;{)]*)\)\s*;", re.S
)


def _norm_type(raw: str) -> str:
    toks = raw.replace("*", " * ").split()
    toks = [t for t in toks if t != "const"]
    return "".join(toks) if toks else ""


def _parse_args(raw: str) -> list:
    raw = raw.strip()
    if not raw or raw == "void":
        return []
    out = []
    for piece in raw.split(","):
        toks = piece.replace("*", " * ").split()
        toks = [t for t in toks if t != "const"]
        # Drop a trailing parameter name (everything here is "type name";
        # the name is the token after the last type word / '*').
        if len(toks) > 1 and toks[-1] != "*" and re.fullmatch(r"\w+", toks[-1]):
            toks = toks[:-1]
        out.append("".join(toks))
    return out


def extract_cpp(root: Path) -> CppModel:
    model = CppModel()
    cpp_path = root / "starway_tpu_torch" / "native" / "sw_engine.cpp"
    h_path = root / "starway_tpu_torch" / "native" / "sw_engine.h"

    if cpp_path.is_file():
        raw = read_text(cpp_path)
        model.cpp_text = raw
        text = _strip_comments(raw)
        model.cpp_code = text
        for m in _CONSTEXPR_RE.finditer(text):
            line = _line_of(text, m.start())
            env = {k: v for k, (v, _) in model.constants.items()}
            for decl in m.group(1).split(","):
                if "=" not in decl:
                    continue
                name, expr = decl.split("=", 1)
                name = name.strip()
                val = _eval_cpp_int(expr, env)
                if re.fullmatch(r"\w+", name) and val is not None:
                    model.constants[name] = (val, line)
                    env[name] = val
        for m in _REASON_RE.finditer(text):
            name = m.group(1)
            entry = (m.group(2), _line_of(text, m.start()))
            if name.startswith("kEv"):
                model.trace_events[name] = entry
            else:
                model.reasons[name] = entry
        m = _COUNTERS_RE.search(text)
        if m:
            names = re.findall(r'"([^"]*)"', m.group(1))
            model.counter_names = (names, _line_of(text, m.start()))
        m = _GAUGES_RE.search(text)
        if m:
            names = re.findall(r'"([^"]*)"', m.group(1))
            model.gauge_names = (names, _line_of(text, m.start()))
        m = _HISTS_RE.search(text)
        if m:
            names = re.findall(r'"([^"]*)"', m.group(1))
            model.hist_names = (names, _line_of(text, m.start()))
        m = _STALLS_RE.search(text)
        if m:
            names = re.findall(r'"([^"]*)"', m.group(1))
            model.stall_reasons = (names, _line_of(text, m.start()))
        m = _VERSION_RE.search(text)
        if m:
            model.version = (m.group(1), _line_of(text, m.start()))

    if h_path.is_file():
        raw = read_text(h_path)
        m = _HDR_VERSION_RE.search(raw)
        if m:
            model.header_version = (m.group(1), _line_of(raw, m.start()))
        text = _strip_comments(raw)
        for m in _TYPEDEF_RE.finditer(text):
            model.callbacks[m.group(2)] = CppFunc(
                name=m.group(2),
                ret=_norm_type(m.group(1)),
                args=_parse_args(m.group(3)),
                line=_line_of(text, m.start()),
            )
        for m in _FUNC_RE.finditer(text):
            name = m.group(2)
            if name in model.callbacks:
                continue
            model.functions[name] = CppFunc(
                name=name,
                ret=_norm_type(m.group(1)),
                args=_parse_args(m.group(3)),
                line=_line_of(text, m.start(2)),
            )

    return model
