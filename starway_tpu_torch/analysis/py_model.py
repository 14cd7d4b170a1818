"""Extract the Python side of the two-engine contract.

Sources are parsed with ``ast`` -- never imported -- so the checker can run
against mutated copies of the tree (tests/test_swcheck.py) and in a venv
with no third-party packages installed.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .base import read_text


def _const_eval(node: ast.AST, env: dict) -> Optional[int]:
    """Fold a small integer expression: literals, names from ``env``, and
    + - * ** << >> arithmetic (the shapes layout constants are written in)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.Name):
        v = env.get(node.id)
        return v if isinstance(v, int) else None
    if isinstance(node, ast.BinOp):
        lo = _const_eval(node.left, env)
        hi = _const_eval(node.right, env)
        if lo is None or hi is None:
            return None
        try:
            if isinstance(node.op, ast.Add):
                return lo + hi
            if isinstance(node.op, ast.Sub):
                return lo - hi
            if isinstance(node.op, ast.Mult):
                return lo * hi
            if isinstance(node.op, ast.Pow):
                return lo ** hi if hi < 128 else None
            if isinstance(node.op, ast.LShift):
                return lo << hi if hi < 128 else None
            if isinstance(node.op, ast.RShift):
                return lo >> hi
            if isinstance(node.op, ast.FloorDiv):
                return lo // hi if hi else None
        except (OverflowError, ValueError):
            return None
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_eval(node.operand, env)
        return -v if v is not None else None
    return None


def module_int_constants(tree: ast.Module) -> dict:
    """Top-level NAME = <int expr> assignments -> {name: (value, line)}."""
    out: dict = {}
    env: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            val = _const_eval(node.value, env)
            if val is not None:
                name = node.targets[0].id
                out[name] = (val, node.lineno)
                env[name] = val
    return out


def module_str_constants(tree: ast.Module) -> dict:
    out: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            out[node.targets[0].id] = (node.value.value, node.lineno)
    return out


def code_string_literals(tree: ast.Module) -> set:
    """Every string literal that is CODE, not documentation: all str
    constants except docstrings (first Expr of a module/class/function
    body).  Searching these instead of raw source keeps vacuity out of
    substring checks -- a key surviving only in a comment or docstring
    must not count as 'referenced'."""
    doc_ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                doc_ids.add(id(body[0].value))
    return {
        node.value
        for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
        and id(node) not in doc_ids
    }


def canon_ctypes(node: ast.AST) -> str:
    """Canonical spelling for a ctypes signature element:
    ``ctypes.c_void_p`` -> "c_void_p", ``_DONE_CB`` -> "_DONE_CB",
    ``ctypes.POINTER(ctypes.c_uint64)`` -> "POINTER(c_uint64)"."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Call):
        args = ", ".join(canon_ctypes(a) for a in node.args)
        return f"{canon_ctypes(node.func)}({args})"
    if isinstance(node, ast.Constant):
        return repr(node.value)
    return ast.dump(node)


@dataclass
class PyModel:
    frames: dict = field(default_factory=dict)       # T_* -> (int, line)
    header_fmt: Optional[tuple] = None               # (fmt str, line)
    sdata_sub_fmt: Optional[tuple] = None            # (fmt str, line)
    frames_doc: Optional[str] = None                 # module docstring
    shm: dict = field(default_factory=dict)          # layout name -> (int, line)
    doorbell: dict = field(default_factory=dict)     # DB_* -> (int, line)
    reasons: dict = field(default_factory=dict)      # REASON_* -> (str, line)
    argtypes: dict = field(default_factory=dict)     # fn -> (list[str], line)
    restype: dict = field(default_factory=dict)      # fn -> (str, line)
    cfunctypes: dict = field(default_factory=dict)   # _X_CB -> (list[str], line)
    engine_strings: set = field(default_factory=set)  # engine.py code literals
    trace_events: dict = field(default_factory=dict)  # EV_* -> (str, line)
    counter_names: Optional[tuple] = None            # (list[str], line)
    gauge_names: Optional[tuple] = None              # (list[str], line)
    hist_names: Optional[tuple] = None               # (list[str], line)
    hist_buckets: Optional[tuple] = None             # (int, line)
    stall_reasons: Optional[tuple] = None            # (list[str], line)
    native_text: str = ""                            # core/native.py source
    files: dict = field(default_factory=dict)        # logical -> repo-rel path


def _parse(path: Path) -> Optional[ast.Module]:
    try:
        return ast.parse(read_text(path))
    except (OSError, SyntaxError):
        return None


def extract_py(root: Path) -> PyModel:
    model = PyModel()
    core = root / "starway_tpu_torch" / "core"
    model.files = {
        "frames": "starway_tpu_torch/core/frames.py",
        "shmring": "starway_tpu_torch/core/shmring.py",
        "conn": "starway_tpu_torch/core/conn.py",
        "native": "starway_tpu_torch/core/native.py",
        "engine": "starway_tpu_torch/core/engine.py",
        "errors": "starway_tpu_torch/errors.py",
        "swtrace": "starway_tpu_torch/core/swtrace.py",
        "telemetry": "starway_tpu_torch/core/telemetry.py",
    }

    tree = _parse(core / "frames.py")
    if tree is not None:
        model.frames = {
            k: v for k, v in module_int_constants(tree).items()
            if k.startswith("T_")
        }
        model.frames_doc = ast.get_docstring(tree)
        for node in tree.body:
            # HEADER = struct.Struct("<BQQ") / SDATA_SUB = struct.Struct("<QQQ")
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id in ("HEADER", "SDATA_SUB") \
                    and isinstance(node.value, ast.Call) \
                    and node.value.args \
                    and isinstance(node.value.args[0], ast.Constant) \
                    and isinstance(node.value.args[0].value, str):
                rec = (node.value.args[0].value, node.lineno)
                if node.targets[0].id == "HEADER":
                    model.header_fmt = rec
                else:
                    model.sdata_sub_fmt = rec

    tree = _parse(core / "shmring.py")
    if tree is not None:
        consts = module_int_constants(tree)
        for name in ("MAGIC", "GLOBAL_HDR", "RING_HDR", "DATA_OFF",
                     "OFF_TAIL", "OFF_HEAD", "REC_HDR"):
            if name in consts:
                model.shm[name] = consts[name]

    tree = _parse(core / "conn.py")
    if tree is not None:
        consts = module_int_constants(tree)
        for name in ("DB_DATA", "DB_STARVING"):
            if name in consts:
                model.doorbell[name] = consts[name]

    tree = _parse(root / "starway_tpu_torch" / "errors.py")
    if tree is not None:
        model.reasons = {
            k: v for k, v in module_str_constants(tree).items()
            if k.startswith("REASON_")
        }

    native_path = core / "native.py"
    tree = _parse(native_path)
    if tree is not None:
        model.native_text = read_text(native_path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            # lib.<fn>.argtypes / lib.<fn>.restype assignments (inside load())
            if isinstance(tgt, ast.Attribute) \
                    and isinstance(tgt.value, ast.Attribute) \
                    and isinstance(tgt.value.value, ast.Name) \
                    and tgt.value.value.id == "lib":
                fn = tgt.value.attr
                if tgt.attr == "argtypes" and isinstance(node.value, ast.List):
                    model.argtypes[fn] = (
                        [canon_ctypes(e) for e in node.value.elts], node.lineno)
                elif tgt.attr == "restype":
                    model.restype[fn] = (canon_ctypes(node.value), node.lineno)
            # _X_CB = ctypes.CFUNCTYPE(None, ...)
            elif isinstance(tgt, ast.Name) and tgt.id.endswith("_CB") \
                    and isinstance(node.value, ast.Call) \
                    and canon_ctypes(node.value.func) == "CFUNCTYPE":
                model.cfunctypes[tgt.id] = (
                    [canon_ctypes(e) for e in node.value.args], node.lineno)

    tree = _parse(core / "engine.py")
    if tree is not None:
        model.engine_strings = code_string_literals(tree)

    tree = _parse(core / "swtrace.py")
    if tree is not None:
        model.trace_events = {
            k: v for k, v in module_str_constants(tree).items()
            if k.startswith("EV_")
        }
        # HIST_BUCKETS = 64 -- the swpulse histogram resolution
        # (contract-pulse pairs it with the kHistBuckets constexpr).
        consts = module_int_constants(tree)
        if "HIST_BUCKETS" in consts:
            model.hist_buckets = consts["HIST_BUCKETS"]
        for node in tree.body:
            # COUNTER_NAMES = ("sends_posted", ...) -- the shared counter
            # vocabulary (contract-trace pairs it with kCounterNames[]);
            # HIST_NAMES / STALL_REASONS are the swpulse twins (DESIGN.md
            # §25; contract-pulse pairs them with kHistNames[] /
            # kStallReasons[]).
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id in ("COUNTER_NAMES", "HIST_NAMES",
                                               "STALL_REASONS") \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                names = [e.value for e in node.value.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str)]
                rec = (names, node.lineno)
                if node.targets[0].id == "COUNTER_NAMES":
                    model.counter_names = rec
                elif node.targets[0].id == "HIST_NAMES":
                    model.hist_names = rec
                else:
                    model.stall_reasons = rec

    tree = _parse(core / "telemetry.py")
    if tree is not None:
        for node in tree.body:
            # GAUGE_NAMES = ("tx_queue_depth", ...) -- the swscope per-conn
            # gauge vocabulary (contract-trace pairs it with kGaugeNames[]).
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "GAUGE_NAMES" \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                names = [e.value for e in node.value.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str)]
                model.gauge_names = (names, node.lineno)

    return model
