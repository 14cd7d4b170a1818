"""Pass 4: pytest ``slow``-marker guard over tests/.

Tier-1 CI runs ``pytest -m 'not slow'`` inside an 870 s budget; the soak
tests that move multi-GiB payloads live behind the ``slow`` marker
(registered in pyproject.toml).  This pass flags any test function that
folds a >= 2 GiB byte count out of literals without carrying the marker,
so a new soak cannot silently land inside the tier-1 budget.  (The
existing 1 GiB in-flight buffers in test_basic.py/test_sm.py are below
the threshold by design -- they are the reference-pinned contract tests.)
"""

from __future__ import annotations

import ast
from pathlib import Path

from .base import Finding, parse_or_finding, rel, test_files
from .py_model import _const_eval, module_int_constants

_THRESHOLD = 2 << 30  # 2 GiB: "multi-GiB" starts here
#: Ints at/above this are not byte counts: 64-bit tag masks
#: (0xFFFFFFFFFFFFFFFF wildcards) and probe-tag constants live up there.
_CEILING = 1 << 40


def _has_slow_mark(decorators) -> bool:
    for dec in decorators:
        for node in ast.walk(dec):
            if isinstance(node, ast.Attribute) and node.attr == "slow":
                return True
    return False


def _module_slow(tree: ast.Module) -> bool:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "pytestmark"
            for t in node.targets
        ):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Attribute) and sub.attr == "slow":
                    return True
    return False


def _max_folded(node: ast.AST, env: dict) -> int:
    """Largest integer any (sub)expression in ``node`` folds to."""
    best = 0
    for sub in ast.walk(node):
        if isinstance(sub, (ast.BinOp, ast.Constant, ast.Name)):
            v = _const_eval(sub, env)
            if v is not None and best < v < _CEILING:
                best = v
    return best


def run(root: Path) -> list:
    out: list = []
    for path in test_files(root):
        relpath = rel(root, path)
        tree, err = parse_or_finding(path, relpath)
        if tree is None:
            out.append(err)
            continue
        if _module_slow(tree):
            continue
        env = {k: v for k, (v, _) in module_int_constants(tree).items()}
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not node.name.startswith("test_"):
                continue
            if _has_slow_mark(node.decorator_list):
                continue
            # Decorators count too: a parametrized payload size
            # (@pytest.mark.parametrize("size", [4 << 30])) is the house
            # style for soaks and must not evade the guard.
            biggest = max(
                [_max_folded(stmt, env) for stmt in node.body]
                + [_max_folded(dec, env) for dec in node.decorator_list],
                default=0)
            if biggest >= _THRESHOLD:
                out.append(Finding(
                    relpath, node.lineno, "marker-slow",
                    f"{node.name} folds a {biggest / (1 << 30):.1f} GiB "
                    "constant but carries no @pytest.mark.slow -- multi-GiB "
                    "payload tests must stay out of the tier-1 870 s budget"))
    return out
