"""Pass 5: hot-path copy hygiene over starway_tpu_torch/core/.

The data plane is zero-copy by design (DESIGN.md §12): payload bytes move
from the user's buffer to the transport (and back) through memoryview
slices, never through intermediate materialisations.  A stray ``bytes(buf)``
or ``buf.tobytes()`` on a core/ data path silently reintroduces a
full-payload copy -- exactly the class of regression this PR removed from
the JSON control parsers (core/conn.py, core/engine.py).

Flagged (rule ``hotpath-copy``):

* ``bytes(x)`` where ``x`` is a name/attribute/call/subscript -- i.e. a
  buffer being copied.  Literal constructions (``bytes([val])``,
  ``bytes(17)``, ``bytes()``) are allocation, not copying, and are skipped.
* any ``x.tobytes()`` call.

Scanned: the full lint surface (every ``core/*.py`` plus
``base.LINT_EXTRA_FILES``) except ``frames.py`` -- the control-frame
codec builds/parses small bounded JSON bodies, and its one documented
``tobytes`` (the memoryview escape hatch in ``unpack_json_body``) is not a
payload path.  Genuinely-needed copies elsewhere take an explicit waiver:
``# swcheck: allow(hotpath-copy): why``.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .base import Finding, lint_py_files, parse_or_finding, rel


def _is_literal_arg(node: ast.AST) -> bool:
    """bytes(...) arguments that allocate rather than copy."""
    return isinstance(node, (ast.Constant, ast.List, ast.Tuple, ast.ListComp,
                             ast.GeneratorExp, ast.Starred))


class _CopyLint(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.findings: list = []

    def visit_Call(self, node):               # noqa: N802
        func = node.func
        if (isinstance(func, ast.Name) and func.id == "bytes"
                and len(node.args) == 1 and not node.keywords
                and not _is_literal_arg(node.args[0])):
            self.findings.append(Finding(
                self.relpath, node.lineno, "hotpath-copy",
                "bytes(...) materialises a full copy of its buffer on a "
                "core/ data path -- slice the memoryview (or pass the "
                "buffer straight to the consumer) instead"))
        elif (isinstance(func, ast.Attribute) and func.attr == "tobytes"):
            self.findings.append(Finding(
                self.relpath, node.lineno, "hotpath-copy",
                ".tobytes() materialises a full copy on a core/ data path "
                "-- keep the memoryview"))
        self.generic_visit(node)


def run(root: Path) -> list:
    out: list = []
    for path in lint_py_files(root):
        if path.name == "frames.py":
            continue  # control-frame codec: small bounded bodies (docstring)
        relpath = rel(root, path)
        tree, err = parse_or_finding(path, relpath)
        if tree is None:
            out.append(err)
            continue
        lint = _CopyLint(relpath)
        lint.visit(tree)
        out.extend(lint.findings)
    return out
