"""Pass 3: layering lint -- the import-direction rules between layers.

Two rows, one discipline (dependencies point DOWN the stack only):

* **core/ imports no torch and no jax** (``layering-jax``).  The matcher and
  transports are byte-oriented; device awareness enters only through the
  duck-typed sink/payload protocols in device.py (CLAUDE.md architecture
  invariants).  A jax import in core/ would make the host transport
  unimportable in torch-free processes (core.native runs with only
  numpy installed) and couple the engine to the device plane.
* **reshard/ sits above core/** (``layering-reshard``, DESIGN.md §20).
  Both directions of the boundary: no module under core/ may import
  ``starway_tpu_torch.reshard`` (the engine must not know schedules exist),
  and under reshard/ only ``api.py`` -- the torch adapter -- may import
  torch (and none of them jax), so the planner/executor stay runnable
  in torch-free processes the same way core/ does.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .base import Finding, core_py_files, parse_or_finding, rel

#: The one reshard/ module allowed to bind the framework (the adapter) --
#: exact repo-relative path, so a nested helper named api.py is NOT exempt.
RESHARD_JAX_OK = ("starway_tpu_torch/reshard/api.py",)

#: The framework these rules guard is the port's, torch; jax (the JAX
#: package's) may be bound by none of these modules, the adapter included.
#: The rule names stay the JAX gate's so waivers and --rules line up.
FRAMEWORKS = ("torch", "jax")


def _is_jax(module: str, frameworks=FRAMEWORKS) -> bool:
    return any(module == m or module.startswith(m + ".") for m in frameworks)


def _is_reshard(module: str, level: int) -> bool:
    if level == 0:
        return (module == "starway_tpu_torch.reshard"
                or module.startswith("starway_tpu_torch.reshard."))
    # Relative imports from core/ modules: `..reshard` is level 2,
    # module "reshard" (or "reshard.plan").
    return module == "reshard" or module.startswith("reshard.")


def _names_package_root(node: "ast.ImportFrom") -> bool:
    """Does this ImportFrom's module part resolve to the starway_tpu_torch
    package root (from a core/ module)?  Then its alias names can bind
    reshard: `from starway_tpu_torch import reshard`, `from .. import
    reshard`."""
    if node.level == 0:
        return node.module == "starway_tpu_torch"
    return node.level == 2 and not node.module


def reshard_py_files(root: Path) -> list:
    pkg = root / "starway_tpu_torch" / "reshard"
    if not pkg.is_dir():
        return []
    return sorted(p for p in pkg.rglob("*.py") if "__pycache__" not in p.parts)


def run(root: Path) -> list:
    out: list = []
    for path in core_py_files(root):
        relpath = rel(root, path)
        tree, err = parse_or_finding(path, relpath)
        if tree is None:
            out.append(err)
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if _is_jax(alias.name):
                        out.append(Finding(
                            relpath, node.lineno, "layering-jax",
                            f"`import {alias.name}` under core/ -- device "
                            "awareness enters only via device.py's "
                            "duck-typed sink/payload protocols"))
                    elif _is_reshard(alias.name, 0):
                        out.append(Finding(
                            relpath, node.lineno, "layering-reshard",
                            f"`import {alias.name}` under core/ -- "
                            "reshard/ sits ABOVE core/; the engine must "
                            "not import the schedule layer"))
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0 and node.module and _is_jax(node.module):
                    out.append(Finding(
                        relpath, node.lineno, "layering-jax",
                        f"`from {node.module} import ...` under core/ -- "
                        "device awareness enters only via device.py"))
                elif node.module and _is_reshard(node.module, node.level):
                    out.append(Finding(
                        relpath, node.lineno, "layering-reshard",
                        f"`from {'.' * node.level}{node.module} import ...` "
                        "under core/ -- reshard/ sits ABOVE core/; the "
                        "engine must not import the schedule layer"))
                elif _names_package_root(node):
                    # `from starway_tpu_torch import reshard` / `from .. import
                    # reshard` bind the subpackage through the package
                    # root -- same boundary, different spelling.
                    for alias in node.names:
                        if (alias.name == "reshard"
                                or alias.name.startswith("reshard.")):
                            out.append(Finding(
                                relpath, node.lineno, "layering-reshard",
                                f"`from {node.module or '.' * node.level} "
                                f"import {alias.name}` under core/ -- "
                                "reshard/ sits ABOVE core/; the engine "
                                "must not import the schedule layer"))
    for path in reshard_py_files(root):
        relpath = rel(root, path)
        banned = ("jax",) if relpath in RESHARD_JAX_OK else FRAMEWORKS
        tree, err = parse_or_finding(path, relpath)
        if tree is None:
            out.append(err)
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if _is_jax(alias.name, banned):
                        out.append(Finding(
                            relpath, node.lineno, "layering-reshard",
                            f"`import {alias.name}` in reshard/{path.name} "
                            "-- only the api.py adapter may bind torch; the "
                            "planner/executor stay jax-free (DESIGN.md §20)"))
            elif isinstance(node, ast.ImportFrom):
                if (node.level == 0 and node.module
                        and _is_jax(node.module, banned)):
                    out.append(Finding(
                        relpath, node.lineno, "layering-reshard",
                        f"`from {node.module} import ...` in "
                        f"reshard/{path.name} -- only the api.py adapter "
                        "may bind torch (DESIGN.md §20)"))
    return out
