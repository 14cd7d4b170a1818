"""Pass 2 (v2): concurrency discipline over the lint surface.

The v1 pass was a single-function syntactic lint; it missed everything
that crossed a call boundary (the PR-6 review crop: a sampler thread
blocking inside an accept under the sample lock, a ``TxCtl`` crashing an
engine-thread attribute read).  v2 keeps the two direct lints and adds
four interprocedural analyses over a call graph of the lint surface
(``core/`` + the declared extras, base.LINT_EXTRA_FILES):

* ``callback-under-lock`` -- direct (v1 shape: ``_run_fires`` or a
  callback-shaped name invoked lexically inside ``with ...lock:``) and
  now *reachable*: a call made while a worker lock is held whose callee
  (transitively, deferred lambda/def bodies excluded) invokes a user
  callback.  DESIGN.md §2: callbacks never fire under a worker lock.
* ``blocking-call`` -- v1 direct lint, unchanged: ``time.sleep``,
  ``create_connection`` without ``timeout=``, ``settimeout(None)``,
  ``setblocking(True)`` anywhere on the engine-thread surface.
* ``reachable-blocking`` -- a call made while a lock is held whose
  callee transitively reaches a blocking primitive (the sampler-accept
  class of bug: lexically clean, blocking one call down).
* ``lock-order`` -- a lock-acquisition graph spanning the Python locks
  (worker ``.lock``, telemetry ``_lock``/``_sample_lock``, swtrace
  ``_reg_lock``, fabric ``_lock``) and the native mutex sites
  (``lock_guard``/``unique_lock`` in sw_engine.cpp, brace-scoped);
  edges are lexical nesting plus lock-held call sites whose callees
  acquire; any cycle is a finding.
* ``duck-attr`` -- the TX-item protocol checker: values read from the
  shared tx/journal/waiting queues are duck-typed (TxData / TxDevpull /
  TxCtl, discovered as the conn.py classes defining ``sess_wrap``);
  every attribute touched on such a value must exist on EVERY concrete
  type unless narrowed by ``isinstance`` or defaulted via ``getattr`` --
  the exact class of the PR-6 ``TxCtl.counted`` engine-thread crash.
* ``lint-coverage`` -- a module directly under ``starway_tpu_torch/`` that
  calls ``time.sleep`` without being part of the lint surface is a
  finding: new runtime modules must join base.LINT_EXTRA_FILES (or
  waive), so the pass file lists can never silently post-date the tree
  again (the gap that left starway_tpu_torch/metrics.py unpoliced).

Name resolution is duck-typed like the code it checks: a call resolves
to every same-named function/method defined on the surface (capped at 4
candidates -- beyond that the name is too generic to mean anything).
That over-approximates edges, which is safe for cycle/reachability
detection and keeps the pass honest about what it can see.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Optional

from .base import (
    Finding,
    LINT_EXTRA_FILES,
    lint_py_files,
    parse_or_finding,
    read_text,
    rel,
)

#: Names that, when *called* under a lock, are overwhelmingly user
#: callbacks (the worker protocol's done/fail/recv/accept/close hooks).
_CALLBACK_NAMES = {
    "done", "fail", "cb", "callback", "user_done", "accept_cb", "close_cb",
    "done_cb", "fail_cb", "on_done", "on_fail",
}

#: Queue attributes whose elements are TX-item protocol values (the
#: seeding set for the duck-attr checker; core/conn.py's shared tx
#: queue, the session replay journal, and the backpressure park queue).
_ITEM_QUEUES = {"tx", "journal", "waiting"}

#: Beyond this many same-named definitions a call target is too generic
#: to resolve meaningfully (``close``, ``run``...).
_MAX_CANDIDATES = 4

_REACH_DEPTH = 8


def _terminal_name(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _is_lock_expr(node: ast.AST) -> bool:
    name = _terminal_name(node)
    return name == "lock" or name.endswith("_lock")


def _lock_id(node: ast.AST, module: str) -> str:
    """Stable identity for a lock expression: module-level ``Name`` locks
    are per-module singletons (``telemetry._lock`` != ``fabric._lock``);
    attribute locks are an instance *class* keyed by attribute name
    (every ``x.lock`` is "the worker lock")."""
    if isinstance(node, ast.Name):
        return f"{module}.{node.id}"
    return f"*.{_terminal_name(node)}"


def _blocking_desc(node: ast.Call) -> Optional[str]:
    """Non-None when ``node`` is one of the blocking primitives."""
    func = node.func
    name = _terminal_name(func)
    if name == "sleep" and isinstance(func, ast.Attribute) \
            and _terminal_name(func.value) == "time":
        return "time.sleep"
    if name == "create_connection" \
            and not any(kw.arg == "timeout" for kw in node.keywords) \
            and len(node.args) < 2:  # timeout is the 2nd positional
        return "socket.create_connection without timeout="
    if name == "settimeout" and node.args \
            and isinstance(node.args[0], ast.Constant) \
            and node.args[0].value is None:
        return "settimeout(None)"
    if name == "setblocking" and node.args \
            and isinstance(node.args[0], ast.Constant) \
            and node.args[0].value is True:
        return "setblocking(True)"
    return None


# ------------------------------------------------------- direct lints (v1)


class _LockLint(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.lock_depth = 0
        self.findings: list = []

    # Function/lambda bodies are deferred execution: a callback *defined*
    # under a lock runs later, outside it (that is the allowed pattern).
    def _visit_deferred(self, node: ast.AST) -> None:
        saved, self.lock_depth = self.lock_depth, 0
        self.generic_visit(node)
        self.lock_depth = saved

    def visit_FunctionDef(self, node):        # noqa: N802
        self._visit_deferred(node)

    def visit_AsyncFunctionDef(self, node):   # noqa: N802
        self._visit_deferred(node)

    def visit_Lambda(self, node):             # noqa: N802
        self._visit_deferred(node)

    def visit_With(self, node):               # noqa: N802
        is_lock = any(_is_lock_expr(item.context_expr) for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        if is_lock:
            self.lock_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if is_lock:
            self.lock_depth -= 1

    def visit_Call(self, node):               # noqa: N802
        if self.lock_depth > 0:
            name = _terminal_name(node.func)
            if name == "_run_fires":
                self.findings.append(Finding(
                    self.relpath, node.lineno, "callback-under-lock",
                    "_run_fires invoked inside a `with ...lock:` block -- "
                    "collect into `fires` and run after release "
                    "(DESIGN.md §2: callbacks never fire under a worker lock)"))
            elif name in _CALLBACK_NAMES:
                self.findings.append(Finding(
                    self.relpath, node.lineno, "callback-under-lock",
                    f"callback `{name}(...)` invoked inside a `with ...lock:` "
                    "block -- defer it via `fires.append(...)` instead"))
        self.generic_visit(node)


class _BlockingLint(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.findings: list = []

    def visit_Call(self, node):               # noqa: N802
        desc = _blocking_desc(node)
        if desc == "time.sleep":
            self.findings.append(Finding(
                self.relpath, node.lineno, "blocking-call",
                "time.sleep under the engine-thread surface -- use a "
                "deadline timer (Worker._add_timer) instead"))
        elif desc == "socket.create_connection without timeout=":
            self.findings.append(Finding(
                self.relpath, node.lineno, "blocking-call",
                "socket.create_connection without timeout= can block the "
                "engine thread indefinitely (STARWAY_CONNECT_TIMEOUT exists "
                "for this)"))
        elif desc == "settimeout(None)":
            self.findings.append(Finding(
                self.relpath, node.lineno, "blocking-call",
                "settimeout(None) makes the socket blocking on the engine "
                "thread"))
        elif desc == "setblocking(True)":
            self.findings.append(Finding(
                self.relpath, node.lineno, "blocking-call",
                "setblocking(True) on an engine-thread socket"))
        self.generic_visit(node)


# --------------------------------------------- interprocedural summaries


class _FuncInfo:
    __slots__ = ("name", "qualname", "relpath", "blocking", "callbacks",
                 "acquires", "calls")

    def __init__(self, name: str, qualname: str, relpath: str):
        self.name = name
        self.qualname = qualname
        self.relpath = relpath
        self.blocking: list = []    # (line, desc)
        self.callbacks: list = []   # (line, name)
        self.acquires: list = []    # (lock_id, line)
        self.calls: list = []       # (name, line, tuple(held lock ids))


class _Summarizer(ast.NodeVisitor):
    """One pass over a function body collecting its summary facts.
    Nested function/lambda bodies are deferred execution and excluded."""

    def __init__(self, info: _FuncInfo, module: str):
        self.info = info
        self.module = module
        self.held: list = []

    def visit_FunctionDef(self, node):        # noqa: N802
        pass  # deferred

    def visit_AsyncFunctionDef(self, node):   # noqa: N802
        pass

    def visit_Lambda(self, node):             # noqa: N802
        pass

    def visit_With(self, node):               # noqa: N802
        lock_ids = [_lock_id(item.context_expr, self.module)
                    for item in node.items
                    if _is_lock_expr(item.context_expr)]
        for item in node.items:
            self.visit(item.context_expr)
        for lid in lock_ids:
            self.info.acquires.append((lid, node.lineno))
            self.held.append(lid)
        for stmt in node.body:
            self.visit(stmt)
        for _ in lock_ids:
            self.held.pop()

    def visit_Call(self, node):               # noqa: N802
        desc = _blocking_desc(node)
        if desc is not None:
            self.info.blocking.append((node.lineno, desc))
        name = _terminal_name(node.func)
        if name in _CALLBACK_NAMES or name == "_run_fires":
            self.info.callbacks.append((node.lineno, name))
        if name:
            self.info.calls.append((name, node.lineno, tuple(self.held)))
        self.generic_visit(node)


def _index_functions(root: Path, files: list) -> tuple[dict, list]:
    """{terminal name: [_FuncInfo]} over the surface, plus parse
    findings.  Only top-level functions and class methods are indexed
    (nested defs are deferred bodies)."""
    index: dict = {}
    findings: list = []
    for path in files:
        relpath = rel(root, path)
        module = path.stem
        tree, err = parse_or_finding(path, relpath)
        if tree is None:
            findings.append(err)
            continue
        defs: list = []
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.append((node.name, node))
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        defs.append((f"{node.name}.{sub.name}", sub))
        for qualname, node in defs:
            info = _FuncInfo(node.name, qualname, relpath)
            summ = _Summarizer(info, module)
            for stmt in node.body:
                summ.visit(stmt)
            index.setdefault(node.name, []).append(info)
    return index, findings


def _resolve(index: dict, name: str) -> list:
    cands = index.get(name, [])
    return cands if 0 < len(cands) <= _MAX_CANDIDATES else []


#: Sentinel for "this exploration was cut short by the cycle guard or
#: the depth bound": such a None is NOT a proven absence and must never
#: be memoized, or the answer becomes query-order dependent (a cycle
#: member probed first would cache a false 'unreachable' that later
#: suppresses a real finding).
_TRUNCATED = ("__truncated__",)


def _reach_fact(index: dict, info: _FuncInfo, kind: str,
                _memo: dict, _stack: set, depth: int = 0):
    """First (chain, line, detail) through which ``info`` reaches a
    blocking primitive / callback invocation; None when proven absent;
    ``_TRUNCATED`` when the search was cut short (cycle / depth bound)
    and absence is therefore unproven.  ``kind`` is
    "blocking" | "callback"."""
    key = (id(info), kind)
    if key in _memo:
        return _memo[key]
    if key in _stack or depth > _REACH_DEPTH:
        return _TRUNCATED
    direct = info.blocking if kind == "blocking" else info.callbacks
    if direct:
        line, detail = direct[0]
        _memo[key] = ((info.qualname,), line, detail)
        return _memo[key]
    _stack.add(key)
    result = None
    truncated = False
    for name, line, _held in info.calls:
        for callee in _resolve(index, name):
            sub = _reach_fact(index, callee, kind, _memo, _stack, depth + 1)
            if sub is _TRUNCATED:
                truncated = True
                continue
            if sub is not None:
                result = ((info.qualname,) + sub[0], sub[1], sub[2])
                break
        if result is not None:
            break
    _stack.discard(key)
    if result is None and truncated:
        return _TRUNCATED  # unproven: recompute from the next query root
    _memo[key] = result
    return result


def _interproc_findings(index: dict) -> list:
    out: list = []
    memo: dict = {}
    for infos in index.values():
        for info in infos:
            for name, line, held in info.calls:
                if not held:
                    continue
                for callee in _resolve(index, name):
                    blk = _reach_fact(index, callee, "blocking", memo, set())
                    if blk is not None and blk is not _TRUNCATED:
                        chain = " -> ".join(blk[0])
                        out.append(Finding(
                            info.relpath, line, "reachable-blocking",
                            f"`{name}(...)` called while holding "
                            f"{held[-1]} reaches {blk[2]} "
                            f"({chain}, {callee.relpath}:{blk[1]}) -- "
                            "blocking while a worker lock is held "
                            "wedges every thread behind it"))
                        break
                for callee in _resolve(index, name):
                    cb = _reach_fact(index, callee, "callback", memo, set())
                    if cb is not None and cb is not _TRUNCATED:
                        chain = " -> ".join(cb[0])
                        out.append(Finding(
                            info.relpath, line, "callback-under-lock",
                            f"`{name}(...)` called while holding "
                            f"{held[-1]} reaches user callback "
                            f"`{cb[2]}` ({chain}, {callee.relpath}:{cb[1]}) "
                            "-- callbacks never fire under a worker lock "
                            "(DESIGN.md §2)"))
                        break
    return out


# --------------------------------------------------------- lock ordering


def _acquire_reach(index: dict, info: _FuncInfo, depth: int,
                   seen: set) -> list:
    """Locks acquired by ``info`` or its callees (depth-limited)."""
    if id(info) in seen or depth > 3:
        return []
    seen.add(id(info))
    out = [(lid, info.relpath, line) for lid, line in info.acquires]
    for name, _line, _held in info.calls:
        for callee in _resolve(index, name):
            out.extend(_acquire_reach(index, callee, depth + 1, seen))
    return out


_CPP_GUARD_RE = re.compile(
    r"std::(?:lock_guard|unique_lock|scoped_lock)\s*<[^>]*>\s*\w+\s*\(\s*"
    r"([\w.>\-]+)\s*[,)]")


def _cpp_lock_edges(root: Path) -> tuple[list, list]:
    """(edges, acquire sites) from the native engine: brace-scoped
    ``lock_guard``/``unique_lock`` declarations; a guard declared while
    another guard's scope is still open is an ordering edge."""
    path = root / "starway_tpu_torch" / "native" / "sw_engine.cpp"
    if not path.is_file():
        return [], []
    relpath = "starway_tpu_torch/native/sw_engine.cpp"
    text = read_text(path)
    edges: list = []
    sites: list = []
    depth = 0
    held: list = []  # (lock_id, depth)
    line = 1
    i = 0
    while i < len(text):
        ch = text[i]
        if ch == "\n":
            line += 1
            i += 1
            continue
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            while held and held[-1][1] > depth:
                held.pop()
        elif ch == "s":
            m = _CPP_GUARD_RE.match(text, i)
            if m:
                raw = m.group(1)
                lid = "native." + raw.split("->")[-1].split(".")[-1]
                sites.append((lid, relpath, line))
                for outer, _d in held:
                    if outer != lid:
                        edges.append((outer, lid, relpath, line))
                held.append((lid, depth))
                i = m.end()
                continue
        i += 1
    return edges, sites


class _LockNest(ast.NodeVisitor):
    """Collect lexical lock-nesting edges within one function."""

    def __init__(self, relpath: str, module: str):
        self.relpath = relpath
        self.module = module
        self.held: list = []
        self.edges: list = []

    def visit_FunctionDef(self, node):        # noqa: N802
        pass

    def visit_AsyncFunctionDef(self, node):   # noqa: N802
        pass

    def visit_Lambda(self, node):             # noqa: N802
        pass

    def visit_With(self, node):               # noqa: N802
        lock_ids = [_lock_id(item.context_expr, self.module)
                    for item in node.items
                    if _is_lock_expr(item.context_expr)]
        for lid in lock_ids:
            for outer in self.held:
                if outer != lid:
                    self.edges.append((outer, lid, self.relpath,
                                       node.lineno))
            self.held.append(lid)
        for stmt in node.body:
            self.visit(stmt)
        for _ in lock_ids:
            self.held.pop()


def _find_cycle(edges: list) -> Optional[list]:
    graph: dict = {}
    sites: dict = {}
    for a, b, f, ln in edges:
        graph.setdefault(a, set()).add(b)
        sites.setdefault((a, b), (f, ln))
    color: dict = {}
    stack: list = []

    def dfs(n) -> Optional[list]:
        color[n] = 1
        stack.append(n)
        for m in sorted(graph.get(n, ())):
            if color.get(m, 0) == 1:
                return stack[stack.index(m):] + [m]
            if color.get(m, 0) == 0:
                cyc = dfs(m)
                if cyc is not None:
                    return cyc
        stack.pop()
        color[n] = 2
        return None

    for n in sorted(graph):
        if color.get(n, 0) == 0:
            cyc = dfs(n)
            if cyc is not None:
                return cyc
    return None


def _lock_order(root: Path, files: list, index: dict) -> list:
    edges: list = []
    for path in files:
        relpath = rel(root, path)
        tree, _err = parse_or_finding(path, relpath)
        if tree is None:
            continue
        nest = _LockNest(relpath, path.stem)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for stmt in node.body:
                    nest.visit(stmt)
        edges.extend(nest.edges)
    # Interprocedural: a call made with lock A held whose callee
    # (transitively) acquires B is an A -> B edge.
    for infos in index.values():
        for info in infos:
            for name, line, held in info.calls:
                if not held:
                    continue
                for callee in _resolve(index, name):
                    for lid, f, ln in _acquire_reach(index, callee, 0, set()):
                        for outer in held:
                            if outer != lid:
                                edges.append((outer, lid, info.relpath,
                                              line))
    cpp_edges, _sites = _cpp_lock_edges(root)
    edges.extend(cpp_edges)
    cycle = _find_cycle(edges)
    if cycle is None:
        return []
    # Anchor at the edge closing the cycle (the last hop's site).
    a, b = cycle[-2], cycle[-1]
    site = next(((f, ln) for x, y, f, ln in edges if (x, y) == (a, b)),
                (None, 1))
    return [Finding(
        site[0] or "starway_tpu_torch/core/engine.py", site[1], "lock-order",
        "lock acquisition cycle " + " -> ".join(cycle) + " -- two threads "
        "taking these locks in opposite orders deadlock (DESIGN.md §16)")]


# -------------------------------------------------- duck-type attributes


def _protocol_classes(root: Path) -> dict:
    """{class name: attribute set} for the TX-item protocol: the conn.py
    classes defining ``sess_wrap`` (TxData / TxDevpull / TxCtl today;
    discovery keeps a 4th item kind honest automatically)."""
    path = root / "starway_tpu_torch" / "core" / "conn.py"
    if not path.is_file():
        return {}
    tree, _err = parse_or_finding(path, "starway_tpu_torch/core/conn.py")
    if tree is None:
        return {}
    out: dict = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        methods = {n.name for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if "sess_wrap" not in methods:
            continue
        attrs = set(methods)
        for sub in node.body:
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == "__slots__" \
                            and isinstance(sub.value, (ast.Tuple, ast.List)):
                        attrs |= {e.value for e in sub.value.elts
                                  if isinstance(e, ast.Constant)
                                  and isinstance(e.value, str)}
        attrs.discard("__weakref__")
        out[node.name] = attrs
    return out


def _queue_expr(node: ast.AST) -> bool:
    """True for an expression denoting a TX-item queue (``self.tx``,
    ``sess.journal``, ``self.sess.waiting``...)."""
    return isinstance(node, ast.Attribute) and node.attr in _ITEM_QUEUES


class _DuckLint:
    """Flow-lite duck-type attribute checker for one function."""

    def __init__(self, relpath: str, classes: dict):
        self.relpath = relpath
        self.classes = classes
        self.all_types = frozenset(classes)
        self.findings: list = []

    def check(self, fn: ast.AST) -> None:
        self._body(fn.body, {}, set())

    # env: var name -> frozenset of possible protocol class names
    # colls: names bound to list(queue) style protocol collections
    def _body(self, stmts: list, env: dict, colls: set) -> None:
        for stmt in stmts:
            self._stmt(stmt, env, colls)

    def _seed_source(self, value: ast.AST, env: dict, colls: set) -> bool:
        """Does ``value`` yield a protocol item?  (queue[0], queue.popleft(),
        next(iter(queue))...)"""
        if isinstance(value, ast.Subscript) and _queue_expr(value.value):
            return True
        if isinstance(value, ast.Call) \
                and isinstance(value.func, ast.Attribute) \
                and value.func.attr in ("popleft", "pop") \
                and _queue_expr(value.func.value):
            return True
        return False

    def _coll_source(self, value: ast.AST, colls: set) -> bool:
        """list(queue) / tuple(queue) -- a named protocol collection."""
        if isinstance(value, ast.Call) and isinstance(value.func, ast.Name) \
                and value.func.id in ("list", "tuple") and value.args:
            arg = value.args[0]
            return _queue_expr(arg) or (isinstance(arg, ast.Name)
                                        and arg.id in colls)
        return False

    def _iter_seeds(self, it: ast.AST, colls: set) -> bool:
        return _queue_expr(it) or (isinstance(it, ast.Name)
                                   and it.id in colls)

    def _stmt(self, stmt: ast.AST, env: dict, colls: set) -> None:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            tgt = stmt.targets[0]
            self._expr(stmt.value, env, colls)
            if isinstance(tgt, ast.Name):
                if self._seed_source(stmt.value, env, colls):
                    env[tgt.id] = self.all_types
                elif self._coll_source(stmt.value, colls):
                    colls.add(tgt.id)
                    env.pop(tgt.id, None)
                else:
                    env.pop(tgt.id, None)
                    colls.discard(tgt.id)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                # Tuple targets rebind their element names (the `for
                # item, offered in spans:` shape) -- unseed them.
                for sub in tgt.elts:
                    for name in ast.walk(sub):
                        if isinstance(name, ast.Name):
                            env.pop(name.id, None)
                            colls.discard(name.id)
            else:
                # Attribute/Subscript target: a STORE on a protocol value
                # (`item.counted = True`) must satisfy the same contract
                # as a read -- and does not rebind the base name.
                self._expr(tgt, env, colls)
            return
        if isinstance(stmt, ast.For):
            self._expr(stmt.iter, env, colls)
            if isinstance(stmt.target, ast.Name):
                if self._iter_seeds(stmt.iter, colls):
                    env[stmt.target.id] = self.all_types
                else:
                    env.pop(stmt.target.id, None)
            else:
                for sub in ast.walk(stmt.target):
                    if isinstance(sub, ast.Name):
                        env.pop(sub.id, None)
            self._body(stmt.body, env, colls)
            self._body(stmt.orelse, env, colls)
            return
        if isinstance(stmt, ast.If):
            narrowed = self._narrow(stmt.test, env, colls)
            self._body(stmt.body, narrowed, colls)
            self._body(stmt.orelse, dict(env), colls)
            return
        if isinstance(stmt, (ast.While,)):
            # A while test narrows its body exactly like an if test.
            narrowed = self._narrow(stmt.test, env, colls)
            self._body(stmt.body, narrowed, colls)
            self._body(stmt.orelse, dict(env), colls)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._expr(item.context_expr, env, colls)
            self._body(stmt.body, env, colls)
            return
        if isinstance(stmt, ast.Try):
            self._body(stmt.body, env, colls)
            for h in stmt.handlers:
                self._body(h.body, dict(env), colls)
            self._body(stmt.orelse, env, colls)
            self._body(stmt.finalbody, env, colls)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs: deferred, out of scope
        if isinstance(stmt, ast.Expr):
            self._expr(stmt.value, env, colls)
            return
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            self._expr(stmt.value, env, colls)
            return
        if isinstance(stmt, ast.AugAssign):
            self._expr(stmt.target, env, colls)
            self._expr(stmt.value, env, colls)
            return
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self._expr(node, env, colls)
            elif isinstance(node, ast.stmt):
                self._stmt(node, env, colls)

    def _narrow(self, test: ast.AST, env: dict, colls: set) -> dict:
        """Evaluate a test for its checks AND return the env the If body
        sees (isinstance narrowing, including across `and` conjuncts)."""
        narrowed = dict(env)
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            for val in test.values:
                narrowed = self._narrow_one(val, narrowed, colls)
            return narrowed
        return self._narrow_one(test, narrowed, colls)

    def _narrow_one(self, test: ast.AST, env: dict, colls: set) -> dict:
        pos = test
        negate = False
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            pos = test.operand
            negate = True
        if isinstance(pos, ast.Call) and _terminal_name(pos.func) == "isinstance" \
                and len(pos.args) == 2 and isinstance(pos.args[0], ast.Name) \
                and pos.args[0].id in env:
            var = pos.args[0].id
            named = set()
            cls_arg = pos.args[1]
            elts = cls_arg.elts if isinstance(cls_arg, (ast.Tuple, ast.List)) \
                else [cls_arg]
            for e in elts:
                named.add(_terminal_name(e))
            hit = named & set(self.all_types)
            if hit:
                out = dict(env)
                out[var] = (env[var] - hit) if negate \
                    else (env[var] & frozenset(hit))
                return out
            return env
        self._expr(test, env, colls)
        return env

    def _expr(self, node: ast.AST, env: dict, colls: set) -> None:
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.And):
            cur = dict(env)
            for val in node.values:
                cur = self._narrow_one(val, cur, colls)
            return
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            var = node.value.id
            types = env.get(var)
            if types:
                missing = [c for c in sorted(types)
                           if node.attr not in self.classes[c]]
                if missing:
                    self.findings.append(Finding(
                        self.relpath, node.lineno, "duck-attr",
                        f"attribute `{node.attr}` read on a TX-item "
                        f"protocol value that may be {'/'.join(missing)} "
                        "-- which does not define it (narrow with "
                        "isinstance or use getattr; the PR-6 "
                        "TxCtl.counted crash class)"))
            self._expr(node.value, env, colls)
            return
        if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
            sub_env = dict(env)
            for gen in node.generators:
                self._expr(gen.iter, sub_env, colls)
                if isinstance(gen.target, ast.Name):
                    if self._iter_seeds(gen.iter, colls):
                        sub_env[gen.target.id] = self.all_types
                    else:
                        sub_env.pop(gen.target.id, None)
                for cond in gen.ifs:
                    sub_env = self._narrow(cond, sub_env, colls)
            self._expr(node.elt, sub_env, colls)
            return
        if isinstance(node, ast.Lambda):
            return  # deferred
        if isinstance(node, ast.Call):
            # getattr(item, "x", default) is the sanctioned escape hatch.
            if _terminal_name(node.func) == "getattr":
                for arg in node.args[1:]:
                    self._expr(arg, env, colls)
                return
            self._expr(node.func, env, colls)
            for arg in node.args:
                self._expr(arg, env, colls)
            for kw in node.keywords:
                self._expr(kw.value, env, colls)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, env, colls)


def _duck_findings(root: Path, files: list) -> list:
    classes = _protocol_classes(root)
    if not classes:
        return []  # conn.py reshaped: protomodel's vacuity guard owns it
    out: list = []
    for path in files:
        relpath = rel(root, path)
        tree, _err = parse_or_finding(path, relpath)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                lint = _DuckLint(relpath, classes)
                lint.check(node)
                out.extend(lint.findings)
    return out


# ------------------------------------------------------- coverage audit


def _coverage_findings(root: Path) -> list:
    """Top-level starway_tpu_torch modules using policed primitives must be in
    the lint surface; declared surface extras must exist."""
    out: list = []
    surface = {str(root / rel_) for rel_ in LINT_EXTRA_FILES}
    for rel_ in LINT_EXTRA_FILES:
        if not (root / rel_).is_file():
            out.append(Finding(
                rel_, 1, "lint-coverage",
                f"{rel_} is declared in the lint surface "
                "(analysis/base.py LINT_EXTRA_FILES) but does not exist "
                "-- the pass file lists drifted from the tree"))
    pkg = root / "starway_tpu_torch"
    if not pkg.is_dir():
        return out
    for path in sorted(pkg.glob("*.py")):
        if str(path) in surface:
            continue
        relpath = rel(root, path)
        tree, err = parse_or_finding(path, relpath)
        if tree is None:
            continue  # top-level modules outside the surface: no parse gate
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and _blocking_desc(node) == "time.sleep":
                out.append(Finding(
                    relpath, node.lineno, "lint-coverage",
                    f"{relpath} calls time.sleep but is outside the "
                    "swcheck lint surface -- add it to LINT_EXTRA_FILES "
                    "(analysis/base.py) so the concurrency/hotpath passes "
                    "police it, or waive here"))
                break
    return out


# ----------------------------------------------------------------- pass


def run(root: Path) -> list:
    out: list = []
    files = lint_py_files(root)
    for path in files:
        relpath = rel(root, path)
        tree, err = parse_or_finding(path, relpath)
        if tree is None:
            out.append(err)
            continue
        for lint_cls in (_LockLint, _BlockingLint):
            lint = lint_cls(relpath)
            lint.visit(tree)
            out.extend(lint.findings)
    index, idx_findings = _index_functions(root, files)
    out.extend(idx_findings)
    out.extend(_interproc_findings(index))
    out.extend(_lock_order(root, files, index))
    out.extend(_duck_findings(root, files))
    out.extend(_coverage_findings(root))
    return out
