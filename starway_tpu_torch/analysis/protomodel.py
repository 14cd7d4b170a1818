"""Pass: protomodel -- cross-engine protocol state-machine extraction.

swcheck's `contract` pass (DESIGN.md §11) diffs *constants*; this pass
diffs *behavior*: the frame-dispatch / session state machine is extracted
from BOTH engines and compared transition-by-transition, so an engine
that grows, drops, or reroutes a dispatch arm without the twin change in
the other engine fails the gate -- the class of drift that shipped the
T_SEQ late-delivery and `:sup`-marker bugs past the constant diff.

**The shared machine** (DESIGN.md §16).  States:

* ``hello-sent`` -- connector blocked in the handshake (HELLO on the
  wire, HELLO_ACK awaited);
* ``estab``      -- framed-stream dispatch (the `_pump_frames` /
  `pump_stream` parser; the server's pre-HELLO accept state is folded in
  -- the same parser object handles both, gated by ``handshaken``);
* ``suspended``  -- session transport lost, resumable (§14).

Inputs are frame names (``DATA`` ... ``BYE``, ``OTHER`` for the
unknown-frame arm) plus the session lifecycle events ``lost`` / ``resume``
/ ``expire``.  Next-states may be sets (``estab|down``): a dispatch arm
that conditionally tears the conn down has both outcomes.

**Python extraction** is syntactic (ast, sources never imported):

* every ``ftype == frames.T_X`` / ``ftype in (frames.T_A, ...)``
  comparison in ``core/conn.py`` is a dispatch arm in ``estab``; the arm's
  next-states are ``down`` when it (or a ``self._x`` helper it calls, one
  level deep) reaches ``_conn_broken``/``raise``, ``expired`` when it
  assigns ``.expired = True``, plus ``estab`` unless the teardown is
  unconditional.  A trailing ``else`` arm contributes the ``OTHER``
  transition only when it tears the conn down.
* ``ftype != frames.T_X`` guarding a ``raise`` in ``core/engine.py`` is
  the connector's blocking handshake: ``(hello-sent, X) -> estab`` and
  ``(hello-sent, OTHER) -> down``.
* the session lifecycle comes from ``core/engine.py``'s ``_sess_*``
  bodies: ``_sess_suspend`` calling ``.suspend()`` is ``(estab, lost) ->
  suspended``; a ``.resume()`` call inside ``_sess_redial``/``_sess_hello``
  is ``(suspended, resume) -> estab``; ``_sess_expire`` assigning
  ``.expired = True`` is ``(suspended, expire) -> expired``.

**Native extraction** is annotation-anchored (the `swcheck:
engine-version` precedent): every dispatch site in ``native/sw_engine.cpp``
carries ``// swcheck: state(<state>, <frame>, <next>[|<next>...])``.
Both extractions are vacuity-guarded -- an empty machine is a finding,
never a pass -- and every diff finding is waiver-able at its anchor line.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Optional

from .base import Finding, parse_or_finding, read_text

#: Annotation vocabulary -- unknown tokens are malformed-annotation
#: findings, so a typo'd state can never vacuously "agree".
KNOWN_STATES = {"hello-sent", "estab", "suspended"}
KNOWN_INPUTS = {
    "HELLO", "HELLO_ACK", "DATA", "FLUSH", "FLUSH_ACK", "DEVPULL",
    "PING", "PONG", "SEQ", "ACK", "BYE", "SDATA", "SACK", "OTHER",
    "CREDIT", "RTS", "CTS", "CSUM", "SNACK",
    "lost", "resume", "expire",
}
KNOWN_NEXTS = {"estab", "down", "expired", "suspended"}

_CPP_STATE_RE = re.compile(r"swcheck:\s*state\(([^)]*)\)")


def _terminal(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _frame_name(node: ast.AST) -> Optional[str]:
    """frames.T_DATA / T_DATA -> "DATA" (None when not a frame const)."""
    name = _terminal(node)
    if name.startswith("T_"):
        return name[2:]
    return None


def _self_method_calls(body: list) -> set:
    """Terminal names of ``self._x(...)`` calls in ``body`` (the one-level
    inline set for next-state inference)."""
    out = set()
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self":
                out.add(node.func.attr)
    return out


def _scan_effects(nodes: list) -> tuple[bool, bool]:
    """(tears_down, sets_expired) anywhere in ``nodes``."""
    down = expired = False
    for stmt in nodes:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) \
                    and _terminal(node.func) in ("_conn_broken", "conn_broken"):
                down = True
            elif isinstance(node, ast.Raise):
                down = True
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and tgt.attr == "expired" \
                            and isinstance(node.value, ast.Constant) \
                            and node.value.value is True:
                        expired = True
    return down, expired


def _unconditional_down(body: list) -> bool:
    """True when a statement DIRECTLY in ``body`` (not nested under a
    conditional) tears the conn down -- the unknown-frame arm shape."""
    for stmt in body:
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call) \
                and _terminal(stmt.value.func) in ("_conn_broken",
                                                   "conn_broken"):
            return True
        if isinstance(stmt, ast.Raise):
            return True
    return False


def _branch_nexts(body: list, class_methods: dict) -> set:
    """Next-state set for one dispatch arm: the arm's own statements plus
    the bodies of same-class ``self._x()`` helpers it calls (one level --
    `_on_seq`-style dispatch helpers, not the whole transitive engine)."""
    down, expired = _scan_effects(body)
    for name in _self_method_calls(body):
        helper = class_methods.get(name)
        if helper is not None:
            hd, he = _scan_effects(helper.body)
            down = down or hd
            expired = expired or he
    nexts = set()
    if down:
        nexts.add("down")
    if expired:
        nexts.add("expired")
    if not _unconditional_down(body):
        nexts.add("estab")
    return nexts


class _Machine:
    """{(state, input): (next-state set, file, line)} with set-union merge
    (the same arm reached through two dispatch shapes stays one row)."""

    def __init__(self) -> None:
        self.transitions: dict = {}

    def add(self, state: str, inp: str, nexts: set, file: str, line: int) -> None:
        key = (state, inp)
        if key in self.transitions:
            old, f, ln = self.transitions[key]
            self.transitions[key] = (old | set(nexts), f, ln)
        else:
            self.transitions[key] = (set(nexts), file, line)


def _walk_ftype_dispatch(tree: ast.Module, relfile: str,
                         machine: _Machine) -> None:
    """Collect `estab` dispatch arms from every ``ftype`` comparison chain
    in the conn parser."""
    # class -> {method name: FunctionDef} for one-level helper inlining.
    class_methods: dict = {}
    method_class: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            methods = {n.name: n for n in node.body
                       if isinstance(n, ast.FunctionDef)}
            class_methods[node.name] = methods
            for name in methods:
                method_class.setdefault(name, node.name)

    def methods_for(fn_name: str) -> dict:
        cls = method_class.get(fn_name)
        return class_methods.get(cls, {}) if cls else {}

    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        helpers = methods_for(fn.name)
        for node in ast.walk(fn):
            if not isinstance(node, ast.If):
                continue
            frames_hit = _frames_in_test(node.test)
            if frames_hit:
                nexts = _branch_nexts(node.body, helpers)
                for name in frames_hit:
                    machine.add("estab", name, nexts, relfile, node.lineno)
                # A terminal `else` arm is the unknown-frame transition --
                # but only when it tears the conn down (a non-tearing else
                # is a dispatch fallthrough, e.g. the ctl-completion
                # default routing to the HELLO_ACK hook).
                tail = node.orelse
                if tail and not (len(tail) == 1 and isinstance(tail[0], ast.If)):
                    if _unconditional_down(tail):
                        machine.add("estab", "OTHER", {"down"}, relfile,
                                    tail[0].lineno)


def _frames_in_test(test: ast.AST) -> list:
    """Frame names dispatched by an If test on ``ftype`` (Eq and
    membership shapes; extra conjuncts like ``and self._sess_drop`` are
    allowed)."""
    out = []
    for node in ast.walk(test):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        if _terminal(node.left) != "ftype":
            continue
        op = node.ops[0]
        if isinstance(op, ast.Eq):
            name = _frame_name(node.comparators[0])
            if name:
                out.append(name)
        elif isinstance(op, ast.In) and isinstance(node.comparators[0],
                                                   (ast.Tuple, ast.List)):
            for elt in node.comparators[0].elts:
                name = _frame_name(elt)
                if name:
                    out.append(name)
    return out


def _walk_handshake(tree: ast.Module, relfile: str, machine: _Machine) -> None:
    """``if ftype != frames.T_X: raise`` in the connector's blocking
    handshake: (hello-sent, X) -> estab and (hello-sent, OTHER) -> down."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.If) or not isinstance(node.test, ast.Compare):
            continue
        test = node.test
        if len(test.ops) != 1 or not isinstance(test.ops[0], ast.NotEq):
            continue
        if _terminal(test.left) != "ftype":
            continue
        name = _frame_name(test.comparators[0])
        if name and any(isinstance(n, ast.Raise) for stmt in node.body
                        for n in ast.walk(stmt)):
            machine.add("hello-sent", name, {"estab"}, relfile, node.lineno)
            machine.add("hello-sent", "OTHER", {"down"}, relfile, node.lineno)


def _walk_lifecycle(tree: ast.Module, relfile: str, machine: _Machine) -> None:
    """Session lifecycle transitions from the engine's `_sess_*` family
    (the §14 machine: suspend on transport loss, resume replay, terminal
    expiry)."""
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        if fn.name == "_sess_suspend":
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and _terminal(node.func) == "suspend":
                    machine.add("estab", "lost", {"suspended"}, relfile,
                                node.lineno)
                    break
        elif fn.name in ("_sess_redial", "_sess_hello"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "resume":
                    machine.add("suspended", "resume", {"estab"}, relfile,
                                node.lineno)
                    break
        elif fn.name == "_sess_expire":
            _, expired = _scan_effects(fn.body)
            if expired:
                machine.add("suspended", "expire", {"expired"}, relfile,
                            fn.lineno)


def extract_py_machine(root: Path) -> tuple[_Machine, list]:
    machine = _Machine()
    findings: list = []
    conn_rel = "starway_tpu_torch/core/conn.py"
    engine_rel = "starway_tpu_torch/core/engine.py"
    for relfile, walkers in (
        (conn_rel, (_walk_ftype_dispatch,)),
        (engine_rel, (_walk_handshake, _walk_lifecycle)),
    ):
        path = root / relfile
        if not path.is_file():
            findings.append(Finding(relfile, 1, "proto-state",
                                    "engine source missing -- cannot extract "
                                    "the protocol state machine"))
            continue
        tree, err = parse_or_finding(path, relfile)
        if tree is None:
            findings.append(err)
            continue
        for walk in walkers:
            walk(tree, relfile, machine)
    return machine, findings


def extract_cpp_machine(root: Path) -> tuple[_Machine, list]:
    machine = _Machine()
    findings: list = []
    relfile = "starway_tpu_torch/native/sw_engine.cpp"
    path = root / relfile
    if not path.is_file():
        return machine, [Finding(relfile, 1, "proto-state",
                                 "native engine source missing -- cannot "
                                 "extract the protocol state machine")]
    text = read_text(path)
    for i, line in enumerate(text.splitlines(), 1):
        m = _CPP_STATE_RE.search(line)
        if m is None:
            continue
        parts = [p.strip() for p in m.group(1).split(",")]
        if len(parts) != 3:
            findings.append(Finding(
                relfile, i, "proto-state",
                f"malformed state annotation `state({m.group(1)})` -- "
                "expected state(<state>, <input>, <next>[|<next>...])"))
            continue
        state, inp, nexts_raw = parts
        nexts = {n.strip() for n in nexts_raw.split("|") if n.strip()}
        bad = ([state] if state not in KNOWN_STATES else []) \
            + ([inp] if inp not in KNOWN_INPUTS else []) \
            + sorted(nexts - KNOWN_NEXTS)
        if bad:
            findings.append(Finding(
                relfile, i, "proto-state",
                f"state annotation uses unknown token(s) {bad} "
                "(see DESIGN.md §16 for the vocabulary)"))
            continue
        machine.add(state, inp, nexts, relfile, i)
    return machine, findings


def _fmt(nexts: set) -> str:
    return "|".join(sorted(nexts))


def run(root: Path) -> list:
    py, out = extract_py_machine(root)
    cpp, cpp_findings = extract_cpp_machine(root)
    out.extend(cpp_findings)
    # Vacuity guard: an extractor that silently comes up empty would make
    # the whole diff a no-op.  Empty machines are findings, not passes.
    if not py.transitions:
        out.append(Finding(
            "starway_tpu_torch/core/conn.py", 1, "proto-state",
            "extracted no transitions from the Python engine -- state "
            "machine checking would be vacuous (dispatch reshaped past the "
            "extraction grammar? see DESIGN.md §16)"))
    if not cpp.transitions:
        out.append(Finding(
            "starway_tpu_torch/native/sw_engine.cpp", 1, "proto-state",
            "found no `swcheck: state(...)` annotations in the native "
            "engine -- state machine checking would be vacuous (annotate "
            "dispatch sites; see DESIGN.md §16)"))
    if not py.transitions or not cpp.transitions:
        return out
    for key in sorted(set(py.transitions) | set(cpp.transitions)):
        state, inp = key
        if key not in cpp.transitions:
            nexts, f, ln = py.transitions[key]
            out.append(Finding(
                f, ln, "proto-state",
                f"transition ({state}, {inp}) -> {_fmt(nexts)} extracted "
                "from the Python engine has no `swcheck: state(...)` "
                "annotation in native/sw_engine.cpp (two engines, one "
                "protocol machine)"))
        elif key not in py.transitions:
            nexts, f, ln = cpp.transitions[key]
            out.append(Finding(
                f, ln, "proto-state",
                f"annotated transition ({state}, {inp}) -> {_fmt(nexts)} "
                "has no counterpart in the Python engine's dispatch "
                "(stale annotation, or a dispatch arm removed on one side)"))
        else:
            pn, pf, pl = py.transitions[key]
            cn, cf, cl = cpp.transitions[key]
            if pn != cn:
                out.append(Finding(
                    pf, pl, "proto-state",
                    f"transition ({state}, {inp}): Python engine -> "
                    f"{_fmt(pn)} but {cf}:{cl} annotates -> {_fmt(cn)} "
                    "(the engines disagree on the outcome of this input)"))
    return out
