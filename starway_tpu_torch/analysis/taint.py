"""Pass: taint -- the §19 unverified-byte taint lint (DESIGN.md §21).

The integrity plane's central promise is a *dominance* property: on a
``csum``-negotiated conn, no payload byte may complete a receive or
reach a user callback unless the CRC verify that covers it ran first
and the mismatch arm aborted delivery (CLAUDE.md: "corrupt bytes must
never complete a receive or be delivered to user code").  The promise
is easy to break one refactor at a time -- move a completion above its
gate, drop one accumulation on one rx state, soften a mismatch arm
from poison to a counter bump -- and every one of those edits is
locally plausible.  This pass proves the discipline statically, in
BOTH engines, the way analysis/concurrency.py proves the
callback-under-lock rule: sources are parsed (ast / comment-stripped
text), never executed, so seeded mutations in tests/test_swcheck.py
are honoured.

Three checks per engine, table-driven off the rx structure:

1. **accumulate** -- every payload read site in the frame pump
   (``_rx_read`` / ``stream_read``) is followed, within its rx-state
   branch, by the guarded CRC accumulation (``if csum_pend: accum =
   crc32c(...)``).  A read that skips accumulation makes the eventual
   verify blind to those bytes.
2. **dominate** -- every delivery sink (the matcher completion, the
   striped-chunk record, the sub-header resolve, the ctl-body JSON
   dispatch) is preceded, within its branch, by a verify gate: an
   ``if`` on the armed checksum that compares the accumulator against
   the announced CRC -- and the mismatch arm must ABORT delivery
   (poison / SNACK-and-continue / return), never fall through.
3. **sm dequeue** -- the shared-memory ring's slot-record checksum
   failure is surfaced as the stable "corrupt" poison before any slot
   byte is parsed (SmCorrupt -> poison_reason in the Python transport
   read; ``read_into < 0`` -> ``conn_corrupt`` in the native one).

Extraction losing the pump function or the sink table is itself a
``taint-integrity`` finding (the explore/compose vacuity convention):
a lint that silently stopped seeing the delivery surface would pass
forever.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Optional

from .base import Finding, parse_or_finding, read_text
from .cpp_model import _strip_comments

F_CONN = "starway_tpu_torch/core/conn.py"
F_SHM = "starway_tpu_torch/core/shmring.py"
F_CPP = "starway_tpu_torch/native/sw_engine.cpp"

#: Delivery sinks in conn.py's ``_pump_frames``: attribute-call names
#: whose invocation hands (or commits to handing) frame bytes onward.
PY_SINKS = ("on_message_complete", "chunk_done", "chunk_start",
            "unpack_json_body")

#: Their native twins inside ``pump_frames`` (call-site tokens).
CPP_SINKS = ("matcher.on_complete(", "stripe_rx_chunk_done(",
             "stripe_rx_resolve(", "on_hello(")

#: The five rx-state arms of the native pump; each sink's verify region
#: runs from its nearest preceding arm guard to the sink itself.
CPP_ARMS = ("if (c->rx_skip)", "if (c->sdata_active)", "if (c->rx_stripe)",
            "if (c->rx_msg)", "if (c->ctl_need)")

_CPP_ACCUM_RE = re.compile(r"csum_accum\s*=\s*crc32c\(")
_CPP_COMPARE_RE = re.compile(r"csum_accum\s*!=\s*c->csum_[fh]")
_CPP_ABORT_RE = re.compile(r"conn_corrupt\(|T_SNACK|return;|continue;")


# ------------------------------------------------------------ python


def _mentions(node: ast.AST, attr: str) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == attr
               for n in ast.walk(node))


def _calls(node: ast.AST, name: str) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            if (isinstance(f, ast.Attribute) and f.attr == name) or \
                    (isinstance(f, ast.Name) and f.id == name):
                return True
    return False


def _aborts(stmts: list) -> bool:
    """Does this mismatch arm stop delivery?  Poison (``_corrupt``),
    retransmit-and-skip (``continue``), or any return/raise counts; a
    counter bump alone does not."""
    for s in stmts:
        for n in ast.walk(s):
            if isinstance(n, (ast.Return, ast.Continue, ast.Raise)):
                return True
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "_corrupt":
                return True
    return False


def _compare_on_accum(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Compare) and (
        _mentions(n.left, "_csum_accum")
        or any(_mentions(c, "_csum_accum") for c in n.comparators))
        for n in ast.walk(node))


def _gate_verdict(stmt: ast.stmt) -> Optional[bool]:
    """Is ``stmt`` (or a statement nested in it) a §19 verify gate?
    Returns None (no gate), True (gate whose mismatch arm aborts), or
    False (gate that falls through -- the taint bug).  Two shapes:

    * the routing gate carries the compare in its own test
      (``if pend is not None and accum != pend[1]: poison``) -- pend
      stays armed for the payload that follows;
    * the consuming gate takes the pend pair down and compares inside
      (``pend, _csum_pend = _csum_pend, None; if accum != pend[0]:``),
      covering both the body-completion gates and the header-dispatch
      gate (which captures pend into a local first)."""
    for node in ast.walk(stmt):
        if isinstance(node, ast.If) and _mentions(node.test, "_csum_pend") \
                and _compare_on_accum(node.test):
            return _aborts(node.body)
    assigns_pend = any(
        isinstance(n, (ast.Assign, ast.AnnAssign)) and any(
            _mentions(t, "_csum_pend")
            for t in (n.targets if isinstance(n, ast.Assign)
                      else [n.target]))
        for n in ast.walk(stmt))
    inner = next((n for n in ast.walk(stmt)
                  if isinstance(n, ast.If)
                  and _compare_on_accum(n.test)), None)
    if assigns_pend and inner is not None:
        return _aborts(inner.body)
    return None


def _stmt_paths(func: ast.FunctionDef) -> dict:
    """id(stmt) -> [(suite, idx), ...] outermost-to-innermost, for every
    statement in the function (suites: body/orelse/finalbody/handlers)."""
    paths: dict = {}

    def visit(stmts: list, prefix: list) -> None:
        for i, s in enumerate(stmts):
            here = prefix + [(stmts, i)]
            paths[id(s)] = here
            for attr in ("body", "orelse", "finalbody"):
                visit(getattr(s, attr, []) or [], here)
            for h in getattr(s, "handlers", []) or []:
                visit(h.body, here)

    visit(func.body, [])
    return paths


def _containing_stmt(paths: dict, func: ast.FunctionDef,
                     target: ast.AST) -> Optional[list]:
    """The statement path whose innermost statement contains ``target``
    (innermost containing statement wins)."""
    best = None
    for sid, path in paths.items():
        suite, idx = path[-1]
        stmt = suite[idx]
        if any(n is target for n in ast.walk(stmt)):
            if best is None or len(path) > len(best):
                best = path
    return best


def _check_python(root: Path, out: list) -> None:
    tree, err = parse_or_finding(root / F_CONN, F_CONN)
    if tree is None:
        out.append(err)
        return
    pump = next((n for n in ast.walk(tree)
                 if isinstance(n, ast.FunctionDef)
                 and n.name == "_pump_frames"), None)
    if pump is None:
        out.append(Finding(
            F_CONN, 1, "taint-integrity",
            "_pump_frames not found -- the rx pump the taint lint proves "
            "the §19 verify-before-deliver discipline over is gone "
            "(update the extraction table, DESIGN.md §21)"))
        return
    paths = _stmt_paths(pump)
    loop = next((n for n in pump.body if isinstance(n, ast.While)), None)
    loop_suite = loop.body if loop is not None else pump.body

    # -- check 1: every read site accumulates under the armed checksum
    reads = [n for n in ast.walk(pump)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "_rx_read"]
    if not reads:
        out.append(Finding(
            F_CONN, pump.lineno, "taint-integrity",
            "_pump_frames has no _rx_read sites -- the taint lint's read "
            "table no longer matches the code (DESIGN.md §21)"))
    for call in reads:
        path = _containing_stmt(paths, pump, call)
        if path is None:
            continue
        # The rx-state branch: the loop-body-level statement holding the
        # read.  Accumulation must follow the read inside that branch --
        # or, for the header read (its try sits at loop-body level
        # directly), among the following loop-body statements UP TO the
        # next read (a later branch's accumulate covers different
        # bytes, so it is a barrier here exactly as in the sink scan).
        branch_idx = next((i for i, (suite, _) in enumerate(path)
                           if suite is loop_suite), None)
        if branch_idx is not None:
            suite, idx = path[branch_idx]
            scope = [suite[idx]]
            for later in suite[idx + 1:]:
                if any(isinstance(n, ast.Call)
                       and isinstance(n.func, ast.Attribute)
                       and n.func.attr == "_rx_read"
                       for n in ast.walk(later)):
                    break
                scope.append(later)
        else:
            scope = [path[0][0][path[0][1]]]
        ok = False
        for s in scope:
            for n in ast.walk(s):
                if isinstance(n, ast.If) and n.lineno > call.lineno \
                        and _mentions(n.test, "_csum_pend") \
                        and _calls(n, "crc32c"):
                    ok = True
                    break
            if ok:
                break
        if not ok:
            out.append(Finding(
                F_CONN, call.lineno, "taint-integrity",
                "payload bytes read here never reach the §19 CRC "
                "accumulator (no guarded crc32c follows this _rx_read in "
                "its rx-state branch): the eventual verify is blind to "
                "them and corrupt bytes pass as good (DESIGN.md §21)"))

    # -- check 2: every delivery sink is dominated by an aborting gate
    found_sinks: set = set()
    for call in ast.walk(pump):
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr in PY_SINKS):
            continue
        found_sinks.add(call.func.attr)
        path = _containing_stmt(paths, pump, call)
        if path is None:
            continue
        verdict: Optional[bool] = None
        # Innermost-out, nearest-first.  At the loop-body level a
        # statement containing another _rx_read is a hard barrier: the
        # bytes beyond it belong to a different frame (a sibling
        # rx-state branch), so a gate there proves nothing about THIS
        # sink -- but the header-dispatch gate between the header read
        # and the dispatch chain is legitimately visible (it is what
        # dominates the zero-length immediate completion).
        for suite, idx in reversed(path):
            at_loop = suite is loop_suite
            for prev in reversed(suite[:idx]):
                if at_loop and any(
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "_rx_read"
                        for n in ast.walk(prev)):
                    break  # barrier: a different frame's bytes
                verdict = _gate_verdict(prev)
                if verdict is not None:
                    break
            if verdict is not None or at_loop:
                break
        if verdict is None:
            out.append(Finding(
                F_CONN, call.lineno, "taint-integrity",
                f"delivery sink {call.func.attr}() is not dominated by a "
                "§19 verify gate: on an integrity conn these bytes reach "
                "user-visible state without their CRC ever being checked "
                "(DESIGN.md §21)"))
        elif verdict is False:
            out.append(Finding(
                F_CONN, call.lineno, "taint-integrity",
                f"the verify gate before {call.func.attr}() does not abort "
                "on mismatch: a failed CRC falls through and corrupt bytes "
                "complete the delivery (poison / SNACK / return -- never "
                "a counter bump alone; DESIGN.md §21)"))
    missing = [s for s in PY_SINKS if s not in found_sinks]
    if missing:
        out.append(Finding(
            F_CONN, pump.lineno, "taint-integrity",
            f"delivery sink(s) {missing} no longer found in _pump_frames "
            "-- the taint lint's sink table drifted from the code and the "
            "dominance proof is vacuous (DESIGN.md §21)"))

    # -- check 3: the sm dequeue poisons on a corrupt slot record
    rx_read = next((n for n in ast.walk(tree)
                    if isinstance(n, ast.FunctionDef)
                    and n.name == "_rx_read"), None)
    if rx_read is None:
        out.append(Finding(
            F_CONN, 1, "taint-integrity",
            "_rx_read not found -- cannot prove the sm slot-record "
            "corruption path poisons before parse (DESIGN.md §21)"))
    else:
        handler = next(
            (h for n in ast.walk(rx_read) if isinstance(n, ast.Try)
             for h in n.handlers
             if h.type is not None and "SmCorrupt" in ast.dump(h.type)),
            None)
        ok = handler is not None and any(
            isinstance(n, (ast.Assign, ast.AnnAssign))
            and any(_mentions(t, "poison_reason")
                    for t in (n.targets if isinstance(n, ast.Assign)
                              else [n.target]))
            for s in handler.body for n in ast.walk(s)) and any(
            isinstance(n, ast.Raise)
            for s in handler.body for n in ast.walk(s))
        if not ok:
            out.append(Finding(
                F_CONN, rx_read.lineno, "taint-integrity",
                "_rx_read does not convert SmCorrupt into the stable "
                "\"corrupt\" poison (set poison_reason, re-raise): a torn "
                "sm slot record would surface as a generic conn break -- "
                "or worse, parse (DESIGN.md §19/§21)"))
    shm_tree, shm_err = parse_or_finding(root / F_SHM, F_SHM)
    if shm_tree is None:
        out.append(shm_err)
    else:
        ri = next((n for n in ast.walk(shm_tree)
                   if isinstance(n, ast.FunctionDef)
                   and n.name == "read_into"), None)
        if ri is None or not any(isinstance(n, ast.Raise)
                                 and n.exc is not None
                                 and "SmCorrupt" in ast.dump(n.exc)
                                 for n in ast.walk(ri)):
            out.append(Finding(
                F_SHM, 1 if ri is None else ri.lineno, "taint-integrity",
                "Ring.read_into no longer raises SmCorrupt at a slot-record "
                "checksum mismatch: torn/stale ring bytes would parse as "
                "frames (DESIGN.md §19/§21)"))


# --------------------------------------------------------------- c++


def _cpp_func_body(code: str, signature: str) -> Optional[tuple]:
    """(body_text, start_offset) of the brace-matched function body
    following ``signature`` in comment-stripped code (string literals
    skipped so braces inside them cannot desync the match)."""
    at = code.find(signature)
    if at < 0:
        return None
    brace = code.find("{", at)
    if brace < 0:
        return None
    depth = 0
    i = brace
    n = len(code)
    while i < n:
        ch = code[i]
        if ch in "\"'":
            q = ch
            i += 1
            while i < n and code[i] != q:
                i += 2 if code[i] == "\\" else 1
        elif ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return code[brace + 1:i], brace + 1
        i += 1
    return None


def _check_cpp(root: Path, out: list) -> None:
    path = root / F_CPP
    if not path.is_file():
        return
    code = _strip_comments(read_text(path))

    def line_of(off: int) -> int:
        return code.count("\n", 0, off) + 1

    got = _cpp_func_body(code, "void pump_frames(")
    if got is None:
        out.append(Finding(
            F_CPP, 1, "taint-integrity",
            "pump_frames not found in the native engine -- the taint "
            "lint's rx surface is gone (DESIGN.md §21)"))
        return
    body, base = got
    for token in CPP_SINKS:
        pos = body.find(token)
        if pos < 0:
            out.append(Finding(
                F_CPP, line_of(base), "taint-integrity",
                f"delivery sink `{token.rstrip('(')}` no longer found in "
                "pump_frames -- the taint lint's sink table drifted from "
                "the native engine (DESIGN.md §21)"))
            continue
        guard = max((body.rfind(g, 0, pos) for g in CPP_ARMS), default=-1)
        if guard < 0:
            out.append(Finding(
                F_CPP, line_of(base + pos), "taint-integrity",
                f"sink `{token.rstrip('(')}` has no preceding rx-state "
                "guard -- pump_frames restructured past the taint lint's "
                "arm table (DESIGN.md §21)"))
            continue
        region = body[guard:pos]
        sink_line = line_of(base + pos)
        if "stream_read(" not in region:
            out.append(Finding(
                F_CPP, sink_line, "taint-integrity",
                f"no stream_read in the rx arm feeding "
                f"`{token.rstrip('(')}` -- the arm/sink pairing drifted "
                "(DESIGN.md §21)"))
            continue
        if not _CPP_ACCUM_RE.search(region):
            out.append(Finding(
                F_CPP, sink_line, "taint-integrity",
                "payload bytes read in this rx arm never reach the §19 "
                "CRC accumulator (no `csum_accum = crc32c(...)` before "
                f"`{token.rstrip('(')}`): the verify is blind to them "
                "(DESIGN.md §21)"))
        cmp_m = None
        for m in _CPP_COMPARE_RE.finditer(region):
            cmp_m = m
        if cmp_m is None:
            out.append(Finding(
                F_CPP, sink_line, "taint-integrity",
                f"delivery sink `{token.rstrip('(')}` is not dominated by "
                "a §19 verify gate (no accumulator-vs-announced-CRC "
                "compare in its rx arm): unverified bytes reach "
                "user-visible state (DESIGN.md §21)"))
        elif not _CPP_ABORT_RE.search(region[cmp_m.end():]):
            out.append(Finding(
                F_CPP, sink_line, "taint-integrity",
                f"the verify gate before `{token.rstrip('(')}` does not "
                "abort on mismatch: a failed CRC falls through to the "
                "delivery (conn_corrupt / T_SNACK / return -- never a "
                "counter bump alone; DESIGN.md §21)"))

    sr = _cpp_func_body(code, "ssize_t stream_read(")
    if sr is None:
        out.append(Finding(
            F_CPP, 1, "taint-integrity",
            "stream_read not found in the native engine -- cannot prove "
            "the sm dequeue poisons on a corrupt slot record "
            "(DESIGN.md §21)"))
        return
    sbody, sbase = sr
    ri = sbody.find("read_into(")
    if ri < 0:
        out.append(Finding(
            F_CPP, line_of(sbase), "taint-integrity",
            "stream_read no longer dequeues via SmRing::read_into -- the "
            "sm taint check lost its anchor (DESIGN.md §21)"))
    elif 'conn_corrupt(c, "sm slot record"' not in sbody:
        out.append(Finding(
            F_CPP, line_of(sbase + ri), "taint-integrity",
            "a corrupt sm slot record (read_into < 0) is not poisoned "
            "with the stable \"sm slot record\" conn_corrupt before its "
            "bytes could parse (DESIGN.md §19/§21)"))


def run(root: Path) -> list:
    out: list = []
    _check_python(root, out)
    _check_cpp(root, out)
    return out
