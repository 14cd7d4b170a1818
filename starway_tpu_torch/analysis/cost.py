"""Pass: cost -- swcost hot-path cost certification (DESIGN.md §23).

ROADMAP item 2 (io_uring batching, MSG_ZEROCOPY, bounded busy-poll) is a
story about *eliminating syscalls and copies*, but nothing in the gate
could verify such a claim or catch its regression: the bench is too
noisy on the 1-core box to resolve a one-syscall delta, and
``hotpath-copy`` is a single-idiom Python lint.  swcost pins the claim
the way swrefine (§22) pins protocol behaviour -- statically, in BOTH
engines, against a checked-in ledger:

1. **Extraction** -- a declared-call-graph walk of the per-op hot paths:
   C++ from the tx chokepoints and ``pump_frames`` rx arms of
   ``native/sw_engine.cpp`` (comment-stripped text, the §21 taint
   machinery's style), Python ``ast`` from the matching methods of
   ``core/conn.py`` / ``core/shmring.py`` / ``core/lane.py``.  Each
   contract path (eager tx/rx, rndv tx/rx, striped chunk tx/rx, sm
   enqueue/dequeue, per-frame dispatch) gets a cost vector
   ``{syscalls, copies, allocs, locks}`` counting *static sites*, the
   things a refactor adds or removes -- not dynamic executions.
2. **Ratcheted ledger** -- ``analysis/cost_budgets.txt`` pins one row
   per (engine, path, metric).  Exceeding a pin is a finding
   (regression); *beating* one is ALSO a finding until the pin is
   lowered, so improvements land as ledger diffs, and cross-engine
   asymmetries (python eager-tx paying sites native does not) are
   documented rows instead of folklore.
3. **Runtime twin** -- both engines carry unconditional ``io_syscalls``
   / ``hot_copies`` counters at the extracted syscall/copy sites
   (tests/test_cost.py drives a canonical op sequence over all four
   engine pairings and checks the deltas against this module's own
   extraction, so the tables cannot go stale silently).  This pass
   statically checks the instrumentation is alive.

A site is excluded from the count by the ordinary waiver discipline on
its own line (``# swcheck: allow(cost-site): why`` / the ``//`` form in
C++); a ledger row is waived in place in cost_budgets.txt.  Extraction
losing an anchor function, an rx arm, or the instrumentation is itself
a ``cost-model`` finding (the explore/compose vacuity convention): a
cost gate that silently stopped seeing the hot path would pass forever.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Optional

from .base import Finding, _waivers_on_line, parse_or_finding, read_text
from .cpp_model import _strip_comments
from .taint import _cpp_func_body

F_CONN = "starway_tpu_torch/core/conn.py"
F_SHM = "starway_tpu_torch/core/shmring.py"
F_LANE = "starway_tpu_torch/core/lane.py"
F_CPP = "starway_tpu_torch/native/sw_engine.cpp"

METRICS = ("syscalls", "copies", "allocs", "locks")

#: Hot-path components: the unit of extraction.  Each is a declared
#: call-graph slice -- (file, [function defs]) on the Python side,
#: [signatures] (taint-style brace-matched bodies) on the native side.
#: ``arm:<name>`` components are carved out of the frame pumps below.
COMPONENTS = {
    "tx_pump":       {"py": (F_CONN, ["kick_tx"]),
                      # tcp_tx_account is kick_tx's budget loop, extracted
                      # so both event cores share it (§24) -- same slice,
                      # zero sites of its own, ledger-neutral.
                      "cpp": ["void kick_tx(", "void tcp_tx_account("]},
    "tx_gather":     {"py": (F_CONN, ["_gather_tx"]),
                      "cpp": ["ssize_t tcp_tx_gather("]},
    "tx_write":      {"py": (F_CONN, ["_tx_write"]),
                      "cpp": ["ssize_t conn_tx_write("]},
    "doorbell":      {"py": (F_CONN, ["_doorbell", "on_writable"]),
                      "cpp": ["void doorbell(", "void conn_writable("]},
    "ctl_send":      {"py": (F_CONN, ["send_ctl"]),
                      "cpp": ["void conn_send_ctl("]},
    "rndv_announce": {"py": (F_CONN, ["_fc_rts_announce"]),
                      "cpp": ["void fc_rts_announce("]},
    "rndv_grant":    {"py": (F_CONN, ["_on_cts"]),
                      "cpp": ["void fc_on_cts("]},
    "rx_read":       {"py": (F_CONN, ["_rx_read"]),
                      "cpp": ["ssize_t stream_read("]},
    "rx_socket":     {"py": (F_CONN, ["on_readable"]),
                      "cpp": ["void conn_readable("]},
    "sm_write":      {"py": (F_SHM, ["write", "_put"]),
                      "cpp": ["size_t write(const uint8_t* src, size_t len)"]},
    "sm_read":       {"py": (F_SHM, ["read_into", "_take"]),
                      "cpp": ["ssize_t read_into(uint8_t* dst, size_t len)"]},
    "stripe_feed":   {"py": (F_LANE, ["_claim"]),
                      "cpp": ["bool stripe_claim("]},
    # §24 swfast components are native-only ("py": None): the Python
    # engine declares the counter vocabulary but has no submission ring
    # or zerocopy machinery, so its rows for these paths pin at 0.
    "uring_pump":    {"py": None,
                      "cpp": ["void uring_service("]},
    "uring_collect": {"py": None,
                      "cpp": ["bool uring_tx_collect("]},
    "uring_finish":  {"py": None,
                      "cpp": ["void uring_op_finish("]},
    "uring_submit":  {"py": None,
                      "cpp": ["int uring_submit_wait("]},
    "zc_send":       {"py": None,
                      "cpp": ["ssize_t zc_tx_send("]},
    "zc_notify":     {"py": None,
                      "cpp": ["void zc_drain_errqueue("]},
}

#: The five rx-state arms of the frame pumps (taint.py's CPP_ARMS order)
#: plus the header/dispatch remainder.  Python arms are keyed by the
#: state attribute their marker statement mentions.
ARM_ORDER = ("skip", "sdata", "stripe", "msg", "ctl")
PY_ARM_ATTRS = {"skip": "_rx_skip", "sdata": "_sdata", "stripe": "_rx_stripe",
                "msg": "_rx_msg", "ctl": "_ctl"}
CPP_ARM_TOKENS = {"skip": "if (c->rx_skip)", "sdata": "if (c->sdata_active)",
                  "stripe": "if (c->rx_stripe)", "msg": "if (c->rx_msg)",
                  "ctl": "if (c->ctl_need)"}

#: Contract paths -> owning components.  Each component belongs to ONE
#: path, so a ledger row moving identifies the code that moved it.
PATHS = {
    "eager_tx":   ["tx_pump", "tx_gather"],
    "eager_rx":   ["arm:msg"],
    "rndv_tx":    ["ctl_send", "rndv_announce", "rndv_grant"],
    "rndv_rx":    ["arm:ctl"],
    "stripe_tx":  ["stripe_feed"],
    "stripe_rx":  ["arm:sdata", "arm:stripe"],
    "sm_enqueue": ["tx_write", "sm_write", "doorbell"],
    "sm_dequeue": ["rx_socket", "sm_read"],
    "dispatch":   ["arm:dispatch", "arm:skip", "rx_read"],
    # §24 swfast (STARWAY_IOURING=1): the per-conn TX pass under the
    # uring core.  Eager AND rndv payload bytes both ride this collector
    # (the rndv_tx path above is the RTS/CTS ctl plane, already at 0
    # syscalls) -- its per-pass site count is STRICTLY LOWER than
    # eager_tx's because the one sendmsg moved into uring_flush, where a
    # single io_uring_enter lands every ready conn's batch.
    "eager_tx_uring": ["uring_pump", "uring_collect", "uring_finish"],
    "uring_flush":    ["uring_submit"],
    # §24 (STARWAY_ZEROCOPY=1): the MSG_ZEROCOPY payload pass (two
    # sendmsg sites: the zerocopy send + the documented ENOBUFS copying
    # fallback) and the errqueue completion drain.  The eliminated cost
    # is the KERNEL-side payload copy -- not a static site here -- so
    # these rows pin the added notification machinery instead.
    "zc_tx":          ["zc_send"],
    "zc_notify":      ["zc_notify"],
}

# ------------------------------------------------------- site tables

#: Native site tables, matched over comment-stripped text.  Syscall
#: wrappers are the ``::``-qualified libc calls plus the epoll verbs;
#: copies are the explicit byte movers; allocs are the heap/growth
#: idioms (push_back onto a reserved vector is amortised, not counted).
CPP_SITE_RES = {
    "syscalls": re.compile(r"::send\(|::sendmsg\(|::recv\(|::recvmsg\(|"
                           r"::writev\(|\bepoll_wait\(|\bepoll_ctl\(|"
                           r"\bio_uring_enter\(|\bio_uring_setup\("),
    "copies":   re.compile(r"\bmemcpy\(|std::copy\(|\bmemmove\(|\.assign\("),
    "allocs":   re.compile(r"\bnew\s|\bmalloc\(|\.resize\(|\.reserve\(|"
                           r"make_shared<"),
    "locks":    re.compile(r"\block_guard\b|\bunique_lock\b|\.lock\(\)"),
}

PY_SYSCALL_ATTRS = {"send", "sendall", "sendmsg", "recv", "recv_into",
                    "recvmsg"}


def _mentions(node: ast.AST, attr: str) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == attr
               for n in ast.walk(node))


def _mentions_sock(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and "sock" in n.attr:
            return True
        if isinstance(n, ast.Name) and "sock" in n.id:
            return True
    return False


def _py_sites(stmts: list) -> list:
    """(metric, lineno) static cost sites in a Python statement list.

    * syscalls -- ``*.sock.send/sendall/sendmsg/recv/recv_into/recvmsg``
    * copies   -- ``bytes(x)`` / ``.tobytes()`` / ``.join(...)`` and
      slice-assignment into a buffer (the shmring put/take idiom)
    * allocs   -- ``bytearray(...)`` with arguments
    * locks    -- ``with <...lock...>:`` items and ``.acquire()``
    """
    out = []
    for s in stmts:
        for n in ast.walk(s):
            if isinstance(n, ast.Call):
                f = n.func
                if isinstance(f, ast.Attribute):
                    if f.attr in PY_SYSCALL_ATTRS and _mentions_sock(f.value):
                        out.append(("syscalls", n.lineno))
                    elif f.attr in ("tobytes", "join"):
                        out.append(("copies", n.lineno))
                    elif f.attr == "acquire":
                        out.append(("locks", n.lineno))
                elif isinstance(f, ast.Name):
                    if f.id == "bytes" and n.args:
                        out.append(("copies", n.lineno))
                    elif f.id == "bytearray" and n.args:
                        out.append(("allocs", n.lineno))
            elif isinstance(n, ast.Assign):
                if any(isinstance(t, ast.Subscript)
                       and isinstance(t.slice, ast.Slice)
                       for t in n.targets):
                    out.append(("copies", n.lineno))
            elif isinstance(n, (ast.With, ast.AsyncWith)):
                for item in n.items:
                    expr = item.context_expr
                    if any((isinstance(x, ast.Attribute) and "lock" in x.attr)
                           or (isinstance(x, ast.Name) and "lock" in x.id)
                           for x in ast.walk(expr)):
                        out.append(("locks", n.lineno))
    return out


def _cpp_sites(region: str, base_off: int, code: str) -> list:
    """(metric, lineno) sites in a comment-stripped native text region
    (``base_off`` is the region's offset into ``code`` for line math)."""
    out = []
    for metric, rx in CPP_SITE_RES.items():
        for m in rx.finditer(region):
            line = code.count("\n", 0, base_off + m.start()) + 1
            out.append((metric, line))
    return out


def _unwaived(sites: list, file_lines: list) -> dict:
    """Fold sites into a {metric: count} vector, dropping sites whose
    own line (or the line above) carries a justified ``cost-site``
    waiver -- the standard discipline, honoured at extraction time so
    the ledger never pins a waived site."""
    vec = {m: 0 for m in METRICS}
    for metric, line in sites:
        waived = any("cost-site" in rules and why
                     for rules, why, _ in _waivers_on_line(file_lines, line))
        if not waived:
            vec[metric] += 1
    return vec


# ------------------------------------------------------- python side


def _py_functions(tree: ast.Module) -> dict:
    return {n.name: n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef)}


def _py_pump_arms(pump: ast.FunctionDef) -> Optional[dict]:
    """Split ``_pump_frames``' top-level loop statements into the five
    rx-state arms + the dispatch remainder.  Arms are delimited by their
    marker statements in ARM_ORDER (the statement mentioning the state
    attribute); everything after the ``ctl`` marker -- and any loop
    prelude before the first marker -- is the dispatch region."""
    loop = next((n for n in pump.body if isinstance(n, ast.While)), None)
    if loop is None:
        return None
    arms: dict = {name: [] for name in ARM_ORDER}
    arms["dispatch"] = []
    pending = list(ARM_ORDER)
    current = "dispatch"
    for stmt in loop.body:
        if pending and _mentions(stmt, PY_ARM_ATTRS[pending[0]]):
            current = pending.pop(0)
        elif current == "ctl":
            # The ctl arm is its single marker statement; the header
            # parse + frame dispatch chain follows it.
            current = "dispatch"
        arms[current].append(stmt)
    if pending:
        return None  # an arm marker vanished: pump restructured
    return arms


def _extract_python(root: Path, vectors: dict, out: list) -> None:
    trees: dict = {}
    lines: dict = {}
    for f in (F_CONN, F_SHM, F_LANE):
        tree, err = parse_or_finding(root / f, f)
        if tree is None:
            out.append(err)
            return
        trees[f] = tree
        lines[f] = read_text(root / f).splitlines()

    comp_vecs: dict = {}
    for name, spec in COMPONENTS.items():
        if spec["py"] is None:
            continue  # native-only §24 component: the py rows pin at 0
        f, funcs = spec["py"]
        defs = _py_functions(trees[f])
        sites: list = []
        for fn in funcs:
            node = defs.get(fn)
            if node is None:
                out.append(Finding(
                    f, 1, "cost-model",
                    f"swcost anchor `{fn}` (component {name}) not found -- "
                    "the extraction table drifted from the code; update "
                    "COMPONENTS and re-pin the ledger (DESIGN.md §23)"))
                continue
            sites.extend(_py_sites(node.body))
        comp_vecs[name] = _unwaived(sites, lines[f])

    pump = _py_functions(trees[F_CONN]).get("_pump_frames")
    arms = _py_pump_arms(pump) if pump is not None else None
    if arms is None:
        out.append(Finding(
            F_CONN, 1 if pump is None else pump.lineno, "cost-model",
            "_pump_frames rx arms not extractable (function or an arm "
            "marker statement is gone): the per-frame cost vectors are "
            "unmeasurable -- update the arm table (DESIGN.md §23)"))
    else:
        for arm, stmts in arms.items():
            comp_vecs[f"arm:{arm}"] = _unwaived(
                _py_sites(stmts), lines[F_CONN])

    _fold_paths("py", comp_vecs, vectors)


# ------------------------------------------------------- native side


def _cpp_arm_regions(body: str, base: int) -> Optional[list]:
    """[(arm, region_text, region_offset)] for the native pump: each
    arm's brace-matched block, with the leftover text (loop head + the
    header/dispatch chain) as the ``dispatch`` region."""
    spans = []
    pos = 0
    for arm in ARM_ORDER:
        at = body.find(CPP_ARM_TOKENS[arm], pos)
        if at < 0:
            return None
        # _cpp_func_body finds the FIRST occurrence; arms appear in
        # order, so search from `at` by slicing.
        got = _cpp_func_body(body[at:], CPP_ARM_TOKENS[arm])
        if got is None:
            return None
        block, boff = got
        spans.append((arm, at, at + boff + len(block) + 1))
        pos = at + boff + len(block)
    regions = [(arm, body[a:b], base + a) for arm, a, b in spans]
    rest = []
    prev = 0
    for _, a, b in spans:
        rest.append((body[prev:a], base + prev))
        prev = b
    rest.append((body[prev:], base + prev))
    return regions, rest


def _extract_cpp(root: Path, vectors: dict, out: list) -> None:
    path = root / F_CPP
    if not path.is_file():
        out.append(Finding(
            F_CPP, 1, "cost-model",
            "native engine source missing -- the swcost ledger cannot "
            "certify the native hot paths (DESIGN.md §23)"))
        return
    raw = read_text(path)
    code = _strip_comments(raw)
    raw_lines = raw.splitlines()

    comp_vecs: dict = {}
    for name, spec in COMPONENTS.items():
        sites: list = []
        for sig in spec["cpp"]:
            got = _cpp_func_body(code, sig)
            if got is None:
                out.append(Finding(
                    F_CPP, 1, "cost-model",
                    f"swcost anchor `{sig.strip()}` (component {name}) not "
                    "found -- the extraction table drifted from the native "
                    "engine; update COMPONENTS and re-pin the ledger "
                    "(DESIGN.md §23)"))
                continue
            body, off = got
            sites.extend(_cpp_sites(body, off, code))
        comp_vecs[name] = _unwaived(sites, raw_lines)

    got = _cpp_func_body(code, "void pump_frames(")
    arms = _cpp_arm_regions(*got) if got is not None else None
    if arms is None:
        out.append(Finding(
            F_CPP, 1, "cost-model",
            "pump_frames rx arms not extractable from the native engine "
            "(function or an arm guard token is gone): update the arm "
            "table (DESIGN.md §23)"))
    else:
        regions, rest = arms
        for arm, text, off in regions:
            comp_vecs[f"arm:{arm}"] = _unwaived(
                _cpp_sites(text, off, code), raw_lines)
        dsites: list = []
        for text, off in rest:
            dsites.extend(_cpp_sites(text, off, code))
        comp_vecs["arm:dispatch"] = _unwaived(dsites, raw_lines)

    _fold_paths("cpp", comp_vecs, vectors)


def _fold_paths(engine: str, comp_vecs: dict, vectors: dict) -> None:
    for pname, comps in PATHS.items():
        for metric in METRICS:
            vectors[(engine, pname, metric)] = sum(
                comp_vecs.get(c, {}).get(metric, 0) for c in comps)


def extract(root: Path):
    """((engine, path, metric) -> site count, [vacuity findings])."""
    vectors: dict = {}
    out: list = []
    _extract_python(root, vectors, out)
    _extract_cpp(root, vectors, out)
    return vectors, out


# ----------------------------------------------------------- ledger

LEDGER_REL = "starway_tpu_torch/analysis/cost_budgets.txt"

_ROW_RE = re.compile(r"^(\w+)\s+(\w+)\s+(\w+)\s+(\d+)\s*(?:#.*)?$")


def ledger_path(root: Path) -> Path:
    """The checked-in ledger, tree-shadowed like wirefuzz's corpus: a
    tmpdir copy of the tree (tests/test_swcheck.py) carries its own."""
    cand = root / LEDGER_REL
    if cand.is_file():
        return cand
    return Path(__file__).resolve().parent / "cost_budgets.txt"


def load_ledger(root: Path):
    """({(engine, path, metric) -> (pin, line)} or None when the ledger
    file itself is gone, [findings])."""
    path = ledger_path(root)
    pins: dict = {}
    out: list = []
    relp = LEDGER_REL
    try:
        text = read_text(path)
    except OSError:
        out.append(Finding(
            relp, 1, "cost-model",
            "cost_budgets.txt missing -- the swcost gate has no pins "
            "(regenerate with `python -m starway_tpu_torch.analysis cost "
            "--write-budgets`; DESIGN.md §23)"))
        return None, out
    for i, line in enumerate(text.splitlines(), 1):
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        m = _ROW_RE.match(s)
        if m is None:
            out.append(Finding(
                relp, i, "cost-model",
                f"malformed ledger row {s!r} (want `engine path metric "
                "value`; DESIGN.md §23)"))
            continue
        engine, pname, metric, value = m.groups()
        key = (engine, pname, metric)
        if engine not in ("py", "cpp") or pname not in PATHS \
                or metric not in METRICS:
            out.append(Finding(
                relp, i, "cost-model",
                f"ledger row pins unknown surface {key} -- stale row or "
                "a renamed path; re-pin the ledger (DESIGN.md §23)"))
            continue
        if key in pins:
            out.append(Finding(
                relp, i, "cost-model",
                f"duplicate ledger row for {key} (DESIGN.md §23)"))
            continue
        pins[key] = (int(value), i)
    return pins, out


def render_ledger(vectors: dict) -> str:
    """The canonical cost_budgets.txt text for an extraction result."""
    lines = [
        "# swcost ledger (DESIGN.md §23): static hot-path cost pins, one",
        "# row per (engine, path, metric) counting SITES, not executions.",
        "# The gate is a ratchet: a row exceeded is a regression; a row",
        "# beaten stays red until the pin here is lowered to match.",
        "# Regenerate: python -m starway_tpu_torch.analysis cost --write-budgets",
        "# Waive a row in place: # swcheck: allow(cost-budget): why",
    ]
    for pname in PATHS:
        lines.append("")
        lines.append(f"# -- {pname}: {' + '.join(PATHS[pname])}")
        for engine in ("py", "cpp"):
            for metric in METRICS:
                v = vectors.get((engine, pname, metric), 0)
                lines.append(f"{engine:<4}{pname:<16}{metric:<10}{v}")
    return "\n".join(lines) + "\n"


# -------------------------------------------------------------- pass


def _check_instrumentation(root: Path, out: list) -> None:
    """The §23 runtime twin must stay alive in both engines: the
    conformance test (tests/test_cost.py) checks deltas only if the
    counters move at all, so a silently-removed increment would leave
    the dynamic side vacuous.  Static liveness closes that hole."""
    checks = (
        (F_CONN, ("io_syscalls += 1", "hot_copies += 1"),
         "self._ctr.<counter> += 1"),
        (F_CPP, ("bump(counters.io_syscalls", "bump(counters.hot_copies"),
         "bump(counters.<counter>)"),
    )
    for f, tokens, idiom in checks:
        path = root / f
        if not path.is_file():
            continue
        text = read_text(path)
        for tok in tokens:
            if tok not in text:
                out.append(Finding(
                    f, 1, "cost-model",
                    f"§23 runtime cost twin dark: no `{tok}` site left in "
                    f"this engine ({idiom} at the hot-path syscall/copy "
                    "sites) -- the dynamic conformance check is vacuous "
                    "(DESIGN.md §23)"))


def run(root: Path) -> list:
    out: list = []
    vectors, vac = extract(root)
    out.extend(vac)

    # Staleness: an engine whose extraction sees ZERO sites for a whole
    # metric class no longer matches the code (every class has known
    # sites at head) -- the ledger would ratify an empty measurement.
    for engine, f in (("py", F_CONN), ("cpp", F_CPP)):
        for metric in METRICS:
            total = sum(v for (e, _, m), v in vectors.items()
                        if e == engine and m == metric)
            if vectors and total == 0:
                out.append(Finding(
                    f, 1, "cost-model",
                    f"swcost extraction stale: zero {metric} sites across "
                    f"every {engine} hot path (the site table no longer "
                    "matches the code; DESIGN.md §23)"))

    pins, lfind = load_ledger(root)
    out.extend(lfind)
    relp = LEDGER_REL
    have_ledger = pins is not None
    pins = pins or {}
    for key, actual in sorted(vectors.items()):
        engine, pname, metric = key
        pinned = pins.pop(key, None)
        if pinned is None:
            if have_ledger:
                out.append(Finding(
                    relp, 1, "cost-model",
                    f"no ledger row for {engine} {pname} {metric} "
                    f"(measured {actual}) -- add the pin (DESIGN.md §23)"))
            continue
        pin, line = pinned
        if actual > pin:
            out.append(Finding(
                relp, line, "cost-budget",
                f"{engine} {pname} {metric}: {actual} sites exceeds the "
                f"pinned budget {pin} -- a hot-path cost regression "
                "(raise the pin only with a ledger-reviewed justification; "
                "DESIGN.md §23)"))
        elif actual < pin:
            out.append(Finding(
                relp, line, "cost-budget",
                f"{engine} {pname} {metric}: {actual} sites beats the "
                f"pinned budget {pin} -- lower the pin to ratchet the "
                "improvement in (DESIGN.md §23)"))
    for key, (pin, line) in sorted(pins.items()):
        out.append(Finding(
            relp, line, "cost-model",
            f"ledger row {' '.join(key)} has no measured twin -- the "
            "extraction no longer produces this vector (DESIGN.md §23)"))

    _check_instrumentation(root, out)
    return out
