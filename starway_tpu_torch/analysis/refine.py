"""Pass: refine -- model<->code conformance (swrefine, DESIGN.md §22).

swproof/swcompose (analysis/protomodel.py, explore.py, compose.py) verify
extracted and hand-written *models* of the protocol; nothing there proves
those models match the *running engines* -- a drifted model makes every
`explore`/`compose` proof vacuous.  swrefine closes that refinement gap
from both ends:

* **Monitor compilation.**  The protomodel-extracted state machines of
  BOTH engines (the ``swcheck: state(...)`` annotations in
  native/sw_engine.cpp; the ast-extracted dispatch of core/conn.py +
  core/engine.py) compile into one nondeterministic-but-checkable
  per-conn monitor automaton over the canonical protocol-event
  vocabulary below.  The automaton tracks the SET of model states a conn
  may be in; an event no tracked state can take is a divergence.

* **Protocol event taps.**  Both engines emit the same event channel
  (swtrace ``EV_PROTO``; armed by STARWAY_PROTO_TRACE / STARWAY_MONITOR,
  zero events on the seed path): ``st:hello-sent``/``st:estab`` at conn
  creation, ``rx:<FRAME>`` at every inbound dispatch, ``tx:<FRAME>`` at
  ctl-plane handoff (context only -- the model describes the *dispatch*
  machine, so the monitor checks rx + lifecycle), and
  ``lost``/``resume``/``expire``/``down`` for the lifecycle.  ``python -m
  starway_tpu_torch.analysis refine --replay <dump>`` replays any ring dump
  through the monitor; ``core/monitor.py`` does the same in-process when
  STARWAY_MONITOR is armed.

* **The gate legs** (this pass, every merge):

  - the canonical frame-name tables -- frames.py ``FRAME_NAMES`` and the
    native ``proto_frame_name()`` switch -- diffed against each other,
    against the T_* constants, and against the protomodel input
    vocabulary (rule ``refine``);
  - the checked-in event corpus (``refine_corpus.txt`` next to this
    file, the wirefuzz_corpus.txt pattern) replayed through the
    freshly-compiled monitor: real event sequences pinned from traced
    runs must stay accepted, and each divergence class must still be
    *detected* (an expected violation that stops firing means the
    monitor went soft);
  - **transition coverage** (rule ``monitor-coverage``): every model
    transition must be witnessed by the corpus or carry a justified
    entry in ``UNWITNESSED_WAIVERS`` -- a transition no pinned run ever
    exercises is a stale model arm or dead code.  (tests/test_swcheck.py
    additionally asserts the LIVE floor: quick scenarios on both engines
    must witness ``COVERAGE_FLOOR`` at runtime.)

**Monitor semantics.**  States: the protomodel vocabulary
(``hello-sent``/``estab``/``suspended``) plus the terminal sinks
``down``/``expired``.  A conn starts from its ``st:`` declaration, or --
for mid-stream replays of a bounded ring -- from the universal live set.
``down`` is always enabled (a transport can die under any state) and is
terminal.  ``expire`` is enabled from ``suspended`` (the model's
grace-expiry row) and, as a documented monitor extension
(``MONITOR_EXTRA``), from ``estab``: the T_BYE arm
``(estab, BYE, estab|expired)`` and both engines' stale-epoch /
one-sided-resume paths expire sessions that never suspended.  Divergence
classes: ``no-transition`` (no tracked state accepts the input),
``state-decl`` (an engine-declared state the monitor contradicts),
``event-after-terminal`` (dispatch after the conn reached only terminal
states), ``bad-event`` (an event outside the canonical vocabulary).
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from . import protomodel
from .base import Finding, parse_or_finding, read_text
from .py_model import module_int_constants

#: swtrace event type the protocol channel rides (EV_PROTO <-> kEvProto).
PROTO_EV = "proto"

LIVE_STATES = ("hello-sent", "estab", "suspended")
TERMINAL_STATES = ("down", "expired")

#: Lifecycle inputs (everything else arrives as rx:<FRAME>).
LIFECYCLE_INPUTS = ("lost", "resume", "expire")

#: Frame-name vocabulary = protomodel's inputs minus the lifecycle.
FRAME_INPUTS = frozenset(protomodel.KNOWN_INPUTS) - frozenset(LIFECYCLE_INPUTS)

#: Documented monitor extensions -- transitions real engines take that the
#: extracted machine does not carry as a dispatch arm.  (estab, expire):
#: the server's stale-epoch registration and the one-sided-resume
#: supersede path expire sessions that never suspended, and the model
#: already admits estab -> expired through the T_BYE arm; the
#: (suspended, expire) model row keeps pinning grace expiry.  Keep this
#: list minimal: every entry here is surface the model checkers cannot
#: see (DESIGN.md §22).
MONITOR_EXTRA = {
    ("estab", "expire"): frozenset({"expired"}),
}

#: Transitions the corpus (or a justified waiver here) must witness; a
#: waiver naming a transition the model no longer contains is itself a
#: finding (stale waiver).  Empty today: every extracted arm is
#: exercisable by a pinned event sequence.
UNWITNESSED_WAIVERS: dict = {}

#: The LIVE runtime floor asserted by tests/test_swcheck.py: quick
#: scenarios (loopback pair + session kill/resume) on EACH engine must
#: witness at least these transitions through real rings -- the
#: corpus-side coverage above proves the monitor can see every arm, this
#: floor proves the taps actually fire in running engines.
COVERAGE_FLOOR = (
    ("hello-sent", "HELLO_ACK"),
    ("estab", "HELLO"),
    ("estab", "DATA"),
    ("estab", "FLUSH"),
    ("estab", "FLUSH_ACK"),
    ("estab", "PING"),
    ("estab", "PONG"),
    ("estab", "SEQ"),
    ("estab", "ACK"),
    ("estab", "lost"),
    ("suspended", "resume"),
)

#: Divergence classes the monitor reports (and the corpus pins).
VIOLATION_CLASSES = ("no-transition", "state-decl", "event-after-terminal",
                     "bad-event")

#: Regression-corpus floor: the gate replays >= this many checked-in
#: sequences or the corpus itself became the regression.
CORPUS_FLOOR = 24


# ------------------------------------------------------------ the monitor


@dataclass
class Violation:
    label: str          # worker/ring label (or corpus case name)
    conn: int
    index: int          # ordinal of the failing event within the conn
    cls: str            # one of VIOLATION_CLASSES
    message: str
    context: list = field(default_factory=list)  # trailing events incl. failing

    def render(self) -> str:
        ctx = " ".join(self.context)
        where = f"{self.label or 'ring'} conn {self.conn} event {self.index}"
        return f"[{self.cls}] {where}: {self.message} [... {ctx}]"


class ConnMonitor:
    """Tracks the set of model states one conn may occupy and steps it
    per protocol event.  ``step`` returns ``(cls, message)`` on the first
    divergence (the caller stops feeding this conn) or None."""

    __slots__ = ("mon", "states", "witnessed")

    def __init__(self, mon: "Monitor"):
        self.mon = mon
        self.states: Optional[frozenset] = None  # None until first event
        self.witnessed: set = set()

    def _init_states(self) -> frozenset:
        # Mid-stream replay (bounded ring lost the conn's birth): any
        # live state is possible.
        return frozenset(LIVE_STATES)

    def step(self, event: str):
        if event == "down":
            # Spontaneous transport death is enabled under every state
            # and terminal (idempotent -- expiry teardown may follow it).
            self.states = frozenset({"down"})
            return None
        if event.startswith("st:"):
            declared = event[3:]
            if declared not in LIVE_STATES:
                return ("bad-event", f"unknown state declaration {event!r}")
            if self.states is None:
                self.states = frozenset({declared})
                return None
            if declared in self.states:
                self.states = frozenset({declared})
                return None
            return ("state-decl",
                    f"engine declared state {declared!r} but the monitor "
                    f"tracks {sorted(self.states)}")
        if event.startswith("tx:"):
            # Context only: the model is the *dispatch* machine; sends
            # are checked at the peer as its rx events.
            name = event[3:]
            if name not in FRAME_INPUTS:
                return ("bad-event", f"unknown tx frame name {event!r}")
            return None
        if event.startswith("rx:"):
            inp = event[3:]
            if inp not in FRAME_INPUTS:
                return ("bad-event", f"unknown rx frame name {event!r}")
        elif event in LIFECYCLE_INPUTS:
            inp = event
        else:
            return ("bad-event", f"event {event!r} outside the canonical "
                                 "vocabulary")
        if self.states is None:
            self.states = self._init_states()
        live = [s for s in self.states if s in LIVE_STATES]
        if not live:
            return ("event-after-terminal",
                    f"event {event!r} dispatched after the conn reached "
                    f"terminal state(s) {sorted(self.states)}")
        nexts: set = set()
        took = []
        for s in live:
            arm = self.mon.transitions.get((s, inp))
            if arm is None:
                arm = MONITOR_EXTRA.get((s, inp))
                if arm is not None:
                    nexts |= arm
                continue
            took.append((s, inp))
            nexts |= arm
        if not nexts:
            return ("no-transition",
                    f"no model transition accepts {event!r} from "
                    f"{sorted(live)} (model states: the engines' own "
                    "extracted machines -- drifted model or drifted code)")
        self.witnessed.update(took)
        self.states = frozenset(nexts)
        return None


class Monitor:
    """The compiled automaton: ``{(state, input): frozenset(next)}`` from
    the union of both engines' extracted machines (protomodel diffs them
    transition-by-transition separately)."""

    def __init__(self, transitions: dict):
        self.transitions = {k: frozenset(v) for k, v in transitions.items()}

    def new_conn(self) -> ConnMonitor:
        return ConnMonitor(self)

    def replay(self, events, label: str = ""):
        """Replay one ring's swtrace events (7-tuples or JSON lists).
        Returns ``(violations, witnessed)``; each conn stops at its first
        divergence, other conns keep replaying."""
        conns: dict = {}
        dead: set = set()
        viols: list = []
        witnessed: set = set()
        trail: dict = {}
        seen_n: dict = {}
        for e in events:
            if len(e) < 6 or e[1] != PROTO_EV:
                continue
            conn_id, event = int(e[3]), str(e[5])
            if conn_id in dead:
                continue
            cm = conns.get(conn_id)
            if cm is None:
                cm = conns[conn_id] = self.new_conn()
                trail[conn_id] = []
                seen_n[conn_id] = 0
            tr = trail[conn_id]
            tr.append(event)
            del tr[:-10]
            seen_n[conn_id] += 1
            res = cm.step(event)
            if res is not None:
                cls, msg = res
                viols.append(Violation(label, conn_id, seen_n[conn_id], cls,
                                       msg, list(tr)))
                dead.add(conn_id)
        for cm in conns.values():
            witnessed |= cm.witnessed
        return viols, witnessed


def compile_monitor(root=None, runtime: bool = False):
    """Compile the monitor from the tree's extracted machines.  Returns
    ``(Monitor | None, problems: list[str])``.  With ``runtime=True``
    (core/monitor.py) the root defaults to the running package's own
    tree and a missing native source is tolerated (installed wheels ship
    no native/ -- the Python machine alone still checks both engines'
    rings, the vocabulary being shared)."""
    problems: list = []
    if root is None:
        root = Path(__file__).resolve().parents[2]
    root = Path(root)
    py, py_f = protomodel.extract_py_machine(root)
    trans: dict = {k: set(v[0]) for k, v in py.transitions.items()}
    cpp_path = root / "starway_tpu_torch" / "native" / "sw_engine.cpp"
    if cpp_path.is_file() or not runtime:
        cpp, cpp_f = protomodel.extract_cpp_machine(root)
        for k, (nexts, _f, _l) in cpp.transitions.items():
            trans.setdefault(k, set()).update(nexts)
        problems += [f.render() for f in cpp_f]
    problems += [f.render() for f in py_f]
    if not trans:
        problems.append("no transitions extracted -- monitor would be "
                        "vacuous")
        return None, problems
    return Monitor(trans), problems


# -------------------------------------------------- frame-name vocabulary


def _py_frame_names(root: Path, out: list):
    """frames.py FRAME_NAMES dict literal -> ({T_* name: event name}, line)."""
    rel = "starway_tpu_torch/core/frames.py"
    path = root / rel
    if not path.is_file():
        out.append(Finding(rel, 1, "refine", "frames.py missing -- cannot "
                           "extract the protocol-event name table"))
        return None
    tree, err = parse_or_finding(path, rel)
    if tree is None:
        out.append(err)
        return None
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "FRAME_NAMES" \
                and isinstance(node.value, ast.Dict):
            table = {}
            for k, v in zip(node.value.keys, node.value.values):
                kname = ""
                if isinstance(k, ast.Name):
                    kname = k.id
                elif isinstance(k, ast.Attribute):
                    kname = k.attr
                if kname.startswith("T_") and isinstance(v, ast.Constant) \
                        and isinstance(v.value, str):
                    table[kname] = v.value
            return table, node.lineno
    out.append(Finding(rel, 1, "refine",
                       "FRAME_NAMES table not found in frames.py -- the "
                       "protocol-event channel has no canonical vocabulary "
                       "(DESIGN.md §22)"))
    return None


_CPP_CASE_RE = re.compile(r'case\s+(T_\w+)\s*:\s*return\s+"(\w+)"\s*;')


def _cpp_frame_names(root: Path, out: list):
    """The native proto_frame_name() switch -> ({T_* name: name}, line)."""
    rel = "starway_tpu_torch/native/sw_engine.cpp"
    path = root / rel
    if not path.is_file():
        out.append(Finding(rel, 1, "refine", "native engine source missing "
                           "-- cannot extract proto_frame_name()"))
        return None
    lines = read_text(path).splitlines()
    start = None
    for i, line in enumerate(lines):
        if "proto_frame_name" in line and "(" in line and ";" not in line:
            start = i
            break
    if start is None:
        out.append(Finding(rel, 1, "refine",
                           "proto_frame_name() not found in the native "
                           "engine -- the protocol-event channel has no "
                           "frame-name table there (DESIGN.md §22)"))
        return None
    table: dict = {}
    for i in range(start, min(start + 80, len(lines))):
        m = _CPP_CASE_RE.search(lines[i])
        if m:
            table[m.group(1)] = m.group(2)
        if lines[i].startswith("}"):
            break
    if not table:
        out.append(Finding(rel, start + 1, "refine",
                           "proto_frame_name() carries no case arms -- "
                           "vacuous frame-name table"))
        return None
    return table, start + 1


def _check_vocabulary(root: Path, out: list) -> None:
    f_frames = "starway_tpu_torch/core/frames.py"
    f_cpp = "starway_tpu_torch/native/sw_engine.cpp"
    py_rec = _py_frame_names(root, out)
    cpp_rec = _cpp_frame_names(root, out)
    frames_path = root / f_frames
    t_consts = {}
    if frames_path.is_file():
        tree, _ = parse_or_finding(frames_path, f_frames)
        if tree is not None:
            t_consts = {k: v for k, v in module_int_constants(tree).items()
                        if k.startswith("T_")}
    if py_rec is None or cpp_rec is None:
        return
    py_tbl, py_line = py_rec
    cpp_tbl, cpp_line = cpp_rec
    for side, tbl, f, line in (("frames.py FRAME_NAMES", py_tbl, f_frames,
                                py_line),
                               ("proto_frame_name()", cpp_tbl, f_cpp,
                                cpp_line)):
        for tname, (val, tline) in sorted(t_consts.items()):
            if tname not in tbl:
                out.append(Finding(
                    f, line, "refine",
                    f"frame constant {tname} (= {val}) has no entry in "
                    f"{side} -- its frames would monitor as OTHER "
                    "(unknown-frame conn death in the model)"))
        for tname, name in sorted(tbl.items()):
            if tname not in t_consts:
                out.append(Finding(
                    f, line, "refine",
                    f"{side} maps {tname} which is not a frame constant "
                    "(stale table entry)"))
            if name != tname[2:]:
                out.append(Finding(
                    f, line, "refine",
                    f"{side} maps {tname} -> {name!r}; the canonical "
                    f"event name is the T_ suffix ({tname[2:]!r})"))
            if name not in protomodel.KNOWN_INPUTS:
                out.append(Finding(
                    f, line, "refine",
                    f"{side} name {name!r} is outside the protomodel "
                    "input vocabulary -- the monitor would reject it as "
                    "bad-event"))
    for tname in sorted(set(py_tbl) | set(cpp_tbl)):
        if py_tbl.get(tname) != cpp_tbl.get(tname):
            out.append(Finding(
                f_frames, py_line, "refine",
                f"frame-name tables disagree on {tname}: frames.py has "
                f"{py_tbl.get(tname)!r}, {f_cpp}:{cpp_line} has "
                f"{cpp_tbl.get(tname)!r} (two engines, one event "
                "vocabulary)"))
    # Tap-presence guard: the channel exists only if both engines still
    # emit it -- an engine that loses its taps makes every replay
    # vacuously green.
    conn_rel = "starway_tpu_torch/core/conn.py"
    conn_path = root / conn_rel
    if conn_path.is_file() and "EV_PROTO" not in read_text(conn_path):
        out.append(Finding(conn_rel, 1, "refine",
                           "core/conn.py never emits EV_PROTO -- the "
                           "Python engine's protocol-event taps are gone "
                           "(replay would pass vacuously)"))
    cpp_path = root / f_cpp
    if cpp_path.is_file():
        text = read_text(cpp_path)
        if text.count("kEvProto") < 2:
            out.append(Finding(f_cpp, 1, "refine",
                               "sw_engine.cpp defines but never records "
                               "kEvProto -- the native engine's protocol-"
                               "event taps are gone"))


# --------------------------------------------------------------- corpus


def corpus_path(root: Optional[Path] = None) -> Path:
    """The tree-under-check's corpus when it carries one (so seeded
    trees can shadow it), else the installed package's own."""
    if root is not None:
        cand = root / "starway_tpu_torch" / "analysis" / "refine_corpus.txt"
        if cand.is_file():
            return cand
    return Path(__file__).resolve().parent / "refine_corpus.txt"


def load_corpus(out: list, root: Optional[Path] = None) -> list:
    """[(name, expect, [events], lineno)] from the checked-in corpus.
    Format errors and a shrunken corpus are findings, never silent
    skips."""
    path = corpus_path(root)
    rel = "starway_tpu_torch/analysis/refine_corpus.txt"
    if not path.is_file():
        out.append(Finding(rel, 1, "refine",
                           "event regression corpus missing -- the gate "
                           "would replay nothing (DESIGN.md §22)"))
        return []
    cases: list = []
    for i, raw in enumerate(read_text(path).splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = [p.strip() for p in line.split("|")]
        if len(parts) != 3 or not parts[0] or not parts[2]:
            out.append(Finding(rel, i, "refine",
                               f"malformed corpus line: {raw[:60]!r} "
                               "(want `name | ok|violation:<class> | "
                               "ev ev ...`)"))
            continue
        name, expect, evs = parts
        if expect != "ok" and not (expect.startswith("violation:")
                                   and expect[10:] in VIOLATION_CLASSES):
            out.append(Finding(rel, i, "refine",
                               f"corpus case {name!r} expects {expect!r} "
                               f"-- not `ok` or a known violation class "
                               f"{list(VIOLATION_CLASSES)}"))
            continue
        cases.append((name, expect, evs.split(), i))
    if len(cases) < CORPUS_FLOOR:
        out.append(Finding(rel, 1, "refine",
                           f"corpus replays only {len(cases)} cases -- "
                           f"below the {CORPUS_FLOOR}-case floor (pinned "
                           "sequences must not silently shrink)"))
    return cases


def _replay_case(mon: Monitor, events: list):
    """One corpus sequence through one fresh conn monitor.  Returns
    ``(outcome, witnessed)`` with outcome `ok` or `violation:<class>`."""
    cm = mon.new_conn()
    for ev in events:
        res = cm.step(ev)
        if res is not None:
            return f"violation:{res[0]}", cm.witnessed
    return "ok", cm.witnessed


# ------------------------------------------------------- ring-dump replay


def replay_dump(path, root=None) -> list:
    """Replay a swtrace ring dump (swtrace.write_ring_dump shape) or a
    flight-recorder dump through the monitor; returns Violations.  The
    ``refine --replay`` CLI surface (DESIGN.md §22)."""
    mon, problems = compile_monitor(root, runtime=True)
    if mon is None:
        raise SystemExit("refine: cannot compile the monitor: "
                         + "; ".join(problems))
    doc = json.loads(Path(path).read_text())
    rings = []
    if isinstance(doc, dict) and "workers" in doc:
        rings = [(w.get("worker", "?"), w.get("events", []))
                 for w in doc["workers"]]
    elif isinstance(doc, dict) and "events" in doc:
        rings = [(doc.get("worker", "?"), doc["events"])]
    else:
        raise SystemExit(f"refine: {path} is not a ring or flight dump "
                         "(want a `workers` or `events` key)")
    out: list = []
    for label, events in rings:
        viols, _ = mon.replay(events, label=label)
        out.extend(viols)
    return out


# ------------------------------------------------------------------ pass


def run(root: Path) -> list:
    out: list = []
    _check_vocabulary(root, out)
    mon, problems = compile_monitor(root)
    corpus_rel = "starway_tpu_torch/analysis/refine_corpus.txt"
    if mon is None:
        # protomodel's own vacuity findings cover the empty-machine case;
        # refine must still refuse to pass standalone.
        out.append(Finding("starway_tpu_torch/core/conn.py", 1, "refine",
                           "monitor compilation produced no transitions -- "
                           "conformance checking would be vacuous"))
        return out
    cases = load_corpus(out, root)
    witnessed: set = set()
    expected_hit: set = set()
    for name, expect, events, lineno in cases:
        outcome, seen = _replay_case(mon, events)
        witnessed |= seen
        if expect.startswith("violation:"):
            expected_hit.add(expect[10:])
        if outcome != expect:
            out.append(Finding(
                corpus_rel, lineno, "refine",
                f"corpus case {name!r}: expected {expect} but the monitor "
                f"answered {outcome} -- the model and its pinned event "
                "history disagree (engine transition changed? update the "
                "model AND the corpus together, DESIGN.md §22)"))
    # Every divergence class must stay detectable: a class no corpus case
    # pins (or that stopped firing, caught above) is a soft monitor.
    if cases:
        for cls in VIOLATION_CLASSES:
            if cls not in expected_hit:
                out.append(Finding(
                    corpus_rel, 1, "refine",
                    f"no corpus case pins divergence class `{cls}` -- the "
                    "monitor's detection of it is unregressable"))
    # Transition coverage: the corpus (plus justified waivers) must
    # witness every model arm.
    for key, why in sorted(UNWITNESSED_WAIVERS.items()):
        if key not in mon.transitions:
            out.append(Finding(
                corpus_rel, 1, "monitor-coverage",
                f"waiver for transition {key} names no model transition "
                "(stale waiver -- the arm is gone, drop the entry)"))
        if not str(why).strip():
            out.append(Finding(
                corpus_rel, 1, "monitor-coverage",
                f"waiver for transition {key} has no justification"))
    if cases:
        missing = [k for k in sorted(mon.transitions)
                   if k not in witnessed and k not in UNWITNESSED_WAIVERS]
        if missing:
            fmt = ", ".join(f"({s}, {i})" for s, i in missing)
            out.append(Finding(
                corpus_rel, 1, "monitor-coverage",
                f"model transition(s) never witnessed by the corpus and "
                f"not waived: {fmt} -- stale model arm, dead code, or a "
                "coverage gap (pin a traced sequence or add a justified "
                "UNWITNESSED_WAIVERS entry, DESIGN.md §22)"))
    return out
