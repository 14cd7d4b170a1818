"""Pass: compose -- bounded model checking of the COMPOSED protocol planes.

analysis/explore.py exhausts the §14 session core in isolation; this
pass exhausts the *product* of the opt-in planes that have grown around
it -- §14 sessions x §17 striped chunks x §18 credit flow control x §19
integrity retransmit -- because every recent review-round bug (a CTS
consumed by a dead incarnation, per-conn unexpected-queue charging, the
resume re-debit of parked frames) lived in exactly the cross-plane seams
a single-plane model cannot see (DESIGN.md §21).

**The model.**  One sender, one receiver, one resilient session.  The
workload is one striped message of two chunks (offsets 0 and 1, unit
sized, SACKed at the last offset) plus one eager data frame governed by
a one-unit §18 window.  Channels are FIFO: a c2s control stream (the
eager frame), an r2s control stream (ACK / CREDIT / SACK / SNACK), and
two rails carrying chunks.  The fault vocabulary, enumerated
exhaustively at every interleaving: a connection kill (suspend + resume
with journal replay and the §18 fresh-window re-debit), a rail death
(in-flight chunks redistribute onto the survivor), one corrupt chunk
(the §19 verified-routing T_SNACK retransmit), and one wire-duplicated
chunk (offset-dedup idempotence).  Faithful rules, straight from
DESIGN.md §§14/17/18/19:

* chunks are idempotent self-describing frames; the receiver records
  each offset once and answers SACK when the last byte lands;
* the sender pins the striped payload until the SACK -- a SNACK
  retransmit, a rail-death redistribution, and a resume re-announce all
  re-read the pinned bytes;
* the eager frame debits the window at submit and the grant returns as
  the receiver matches/drains it; resume resets to the full window and
  re-debits journal-replayed frames;
* a corrupt chunk with verified routing NACKs and retransmits alone --
  its bytes are never recorded;
* session replay re-offers undelivered chunks and the journaled eager
  frame; the receiver's seq/offset dedup keeps delivery exactly-once.

**Invariants** (each backed by a seeded model mutation in
tests/test_swcheck.py that makes it fire):

===================  ==================================================
stripe-exactly-once  a striped message completes exactly once, from
                     exactly the full offset set, across dups, rail
                     deaths, and resume replay (``chunk-no-dedup``)
pin-release          the pinned payload is released only by the SACK;
                     no retransmit / redistribution / replay ever needs
                     bytes that are gone (``early-unpin``: release at
                     local handoff, the pre-§17 eager discipline)
credit-conservation  the §18 window is never overcommitted across
                     incarnations: outstanding debits + remaining
                     credits never exceed the advertised window, and at
                     clean quiescence the window is whole
                     (``resume-no-redebit``: a resume that resets the
                     window without re-debiting replayed frames)
no-wrong-answer      corrupt chunk bytes never complete a receive
                     (``accept-corrupt``: record the chunk anyway)
quiescence           every schedule ends with the ops complete or
                     stably failed -- no silent wedge
                     (``snack-drop``: the sender ignores SNACK and the
                     chunk is never re-queued)
===================  ==================================================

Like explore, the pass refuses to run vacuously: the Python engine's
extracted machine (analysis/protomodel.py) must still contain the
dispatch arms this model abstracts -- (estab, SDATA/SACK/SNACK/CREDIT)
and (suspended, resume); if extraction lost them the model no longer
describes the code and that is a finding, not a pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Optional

from .base import Finding
from . import protomodel

#: §18 window in abstract units; the eager frame debits one.
FC_W = 1

#: Striped-message offsets (unit chunks; SACK at the full set).
OFFS = (0, 1)

#: Per-schedule fault budgets.  One of each is enough for every seam the
#: invariants guard (a replay overlapping a retransmit needs kill after
#: corrupt; redistribution-after-release needs rail death alone) while
#: keeping the product space exhaustible on the 1-core box.
BUDGET_KILLS = 1
BUDGET_RAIL_DEATHS = 1
BUDGET_CORRUPTS = 1
BUDGET_DUPS = 1

#: Seeded model mutations -> the invariant each must trip.
MUTATIONS = {
    "chunk-no-dedup": "stripe-exactly-once",
    "early-unpin": "pin-release",
    "resume-no-redebit": "credit-conservation",
    "accept-corrupt": "no-wrong-answer",
    "snack-drop": "quiescence",
}

INVARIANTS = ("stripe-exactly-once", "pin-release", "credit-conservation",
              "no-wrong-answer", "quiescence")

# chunk states: "todo" (needs a rail), "fly" (riding one), "landed"
# (offset recorded by the receiver), "lost" (corrupt-dropped, awaiting
# the SNACK round trip).


@dataclass(frozen=True)
class _State:
    chunks: tuple = ("todo", "todo")
    pinned: bool = True
    sacked: bool = False
    completed: bool = False
    completions: int = 0
    received: int = 0            # recorded chunk units (dups count under
    got_offs: frozenset = frozenset()  # the no-dedup mutation)
    wrong: bool = False          # a corrupt chunk's bytes were recorded
    e_submitted: bool = False
    journal_e: bool = False      # journaled & unacked
    e_deliv: int = 0
    rx_cum: int = 0              # seq dedup for the eager frame
    credits: int = FC_W
    debits: int = 0              # debited, grant not yet back
    c2s: tuple = ()              # ("e",)
    r2s: tuple = ()              # ("ack",)/("credit",)/("sack",)/("snack", off)
    rail0: tuple = ()            # (off, corrupt)
    rail1: tuple = ()
    rail1_alive: bool = True
    suspended: bool = False
    expired: bool = False
    kills: int = BUDGET_KILLS
    rail_deaths: int = BUDGET_RAIL_DEATHS
    corrupts: int = BUDGET_CORRUPTS
    dups: int = BUDGET_DUPS


def _is_terminal(s: _State) -> bool:
    if s.expired:
        return True
    if s.suspended:
        return False
    return (s.e_submitted and s.e_deliv >= 1 and not s.journal_e
            and s.sacked and all(c == "landed" for c in s.chunks)
            and not s.c2s and not s.r2s and not s.rail0 and not s.rail1)


@dataclass
class _Run:
    mutation: Optional[str] = None
    schedules: int = 0
    states: int = 0
    violations: list = field(default_factory=list)
    _seen_viol: set = field(default_factory=set)

    def violate(self, invariant: str, msg: str, trace: tuple) -> None:
        if invariant not in self._seen_viol:
            self._seen_viol.add(invariant)
            self.violations.append((invariant, msg, trace))


def _check_window(s: _State, run: _Run, trace: tuple) -> None:
    """§18 conservation, checked at every state: the receiver advertised
    FC_W -- outstanding debits plus the sender's remaining credits can
    never exceed it (overcommit = unbounded receiver memory), and no
    counter may go negative."""
    if s.credits + s.debits > FC_W or s.credits < 0 or s.debits < 0:
        run.violate(
            "credit-conservation",
            f"window overcommitted: credits={s.credits} debits={s.debits} "
            f"exceed the advertised window {FC_W} (the receiver's memory "
            "bound no longer holds)", trace)


def _set_chunk(chunks: tuple, off: int, state: str) -> tuple:
    out = list(chunks)
    out[off] = state
    return tuple(out)


def _record_chunk(s: _State, off: int, corrupt: bool, run: _Run,
                  trace: tuple) -> _State:
    """The receiver records one arriving chunk (dedup already decided by
    the caller under the faithful model)."""
    wrong = s.wrong or corrupt
    received = s.received + 1
    got = s.got_offs | {off}
    chunks = _set_chunk(s.chunks, off, "landed")
    completions = s.completions
    completed = s.completed
    r2s = s.r2s
    if run.mutation == "chunk-no-dedup":
        complete_now = received >= len(OFFS)
    else:
        complete_now = got == frozenset(OFFS) and not completed
    if complete_now:
        completions += 1
        if completions > 1:
            run.violate(
                "stripe-exactly-once",
                "striped message completed twice (duplicate offsets "
                "double-counted into the assembly)", trace)
        if len(got) < len(OFFS):
            run.violate(
                "stripe-exactly-once",
                f"striped message completed from offsets {sorted(got)} -- "
                f"not the full set {list(OFFS)} (duplicate counted for a "
                "missing chunk)", trace)
        if wrong:
            run.violate(
                "no-wrong-answer",
                "a corrupt chunk's bytes completed the striped receive "
                "(corruption must be a recoverable fault, never a wrong "
                "answer)", trace)
        completed = True
        r2s = r2s + (("sack",),)
    return replace(s, chunks=chunks, received=received, got_offs=got,
                   wrong=wrong, completions=completions,
                   completed=completed, r2s=r2s)


def _enabled(s: _State) -> list:
    if s.expired:
        return []
    if s.suspended:
        return ["resume", "expire"]
    acts = []
    if not s.e_submitted and s.credits > 0:
        acts.append("submit_e")
    if "todo" in s.chunks:
        acts.append("send0")
        if s.rail1_alive:
            acts.append("send1")
    if s.c2s:
        acts.append("dlv_m")
    if s.r2s:
        acts.append("dlv_r")
    if s.rail0:
        acts.append("dlv_c0")
    if s.rail1:
        acts.append("dlv_c1")
    if s.corrupts > 0:
        if s.rail0 and not s.rail0[0][1]:
            acts.append("corrupt0")
        if s.rail1 and not s.rail1[0][1]:
            acts.append("corrupt1")
    if s.dups > 0:
        if s.rail0:
            acts.append("dup0")
        if s.rail1:
            acts.append("dup1")
    if s.kills > 0:
        acts.append("kill")
    if s.rail_deaths > 0 and s.rail1_alive:
        acts.append("rail_death")
    return acts


def _apply(s: _State, act: str, run: _Run, trace: tuple) -> _State:
    mut = run.mutation
    if act == "submit_e":
        return replace(s, e_submitted=True, journal_e=True,
                       credits=s.credits - 1, debits=s.debits + 1,
                       c2s=s.c2s + (("e",),))
    if act in ("send0", "send1"):
        off = s.chunks.index("todo")
        if not s.pinned:
            run.violate(
                "pin-release",
                f"chunk (re)send at offset {off} after the pinned payload "
                "was released -- only the receiver's SACK may release it "
                "(retransmit/redistribution/replay all re-read the pin)",
                trace + (act,))
        chunks = _set_chunk(s.chunks, off, "fly")
        rail = "rail0" if act == "send0" else "rail1"
        ns = replace(s, chunks=chunks,
                     **{rail: getattr(s, rail) + ((off, False),)})
        if mut == "early-unpin" and "todo" not in ns.chunks:
            # The buggy shape: release at local handoff (every chunk on a
            # rail), not at end-to-end SACK.
            ns = replace(ns, pinned=False)
        return ns
    if act in ("dlv_c0", "dlv_c1"):
        rail = "rail0" if act == "dlv_c0" else "rail1"
        (off, corrupt), rest = getattr(s, rail)[0], getattr(s, rail)[1:]
        s = replace(s, **{rail: rest})
        if corrupt and mut != "accept-corrupt":
            # §19: payload CRC failed, routing verified -> SNACK, and the
            # chunk is NOT recorded.  The sender re-queues it from the
            # pinned payload when the SNACK lands.
            chunks = s.chunks
            if chunks[off] == "fly":
                chunks = _set_chunk(chunks, off, "lost")
            return replace(s, chunks=chunks,
                           r2s=s.r2s + (("snack", off),))
        if off in s.got_offs and mut != "chunk-no-dedup":
            # Duplicate offset (wire dup / replay overlap): idempotent
            # drop.  A completed message re-SACKs so the sender stops
            # (the done-ids path).
            r2s = s.r2s
            if s.completed and not s.sacked:
                r2s = r2s + (("sack",),)
            return replace(s, r2s=r2s)
        return _record_chunk(s, off, corrupt, run, trace + (act,))
    if act == "dlv_m":
        msg, rest = s.c2s[0], s.c2s[1:]
        assert msg[0] == "e"
        if s.rx_cum >= 1:
            # Seq dedup: drained, not delivered -- but the (re-)debited
            # window still returns (§18).
            return replace(s, c2s=rest, r2s=s.r2s + (("credit",),))
        return replace(s, c2s=rest, rx_cum=1, e_deliv=s.e_deliv + 1,
                       r2s=s.r2s + (("credit",), ("ack",)))
    if act == "dlv_r":
        msg, rest = s.r2s[0], s.r2s[1:]
        if msg[0] == "credit":
            ns = replace(s, r2s=rest, credits=s.credits + 1,
                         debits=s.debits - 1)
            _check_window(ns, run, trace + (act,))
            return ns
        if msg[0] == "ack":
            return replace(s, r2s=rest, journal_e=False)
        if msg[0] == "sack":
            return replace(s, r2s=rest, sacked=True, pinned=False)
        # snack: re-queue exactly that chunk from the pinned payload.
        off = msg[1]
        if mut == "snack-drop":
            return replace(s, r2s=rest)
        chunks = s.chunks
        if chunks[off] == "lost":
            chunks = _set_chunk(chunks, off, "todo")
        return replace(s, r2s=rest, chunks=chunks)
    if act in ("corrupt0", "corrupt1"):
        rail = "rail0" if act == "corrupt0" else "rail1"
        q = getattr(s, rail)
        return replace(s, corrupts=s.corrupts - 1,
                       **{rail: ((q[0][0], True),) + q[1:]})
    if act in ("dup0", "dup1"):
        rail = "rail0" if act == "dup0" else "rail1"
        q = getattr(s, rail)
        return replace(s, dups=s.dups - 1, **{rail: (q[0],) + q})
    if act == "rail_death":
        # The secondary transport died: its in-flight chunks are gone and
        # redistribute onto the survivor (which re-reads the pin).
        chunks = s.chunks
        for off, _corrupt in s.rail1:
            if chunks[off] == "fly":
                chunks = _set_chunk(chunks, off, "todo")
        return replace(s, rail_deaths=s.rail_deaths - 1, rail1_alive=False,
                       rail1=(), chunks=chunks)
    if act == "kill":
        # Conn death: every wire wiped, session suspended.  In-flight
        # chunks will be re-announced by the resume replay.
        chunks = tuple("todo" if c == "fly" else c for c in s.chunks)
        return replace(s, kills=s.kills - 1, suspended=True, chunks=chunks,
                       c2s=(), r2s=(), rail0=(), rail1=())
    if act == "resume":
        # §14 replay + §17 per-message re-announce + §18 fresh window.
        # The resume handshake carries the receiver's cumulative seq
        # (sess_ack): an eager frame the receiver already processed is
        # trimmed from the journal HERE, never replayed -- losing its
        # in-flight ACK with the conn costs nothing.
        journal_e = s.journal_e and s.rx_cum < 1
        chunks = tuple("todo" if c in ("fly", "lost") else c
                       for c in s.chunks) if not s.sacked else s.chunks
        c2s = (("e",),) if journal_e else ()
        replay_debit = 1 if journal_e else 0
        if mut == "resume-no-redebit":
            # The buggy shape: full window, replayed frames not debited.
            credits, debits = FC_W, s.debits
        else:
            credits, debits = FC_W - replay_debit, replay_debit
        r2s = ()
        if s.completed and not s.sacked:
            # The sender's re-announce meets the receiver's done-ids
            # dedup and draws a fresh SACK (modeled as the direct
            # re-offer).
            r2s = (("sack",),)
        ns = replace(s, suspended=False, journal_e=journal_e, chunks=chunks,
                     c2s=c2s, r2s=r2s, credits=credits, debits=debits)
        _check_window(ns, run, trace + (act,))
        return ns
    if act == "expire":
        # Grace expiry: terminal; every pending op fails with the stable
        # reason and the pin is released with the failed sends.
        return replace(s, expired=True, suspended=False, pinned=False,
                       c2s=(), r2s=(), rail0=(), rail1=())
    raise AssertionError(f"unknown action {act}")


def check(mutation: Optional[str] = None, max_states: int = 400_000) -> dict:
    """Exhaust the composed model under ``mutation`` (None = faithful).
    Returns ``{"schedules", "states", "violations"}`` -- schedules is the
    number of distinct complete root-to-terminal action sequences,
    counted by DP over the memoized state graph (explore.check's
    convention)."""
    if mutation is not None and mutation not in MUTATIONS:
        raise ValueError(f"unknown mutation {mutation!r} "
                         f"(choose from {sorted(MUTATIONS)})")
    run = _Run(mutation=mutation)
    paths: dict = {}

    def visit(s: _State, trace: tuple, depth: int) -> int:
        if s in paths:
            return paths[s]
        if depth > 400 or len(paths) > max_states:
            run.violate("quiescence",
                        "state space exploded past the model bound "
                        "(runaway retransmit/replay loop)", trace)
            paths[s] = 0
            return 0
        if _is_terminal(s):
            paths[s] = 1
            return 1
        acts = _enabled(s)
        if not acts:
            pending = [f"chunk{off}={st}" for off, st in enumerate(s.chunks)
                       if st != "landed"]
            run.violate(
                "quiescence",
                "deadlock: ops pending but no action enabled "
                f"({', '.join(pending) or 'control plane wedged'}, "
                f"sacked={s.sacked})", trace)
            paths[s] = 0
            return 0
        paths[s] = 0  # cycle guard
        total = 0
        for act in acts:
            total += visit(_apply(s, act, run, trace), trace + (act,),
                           depth + 1)
        paths[s] = total
        return total

    schedules = visit(_State(), (), 0)
    for s in list(paths):
        if _is_terminal(s) and not s.expired:
            if s.completions != 1:
                run.violate(
                    "stripe-exactly-once",
                    f"clean quiescence with completions={s.completions} "
                    "(want exactly 1)", ())
            if s.credits != FC_W or s.debits != 0:
                run.violate(
                    "credit-conservation",
                    f"clean quiescence with credits={s.credits} "
                    f"debits={s.debits} -- the §18 window ({FC_W}) was "
                    "permanently lost across the schedule", ())
            if s.pinned:
                run.violate(
                    "pin-release",
                    "clean quiescence with the payload still pinned after "
                    "its SACK -- the release leaked", ())
    return {"schedules": schedules, "states": len(paths),
            "violations": run.violations}


#: Dispatch arms the composed model abstracts; their disappearance from
#: the extracted machine means the model no longer describes the code.
_REQUIRED_TRANSITIONS = (
    ("estab", "SDATA"), ("estab", "SACK"), ("estab", "SNACK"),
    ("estab", "CREDIT"), ("suspended", "resume"),
)


#: The faithful model is pure (no tree input): memoized so the many
#: seeded-tree invocations in tests/test_swcheck.py pay the exploration
#: once, not per run_all call.  Mutated runs are never cached.
_FAITHFUL: Optional[dict] = None


def run(root: Path) -> list:
    global _FAITHFUL
    out: list = []
    machine, extract_findings = protomodel.extract_py_machine(root)
    missing = [key for key in _REQUIRED_TRANSITIONS
               if key not in machine.transitions]
    if missing and not extract_findings:
        out.append(Finding(
            "starway_tpu_torch/core/lane.py", 1, "proto-compose",
            f"the composed model's transitions {missing} are no longer "
            "extracted from the engine -- the product model would verify "
            "planes the code does not implement (update the model or the "
            "extraction grammar, DESIGN.md §21)"))
        return out
    if _FAITHFUL is None:
        _FAITHFUL = check(None)
    result = _FAITHFUL
    for invariant, msg, trace in result["violations"]:
        out.append(Finding(
            "starway_tpu_torch/core/lane.py", 1, "proto-compose",
            f"composed-plane invariant `{invariant}` violated: {msg} "
            f"[schedule: {' -> '.join(trace) or '<initial>'}]"))
    if result["schedules"] < 2000:
        out.append(Finding(
            "starway_tpu_torch/core/lane.py", 1, "proto-compose",
            f"only {result['schedules']} composed fault schedules "
            "enumerated -- the bounded exploration lost coverage (model "
            "bounds shrunk?)"))
    return out
