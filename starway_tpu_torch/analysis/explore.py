"""Pass: explore -- bounded exhaustive model checking of the session layer.

scripts/session_chaos.py *samples* fault schedules against the live
engines; this pass makes the same oracle **total** over an abstract model
of the §14 resilient-session machine: two peers, a bounded workload
(two data sends and a flush), and every interleaving of the FaultProxy
fault vocabulary -- connection kills, duplicated sequenced units,
adjacent reorders, and a peer restart (epoch bump) -- enumerated
exhaustively instead of sampled.  The model is deliberately small enough
to exhaust (a few thousand states, >1k complete schedules) and
deliberately faithful to DESIGN.md §14's load-bearing rules:

* frames are sequenced at submit and journaled until the peer's
  cumulative ACK covers them; replay resends whole frames in order from
  the journal past the ACK carried by the resume handshake;
* the receiver drops any frame whose seq it has already processed
  (exactly-once across replay overlap) and resets on a seq gap;
* FLUSH_ACK is itself sequenced/journaled (a barrier ACK lost with the
  conn must replay, modeled as the receiver re-offering it on resume);
* a resume dial answered with a different epoch expires the session;
  grace expiry is terminal and fails everything with a stable reason.

**Invariants** (each backed by a seeded model mutation in
tests/test_swcheck.py that makes it fire):

=================  =====================================================
exactly-once       no data payload is delivered twice (``no-dedup``)
journal-trim       ACK-driven trim never drops an unacked frame, and
                   every frame the receiver may still need is
                   replayable (``trim-overshoot``)
flush-order        a completed flush barrier proves every data frame
                   submitted before it was delivered (``ack-overclaim``)
epoch              sessions never resume across an epoch change, and
                   epochs never regress (``resume-ignores-epoch``)
quiescence         from every reachable state the run ends -- every op
                   completes or fails with a stable reason; no silent
                   deadlock states (``no-replay``)
credit-conservation
                   the §18 flow-control window is never permanently
                   lost across kill/resume schedules: at clean
                   quiescence the sender's credits equal the advertised
                   window.  Grants lost in flight are healed by the
                   resume-time full-window reset; replayed frames
                   re-debit and their (possibly duplicate) deliveries
                   re-grant, clamped at the window (``credit-leak``:
                   a resume that carries stale credits across the
                   incarnation leaks the in-flight grants forever)
=================  =====================================================

The pass also refuses to run vacuously: the Python engine's extracted
state machine (analysis/protomodel.py) must still contain the session
transitions this model abstracts ((estab, SEQ), (estab, lost),
(suspended, resume), (suspended, expire)); if extraction lost them, the
model no longer describes the code and that is a finding, not a pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Optional

from .base import Finding
from . import protomodel

#: Model bounds: 2 data ops + 1 flush, <=3 in-flight sequenced frames,
#: and per-schedule fault budgets (2 kills, 1 dup, 1 reorder, 1 restart,
#: 2 gap-resets before grace gives up).  Small enough to exhaust on the
#: 1-core box inside the gate budget, large enough that every invariant
#: has room to break (a replay overlapping live frames needs 2 kills).
OPS = ("d1", "d2", "flush")
DATA_OPS = tuple(o for o in OPS if o != "flush")
MAX_INFLIGHT = 3
BUDGET_KILLS = 2
BUDGET_DUPS = 1
BUDGET_REORDERS = 1
BUDGET_RESTARTS = 1
BUDGET_RESETS = 2

#: Seeded model mutations -> the invariant each must trip (the
#: "assert the checker can actually see each failure" table).
MUTATIONS = {
    "no-dedup": "exactly-once",
    "trim-overshoot": "journal-trim",
    "ack-overclaim": "flush-order",
    "resume-ignores-epoch": "epoch",
    "no-replay": "quiescence",
    "credit-leak": "credit-conservation",
}

INVARIANTS = ("exactly-once", "journal-trim", "flush-order", "epoch",
              "quiescence", "credit-conservation")

#: §18 flow-control window in abstract units (each data op debits one).
FC_W = 2


@dataclass(frozen=True)
class _State:
    ops_left: tuple = OPS
    tx_seq: int = 0
    journal: tuple = ()          # ((seq, kind), ...) unacked, seq order
    peer_acked: int = 0
    c2s: tuple = ()              # in-flight sequenced frames (seq, kind)
    s2c: tuple = ()              # in-flight ("ack", cum) / ("fack",)
    rx_cum: int = 0
    acked_sent: int = 0
    delivered: tuple = ()        # data kinds, delivery order
    r_fack_owed: bool = False    # receiver's journaled barrier ACK
    flush_state: str = "none"    # none | sent | done | failed
    credits: int = FC_W            # §18 sender window remainder
    suspended: bool = False
    expired: bool = False
    epoch_s: int = 0
    epoch_r: int = 0
    kills: int = BUDGET_KILLS
    dups: int = BUDGET_DUPS
    reorders: int = BUDGET_REORDERS
    restarts: int = BUDGET_RESTARTS
    resets: int = BUDGET_RESETS


def _is_terminal(s: _State) -> bool:
    if s.suspended:
        return False  # resume/expire/restart always enabled
    if s.expired:
        return True   # channels cleared at expiry; ops failed stably
    return (not s.ops_left and not s.c2s and not s.s2c
            and s.flush_state != "sent")


@dataclass
class _Run:
    mutation: Optional[str] = None
    schedules: int = 0
    states: int = 0
    violations: list = field(default_factory=list)  # (invariant, msg, trace)
    _seen_viol: set = field(default_factory=set)

    def violate(self, invariant: str, msg: str, trace: tuple) -> None:
        if invariant not in self._seen_viol:
            self._seen_viol.add(invariant)
            self.violations.append((invariant, msg, trace))


def _gap_reset(s: _State, run: _Run, trace: tuple) -> _State:
    """The receiver saw an unrepairable seq gap: reset the conn.  With
    grace budget left this is a suspend (replay heals it); exhausted,
    the session expires -- the model's grace-window abstraction."""
    if s.resets > 0:
        return replace(s, suspended=True, c2s=(), s2c=(),
                       resets=s.resets - 1)
    return _expire(s)


def _expire(s: _State) -> _State:
    return replace(s, expired=True, suspended=False, c2s=(), s2c=(),
                   ops_left=(),
                   flush_state="failed" if s.flush_state == "sent"
                   else s.flush_state)


def _enabled(s: _State) -> list:
    acts = []
    if s.expired:
        return acts
    if s.suspended:
        acts.append("resume")
        acts.append("expire")
        if s.restarts > 0:
            acts.append("restart")
        return acts
    if s.ops_left and len(s.c2s) < MAX_INFLIGHT:
        # §18 gate: data submits park (are disabled) with the window dry;
        # grants, or the resume-time reset, re-enable them.
        if s.ops_left[0] == "flush" or s.credits > 0:
            acts.append("submit")
    if s.c2s:
        acts.append("deliver")
    if s.s2c:
        acts.append("deliver_ack")
    if s.kills > 0:
        acts.append("kill")
    if s.dups > 0 and s.c2s:
        acts.append("dup")
    if s.reorders > 0 and len(s.c2s) >= 2:
        acts.append("reorder")
    return acts


def _apply(s: _State, act: str, run: _Run, trace: tuple) -> _State:
    mut = run.mutation
    if act == "submit":
        kind = s.ops_left[0]
        seq = s.tx_seq + 1
        return replace(
            s, ops_left=s.ops_left[1:], tx_seq=seq,
            journal=s.journal + ((seq, kind),),
            c2s=s.c2s + ((seq, kind),),
            credits=s.credits - (0 if kind == "flush" else 1),
            flush_state="sent" if kind == "flush" else s.flush_state)
    if act == "deliver":
        (seq, kind), rest = s.c2s[0], s.c2s[1:]
        if seq <= s.rx_cum and mut != "no-dedup":
            # Dup: drained and dropped -- but its (re-)debited window
            # still returns (§18 credit conservation).
            s2c = s.s2c
            if kind != "flush":
                s2c = s2c + (("credit",),)
            return replace(s, c2s=rest, s2c=s2c)
        if seq <= s.rx_cum or seq == s.rx_cum + 1:
            # In-order (or, under no-dedup, a replayed duplicate).
            new_cum = max(s.rx_cum, seq)
            delivered = s.delivered
            fack_owed = s.r_fack_owed
            s2c = s.s2c
            if kind != "flush":
                if kind in delivered:
                    run.violate(
                        "exactly-once",
                        f"data op {kind!r} (seq {seq}) delivered twice",
                        trace + (act,))
                delivered = delivered + (kind,)
                # Matched/drained: the window grant goes back (never
                # inflight-capped -- grants are deltas, dropping one
                # would leak window forever).
                s2c = s2c + (("credit",),)
            else:
                fack_owed = True
                # Journaled barrier ACK: it retries from the receiver's
                # tx queue in the real engine, so the model must never
                # silently drop it (credit entries would otherwise starve
                # its inflight slot forever once kills are exhausted).
                s2c = s2c + (("fack",),)
            if new_cum > s.acked_sent and len(s2c) < MAX_INFLIGHT:
                s2c = s2c + (("ack", new_cum),)
            return replace(s, c2s=rest, rx_cum=new_cum, delivered=delivered,
                           r_fack_owed=fack_owed, s2c=s2c,
                           acked_sent=max(s.acked_sent, new_cum))
        return _gap_reset(replace(s, c2s=rest), run, trace)
    if act == "deliver_ack":
        msg, rest = s.s2c[0], s.s2c[1:]
        if msg[0] == "credit":
            # Clamped at the window: a wire-duplicated grant (the dup
            # fault hitting a credit-bearing schedule) must never mint
            # credit -- the engines clamp identically.
            return replace(s, s2c=rest,
                           credits=min(FC_W, s.credits + 1))
        if msg[0] == "ack":
            cum = msg[1]
            if mut == "trim-overshoot":
                cum += 1
            kept = tuple(e for e in s.journal if e[0] > cum)
            for e in s.journal:
                if e[0] <= cum and e[0] > msg[1]:
                    run.violate(
                        "journal-trim",
                        f"trim for cumulative ACK {msg[1]} dropped "
                        f"unacked frame seq {e[0]} ({e[1]!r})",
                        trace + (act,))
            return replace(s, s2c=rest, journal=kept,
                           peer_acked=max(s.peer_acked, msg[1]))
        # flush ack: the barrier completed -- every data op submitted
        # before the flush must already have been delivered.
        missing = [o for o in DATA_OPS
                   if o not in s.ops_left and o not in s.delivered]
        if s.flush_state == "sent" and missing:
            run.violate(
                "flush-order",
                f"flush barrier completed with data op(s) {missing} "
                "never delivered",
                trace + (act,))
        return replace(s, s2c=rest,
                       flush_state="done" if s.flush_state == "sent"
                       else s.flush_state)
    if act == "kill":
        return replace(s, suspended=True, c2s=(), s2c=(), kills=s.kills - 1)
    if act == "dup":
        # FaultProxy `duplicate`: a sequenced unit rides the wire twice,
        # adjacently -- the replay-overlap shape seq dedup must absorb.
        return replace(s, c2s=(s.c2s[0],) + s.c2s, dups=s.dups - 1)
    if act == "reorder":
        # FaultProxy `reorder`: one adjacent pair swapped; the receiver
        # sees an unrepairable gap and resets (replay heals it).
        return replace(s, c2s=(s.c2s[1], s.c2s[0]) + s.c2s[2:],
                       reorders=s.reorders - 1)
    if act == "resume":
        if s.epoch_s != s.epoch_r:
            if mut == "resume-ignores-epoch":
                run.violate(
                    "epoch",
                    f"session resumed across an epoch change "
                    f"({s.epoch_s} != {s.epoch_r})",
                    trace + (act,))
                # Fall through: the buggy engine resumes anyway (and the
                # wiped receiver state now double-delivers downstream).
            else:
                return _expire(s)
        reported = s.rx_cum
        rx_cum = s.rx_cum
        if mut == "ack-overclaim":
            # The resume handshake claims one frame it never processed.
            reported += 1
            rx_cum += 1
        kept = tuple(e for e in s.journal if e[0] > reported)
        if mut != "ack-overclaim":
            for e in s.journal:
                if e[0] <= reported and e[0] > s.peer_acked \
                        and e[0] > s.rx_cum:
                    run.violate(
                        "journal-trim",
                        f"resume trim dropped frame seq {e[0]} the "
                        "receiver never processed",
                        trace + (act,))
        replay = kept
        if mut == "no-replay":
            replay = ()
        s2c = ()
        if s.r_fack_owed:
            # The receiver's journaled barrier ACK rides the new
            # incarnation (FLUSH_ACK is a sequenced session frame).
            s2c = (("fack",),)
        # §18: fresh window per incarnation -- stale debits and in-flight
        # grants (wiped with s2c at the kill) are healed by resetting to
        # the full window minus the re-debited replay frames.  The
        # credit-leak mutation carries the old remainder across instead,
        # leaking every grant the kill swallowed.
        replay_debit = sum(1 for e in replay if e[1] != "flush")
        credits = (s.credits if mut == "credit-leak"
                   else FC_W - replay_debit)
        return replace(s, suspended=False, journal=kept, c2s=replay,
                       s2c=s2c, rx_cum=rx_cum, acked_sent=rx_cum,
                       credits=credits,
                       peer_acked=max(s.peer_acked, reported))
    if act == "restart":
        # The acceptor process restarted: new epoch, session state gone.
        new_r = s.epoch_r + 1
        if new_r < s.epoch_r:
            run.violate("epoch", "epoch regressed", trace + (act,))
        return replace(s, restarts=s.restarts - 1, epoch_r=new_r,
                       rx_cum=0, acked_sent=0, r_fack_owed=False)
    if act == "expire":
        return _expire(s)
    raise AssertionError(f"unknown action {act}")


def check(mutation: Optional[str] = None, max_states: int = 200_000) -> dict:
    """Exhaust the model under ``mutation`` (None = faithful §14 model).
    Returns ``{"schedules", "states", "violations"}``; ``schedules`` is
    the number of distinct complete fault schedules (root-to-terminal
    action sequences, counted by DP over the memoized state graph)."""
    if mutation is not None and mutation not in MUTATIONS:
        raise ValueError(f"unknown mutation {mutation!r} "
                         f"(choose from {sorted(MUTATIONS)})")
    run = _Run(mutation=mutation)
    paths: dict = {}

    def visit(s: _State, trace: tuple, depth: int) -> int:
        if s in paths:
            return paths[s]
        if depth > 400 or len(paths) > max_states:
            # Far beyond any faithful-model bound: a mutation introduced
            # unbounded behavior -- the no-silent-deadlock oracle owns it.
            run.violate("quiescence",
                        "state space exploded past the model bound "
                        "(runaway replay/reset loop)", trace)
            paths[s] = 0
            return 0
        if _is_terminal(s):
            paths[s] = 1
            return 1
        acts = _enabled(s)
        if not acts:
            run.violate(
                "quiescence",
                "deadlock: ops pending but no action enabled "
                f"(flush_state={s.flush_state!r}, journal={s.journal})",
                trace)
            paths[s] = 0
            return 0
        paths[s] = 0  # cycle guard: a revisit mid-expansion counts 0 paths
        total = 0
        for act in acts:
            total += visit(_apply(s, act, run, trace), trace + (act,),
                           depth + 1)
        paths[s] = total
        return total

    init = _State()
    schedules = visit(init, (), 0)
    # Completeness at clean quiescence: every terminal non-expired state
    # must have delivered each data op exactly once and completed the
    # flush -- a lost frame that deadlocks nothing still fails here.
    for s in list(paths):
        if _is_terminal(s) and not s.expired:
            if tuple(sorted(s.delivered)) != tuple(sorted(DATA_OPS)):
                run.violate(
                    "exactly-once",
                    f"clean quiescence with delivered={s.delivered!r} "
                    f"(want each of {DATA_OPS} exactly once)", ())
            if s.flush_state != "done":
                run.violate(
                    "quiescence",
                    "clean quiescence with the flush barrier never "
                    "completed", ())
            if s.credits != FC_W:
                run.violate(
                    "credit-conservation",
                    f"clean quiescence with credits={s.credits} -- the "
                    f"§18 window ({FC_W}) was permanently lost across "
                    "the schedule", ())
    return {"schedules": schedules, "states": len(paths),
            "violations": run.violations}


#: Session transitions the model abstracts; their disappearance from the
#: extracted machine means the model no longer describes the code.
_REQUIRED_TRANSITIONS = (
    ("estab", "SEQ"), ("estab", "ACK"), ("estab", "lost"),
    ("suspended", "resume"), ("suspended", "expire"),
)


def run(root: Path) -> list:
    out: list = []
    machine, extract_findings = protomodel.extract_py_machine(root)
    # Extraction failures are protomodel's findings; here they only gate
    # vacuity (don't double-report).
    missing = [key for key in _REQUIRED_TRANSITIONS
               if key not in machine.transitions]
    if missing and not extract_findings:
        out.append(Finding(
            "starway_tpu_torch/core/session.py", 1, "proto-explore",
            f"the session model's transitions {missing} are no longer "
            "extracted from the engine -- the model checker would verify "
            "a machine the code does not implement (update the model or "
            "the extraction grammar, DESIGN.md §16)"))
        return out
    result = check(None)
    for invariant, msg, trace in result["violations"]:
        out.append(Finding(
            "starway_tpu_torch/core/session.py", 1, "proto-explore",
            f"invariant `{invariant}` violated: {msg} "
            f"[schedule: {' -> '.join(trace) or '<initial>'}]"))
    if result["schedules"] < 1000:
        out.append(Finding(
            "starway_tpu_torch/core/session.py", 1, "proto-explore",
            f"only {result['schedules']} fault schedules enumerated -- "
            "the bounded exploration lost coverage (model bounds "
            "shrunk?)"))
    return out
