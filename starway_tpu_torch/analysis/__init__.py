"""swcheck + swproof + swcompose: static cross-engine contract checking.

``python -m starway_tpu_torch.analysis`` runs twelve passes and exits non-zero
on any finding (the CI merge gate; also step 1 of
scripts/release_smoke.sh):

* **contract** -- diffs the wire/shm/ABI/reason/handshake contract between
  ``core/engine.py``-side sources and the engine copy,
  ``starway_tpu_torch/native/sw_engine.{h,cpp}``
  ("two engines, one contract", CLAUDE.md).
* **concurrency** -- callbacks never fire under a worker lock (direct or
  *reachable* through the call graph); no blocking calls on the engine
  thread or reachable under a lock; lock-order cycle detection spanning
  the Python locks and the native mutex sites; the TX-item duck-type
  attribute contract; lint-surface coverage audit (DESIGN.md §2, §16).
* **layering** -- no torch (and no jax) imports under core/.
* **markers** -- multi-GiB test payloads must carry @pytest.mark.slow.
* **hotpath** -- no full-payload ``bytes(...)``/``.tobytes()`` copies on
  core/ data paths (the zero-copy discipline, DESIGN.md §12).
* **protomodel** -- extracts the protocol state machine from BOTH engines
  (ast over the Python dispatch; ``swcheck: state(...)`` annotations in
  the native engine) and diffs them transition-by-transition
  (DESIGN.md §16).
* **explore** -- bounded exhaustive model checking of the §14 session
  layer: every fault schedule (kill/dup/reorder/restart) over a bounded
  workload, against the exactly-once / journal-trim / flush-order /
  epoch / quiescence invariants.
* **compose** -- the swcompose product model (DESIGN.md §21): sessions
  x striped chunks x credit window x integrity retransmit explored
  under conn kills, rail deaths, corruption, and duplication, against
  the stripe-exactly-once / pin-release / credit-conservation /
  no-wrong-answer / quiescence invariants.
* **wirefuzz** -- a contract-derived differential fuzzer for the frame
  and sm-slot-record decoders: identical adversarial bytes through a
  grammar oracle, ``frames.decode_stream`` / ``decode_sm_records``, and
  the native ``sw_wire_decode`` export; a checked-in regression corpus
  replays every run (DESIGN.md §21).
* **taint** -- the §19 unverified-byte lint: every rx delivery sink in
  BOTH engines is dominated by a CRC verify whose mismatch arm aborts,
  every payload read accumulates, and sm slot corruption poisons
  before parse (DESIGN.md §21).
* **refine** -- swrefine model<->code conformance (DESIGN.md §22): the
  canonical protocol-event vocabulary diffed across both engines, the
  checked-in event corpus replayed through the monitor automaton
  compiled from the engines' own extracted state machines, and
  transition coverage (every model arm witnessed by a pinned run or a
  justified waiver).  ``refine --replay <dump>`` replays any swtrace
  ring/flight dump through the same monitor.
* **cost** -- swcost hot-path cost certification (DESIGN.md §23): a
  per-contract-path ``{syscalls, copies, allocs, locks}`` site vector
  extracted from BOTH engines and ratcheted against the checked-in
  ``analysis/cost_budgets.txt`` ledger (over OR under a pin is a
  finding), plus liveness of the ``io_syscalls``/``hot_copies``
  runtime twin the tests/test_cost.py conformance check rides on.
  ``cost --write-budgets`` re-pins the ledger from head.

Waivers: a finding is suppressed by an explicit justified comment on (or
directly above) the flagged line::

    # swcheck: allow(blocking-call): bench harness runs off-engine

A waiver without the ``: why`` justification, or naming an unknown rule,
is itself a finding (``bad-waiver``).  See DESIGN.md §11 and §16.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterable, Optional

from . import (compose, concurrency, contract, cost, explore, hotpath,
               layering, markers, protomodel, refine, taint, wirefuzz)
from .base import (  # noqa: F401  (re-exported for tests and tooling)
    RULES,
    Finding,
    apply_waivers,
    clear_caches,
    core_py_files,
    find_root,
    lint_py_files,
    scan_bad_waivers,
    test_files,
    waiver_audit_files,
)

PASSES = {
    "contract": contract.run,
    "concurrency": concurrency.run,
    "layering": layering.run,
    "markers": markers.run,
    "hotpath": hotpath.run,
    "protomodel": protomodel.run,
    "explore": explore.run,
    "compose": compose.run,
    "wirefuzz": wirefuzz.run,
    "taint": taint.run,
    "refine": refine.run,
    "cost": cost.run,
}


def run_all(root: Optional[str] = None,
            passes: Optional[Iterable[str]] = None,
            timings: Optional[dict] = None) -> list:
    """Run the selected passes (default: all) against ``root`` and return
    the post-waiver findings, sorted by location.  ``timings``, when a
    dict, receives per-pass wall seconds (the --timings CLI surface)."""
    rootp = find_root(root) if not isinstance(root, Path) else root
    clear_caches()  # parse-once per gate run; files may change between runs
    selected = list(passes) if passes else list(PASSES)
    findings: list = []
    for name in selected:
        t0 = time.perf_counter()
        findings.extend(PASSES[name](rootp))
        if timings is not None:
            timings[name] = time.perf_counter() - t0
    findings = apply_waivers(rootp, findings)
    findings.extend(scan_bad_waivers(rootp, waiver_audit_files(rootp)))
    seen = set()
    unique = []
    for f in sorted(findings, key=lambda f: (f.file, f.line, f.rule, f.message)):
        key = (f.file, f.line, f.rule, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique
