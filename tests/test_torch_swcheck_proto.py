"""The port's analysis gate, protocol models: twins of tests/test_swcheck.py.

protomodel (the two engines' state machines diffed transition by
transition), explore (the session model under fault schedules), compose
(the composed-plane product model) and refine (the monitor compiled from
the engines' machines, its event corpus and transition coverage), run on
the port's engines.  Each seeded case applies the JAX package's mutation
to the port's tree and the JAX package's and asserts that both gates fire
the same rule (tests/torch_swcheck_util.py); each model mutation fires the
same invariants in the port's model as in the JAX package's.
"""

from __future__ import annotations

import re

import pytest

from starway_tpu.analysis import compose as jax_compose
from starway_tpu.analysis import explore as jax_explore
from starway_tpu_torch import analysis as port_analysis
from torch_swcheck_util import REPO, SWA, Twin


def test_state_annotation_value_drift(tmp_path):
    # The native arm claims a different outcome than the Python dispatch:
    # the transition-by-transition diff must name the disagreeing pair.
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "// swcheck: state(estab, ACK, estab)",
              "// swcheck: state(estab, ACK, down)")
    hits = root.findings("proto-state")
    assert any("(estab, ACK)" in f.message and "disagree" in f.message
               for f in hits), hits
    root.caught("proto-state", "(estab, ACK)", "conn.py")


def test_state_annotation_missing(tmp_path):
    # Deleting a dispatch annotation = the native engine no longer claims
    # the arm: anchored at the Python side of the pair.
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "// swcheck: state(estab, BYE, estab|expired)\n", "")
    root.caught("proto-state", "(estab, BYE)", "conn.py")


def test_state_python_arm_drift(tmp_path):
    # Renaming a Python dispatch arm fires BOTH ways: the new arm has no
    # annotation, the old annotation has no counterpart.
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "elif ftype == frames.T_BYE:", "elif ftype == frames.T_BYEX:")
    hits = root.findings("proto-state")
    assert any("(estab, BYEX)" in f.message for f in hits), hits
    assert any("(estab, BYE)" in f.message and "no counterpart" in f.message
               for f in hits), hits
    root.caught("proto-state", "(estab, BYE)", "sw_engine.cpp")


def test_state_extraction_vacuity(tmp_path):
    # Stripping every annotation must be a finding, never a vacuous pass
    # (empty extraction is a finding -- the acceptance bar).
    root = Twin(tmp_path)
    root.modify("native/sw_engine.cpp", lambda t: re.sub(r"// swcheck: state\([^)]*\)\n", "", t))
    root.caught("proto-state", "no `swcheck: state(...)` annotations",
                "sw_engine.cpp")


def test_state_unknown_token(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "// swcheck: state(estab, PING, estab)",
              "// swcheck: state(estab, PINGG, estab)")
    hits = root.findings("proto-state")
    assert any("unknown token" in f.message and "PINGG" in f.message
               for f in hits), hits


def test_state_waiver(tmp_path):
    # proto-state findings ride the standard waiver policy at their
    # anchor line (here: the Python arm the native side stopped claiming).
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "// swcheck: state(estab, BYE, estab|expired)\n", "")
    root.edit("pkg/core/conn.py",
              "            elif ftype == frames.T_BYE:",
              f"            {SWA}(proto-state): exercising the waiver path\n"
              "            elif ftype == frames.T_BYE:")
    assert root.findings("proto-state") == []
    assert root.findings("bad-waiver") == []


def test_sdata_dispatch_annotation_drift(tmp_path):
    # Re-routing the native SDATA arm's annotated outcome must diff
    # against the Python engine's extracted transition (proto-state).
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "// swcheck: state(estab, SDATA, estab|down)",
              "// swcheck: state(estab, SDATA, estab)")
    root.caught("proto-state", "SDATA", "conn.py")


def test_credit_state_annotation_drift(tmp_path):
    # Re-routing the native CREDIT arm's annotated outcome must diff
    # against the Python engine's extracted transition (the
    # `state(estab, CREDIT, estab)` requirement).
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "// swcheck: state(estab, CREDIT, estab)",
              "// swcheck: state(estab, CREDIT, estab|down)")
    root.caught("proto-state", "CREDIT", "conn.py")


def test_csum_state_annotation_drift(tmp_path):
    # The CSUM gate can tear the conn down (nested/missing checksum):
    # the native annotation claiming estab-only must diff against the
    # Python extraction.
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "// swcheck: state(estab, CSUM, estab|down)",
              "// swcheck: state(estab, CSUM, estab)")
    root.caught("proto-state", "CSUM", "conn.py")


def test_snack_state_annotation_missing(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "// swcheck: state(estab, SNACK, estab)\n", "")
    root.caught("proto-state", "(estab, SNACK)", "conn.py")


def test_explore_head_clean_and_schedule_floor():
    # The faithful §14 model must exhaust clean, and the enumeration must
    # cover >= 1k distinct fault schedules (the acceptance floor).
    from starway_tpu_torch.analysis import explore

    result = explore.check(None)
    assert result["violations"] == [], result["violations"]
    assert result["schedules"] >= 1000, result["schedules"]
    assert result["states"] > 100


def test_explore_every_invariant_fires_under_its_mutation():
    # Every invariant is backed by a seeded model mutation that makes it
    # fire -- otherwise the checker could never see the failure it
    # claims to rule out.
    from starway_tpu_torch.analysis import explore

    assert set(explore.MUTATIONS.values()) == set(explore.INVARIANTS)
    assert explore.MUTATIONS == jax_explore.MUTATIONS
    for mutation, invariant in explore.MUTATIONS.items():
        result = explore.check(mutation)
        fired = {v[0] for v in result["violations"]}
        assert invariant in fired, (mutation, invariant, fired)
        # The JAX package's model fires the same invariants.
        ref = jax_explore.check(mutation)
        assert fired == {v[0] for v in ref["violations"]}, mutation


def test_explore_refuses_vacuity_when_machine_drifts(tmp_path):
    # If extraction loses the session transitions the model abstracts,
    # explore must flag the desync instead of checking a machine the
    # code no longer implements.
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "elif ftype == frames.T_SEQ:", "elif ftype == frames.T_SEQX:")
    root.caught("proto-explore", "no longer extracted", "session.py")


def test_explore_waiver(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "elif ftype == frames.T_SEQ:", "elif ftype == frames.T_SEQX:")
    root.modify("pkg/core/session.py", lambda t: f"{SWA}(proto-explore): exercising the waiver path\n"
                 + t)
    assert root.findings("proto-explore") == []


def test_explore_credit_conservation_mutation():
    # The §18 credit-conservation invariant is backed by its seeded
    # mutation: a resume carrying stale credits across the incarnation
    # must make exactly it fire (the kill swallowed in-flight grants).
    from starway_tpu_torch.analysis import explore

    clean = explore.check(None)
    assert not any(v[0] == "credit-conservation"
                   for v in clean["violations"]), clean["violations"]
    leaked = explore.check("credit-leak")
    fired = {v[0] for v in leaked["violations"]}
    assert "credit-conservation" in fired, fired
    ref = jax_explore.check("credit-leak")
    assert fired == {v[0] for v in ref["violations"]}


def test_swcompose_rules_registered():
    # Satellite: the three new finding codes are waiver targets
    # (--rules) and render as problem-matcher rows like every pass.
    for rule in ("proto-compose", "wire-diff", "taint-integrity"):
        assert rule in port_analysis.RULES, rule


def test_compose_head_clean_and_schedule_floor():
    # The faithful composed model (sessions x striping x fc x integrity)
    # must exhaust clean, over a product space comfortably past the
    # single-plane explore floor.
    from starway_tpu_torch.analysis import compose

    result = compose.check(None)
    assert result["violations"] == [], result["violations"]
    assert result["schedules"] >= 2000, result["schedules"]
    assert result["states"] > 1000, result["states"]


def test_compose_every_invariant_fires_under_its_mutation():
    # Repo convention: every invariant is backed by a seeded model
    # mutation that makes the checker fail -- otherwise it could never
    # see the failure class it claims to rule out.
    from starway_tpu_torch.analysis import compose

    assert set(compose.MUTATIONS.values()) == set(compose.INVARIANTS)
    assert compose.MUTATIONS == jax_compose.MUTATIONS
    for mutation, invariant in compose.MUTATIONS.items():
        result = compose.check(mutation)
        fired = {v[0] for v in result["violations"]}
        assert invariant in fired, (mutation, invariant, fired)
        # The JAX package's model fires the same invariants.
        ref = jax_compose.check(mutation)
        assert fired == {v[0] for v in ref["violations"]}, mutation


def test_compose_unknown_mutation_rejected():
    from starway_tpu_torch.analysis import compose

    with pytest.raises(ValueError):
        compose.check("no-such-mutation")


def test_compose_refuses_vacuity_when_machine_drifts(tmp_path):
    # If extraction loses the striping dispatch arm the product model
    # abstracts, compose must flag the desync instead of verifying
    # planes the code no longer implements.
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "elif ftype == frames.T_SDATA:", "elif ftype == frames.T_SDATAX:")
    root.caught("proto-compose", "no longer extracted", "lane.py")


def test_compose_waiver(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "elif ftype == frames.T_SDATA:", "elif ftype == frames.T_SDATAX:")
    root.modify("pkg/core/lane.py", lambda t: f"{SWA}(proto-compose): exercising the waiver path\n"
                 + t)
    assert root.findings("proto-compose") == []


def test_refine_rules_registered():
    assert "refine" in port_analysis.RULES
    assert "monitor-coverage" in port_analysis.RULES
    from starway_tpu_torch.analysis import PASSES

    assert "refine" in PASSES


def test_refine_head_clean_with_real_corpus():
    # The acceptance bar: monitor compiles from HEAD's machines, the
    # checked-in corpus (>= the floor) replays clean, every model
    # transition is witnessed or waived, and every divergence class is
    # pinned.
    from starway_tpu_torch.analysis import refine

    assert port_analysis.run_all(REPO, ["refine"]) == []
    mon, problems = refine.compile_monitor(REPO)
    assert mon is not None and not problems
    assert len(mon.transitions) >= 20, sorted(mon.transitions)
    sink: list = []
    cases = refine.load_corpus(sink, REPO)
    assert sink == [] and len(cases) >= refine.CORPUS_FLOOR


async def _refine_floor_scenario(port):
    """Quick live scenario whose rings must witness COVERAGE_FLOOR: a
    session pair exchanging bursts through a FaultProxy with one
    mid-burst kill (suspend -> resume) -- the same shape as the chaos
    soaks, bounded for the gate."""
    import asyncio

    import numpy as np

    from starway_tpu_torch import Client, Server
    from starway_tpu_torch.testing.faults import FaultProxy

    server = Server()
    server.listen("127.0.0.1", port)
    proxy = FaultProxy("127.0.0.1", port).start()
    client = Client()
    await client.aconnect("127.0.0.1", proxy.port)
    try:
        for cycle in range(2):
            tag0 = cycle * 100
            bufs = [np.zeros(256, dtype=np.uint8) for _ in range(5)]
            recvs = [server.arecv(bufs[i], tag0 + i, (1 << 64) - 1)
                     for i in range(5)]
            sends = [client.asend(
                np.full(256, (tag0 + i) % 251, dtype=np.uint8), tag0 + i)
                for i in range(5)]
            if cycle == 1:
                await asyncio.sleep(0.2)
                proxy.kill_all(rst=True)
            await asyncio.wait_for(asyncio.gather(*sends), 30)
            await asyncio.wait_for(client.aflush(), 30)
            await asyncio.wait_for(asyncio.gather(*recvs), 30)
    finally:
        await client.aclose()
        await server.aclose()
        proxy.stop()


@pytest.mark.parametrize("engine", ["python", "native"])
async def test_refine_live_transition_coverage_floor(port, monkeypatch,
                                                     engine):
    """The LIVE transition-coverage floor: quick scenarios on
    EACH engine must witness refine.COVERAGE_FLOOR through real rings --
    the corpus proves the monitor can see every arm, this proves the
    engine taps actually fire.  Failures name the unwitnessed
    transitions."""
    from starway_tpu_torch.analysis import refine
    from starway_tpu_torch.core import native, swtrace

    if engine == "native" and not native.available():
        pytest.skip("native engine not built")
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "1" if engine == "native" else "0")
    monkeypatch.setenv("STARWAY_PROTO_TRACE", "1")
    monkeypatch.setenv("STARWAY_SESSION", "1")
    monkeypatch.delenv("STARWAY_TRACE", raising=False)
    swtrace.reset()
    await _refine_floor_scenario(port)
    mon, problems = refine.compile_monitor(REPO)
    assert mon is not None, problems
    witnessed: set = set()
    for dump in swtrace.dump_all():
        viols, seen = mon.replay(dump["events"], label=dump["worker"])
        assert viols == [], [v.render() for v in viols]
        witnessed |= seen
    missing = [t for t in refine.COVERAGE_FLOOR if t not in witnessed]
    assert not missing, (
        f"{engine} engine never witnessed model transition(s) {missing} "
        f"(witnessed: {sorted(witnessed)})")


def test_refine_frame_name_drift_python_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/frames.py",
              '    T_SACK: "SACK",', '    T_SACK: "SACKZ",')
    root.caught("refine", "canonical event name", "frames.py")


def test_refine_frame_name_drift_cpp_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              'case T_SACK: return "SACK";', 'case T_SACK: return "WRONG";')
    root.caught("refine", "disagree on T_SACK", "frames.py")


def test_refine_native_table_gone_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "const char* proto_frame_name(uint8_t t) {",
              "const char* frame_name_x(uint8_t t) {")
    root.caught("refine", "proto_frame_name() not found",
                "sw_engine.cpp")


def test_refine_python_taps_gone_seeded(tmp_path):
    # An engine that loses its EV_PROTO taps makes every replay
    # vacuously green -- that is a finding, not a pass.
    root = Twin(tmp_path)
    root.modify("pkg/core/conn.py",
                lambda t: t.replace("swtrace.EV_PROTO", "swtrace.EV_CONN_UP"))
    root.caught("refine", "taps are gone", "conn.py")


def test_refine_engine_transition_mutation_turns_gate_red(tmp_path):
    """The refinement gap itself: remove one dispatch arm from
    BOTH engines consistently -- protomodel stays green (the machines
    still agree), but the pinned event history replays red: the model no
    longer matches the histories real engines produced."""
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "elif ftype == frames.T_BYE:", "elif ftype == 0xEE:")
    root.edit("native/sw_engine.cpp",
              "        // swcheck: state(estab, BYE, estab|expired)\n", "")
    assert root.findings("proto-state") == []  # still two equal machines
    root.caught("refine", "session-bye-then-eof", "refine_corpus.txt")


def test_refine_corpus_floor_and_malformed_lines(tmp_path):
    # A truncated or garbled corpus is itself a finding, never a silent
    # skip (the seeded tree's own corpus shadows the checked-in one).
    root = Twin(tmp_path)
    root.write("pkg/analysis/refine_corpus.txt",
               "# truncated corpus\n"
               "only-case | ok | st:estab rx:HELLO\n"
               "garbled line without pipes\n"
               "bad-expect | violation:made-up | st:estab\n")
    root.caught("refine", "below the", "refine_corpus.txt")
    root.caught("refine", "malformed corpus", "refine_corpus.txt")
    root.caught("refine", "not `ok` or a known violation class",
                "refine_corpus.txt")


def test_refine_expectation_flip_seeded(tmp_path):
    # A pinned-ok history that starts violating (or vice versa) is the
    # core regression signal: model and history must move together.
    root = Twin(tmp_path)
    real = (REPO / "starway_tpu_torch" / "analysis" / "refine_corpus.txt").read_text()
    root.write("pkg/analysis/refine_corpus.txt", real.replace(
               "viol-resume-from-estab | violation:no-transition |",
               "viol-resume-from-estab | ok |", 1))
    root.caught("refine", "viol-resume-from-estab",
                "refine_corpus.txt")


def test_refine_unwitnessed_transition_seeded(tmp_path):
    # monitor-coverage: drop the corpus cases that witness (estab, SNACK)
    # (padding to stay above the floor) -- the unwitnessed transition
    # must be named.
    root = Twin(tmp_path)
    real = (REPO / "starway_tpu_torch" / "analysis" / "refine_corpus.txt").read_text()
    kept = [ln for ln in real.splitlines()
            if "rx:SNACK" not in ln]
    kept += [f"pad-{i} | ok | st:estab rx:HELLO rx:DATA down"
             for i in range(4)]
    root.write("pkg/analysis/refine_corpus.txt", "\n".join(kept) + "\n")
    root.caught("monitor-coverage", "(estab, SNACK)",
                "refine_corpus.txt")


def test_refine_coverage_waiver(tmp_path):
    # The shadow corpus's own line-1 waiver suppresses the coverage
    # finding -- the new rules are ordinary --rules waiver targets.
    root = Twin(tmp_path)
    real = (REPO / "starway_tpu_torch" / "analysis" / "refine_corpus.txt").read_text()
    kept = [ln for ln in real.splitlines() if "rx:SNACK" not in ln]
    kept += [f"pad-{i} | ok | st:estab rx:HELLO rx:DATA down"
             for i in range(4)]
    root.write("pkg/analysis/refine_corpus.txt",
               f"{SWA}(monitor-coverage): exercising the waiver path\n"
        + "\n".join(kept) + "\n")
    assert root.findings("monitor-coverage") == []
    assert root.findings("bad-waiver") == []
