"""The port's analysis gate, wire decoders and integrity: twins of
tests/test_swcheck.py.

wirefuzz diffs the contract-derived grammar oracle, the port's
``core/frames.py`` / ``core/shmring.py`` decoders and the ``sw_wire_decode``
export of the port's engine, built from the tree's own copy
(``build/starway_tpu_torch/_sw_native.so``, never the JAX package's
artifact), on identical bytes; taint checks that every rx delivery sink
of both engines is dominated by the CRC verify.  Each seeded case applies
the JAX package's mutation to the port's tree and the JAX package's and
asserts that both gates fire the same rule (tests/torch_swcheck_util.py).
The JAX package's seeded tree has no engine build, so only the port's
gate runs the native leg on a seeded tree.
"""

from __future__ import annotations

import pytest

from starway_tpu_torch import native_build
from torch_swcheck_util import REPO, SWA, Twin


def test_wirefuzz_head_replays_corpus_clean_with_native():
    # The acceptance bar: the checked-in corpus (>= the 100-case floor)
    # plus the quick-mode generator replays with zero divergence across
    # the oracle, frames.decode_stream/decode_sm_records, AND the native
    # sw_wire_decode export (the built artifact must be present here).
    from starway_tpu_torch.analysis import wirefuzz

    out: list = []
    got = wirefuzz._extract_tables(REPO, out)
    assert got is not None and out == [], [f.render() for f in out]
    counts = wirefuzz.fuzz(REPO, got[0], out,
                           seeds_per_mode=wirefuzz.QUICK_SEEDS)
    assert out == [], [f.render() for f in out]
    assert counts["native"], "native sw_wire_decode export not loaded"
    # ... the port's own build of its engine copy, never the JAX package's.
    assert str(native_build.artifact(REPO)) in wirefuzz._NATIVE_CACHE
    assert counts["divergences"] == 0
    assert counts["cases"] >= (wirefuzz.CORPUS_FLOOR
                               + 3 * wirefuzz.QUICK_SEEDS), counts


def test_wirefuzz_fixed_divergence_seed_pinned():
    # The zero-length ctl body was a REAL cross-engine divergence (C++
    # silently dropped the frame; the Python parser issued a 0-byte read
    # -- conn death on TCP, a permanent stall on sm rings).  Both
    # engines now reject it identically; the corpus pins the bytes.
    from starway_tpu_torch.analysis import wirefuzz
    from starway_tpu_torch.core import frames

    zero_ctl = bytes.fromhex("0100000000000000000000000000000000")
    want = "reject(zero control body) n=0 []"
    assert frames.decode_stream(zero_ctl) == want
    lib = wirefuzz._load_native(REPO)
    assert lib is not None, "native decode harness missing"
    assert wirefuzz._native_decode(lib, zero_ctl, "stream") == want
    corpus = (REPO / "starway_tpu_torch" / "analysis"
              / "wirefuzz_corpus.txt").read_text()
    assert zero_ctl.hex() in corpus, "divergent seed not pinned in corpus"


def test_wirefuzz_python_decoder_divergence_seeded(tmp_path):
    # Mutate the reference decoder's ctl-body rule: the oracle (derived
    # from the contract tables, not the decoder) catches the divergence
    # on the pinned corpus bytes.
    root = Twin(tmp_path)
    root.edit("pkg/core/frames.py",
              '            if b == 0:\n'
              '                return done("reject(zero control body)")',
              '            if b == 0 and False:\n'
              '                return done("reject(zero control body)")')
    root.caught("wire-diff", "Python decoder diverges", "frames.py")


def test_wirefuzz_smrec_divergence_seeded(tmp_path):
    # Mutate the slot-record decoder's seqno seed: every valid record
    # now rejects, diverging from the oracle in mode smrec.
    root = Twin(tmp_path)
    root.edit("pkg/core/shmring.py",
              "frames.crc32c(_SEQ8.pack(seq))",
              "frames.crc32c(_SEQ8.pack(seq + 1))")
    root.caught("wire-diff", "diverges", "shmring.py")


def test_wirefuzz_native_table_drift_seeded(tmp_path):
    # The static leg: kCsumExempt[] losing a member diffs against
    # frames.CSUM_EXEMPT without running a single byte.
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "constexpr uint8_t kCsumExempt[] = {T_HELLO, T_HELLO_ACK, T_SEQ};",
              "constexpr uint8_t kCsumExempt[] = {T_HELLO, T_HELLO_ACK};")
    root.caught("wire-diff", "kCsumExempt", "frames.py")


def test_wirefuzz_ctl_bound_drift_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "constexpr uint64_t CTL_MAX = 1ull << 20;",
              "constexpr uint64_t CTL_MAX = 1ull << 21;")
    root.caught("wire-diff", "ctl-body bound", "frames.py")


def test_wirefuzz_smrec_ring_bound_drift_seeded(tmp_path):
    # The smrec record-length bound is pinned statically like CTL_MAX:
    # the oracle follows the tree's shmring.DEFAULT_RING, the native
    # harness hardcodes its twin, and a drift is a finding even with no
    # built artifact to fuzz (the corpus boundary cases fire it
    # dynamically too).
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "const uint64_t ring_size = 1ull << 20;",
              "const uint64_t ring_size = 1ull << 21;")
    root.caught("wire-diff", "record-length bound", "shmring.py")


def test_wirefuzz_private_parser_table_seeded(tmp_path):
    # The live parser growing a private decode table (instead of
    # aliasing frames.CSUM_EXEMPT) is the drift the fuzzer cannot see
    # dynamically -- the alias check catches it statically.
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "_CSUM_EXEMPT = frames.CSUM_EXEMPT",
              "_CSUM_EXEMPT = frozenset((frames.T_HELLO, frames.T_HELLO_ACK,"
              " frames.T_SEQ))")
    root.caught("wire-diff", "no longer aliases", "conn.py")


def test_wirefuzz_corpus_floor_and_malformed_lines(tmp_path):
    # A truncated or garbled corpus is itself a finding, never a silent
    # skip (the seeded tree's own corpus shadows the checked-in one).
    root = Twin(tmp_path)
    root.write("pkg/analysis/wirefuzz_corpus.txt",
               "# truncated corpus\n"
               "seed stream 1\n"
               "bogus stream 2\n"
               "hex stream zz\n")
    root.caught("wire-diff", "below the", "wirefuzz_corpus.txt")
    root.caught("wire-diff", "malformed corpus",
                "wirefuzz_corpus.txt")


def test_wirefuzz_waiver(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "constexpr uint8_t kCsumExempt[] = {T_HELLO, T_HELLO_ACK, T_SEQ};",
              "constexpr uint8_t kCsumExempt[] = {T_HELLO, T_HELLO_ACK};")
    root.edit("pkg/core/frames.py",
              "CSUM_EXEMPT = frozenset((T_HELLO, T_HELLO_ACK, T_SEQ))",
              f"{SWA}(wire-diff): exercising the waiver path\n"
              "CSUM_EXEMPT = frozenset((T_HELLO, T_HELLO_ACK, T_SEQ))")
    # The port's gate also runs the mutated engine (rebuilt from the
    # seeded source), whose decoder now diverges on the corpus: that
    # finding anchors at the engine source's first line and takes its
    # own waiver there.  The JAX package's seeded tree has no build.
    hits = root.findings("wire-diff", parity=False)
    assert hits and {(f.file, f.line) for f in hits} == {
        ("starway_tpu_torch/native/sw_engine.cpp", 1)}, hits
    root.modify("native/sw_engine.cpp",
                lambda t: f"// {SWA[2:]}(wire-diff): exercising the waiver "
                "path\n" + t)
    assert root.findings("wire-diff") == []
    assert root.findings("bad-waiver") == []


@pytest.mark.slow
def test_wirefuzz_long_soak():
    # The nightly CI leg's in-repo twin: a deep generator run over all
    # three modes with zero divergence (quick mode covers the gate).
    from starway_tpu_torch.analysis import wirefuzz

    out: list = []
    got = wirefuzz._extract_tables(REPO, out)
    assert got is not None and out == [], [f.render() for f in out]
    counts = wirefuzz.fuzz(REPO, got[0], out, seeds_per_mode=20000)
    assert out == [], [f.render() for f in out]
    assert counts["cases"] >= 60000, counts


def test_taint_dropped_accumulation_seeded(tmp_path):
    # Remove the guarded CRC accumulation on the eager-body read: the
    # eventual verify goes blind to those bytes.
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "                if self._csum_pend is not None:\n"
              "                    self._csum_accum = frames.crc32c(target[:n],\n"
              "                                                     self._csum_accum)\n"
              "                m.received += n",
              "                m.received += n")
    root.caught("taint-integrity", "CRC accumulator", "conn.py")


def test_taint_softened_gate_seeded(tmp_path):
    # Soften the pre-completion mismatch arm from poison to a counter
    # bump: corrupt bytes would complete the receive.
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              '                        if self._csum_accum != pend[0]:\n'
              '                            self._corrupt(fires, "payload checksum (DATA)")\n'
              '                            return',
              '                        if self._csum_accum != pend[0]:\n'
              '                            self._ctr.csum_fail += 1')
    root.caught("taint-integrity", "does not abort", "conn.py")


def test_taint_sm_poison_dropped_seeded(tmp_path):
    # The SmCorrupt handler must surface the stable "corrupt" poison;
    # dropping the poison_reason assignment degrades it to a generic
    # conn break (or worse).
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "                self.poison_reason = REASON_CORRUPT\n"
              "                if self.sess is None or self.sess.expired:",
              "                if self.sess is None or self.sess.expired:")
    root.caught("taint-integrity", "SmCorrupt", "conn.py")


def test_taint_shmring_raise_dropped_seeded(tmp_path):
    # Ring.read_into silently tolerating a checksum mismatch means torn
    # ring bytes parse as frames.
    root = Twin(tmp_path)
    root.edit("pkg/core/shmring.py",
              'raise SmCorrupt("sm slot record checksum mismatch "',
              'raise OSError("sm slot record checksum mismatch "')
    root.edit("pkg/core/shmring.py",
              'raise SmCorrupt("sm slot record header corrupt "',
              'raise OSError("sm slot record header corrupt "')
    root.caught("taint-integrity", "read_into", "shmring.py")


def test_taint_cpp_sm_poison_dropped_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              'conn_corrupt(c, "sm slot record", fires);',
              'bump(counters.csum_fail);')
    root.caught("taint-integrity", "sm slot record",
              "sw_engine.cpp")


def test_taint_cpp_dropped_accumulation_seeded(tmp_path):
    # Remove the striped-chunk payload accumulation in the native rx
    # arm: the chunk-level verify goes blind (first occurrence of this
    # exact statement is the rx_stripe arm).
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "c->csum_accum = crc32c(target, (size_t)r, c->csum_accum);",
              ";")
    root.caught("taint-integrity", "CRC accumulator",
              "sw_engine.cpp")


def test_taint_refuses_vacuity_when_pump_renamed(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "def _pump_frames(self, fires: list) -> None:",
              "def _pump_frames_gone(self, fires: list) -> None:")
    root.caught("taint-integrity", "_pump_frames not found",
              "conn.py")


def test_taint_waiver(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "                self.poison_reason = REASON_CORRUPT\n"
              "                if self.sess is None or self.sess.expired:",
              "                if self.sess is None or self.sess.expired:")
    root.edit("pkg/core/conn.py",
              "    def _rx_read(self, target) -> int:",
              f"    {SWA}(taint-integrity): exercising the waiver path\n"
              "    def _rx_read(self, target) -> int:")
    assert root.findings("taint-integrity") == []
    assert root.findings("bad-waiver") == []
