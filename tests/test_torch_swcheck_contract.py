"""The port's analysis gate, contract rules: twins of tests/test_swcheck.py.

Each case applies one of the JAX package's mutations of the two-engine
contract (frame constants, shm layout, ABI, reasons, handshake keys, the
engine version, the frames.py doc table, the swtrace/telemetry/swpulse
vocabularies) to a seeded copy of the port's tree and of the JAX
package's, and asserts that the port's gate (``python -m
starway_tpu_torch.analysis``) fires the rule at a real ``file:line`` of
the port's engines and that the JAX package's gate fires the same rule on
its own tree (tests/torch_swcheck_util.py).  Only the ``contract`` pass
runs.  Drift-prone fixtures read the engine's own version rather than a
literal.
"""

from __future__ import annotations

import re

from torch_swcheck_util import JAX, Twin, engine_version


def test_bumped_frame_constant(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/frames.py", "T_DATA = 3", "T_DATA = 9")
    root.caught("contract-frames", "T_DATA", "frames.py")


def test_changed_shm_offset(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/shmring.py", "OFF_HEAD = 64", "OFF_HEAD = 128")
    root.caught("contract-shm", "OFF_HEAD", "shmring.py")


def test_dropped_timeout_abi_arg(tmp_path):
    root = Twin(tmp_path)
    root.modify("pkg/core/native.py", lambda t: re.sub(
        r"(_RECV_CB, _FAIL_CB, ctypes\.c_void_p,\s*)ctypes\.c_double,",
        r"\1", t, count=1))
    root.caught("contract-abi", "sw_recv", "native.py")
    hit = next(f for f in root.findings("contract-abi") if "sw_recv" in f.message)
    assert "8 argtypes" in hit.message and "9 parameters" in hit.message


def test_reworded_reason_string(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/errors.py",
              'REASON_TIMEOUT = "Operation timed out (deadline exceeded before completion)"',
              'REASON_TIMEOUT = "Operation exceeded its deadline"')
    hits = root.findings("contract-reason")
    # Both sub-checks fire: the stable "timed out" keyword is gone AND the
    # literal no longer matches the C++ engine's kTimedOut.
    assert any("stable keyword" in f.message for f in hits), hits
    assert any("kTimedOut" in f.message for f in hits), hits
    root.caught("contract-reason", "REASON_TIMEOUT", "errors.py")


def test_garbled_doc_table(tmp_path):
    # Re-introduce a bug the JAX package once had: the HELLO_ACK row
    # losing its column separator must be caught, so the docstring table
    # can never silently drift from the T_* constants again.
    root = Twin(tmp_path)
    root.edit("pkg/core/frames.py", "HELLO_ACK 0", "HELLO_ACK0 ")
    hits = root.findings("contract-doctable")
    assert any("HELLO_ACK0" in f.message for f in hits), hits
    assert any("missing from the docstring table" in f.message for f in hits), hits


def test_version_drift(tmp_path):
    # The version is read from the engine itself, so the fixture follows
    # every bump of it (both packages' engines say the same).
    version = engine_version()
    assert engine_version(JAX) == version
    name, _, n = version.rpartition("-")
    bumped = f"{name}-{int(n) + 1}"
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              f'return "{version}"', f'return "{bumped}"')
    root.caught("contract-version", bumped, "sw_engine.h")


def test_handshake_key_only_in_comments_still_fails(tmp_path):
    # Deleting the negotiation code must fire even when the key survives
    # in comments/docstrings (the checker searches code literals only).
    root = Twin(tmp_path)
    root.modify("pkg/core/engine.py", lambda t: t.replace('"ka"', '"kx"')
                 + '\n# the "ka" key lives only in this comment now\n')
    root.caught("contract-handshake", '"ka"', "engine.py")
    root2 = Twin(tmp_path / "two")
    root2.modify("native/sw_engine.cpp", lambda t: t.replace('"ka"', '"kx"')
                 + '\n// the "ka" key lives only in this comment now\n')
    root2.caught("contract-handshake", '"ka"', "sw_engine.cpp")


def test_counter_added_to_one_engine_only(tmp_path):
    # The counter-name vocabulary is contract surface;
    # renaming (= adding/removing) a counter in the C++ array alone must
    # fire on BOTH sides of the diff.
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp", '"bytes_tx",', '"bytes_tx_v2",')
    root.caught("contract-trace", "bytes_tx_v2", "sw_engine.cpp")
    root.caught("contract-trace", "'bytes_tx'", "swtrace.py")


def test_counter_added_to_python_only(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/swtrace.py",
              '"reconnects",         # ', '"reconnects",\n    "rebalances",  # ')
    root.caught("contract-trace", "rebalances", "swtrace.py")


def test_trace_event_value_drift(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/swtrace.py",
              'EV_SEND_POST = "send_post"', 'EV_SEND_POST = "send_posted"')
    root.caught("contract-trace", "EV_SEND_POST", "swtrace.py")


def test_trace_event_only_in_cpp(tmp_path):
    root = Twin(tmp_path)
    root.modify("native/sw_engine.cpp", lambda t: t.replace(
                'const char* kEvConnDown = "conn_down";',
                'const char* kEvConnDown = "conn_down";\n'
                'const char* kEvRetry = "retry";', 1))
    root.caught("contract-trace", "kEvRetry", "sw_engine.cpp")


def test_session_frame_constant_drift(tmp_path):
    # The new frame-table rows: T_SEQ/T_ACK diverging between the engines
    # (either direction) is a finding.
    root = Twin(tmp_path)
    root.edit("pkg/core/frames.py", "T_SEQ = 9", "T_SEQ = 11")
    root.caught("contract-frames", "T_SEQ", "frames.py")
    root2 = Twin(tmp_path / "two")
    root2.edit("native/sw_engine.cpp",
               "constexpr uint8_t T_ACK = 10;", "constexpr uint8_t T_ACK = 12;")
    # Frame diffs anchor at the Python side of the pair (the reference
    # table), whichever engine drifted.
    root2.caught("contract-frames", "T_ACK = 12", "frames.py")


def test_session_handshake_key_dropped(tmp_path):
    # Deleting the "sess" negotiation from either engine's code fires,
    # even when the key survives in comments/docstrings.
    root = Twin(tmp_path)
    root.modify("pkg/core/engine.py", lambda t: t.replace('"sess"', '"sesz"')
                 + '\n# the "sess" key lives only in this comment now\n')
    root.caught("contract-handshake", '"sess"', "engine.py")
    root2 = Twin(tmp_path / "two")
    root2.modify("native/sw_engine.cpp", lambda t: t.replace('"sess"', '"sesz"')
                 + '\n// the "sess" key lives only in this comment now\n')
    root2.caught("contract-handshake", '"sess"', "sw_engine.cpp")


def test_session_reason_reworded(tmp_path):
    # "session expired" is a stable reason keyword callers match on
    # (tests/test_session.py): rewording it fires both sub-checks --
    # keyword gone AND literal drift from the C++ kSessionExpired.
    root = Twin(tmp_path)
    root.edit("pkg/errors.py",
              'REASON_SESSION_EXPIRED = "Session expired (resume window elapsed'
              ' or peer restarted)"',
              'REASON_SESSION_EXPIRED = "Resume window closed"')
    hits = root.findings("contract-reason")
    assert any("stable keyword" in f.message for f in hits), hits
    assert any("kSessionExpired" in f.message for f in hits), hits
    root.caught("contract-reason", "REASON_SESSION_EXPIRED",
                "errors.py")


def test_session_counter_dropped_from_cpp(tmp_path):
    # The five session counters (sessions_resumed, frames_replayed,
    # dup_frames_dropped, acks_tx/rx) are vocabulary: renaming one in the
    # C++ array alone fires on BOTH sides of the diff.
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              '"sessions_resumed"', '"sessions_resumed_v2"')
    root.caught("contract-trace", "sessions_resumed_v2",
                "sw_engine.cpp")
    root.caught("contract-trace", "'sessions_resumed'", "swtrace.py")


def test_session_doc_table_row_garbled(tmp_path):
    # The SEQ row of the frames.py docstring table must track T_SEQ; a
    # garbled label is "constant missing from the table", never silence.
    root = Twin(tmp_path)
    root.edit("pkg/core/frames.py",
              "SEQ       next session frame's seq", "SEQX      next session frame's seq")
    hits = root.findings("contract-doctable")
    assert any("SEQX" in f.message for f in hits), hits
    assert any("missing from the docstring table" in f.message
               for f in hits), hits


def test_tr_handshake_key_dropped(tmp_path):
    # Deleting the "tr" negotiation from either engine's code fires, even
    # when the key survives in comments/docstrings.
    root = Twin(tmp_path)
    root.modify("pkg/core/engine.py", lambda t: t.replace('"tr"', '"tz"')
                 + '\n# the "tr" key lives only in this comment now\n')
    root.caught("contract-handshake", '"tr"', "engine.py")
    root2 = Twin(tmp_path / "two")
    root2.modify("native/sw_engine.cpp", lambda t: t.replace('"tr"', '"tz"')
                 + '\n// the "tr" key lives only in this comment now\n')
    root2.caught("contract-handshake", '"tr"', "sw_engine.cpp")


def test_gauge_dropped_from_cpp(tmp_path):
    # Renaming a gauge in the C++ array alone fires on BOTH sides of the
    # set diff (a gauge added to one engine only).
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              '"journal_bytes",', '"journal_bytes_v2",')
    root.caught("contract-trace", "journal_bytes_v2", "sw_engine.cpp")
    root.caught("contract-trace", "'journal_bytes'", "telemetry.py")


def test_gauge_added_to_python_only(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/telemetry.py",
              '"journal_frames",', '"journal_frames",\n    "rx_backlog",')
    root.caught("contract-trace", "rx_backlog", "telemetry.py")


def test_gauge_vocabulary_vacuity_guard(tmp_path):
    # An extractor that silently loses the vocabulary must be a finding,
    # never a vacuous pass.
    root = Twin(tmp_path)
    root.edit("pkg/core/telemetry.py",
              "GAUGE_NAMES = (", "GAUGE_LABELS = (")
    root.caught("contract-trace", "GAUGE_NAMES tuple not found",
              "telemetry.py")


def test_e2e_event_value_drift(tmp_path):
    # The swscope events ride the existing EV_* <-> kEv* mechanical diff.
    root = Twin(tmp_path)
    root.edit("pkg/core/swtrace.py",
              'EV_E2E = "e2e"', 'EV_E2E = "e2e_v2"')
    root.caught("contract-trace", "EV_E2E", "swtrace.py")
    root2 = Twin(tmp_path / "two")
    root2.edit("native/sw_engine.cpp",
              'const char* kEvClock = "clock_sample";',
              'const char* kEvClock = "clock_tick";')
    root2.caught("contract-trace", "EV_CLOCK", "swtrace.py")


def test_sw_gauges_abi_dropped(tmp_path):
    # The sw_gauges ABI row: dropping the ctypes argtypes while the
    # header still declares the function is a stale-binding finding.
    root = Twin(tmp_path)
    root.edit("pkg/core/native.py",
              "        lib.sw_gauges.argtypes = [\n"
              "            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int\n"
              "        ]\n", "")
    root.caught("contract-abi", "sw_gauges", "sw_engine.h")


def test_bumped_sdata_frame_constant(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/frames.py", "T_SDATA = 12", "T_SDATA = 14")
    root.caught("contract-frames", "T_SDATA", "frames.py")


def test_changed_sdata_subheader_layout(tmp_path):
    # The 24-byte stripe sub-header is wire format: shrinking the Python
    # struct must diff against the native SDATA_SUB_SIZE constexpr.
    root = Twin(tmp_path)
    root.edit("pkg/core/frames.py",
              'SDATA_SUB = struct.Struct("<QQQ")',
              'SDATA_SUB = struct.Struct("<QQ")')
    root.caught("contract-header", "SDATA_SUB", "frames.py")


def test_rails_handshake_key_dropped(tmp_path):
    # Deleting the rails negotiation from one engine only must fire, even
    # with the key surviving in comments (code-literal search only).
    root = Twin(tmp_path)
    root.modify("pkg/core/engine.py", lambda t: t.replace('"rails"', '"railx"')
                 + '\n# the "rails" key lives only in this comment now\n')
    root.caught("contract-handshake", '"rails"', "engine.py")
    root2 = Twin(tmp_path / "two")
    root2.modify("native/sw_engine.cpp", lambda t: t.replace('"rail_of"', '"rail_xx"'))
    root2.caught("contract-handshake", '"rail_of"', "sw_engine.cpp")


def test_stripe_counter_dropped_from_native(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              '"stripe_chunks_tx",  "stripe_chunks_rx",',
              '"stripe_chunks_tx_v2",  "stripe_chunks_rx",')
    root.caught("contract-trace", "stripe_chunks_tx_v2",
              "sw_engine.cpp")
    root.caught("contract-trace", "'stripe_chunks_tx'",
              "swtrace.py")


def test_stripe_gauge_dropped_from_python(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/telemetry.py",
              '"stripe_pending",', '')
    root.caught("contract-trace", "stripe_pending",
              "sw_engine.cpp")


def test_credit_frame_constant_drift(tmp_path):
    # The new frame rows: T_CREDIT/T_RTS/T_CTS diverging between the
    # engines (either direction) is a finding.
    root = Twin(tmp_path)
    root.edit("pkg/core/frames.py", "T_CREDIT = 14", "T_CREDIT = 17")
    root.caught("contract-frames", "T_CREDIT", "frames.py")
    root2 = Twin(tmp_path / "two")
    root2.edit("native/sw_engine.cpp",
              "constexpr uint8_t T_RTS = 15;", "constexpr uint8_t T_RTS = 18;")
    root2.caught("contract-frames", "T_RTS = 18", "frames.py")


def test_fc_handshake_key_dropped(tmp_path):
    # Deleting the "fc" negotiation from either engine's code fires,
    # even when the key survives in comments/docstrings.
    root = Twin(tmp_path)
    root.modify("pkg/core/engine.py", lambda t: t.replace('"fc"', '"fz"')
                 + '\n# the "fc" key lives only in this comment now\n')
    root.caught("contract-handshake", '"fc"', "engine.py")
    root2 = Twin(tmp_path / "two")
    # The checker matches the bare `"fc"` code literal (the json_field
    # reads); the escaped \"fc\" string-building fragments never match
    # it, so renaming the reads alone must fire.
    root2.modify("native/sw_engine.cpp", lambda t: t.replace('"fc"', '"fz"')
                  + '\n// the "fc" key lives only in this comment now\n')
    root2.caught("contract-handshake", '"fc"', "sw_engine.cpp")


def test_fc_counter_dropped_from_native(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              '"sends_parked",      "sheds",', '"sends_parked_v2",      "sheds",')
    root.caught("contract-trace", "sends_parked_v2", "sw_engine.cpp")
    root.caught("contract-trace", "'sends_parked'", "swtrace.py")


def test_fc_gauge_dropped_from_python(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/telemetry.py", '"credits_avail",', '')
    root.caught("contract-trace", "credits_avail", "sw_engine.cpp")


def test_credit_doc_table_row_garbled(tmp_path):
    # The CREDIT row of the frames.py docstring table must track
    # T_CREDIT; a garbled label is "constant missing from the table".
    root = Twin(tmp_path)
    root.edit("pkg/core/frames.py",
              "CREDIT    granted window bytes", "CREDITX   granted window bytes")
    hits = root.findings("contract-doctable")
    assert any("CREDITX" in f.message for f in hits), hits
    assert any("missing from the docstring table" in f.message
               for f in hits), hits


def test_csum_frame_constant_drift(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/frames.py", "T_SNACK = 18", "T_SNACK = 19")
    root.caught("contract-frames", "T_SNACK", "frames.py")
    root2 = Twin(tmp_path / "two")
    root2.edit("native/sw_engine.cpp",
              "constexpr uint8_t T_CSUM = 17;", "constexpr uint8_t T_CSUM = 19;")
    root2.caught("contract-frames", "T_CSUM = 19", "frames.py")


def test_csum_handshake_key_dropped(tmp_path):
    # Deleting the "csum" negotiation from either engine's code fires,
    # even when the key survives in comments/docstrings.
    root = Twin(tmp_path)
    root.modify("pkg/core/engine.py", lambda t: t.replace('"csum"', '"csux"')
                 + '\n# the "csum" key lives only in this comment now\n')
    root.caught("contract-handshake", '"csum"', "engine.py")
    root2 = Twin(tmp_path / "two")
    root2.modify("native/sw_engine.cpp", lambda t: t.replace('"csum"', '"csux"')
                 + '\n// the "csum" key lives only in this comment now\n')
    root2.caught("contract-handshake", '"csum"', "sw_engine.cpp")


def test_corrupt_reason_reworded(tmp_path):
    # "corrupt" is the stable poison keyword callers match on
    # (tests/test_integrity.py): rewording fires both sub-checks.
    root = Twin(tmp_path)
    root.edit("pkg/errors.py",
              'REASON_CORRUPT = "Data integrity violation (corrupt frame'
              ' detected)"',
              'REASON_CORRUPT = "Checksum mismatch"')
    hits = root.findings("contract-reason")
    assert any("stable keyword" in f.message for f in hits), hits
    assert any("kCorrupt" in f.message for f in hits), hits
    root.caught("contract-reason", "REASON_CORRUPT", "errors.py")


def test_sm_slot_trailer_layout_drift(tmp_path):
    # The slot-record header size is shared segment framing: the engines
    # disagreeing on it would silently interleave garbage.
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "constexpr size_t SM_REC_HDR = 8;", "constexpr size_t SM_REC_HDR = 16;")
    root.caught("contract-shm", "SM_REC_HDR", "shmring.py")


def test_csum_counter_dropped_from_cpp(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp", '"csum_fail"', '"csum_fail_v2"')
    root.caught("contract-trace", "csum_fail_v2", "sw_engine.cpp")
    root.caught("contract-trace", "'csum_fail'", "swtrace.py")


def test_retx_gauge_dropped_from_cpp(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp", '"retx_pending",', "")
    root.caught("contract-trace", "retx_pending", "telemetry.py")


def test_csum_doc_table_row_garbled(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/frames.py",
              "SNACK     corrupt chunk's msg id", "SNACKX    corrupt chunk's msg id")
    hits = root.findings("contract-doctable")
    assert any("SNACKX" in f.message for f in hits), hits
    assert any("missing from the docstring table" in f.message
               for f in hits), hits


def test_sw_crc32c_abi_dropped(tmp_path):
    # Removing the export from the header while the ctypes binding stays
    # is a stale-binding finding (and vice versa would be a missing
    # argtypes finding) -- the §19 checksum must stay one function.
    root = Twin(tmp_path)
    root.edit("native/sw_engine.h",
              "uint32_t sw_crc32c(const void* p, uint64_t n, uint32_t seed);", "")
    root.caught("contract-abi", "sw_crc32c", "native.py")


def test_hist_dropped_from_cpp(tmp_path):
    # Renaming a histogram in the C++ array alone fires on BOTH sides of
    # the set diff (a histogram added to one engine only).
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp", '"flush_us",       //',
              '"flush_us_v2",    //')
    root.caught("contract-pulse", "flush_us_v2", "sw_engine.cpp")
    root.caught("contract-pulse", "'flush_us'", "swtrace.py")


def test_hist_added_to_python_only(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/swtrace.py",
              '"msg_bytes",', '"msg_bytes",\n    "rtt_us",')
    root.caught("contract-pulse", "rtt_us", "swtrace.py")


def test_hist_bucket_resolution_drift(tmp_path):
    # The bucket count IS the bucket-boundary contract (base-2 buckets):
    # shrinking the native array alone must fire.
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "constexpr int kHistBuckets = 64;",
              "constexpr int kHistBuckets = 32;")
    root.caught("contract-pulse", "kHistBuckets = 32", "swtrace.py")


def test_stall_reason_reworded(tmp_path):
    # Stall reports carry the reason string verbatim from either engine:
    # rewording one side alone must fire.
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp", '"stall-credit",', '"stall-credits",')
    root.caught("contract-pulse", "stall-credits", "sw_engine.cpp")


def test_hist_vocabulary_vacuity_guard(tmp_path):
    # An extractor that silently loses the vocabulary must be a finding,
    # never a vacuous pass.
    root = Twin(tmp_path)
    root.edit("pkg/core/swtrace.py",
              "HIST_NAMES = (", "HIST_LABELS = (")
    root.caught("contract-pulse", "HIST_NAMES tuple not found",
              "swtrace.py")
