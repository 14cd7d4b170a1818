"""Pass 1: the cross-engine contract checker.

Diffs the machine-readable contract surface between the Python engine
(core/frames.py, core/shmring.py, core/conn.py, core/native.py, errors.py,
core/engine.py) and the C++ engine (native/sw_engine.cpp, native/
sw_engine.h): frame-type constants, the 17-byte wire header, the shm ring
layout, doorbell bytes, the exported C ABI (incl. per-op ``timeout_s``),
stable failure-reason strings, negotiated handshake keys, and the engine
version string.  "Two engines, one contract" (CLAUDE.md) -- this pass is
what turns that sentence from a review checklist into a merge gate.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path

from .base import Finding
from .cpp_model import CppModel, extract_cpp
from .py_model import PyModel, extract_py

# Python-side shm layout name -> C++ engine name (same segment bytes).
_SHM_PAIRS = [
    ("MAGIC", "SM_MAGIC"),
    ("GLOBAL_HDR", "SM_GLOBAL_HDR"),
    ("RING_HDR", "SM_RING_HDR"),
    ("DATA_OFF", "SM_DATA_OFF"),
    ("OFF_TAIL", "SM_OFF_TAIL"),
    ("OFF_HEAD", "SM_OFF_HEAD"),
    # §19 integrity slot-record header (len u32 + crc u32): the trailer
    # layout both engines frame ring writes with once "csum" negotiates.
    ("REC_HDR", "SM_REC_HDR"),
]

# errors.py constant -> (C++ literal name, stable keyword pinned by tests).
_REASON_PAIRS = [
    ("REASON_CANCELLED", "kCancelled", "cancel"),
    ("REASON_NOT_CONNECTED", "kNotConnected", "not connected"),
    ("REASON_TRUNCATED", "kTruncated", "truncated"),
    ("REASON_TIMEOUT", "kTimedOut", "timed out"),
    ("REASON_SESSION_EXPIRED", "kSessionExpired", "session expired"),
    ("REASON_CORRUPT", "kCorrupt", "corrupt"),
]

# Negotiated handshake keys: offered in HELLO, confirmed in HELLO_ACK.
# "sess" is the resilient-session negotiation (DESIGN.md §14; carries the
# sess_id/sess_epoch/sess_ack triple alongside it); "tr" is the swscope
# end-to-end trace-conn id (DESIGN.md §15); "rails"/"rail_of" are the
# multi-rail striping negotiation and the secondary-lane attach key
# (DESIGN.md §17); "fc" is the receiver-driven flow-control window
# advertisement (DESIGN.md §18); "csum" is the end-to-end integrity
# negotiation (DESIGN.md §19).  The port's engines negotiate their device
# pull under "cudaipc" (device.py's identity), never under "devpull".
_HANDSHAKE_KEYS = ["ka", "sm", "cudaipc", "sess", "tr", "rails", "rail_of",
                   "fc", "csum"]

# Normalised C type -> acceptable canonical ctypes spellings.
_C2CTYPES = {
    "void*": {"c_void_p"},
    "char*": {"c_char_p", "POINTER(c_char)"},
    "uint64_t": {"c_uint64"},
    "uint64_t*": {"POINTER(c_uint64)"},
    "uint8_t": {"c_uint8"},
    "uint32_t": {"c_uint32"},
    "int": {"c_int"},
    "double": {"c_double"},
}

_C2RESTYPE = {
    "char*": "c_char_p",
    "void*": "c_void_p",
    "uint64_t": "c_uint64",
    "uint32_t": "c_uint32",
}


def _cb_pyname(typedef: str) -> str:
    # sw_done_cb -> _DONE_CB, sw_devpull_claim_cb -> _DEVPULL_CLAIM_CB
    return "_" + typedef[3:-3].upper() + "_CB"


def _expected_ctypes(ctype: str, callbacks: dict) -> set:
    if ctype in callbacks:
        return {_cb_pyname(ctype)}
    return _C2CTYPES.get(ctype, {ctype})


def _check_frames(py: PyModel, cpp: CppModel, out: list) -> None:
    f_frames = py.files["frames"]
    cpp_t = {k: v for k, v in cpp.constants.items() if re.fullmatch(r"T_\w+", k)}
    for name, (val, line) in sorted(py.frames.items()):
        if name not in cpp_t:
            out.append(Finding(f_frames, line, "contract-frames",
                               f"{name} = {val} has no counterpart in {cpp.cpp_file}"))
        elif cpp_t[name][0] != val:
            out.append(Finding(
                f_frames, line, "contract-frames",
                f"{name} = {val} but {cpp.cpp_file}:{cpp_t[name][1]} has "
                f"{name} = {cpp_t[name][0]} (two engines, one wire format)"))
    for name, (val, line) in sorted(cpp_t.items()):
        if name not in py.frames:
            out.append(Finding(cpp.cpp_file, line, "contract-frames",
                               f"{name} = {val} has no counterpart in {f_frames}"))

    if py.header_fmt is not None:
        fmt, line = py.header_fmt
        try:
            py_size = struct.calcsize(fmt)
        except struct.error:
            py_size = -1
        cpp_size = cpp.constants.get("HEADER_SIZE")
        if cpp_size is None:
            out.append(Finding(cpp.cpp_file, 1, "contract-header",
                               "HEADER_SIZE constexpr not found"))
        elif cpp_size[0] != py_size:
            out.append(Finding(
                f_frames, line, "contract-header",
                f"struct.Struct({fmt!r}) packs {py_size} bytes but "
                f"{cpp.cpp_file}:{cpp_size[1]} has HEADER_SIZE = {cpp_size[0]}"))
    else:
        out.append(Finding(f_frames, 1, "contract-header",
                           "HEADER = struct.Struct(...) not found"))

    # Striped-DATA sub-header layout (DESIGN.md §17): the SDATA_SUB pack
    # size must equal the C++ SDATA_SUB_SIZE constexpr.
    if py.sdata_sub_fmt is not None:
        fmt, line = py.sdata_sub_fmt
        try:
            py_size = struct.calcsize(fmt)
        except struct.error:
            py_size = -1
        cpp_size = cpp.constants.get("SDATA_SUB_SIZE")
        if cpp_size is None:
            out.append(Finding(cpp.cpp_file, 1, "contract-header",
                               "SDATA_SUB_SIZE constexpr not found"))
        elif cpp_size[0] != py_size:
            out.append(Finding(
                f_frames, line, "contract-header",
                f"SDATA_SUB struct.Struct({fmt!r}) packs {py_size} bytes but "
                f"{cpp.cpp_file}:{cpp_size[1]} has SDATA_SUB_SIZE = "
                f"{cpp_size[0]} (two engines, one stripe sub-header)"))
    else:
        out.append(Finding(f_frames, 1, "contract-header",
                           "SDATA_SUB = struct.Struct(...) not found"))


def _check_shm(py: PyModel, cpp: CppModel, out: list) -> None:
    f_shm = py.files["shmring"]
    for py_name, cpp_name in _SHM_PAIRS:
        if py_name not in py.shm:
            out.append(Finding(f_shm, 1, "contract-shm",
                               f"{py_name} layout constant not found"))
            continue
        val, line = py.shm[py_name]
        if cpp_name not in cpp.constants:
            out.append(Finding(cpp.cpp_file, 1, "contract-shm",
                               f"{cpp_name} constexpr not found"))
        elif cpp.constants[cpp_name][0] != val:
            cval, cline = cpp.constants[cpp_name]
            out.append(Finding(
                f_shm, line, "contract-shm",
                f"{py_name} = {val:#x} but {cpp.cpp_file}:{cline} has "
                f"{cpp_name} = {cval:#x} (same mapped segment on both engines)"))
    f_conn = py.files["conn"]
    for name in ("DB_DATA", "DB_STARVING"):
        if name not in py.doorbell:
            out.append(Finding(f_conn, 1, "contract-doorbell",
                               f"{name} constant not found"))
        elif name not in cpp.constants:
            out.append(Finding(cpp.cpp_file, 1, "contract-doorbell",
                               f"{name} constexpr not found"))
        elif cpp.constants[name][0] != py.doorbell[name][0]:
            val, line = py.doorbell[name]
            cval, cline = cpp.constants[name]
            out.append(Finding(
                f_conn, line, "contract-doorbell",
                f"{name} = {val} but {cpp.cpp_file}:{cline} has {cval}"))


def _check_abi(py: PyModel, cpp: CppModel, out: list) -> None:
    f_native = py.files["native"]
    for name, fn in sorted(cpp.functions.items()):
        if fn.args and name not in py.argtypes:
            out.append(Finding(
                cpp.h_file, fn.line, "contract-abi",
                f"{name} declared in {cpp.h_file} but {f_native} load() "
                "declares no argtypes for it"))
            continue
        if name in py.argtypes:
            got, line = py.argtypes[name]
            if len(got) != len(fn.args):
                out.append(Finding(
                    f_native, line, "contract-abi",
                    f"{name}: {len(got)} argtypes but {cpp.h_file}:{fn.line} "
                    f"declares {len(fn.args)} parameters "
                    f"({', '.join(fn.args) or 'void'})"))
            else:
                for i, (ctype, pytype) in enumerate(zip(fn.args, got)):
                    if pytype not in _expected_ctypes(ctype, cpp.callbacks):
                        out.append(Finding(
                            f_native, line, "contract-abi",
                            f"{name} arg {i}: {pytype} does not match C type "
                            f"`{ctype}` ({cpp.h_file}:{fn.line})"))
        want_res = _C2RESTYPE.get(fn.ret)
        have_res = py.restype.get(name)
        if want_res is not None:
            if have_res is None:
                out.append(Finding(
                    cpp.h_file, fn.line, "contract-abi",
                    f"{name} returns `{fn.ret}` but {f_native} declares no "
                    f"restype (ctypes default int truncates pointers)"))
            elif have_res[0] != want_res:
                out.append(Finding(
                    f_native, have_res[1], "contract-abi",
                    f"{name}: restype {have_res[0]} but C return type is "
                    f"`{fn.ret}` ({cpp.h_file}:{fn.line})"))
    for name, (_, line) in sorted(py.argtypes.items()):
        if name not in cpp.functions:
            out.append(Finding(
                f_native, line, "contract-abi",
                f"{name} has argtypes but is not declared in {cpp.h_file} "
                "(stale binding)"))
    for typedef, sig in sorted(cpp.callbacks.items()):
        pyname = _cb_pyname(typedef)
        if pyname not in py.cfunctypes:
            out.append(Finding(
                cpp.h_file, sig.line, "contract-abi",
                f"callback typedef {typedef} has no {pyname} CFUNCTYPE in "
                f"{f_native}"))
            continue
        got, line = py.cfunctypes[pyname]
        if len(got) != len(sig.args) + 1:  # CFUNCTYPE arg 0 is the restype
            out.append(Finding(
                f_native, line, "contract-abi",
                f"{pyname}: {len(got) - 1} args but {typedef} "
                f"({cpp.h_file}:{sig.line}) declares {len(sig.args)}"))
            continue
        # The return maps through the same C->ctypes table as the args
        # (void -> None), so a future non-void callback checks correctly.
        ret_ok = (got[0] == "None") if sig.ret == "void" \
            else got[0] in _expected_ctypes(sig.ret, cpp.callbacks)
        if not ret_ok:
            out.append(Finding(
                f_native, line, "contract-abi",
                f"{pyname}: return {got[0]} but {typedef} returns {sig.ret}"))
        for i, (ctype, pytype) in enumerate(zip(sig.args, got[1:])):
            if pytype not in _expected_ctypes(ctype, cpp.callbacks):
                out.append(Finding(
                    f_native, line, "contract-abi",
                    f"{pyname} arg {i}: {pytype} does not match C type "
                    f"`{ctype}` ({typedef}, {cpp.h_file}:{sig.line})"))


def _check_reasons(py: PyModel, cpp: CppModel, out: list) -> None:
    f_err = py.files["errors"]
    for py_name, cpp_name, keyword in _REASON_PAIRS:
        if py_name not in py.reasons:
            out.append(Finding(f_err, 1, "contract-reason",
                               f"{py_name} not found"))
            continue
        val, line = py.reasons[py_name]
        if keyword not in val.lower():
            out.append(Finding(
                f_err, line, "contract-reason",
                f"{py_name} = {val!r} lost its stable keyword {keyword!r} "
                "(pinned by tests/test_basic.py fail-callback matching)"))
        if cpp_name not in cpp.reasons:
            out.append(Finding(cpp.cpp_file, 1, "contract-reason",
                               f"{cpp_name} reason literal not found"))
        elif cpp.reasons[cpp_name][0] != val:
            cval, cline = cpp.reasons[cpp_name]
            out.append(Finding(
                f_err, line, "contract-reason",
                f"{py_name} = {val!r} but {cpp.cpp_file}:{cline} has "
                f"{cpp_name} = {cval!r} (engines must report identical reasons)"))


def _check_handshake(py: PyModel, cpp: CppModel, out: list) -> None:
    # Code-only surfaces on both sides: a key surviving in a comment or
    # docstring after the negotiation lines were deleted must still fail.
    f_engine = py.files["engine"]
    for key in _HANDSHAKE_KEYS:
        if key not in py.engine_strings:
            out.append(Finding(f_engine, 1, "contract-handshake",
                               f"handshake key \"{key}\" not referenced in "
                               "code by the Python engine"))
        if f'"{key}"' not in cpp.cpp_code:
            out.append(Finding(cpp.cpp_file, 1, "contract-handshake",
                               f"handshake key \"{key}\" not referenced in "
                               "code by the C++ engine"))


def _ev_cpp_name(py_name: str) -> str:
    """EV_SEND_POST -> kEvSendPost (the mechanical cross-engine mapping)."""
    return "kEv" + "".join(
        part.capitalize() for part in py_name[3:].lower().split("_"))


def _check_trace(py: PyModel, cpp: CppModel, out: list) -> None:
    """swtrace vocabulary parity (ISSUE 4): trace event-type constants and
    the counter-name vocabulary must exist, identically, in both engines --
    a counter or event added to one engine only is a finding."""
    f_sw = py.files["swtrace"]
    claimed = set()
    for name, (val, line) in sorted(py.trace_events.items()):
        cname = _ev_cpp_name(name)
        claimed.add(cname)
        if cname not in cpp.trace_events:
            out.append(Finding(
                f_sw, line, "contract-trace",
                f"{name} = {val!r} has no {cname} counterpart in "
                f"{cpp.cpp_file} (two engines, one trace vocabulary)"))
        elif cpp.trace_events[cname][0] != val:
            cval, cline = cpp.trace_events[cname]
            out.append(Finding(
                f_sw, line, "contract-trace",
                f"{name} = {val!r} but {cpp.cpp_file}:{cline} has "
                f"{cname} = {cval!r}"))
    for cname, (cval, cline) in sorted(cpp.trace_events.items()):
        if cname not in claimed:
            out.append(Finding(
                cpp.cpp_file, cline, "contract-trace",
                f"{cname} = {cval!r} has no EV_* counterpart in {f_sw}"))
    if py.counter_names is None:
        out.append(Finding(f_sw, 1, "contract-trace",
                           "COUNTER_NAMES tuple not found"))
        return
    if cpp.counter_names is None:
        out.append(Finding(cpp.cpp_file, 1, "contract-trace",
                           "kCounterNames[] array not found"))
        return
    py_names, py_line = py.counter_names
    cpp_names, cpp_line = cpp.counter_names
    for name in py_names:
        if name not in cpp_names:
            out.append(Finding(
                f_sw, py_line, "contract-trace",
                f"counter {name!r} is declared in COUNTER_NAMES only -- "
                f"{cpp.cpp_file}:{cpp_line} kCounterNames[] lacks it "
                "(a counter added to one engine only)"))
    for name in cpp_names:
        if name not in py_names:
            out.append(Finding(
                cpp.cpp_file, cpp_line, "contract-trace",
                f"counter {name!r} is declared in kCounterNames[] only -- "
                f"{f_sw}:{py_line} COUNTER_NAMES lacks it "
                "(a counter added to one engine only)"))
    # swscope gauge vocabulary (ISSUE 6): GAUGE_NAMES <-> kGaugeNames[],
    # vacuity-guarded like the counter pair above.
    f_tel = py.files["telemetry"]
    if py.gauge_names is None:
        out.append(Finding(f_tel, 1, "contract-trace",
                           "GAUGE_NAMES tuple not found"))
        return
    if cpp.gauge_names is None:
        out.append(Finding(cpp.cpp_file, 1, "contract-trace",
                           "kGaugeNames[] array not found"))
        return
    pg_names, pg_line = py.gauge_names
    cg_names, cg_line = cpp.gauge_names
    for name in pg_names:
        if name not in cg_names:
            out.append(Finding(
                f_tel, pg_line, "contract-trace",
                f"gauge {name!r} is declared in GAUGE_NAMES only -- "
                f"{cpp.cpp_file}:{cg_line} kGaugeNames[] lacks it "
                "(a gauge added to one engine only)"))
    for name in cg_names:
        if name not in pg_names:
            out.append(Finding(
                cpp.cpp_file, cg_line, "contract-trace",
                f"gauge {name!r} is declared in kGaugeNames[] only -- "
                f"{f_tel}:{pg_line} GAUGE_NAMES lacks it "
                "(a gauge added to one engine only)"))


def _check_pulse(py: PyModel, cpp: CppModel, out: list) -> None:
    """swpulse vocabulary parity (DESIGN.md §25): the histogram name
    vocabulary (HIST_NAMES <-> kHistNames[], ORDER included -- it is the
    sw_hists row order), the bucket resolution (HIST_BUCKETS <->
    kHistBuckets) and the stall sentinel reasons (STALL_REASONS <->
    kStallReasons[]) must exist, identically, in both engines.  Vacuity
    guarded: a missing vocabulary is a finding, never a silent pass."""
    f_sw = py.files["swtrace"]
    if py.hist_names is None:
        out.append(Finding(f_sw, 1, "contract-pulse",
                           "HIST_NAMES tuple not found"))
        return
    if cpp.hist_names is None:
        out.append(Finding(cpp.cpp_file, 1, "contract-pulse",
                           "kHistNames[] array not found"))
        return
    ph_names, ph_line = py.hist_names
    ch_names, ch_line = cpp.hist_names
    for name in ph_names:
        if name not in ch_names:
            out.append(Finding(
                f_sw, ph_line, "contract-pulse",
                f"histogram {name!r} is declared in HIST_NAMES only -- "
                f"{cpp.cpp_file}:{ch_line} kHistNames[] lacks it "
                "(a histogram added to one engine only)"))
    for name in ch_names:
        if name not in ph_names:
            out.append(Finding(
                cpp.cpp_file, ch_line, "contract-pulse",
                f"histogram {name!r} is declared in kHistNames[] only -- "
                f"{f_sw}:{ph_line} HIST_NAMES lacks it "
                "(a histogram added to one engine only)"))
    if set(ph_names) == set(ch_names) and ph_names != ch_names:
        out.append(Finding(
            cpp.cpp_file, ch_line, "contract-pulse",
            f"kHistNames[] order {ch_names} differs from "
            f"{f_sw}:{ph_line} HIST_NAMES {ph_names} -- the order is the "
            "sw_hists row order and must match"))
    if py.hist_buckets is None:
        out.append(Finding(f_sw, 1, "contract-pulse",
                           "HIST_BUCKETS constant not found"))
    elif "kHistBuckets" not in cpp.constants:
        out.append(Finding(cpp.cpp_file, 1, "contract-pulse",
                           "kHistBuckets constexpr not found"))
    elif cpp.constants["kHistBuckets"][0] != py.hist_buckets[0]:
        cval, cline = cpp.constants["kHistBuckets"]
        out.append(Finding(
            f_sw, py.hist_buckets[1], "contract-pulse",
            f"HIST_BUCKETS = {py.hist_buckets[0]} but "
            f"{cpp.cpp_file}:{cline} has kHistBuckets = {cval} "
            "(the bucket boundaries must be identical in both engines)"))
    if py.stall_reasons is None:
        out.append(Finding(f_sw, 1, "contract-pulse",
                           "STALL_REASONS tuple not found"))
        return
    if cpp.stall_reasons is None:
        out.append(Finding(cpp.cpp_file, 1, "contract-pulse",
                           "kStallReasons[] array not found"))
        return
    ps_names, ps_line = py.stall_reasons
    cs_names, cs_line = cpp.stall_reasons
    if ps_names != cs_names:
        out.append(Finding(
            cpp.cpp_file, cs_line, "contract-pulse",
            f"kStallReasons[] {cs_names} differs from {f_sw}:{ps_line} "
            f"STALL_REASONS {ps_names} -- stall reports must carry the "
            "same reason strings from both engines"))


def _check_version(cpp: CppModel, out: list) -> None:
    if cpp.version is None:
        out.append(Finding(cpp.cpp_file, 1, "contract-version",
                           "sw_version() string literal not found"))
        return
    if cpp.header_version is None:
        out.append(Finding(
            cpp.h_file, 1, "contract-version",
            'sw_engine.h is missing its `swcheck: engine-version "..."` '
            "annotation next to sw_version()"))
    elif cpp.header_version[0] != cpp.version[0]:
        out.append(Finding(
            cpp.h_file, cpp.header_version[1], "contract-version",
            f"header documents engine version {cpp.header_version[0]!r} but "
            f"{cpp.cpp_file}:{cpp.version[1]} returns {cpp.version[0]!r} "
            "(bump both when the protocol changes)"))


def _check_doctable(py: PyModel, out: list) -> None:
    """The frames.py docstring frame table must list exactly the T_*
    constants, with every row keeping to the table's column grid -- the
    doc can then never drift from the code (ISSUE 2 satellite)."""
    f_frames = py.files["frames"]
    doc = py.frames_doc
    if not doc:
        out.append(Finding(f_frames, 1, "contract-doctable",
                           "frames.py module docstring not found"))
        return
    lines = doc.splitlines()
    seps = [i for i, ln in enumerate(lines)
            if re.fullmatch(r"=+( +=+)+ *", ln)]
    if len(seps) < 3:
        out.append(Finding(f_frames, 1, "contract-doctable",
                           "frame table (reST grid with 3 `=== ===` rules) "
                           "not found in the module docstring"))
        return
    grid = lines[seps[0]]
    gaps = [i for i, ch in enumerate(grid) if ch == " "]
    want = {name[2:] for name in py.frames}
    seen = set()
    for i in range(seps[1] + 1, seps[2]):
        row = lines[i]
        if not row.strip():
            continue
        lineno = i + 1  # docstring starts on file line 1
        name = row.split()[0]
        bad_grid = [g for g in gaps if g < len(row) and row[g] != " "]
        if name not in want:
            out.append(Finding(
                f_frames, lineno, "contract-doctable",
                f"table row {name!r} matches no T_* frame constant "
                "(garbled row or stale docs)"))
        elif bad_grid:
            seen.add(name)
            out.append(Finding(
                f_frames, lineno, "contract-doctable",
                f"table row {name!r} overruns its column at offset(s) "
                f"{bad_grid} (row no longer aligns with the `===` grid)"))
        else:
            seen.add(name)
    for name in sorted(want - seen):
        out.append(Finding(
            f_frames, seps[1] + 1, "contract-doctable",
            f"frame type T_{name} is missing from the docstring table"))


def run(root: Path) -> list:
    py = extract_py(root)
    cpp = extract_cpp(root)
    out: list = []
    # Vacuity guard: an extractor that silently comes up empty would turn
    # the whole gate into a no-op.  Empty models are findings, not passes.
    for ok, where, what in [
        (py.frames, py.files["frames"], "T_* frame constants"),
        (py.argtypes, py.files["native"], "lib.*.argtypes declarations"),
        (py.trace_events, py.files["swtrace"], "EV_* trace event constants"),
        (cpp.constants, cpp.cpp_file, "constexpr constants"),
        (cpp.functions, cpp.h_file, "sw_* ABI declarations"),
    ]:
        if not ok:
            out.append(Finding(where, 1, "contract-abi",
                               f"extractor found no {what} -- contract "
                               "checking would be vacuous (file moved or "
                               "extraction surface changed?)"))
    if any(f.message.startswith("extractor found no") for f in out):
        return out
    _check_frames(py, cpp, out)
    _check_shm(py, cpp, out)
    _check_abi(py, cpp, out)
    _check_reasons(py, cpp, out)
    _check_handshake(py, cpp, out)
    _check_trace(py, cpp, out)
    _check_pulse(py, cpp, out)
    _check_version(cpp, out)
    _check_doctable(py, out)
    return out
