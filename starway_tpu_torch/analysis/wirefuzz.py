"""Pass: wirefuzz -- a contract-derived differential fuzzer for the wire
decoders (DESIGN.md §21).

tests/test_fuzz_differential.py fuzzes the *matcher* with well-formed
traffic; nothing fuzzed the frame *decoders* with adversarial bytes --
exactly where the zero-length-ctl-body divergence lived (silent drop in
the C++ engine, conn-death-or-stall in the Python one).  This pass
closes that gap with three redundant implementations of the structural
decode contract, diffed byte-for-byte on identical inputs:

1. an **oracle** decoder implemented HERE, driven entirely by tables
   extracted (ast/regex, never imported) from the contract surface --
   frame-type constants, the 17-byte header layout, the stripe
   sub-header, the §19 checksum scope sets, the ctl-body bound, and the
   sm slot-record framing;
2. the Python engine's reference decoder, ``frames.decode_stream`` /
   ``shmring.decode_sm_records``, loaded FROM THE TREE UNDER CHECK (a
   throwaway package, so mutated copies are honoured);
3. the native engine's ``sw_wire_decode`` export, from the tree's own
   copy of the engine built by ``native_build``
   (``build/starway_tpu_torch/_sw_native.so`` under the tree's root); an
   engine that cannot be built or loaded is a finding, never a skip.

All three render the same canonical outcome string (status, consumed
bytes, frame list); any disagreement is a ``wire-diff`` finding.  Inputs
come from two sources, both deterministic:

* the **regression corpus** (``wirefuzz_corpus.txt`` next to this file):
  every previously-divergent or edge-pinning case, replayed by every
  gate run -- the corpus going missing or shrinking below its floor is
  itself a finding, never a silent skip;
* a **seeded generator** that builds structurally valid frame scripts
  from the extracted grammar and then mutates fields, lengths, types,
  and truncation points.  The merge gate runs a bounded quick mode
  (``QUICK_SEEDS`` per mode, ~0.2 s); the nightly CI job sets
  ``SWCHECK_WIREFUZZ_SEEDS`` for the long run and appends any new
  divergent case to the corpus.

A **static leg** runs even without any dynamic target: the §19/§21
decode tables themselves are diffed between the engines
(``frames.CSUM_EXEMPT/CSUM_BODY/HEADER_ONLY/CTL_MAX`` vs the native
``kCsumExempt[]/kCsumBody[]/kHeaderOnly[]/CTL_MAX``), and conn.py must
still *alias* the shared tables (a live parser growing its own private
set is the drift this pass exists to prevent).
"""

from __future__ import annotations

import ast
import ctypes
import importlib.util
import os
import re
import struct
import sys
import types
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .base import Finding, parse_or_finding
from .cpp_model import extract_cpp

#: Seeds per mode in the merge-gate quick run (SWCHECK_WIREFUZZ_SEEDS
#: overrides for the nightly long run).
QUICK_SEEDS = 50

#: Regression-corpus floor: the gate replays >= this many checked-in
#: cases or the corpus itself became the regression.
CORPUS_FLOOR = 100

#: Findings cap per run: a systemic divergence (e.g. a reshaped decoder)
#: would otherwise bury the signal under thousands of identical diffs.
MAX_DIVERGENCES = 8

MODES = ("stream", "csum", "smrec")
_MODE_NUM = {"stream": 0, "csum": 1, "smrec": 2}

#: The decode-table names shared (by value) between the engines.
_TABLE_PAIRS = (("CSUM_EXEMPT", "kCsumExempt"), ("CSUM_BODY", "kCsumBody"),
                ("HEADER_ONLY", "kHeaderOnly"))

_CPP_ARRAY_RE = r"constexpr\s+uint8_t\s+{name}\s*\[\s*\]\s*=\s*\{{([^}}]*)\}}"


# ------------------------------------------------------------- tables


@dataclass
class Tables:
    """The decode grammar, as extracted from frames.py (the oracle's and
    the generator's single source of truth)."""
    t: dict = field(default_factory=dict)      # T_* name -> value
    exempt: set = field(default_factory=set)   # values
    body: set = field(default_factory=set)
    header_only: set = field(default_factory=set)
    ctl_max: int = 0
    header: struct.Struct = struct.Struct("<BQQ")
    sub: struct.Struct = struct.Struct("<QQQ")
    rec_ring: int = 1 << 20                    # shmring.DEFAULT_RING
    decode_line: int = 1                       # frames.decode_stream anchor
    rec_line: int = 1                          # shmring decoder anchor


def _py_set_members(tree: ast.Module, name: str) -> Optional[tuple]:
    """``NAME = frozenset((T_A, T_B, ...))`` -> (set of T_ names, line)."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name \
                and isinstance(node.value, ast.Call) \
                and isinstance(node.value.func, ast.Name) \
                and node.value.func.id == "frozenset" \
                and node.value.args \
                and isinstance(node.value.args[0], (ast.Tuple, ast.List)):
            names = set()
            for elt in node.value.args[0].elts:
                if isinstance(elt, ast.Name):
                    names.add(elt.id)
                elif isinstance(elt, ast.Attribute):
                    names.add(elt.attr)
            return names, node.lineno
    return None


def _extract_tables(root: Path, out: list) -> Optional[tuple]:
    """Extract the shared decode tables from BOTH engines and diff them.
    Returns (Tables, py_sets) or None when extraction lost the surface
    (vacuity findings appended either way)."""
    f_frames = "starway_tpu_torch/core/frames.py"
    tree, err = parse_or_finding(root / f_frames, f_frames)
    if tree is None:
        out.append(err)
        return None
    consts: dict = {}
    env: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            try:
                val = ast.literal_eval(node.value)
            except (ValueError, TypeError, SyntaxError):
                # CTL_MAX-style shift expressions don't literal_eval.
                val = _fold_int(node.value, env)
            if isinstance(val, int) and not isinstance(val, bool):
                consts[name] = (val, node.lineno)
                env[name] = val
    tbl = Tables()
    tbl.t = {k: v[0] for k, v in consts.items() if k.startswith("T_")
             and k != "T_"}
    # The wire layouts come from the contract surface too (the contract
    # pass already pins them against HEADER_SIZE/SDATA_SUB_SIZE).
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in ("HEADER", "SDATA_SUB") \
                and isinstance(node.value, ast.Call) and node.value.args \
                and isinstance(node.value.args[0], ast.Constant) \
                and isinstance(node.value.args[0].value, str):
            try:
                s = struct.Struct(node.value.args[0].value)
            except struct.error:
                continue
            if node.targets[0].id == "HEADER":
                tbl.header = s
            else:
                tbl.sub = s
    py_sets: dict = {}
    for name in ("CSUM_EXEMPT", "CSUM_BODY", "HEADER_ONLY"):
        got = _py_set_members(tree, name)
        if got is None:
            out.append(Finding(
                f_frames, 1, "wire-diff",
                f"decode table {name} not found in frames.py -- the shared "
                "decode contract lost its Python side (wirefuzz would be "
                "vacuous)"))
        else:
            py_sets[name] = got
    if "CTL_MAX" not in consts:
        out.append(Finding(f_frames, 1, "wire-diff",
                           "CTL_MAX bound not found in frames.py"))
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "decode_stream":
            tbl.decode_line = node.lineno
            break
    else:
        out.append(Finding(
            f_frames, 1, "wire-diff",
            "frames.decode_stream (the Python engine's reference decoder) "
            "not found -- differential fuzzing would be vacuous"))
    f_shm = "starway_tpu_torch/core/shmring.py"
    shm_tree, shm_err = parse_or_finding(root / f_shm, f_shm)
    if shm_tree is None:
        out.append(shm_err)
    else:
        for node in ast.walk(shm_tree):
            if isinstance(node, ast.FunctionDef) \
                    and node.name == "decode_sm_records":
                tbl.rec_line = node.lineno
                break
        else:
            out.append(Finding(
                f_shm, 1, "wire-diff",
                "shmring.decode_sm_records (the slot-record reference "
                "decoder) not found -- the smrec mode would be vacuous"))
        # The record-length bound the smrec decoders share: the oracle
        # follows the tree's DEFAULT_RING; the native harness hardcodes
        # its twin, so pin it statically (the CTL_MAX precedent) --
        # corpus boundary cases make a drift fire dynamically too.
        ring = None
        ring_line = 1
        for node in shm_tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "DEFAULT_RING":
                ring = _fold_int(node.value, {})
                ring_line = node.lineno
                break
        if ring is None:
            out.append(Finding(
                f_shm, 1, "wire-diff",
                "shmring.DEFAULT_RING not found -- the smrec record "
                "bound lost its Python side (oracle would guess)"))
        else:
            tbl.rec_ring = ring
    if not tbl.t or len(py_sets) < 3 or "CTL_MAX" not in consts:
        return None
    tbl.exempt = {tbl.t[n] for n in py_sets["CSUM_EXEMPT"][0] if n in tbl.t}
    tbl.body = {tbl.t[n] for n in py_sets["CSUM_BODY"][0] if n in tbl.t}
    tbl.header_only = {tbl.t[n] for n in py_sets["HEADER_ONLY"][0]
                       if n in tbl.t}
    tbl.ctl_max = consts["CTL_MAX"][0]

    # --- cross-engine table diff (the static leg)
    cpp = extract_cpp(root)
    for py_name, cpp_name in _TABLE_PAIRS:
        if py_name not in py_sets:
            continue
        m = re.search(_CPP_ARRAY_RE.format(name=cpp_name), cpp.cpp_code)
        if m is None:
            out.append(Finding(
                cpp.cpp_file, 1, "wire-diff",
                f"{cpp_name}[] decode table not found in the native engine "
                f"(the frames.py {py_name} twin)"))
            continue
        cpp_names = set(re.findall(r"T_\w+", m.group(1)))
        names, line = py_sets[py_name]
        if cpp_names != names:
            only_py = sorted(names - cpp_names)
            only_cpp = sorted(cpp_names - names)
            out.append(Finding(
                f_frames, line, "wire-diff",
                f"decode table {py_name} disagrees with {cpp_name}[] "
                f"({cpp.cpp_file}): only-Python {only_py}, only-C++ "
                f"{only_cpp} (two engines, one decode contract)"))
    if "CTL_MAX" in cpp.constants:
        cval, cline = cpp.constants["CTL_MAX"]
        if cval != tbl.ctl_max:
            out.append(Finding(
                f_frames, consts["CTL_MAX"][1], "wire-diff",
                f"CTL_MAX = {tbl.ctl_max} but {cpp.cpp_file}:{cline} has "
                f"CTL_MAX = {cval} (the engines disagree on the ctl-body "
                "bound)"))
    elif cpp.constants:
        out.append(Finding(cpp.cpp_file, 1, "wire-diff",
                           "CTL_MAX constexpr not found in the native "
                           "engine (the frames.py CTL_MAX twin)"))
    m = re.search(r"ring_size\s*=\s*1ull\s*<<\s*(\d+)", cpp.cpp_code)
    if m is None:
        out.append(Finding(
            cpp.cpp_file, 1, "wire-diff",
            "wire_decode_recs ring_size bound not found in the native "
            "harness (the shmring.DEFAULT_RING twin)"))
    elif (1 << int(m.group(1))) != tbl.rec_ring:
        out.append(Finding(
            f_shm, ring_line, "wire-diff",
            f"shmring.DEFAULT_RING = {tbl.rec_ring} but the native "
            f"harness bounds sm records at 1<<{m.group(1)} "
            f"({cpp.cpp_file}) -- the smrec decoders disagree on the "
            "record-length bound"))

    # --- the live parser must still ALIAS the shared tables
    f_conn = "starway_tpu_torch/core/conn.py"
    conn_tree, conn_err = parse_or_finding(root / f_conn, f_conn)
    if conn_tree is None:
        out.append(conn_err)
    else:
        for local, shared in (("_CSUM_EXEMPT", "CSUM_EXEMPT"),
                              ("_CSUM_BODY", "CSUM_BODY")):
            for node in conn_tree.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id == local:
                    v = node.value
                    ok = (isinstance(v, ast.Attribute) and v.attr == shared
                          and isinstance(v.value, ast.Name)
                          and v.value.id == "frames")
                    if not ok:
                        out.append(Finding(
                            f_conn, node.lineno, "wire-diff",
                            f"{local} no longer aliases frames.{shared}: the "
                            "live parser grew a private decode table the "
                            "fuzzer (and the native twin) cannot see"))
                    break
            else:
                out.append(Finding(
                    f_conn, 1, "wire-diff",
                    f"{local} not found in conn.py -- cannot prove the live "
                    "parser shares the decode tables"))
    return tbl, py_sets


def _fold_int(node: ast.AST, env: dict) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.Name):
        v = env.get(node.id)
        return v if isinstance(v, int) else None
    if isinstance(node, ast.BinOp):
        lo, hi = _fold_int(node.left, env), _fold_int(node.right, env)
        if lo is None or hi is None:
            return None
        if isinstance(node.op, ast.LShift) and hi < 128:
            return lo << hi
        if isinstance(node.op, ast.Add):
            return lo + hi
        if isinstance(node.op, ast.Sub):
            return lo - hi
        if isinstance(node.op, ast.Mult):
            return lo * hi
    return None


# ------------------------------------------------------------- oracle
#
# An independent CRC32C and decoder: table-driven off the extracted
# grammar, sharing no code with core/frames.py.  Divergence between this
# and either engine decoder is the pass's whole point, so resist the
# urge to "reuse".

_CRC_TBL: Optional[list] = None


def _crc(data: bytes, crc: int = 0) -> int:
    global _CRC_TBL
    if _CRC_TBL is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TBL = tbl
    c = (crc & 0xFFFFFFFF) ^ 0xFFFFFFFF
    for b in data:
        c = _CRC_TBL[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _fmt(status: str, consumed: int, entries: list) -> str:
    shown = entries[:64]
    extra = len(entries) - len(shown)
    if extra > 0:
        shown.append(f"+{extra}")
    return f"{status} n={consumed} [" + " ".join(shown) + "]"


def oracle_stream(tbl: Tables, data: bytes, csum: bool) -> str:
    t = tbl.t
    hsz, ssz = tbl.header.size, tbl.sub.size
    n = len(data)
    pos = consumed = 0
    entries: list = []
    pend: Optional[tuple] = None
    accum = 0
    ctl = {t["T_HELLO"], t["T_HELLO_ACK"], t["T_DEVPULL"], t["T_RTS"]}
    while True:
        if n - pos < hsz:
            return _fmt("ok" if pos == n else "short:header",
                        consumed, entries)
        ftype, a, b = tbl.header.unpack_from(data, pos)
        if pend is not None:
            accum = _crc(data[pos:pos + hsz], accum)
        pos += hsz
        if csum:
            if ftype == t["T_CSUM"]:
                if pend is not None:
                    return _fmt("reject(nested checksum prefix)",
                                consumed, entries)
                pend = (a & 0xFFFFFFFF, b & 0xFFFFFFFF)
                accum = 0
                entries.append(f"{ftype}:{a}:{b}")
                consumed = pos
                continue
            if ftype not in tbl.exempt:
                if pend is None:
                    return _fmt("reject(frame without checksum)",
                                consumed, entries)
                if ftype != t["T_SDATA"] and accum != pend[1]:
                    return _fmt("reject(frame header checksum)",
                                consumed, entries)
                if not (ftype == t["T_SDATA"]
                        or (ftype in tbl.body and b > 0)):
                    cf, pend = pend[0], None
                    if accum != cf:
                        return _fmt("reject(frame checksum)",
                                    consumed, entries)
        if ftype == t["T_SDATA"]:
            if b <= ssz:
                return _fmt("reject(sdata sub-header)", consumed, entries)
            if n - pos < ssz:
                return _fmt("short:sub", consumed, entries)
            if pend is not None:
                accum = _crc(data[pos:pos + ssz], accum)
                if accum != pend[1]:
                    return _fmt("reject(stripe sub-header checksum)",
                                consumed, entries)
            mid, off, tot = tbl.sub.unpack_from(data, pos)
            pos += ssz
            clen = b - ssz
            if clen > n - pos:
                return _fmt("short:body", consumed, entries)
            if pend is not None:
                accum = _crc(data[pos:pos + clen], accum)
                cf, pend = pend[0], None
                if accum != cf:
                    pos += clen
                    entries.append(f"snack:{mid}:{off}")
                    consumed = pos
                    continue
            pos += clen
            entries.append(f"{ftype}:{a}:{b}:{mid}:{off}:{tot}")
            consumed = pos
            continue
        if ftype == t["T_DATA"]:
            if b:
                if b > n - pos:
                    return _fmt("short:body", consumed, entries)
                if pend is not None:
                    accum = _crc(data[pos:pos + b], accum)
                    cf, pend = pend[0], None
                    if accum != cf:
                        return _fmt("reject(payload checksum (DATA))",
                                    consumed, entries)
                pos += b
            entries.append(f"{ftype}:{a}:{b}")
            consumed = pos
            continue
        if ftype in ctl:
            if b == 0:
                return _fmt("reject(zero control body)", consumed, entries)
            if b > tbl.ctl_max:
                return _fmt("reject(oversized control body)",
                            consumed, entries)
            if b > n - pos:
                return _fmt("short:body", consumed, entries)
            if pend is not None:
                accum = _crc(data[pos:pos + b], accum)
                cf, pend = pend[0], None
                if accum != cf:
                    return _fmt("reject(control body checksum)",
                                consumed, entries)
            pos += b
            entries.append(f"{ftype}:{a}:{b}")
            consumed = pos
            continue
        if ftype in tbl.header_only:
            entries.append(f"{ftype}:{a}:{b}")
            consumed = pos
            continue
        return _fmt("reject(unknown frame type)", consumed, entries)


_REC = struct.Struct("<II")  # shmring slot record: u32 len, u32 crc
_SEQ8 = struct.Struct("<Q")


def oracle_recs(tbl: Tables, data: bytes) -> str:
    n = len(data)
    pos = consumed = seq = 0
    entries: list = []
    while True:
        if n - pos == 0:
            return _fmt("ok", consumed, entries)
        if n - pos < _REC.size:
            return _fmt("short:rec-header", consumed, entries)
        ln, crc = _REC.unpack_from(data, pos)
        if ln == 0 or ln > tbl.rec_ring:
            return _fmt("reject(sm record header)", consumed, entries)
        if pos + _REC.size + ln > n:
            return _fmt("short:rec-body", consumed, entries)
        accum = _crc(data[pos + _REC.size:pos + _REC.size + ln],
                     _crc(_SEQ8.pack(seq)))
        if accum != crc:
            return _fmt("reject(sm record checksum)", consumed, entries)
        seq += 1
        pos += _REC.size + ln
        consumed = pos
        entries.append(f"r:{ln}")


# ----------------------------------------------------- dynamic targets


def _load_target_modules(root: Path):
    """Load the tree-under-check's frames.py + shmring.py as a throwaway
    package (mutated copies honoured; never the installed starway_tpu_torch).
    Returns (frames_mod, shmring_mod, cleanup_names)."""
    pkgname = "_swfuzz_" + uuid.uuid4().hex
    core = root / "starway_tpu_torch" / "core"
    pkg = types.ModuleType(pkgname)
    pkg.__path__ = [str(core)]
    sys.modules[pkgname] = pkg
    names = [pkgname]
    mods = []
    for sub in ("frames", "shmring"):
        full = f"{pkgname}.{sub}"
        spec = importlib.util.spec_from_file_location(full, core / f"{sub}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        names.append(full)
        spec.loader.exec_module(mod)
        mods.append(mod)
    return mods[0], mods[1], names


_NATIVE_CACHE: dict = {}
#: artifact path -> why it could not be loaded (the wire-diff finding).
_NATIVE_ERRORS: dict = {}


def _load_native(root: Path):
    """The tree's engine artifact with the sw_wire_decode export, built
    from the tree's own engine copy by native_build when it is missing
    or older than its sources; None when it cannot be built or loaded,
    with the reason in _NATIVE_ERRORS."""
    from .. import native_build

    so = native_build.artifact(root)
    key = str(so)
    if key in _NATIVE_CACHE:
        return _NATIVE_CACHE[key]
    lib = None
    try:
        native_build.ensure_built(root=root)
        cand = ctypes.CDLL(str(so))
        if hasattr(cand, "sw_wire_decode"):
            cand.sw_wire_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int,
            ]
            lib = cand
        else:
            _NATIVE_ERRORS[key] = "the artifact has no sw_wire_decode export"
    except (OSError, RuntimeError) as e:
        _NATIVE_ERRORS[key] = str(e)
    _NATIVE_CACHE[key] = lib
    return lib


def _native_decode(lib, data: bytes, mode: str) -> str:
    out = ctypes.create_string_buffer(1 << 16)
    lib.sw_wire_decode(data, len(data), _MODE_NUM[mode], out, len(out))
    return out.value.decode("utf-8", "replace")


# ---------------------------------------------------------- generator


def _gen_frame(rng, tbl: Tables, csum: bool) -> bytes:
    """One structurally valid frame (with its T_CSUM prefix when the
    mode demands one)."""
    t = tbl.t
    kind = rng.randrange(6)
    if kind == 0:  # DATA
        body = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 24)))
        frame = tbl.header.pack(t["T_DATA"], rng.randrange(1 << 16),
                                len(body))
        payload = body
    elif kind == 1:  # striped chunk
        clen = rng.randrange(1, 24)
        mid, off, tot = rng.randrange(1, 8), rng.randrange(0, 64), 64
        frame = (tbl.header.pack(t["T_SDATA"], rng.randrange(1 << 16),
                                 tbl.sub.size + clen)
                 + tbl.sub.pack(mid, off, tot))
        payload = bytes(rng.randrange(256) for _ in range(clen))
    elif kind == 2:  # ctl (JSON-ish body)
        ftype = rng.choice((t["T_HELLO"], t["T_HELLO_ACK"], t["T_DEVPULL"],
                            t["T_RTS"]))
        body = b'{"k":"' + bytes(0x61 + rng.randrange(26)
                                 for _ in range(rng.randrange(1, 12))) + b'"}'
        frame = tbl.header.pack(ftype, rng.randrange(1 << 8), len(body))
        payload = body
    else:  # header-only ctl plane
        ftype = rng.choice(sorted(tbl.header_only))
        frame = tbl.header.pack(ftype, rng.randrange(1 << 8),
                                rng.randrange(1 << 4))
        payload = b""
    if csum and frame[0] not in tbl.exempt:
        head_len = tbl.header.size
        if frame[0] == tbl.t["T_SDATA"]:
            head_len += tbl.sub.size
        ch = _crc(frame[:head_len])
        cf = _crc(frame[head_len:] + payload, ch)
        return tbl.header.pack(t["T_CSUM"], cf, ch) + frame + payload
    return frame + payload


def _gen_record(rng, seq: int) -> bytes:
    body = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 24)))
    crc = _crc(body, _crc(_SEQ8.pack(seq)))
    return _REC.pack(len(body), crc) + body


def gen_case(tbl: Tables, mode: str, seed: int) -> bytes:
    """Deterministic adversarial input for ``seed``: a valid script of
    frames/records, then zero or more structure-aware mutations."""
    import random

    rng = random.Random((seed << 2) | _MODE_NUM[mode])
    if mode == "smrec":
        buf = bytearray(b"".join(_gen_record(rng, i)
                                 for i in range(rng.randrange(1, 4))))
    else:
        buf = bytearray(b"".join(_gen_frame(rng, tbl, mode == "csum")
                                 for _ in range(rng.randrange(1, 4))))
    for _ in range(rng.randrange(0, 3)):
        op = rng.randrange(6)
        if not buf:
            break
        if op == 0:    # flip one byte
            buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
        elif op == 1:  # truncate
            del buf[rng.randrange(len(buf)):]
        elif op == 2:  # rewrite a length field (header offset 9..16)
            if len(buf) >= tbl.header.size:
                b = rng.choice((0, 1, tbl.sub.size, tbl.sub.size + 1,
                                tbl.ctl_max, tbl.ctl_max + 1,
                                (1 << 63) - 1, (1 << 64) - 1))
                struct.pack_into("<Q", buf, 9, b)
        elif op == 3:  # rewrite a type byte at a frame-ish offset
            buf[0] = rng.randrange(256)
        elif op == 4:  # duplicate a slice
            i = rng.randrange(len(buf))
            j = rng.randrange(i, min(len(buf), i + 40) + 1)
            buf[i:i] = buf[i:j]
        else:          # zero a span
            i = rng.randrange(len(buf))
            j = rng.randrange(i, min(len(buf), i + 16) + 1)
            buf[i:j] = bytes(j - i)
    return bytes(buf[:4096])


# ------------------------------------------------------------- corpus


def corpus_path(root: Optional[Path] = None) -> Path:
    """The tree-under-check's corpus when it carries one (so seeded
    mutations in tests/test_swcheck.py are honoured), else this
    package's checked-in copy."""
    if root is not None:
        cand = root / "starway_tpu_torch" / "analysis" / "wirefuzz_corpus.txt"
        if cand.is_file():
            return cand
    return Path(__file__).resolve().parent / "wirefuzz_corpus.txt"


def load_corpus(out: list, root: Optional[Path] = None) -> list:
    """[(label, mode, seed_or_bytes)] from the checked-in corpus file
    (``hex`` pins exact bytes, ``-`` meaning zero of them; ``seed`` pins
    generator cases).  Format errors and a shrunken corpus are findings,
    not skips."""
    path = corpus_path(root)
    rel = "starway_tpu_torch/analysis/wirefuzz_corpus.txt"
    cases: list = []
    if not path.is_file():
        out.append(Finding(rel, 1, "wire-diff",
                           "regression corpus missing -- the gate would "
                           "replay nothing"))
        return cases
    for i, line in enumerate(path.read_text().splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(None, 2)
        if len(parts) < 3 or parts[0] not in ("seed", "hex") \
                or parts[1] not in MODES:
            out.append(Finding(rel, i, "wire-diff",
                               f"malformed corpus line: {line[:60]!r}"))
            continue
        kind, mode, rest = parts
        rest = rest.split()[0]
        if kind == "seed":
            try:
                cases.append((f"corpus:{i}", mode, int(rest)))
            except ValueError:
                out.append(Finding(rel, i, "wire-diff",
                                   f"malformed corpus seed: {rest!r}"))
        else:
            try:
                cases.append((f"corpus:{i}", mode,
                              b"" if rest == "-" else bytes.fromhex(rest)))
            except ValueError:
                out.append(Finding(rel, i, "wire-diff",
                                   f"malformed corpus hex: {rest[:40]!r}"))
    if len(cases) < CORPUS_FLOOR:
        out.append(Finding(
            rel, 1, "wire-diff",
            f"regression corpus holds {len(cases)} cases -- below the "
            f"{CORPUS_FLOOR}-case floor (corpus truncated?)"))
    return cases


# ---------------------------------------------------------------- run


def _outcome(fn, *args) -> str:
    """A decoder RAISING on adversarial bytes is itself an outcome (and
    a divergence when the others reject cleanly) -- render it instead of
    letting the exception kill the whole pass."""
    try:
        return fn(*args)
    except Exception as e:
        return f"crash({type(e).__name__})"


def _diff_case(tbl: Tables, frames_mod, shm_mod, lib, label: str,
               mode: str, data: bytes, out: list, counts: dict) -> None:
    if mode == "smrec":
        want = _outcome(oracle_recs, tbl, data)
        got_py = _outcome(shm_mod.decode_sm_records, data)
        anchor = ("starway_tpu_torch/core/shmring.py", tbl.rec_line)
    else:
        want = _outcome(oracle_stream, tbl, data, mode == "csum")
        got_py = _outcome(
            lambda: frames_mod.decode_stream(data, csum=(mode == "csum")))
        anchor = ("starway_tpu_torch/core/frames.py", tbl.decode_line)
    hexs = data.hex()
    if len(hexs) > 96:
        hexs = hexs[:96] + f"..({len(data)}B)"
    if got_py != want:
        counts["divergences"] += 1
        out.append(Finding(
            anchor[0], anchor[1], "wire-diff",
            f"[{label} mode={mode}] Python decoder diverges from the "
            f"grammar oracle on {hexs}: oracle {want!r} != python "
            f"{got_py!r} (replay: analysis/wirefuzz.py)"))
        return  # don't double-report the same bytes against native
    if lib is not None:
        got_nat = _native_decode(lib, data, mode)
        if got_nat != want:
            counts["divergences"] += 1
            out.append(Finding(
                "starway_tpu_torch/native/sw_engine.cpp", 1, "wire-diff",
                f"[{label} mode={mode}] native sw_wire_decode diverges on "
                f"{hexs}: oracle {want!r} != native {got_nat!r} "
                "(replay: analysis/wirefuzz.py; rebuild the engine if the "
                "artifact is stale)"))


def fuzz(root: Path, tbl: Tables, out: list,
         seeds_per_mode: Optional[int] = None) -> dict:
    """Replay the corpus, then run ``seeds_per_mode`` fresh seeds per
    mode, diffing oracle vs Python vs native on every case.  Returns
    ``{"cases", "divergences", "native"}``."""
    if seeds_per_mode is None:
        try:
            seeds_per_mode = int(os.environ.get("SWCHECK_WIREFUZZ_SEEDS",
                                                QUICK_SEEDS))
        except ValueError:
            seeds_per_mode = QUICK_SEEDS
    counts = {"cases": 0, "divergences": 0, "native": False}
    try:
        frames_mod, shm_mod, names = _load_target_modules(root)
    except Exception as e:
        out.append(Finding(
            "starway_tpu_torch/core/frames.py", 1, "wire-diff",
            f"cannot load the tree's reference decoders: {e} "
            "(differential fuzzing would be vacuous)"))
        return counts
    try:
        if not hasattr(frames_mod, "decode_stream") \
                or not hasattr(shm_mod, "decode_sm_records"):
            return counts  # vacuity findings already appended by tables
        lib = _load_native(root)
        counts["native"] = lib is not None
        if lib is None:
            from .. import native_build

            so = native_build.artifact(root)
            out.append(Finding(
                "starway_tpu_torch/native/sw_engine.cpp", 1, "wire-diff",
                f"the native leg cannot run: {so} "
                f"({_NATIVE_ERRORS.get(str(so), 'not loaded')}) -- only "
                "two of the three decoders would be diffed"))
        cases = load_corpus(out, root)
        for seed in range(seeds_per_mode):
            for mode in MODES:
                cases.append((f"seed:{seed}", mode, seed))
        for label, mode, case in cases:
            if counts["divergences"] >= MAX_DIVERGENCES:
                out.append(Finding(
                    "starway_tpu_torch/core/frames.py", tbl.decode_line,
                    "wire-diff",
                    f"stopped after {MAX_DIVERGENCES} decoder divergences "
                    "-- the decode contract is systemically split (fix the "
                    "first finding and re-run)"))
                break
            try:
                data = case if isinstance(case, bytes) \
                    else gen_case(tbl, mode, case)
            except Exception as e:
                # The generator packs with the extracted layouts; it can
                # only fail when the grammar itself drifted under a
                # seeded mutation -- report once, don't die.
                if not counts.get("gen_error"):
                    counts["gen_error"] = True
                    out.append(Finding(
                        "starway_tpu_torch/core/frames.py", tbl.decode_line,
                        "wire-diff",
                        f"case generator failed on the extracted grammar "
                        f"({type(e).__name__}: {e}) -- the wire layout "
                        "drifted out from under the fuzzer"))
                continue
            counts["cases"] += 1
            _diff_case(tbl, frames_mod, shm_mod, lib, label, mode, data,
                       out, counts)
    finally:
        for name in names:
            sys.modules.pop(name, None)
    return counts


def minimize_corpus(root: Path) -> dict:
    """Dedup the regression corpus in place by canonical-outcome
    signature (``(mode, grammar-oracle outcome)``): the oracle IS the
    contract, so two seeds it maps to the same outcome exercise the same
    decode behaviour and one suffices.  Every ``hex`` case is a pinned
    divergence (each carries its ``# why`` note) and is always kept --
    their outcomes also seed the duplicate set, so a generator seed
    shadowing a pin drops.  Comment lines survive verbatim, and if
    dedup would shrink the corpus below the CORPUS_FLOOR replay floor,
    dropped seeds are padded back (first-dropped first) under a marker
    comment.  Returns a summary dict for the CLI."""
    out: list = []
    got = _extract_tables(root, out)
    if got is None or out:
        raise SystemExit(
            "wirefuzz: cannot minimize -- grammar extraction failed:\n"
            + "\n".join(f.render() for f in out))
    tbl, _sets = got
    path = corpus_path(root)
    lines = path.read_text().splitlines()

    def signature(mode: str, data: bytes) -> tuple:
        if mode == "smrec":
            return (mode, _outcome(oracle_recs, tbl, data))
        return (mode, _outcome(oracle_stream, tbl, data, mode == "csum"))

    parsed = []
    for line in lines:
        s = line.strip()
        kind = mode = tok = None
        if s and not s.startswith("#"):
            parts = s.split(None, 2)
            if len(parts) >= 3 and parts[0] in ("seed", "hex") \
                    and parts[1] in MODES:
                kind, mode, tok = parts[0], parts[1], parts[2].split()[0]
        parsed.append((line, kind, mode, tok))

    seen: set = set()
    for _, kind, mode, tok in parsed:
        if kind == "hex":
            try:
                seen.add(signature(
                    mode, b"" if tok == "-" else bytes.fromhex(tok)))
            except ValueError:
                pass  # load_corpus flags malformed pins; keep them as-is

    kept: list = []
    dropped: list = []
    before = after = hex_kept = 0
    for line, kind, mode, tok in parsed:
        if kind is None:
            kept.append(line)
            continue
        before += 1
        if kind == "hex":
            hex_kept += 1
            kept.append(line)
            after += 1
            continue
        try:
            key = signature(mode, gen_case(tbl, mode, int(tok)))
        except Exception:
            kept.append(line)  # unparseable seed: a finding, not a drop
            after += 1
            continue
        if key in seen:
            dropped.append(line)
        else:
            seen.add(key)
            kept.append(line)
            after += 1
    if after < CORPUS_FLOOR and dropped:
        refill = dropped[:CORPUS_FLOOR - after]
        kept.append("# floor padding: outcome-duplicate seeds retained to "
                    f"keep the corpus at the {CORPUS_FLOOR}-case replay "
                    "floor")
        kept.extend(refill)
        after += len(refill)
    path.write_text("\n".join(kept) + "\n")
    return {"path": str(path), "before": before, "after": after,
            "hex_kept": hex_kept, "floor": CORPUS_FLOOR}


def run(root: Path) -> list:
    out: list = []
    got = _extract_tables(root, out)
    if got is None:
        return out
    tbl, _sets = got
    fuzz(root, tbl, out)
    return out
