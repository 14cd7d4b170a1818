"""On-demand build of the native engine for this package.

The C++ engine (``native/sw_engine.cpp`` at the repository root) is a plain
shared object with a C interface, driven through ctypes by
``core/native.py``.  This package compiles its own copy with g++ into
``build/starway_tpu_torch/_sw_native.so`` under the repository root the
first time the engine is asked for, and rebuilds it when the source is
newer than the artifact.  It never loads the JAX package's build.

Concurrent processes (test workers, ranks) build once: the build runs under
an exclusive ``fcntl`` lock beside the artifact, and a process that waited
on the lock finds the fresh artifact and returns it.  Each build's compiler
output goes to ``_sw_native.build.log`` beside the artifact; a failure
raises with the output's tail and the log's path.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
_SRC = _ROOT / "native" / "sw_engine.cpp"
_HDR = _ROOT / "native" / "sw_engine.h"
_OUT = _ROOT / "build" / "starway_tpu_torch" / "_sw_native.so"
_LOG = _OUT.with_name("_sw_native.build.log")
_LOCK = _OUT.with_name("_sw_native.lock")

_BUILD_TIMEOUT_S = 300


def _fresh() -> bool:
    return (_SRC.exists() and _HDR.exists() and _OUT.exists()
            and _OUT.stat().st_mtime >= max(_SRC.stat().st_mtime,
                                            _HDR.stat().st_mtime))


def prebuilt() -> "Path | None":
    """The artifact if it exists and is fresh, else None -- NEVER compiles
    (for callers on the connection-setup path)."""
    return _OUT if _fresh() else None


def _tail(cmd: list, out: str) -> str:
    """Write the build transcript to the log and return its tail."""
    try:
        _LOG.write_text(f"$ {' '.join(cmd)}\n{out}\n")
    except OSError:
        pass  # the tail in the exception still names the failure
    return out.strip()[-4000:]


def ensure_built(force: bool = False) -> Path:
    """Compile native/sw_engine.cpp into the artifact unless it is fresh;
    returns its path."""
    for src in (_SRC, _HDR):
        if not src.exists():
            raise FileNotFoundError(f"native source missing: {src}")
    if not force and _fresh():
        return _OUT
    _OUT.parent.mkdir(parents=True, exist_ok=True)
    with open(_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not force and _fresh():
            return _OUT  # another process built it while this one waited
        tmp = _OUT.with_suffix(f".tmp.{os.getpid()}.so")
        # -lrt: shm_open/shm_unlink live in librt on glibc < 2.34.
        cmd = ["g++", "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
               "-Wall", "-Wextra", str(_SRC), "-o", str(tmp), "-lrt"]
        try:
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=_BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(
                    f"native build timed out after {_BUILD_TIMEOUT_S}s "
                    f"(log: {_LOG})") from e
            except OSError as e:  # g++ missing or not executable
                raise RuntimeError(
                    f"native build could not start ({e}); is a C++ "
                    f"toolchain installed?") from e
            tail = _tail(cmd, proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native build failed with exit code {proc.returncode} "
                    f"(log: {_LOG})\n{tail}")
            os.replace(tmp, _OUT)
        finally:
            tmp.unlink(missing_ok=True)
    return _OUT


if __name__ == "__main__":
    print(ensure_built(force=True))
