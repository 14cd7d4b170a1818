"""On-demand build of the native engine for this package.

The C++ engine is a plain shared object with a C interface, driven through
ctypes by ``core/native.py``.  This package keeps its own copy of the
engine's source (``starway_tpu_torch/native/sw_engine.{cpp,h}``, the
JAX package's ``native/`` one with the pull negotiated under "cudaipc")
and compiles it with g++ into ``build/starway_tpu_torch/_sw_native.so``
under the repository root (:func:`build_dir`: in an installed tree, the
package's own ``_build/``) the first time the engine is asked for,
rebuilding it when the source is newer than the artifact.  It never loads
the JAX package's build, whose artifact and lock live elsewhere.

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
_SRC = _ROOT / "starway_tpu_torch" / "native" / "sw_engine.cpp"
_HDR = _ROOT / "starway_tpu_torch" / "native" / "sw_engine.h"


def build_dir(root=None) -> Path:
    """Where the package's builds go (the engine's copy here, the CUDA
    kernels in ops/_build.py): ``build/starway_tpu_torch/`` under the root
    of a checkout or an unpacked sdist (``root``, default the tree this
    package lives in, with its ``pyproject.toml``); in an installed tree,
    whose parent is ``site-packages``, ``_build/`` inside the package."""
    if root is not None or (_ROOT / "pyproject.toml").exists():
        return Path(_ROOT if root is None else root) / "build" / \
            "starway_tpu_torch"
    return _ROOT / "starway_tpu_torch" / "_build"


_OUT = build_dir() / "_sw_native.so"
_LOG = _OUT.with_name("_sw_native.build.log")
_LOCK = _OUT.with_name("_sw_native.lock")

_BUILD_TIMEOUT_S = 300


def artifact(root=None) -> Path:
    """The engine artifact of the tree at ``root`` (default: the tree this
    package lives in): ``_sw_native.so`` in its :func:`build_dir`."""
    if root is None:
        return _OUT
    return build_dir(root) / "_sw_native.so"


def _sources(root=None) -> tuple:
    if root is None:
        return _SRC, _HDR
    native = Path(root) / "starway_tpu_torch" / "native"
    return native / "sw_engine.cpp", native / "sw_engine.h"


def _fresh(root=None) -> bool:
    src, hdr = _sources(root)
    out = artifact(root)
    return (src.exists() and hdr.exists() and out.exists()
            and out.stat().st_mtime >= max(src.stat().st_mtime,
                                           hdr.stat().st_mtime))


def prebuilt() -> "Path | None":
    """The artifact if it exists and is fresh, else None -- NEVER compiles
    (for callers on the connection-setup path)."""
    return _OUT if _fresh() else None


def _tail(log: Path, cmd: list, out: str) -> str:
    """Write the build transcript to the log and return its tail."""
    try:
        log.write_text(f"$ {' '.join(cmd)}\n{out}\n")
    except OSError:
        pass  # the tail in the exception still names the failure
    return out.strip()[-4000:]


def ensure_built(force: bool = False, root=None) -> Path:
    """Compile the engine's copy into the artifact unless it is fresh;
    returns its path.  ``root`` names another tree (a checkout or a copy
    under test) whose own engine copy is built into its own ``build/``."""
    src, hdr = _sources(root)
    out_path = artifact(root)
    log = out_path.with_name(_LOG.name)
    for path in (src, hdr):
        if not path.exists():
            raise FileNotFoundError(f"native source missing: {path}")
    if not force and _fresh(root):
        return out_path
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path.with_name(_LOCK.name), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not force and _fresh(root):
            return out_path  # another process built it while this one waited
        tmp = out_path.with_suffix(f".tmp.{os.getpid()}.so")
        # -lrt: shm_open/shm_unlink live in librt on glibc < 2.34.
        cmd = ["g++", "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
               "-Wall", "-Wextra", str(src), "-o", str(tmp), "-lrt"]
        try:
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=_BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(
                    f"native build timed out after {_BUILD_TIMEOUT_S}s "
                    f"(log: {log})") from e
            except OSError as e:  # g++ missing or not executable
                raise RuntimeError(
                    f"native build could not start ({e}); is a C++ "
                    f"toolchain installed?") from e
            tail = _tail(log, cmd, proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native build failed with exit code {proc.returncode} "
                    f"(log: {log})\n{tail}")
            os.replace(tmp, out_path)
        finally:
            tmp.unlink(missing_ok=True)
    return out_path


if __name__ == "__main__":
    print(ensure_built(force=True))
