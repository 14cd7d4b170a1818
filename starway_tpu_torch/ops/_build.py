"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface,
``build/starway_tpu_torch/libkernels.so`` under the repository root, the
first time a kernel is used.  The sources compile in parallel (one
``nvcc`` each, all started together) and link once.  A stamp beside the
library holds a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.

The library is bound with ``ctypes``: every pointer and the stream are
``c_void_p``, every size ``c_int``, and every entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises when that is
not 0.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "starway_tpu_torch"
LIB_NAME = "libkernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> (argument types, return type); the launchers return the launch's
# cudaError_t.
SIGNATURES = {
    "sw_decode_attention": ([P] * 10 + [I] * 9 + [F, I, P], ctypes.c_int),
    "sw_decode_attention_smem": ([I, I], ctypes.c_size_t),
    "sw_flash_fwd": ([P] * 5 + [I] * 8 + [F, I, P], ctypes.c_int),
    "sw_flash_bwd_dkv": ([P] * 8 + [I] * 10 + [F, I, P], ctypes.c_int),
    "sw_flash_bwd_dq": ([P] * 7 + [I] * 10 + [F, I, P], ctypes.c_int),
    "sw_int8_matmul": ([P] * 4 + [I] * 5 + [P], ctypes.c_int),
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall seconds of the last build in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> Path:
    """Compile the kernels unless an up-to-date library exists; returns
    its path.  Raises ``RuntimeError`` with nvcc's output on failure."""
    global build_seconds
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "libkernels.sha256"
    digest = _digest()
    if (not force and lib.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
                 str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    stamp.write_text(digest + "\n")
    build_seconds = time.perf_counter() - t0
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_ptr(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
