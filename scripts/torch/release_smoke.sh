#!/bin/bash
# The release pipeline of the PyTorch/CUDA port, run once, locally: the
# twin of scripts/release_smoke.sh's nine steps for starway_tpu_torch.
# Build the sdist, check that it ships the port's sources and tests and no
# binary, build a wheel from the unpacked sdist and install it into a
# fresh venv, build the CUDA kernels and the C++ engine's copy at first use
# from the INSTALLED tree, then run the card's kernel tests and the
# transport's smoke, fault, session-chaos and integrity slices from the
# sdist tree with the venv's interpreter.
#
# Offline by construction: the builds use the system setuptools
# (--no-isolation, or `pip wheel --no-build-isolation` where the `build`
# module is missing), the venv sees the system's packages, and pip installs
# the local wheel with --no-deps.  No step imports jax: the tests run with
# STARWAY_TEST_REAL_TPU=1, which keeps tests/conftest.py from importing it.
#
# Usage: bash scripts/torch/release_smoke.sh [--device cpu] [workdir]
#        (default workdir ${TMPDIR:-/tmp}/sw_release_torch)
# On the card (the default) every step runs.  --device cpu skips only the
# nvcc build of the kernels and the cuda-marked tests, and says so.
set -euo pipefail
cd "$(dirname "$0")/../.."
DEVICE=cuda
if [ "${1:-}" = "--device" ]; then DEVICE="$2"; shift 2; fi
case "$DEVICE" in cuda|cpu) ;; *) echo "--device cuda|cpu" >&2; exit 2 ;; esac
if [ "$DEVICE" = "cuda" ] && ! python -c "import torch, sys; sys.exit(not torch.cuda.is_available())"; then
  echo "release_smoke: no CUDA device; pass --device cpu to run every step" \
       "but the kernels' build and the cuda-marked tests" >&2
  exit 2
fi
WORK="${1:-${TMPDIR:-/tmp}/sw_release_torch}"
rm -rf "$WORK"
mkdir -p "$WORK"
WORK="$(cd "$WORK" && pwd)"   # later steps cd around; must be absolute
export STARWAY_TEST_REAL_TPU=1
if python -c "import build" 2>/dev/null; then HAVE_BUILD=1; else HAVE_BUILD=0; fi
T0=$SECONDS

echo "== 1/9 the port's gate (python -m starway_tpu_torch.analysis)"
python -m starway_tpu_torch.analysis

echo "== 2/9 sdist build"
if [ "$HAVE_BUILD" = "1" ]; then
  python -m build --sdist --no-isolation --outdir "$WORK/dist" . >"$WORK/build.log" 2>&1 \
    || { tail -20 "$WORK/build.log"; exit 1; }
else
  python setup.py -q sdist -d "$WORK/dist" >"$WORK/build.log" 2>&1 \
    || { tail -20 "$WORK/build.log"; exit 1; }
fi
SDIST="$(ls "$WORK"/dist/*.tar.gz)"
echo "   $SDIST"

echo "== 3/9 sdist completeness (the port's sources, tests and scripts ship)"
tar tzf "$SDIST" | sed 's|^[^/]*/||' | sort > "$WORK/filelist"
NEED="starway_tpu_torch/native/sw_engine.cpp starway_tpu_torch/native/sw_engine.h
starway_tpu_torch/native_build.py starway_tpu_torch/ops/_build.py
starway_tpu_torch/analysis/__main__.py tests/conftest.py tests/torch_port_util.py
scripts/torch/session_chaos.py scripts/torch/kernel_bench.py
scripts/torch/collect_baseline.py scripts/torch/onchip_refresh.sh"
NEED="$NEED $(cd starway_tpu_torch && ls csrc/*.cu csrc/*.cuh analysis/*.txt | sed 's|^|starway_tpu_torch/|')"
NEED="$NEED $(ls tests/test_torch_*.py)"
for f in $NEED; do
  grep -qx "$f" "$WORK/filelist" || { echo "MISSING from sdist: $f"; exit 1; }
done
if grep -Eq '(^|/)(libkernels|_sw_native)\.so$' "$WORK/filelist"; then
  echo "sdist ships a prebuilt binary (libkernels.so or _sw_native.so): it must not"
  exit 1
fi
echo "   $(wc -l < "$WORK/filelist") files; $(echo $NEED | wc -w) required present, no prebuilt .so"

echo "== 4/9 wheel built FROM the sdist tree; installed into a fresh venv"
mkdir -p "$WORK/src"
tar xzf "$SDIST" -C "$WORK/src" --strip-components=1
if [ "$HAVE_BUILD" = "1" ]; then
  python -m build --wheel --no-isolation --outdir "$WORK/dist" "$WORK/src" \
    >>"$WORK/build.log" 2>&1 || { tail -20 "$WORK/build.log"; exit 1; }
else
  python -m pip wheel --no-deps --no-build-isolation -w "$WORK/dist" "$WORK/src" \
    >>"$WORK/build.log" 2>&1 || { tail -20 "$WORK/build.log"; exit 1; }
fi
WHEEL="$(ls "$WORK"/dist/*.whl)"
if python -c "import re, sys, zipfile; sys.exit(not any(re.search(r'(libkernels|_sw_native)\.so$', n) for n in zipfile.ZipFile(sys.argv[1]).namelist()))" "$WHEEL"; then
  echo "the wheel ships a prebuilt binary of the port: it must not"; exit 1
fi
python -m venv --system-site-packages --without-pip "$WORK/venv"
VPY="$WORK/venv/bin/python"
# --system-site-packages chains to the BASE interpreter; where this one runs
# from a venv of its own, its site-packages (torch, numpy, pytest, pip) are
# bridged by a .pth file: offline, nothing installed.
HOST_SITE="$(python -c 'import sysconfig; print(sysconfig.get_paths()["purelib"])')"
VENV_SITE="$("$VPY" -c 'import sysconfig; print(sysconfig.get_paths()["purelib"])')"
echo "$HOST_SITE" > "$VENV_SITE/_host_site.pth"
"$VPY" -m pip install --no-deps --quiet "$WHEEL"
# From a NEUTRAL cwd: the checkout on sys.path would shadow the install.
(cd "$WORK" && SW_WORK="$WORK" "$VPY" - <<'PY'
import os
import starway_tpu_torch
from starway_tpu_torch import Client, DeviceBuffer, Server
assert starway_tpu_torch.__file__.startswith(os.environ["SW_WORK"]), starway_tpu_torch.__file__
print("   installed import ok:", starway_tpu_torch.__file__)
PY
)

echo "== 5/9 the engine's copy and the CUDA kernels built at first use from the installed tree"
(cd "$WORK" && SW_WORK="$WORK" SW_DEVICE="$DEVICE" "$VPY" - <<'PY'
import os
from starway_tpu_torch import native_build
from starway_tpu_torch.core import native
from starway_tpu_torch.ops import _build

work = os.environ["SW_WORK"]
so = native_build.ensure_built()
assert str(so).startswith(work) and "site-packages" in str(so), so
assert native.available(), "the installed engine copy failed to load"
print("   engine copy built and loaded:", so)
if os.environ["SW_DEVICE"] == "cuda":
    lib = _build.build(force=True)
    assert str(lib).startswith(work) and "site-packages" in str(lib), lib
    _build.library()
    print(f"   kernels built in {_build.build_seconds:.1f} s and loaded:", lib)
else:
    print("   SKIPPED (--device cpu): the nvcc build of the kernels;",
          "they would build into", _build.BUILD_DIR)
PY
)
if [ "$DEVICE" = "cuda" ]; then
  echo "   the kernels against their plain versions on the card, from the sdist tree"
  (cd "$WORK/src" && "$VPY" -m pytest -m cuda tests/test_torch_cuda.py -q -p no:cacheprovider)
else
  echo "   SKIPPED (--device cpu): tests/test_torch_cuda.py, cuda-marked"
fi

echo "== 6/9 smoke tests from the sdist tree on the venv interpreter"
(cd "$WORK/src" && "$VPY" -m pytest tests/test_torch_transport.py -q -p no:cacheprovider \
    -k "inproc or worker_address or evaluate_perf or op_before")

echo "== 7/9 fault-injection smoke (drop + partition, small payloads)"
(cd "$WORK/src" && "$VPY" -m pytest tests/test_torch_faults.py -q -m "not slow" \
    -p no:cacheprovider -k "drop or partition or repost")

echo "== 8/9 session-chaos smoke (resets mid-burst, exactly-once oracle)"
(cd "$WORK/src" && "$VPY" scripts/torch/session_chaos.py --cycles 3)
(cd "$WORK/src" && "$VPY" scripts/torch/session_chaos.py --cycles 3 \
    --server-engine native --client-engine native)
(cd "$WORK/src" && "$VPY" scripts/torch/session_chaos.py --overload \
    --clients 8 --cycles 2 --n 8)

echo "== 9/9 integrity smoke (STARWAY_INTEGRITY=1)"
(cd "$WORK/src" && STARWAY_INTEGRITY=1 "$VPY" -m pytest -q -p no:cacheprovider \
    tests/test_torch_transport.py tests/test_torch_faults.py -m "not slow" \
    -k "test_client_to_server_send_recv or message_integrity or corrupt_mode")
(cd "$WORK/src" && "$VPY" scripts/torch/session_chaos.py --corrupt --cycles 3)

echo "   wall $((SECONDS - T0)) s"
echo "RELEASE SMOKE: OK ($SDIST, device $DEVICE)"
