"""Release-artifact completeness of the port, the twin of
tests/test_packaging.py: the sdist ships the port's CUDA sources, its
copy of the C++ engine, the analysis gate's corpora, its tests and its
scripts, and no binary built here (``libkernels.so``, ``_sw_native.so``).
scripts/torch/release_smoke.sh runs the whole pipeline (sdist, wheel, a
fresh venv, the builds at first use from the installed tree, the smoke
slices); this pins the file list, so that a MANIFEST.in regression fails
here rather than at release time.

The sdist is built from a copy of the tree without what .gitignore
lists (build outputs), so that the build's metadata never lands in the checkout beside a
concurrent build of tests/test_packaging.py."""

import shutil
import subprocess
import sys
import tarfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "starway_tpu_torch"


@pytest.fixture(scope="module")
def sdist_names(tmp_path_factory):
    pytest.importorskip("build")
    src = tmp_path_factory.mktemp("src") / "tree"
    ignored = [line.strip().rstrip("/") for line in
               (REPO / ".gitignore").read_text().splitlines()
               if line.strip() and not line.startswith("#")]
    shutil.copytree(REPO, src,
                    ignore=shutil.ignore_patterns(".git", *ignored))
    out = tmp_path_factory.mktemp("dist")
    r = subprocess.run(
        [sys.executable, "-m", "build", "--sdist", "--no-isolation",
         "--outdir", str(out), str(src)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    (sdist,) = out.glob("*.tar.gz")
    with tarfile.open(sdist) as tf:
        return {n.split("/", 1)[1] for n in tf.getnames() if "/" in n}


def _rel(paths) -> set:
    return {p.relative_to(REPO).as_posix() for p in paths}


def test_sdist_ships_native_sources(sdist_names):
    """The kernels' CUDA sources and the engine's copy build at first use,
    so they ship, with the two modules that build them."""
    need = _rel(list((PORT / "csrc").glob("*.cu"))
                + list((PORT / "csrc").glob("*.cuh"))) | {
        "starway_tpu_torch/native/sw_engine.cpp",
        "starway_tpu_torch/native/sw_engine.h",
        "starway_tpu_torch/native_build.py",
        "starway_tpu_torch/ops/_build.py"}
    assert len(need) >= 11
    missing = need - sdist_names
    assert not missing, f"missing from sdist: {sorted(missing)}"


def test_sdist_ships_test_suite(sdist_names):
    need = _rel((REPO / "tests").glob("test_torch_*.py")) | {
        "tests/conftest.py", "tests/torch_port_util.py"}
    missing = need - sdist_names
    assert not missing, f"test files missing from sdist: {sorted(missing)}"


def test_sdist_has_no_prebuilt_binary(sdist_names):
    built = sorted(n for n in sdist_names
                   if n.rsplit("/", 1)[-1] in ("libkernels.so",
                                               "_sw_native.so"))
    assert not built, f"a binary built here leaked into the sdist: {built}"


def test_sdist_ships_package_complete(sdist_names):
    """Every module of the port, the gate's corpora and budgets, and the
    port's scripts."""
    need = _rel(p for p in PORT.rglob("*.py")
                if "__pycache__" not in p.parts)
    need |= _rel((PORT / "analysis").glob("*.txt"))
    need |= _rel(list((REPO / "scripts" / "torch").glob("*.py"))
                 + list((REPO / "scripts" / "torch").glob("*.sh")))
    missing = need - sdist_names
    assert not missing, f"port files missing from sdist: {sorted(missing)}"


def test_installed_tree_builds_inside_the_package(tmp_path):
    """In an installed tree (no ``pyproject.toml`` beside the package, as
    in ``site-packages``) the kernels and the engine's copy build into the
    package's own ``_build/``, never into a ``build/`` beside it; in a
    checkout, into ``build/starway_tpu_torch/`` under its root."""
    import importlib.util

    from starway_tpu_torch import native_build
    from starway_tpu_torch.ops import _build

    here = REPO / "build" / "starway_tpu_torch"
    assert _build.BUILD_DIR == native_build.build_dir() == here
    assert native_build.artifact() == here / "_sw_native.so"
    installed = tmp_path / "site-packages" / "starway_tpu_torch"
    installed.mkdir(parents=True)
    shutil.copy(PORT / "native_build.py", installed)
    spec = importlib.util.spec_from_file_location(
        "installed_native_build", installed / "native_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.build_dir() == installed / "_build"
    assert mod.artifact() == installed / "_build" / "_sw_native.so"
