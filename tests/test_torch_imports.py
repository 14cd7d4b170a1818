"""The port stands alone: no module of starway_tpu_torch, and not
chip_smoke.py, imports jax, optax or the JAX package; importing the
serving, training and transport stacks leaves them out of sys.modules;
and the entry points default to the GPU rather than falling back to the
CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "starway_tpu")


def _port_files():
    files = sorted((REPO / "starway_tpu_torch").rglob("*.py"))
    assert len(files) >= 17
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax(path):
    bad = [(line, name) for line, name in _imported_roots(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_serving_import_keeps_jax_out_of_the_process():
    code = ("import sys, starway_tpu_torch.models.serving, "
            "starway_tpu_torch.ops.decode, starway_tpu_torch.ops.flash, "
            "starway_tpu_torch.ops.gemv, starway_tpu_torch.models.trainer, "
            "starway_tpu_torch.utils.checkpoint\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda():
    from starway_tpu_torch import DeviceBuffer
    from starway_tpu_torch.models import LlamaConfig, init_params
    from starway_tpu_torch.models.generate import init_cache

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = LlamaConfig.preset("debug")
    with pytest.raises((RuntimeError, AssertionError)):
        init_params(cfg, 0)
    with pytest.raises((RuntimeError, AssertionError)):
        init_cache(cfg, 1, 8)
    assert init_params(cfg, 0, device="cpu")["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceBuffer((16,), torch.uint8)
    assert DeviceBuffer((16,), torch.uint8, device="cpu").device.type == "cpu"


def test_transport_import_keeps_jax_out_of_the_process():
    code = ("import sys\n"
            "from starway_tpu_torch import Server, Client, DeviceBuffer\n"
            "import starway_tpu_torch.api, starway_tpu_torch.device, "
            "starway_tpu_torch.core.engine, starway_tpu_torch.core.native, "
            "starway_tpu_torch.headline\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_paged_import_keeps_jax_out_of_the_process():
    code = ("import sys, starway_tpu_torch.models.paged\n"
            "assert 'starway_tpu_torch.ops.paged' in sys.modules\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_parallel_import_keeps_jax_out_of_the_process():
    code = ("import sys, starway_tpu_torch.parallel, "
            "starway_tpu_torch.ops.collectives\n"
            "assert 'starway_tpu_torch.parallel.ring_attention' in "
            "sys.modules\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_scan_covers_the_parallel_layer():
    scanned = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert {"starway_tpu_torch/parallel/ring_attention.py",
            "starway_tpu_torch/parallel/sharding.py",
            "starway_tpu_torch/ops/collectives.py"} <= scanned


def test_scan_covers_the_transport():
    scanned = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert {"starway_tpu_torch/api.py", "starway_tpu_torch/device.py",
            "starway_tpu_torch/headline.py",
            "starway_tpu_torch/native_build.py",
            "starway_tpu_torch/core/engine.py",
            "starway_tpu_torch/core/native.py"} <= scanned


def test_bench_and_tools_import_keeps_jax_out_of_the_process():
    code = ("import sys, starway_tpu_torch.bench, "
            "starway_tpu_torch.benchmarks.scenarios, "
            "starway_tpu_torch.reshard, starway_tpu_torch.metrics, "
            "starway_tpu_torch.trace\n"
            "starway_tpu_torch.bench.build_parser()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_scan_covers_the_bench_and_tools():
    scanned = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert {"starway_tpu_torch/bench.py", "starway_tpu_torch/metrics.py",
            "starway_tpu_torch/trace.py",
            "starway_tpu_torch/benchmarks/__init__.py",
            "starway_tpu_torch/benchmarks/scenarios.py",
            "starway_tpu_torch/reshard/__init__.py",
            "starway_tpu_torch/reshard/plan.py",
            "starway_tpu_torch/reshard/tags.py",
            "starway_tpu_torch/reshard/executor.py"} <= scanned


def test_transport_tail_and_model_over_it_import_keeps_jax_out():
    """The analysis core (compiled here, as the armed monitor compiles it),
    the fault proxy, the DP exchange, remote serving and the mesh."""
    code = ("import sys, starway_tpu_torch.analysis.refine, "
            "starway_tpu_torch.testing.faults, "
            "starway_tpu_torch.parallel.dp_exchange, "
            "starway_tpu_torch.models.remote_serving, "
            "starway_tpu_torch.mesh\n"
            "from starway_tpu_torch.analysis import refine\n"
            "mon, problems = refine.compile_monitor(runtime=True)\n"
            "assert mon is not None and not problems, problems\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_scan_covers_the_transport_tail_and_the_model_over_it():
    scanned = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert {"starway_tpu_torch/analysis/__init__.py",
            "starway_tpu_torch/analysis/base.py",
            "starway_tpu_torch/analysis/py_model.py",
            "starway_tpu_torch/analysis/protomodel.py",
            "starway_tpu_torch/analysis/refine.py",
            "starway_tpu_torch/testing/__init__.py",
            "starway_tpu_torch/testing/faults.py",
            "starway_tpu_torch/parallel/dp_exchange.py",
            "starway_tpu_torch/models/remote_serving.py",
            "starway_tpu_torch/mesh.py"} <= scanned


def test_serving_stack_imports_keep_jax_and_transformers_out():
    """The rolling, speculative, beam and HF-conversion entry points import
    without jax, the JAX package or transformers (the converter reads a
    model through its state_dict and config attributes)."""
    code = ("import sys\n"
            "from starway_tpu_torch.models import (init_rolling_cache, "
            "prefill_rolling, generate_speculative, generate_lookup, "
            "draft_from_truncation, generate_beam, config_from_hf, "
            "params_from_hf)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('transformers',)!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_scan_covers_the_serving_stack():
    scanned = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert {"starway_tpu_torch/models/generate.py",
            "starway_tpu_torch/models/speculative.py",
            "starway_tpu_torch/models/beam.py",
            "starway_tpu_torch/models/hf_convert.py",
            "starway_tpu_torch/models/serving.py"} <= scanned


def test_mesh_layer_imports_keep_jax_out_of_the_process():
    """Ulysses, FSDP, the model over a mesh and the sharded MoE import
    without jax or the JAX package."""
    code = ("import sys\n"
            "from starway_tpu_torch.parallel import (fsdp_specs, shard_tree, "
            "make_fsdp_train_step, make_ulysses_attention, "
            "ulysses_attention, mesh_sharding, shard_array)\n"
            "from starway_tpu_torch.models import param_specs, "
            "quantized_param_specs\n"
            "import starway_tpu_torch.models.sharded\n"
            "from starway_tpu_torch.models.moe import moe_specs\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_scan_covers_the_mesh_layer():
    scanned = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert {"starway_tpu_torch/parallel/ulysses.py",
            "starway_tpu_torch/parallel/fsdp.py",
            "starway_tpu_torch/models/sharded.py"} <= scanned
