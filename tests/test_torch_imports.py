"""The port stands alone: no module of starway_tpu_torch, and not
chip_smoke.py, imports jax, optax or the JAX package; importing the
serving and training stacks leaves them out of sys.modules; and the entry
points default to the GPU rather than falling back to the CPU."""

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
