"""The port's twin of examples/serve_hf.py on the CPU: the original's tiny
random transformers models (built offline from ``torch.manual_seed(0)``)
of all eight ``--arch`` values, converted by the port's
``config_from_hf``/``params_from_hf``, serve the ragged batch and the
eos-fill run, and row 0 equals ``transformers``' own greedy ``generate``
token for token.  For ``llama``, ``llama31`` and ``--quantize int8`` the
JAX package converts the same model and serves the same batch; the twin,
handed that tree (carried across by ``params_from_numpy``), gives the same
tokens.  The twin also runs with ``--device cpu`` in a fresh process that
must end with nothing of JAX imported, and refuses to run without a card
and without ``--device cpu``."""

import importlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import (assert_refused, carried, run_twins, twin,
                             twin_output)

# transformers on its PyTorch backend: where TensorFlow is installed,
# transformers would import it (seconds of the file's budget).
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")
transformers = pytest.importorskip("transformers")

jgen = importlib.import_module("starway_tpu.models.generate")

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("arch", ["llama", "llama31", "qwen2", "qwen25",
                                  "mixtral", "gemma", "phi3", "phi35"])
def test_serve_hf_matches_transformers(arch):
    from starway_tpu_torch.models import config_from_hf, params_from_hf

    mod = twin("serve_hf")
    hf = mod.demo_model(arch).eval()
    cfg = config_from_hf(hf.config, dtype="float32")
    with torch.no_grad():
        got = mod.serve(params_from_hf(hf, cfg, device="cpu"), cfg, hf=hf)
    assert got["match"] is True
    assert (got["filled"][0] == got["new"][0][0]).all()  # eos-fill


@pytest.mark.parametrize("arch,quantize", [("llama", "none"),
                                           ("llama31", "none"),
                                           ("llama", "int8")])
def test_serve_hf_matches_jax(arch, quantize):
    """The JAX package converts the same transformers model and serves the
    example's ragged batch and eos-fill run; the twin, handed that tree,
    gives the same tokens."""
    from starway_tpu.models import hf_convert as jhf
    from starway_tpu_torch.models import config_from_hf

    mod = twin("serve_hf")
    hf = mod.demo_model(arch).eval()
    jcfg = jhf.config_from_hf(hf.config, dtype="float32")
    jtree = jhf.params_from_hf(hf, jcfg, quantize=quantize)
    with torch.no_grad():
        got = mod.serve(carried(jtree),
                        config_from_hf(hf.config, dtype="float32"),
                        quantize=quantize)
    P = max(map(len, mod.ROWS))
    padded = jnp.asarray([r + [0] * (P - len(r)) for r in mod.ROWS],
                         jnp.int32)
    lengths = jnp.asarray([len(r) for r in mod.ROWS], jnp.int32)
    new = jgen.generate(jtree, jcfg, padded, 12, prompt_lengths=lengths,
                        key=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got["new"], np.asarray(new))
    filled = jgen.generate(jtree, jcfg, padded, 12, prompt_lengths=lengths,
                           eos_id=int(new[0][0]), key=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got["filled"], np.asarray(filled))


@pytest.fixture(scope="module")
def runs():
    """The twin refusing without a card, then on the CPU, in one fresh
    process."""
    return run_twins(REPO, [
        ("refuse", "serve_hf", []),
        ("serve_hf", "serve_hf", ["--device", "cpu", "--max-new", "4",
                                  "--arch", "llama31"])])


def test_twin_runs_without_jax(runs):
    assert "matches transformers.generate: True" in twin_output(runs,
                                                                "serve_hf")


def test_twin_refuses_without_a_card(runs):
    """Without a card and without --device cpu the twin stops with a
    message: it never carries on on the CPU."""
    assert_refused(runs, "refuse")
