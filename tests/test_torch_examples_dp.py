"""The port's twin of examples/dp_training_2proc.py against the JAX package
on the CPU.  The twin's body takes the parameter tree, so here it gets the
JAX example's own weights (``init_params(PRNGKey(0), debug)``, carried
across by ``params_from_numpy``), and the JAX side makes the JAX example's
calls at its seeds (each rank's batches from ``default_rng(100 + rank)``,
the two ranks' gradients averaged, ``optax.adamw(1e-3)``).  Held: the two
spawned ranks end bit-equal, and each rank's per-step losses lie within
1e-5 relative of the JAX rank's.  The twin also runs with ``--device cpu``
in a fresh process that must end with nothing of JAX imported, and
refuses to run without a card and without ``--device cpu``."""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import init_params as jax_init_params
from torch_port_util import (assert_refused, carried, run_twins, twin,
                             twin_output)

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def debug():
    """The debug preset's tree at the example's seed, both packages."""
    jcfg = JaxConfig.preset("debug")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, carried(jp)


def jax_dp_losses(jp, jcfg, steps: int) -> dict:
    """examples/dp_training_2proc.py's two ranks in one process: each rank's
    gradients on its own batches, averaged, one ``optax.adamw(1e-3)``
    update (both ranks apply the same one)."""
    from starway_tpu.models import loss_fn

    tx = optax.adamw(1e-3)
    opt = tx.init(jp)
    grad_fn = jax.jit(lambda p, b: jax.value_and_grad(loss_fn)(p, b, jcfg))
    rngs = [np.random.default_rng(100 + r) for r in (0, 1)]
    losses = {0: [], 1: []}
    for _ in range(steps):
        out = [grad_fn(jp, jnp.asarray(rng.integers(
            0, jcfg.vocab_size, (4, 33), dtype=np.int32))) for rng in rngs]
        grads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, out[0][1],
                                       out[1][1])
        updates, opt = tx.update(grads, opt, jp)
        jp = optax.apply_updates(jp, updates)
        for r in (0, 1):
            losses[r].append(float(out[r][0]))
    return losses


def test_dp_training_matches_jax(debug):
    jcfg, jp, tp = debug
    steps = 3
    ranks = twin("dp_training_2proc").run(steps, "cpu", params=tp)
    want = jax_dp_losses(jp, jcfg, steps)
    for r in (0, 1):
        np.testing.assert_allclose(ranks[r]["losses"], want[r],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
    assert ranks[0]["digest"] == ranks[1]["digest"]


@pytest.fixture(scope="module")
def runs():
    """The twin refusing without a card, then on the CPU for one step, in
    one fresh process."""
    return run_twins(REPO, [
        ("refuse", "dp_training_2proc", []),
        ("dp", "dp_training_2proc", ["--device", "cpu", "--steps", "1"])])


def test_twin_runs_without_jax(runs):
    assert "OK: 1 DP steps, parameters identical across ranks" in \
        twin_output(runs, "dp")


def test_twin_refuses_without_a_card(runs):
    """Without a card and without --device cpu the twin stops with a
    message: it never carries on on the CPU."""
    assert_refused(runs, "refuse")
