"""The port's twin of examples/spmd_training.py against the JAX package on
the CPU.  The twin's body takes the three parts' parameter trees, so here
it gets the JAX example's own (``init_params(PRNGKey(k), cfg)`` for k = 0,
1, 2, carried across by ``params_from_numpy``), and the JAX side makes the
JAX example's calls at its seeds (the batches of ``default_rng(0)``) on
its virtual 8-device CPU mesh.  Held within 1e-5 relative: the losses of
the ZeRO ``Trainer`` over 8 fsdp slots, of the same step from
``fsdp_specs`` + ``shard_tree`` + ``make_fsdp_train_step``, and of
pp-Llama 1F1B over 4 stages.  The optimizer state that ``shard_tree``
shards keeps its step count a plain tensor.  The twin also runs with
``--device cpu`` in a fresh process that must end with nothing of JAX
imported, and refuses to run without a card and without ``--device
cpu``."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import init_params as jax_init_params
from starway_tpu_torch.parallel import P, fsdp_specs, make_mesh, shard_tree
from starway_tpu_torch.utils.optim import adamw
from torch_port_util import (assert_refused, carried, run_twins, twin,
                             twin_output)

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5


def jax_spmd_losses(jtrees, jcfg, devices: int, steps: int) -> dict:
    """examples/spmd_training.py's three parts on the JAX package's
    virtual CPU mesh."""
    from starway_tpu.models import (make_pp_llama_train, make_train_step,
                                    pp_split_params, shard_pp_params)
    from starway_tpu.models.trainer import Trainer as JaxTrainer
    from starway_tpu.parallel import (fsdp_specs, make_fsdp_train_step,
                                      make_mesh, shard_tree)

    rng = np.random.default_rng(0)
    batch = lambda: jnp.asarray(rng.integers(  # noqa: E731
        0, jcfg.vocab_size, (devices, 33), dtype=np.int32))
    losses = {}
    mesh = make_mesh({"fsdp": devices})
    trainer = JaxTrainer(jcfg, optax.adamw(3e-3), jtrees[0], mesh=mesh,
                         fsdp_axis="fsdp")
    for _ in range(steps):
        loss = trainer.step_sync(batch())
    losses["fsdp_trainer"] = float(loss)
    tx = optax.adamw(3e-3)
    pspecs = fsdp_specs(jtrees[1], mesh)
    ospecs = fsdp_specs(jax.eval_shape(tx.init, jtrees[1]), mesh)
    p = shard_tree(jtrees[1], mesh, pspecs)
    o = shard_tree(tx.init(jtrees[1]), mesh, ospecs)
    step = make_fsdp_train_step(make_train_step(jcfg, tx), mesh, pspecs,
                                ospecs)
    for _ in range(steps):
        p, o, loss = step(p, o, batch())
    losses["fsdp_manual"] = float(loss)
    pp_n = max(d for d in (4, 2, 1)
               if d <= devices and jcfg.n_layers % d == 0)
    mesh_pp = make_mesh({"pp": pp_n})
    pp = shard_pp_params(pp_split_params(jtrees[2], pp_n), mesh_pp)
    pp_step = make_pp_llama_train(mesh_pp, jcfg, n_micro=4)
    opt = tx.init(pp)
    fixed = jnp.asarray(rng.integers(0, jcfg.vocab_size, (8, 33),
                                     dtype=np.int32))
    for _ in range(steps):
        loss, grads = pp_step(pp, fixed)
        updates, opt = tx.update(grads, opt, pp)
        pp = optax.apply_updates(pp, updates)
    losses["pp"] = float(loss)
    return losses


def test_spmd_training_matches_jax():
    mod = twin("spmd_training")
    cfg = mod.config()
    jcfg = JaxConfig.preset("debug", d_model=64, n_heads=4, n_kv_heads=4,
                            d_ff=128, vocab_size=256, n_layers=4)
    jtrees = [jax_init_params(jax.random.PRNGKey(k), jcfg) for k in range(3)]
    devices, steps = 8, 2
    got = mod.tour([carried(t) for t in jtrees], cfg, devices=devices,
                   steps=steps, device="cpu")
    want = jax_spmd_losses(jtrees, jcfg, devices, steps)
    for part in ("fsdp_trainer", "fsdp_manual", "pp"):
        np.testing.assert_allclose(got[part], want[part], rtol=LOSS_RTOL,
                                   err_msg=part)


def test_shard_tree_keeps_the_step_count_plain():
    """The optimizer state sharded by ``shard_tree`` over ``fsdp_specs``
    (spmd_training's part 2, the JAX package's calls) keeps its 0-d step
    count a plain tensor on the mesh's device, as ``tx.init`` of a sharded
    tree holds it, so the AdamW update can step it."""
    tx = adamw(1e-2)
    tree = {"w": torch.ones(8, 4), "b": torch.zeros(4)}
    mesh = make_mesh({"fsdp": 4}, device="cpu")
    state = tx.init(tree)
    sharded = shard_tree(state, mesh, fsdp_specs(state, mesh))
    assert type(sharded.count) is torch.Tensor and sharded.count.dim() == 0
    assert type(sharded.mu["w"]) is not torch.Tensor
    assert fsdp_specs(state, mesh).count == P()


@pytest.fixture(scope="module")
def runs():
    """The twin refusing without a card, then on the CPU for one step over
    4 slots, in one fresh process."""
    return run_twins(REPO, [
        ("refuse", "spmd_training", []),
        ("spmd", "spmd_training", ["--device", "cpu", "--steps", "1",
                                   "--devices", "4"])])


def test_twin_runs_without_jax(runs):
    assert "[pp-llama]     4 stages x 1 layers, 1 steps" in twin_output(
        runs, "spmd")


def test_twin_refuses_without_a_card(runs):
    """Without a card and without --device cpu the twin stops with a
    message: it never carries on on the CPU."""
    assert_refused(runs, "refuse")
