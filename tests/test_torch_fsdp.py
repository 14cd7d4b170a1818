"""ZeRO/FSDP (starway_tpu_torch.parallel.fsdp) and the Trainer's ZeRO mode
against the JAX package and against the port's local step, float32.

The twins of tests/test_fsdp.py and tests/test_trainer.py:73, :99, :193:
``fsdp_specs`` equal to JAX's leaf for leaf (parameters and the AdamW
state, and the hybrid with tp); the sharded step equal to the unsharded
one (loss 1e-5, gradients 1e-5, the AdamW step at the JAX tests' bound);
the Trainer in ZeRO mode against the local Trainer, with accumulation, and
its checkpoint round trip with the sharding kept.
"""

import numpy as np
import pytest
import torch

import jax
import optax
from jax.sharding import PartitionSpec as JP

from starway_tpu.models import llama as jl
from starway_tpu.parallel import fsdp_specs as jax_fsdp_specs
from starway_tpu.parallel import make_mesh as jax_mesh
from starway_tpu_torch.models import llama as tl
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.trainer import Trainer
from starway_tpu_torch.parallel import (P, fsdp_specs, make_fsdp_train_step,
                                        make_mesh, shard_tree)
from starway_tpu_torch.utils.optim import adamw
from starway_tpu_torch.utils.tree import tree_leaves
from torch_port_util import to_numpy, tree_to_numpy

SMALL = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256)


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig.preset("debug", **SMALL)
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    batch = np.random.default_rng(0).integers(0, 256, (8, 17), np.int32)
    return (jcfg, tl.LlamaConfig.preset("debug", **SMALL), jp,
            torch.as_tensor(batch).long())


def _params(jp):
    return params_from_numpy(tree_to_numpy(jp), device="cpu")


def _entries(spec) -> tuple:
    return tuple(spec)


def _spec_tuples(tree, is_jax: bool) -> list:
    if is_jax:
        return [_entries(s) for s in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, JP))]
    return [_entries(s) for s in tree_leaves(tree)]


def _full(x):
    return x.full() if hasattr(x, "full") else x


@pytest.mark.parametrize("axes", [{"fsdp": 4}, {"fsdp": 2, "tp": 2}])
def test_fsdp_specs_equal_jax(setup, axes):
    """Specs leaf for leaf as JAX's, for the parameters and the AdamW
    state (mu/nu shard like their parameters, the count is replicated);
    with tp, ``base_specs`` pins tp and fsdp takes another dim."""
    jcfg, tcfg, jp, _ = setup
    tp = _params(jp)
    jm, tm = jax_mesh(axes), make_mesh(axes, device="cpu")
    jbase = jl.param_specs(jcfg) if "tp" in axes else None
    tbase = tl.param_specs(tcfg) if "tp" in axes else None
    want = _spec_tuples(jax_fsdp_specs(jp, jm, base_specs=jbase), True)
    got = _spec_tuples(fsdp_specs(tp, tm, base_specs=tbase), False)
    assert got == want
    for name, spec in fsdp_specs(tp, tm)["layers"].items():
        assert not tuple(spec) or tuple(spec)[0] is None, name
    if "tp" in axes:
        wq = tuple(fsdp_specs(tp, tm, base_specs=tbase)["layers"]["wq"])
        assert wq[2] == "tp" and "fsdp" in wq[:2]
    jo = jax_fsdp_specs(jax.eval_shape(optax.adamw(1e-2).init, jp), jm)
    to = fsdp_specs(adamw(1e-2).init(tp), tm)
    assert _spec_tuples(to, False) == _spec_tuples(jo, True)


@pytest.mark.parametrize("axes", [{"fsdp": 4}, {"fsdp": 2, "tp": 2}])
def test_fsdp_step_matches_unsharded(setup, axes):
    """The ZeRO step (batch over fsdp, weights gathered per layer,
    gradients reduce-scattered) against the unsharded step; the updated
    tree really lives sharded."""
    jcfg, tcfg, jp, batch = setup
    tx = adamw(1e-2)
    tp = _params(jp)
    loss0, g0 = tl.value_and_grad(tp, batch, tcfg)
    p1, _, loss = tl.make_train_step(tcfg, tx)(tp, tx.init(tp), batch)
    mesh = make_mesh(axes, device="cpu")
    base = tl.param_specs(tcfg) if "tp" in axes else None
    tp = _params(jp)
    pspecs = fsdp_specs(tp, mesh, base_specs=base)
    sh = shard_tree(tp, mesh, pspecs)
    loss_g, g1 = tl.value_and_grad(sh, batch, tcfg)
    assert abs(float(loss_g) - float(loss0)) < 1e-5
    for a, b in zip(tree_leaves(g0), [_full(x) for x in _leaves(g1)]):
        np.testing.assert_allclose(to_numpy(b), to_numpy(a), atol=1e-5)
    opt = tx.init(sh)
    ospecs = fsdp_specs(tx.init(tp), mesh)
    step = make_fsdp_train_step(tl.make_train_step(tcfg, tx), mesh, pspecs,
                                ospecs, batch_spec=P("fsdp"))
    p1_sh, o1_sh, loss_sh = step(sh, opt, batch)
    assert abs(float(loss_sh) - float(loss)) < 1e-5
    for a, b in zip(tree_leaves(p1), [_full(x) for x in _leaves(p1_sh)]):
        np.testing.assert_allclose(to_numpy(b), to_numpy(a), atol=1e-4,
                                   rtol=5e-3)
    emb = p1_sh["embed"]
    assert "fsdp" in tuple(emb.sharding.spec)
    n = mesh.size
    assert emb.tree_children()[0].numel() == emb.full().numel() // n
    mu = o1_sh.mu["embed"]
    assert mu.tree_children()[0].numel() == mu.full().numel() // n


def _leaves(tree):
    """The sharded leaves of a tree (each ShardedTensor once)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_fsdp_step_matches_jax(setup):
    """The port's ZeRO step against the JAX package's
    ``make_fsdp_train_step`` on its 4-device mesh: loss 1e-5, parameters
    at the JAX test's bound."""
    from starway_tpu.parallel import make_fsdp_train_step as jax_fsdp_step
    from starway_tpu.parallel import shard_tree as jax_shard_tree

    jcfg, tcfg, jp, batch = setup
    jm = jax_mesh({"fsdp": 4})
    jtx = optax.adamw(1e-2)
    jps = jax_fsdp_specs(jp, jm)
    jos = jax_fsdp_specs(jax.eval_shape(jtx.init, jp), jm)
    jstep = jax_fsdp_step(jl.make_train_step(jcfg, jtx), jm, jps, jos,
                          donate=False)
    jp1, _, jloss = jstep(jax_shard_tree(jp, jm, jps),
                          jax_shard_tree(jtx.init(jp), jm, jos),
                          np.asarray(batch, np.int32))
    tm = make_mesh({"fsdp": 4}, device="cpu")
    tx = adamw(1e-2)
    tp = _params(jp)
    pspecs = fsdp_specs(tp, tm)
    sh = shard_tree(tp, tm, pspecs)
    p1, _, loss = make_fsdp_train_step(tl.make_train_step(tcfg, tx), tm,
                                       pspecs)(sh, tx.init(sh), batch)
    assert abs(float(loss) - float(jloss)) < 1e-5
    for a, b in zip(jax.tree_util.tree_leaves(jp1),
                    [_full(x) for x in _leaves(p1)]):
        np.testing.assert_allclose(to_numpy(b), np.asarray(a), atol=1e-4,
                                   rtol=5e-3)


def test_trainer_fsdp_mode_matches_local(setup):
    """The twin of tests/test_trainer.py::test_trainer_fsdp_mode_matches_
    local: one ZeRO step's loss is the local Trainer's, the embedding
    lives 1/4 a slot, the step has its telemetry span."""
    _, tcfg, jp, batch = setup
    base = Trainer(tcfg, adamw(3e-3), _params(jp), donate=False)
    loss_ref = base.step_sync(batch)
    mesh = make_mesh({"fsdp": 4}, device="cpu")
    t = Trainer(tcfg, adamw(3e-3), _params(jp), mesh=mesh, fsdp_axis="fsdp")
    loss = t.step_sync(batch)
    assert t.state.step == 1
    assert abs(loss - loss_ref) < 1e-5
    emb = t.state.params["embed"]
    assert emb.tree_children()[0].numel() == emb.full().numel() // 4
    assert "fsdp_step" in t.telemetry()
    for a, b in zip(tree_leaves(base.state.params),
                    [_full(x) for x in _leaves(t.state.params)]):
        np.testing.assert_allclose(to_numpy(b), to_numpy(a), atol=1e-4,
                                   rtol=5e-3)
    with pytest.raises(ValueError):
        Trainer(tcfg, adamw(3e-3), _params(jp), mesh=mesh)
    with pytest.raises(ValueError):
        Trainer(tcfg, adamw(3e-3), _params(jp), mesh=mesh, fsdp_axis="fsdp",
                dp_port=object())


def test_trainer_fsdp_ckpt_roundtrip(setup, tmp_path):
    """The twin of tests/test_trainer.py::test_trainer_fsdp_ckpt_
    roundtrip: the ZeRO state round-trips through the npz checkpoint with
    its sharding, bit for bit, and trains on."""
    _, tcfg, jp, batch = setup
    mesh = make_mesh({"fsdp": 4}, device="cpu")
    t = Trainer(tcfg, adamw(3e-3), _params(jp), mesh=mesh, fsdp_axis="fsdp")
    t.step_sync(batch)
    t.save(str(tmp_path / "ck"))
    t2 = Trainer(tcfg, adamw(3e-3), tl.init_params(tcfg, 1, device="cpu"),
                 mesh=mesh, fsdp_axis="fsdp")
    t2.restore(str(tmp_path / "ck"))
    assert t2.state.step == 1
    emb = t2.state.params["embed"]
    assert "fsdp" in tuple(emb.sharding.spec)
    assert emb.tree_children()[0].numel() == emb.full().numel() // 4
    for a, b in zip(tree_leaves(t._tree()), tree_leaves(t2._tree())):
        assert torch.equal(a, b)
    assert np.isfinite(t2.step_sync(batch))


def test_trainer_fsdp_accum_matches_local():
    """The twin of tests/test_trainer.py::test_trainer_fsdp_accum_matches_
    local: accumulation composes with ZeRO mode."""
    cfg = tl.LlamaConfig.preset("debug")
    params = tl.init_params(cfg, 0, device="cpu")
    batch = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (8, 17))).long()
    local = Trainer(cfg, adamw(1e-3), params, donate=False, accum_steps=2)
    sharded = Trainer(cfg, adamw(1e-3), params, donate=False,
                      mesh=make_mesh({"fsdp": 4}, device="cpu"),
                      fsdp_axis="fsdp", accum_steps=2)
    l1 = local.step_sync(batch)
    l2 = sharded.step_sync(batch)
    assert abs(l2 - l1) < 1e-5
    for a, b in zip(tree_leaves(local.state.params),
                    [_full(x) for x in _leaves(sharded.state.params)]):
        np.testing.assert_allclose(to_numpy(b), to_numpy(a), atol=5e-5,
                                   rtol=1e-3)


def _plain_moe_fns(with_stats: bool):
    """The same plain moe_fn (switch_moe at capacity factor 1, top-2: it
    drops tokens, so its capacity must be the whole batch's) in both
    packages."""
    import importlib

    jmoe = importlib.import_module("starway_tpu.models.moe")
    tmoe = importlib.import_module("starway_tpu_torch.models.moe")

    def make(mod):
        def fn(x, router, w_in, w_out, w_gate=None):
            return mod.switch_moe(x, router, w_in, w_out, w_gate=w_gate,
                                  capacity_factor=1.0, k=2,
                                  with_stats=with_stats)

        return fn

    return make(jmoe), make(tmoe)


def test_trainer_fsdp_plain_moe_fn_matches_jax():
    """An expert model in ZeRO mode with a plain moe_fn, which GSPMD gives
    the global batch in the JAX package: the gradients of the sharded tree
    (the router's included) and the router health equal JAX's global
    view, and two ZeRO Trainer steps give the JAX ZeRO Trainer's losses
    and parameters."""
    import jax.numpy as jnp

    from starway_tpu.models.trainer import Trainer as JaxTrainer

    kw = dict(SMALL, n_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
    jcfg = jl.LlamaConfig.preset("debug", **kw)
    tcfg = tl.LlamaConfig.preset("debug", **kw)
    jp = jl.init_params(jax.random.PRNGKey(2), jcfg)
    batch = np.random.default_rng(2).integers(0, 256, (8, 17), np.int32)
    tb = torch.as_tensor(batch).long()
    jfn, tfn = _plain_moe_fns(with_stats=True)
    (jloss, jstats), jg = jax.value_and_grad(
        lambda p: jl.loss_fn(p, jnp.asarray(batch), jcfg, moe_fn=jfn,
                             with_moe_stats=True), has_aux=True)(jp)
    tm = make_mesh({"fsdp": 4}, device="cpu")
    sh = shard_tree(_params(jp), tm, fsdp_specs(_params(jp), tm))
    (tloss, tstats), tg = tl.value_and_grad(sh, tb, tcfg, moe_fn=tfn,
                                            with_moe_stats=True)
    assert abs(float(tloss) - float(jloss)) < 1e-5
    for a, b in zip(jax.tree_util.tree_leaves(jg), _leaves(tg)):
        np.testing.assert_allclose(to_numpy(_full(b)), np.asarray(a),
                                   atol=1e-5)
    for name in ("drop_fraction", "expert_load"):
        np.testing.assert_allclose(to_numpy(tstats[name]),
                                   np.asarray(jstats[name]), atol=1e-6)

    jfn, tfn = _plain_moe_fns(with_stats=False)
    jt = JaxTrainer(jcfg, optax.adamw(3e-3), jp, donate=False,
                    mesh=jax_mesh({"fsdp": 4}), fsdp_axis="fsdp", moe_fn=jfn)
    tt = Trainer(tcfg, adamw(3e-3), _params(jp), mesh=tm, fsdp_axis="fsdp",
                 moe_fn=tfn)
    want = [jt.step_sync(jnp.asarray(batch)) for _ in range(2)]
    got = [tt.step_sync(tb) for _ in range(2)]
    np.testing.assert_allclose(got, want, atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(jt.state.params),
                    _leaves(tt.state.params)):
        np.testing.assert_allclose(to_numpy(_full(b)), np.asarray(a),
                                   atol=1e-4, rtol=5e-3)
