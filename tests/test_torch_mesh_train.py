"""MoE training and the model over a mesh of several axes
(starway_tpu_torch.models.sharded, .moe, ops/collectives.py) against the
JAX package on the same numpy inputs, float32, debug widths.

* MoE training: ``value_and_grad(loss_fn)`` of an expert model (loss, aux
  and every gradient, the router's included) within 1e-5 of
  ``jax.value_and_grad``, k = 1 and 2, gelu and SwiGLU experts, with
  drops, with remat (a router tie under remat included); the router
  health through the train step to 1e-6; the Trainer's losses beside the
  JAX Trainer's.
* The collectives along each axis of ``{"dp": 2, "tp": 2, "sp": 2}`` and
  ``{"dp": 2, "ep": 2, "tp": 2}`` against JAX's under ``shard_map`` on its
  8-device CPU mesh: exact, 1e-6 for sums.
* A forward and one AdamW step over dp x tp x sp (ring and zigzag) and
  over dp x ep x tp: loss and new parameters within 1e-5 of the JAX step
  on its mesh and of the port's unsharded step.
* Two gloo processes holding two slots each give the one-process run's
  bits (tests/torch_port_util.py ``mesh_runs``): the dp x tp forward, loss
  and gradients, the ep step, the zigzag attention of a sequence split
  over the processes, and FSDP, each rank holding half of every sharded
  leaf and of mu/nu.
"""

import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from conftest import free_port
from starway_tpu.models import llama as jl
from starway_tpu.ops import collectives as jcol
from starway_tpu.parallel import make_mesh as jax_mesh
from starway_tpu.parallel.sharding import shard_map_fn
from starway_tpu_torch.models import llama as tl
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.trainer import Trainer
from starway_tpu_torch.ops import collectives as col
from starway_tpu_torch.parallel import make_mesh, shard_tree
from starway_tpu_torch.parallel.sharding import cut_blocks
from starway_tpu_torch.utils.optim import adamw
from torch_port_util import mesh_runs, to_numpy, tree_to_numpy

jmoe = importlib.import_module("starway_tpu.models.moe")
tmoe = importlib.import_module("starway_tpu_torch.models.moe")

TESTS = Path(__file__).resolve().parent
ATOL = 1e-5


def _pair(seed=0, **kw):
    jcfg = jl.LlamaConfig.preset("debug", **kw)
    jp = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tl.LlamaConfig.preset("debug", **kw), jp, params_from_numpy(
        tree_to_numpy(jp), device="cpu")


def _batch(seed, b=4, s=17):
    return np.random.default_rng(seed).integers(0, 512, (b, s), np.int32)


def _full(x):
    return x.full() if hasattr(x, "full") else x


def _close_trees(port, jax_tree, atol=ATOL):
    """Every leaf of a port tree (sharded or not) within ``atol`` of the
    JAX tree's."""
    if isinstance(jax_tree, dict):
        for key in jax_tree:
            _close_trees(port[key], jax_tree[key], atol)
        return
    np.testing.assert_allclose(to_numpy(_full(port)), np.asarray(jax_tree),
                               atol=atol)


def _close_step(port, jax_tree):
    """New parameters after one AdamW step: its first update is about
    ``lr * g / |g|``, which turns ulp-level differences of a near-zero
    gradient into visible ones, so the step is held at the JAX package's
    own bound for a resharded step (tests/test_fsdp.py: atol 1e-4, rtol
    5e-3) and the gradients it consumed at 1e-5 (:func:`_close_grads`)."""
    if isinstance(jax_tree, dict):
        for key in jax_tree:
            _close_step(port[key], jax_tree[key])
        return
    np.testing.assert_allclose(to_numpy(_full(port)), np.asarray(jax_tree),
                               atol=1e-4, rtol=5e-3)


def _close_grads(jcfg, tcfg, jsh, tsh, batch, jkw, tkw):
    """The loss and every gradient of the sharded trees within 1e-5."""
    jl_, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jl.loss_fn(p, b, jcfg, **jkw)))(jsh, jnp.asarray(batch))
    tl_, tg = tl.value_and_grad(tsh, torch.as_tensor(batch).long(), tcfg,
                                **tkw)
    assert abs(float(tl_) - float(jl_)) < ATOL
    _close_trees(tg, jg)
    return tg


def _jax_shard(tree, mesh, specs):
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)


# ------------------------------------------------------------ MoE training

MOE_CASES = {
    "k1-gelu": dict(n_experts=4),
    "k2-swiglu": dict(n_experts=4, moe_top_k=2, moe_swiglu=True),
    "k2-drops-remat": dict(n_experts=4, moe_top_k=2, moe_capacity_factor=0.5,
                           remat=True),
    "k1-swiglu-dots": dict(n_experts=4, moe_swiglu=True, remat=True,
                           remat_policy="dots"),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_value_and_grad_matches_jax(case):
    """The twin of tests/test_parallel_extra.py::test_moe_model_trains'
    gradient: loss, aux and every gradient of the expert model."""
    jcfg, tcfg, jp, tp = _pair(3, **MOE_CASES[case])
    batch = _batch(4, b=2)
    jl_, jg = jax.value_and_grad(jl.loss_fn)(jp, jnp.asarray(batch), jcfg)
    tb = torch.as_tensor(batch).long()
    tl_, tg = tl.value_and_grad(tp, tb, tcfg)
    assert abs(float(tl_) - float(jl_)) < ATOL
    _close_trees(tg, jg)
    _, jaux = jl.forward(jp, jnp.asarray(batch[:, :-1]), jcfg,
                         return_aux=True)
    _, taux = tl.forward(tp, tb[:, :-1], tcfg, return_aux=True)
    assert abs(float(taux) - float(jaux)) < ATOL
    assert float(tg["layers"]["moe"]["router"].abs().max()) > 0


def test_moe_router_tie_under_remat():
    """Every router probability equal (a zero router): the stable top-k
    picks the lower experts, and the recomputed routing of the remat
    backward picks the same, so the gradients equal the JAX package's and
    the ones without remat."""
    jcfg, tcfg, jp, tp = _pair(5, n_experts=4, moe_top_k=2, remat=True)
    jp["layers"]["moe"]["router"] = jnp.zeros_like(
        jp["layers"]["moe"]["router"])
    tp["layers"]["moe"]["router"].zero_()
    batch = _batch(6, b=2)
    jl_, jg = jax.value_and_grad(jl.loss_fn)(jp, jnp.asarray(batch), jcfg)
    tb = torch.as_tensor(batch).long()
    tl_, tg = tl.value_and_grad(tp, tb, tcfg)
    assert abs(float(tl_) - float(jl_)) < ATOL
    _close_trees(tg, jg)
    _, plain = tl.value_and_grad(tp, tb, dataclasses.replace(tcfg,
                                                             remat=False))
    _close_trees(tg, _np_tree(plain), atol=1e-6)


@pytest.mark.parametrize("mesh_axes", [None, {"dp": 2, "ep": 1, "tp": 2}])
def test_value_and_grad_under_no_grad(mesh_axes):
    """``value_and_grad`` called where autograd is off (a server or a
    script under ``torch.no_grad()``) gives the gradients it gives with
    autograd on, every layer leaf included, for a whole tree and a
    sharded one."""
    _, tcfg, _, tp = _pair(7, n_experts=4, moe_top_k=2)
    if mesh_axes is not None:
        tp = shard_tree(tp, make_mesh(mesh_axes, device="cpu"),
                        tl.param_specs(tcfg))
    tb = torch.as_tensor(_batch(8, b=2)).long()
    want_loss, want = tl.value_and_grad(tp, tb, tcfg)
    with torch.no_grad():
        loss, got = tl.value_and_grad(tp, tb, tcfg)
    assert float(loss) == float(want_loss)
    _close_trees(got, _np_tree(want), atol=0)
    assert float(_full(got["layers"]["moe"]["router"]).abs().max()) > 0


def _stats_setup():
    mesh_axes = {"dp": 2, "ep": 4, "tp": 1}
    jcfg, tcfg, jp, tp = _pair(30, n_experts=4, moe_top_k=2)
    jmesh = jax_mesh(mesh_axes)
    tmesh = make_mesh(mesh_axes, device="cpu")
    return (jcfg, tcfg, _jax_shard(jp, jmesh, jl.param_specs(jcfg)),
            shard_tree(tp, tmesh, tl.param_specs(tcfg)), jmesh, tmesh)


@pytest.mark.parametrize("accum", [1, 2])
def test_moe_stats_reach_training_loop(accum):
    """The twin of tests/test_parallel_extra.py::test_moe_stats_reach_
    training_loop on its mesh and seed: the train step with a stats
    moe_fn gives the loss (1e-5), the layer-stacked router health (1e-6)
    and the new parameters (1e-5) of the JAX step."""
    jcfg, tcfg, jsh, tsh, jmesh, tmesh = _stats_setup()
    batch = _batch(31, s=33)
    jfn = jmoe.make_sharded_moe(jmesh, capacity_factor=1.25, k=2,
                                with_stats=True)
    tfn = tmoe.make_sharded_moe(tmesh, capacity_factor=1.25, k=2,
                                with_stats=True)
    if accum == 1:
        _close_grads(jcfg, tcfg, jsh, tsh, batch, dict(moe_fn=jfn),
                     dict(moe_fn=tfn))
    jtx, ttx = optax.adamw(1e-3), adamw(1e-3)
    jstep = jax.jit(jl.make_train_step(jcfg, jtx, moe_fn=jfn,
                                       accum_steps=accum,
                                       with_moe_stats=True))
    jp2, _, jloss, jstats = jstep(jsh, jtx.init(jsh), jnp.asarray(batch))
    tstep = tl.make_train_step(tcfg, ttx, moe_fn=tfn, accum_steps=accum,
                               with_moe_stats=True)
    tp2, _, tloss, tstats = tstep(tsh, ttx.init(tsh),
                                  torch.as_tensor(batch).long())
    assert abs(float(tloss) - float(jloss)) < ATOL
    assert tstats["expert_load"].shape == (tcfg.n_layers, 4)
    for name in ("drop_fraction", "expert_load"):
        np.testing.assert_allclose(to_numpy(tstats[name]),
                                   np.asarray(jstats[name]), atol=1e-6)
    _close_step(tp2, jp2)


def test_moe_trainer_loss_falls_as_jax():
    """The twin of tests/test_trainer.py::test_trainer_moe_stats plus its
    loss curve: the Trainer with a stats moe_fn keeps the router health
    each step, and its losses over three steps are the JAX Trainer's."""
    from starway_tpu.models.trainer import Trainer as JaxTrainer

    jcfg, tcfg, jsh, tsh, jmesh, tmesh = _stats_setup()
    jt = JaxTrainer(jcfg, optax.adamw(3e-3), jsh, donate=False,
                    moe_fn=jmoe.make_sharded_moe(jmesh, k=2,
                                                 with_stats=True),
                    with_moe_stats=True)
    tt = Trainer(tcfg, adamw(3e-3), tsh, donate=False,
                 moe_fn=tmoe.make_sharded_moe(tmesh, k=2, with_stats=True),
                 with_moe_stats=True)
    assert tt.last_moe_stats is None
    batch = _batch(7, s=33)
    got = [tt.step_sync(torch.as_tensor(batch).long()) for _ in range(3)]
    want = [jt.step_sync(jnp.asarray(batch)) for _ in range(3)]
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[-1] < got[0]
    assert tt.last_moe_stats["drop_fraction"].shape == (tcfg.n_layers,)


# ------------------------------------------------------------ collectives

MESHES = {"dp-tp-sp": {"dp": 2, "tp": 2, "sp": 2},
          "dp-ep-tp": {"dp": 2, "ep": 2, "tp": 2}}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_collectives_along_each_axis_match_jax(name):
    """Every collective along each axis of a three-axis mesh: each slot
    holds its block of x (split over all three axes on dim 0), and the
    port's results equal JAX's ``shard_map`` collectives slot for slot."""
    axes = MESHES[name]
    names = tuple(axes)
    x = np.random.default_rng(8).standard_normal((8 * 4, 4, 6), np.float32)
    jmesh = jax_mesh(axes)
    tmesh = make_mesh(axes, device="cpu")
    spec = JP(names)
    blocks = cut_blocks(torch.from_numpy(x), tmesh, (names,))
    for axis in names:
        def body(v, axis=axis):
            return (jcol.all_to_all(v, axis, 1, 0, tiled=True),
                    jcol.all_gather(v, axis, axis=1, tiled=True),
                    jcol.psum(v, axis), jcol.pmean(v, axis),
                    jcol.reduce_scatter(v, axis, 1),
                    jcol.ring_shift(v, axis, 1))

        run = jax.jit(shard_map_fn(jmesh, body, in_specs=(spec,),
                                   out_specs=(spec,) * 6))
        want = [np.split(np.asarray(w), 8) for w in run(jnp.asarray(x))]
        got = [col.all_to_all(blocks, tmesh, axis, 1, 0),
               col.all_gather(blocks, tmesh, axis, 1),
               col.psum(blocks, tmesh, axis), col.pmean(blocks, tmesh, axis),
               col.reduce_scatter(blocks, tmesh, axis, 1),
               col.ring_shift(blocks, tmesh, axis, 1)]
        for i, (g, w) in enumerate(zip(got, want)):
            for slot in range(8):
                np.testing.assert_allclose(g[slot].numpy(), w[slot],
                                           atol=1e-6 if i in (2, 3, 4)
                                           else 0, err_msg=f"{axis} {i}")


def test_collectives_differentiate_to_their_adjoints():
    """The gradient of each collective is its adjoint (checked by the dot
    product test: <f(x), y> == <x, f*(y)>) along one axis of a three-axis
    mesh."""
    mesh = make_mesh({"dp": 2, "tp": 2, "sp": 2}, device="cpu")
    gen = torch.Generator().manual_seed(9)
    fns = {"all_to_all": lambda b: col.all_to_all(b, mesh, "tp", 1, 0),
           "all_gather": lambda b: col.all_gather(b, mesh, "tp", 1),
           "psum": lambda b: col.psum(b, mesh, "sp"),
           "reduce_scatter": lambda b: col.reduce_scatter(b, mesh, "dp", 1),
           "ring_shift": lambda b: col.ring_shift(b, mesh, "sp", 1)}
    for name, fn in fns.items():
        xs = [torch.randn(4, 4, generator=gen, dtype=torch.float64)
              .requires_grad_() for _ in range(8)]
        ys = fn(xs)
        ws = [torch.randn(y.shape, generator=gen, dtype=torch.float64)
              for y in ys]
        lhs = sum((y * w).sum() for y, w in zip(ys, ws))
        grads = torch.autograd.grad(lhs, xs)
        rhs = sum((x * g).sum() for x, g in zip(xs, grads))
        torch.testing.assert_close(lhs, rhs, msg=name)


# ------------------------------------------------------------ dp x tp x sp


@pytest.mark.parametrize("layout", ["ring", "zigzag"])
def test_dp_tp_sp_step_matches_jax(layout):
    """One AdamW step over dp x tp x sp with ring attention: the JAX step
    jits GSPMD over its 8-device mesh, the port runs the 8 slots with the
    collectives written out; loss and new parameters within 1e-5, and
    equal to the port's unsharded step."""
    axes = {"dp": 2, "tp": 2, "sp": 2}
    jcfg, tcfg, jp, tp = _pair(1, n_layers=1, remat=True)
    jmesh, tmesh = jax_mesh(axes), make_mesh(axes, device="cpu")
    batch = _batch(2, s=33)
    jtx, ttx = optax.adamw(1e-3), adamw(1e-3)
    jsh = _jax_shard(jp, jmesh, jl.param_specs(jcfg))
    jstep = jax.jit(jl.make_train_step(
        jcfg, jtx, jl.make_sharded_attn(jmesh, layout=layout)))
    jp2, _, jloss = jstep(jsh, jtx.init(jsh), jax.device_put(
        jnp.asarray(batch), NamedSharding(jmesh, JP("dp", None))))
    tsh = shard_tree(tp, tmesh, tl.param_specs(tcfg))
    tstep = tl.make_train_step(tcfg, ttx,
                               tl.make_sharded_attn(tmesh, layout=layout))
    tb = torch.as_tensor(batch).long()
    tp2, _, tloss = tstep(tsh, ttx.init(tsh), tb)
    assert abs(float(tloss) - float(jloss)) < ATOL
    _close_step(tp2, jp2)
    up, _, uloss = tl.make_train_step(tcfg, ttx)(
        tp, ttx.init(tp), tb)
    assert abs(float(tloss) - float(uloss)) < ATOL
    _close_step(tp2, _np_tree(up))
    if layout == "ring":
        tsh = shard_tree(_pair(1, n_layers=1, remat=True)[3], tmesh,
                         tl.param_specs(tcfg))
        _close_grads(jcfg, tcfg, _jax_shard(jp, jmesh, jl.param_specs(jcfg)),
                     tsh, batch,
                     dict(attn_fn=jl.make_sharded_attn(jmesh)),
                     dict(attn_fn=tl.make_sharded_attn(tmesh)))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return to_numpy(_full(tree))


def test_sharded_forward_matches_single_device():
    """The twin of tests/test_model.py::test_sharded_forward_matches_
    single_device: tp-sharded params and ring attention over dp x tp x sp
    give the logits of the JAX sharded forward and of the unsharded
    one."""
    axes = {"dp": 2, "tp": 2, "sp": 2}
    jcfg, tcfg, jp, tp = _pair(0)
    tokens = np.random.default_rng(2).integers(0, 512, (4, 32), np.int32)
    jmesh, tmesh = jax_mesh(axes), make_mesh(axes, device="cpu")
    jout = jax.jit(lambda p, t: jl.forward(
        p, t, jcfg, jl.make_sharded_attn(jmesh)))(
        _jax_shard(jp, jmesh, jl.param_specs(jcfg)), jax.device_put(
            jnp.asarray(tokens), NamedSharding(jmesh, JP("dp", None))))
    tt = torch.as_tensor(tokens).long()
    tsh = shard_tree(tp, tmesh, tl.param_specs(tcfg))
    got = tl.forward(tsh, tt, tcfg, tl.make_sharded_attn(tmesh))
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), tl.forward(tp, tt, tcfg).numpy(),
                               atol=ATOL)
    # The global view of the attention fn on an unsharded tree: JAX's
    # shard_map spec P(dp, tp, sp, None) cut on the one process.
    np.testing.assert_allclose(
        tl.forward(tp, tt, tcfg, tl.make_sharded_attn(tmesh)).numpy(),
        np.asarray(jout), atol=ATOL)


def test_dp_ep_tp_step_matches_jax():
    """The combined mesh of the graft's phase 2b, every axis above 1:
    dp x ep x tp with make_sharded_moe (top-2): loss and new parameters
    within 1e-5 of the JAX step, and of the port's unsharded step with the
    same moe_fn."""
    axes = {"dp": 2, "ep": 2, "tp": 2}
    jcfg, tcfg, jp, tp = _pair(5, n_layers=1, n_experts=4, moe_top_k=2,
                               remat=True)
    jmesh, tmesh = jax_mesh(axes), make_mesh(axes, device="cpu")
    batch = _batch(11, s=17)
    jtx, ttx = optax.adamw(1e-3), adamw(1e-3)
    jsh = _jax_shard(jp, jmesh, jl.param_specs(jcfg))
    jstep = jax.jit(jl.make_train_step(
        jcfg, jtx, moe_fn=jmoe.make_sharded_moe(jmesh, k=2)))
    jp2, _, jloss = jstep(jsh, jtx.init(jsh), jax.device_put(
        jnp.asarray(batch), NamedSharding(jmesh, JP("dp", None))))
    moe_fn = tmoe.make_sharded_moe(tmesh, k=2)
    tsh = shard_tree(tp, tmesh, tl.param_specs(tcfg))
    tb = torch.as_tensor(batch).long()
    _close_grads(jcfg, tcfg, jsh, tsh, batch,
                 dict(moe_fn=jmoe.make_sharded_moe(jmesh, k=2)),
                 dict(moe_fn=moe_fn))
    tp2, _, tloss = tl.make_train_step(tcfg, ttx, moe_fn=moe_fn)(
        tsh, ttx.init(tsh), tb)
    assert abs(float(tloss) - float(jloss)) < ATOL
    _close_step(tp2, jp2)
    up, _, uloss = tl.make_train_step(tcfg, ttx, moe_fn=moe_fn)(
        tp, ttx.init(tp), tb)
    assert abs(float(tloss) - float(uloss)) < ATOL
    _close_step(tp2, _np_tree(up))


# ------------------------------------------------------------ processes


def test_mesh_across_two_processes(tmp_path):
    """Four slots over two gloo processes, two each: every shard of the
    dp x tp forward, loss and gradients, of the ep AdamW step, of the
    zigzag attention of a sequence split over the processes and of the
    ZeRO step equals the one-process run's bit for bit; each FSDP rank
    holds half of every sharded leaf of the parameters and of mu/nu."""
    world = 2
    port = free_port()
    code = ("import sys; sys.path[:0] = sys.argv[1:3]\n"
            "from torch_port_util import mesh_worker\n"
            "mesh_worker(int(sys.argv[3]), int(sys.argv[4]), "
            "int(sys.argv[5]), sys.argv[6])\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(TESTS), str(TESTS.parent), str(r),
         str(world), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ref = mesh_runs(None)
    for r in range(world):
        got = np.load(tmp_path / f"out{r}.npz")
        for key in got.files:
            if key.endswith(("/held", "/total", "/sharded")):
                continue  # what this process holds: checked below
            want = ref[key]
            if key in ("dptp/logits", "zigzag/out", "zigzag/dq"):
                rows = want.shape[0 if key == "dptp/logits" else 2] // world
                cut = slice(r * rows, (r + 1) * rows)
                want = want[cut] if key == "dptp/logits" else want[:, :, cut]
            np.testing.assert_array_equal(got[key], want, err_msg=key)
        sharded = [key[:-len("/sharded")] for key in got.files
                   if key.startswith("fsdp/") and key.endswith("/sharded")
                   and got[key]]
        assert len(sharded) >= 3 * 5  # params, mu and nu
        for leaf in sharded:  # this rank's two slots of four
            assert 2 * int(got[leaf + "/held"]) == int(got[leaf + "/total"])
