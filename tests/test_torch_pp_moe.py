"""MoE through the port's pipeline (models/pp_llama.py) against the JAX
package's on the same numpy inputs, case for case the twin of
tests/test_pp_moe.py:

* stage-local experts over pp, top-2, nonzero aux: loss and every
  gradient equal JAX's pipeline and the microbatched oracle (the mean
  over microbatches of ``loss_fn``, the port's own ``value_and_grad``);
  the aux reaches stage 0's router;
* pp x ep: expert tables split over ep inside each stage, tokens over ep,
  the dispatch an all-to-all among the stage's slots
  (parallel/sharding.py ``AxisSlice``), with the expert-aware gradient
  reduction: JAX's loss and gradients, and the specs JAX names;
* pp x dp x ep with drops and aux: JAX's loss and gradients;
* interleaved stage-local MoE: JAX's loss and gradients;
* the refusals: interleaved ep, ep on a dense config.

Tolerances, float32: losses rtol 1e-6, gradients atol 5e-6 with rtol
1e-5 (tests/test_torch_pipeline.py); against the port's oracle, whose
sums over microbatches run in another order, the same."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from starway_tpu.models import llama as jl
from starway_tpu.models import pp_llama as jpp
from starway_tpu.parallel import make_mesh as jax_mesh
from starway_tpu_torch.models import llama as tl
from starway_tpu_torch.models import pp_llama as tpp
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.parallel import make_mesh
from torch_port_util import to_numpy, tree_to_numpy

LOSS_RTOL = 1e-6
GRAD_TOL = dict(atol=5e-6, rtol=1e-5)
WIDTHS = dict(d_model=32, n_heads=4, n_kv_heads=2, d_ff=48, vocab_size=64)


def _pair(seed, **kw):
    jcfg = jl.LlamaConfig.preset("debug", **WIDTHS, **kw)
    jp = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tl.LlamaConfig.preset("debug", **WIDTHS, **kw), jp, \
        params_from_numpy(tree_to_numpy(jp), device="cpu")


def _batch(seed):
    return np.random.default_rng(seed).integers(0, 64, (8, 9),
                                                dtype=np.int32)


def _full(x):
    return x.full() if hasattr(x, "full") else x


def _close(port, want, msg=""):
    if isinstance(want, dict):
        for key in want:
            _close(port[key], want[key], f"{msg}/{key}")
        return
    np.testing.assert_allclose(to_numpy(_full(port)), np.asarray(want),
                               err_msg=msg, **GRAD_TOL)


def _steps(axes, jcfg, tcfg, jp, tp, batch, n_micro, n_chunks=1,
           ep_axis=None, dp_axis=None):
    """(JAX loss, grads), (port loss, grads), the port's sharded tree."""
    jmesh, mesh = jax_mesh(axes), make_mesh(axes, device="cpu")
    if n_chunks == 1:
        jsh = jpp.shard_pp_params(jpp.pp_split_params(jp, axes["pp"]),
                                  jmesh, ep_axis=ep_axis)
        tsh = tpp.shard_pp_params(tpp.pp_split_params(tp, axes["pp"]), mesh,
                                  ep_axis=ep_axis)
    else:
        jsh = jpp.shard_ppv_params(jpp.ppv_split_params(jp, axes["pp"],
                                                        n_chunks), jmesh)
        tsh = tpp.shard_ppv_params(tpp.ppv_split_params(tp, axes["pp"],
                                                        n_chunks), mesh)
    kw = dict(n_micro=n_micro, n_chunks=n_chunks, ep_axis=ep_axis,
              dp_axis=dp_axis)
    jout = jpp.make_pp_llama_train(jmesh, jcfg, **kw)(jsh, jnp.asarray(batch))
    out = tpp.make_pp_llama_train(mesh, tcfg, **kw)(
        tsh, torch.as_tensor(batch).long())
    return jout, out, tsh, mesh


def _oracle(params, batch, cfg, n_micro):
    """mean_j [CE(mb_j) + coef * aux(mb_j) / n_layers] and its gradients,
    the sequential semantics of the schedule (capacity from the
    microbatch's tokens), through the port's unsharded value_and_grad."""
    total, grads = None, None
    for mb in torch.as_tensor(batch).long().chunk(n_micro):
        loss, g = tl.value_and_grad(params, mb, cfg)
        total = loss if total is None else total + loss
        grads = g if grads is None else _add(grads, g)
    return total / n_micro, _scale(grads, 1 / n_micro)


def _add(a, b):
    return {k: _add(a[k], b[k]) for k in a} if isinstance(a, dict) \
        else a + b


def _scale(a, s):
    return {k: _scale(v, s) for k, v in a.items()} if isinstance(a, dict) \
        else a * s


def _close_flat(flat, ref):
    for key in ref:
        if isinstance(ref[key], dict):
            _close_flat(flat[key], ref[key])
        else:
            np.testing.assert_allclose(to_numpy(flat[key]),
                                       to_numpy(ref[key]), err_msg=key,
                                       **GRAD_TOL)


def test_pp_moe_grads_match_jax():
    """Stage-local experts, top-2, aux 0.02: JAX's loss and gradients and
    the microbatched oracle's; with the coefficient at 0 stage 0's router
    gradient changes (the aux chains through the backward hops)."""
    kw = dict(n_layers=4, n_experts=4, moe_top_k=2, moe_aux_coef=0.02)
    jcfg, tcfg, jp, tp = _pair(0, **kw)
    batch = _batch(0)
    (jloss, jgrads), (loss, grads), tsh, mesh = _steps(
        {"pp": 2}, jcfg, tcfg, jp, tp, batch, 4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _close(grads, jgrads)
    ref_loss, ref = _oracle(tp, batch, tcfg, 4)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    _close_flat(tpp.pp_merge_params(grads), ref)

    cfg0 = tl.LlamaConfig.preset("debug", **WIDTHS, **dict(
        kw, moe_aux_coef=0.0))
    _, grads0 = tpp.make_pp_llama_train(mesh, cfg0, n_micro=4)(
        tsh, torch.as_tensor(batch).long())
    r_with = grads["stages"]["moe"]["router"].full()[0]
    r_without = grads0["stages"]["moe"]["router"].full()[0]
    assert float((r_with - r_without).abs().max()) > 0


def test_pp_ep_moe_grads_match_jax():
    """pp x ep without drops and aux: JAX's loss and gradients, and the
    oracle's (the math does not depend on the split); expert tables split
    (pp, -, ep), the router over pp only."""
    kw = dict(n_layers=4, n_experts=4, moe_top_k=1, moe_aux_coef=0.0,
              moe_capacity_factor=4.0)
    jcfg, tcfg, jp, tp = _pair(1, **kw)
    batch = _batch(1)
    (jloss, jgrads), (loss, grads), _, _ = _steps(
        {"pp": 2, "ep": 2}, jcfg, tcfg, jp, tp, batch, 2, ep_axis="ep")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _close(grads, jgrads)
    ref_loss, ref = _oracle(tp, batch, tcfg, 2)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    _close_flat(tpp.pp_merge_params(grads), ref)

    specs = tpp.pp_param_specs(tpp.pp_split_params(tp, 2), ep_axis="ep")
    assert tuple(specs["stages"]["moe"]["w_in"]) == ("pp", None, "ep")
    assert tuple(specs["stages"]["moe"]["router"]) == ("pp",)


def test_pp_ep_dp_moe_matches_jax():
    """pp x dp x ep over 8 slots, with drops (capacity 1.25) and aux:
    JAX's loss and gradients, laid out like the params."""
    kw = dict(n_layers=2, n_experts=2, moe_top_k=1, moe_aux_coef=0.01)
    jcfg, tcfg, jp, tp = _pair(2, **kw)
    (jloss, jgrads), (loss, grads), tsh, _ = _steps(
        {"pp": 2, "dp": 2, "ep": 2}, jcfg, tcfg, jp, tp, _batch(2), 2,
        ep_axis="ep", dp_axis="dp")
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _close(grads, jgrads)
    assert grads["stages"]["moe"]["w_in"].shape == \
        tsh["stages"]["moe"]["w_in"].shape


def test_interleaved_pp_moe_grads_match_jax():
    """The interleaved schedule (2 chunks a stage slot) with stage-local
    MoE chains every chunk's aux: JAX's loss and gradients, and the
    oracle's."""
    kw = dict(n_layers=8, n_experts=4, moe_top_k=2, moe_aux_coef=0.02)
    jcfg, tcfg, jp, tp = _pair(3, **kw)
    batch = _batch(3)
    (jloss, jgrads), (loss, grads), _, _ = _steps(
        {"pp": 2}, jcfg, tcfg, jp, tp, batch, 4, n_chunks=2)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _close(grads, jgrads)
    ref_loss, ref = _oracle(tp, batch, tcfg, 4)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    _close_flat(tpp.ppv_merge_params(grads), ref)


def test_pp_moe_validation():
    """JAX's refusals, word for word."""
    mesh = make_mesh({"pp": 2, "ep": 2}, device="cpu")
    cfg = tl.LlamaConfig.preset("debug", n_layers=8, n_experts=4)
    with pytest.raises(NotImplementedError, match="stage-local"):
        tpp.make_pp_llama_train(mesh, cfg, n_micro=2, n_chunks=2,
                                ep_axis="ep")
    dense = tl.LlamaConfig.preset("debug", n_layers=4)
    with pytest.raises(ValueError, match="ep_axis given but"):
        tpp.make_pp_llama_train(mesh, dense, n_micro=2, ep_axis="ep")
    with pytest.raises(ValueError, match="not divisible by 2 stages x 3"):
        tpp.make_pp_llama_train(mesh, dense, n_micro=2, n_chunks=3)
    step = tpp.make_pp_llama_train(make_mesh({"pp": 2}, device="cpu"),
                                   dense, n_micro=3)
    with pytest.raises(ValueError, match="not divisible by n_micro=3"):
        step({}, torch.zeros((4, 9), dtype=torch.long))
