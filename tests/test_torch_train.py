"""The port's training path (starway_tpu_torch.models.llama loss_fn /
value_and_grad / make_train_step, models.trainer.Trainer, utils.optim
.adamw) against the JAX package's (``jax.value_and_grad(loss_fn)``,
``Trainer`` + ``optax.adamw``) on the same numpy parameters and batches,
and the remat structure: how often the attention runs per step, and that
remat leaves the gradients unchanged.

Tolerances: float32 loss rtol 1e-6 and gradients atol 2e-6 (the two
frameworks sum in other orders); bfloat16 loss atol 1e-2 and gradients
3e-2 of max |grad| (bfloat16 rounds at different points in the two
frameworks: a few bfloat16 ulps of the largest gradient).  After several
AdamW steps the parameters agree to 1e-5 except where a gradient is
within float32 noise of 0, where Adam's normalised step can differ by up
to 2 * lr per step; the test bounds both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from starway_tpu.models import llama as jl
from starway_tpu.models.trainer import Trainer as JaxTrainer
from starway_tpu.utils import checkpoint as jax_checkpoint
from starway_tpu_torch.models import llama as tl
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.trainer import Trainer
from starway_tpu_torch.ops.attention import blockwise_attention
from starway_tpu_torch.utils.optim import adamw
from starway_tpu_torch.utils.tree import tree_leaves
from torch_port_util import to_numpy, tree_to_numpy

GRAD_ATOL = 2e-6
LR = 1e-3


def _pair(seed=0, **kw):
    jcfg = jl.LlamaConfig.preset("debug", **kw)
    tcfg = tl.LlamaConfig.preset("debug", **kw)
    return jcfg, tcfg, tree_to_numpy(
        jl.init_params(jax.random.PRNGKey(seed), jcfg))


def _batch(seed, b=2, s=17, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), np.int32)


def _tt(batch):
    return torch.as_tensor(batch).long()


def _assert_grads_close(jgrads, tgrads, atol_fn):
    jl_leaves = jax.tree_util.tree_leaves(jgrads)
    t_leaves = tree_leaves(tgrads)
    assert len(jl_leaves) == len(t_leaves)
    for a, b in zip(jl_leaves, t_leaves):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(to_numpy(b), a, atol=atol_fn(a))


@pytest.mark.parametrize("variant", [dict(), dict(sliding_window=5),
                                     dict(attn_bias=True)])
def test_loss_and_grads_match_jax(variant):
    """value_and_grad(loss_fn) on the float32 debug preset: the loss and
    every gradient leaf against jax.value_and_grad."""
    jcfg, tcfg, npp = _pair(**variant)
    batch = _batch(1)
    jv, jg = jax.value_and_grad(jl.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, npp), jnp.asarray(batch), jcfg)
    tp = params_from_numpy(npp, device="cpu")
    tv, tg = tl.value_and_grad(tp, _tt(batch), tcfg)
    assert tv.dtype == torch.float32 and tv.dim() == 0
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    _assert_grads_close(jg, tg, lambda a: GRAD_ATOL)
    assert all(not p.requires_grad for p in tree_leaves(tp))


def test_loss_and_grads_match_jax_bf16():
    jcfg, tcfg, npp = _pair(dtype="bfloat16")
    batch = _batch(2)
    jv, jg = jax.value_and_grad(jl.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, npp), jnp.asarray(batch), jcfg)
    tv, tg = tl.value_and_grad(params_from_numpy(npp, device="cpu"),
                               _tt(batch), tcfg)
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(tg))
    np.testing.assert_allclose(float(tv), float(jv), atol=1e-2)
    _assert_grads_close(jg, tg, lambda a: 3e-2 * np.abs(a).max())


def test_loss_and_forward_aux_match_jax():
    """token_ce and forward(return_aux=True) against the JAX functions."""
    jcfg, tcfg, npp = _pair()
    toks = _batch(3, s=9)
    logits, aux = tl.forward(params_from_numpy(npp, device="cpu"), _tt(toks),
                             tcfg, return_aux=True)
    jlogits, jaux = jl.forward(jax.tree_util.tree_map(jnp.asarray, npp),
                               jnp.asarray(toks), jcfg, return_aux=True)
    assert float(aux) == float(jaux) == 0.0 and aux.dtype == torch.float32
    targets = _batch(4, s=9)
    np.testing.assert_allclose(
        float(tl.token_ce(logits, _tt(targets))),
        float(jl.token_ce(jlogits, jnp.asarray(targets))), rtol=1e-6)


def _assert_params_close(jparams, tparams, n_steps):
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    tree_leaves(tparams)):
        diff = np.abs(np.asarray(a, np.float32) - to_numpy(b))
        assert diff.max() <= 2 * LR * n_steps
        assert (diff > 1e-5).mean() < 1e-4


def test_trainer_matches_jax_trainer():
    """Four Trainer.step_sync steps with the port's adamw against the JAX
    Trainer with optax.adamw: losses, parameters and the step count."""
    jcfg, tcfg, npp = _pair()
    jt = JaxTrainer(jcfg, optax.adamw(LR),
                    jax.tree_util.tree_map(jnp.asarray, npp), donate=False)
    tt = Trainer(tcfg, adamw(LR), params_from_numpy(npp, device="cpu"))
    for i in range(4):
        b = _batch(10 + i)
        np.testing.assert_allclose(tt.step_sync(_tt(b)),
                                   jt.step_sync(jnp.asarray(b)), rtol=1e-6)
    assert tt.state.step == jt.state.step == 4
    assert int(tt.state.opt_state.count) == 4
    _assert_params_close(jt.state.params, tt.state.params, 4)
    assert {"grad", "apply"} <= set(tt.telemetry())


def test_trainer_accum_matches_full_batch():
    """Trainer(accum_steps=2) reproduces the full-batch step (mirrors the
    JAX package's test of the same name, same tolerances), the JAX accum
    trainer's loss, and refuses accum_steps < 1."""
    jcfg, tcfg, npp = _pair()
    batch = _batch(6, b=8)
    t1 = Trainer(tcfg, adamw(LR), params_from_numpy(npp, device="cpu"))
    t2 = Trainer(tcfg, adamw(LR), params_from_numpy(npp, device="cpu"),
                 accum_steps=2)
    l1 = t1.step_sync(_tt(batch))
    l2 = t2.step_sync(_tt(batch))
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for a, b in zip(tree_leaves(t1.state.params),
                    tree_leaves(t2.state.params)):
        np.testing.assert_allclose(to_numpy(b), to_numpy(a), atol=5e-5,
                                   rtol=1e-3)
    assert t2.state.step == 1 and "accum_step" in t2.telemetry()
    jt = JaxTrainer(jcfg, optax.adamw(LR),
                    jax.tree_util.tree_map(jnp.asarray, npp), donate=False,
                    accum_steps=2)
    np.testing.assert_allclose(l2, jt.step_sync(jnp.asarray(batch)),
                               rtol=1e-6)
    _assert_params_close(jt.state.params, t2.state.params, 1)
    with pytest.raises(ValueError, match="accum_steps"):
        Trainer(tcfg, adamw(LR), t1.state.params, accum_steps=0)


def test_trainer_donate_false_keeps_params():
    _, tcfg, npp = _pair()
    params = params_from_numpy(npp, device="cpu")
    before = [p.clone() for p in tree_leaves(params)]
    t = Trainer(tcfg, adamw(LR), params, donate=False)
    t.step_sync(_tt(_batch(7)))
    for a, b in zip(before, tree_leaves(params)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, tree_leaves(t.state.params)))


def test_trainer_local_steps_and_ckpt(tmp_path):
    """Steps, save, restore into a trainer from other weights (mirrors the
    JAX package's test of the same name)."""
    _, tcfg, npp = _pair()
    t = Trainer(tcfg, adamw(3e-3), params_from_numpy(npp, device="cpu"))
    losses = [t.step_sync(_tt(_batch(i, b=4, s=33))) for i in range(3)]
    assert all(np.isfinite(losses)) and t.state.step == 3
    t.save(str(tmp_path / "ck"))
    t2 = Trainer(tcfg, adamw(3e-3), tl.init_params(tcfg, 1, device="cpu"))
    t2.restore(str(tmp_path / "ck"))
    assert t2.state.step == 3
    for a, b in zip(tree_leaves((t.state.params, t.state.opt_state)),
                    tree_leaves((t2.state.params, t2.state.opt_state))):
        assert torch.equal(a, b)
    b = _tt(_batch(9, b=4, s=33))
    assert t.step_sync(b) == t2.step_sync(b)


def test_trainer_restores_jax_trainer_checkpoint(tmp_path, monkeypatch):
    """A float32 JAX Trainer checkpoint (npz backend) resumes in the port's
    Trainer: params, AdamW moments and count, and the step; the next step
    then matches the JAX trainer's."""
    monkeypatch.setattr(jax_checkpoint, "_have_orbax", lambda: False)
    jcfg, tcfg, npp = _pair()
    jt = JaxTrainer(jcfg, optax.adamw(LR),
                    jax.tree_util.tree_map(jnp.asarray, npp), donate=False)
    for i in range(2):
        jt.step_sync(jnp.asarray(_batch(20 + i)))
    assert jt.save(str(tmp_path / "ck")) == "npz"
    tt = Trainer(tcfg, adamw(LR), tl.init_params(tcfg, 5, device="cpu"))
    tt.restore(str(tmp_path / "ck"))
    assert tt.state.step == 2 and int(tt.state.opt_state.count) == 2
    for a, b in zip(jax.tree_util.tree_leaves(
            (jt.state.params, jt.state.opt_state)),
            tree_leaves((tt.state.params, tt.state.opt_state))):
        np.testing.assert_array_equal(to_numpy(b), np.asarray(a))
    b = _batch(30)
    np.testing.assert_allclose(tt.step_sync(_tt(b)),
                               jt.step_sync(jnp.asarray(b)), rtol=1e-6)
    _assert_params_close(jt.state.params, tt.state.params, 1)


# ------------------------------------------------------------------- remat


def _remat_cfg(**kw):
    return tl.LlamaConfig.preset("debug", n_layers=3, **kw)


def _counting_attn():
    calls = []

    def attn(q, k, v):
        calls.append(1)
        return blockwise_attention(q, k, v, causal=True)

    return attn, calls


@pytest.mark.parametrize("remat,policy,per_layer", [
    (False, None, 1), (True, "dots", 1), (True, None, 2)])
def test_remat_attention_calls_per_step(remat, policy, per_layer):
    """Under "dots" the attention runs once per layer and step, as with no
    remat (the JAX package's pin: no flash forward replayed in the
    backward); full-layer remat runs it twice (mirrors
    tests/test_remat_policy.py's call-site counts)."""
    cfg = _remat_cfg(remat=remat, remat_policy=policy)
    attn, calls = _counting_attn()
    params = tl.init_params(cfg, 0, device="cpu")
    step = tl.make_train_step(cfg, adamw(LR), attn)
    step(params, adamw(LR).init(params), _tt(_batch(11)))
    assert len(calls) == per_layer * cfg.n_layers


@pytest.mark.parametrize("policy", ["dots", None])
def test_remat_grads_match_no_remat(policy):
    """Checkpointing is numerically neutral: the same loss and gradients
    as the step without remat."""
    params = tl.init_params(_remat_cfg(), 2, device="cpu")
    batch = _tt(_batch(12))
    v0, g0 = tl.value_and_grad(params, batch, _remat_cfg())
    v1, g1 = tl.value_and_grad(params, batch,
                               _remat_cfg(remat=True, remat_policy=policy))
    torch.testing.assert_close(v1, v0, atol=0, rtol=1e-6)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-5)


def test_params_from_numpy_requires_grad():
    """requires_grad=True makes the floating leaves autograd leaves (in
    the dtype asked for), not the int8 codes and scales of W8A16 pairs;
    backward through loss_fn then gives value_and_grad's gradients."""
    from starway_tpu.ops.quantize import quantize_params

    jcfg, tcfg, npp = _pair(dtype="bfloat16")
    params = params_from_numpy(npp, device="cpu", dtype=torch.bfloat16,
                               requires_grad=True)
    assert all(p.requires_grad and p.dtype == torch.bfloat16
               for p in tree_leaves(params))
    batch = _tt(_batch(14))
    tl.loss_fn(params, batch, tcfg).backward()
    _, grads = tl.value_and_grad(params, batch, tcfg)
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        torch.testing.assert_close(p.grad, g, atol=0, rtol=0)
    quant = params_from_numpy(tree_to_numpy(quantize_params(
        jax.tree_util.tree_map(jnp.asarray, npp))), device="cpu",
        requires_grad=True)
    assert not quant["layers"]["wq"]["q"].requires_grad
    assert not quant["layers"]["wq"]["s"].requires_grad
    assert quant["layers"]["attn_norm"].requires_grad


def test_llama_model_parameters_train():
    """LlamaModel's leaves are trainable nn.Parameters: autograd through
    the module gives value_and_grad's gradients."""
    _, tcfg, npp = _pair()
    params = params_from_numpy(npp, device="cpu")
    model = tl.LlamaModel(params, tcfg)
    assert all(p.requires_grad for p in model.parameters())
    assert len(list(model.parameters())) == len(tree_leaves(params))
    batch = _tt(_batch(13))
    logits = model(batch[:, :-1])
    tl.token_ce(logits, batch[:, 1:]).backward()
    _, grads = tl.value_and_grad(params, batch, tcfg)
    for (path, name), g in zip(sorted(model._paths), tree_leaves(grads)):
        torch.testing.assert_close(getattr(model, name).grad, g)
