"""The port's Llama model (starway_tpu_torch.models.llama, .generate)
against the JAX package's on the same parameters, carried over with
``params_from_numpy``: forward logits, the prefill caches and decode_step
logits, on the debug preset in float32.

Tolerances: logits atol 1e-4 (float32 through two layers; the frameworks
sum in different orders), caches atol 1e-5, rope tables atol 1e-5.  int8
cache codes may differ by one where a value sits within float32 rounding
of a code boundary; the test bounds that."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from starway_tpu.models import llama as jl
from starway_tpu.ops.quantize import quantize_params as jax_quantize_params
from starway_tpu_torch.models import llama as tl
from starway_tpu_torch.models.convert import params_from_numpy
from torch_port_util import to_numpy, tree_to_numpy

# The packages re-export generate(), which shadows the module name.
jgen = importlib.import_module("starway_tpu.models.generate")
tgen = importlib.import_module("starway_tpu_torch.models.generate")

LOGIT_ATOL = 1e-4

VARIANTS = {
    "base": dict(),
    "qwen2": dict(attn_bias=True),
    "gemma": dict(mlp_act="gelu_tanh", scaled_embed=True),
    "window": dict(sliding_window=5),
    "llama3_rope": dict(rope_scaling=("llama3", 8.0, 1.0, 4.0, 64)),
    "yarn_rope": dict(rope_scaling=("yarn", 4.0, 32, 32.0, 1.0, 1.1, True)),
}


def _pair(variant="base", seed=0, **extra):
    kw = dict(VARIANTS[variant], **extra)
    jcfg = jl.LlamaConfig.preset("debug", **kw)
    tcfg = tl.LlamaConfig.preset("debug", **kw)
    jp = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    if variant == "qwen2":  # zero biases would make the flag a no-op
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), 3)
        for key, name in zip(keys, ("bq", "bk", "bv")):
            jp["layers"][name] = 0.3 * jax.random.normal(
                key, jp["layers"][name].shape)
    return jcfg, tcfg, jp, params_from_numpy(tree_to_numpy(jp), device="cpu")


def _tokens(seed, b=2, s=11, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (b, s), np.int32)


def test_config_fields_and_presets_match():
    jf = {f.name: f.default for f in dataclasses.fields(jl.LlamaConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tl.LlamaConfig)}
    assert jf == tf
    assert jl.LlamaConfig.PRESETS == tl.LlamaConfig.PRESETS
    cfg = tl.LlamaConfig.preset("llama3-8b")
    assert cfg.head_dim == 128 and cfg.compute_dtype == torch.bfloat16
    for bad in (dict(kv_quant="int4"), dict(sliding_window=0),
                dict(d_model=100, n_heads=3), dict(mlp_act="relu"),
                dict(rope_scaling=("linear",))):
        with pytest.raises(ValueError):
            tl.LlamaConfig.preset("debug", **bad)


@pytest.mark.parametrize("scaling", [
    None, ("linear", 4.0), ("llama3", 8.0, 1.0, 4.0, 64),
    ("yarn", 4.0, 32, 32.0, 1.0, 1.1, True),
    ("yarn", 2.0, 16, 16.0, 2.0, 1.0, False),
    ("longrope", 16, 1.2, tuple(np.linspace(1, 2, 8)),
     tuple(np.linspace(1, 4, 8))),
    ("longrope_fixed", 1.1, tuple(np.linspace(1, 3, 8)))])
def test_rope_tables_match(scaling):
    for seq in (12, 40):
        jc, js = jl.rope_tables(seq, 16, 10000.0, scaling)
        tc, ts = tl.rope_tables(seq, 16, 10000.0, scaling)
        np.testing.assert_allclose(to_numpy(tc), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(to_numpy(ts), np.asarray(js), atol=1e-5)
    cfg = tl.LlamaConfig.preset("debug", rope_scaling=(
        "longrope", 16, 1.2, tuple(np.linspace(1, 2, 8)),
        tuple(np.linspace(1, 4, 8))))
    assert tl.resolve_longrope(cfg, 64).rope_scaling[0] == "longrope_fixed"


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_match(variant):
    jcfg, tcfg, jp, tp = _pair(variant)
    toks = _tokens(1)
    want = jl.forward(jp, jnp.asarray(toks), jcfg)
    got = tl.forward(tp, torch.as_tensor(toks).long(), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 11, 512)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               atol=LOGIT_ATOL)


def test_forward_options_and_model_module():
    jcfg, tcfg, jp, tp = _pair()
    toks = _tokens(2)
    tt = torch.as_tensor(toks).long()
    pos = np.asarray([3, 10], np.int32)
    jl_logits, _aux, (jk, jv) = jl.forward(
        jp, jnp.asarray(toks), jcfg, return_aux=True, return_kv=True,
        logit_positions=jnp.asarray(pos))
    logits, (k, v) = tl.forward(tp, tt, tcfg, return_kv=True,
                                logit_positions=torch.as_tensor(pos))
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jl_logits),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(to_numpy(k), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(to_numpy(v), np.asarray(jv), atol=1e-5)
    last = tl.forward(tp, tt, tcfg, last_only=True)
    torch.testing.assert_close(last, tl.forward(tp, tt, tcfg)[:, -1:])
    model = tl.LlamaModel(tp, tcfg)
    torch.testing.assert_close(model(tt), tl.forward(tp, tt, tcfg))
    assert model.params["layers"]["wq"] is model.layers__wq


def test_w8a16_forward_matches():
    jcfg, tcfg, jp, _ = _pair()
    jq = jax_quantize_params(jp)
    tq = params_from_numpy(tree_to_numpy(jq), device="cpu")
    assert tq["layers"]["wq"]["q"].dtype == torch.int8
    toks = _tokens(3)
    np.testing.assert_allclose(
        to_numpy(tl.forward(tq, torch.as_tensor(toks).long(), tcfg)),
        np.asarray(jl.forward(jq, jnp.asarray(toks), jcfg)), atol=LOGIT_ATOL)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_prefill_and_decode_step_match(kv_quant):
    jcfg, tcfg, jp, tp = _pair(kv_quant=kv_quant)
    toks = _tokens(4, s=9)
    max_len = 16
    jlog, jcache = jgen.prefill(jp, jcfg, jnp.asarray(toks), max_len)
    tlog, tcache = tgen.prefill(tp, tcfg, torch.as_tensor(toks).long(),
                                max_len)
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog),
                               atol=LOGIT_ATOL)
    assert set(tcache) == set(jcache)
    for name in jcache:
        assert tuple(tcache[name].shape) == jcache[name].shape
    _assert_caches_close(tcache, jcache)

    # Scalar position, then per-row positions (a ragged batch).
    nxt = np.asarray([5, 7], np.int32)
    jlog, jcache = jgen.decode_step(jp, jcache, jnp.asarray(nxt), 9, jcfg)
    tlog, tcache_in = tgen.decode_step(tp, tcache, torch.as_tensor(nxt).long(),
                                       9, tcfg)
    assert tcache_in is tcache  # updated in place
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog),
                               atol=LOGIT_ATOL)
    pos = np.asarray([10, 4], np.int32)
    jlog, jcache = jgen.decode_step(jp, jcache, jnp.asarray(nxt),
                                    jnp.asarray(pos), jcfg)
    tlog, tcache = tgen.decode_step(tp, tcache, torch.as_tensor(nxt).long(),
                                    torch.as_tensor(pos), tcfg)
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog),
                               atol=LOGIT_ATOL)
    _assert_caches_close(tcache, jcache)


def _assert_caches_close(tcache, jcache):
    for name in jcache:
        got, want = to_numpy(tcache[name]), np.asarray(jcache[name])
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=name)


def test_decode_step_clamps_out_of_range_writes():
    """A write position past the cache end lands on the last slot, as the
    reference's clamped dynamic_update_slice does: no error, no wrap."""
    jcfg, tcfg, jp, tp = _pair()
    toks = _tokens(5, s=6)
    _, jcache = jgen.prefill(jp, jcfg, jnp.asarray(toks), 8)
    _, tcache = tgen.prefill(tp, tcfg, torch.as_tensor(toks).long(), 8)
    nxt = np.asarray([3, 4], np.int32)
    pos = np.asarray([7, 11], np.int32)
    _, jcache = jgen.decode_step(jp, jcache, jnp.asarray(nxt),
                                 jnp.asarray(pos), jcfg)
    _, tcache = tgen.decode_step(tp, tcache, torch.as_tensor(nxt).long(),
                                 torch.as_tensor(pos), tcfg)
    _assert_caches_close(tcache, jcache)
    assert float(tcache["k"][:, 1, :, 7].abs().sum()) > 0


def test_unported_paths_raise():
    """MoE training is ported: ``loss_fn`` and ``value_and_grad`` of an
    expert model equal the JAX package's loss (its gradients:
    tests/test_torch_mesh_train.py).  The rolling paths are ported
    (tests/test_torch_rolling.py): on a config without a window they
    refuse as the JAX package does, with a ValueError."""
    jcfg = jl.LlamaConfig.preset("debug", n_experts=4)
    cfg = tl.LlamaConfig.preset("debug", n_experts=4)
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    mp = params_from_numpy(tree_to_numpy(jp), device="cpu")
    assert "moe" in mp["layers"] and "w_up" not in mp["layers"]
    batch = _tokens(5, b=1, s=5)
    want = float(jl.loss_fn(jp, jnp.asarray(batch), jcfg))
    tb = torch.as_tensor(batch).long()
    assert abs(float(tl.loss_fn(mp, tb, cfg)) - want) < 1e-5
    assert abs(float(tl.value_and_grad(mp, tb, cfg)[0]) - want) < 1e-5
    _, tcfg, _, tp = _pair()
    cache = tgen.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="sliding_window"):
        tgen.decode_step(tp, cache, torch.tensor([1]), 0, tcfg, rolling=True)
    with pytest.raises(ValueError, match="sliding_window"):
        tgen.prefill_rolling(tp, tcfg, torch.tensor([[1, 2]]))


def test_trainer_unported_options_raise():
    """Every Trainer option is ported now (ZeRO mode and MoE:
    tests/test_torch_fsdp.py, tests/test_torch_mesh_train.py); what the
    JAX Trainer refuses the port refuses alike: half of mesh/fsdp_axis,
    stats without a stats-producing moe_fn, stats in ZeRO mode, and a DP
    port beside ZeRO."""
    from starway_tpu_torch.models.trainer import Trainer
    from starway_tpu_torch.parallel import make_mesh
    from starway_tpu_torch.utils.optim import adamw

    _, tcfg, _, tp = _pair()
    assert Trainer(tcfg, adamw(1e-3), tp, dp_port=object()).dp_port is not None
    mesh = make_mesh({"fsdp": 2}, device="cpu")
    mcfg = tl.LlamaConfig.preset("debug", n_experts=4)
    for cfg, kw, err in (
            (tcfg, dict(fsdp_axis="fsdp"), ValueError),
            (tcfg, dict(mesh=mesh), ValueError),
            (tcfg, dict(mesh=mesh, fsdp_axis="fsdp", dp_port=object()),
             ValueError),
            (tcfg, dict(with_moe_stats=True), ValueError),
            (mcfg, dict(with_moe_stats=True), ValueError),
            (mcfg, dict(mesh=mesh, fsdp_axis="fsdp", with_moe_stats=True),
             NotImplementedError)):
        with pytest.raises(err):
            Trainer(cfg, adamw(1e-3), tp, **kw)
