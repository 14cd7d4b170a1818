"""Tensor-parallel serving (a tree sharded over ``{"tp": 2}`` by
``param_specs`` or ``quantized_param_specs``) against the JAX package,
token for token, float32 debug widths.

The twins of the graft's tp serving phase (``__graft_entry__.py``
phase 5: ``SlotServer`` over tp = 2, plain and int8 KV caches, its three
requests against the unsharded ``generate``), of tests/test_wquant.py::
test_w8_tp_sharded (the W8A16 tree over tp = 2) and of tests/
test_speculative.py::test_speculative_tp_sharded and ::test_speculative_
tp_int8_combined.  Each slot projects its own heads, writes its own part
of the cache (models/sharded.py ``HeadSplit``) and attends it; the logits
are also held within 1e-5 of the unsharded port's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import generate as jax_generate
from starway_tpu.models import init_params as jax_init_params
from starway_tpu.models.speculative import (
    draft_from_truncation as jax_truncate)
from starway_tpu.models.speculative import (
    generate_speculative as jax_speculative)
from starway_tpu.ops.quantize import quantize_params as jax_quantize
from starway_tpu_torch.models import (LlamaConfig, SlotServer, generate,
                                      generate_speculative, param_specs,
                                      quantized_param_specs)
from starway_tpu_torch.models import llama as tl
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.generate import decode_step, init_cache
from starway_tpu_torch.models.speculative import draft_from_truncation
from starway_tpu_torch.parallel import make_mesh, shard_tree
from torch_port_util import tree_to_numpy

REQS = [([3, 1, 4, 1], 5), ([2, 7], 4), ([5, 5, 6], 3)]


def _torch(tree):
    return params_from_numpy(tree_to_numpy(tree), device="cpu")


def _tp(tree, specs):
    return shard_tree(tree, make_mesh({"tp": 2}, device="cpu"), specs)


@pytest.mark.parametrize("kv_quant", ["none", "int8", "w8"])
def test_tp_slot_server_matches_jax(kv_quant):
    """Phase 5 of the graft: continuous batching over tp = 2, each request
    equal to the unsharded JAX ``generate``; "w8" serves the W8A16 tree
    of ``quantized_param_specs`` over an int8 KV cache."""
    from starway_tpu_torch.ops.quantize import quantize_params

    w8 = kv_quant == "w8"
    kv = "int8" if w8 else kv_quant
    jcfg = JaxConfig.preset("debug", kv_quant=kv)
    jp = jax_init_params(jax.random.PRNGKey(4), jcfg)
    cfg = LlamaConfig.preset("debug", kv_quant=kv)
    tree = _tp(quantize_params(_torch(jp)), quantized_param_specs(cfg)) \
        if w8 else _tp(_torch(jp), param_specs(cfg))
    if w8:
        jp = jax_quantize(jp)
    srv = SlotServer(tree, cfg, n_slots=2, max_len=32, chunk=4)
    rids = [srv.submit(p, m) for p, m in REQS]
    done = srv.run()
    assert sorted(done) == sorted(rids)
    for rid, (p, m) in zip(rids, REQS):
        want = np.asarray(jax_generate(jp, jcfg, jnp.asarray([p], jnp.int32),
                                       m)[0, len(p):])
        np.testing.assert_array_equal(done[rid], want)


def test_tp_w8_generate_and_logits():
    """The W8A16 tree over tp = 2 (q under the raw spec, the scales on the
    surviving output dims) reproduces the unsharded W8 greedy output of
    the JAX package, and the decode logits of the unsharded port."""
    from starway_tpu_torch.ops.quantize import quantize_params

    jcfg = JaxConfig.preset("debug")
    jq = jax_quantize(jax_init_params(jax.random.PRNGKey(0), jcfg))
    cfg = LlamaConfig.preset("debug")
    tq = quantize_params(_torch(jax_init_params(jax.random.PRNGKey(0),
                                                jcfg)))
    sq = _tp(tq, quantized_param_specs(cfg))
    prompt = [[3, 1, 4, 1, 5]]
    want = np.asarray(jax_generate(jq, jcfg, jnp.asarray(prompt, jnp.int32),
                                   6))
    got = generate(sq, cfg, torch.tensor(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    one = torch.tensor([[7]])
    la, _ = decode_step(tq, init_cache(cfg, 1, 8, device="cpu"), one[:, 0],
                        0, cfg)
    lb, _ = decode_step(sq, init_cache(cfg, 1, 8, device="cpu", params=sq),
                        one[:, 0], 0, cfg)
    np.testing.assert_allclose(lb.numpy(), la.numpy(), atol=1e-5)
    assert tl.forward(sq, torch.tensor(prompt), cfg).shape == (1, 5, 512)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_speculative_tp_matches_jax(kv_quant):
    """The twins of test_speculative_tp_sharded (a separate draft model)
    and test_speculative_tp_int8_combined (a truncation draft over int8
    caches): target and draft both over tp = 2, tokens equal to JAX's."""
    jcfg = JaxConfig.preset("debug", kv_quant=kv_quant)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = LlamaConfig.preset("debug", kv_quant=kv_quant)
    if kv_quant == "none":
        jdcfg = JaxConfig.preset("debug", n_layers=1)
        jd = jax_init_params(jax.random.PRNGKey(1), jdcfg)
        dcfg = LlamaConfig.preset("debug", n_layers=1)
        td = _torch(jd)
        prompt, n = [[3, 1, 4, 1, 5]], 9
        want = jax_speculative(jp, jcfg, jd, jdcfg, jnp.asarray(prompt),
                               n, gamma=3)
    else:
        jd, jdcfg = jax_truncate(jp, jcfg, 1)
        td, dcfg = draft_from_truncation(_torch(jp), cfg, 1)
        prompt, n = [[3, 1, 4, 1, 5, 9]], 8
        want = jax_generate(jp, jcfg, jnp.asarray(prompt, jnp.int32), n)
    got = generate_speculative(_tp(_torch(jp), param_specs(cfg)), cfg,
                               _tp(td, param_specs(dcfg)), dcfg,
                               torch.tensor(prompt), n, gamma=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tp_serving_refuses_other_meshes():
    """Serving takes a tree over {"tp": n} in one process; a tree with a
    data axis above 1 is refused, naming ROADMAP.md."""
    cfg = LlamaConfig.preset("debug")
    sh = shard_tree(tl.init_params(cfg, 0, device="cpu"),
                    make_mesh({"dp": 2, "tp": 2}, device="cpu"),
                    param_specs(cfg))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_cache(cfg, 1, 8, device="cpu", params=sh)
