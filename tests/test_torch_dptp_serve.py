"""Serving a tree sharded over data and tensor axes (``{"dp": 2, "tp": 2}``)
and across processes, against the JAX package, token for token, float32
debug widths.

The JAX package serves whatever ``NamedSharding`` its jitted functions are
given (tests/test_generate.py::test_generate_tp_sharded); these cases give
its ``generate`` and ``generate_speculative`` the tree over the same
``{"dp": 2, "tp": 2}`` mesh of its 8 virtual CPU devices.  The port cuts
the batch rows (the server's slots) over dp as a training batch is cut,
each data group's tp slots hold their kv heads of their rows
(models/sharded.py ``HeadSplit`` with ``rows``), and the logits are held
within 1e-5 of the unsharded port's.  Two gloo processes serve the same
requests in the multi-controller style and must agree bit for bit, with
each other and with JAX's tokens.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from conftest import free_port
from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import generate as jax_generate
from starway_tpu.models import init_params as jax_init_params
from starway_tpu.models import param_specs as jax_param_specs
from starway_tpu.models.llama import (
    quantized_param_specs as jax_quantized_specs)
from starway_tpu.models.serving import SlotServer as JaxSlotServer
from starway_tpu.models.speculative import (
    generate_speculative as jax_speculative)
from starway_tpu.ops.quantize import quantize_params as jax_quantize
from starway_tpu.parallel import make_mesh as jax_mesh
from starway_tpu_torch.models import (LlamaConfig, SlotServer, generate,
                                      generate_speculative, param_specs,
                                      quantized_param_specs)
from starway_tpu_torch.models import llama as tl
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.generate import (decode_step, init_cache,
                                               prefill)
from starway_tpu_torch.models.sharded import HeadSplit, data_groups
from starway_tpu_torch.parallel import make_mesh, shard_tree
from torch_port_util import (SERVE_PROMPT, SERVE_REQS, save_tree,
                             serve_runs, tree_to_numpy)

TESTS = Path(__file__).resolve().parent
DPTP = {"dp": 2, "tp": 2}


def _torch(tree):
    return params_from_numpy(tree_to_numpy(tree), device="cpu")


def _port(tree, specs, shape=DPTP):
    return shard_tree(tree, make_mesh(shape, device="cpu"), specs)


def _jax(tree, specs, shape=DPTP):
    mesh = jax_mesh(shape)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)


@pytest.mark.parametrize("kv_quant", ["none", "int8", "w8"])
def test_dptp_slot_server_matches_jax(kv_quant):
    """Continuous batching over dp x tp = 2 x 2 (two slots a data group),
    each request equal to JAX's ``generate`` over the same mesh; "w8"
    serves the W8A16 tree of ``quantized_param_specs`` over an int8 KV
    cache."""
    from starway_tpu_torch.ops.quantize import quantize_params

    w8 = kv_quant == "w8"
    kv = "int8" if w8 else kv_quant
    jcfg = JaxConfig.preset("debug", kv_quant=kv)
    jp = jax_init_params(jax.random.PRNGKey(4), jcfg)
    cfg = LlamaConfig.preset("debug", kv_quant=kv)
    if w8:
        tree = _port(quantize_params(_torch(jp)), quantized_param_specs(cfg))
        jp = jax_quantize(jp)
        jtree = _jax(jp, jax_quantized_specs(jcfg))
    else:
        tree = _port(_torch(jp), param_specs(cfg))
        jtree = _jax(jp, jax_param_specs(jcfg))
    srv = SlotServer(tree, cfg, n_slots=4, max_len=32, chunk=4)
    rids = [srv.submit(p, m) for p, m in SERVE_REQS]
    done = srv.run()
    assert sorted(done) == sorted(rids)
    for rid, (p, m) in zip(rids, SERVE_REQS):
        want = np.asarray(jax_generate(jtree, jcfg,
                                       jnp.asarray([p], jnp.int32),
                                       m)[0, len(p):])
        np.testing.assert_array_equal(done[rid], want)
    # The cache: each slot holds its kv heads of its data group's rows.
    k = srv.cache["k"]
    assert isinstance(k, HeadSplit) and k.rows == [(0, 2), (0, 2),
                                                   (2, 4), (2, 4)]
    assert k.shape == (cfg.n_layers, 4, cfg.n_kv_heads, 32, cfg.head_dim)
    assert [tuple(p.shape[1:3]) for p in k.parts] == [
        (2, cfg.n_kv_heads // 2)] * 4


def test_dptp_generate_matches_jax_and_logits():
    """``generate()`` on a batch of two over dp x tp gives JAX's tokens
    over the same mesh; the prefill and decode logits are within 1e-5 of
    the unsharded port's, and the tp shards are held once (the data
    groups share them)."""
    jcfg = JaxConfig.preset("debug")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = LlamaConfig.preset("debug")
    whole = _torch(jp)
    tree = _port(whole, param_specs(cfg))
    prompt = torch.tensor(SERVE_PROMPT)
    want = np.asarray(jax_generate(_jax(jp, jax_param_specs(jcfg)), jcfg,
                                   jnp.asarray(SERVE_PROMPT, jnp.int32), 6))
    np.testing.assert_array_equal(generate(tree, cfg, prompt, 6).numpy(),
                                  want)
    la, ca = prefill(whole, cfg, prompt, 8)
    lb, cb = prefill(tree, cfg, prompt, 8)
    np.testing.assert_allclose(lb.numpy(), la.numpy(), atol=1e-5)
    tok = torch.tensor([7, 9])
    da, _ = decode_step(whole, ca, tok, 5, cfg)
    db, _ = decode_step(tree, cb, tok, 5, cfg)
    np.testing.assert_allclose(db.numpy(), da.numpy(), atol=1e-5)
    # Each data group's view holds the very tensors of the tree's tp slots.
    groups = data_groups(tree)
    wq = tree["layers"]["wq"]
    for g in (0, 1):
        view = groups.views[g]["layers"]["wq"]
        assert [t.data_ptr() for t in view.shards.values()] == [
            wq.shards[wq.sharding.mesh.slots[i]].data_ptr() for i in (0, 1)]
    # The rows of the decode cache: the data groups' blocks of the batch.
    assert cb["k"].rows == [(0, 1), (0, 1), (1, 2), (1, 2)]
    torch.testing.assert_close(
        torch.cat([torch.cat(cb["k"].parts[2 * g:2 * g + 2], dim=2)
                   for g in (0, 1)], dim=1), ca["k"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_dptp_speculative_matches_jax(kv_quant):
    """``generate_speculative`` with target and draft over dp x tp on a
    batch of two: JAX's tokens over the same mesh."""
    jcfg = JaxConfig.preset("debug", kv_quant=kv_quant)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jdcfg = JaxConfig.preset("debug", n_layers=1, kv_quant=kv_quant)
    jd = jax_init_params(jax.random.PRNGKey(1), jdcfg)
    cfg = LlamaConfig.preset("debug", kv_quant=kv_quant)
    dcfg = LlamaConfig.preset("debug", n_layers=1, kv_quant=kv_quant)
    prompt = jnp.asarray(SERVE_PROMPT, jnp.int32)
    want = jax_speculative(_jax(jp, jax_param_specs(jcfg)), jcfg,
                           _jax(jd, jax_param_specs(jdcfg)), jdcfg,
                           prompt, 9, gamma=3)
    got = generate_speculative(_port(_torch(jp), param_specs(cfg)), cfg,
                               _port(_torch(jd), param_specs(dcfg)), dcfg,
                               torch.tensor(SERVE_PROMPT), 9, gamma=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dptp_prefix_caching_matches_jax():
    """Prefixed admissions over dp x tp: a registered prefix's rows are
    filed into the slot's data group and its suffix ingested there; every
    request (two prefixes and none, cohabiting) generates what the JAX
    server does."""
    jcfg = JaxConfig.preset("debug")
    jp = jax_init_params(jax.random.PRNGKey(5), jcfg)
    cfg = LlamaConfig.preset("debug")
    rng = np.random.default_rng(7)
    pre = {"a": list(map(int, rng.integers(1, 512, 9))),
           "b": list(map(int, rng.integers(1, 512, 4))), None: []}
    reqs = [(list(map(int, rng.integers(1, 512, n))), m, w)
            for n, m, w in [(3, 6, "a"), (7, 4, "a"), (2, 8, "b"),
                            (5, 5, None), (1, 7, "a")]]
    outs = []
    for srv in (JaxSlotServer(jp, jcfg, n_slots=4, max_len=64, chunk=4),
                SlotServer(_port(_torch(jp), param_specs(cfg)), cfg,
                           n_slots=4, max_len=64, chunk=4)):
        pids = {"a": srv.register_prefix(pre["a"]),
                "b": srv.register_prefix(pre["b"]), None: None}
        rids = [srv.submit(s, m, prefix=pids[w]) for s, m, w in reqs]
        done = srv.run()
        outs.append([done[r] for r in rids])
    for (s, m, w), j, t in zip(reqs, *outs):
        np.testing.assert_array_equal(t, j, err_msg=f"prefix {w}")


def test_fsdp_axis_cuts_the_rows_like_dp():
    """``"fsdp"`` is a data axis for serving as for training: a tree over
    ``{"fsdp": 2, "tp": 2}`` (the weights replicated over fsdp) serves the
    unsharded port's tokens."""
    cfg = LlamaConfig.preset("debug")
    whole = tl.init_params(cfg, 0, device="cpu")
    tree = _port(whole, param_specs(cfg), {"fsdp": 2, "tp": 2})
    prompt = torch.tensor(SERVE_PROMPT)
    np.testing.assert_array_equal(generate(tree, cfg, prompt, 5).numpy(),
                                  generate(whole, cfg, prompt, 5).numpy())


def test_dptp_refuses_what_does_not_split():
    """What the data axes do not divide is served in uneven blocks, as the
    JAX package serves it over the same mesh: a batch of three rows and a
    server of three slots over dp = 2, rolling slots over the sharded
    tree, and a leaf split over a data axis (gathered before its use)."""
    jcfg = JaxConfig.preset("debug")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = LlamaConfig.preset("debug")
    tree = _port(_torch(jp), param_specs(cfg))
    jtree = _jax(jp, jax_param_specs(jcfg))
    three = [[1, 2], [3, 4], [5, 6]]
    want = np.asarray(jax_generate(jtree, jcfg, jnp.asarray(three,
                                                            jnp.int32), 4))
    np.testing.assert_array_equal(
        generate(tree, cfg, torch.tensor(three), 4).numpy(), want)
    srv = SlotServer(tree, cfg, n_slots=3, max_len=16)
    assert srv.cache["k"].rows == [(0, 2), (0, 2), (2, 3), (2, 3)]
    rids = [srv.submit(p, 4) for p in three]
    done = srv.run()
    for rid, row in zip(rids, want):
        np.testing.assert_array_equal(done[rid], row[2:])
    rcfg = LlamaConfig.preset("debug", sliding_window=4)
    jrcfg = JaxConfig.preset("debug", sliding_window=4)
    srv = SlotServer(tree, rcfg, n_slots=2, max_len=16)
    rids = [srv.submit(p, 7) for p in three]
    done = srv.run()
    want = np.asarray(jax_generate(jtree, jrcfg, jnp.asarray(three,
                                                             jnp.int32), 7))
    for rid, row in zip(rids, want):
        np.testing.assert_array_equal(done[rid], row[2:])
    specs, jspecs = param_specs(cfg), jax_param_specs(jcfg)
    specs["embed"] = type(specs["embed"])("dp", None)
    jspecs["embed"] = type(jspecs["embed"])("dp", None)
    split = _port(_torch(jp), specs)
    want = jax_generate(_jax(jp, jspecs), jcfg,
                        jnp.asarray(SERVE_PROMPT, jnp.int32), 4)
    np.testing.assert_array_equal(
        generate(split, cfg, torch.tensor(SERVE_PROMPT), 4).numpy(),
        np.asarray(want))


def test_head_split_rows_route_a_slot_to_its_group():
    """Slicing a row-split cache's batch dimension takes the parts of the
    data group that holds the rows; a slice across two groups is
    refused."""
    parts = [torch.full((1, 2, 1, 3), float(j)) for j in range(4)]
    c = HeadSplit(parts, 2, [(0, 2), (0, 2), (2, 4), (2, 4)], 4)
    assert c.shape == (1, 4, 2, 3)
    one = c[:, 3:4]
    assert one.rows is None and [p[0, 0, 0, 0].item() for p in one.parts] \
        == [2.0, 3.0]
    one.copy_(HeadSplit([torch.full((1, 1, 1, 3), 9.0)] * 2, 2))
    assert parts[2][0, 1].eq(9).all() and parts[2][0, 0].eq(2).all()
    assert parts[0].eq(0).all()
    with pytest.raises(IndexError, match="cross"):
        c[:, 1:3]
    assert c[0].rows == c.rows and c[0].dim == 1


def _serve_across(tmp_path, shape: str) -> list:
    world = 2
    port = free_port()
    code = ("import sys; sys.path[:0] = sys.argv[1:3]\n"
            "from torch_port_util import serve_worker\n"
            "serve_worker(int(sys.argv[3]), int(sys.argv[4]), "
            "int(sys.argv[5]), sys.argv[6], sys.argv[7])\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(TESTS), str(TESTS.parent), str(r),
         str(world), str(port), str(tmp_path), shape],
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
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("shape", ["tp=2", "dp=2,tp=2"])
def test_serving_across_two_processes(tmp_path, shape):
    """A tree whose slots live in two gloo processes serves ``SlotServer``
    and ``generate()`` with every process running the same loop on the
    same requests: the processes' tokens are bit-equal to each other, to
    the one-process run's and to JAX's."""
    jcfg = JaxConfig.preset("debug")
    jp = jax_init_params(jax.random.PRNGKey(2), jcfg)
    save_tree(str(tmp_path / "params.npz"), tree_to_numpy(jp))
    runs = _serve_across(tmp_path, shape)
    one = serve_runs({k: int(v) for k, v in
                      (kv.split("=") for kv in shape.split(","))},
                     str(tmp_path))
    for got in runs:
        assert sorted(got) == sorted(one)
        for key in one:
            np.testing.assert_array_equal(got[key], one[key], err_msg=key)
    for i, (p, m) in enumerate(SERVE_REQS):
        want = jax_generate(jp, jcfg, jnp.asarray([p], jnp.int32), m)
        np.testing.assert_array_equal(one[f"server/{i}"],
                                      np.asarray(want)[0, len(p):])
    want = jax_generate(jp, jcfg, jnp.asarray(SERVE_PROMPT, jnp.int32), 6)
    np.testing.assert_array_equal(one["generate"], np.asarray(want))
