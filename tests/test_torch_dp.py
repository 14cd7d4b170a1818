"""The gradient exchange at a data-parallel boundary on the port:
``parallel/dp_exchange.py`` (``send_pytree``/``recv_pytree`` over
``ClientPort``/``ServerPort``) and the ``Trainer``'s ``dp_port`` path
(``step_dp``), the twins of tests/test_trainer.py's
``test_trainer_dp_step_pair`` and of the JAX package's dp_exchange.

Held: two port Trainers from the same init end bit-equal after averaged
steps, on every transport, and equal to one in-process step that averages
both ranks' gradients; trees cross between the packages leaf for leaf
(JAX's flatten order, tags ``base_tag + leaf index``); a JAX Trainer and a
port Trainer on one wire agree after a step to 1e-6 (float32: each side
averages the same two gradients, the JAX one and the port one, so only
the two optimizers' roundings differ); and the refusals of the reference
(``accum_steps > 1``, ZeRO mode with ``dp_port``, more than 256 leaves).
"""

import asyncio
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import starway_tpu
import starway_tpu_torch
from starway_tpu.models import llama as jl
from starway_tpu.models.trainer import Trainer as JaxTrainer
from starway_tpu.parallel import ClientPort as JaxClientPort
from starway_tpu.parallel import ServerPort as JaxServerPort
from starway_tpu.parallel import recv_pytree as jax_recv_pytree
from starway_tpu.parallel import send_pytree as jax_send_pytree
from starway_tpu_torch.models import llama as tl
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.trainer import Trainer
from starway_tpu_torch.parallel import (ClientPort, ServerPort, recv_pytree,
                                        send_pytree)
from starway_tpu_torch.utils.optim import adamw
from starway_tpu_torch.utils.tree import tree_leaves, tree_map
from torch_port_util import to_numpy, tree_to_numpy

pytestmark = pytest.mark.asyncio

ADDR = "127.0.0.1"
LR = 1e-3
MIXED_ATOL = 1e-6
PKGS = {"jax": starway_tpu, "port": starway_tpu_torch}


@pytest.fixture(params=["inproc", "tcp", "tcp-pull", "native"])
def transport(request, monkeypatch):
    monkeypatch.setenv("STARWAY_TLS", "inproc,tcp" if request.param ==
                       "inproc" else "tcp")
    monkeypatch.setenv("STARWAY_DEVPULL",
                       "1" if request.param == "tcp-pull" else "0")
    if request.param == "native":
        from starway_tpu_torch.core import native

        if not native.available():
            pytest.skip("native engine unavailable (no toolchain)")
    monkeypatch.setenv("STARWAY_NATIVE",
                       "1" if request.param == "native" else "0")
    return request.param


async def _link(port, server_pkg="port", client_pkg="port"):
    server = PKGS[server_pkg].Server()
    server.listen(ADDR, port)
    client = PKGS[client_pkg].Client()
    await client.aconnect(ADDR, port)
    for _ in range(400):
        if server.list_clients():
            break
        await asyncio.sleep(0.005)
    return server, client


def _cfg_params(seed=0):
    jcfg = jl.LlamaConfig.preset("debug", n_layers=1)
    tcfg = tl.LlamaConfig.preset("debug", n_layers=1)
    return jcfg, tcfg, tree_to_numpy(jl.init_params(jax.random.PRNGKey(seed),
                                                    jcfg))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (4, 33), dtype=np.int32)


async def test_trainer_dp_step_pair(port, transport):
    """Two port Trainers from the same init, each on its own batch, two
    averaged steps: their parameters end bit for bit equal, and equal to
    one in-process Trainer whose step applies (g_a + g_b) / 2."""
    _, cfg, npp = _cfg_params()
    server, client = await _link(port)
    try:
        ta = Trainer(cfg, adamw(LR), params_from_numpy(npp, device="cpu"),
                     dp_port=ClientPort(client))
        tb = Trainer(cfg, adamw(LR), params_from_numpy(npp, device="cpu"),
                     dp_port=ServerPort(server))
        ref = Trainer(cfg, adamw(LR), params_from_numpy(npp, device="cpu"))
        for step in range(2):
            ba = torch.as_tensor(_batch(cfg, 10 + 2 * step)).long()
            bb = torch.as_tensor(_batch(cfg, 11 + 2 * step)).long()
            la, lb = await asyncio.gather(ta.step_dp(ba), tb.step_dp(bb))
            assert np.isfinite(la) and np.isfinite(lb)
            _, ga = tl.value_and_grad(ref.state.params, ba, cfg)
            _, gb = tl.value_and_grad(ref.state.params, bb, cfg)
            ref.state.params, ref.state.opt_state = tl.apply_updates(
                ref.tx, ref.state.params, ref.state.opt_state,
                tree_map(lambda a, b: (a + b) / 2, ga, gb))
        assert ta.state.step == tb.state.step == 2
        for x, y, z in zip(tree_leaves(ta.state.params),
                           tree_leaves(tb.state.params),
                           tree_leaves(ref.state.params)):
            assert torch.equal(x, y) and torch.equal(x, z)
        for name in ("grad", "dp_exchange", "apply"):
            assert name in ta.telemetry() and name in tb.telemetry()
    finally:
        await client.aclose()
        await server.aclose()


def _tree(seed):
    """A tree with unsorted dict keys, a list and three dtypes: the flatten
    order is JAX's, whatever the insertion order."""
    rng = np.random.default_rng(seed)
    return {"zeta": rng.standard_normal((3, 5)).astype(np.float32),
            "alpha": [rng.integers(-9, 9, (7,), dtype=np.int32),
                      rng.standard_normal((2, 2)).astype(np.float32)],
            "mid": {"b": rng.standard_normal((4,)).astype(np.float32),
                    "a": rng.integers(0, 255, (6,), dtype=np.uint8)}}


async def test_pytree_roundtrip_both_ways(port, transport):
    """send_pytree/recv_pytree each way on one link: every leaf arrives
    in place of its twin, same shape, dtype and bytes, with the leaf
    count returned."""
    server, client = await _link(port)
    try:
        for seed, (src, dst) in enumerate(((ClientPort(client),
                                            ServerPort(server)),
                                           (ServerPort(server),
                                            ClientPort(client)))):
            want = tree_map(torch.from_numpy, _tree(seed))
            like = tree_map(torch.zeros_like, want)
            n, got = await asyncio.gather(
                send_pytree(src, want, base_tag=0x500),
                recv_pytree(dst, like, base_tag=0x500))
            assert n == len(tree_leaves(want)) == 5
            assert list(got) == list(want)  # the caller's key order
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                assert a.dtype == b.dtype and torch.equal(a, b)
    finally:
        await client.aclose()
        await server.aclose()


@pytest.mark.parametrize("sender", ["jax", "port"])
async def test_pytree_crosses_the_packages(port, monkeypatch, sender):
    """A tree sent by one package's send_pytree arrives through the other
    package's recv_pytree leaf for leaf: both number the leaves in JAX's
    flatten order, so the tags agree on one wire."""
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    receiver = "port" if sender == "jax" else "jax"
    server, client = await _link(port, server_pkg=receiver,
                                 client_pkg=sender)
    try:
        tree = _tree(3)
        if sender == "jax":
            src = JaxClientPort(client)
            dst = ServerPort(server)
            want = jax.tree_util.tree_map(jnp.asarray, tree)
            like = tree_map(lambda a: torch.zeros_like(torch.from_numpy(a)),
                            tree)
            n, got = await asyncio.gather(
                jax_send_pytree(src, want, base_tag=0x900),
                recv_pytree(dst, like, base_tag=0x900))
            leaves = [to_numpy(t) for t in tree_leaves(got)]
        else:
            src = ClientPort(client)
            dst = JaxServerPort(server)
            want = tree_map(torch.from_numpy, tree)
            like = jax.tree_util.tree_map(jnp.zeros_like, tree)
            n, got = await asyncio.gather(
                send_pytree(src, want, base_tag=0x900),
                jax_recv_pytree(dst, like, base_tag=0x900))
            leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(got)]
        expected = jax.tree_util.tree_leaves(tree)
        assert n == len(expected) == len(leaves)
        for a, b in zip(leaves, expected):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    finally:
        await client.aclose()
        await server.aclose()


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
async def test_mixed_trainer_pair_on_one_wire(port, monkeypatch, server_pkg):
    """A JAX Trainer (optax.adamw) and a port Trainer (utils.optim.adamw)
    from the same numpy init exchange gradients for one step over tcp:
    after it, their parameters agree to 1e-6 (float32)."""
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    jcfg, tcfg, npp = _cfg_params(seed=1)
    client_pkg = "port" if server_pkg == "jax" else "jax"
    server, client = await _link(port, server_pkg, client_pkg)
    ports = {server_pkg: ("server", server), client_pkg: ("client", client)}
    try:
        def port_of(pkg):
            side, obj = ports[pkg]
            if pkg == "jax":
                return (JaxServerPort if side == "server" else
                        JaxClientPort)(obj)
            return (ServerPort if side == "server" else ClientPort)(obj)

        jt = JaxTrainer(jcfg, optax.adamw(LR),
                        jax.tree_util.tree_map(jnp.asarray, npp),
                        donate=False, dp_port=port_of("jax"))
        tt = Trainer(tcfg, adamw(LR), params_from_numpy(npp, device="cpu"),
                     dp_port=port_of("port"))
        lj, lt = await asyncio.gather(
            jt.step_dp(jnp.asarray(_batch(jcfg, 20))),
            tt.step_dp(torch.as_tensor(_batch(tcfg, 21)).long()))
        assert np.isfinite(lj) and np.isfinite(lt)
        jleaves = jax.tree_util.tree_leaves(jt.state.params)
        tleaves = tree_leaves(tt.state.params)
        assert len(jleaves) == len(tleaves)
        moved = 0.0
        for a, b, p0 in zip(jleaves, tleaves, jax.tree_util.tree_leaves(npp)):
            np.testing.assert_allclose(to_numpy(b), np.asarray(a),
                                       atol=MIXED_ATOL, rtol=0)
            moved = max(moved, float(np.abs(np.asarray(a) - p0).max()))
        assert moved > 100 * MIXED_ATOL  # the step moved the parameters
    finally:
        await client.aclose()
        await server.aclose()


def test_dp_refusals():
    """The reference's refusals: gradient accumulation and ZeRO mode do not
    compose with dp_port, and more than 256 leaves would overrun a step's
    tag window; step_dp without a port refuses too."""
    _, cfg, npp = _cfg_params()
    params = params_from_numpy(npp, device="cpu")
    with pytest.raises(ValueError, match="dp_port"):
        Trainer(cfg, adamw(LR), params, accum_steps=2, dp_port=object())
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(cfg, adamw(LR), params, dp_port=object(), mesh=object(),
                fsdp_axis="fsdp")
    wide = copy.copy(params)
    wide["extra"] = [torch.zeros(1) for _ in range(257 - len(
        tree_leaves(params)))]
    assert len(tree_leaves(wide)) == 257
    with pytest.raises(ValueError, match="<= 256 pytree leaves"):
        Trainer(cfg, adamw(LR), wide, dp_port=object())
    wide["extra"].pop()
    assert Trainer(cfg, adamw(LR), wide, dp_port=object()).dp_base_tag == \
        0x6000
    with pytest.raises(ValueError, match="dp_port"):
        asyncio.run(Trainer(cfg, adamw(LR), params).step_dp(
            torch.zeros((1, 3), dtype=torch.long)))
