"""The port's mixture-of-experts FFN (starway_tpu_torch.models.moe), the
MoE serving paths and the mesh collectives (ops/collectives.py,
parallel/all_to_all.py) against the JAX package's on the same numpy
inputs, on the CPU.

* ``switch_moe`` at k = 1 and 2, gelu and SwiGLU, dropless and with drops,
  and a forced router tie: y within 1e-5 (float32), aux and the stats
  within 1e-6, the routing (experts, gates, slots, keep) equal;
* ``forward`` on an MoE tree: logits within 1e-5, aux, and the
  layer-stacked ``return_moe_stats`` tree;
* token for token against JAX: ``generate()`` (aligned, and ragged rows
  equal to their solo runs), ``SlotServer`` (dense and rolling slots),
  ``PagedSlotServer`` (with and without a registered prefix),
  ``generate_speculative``/``generate_lookup``, ``generate_beam`` (scores
  1e-4) and a ``RemoteSlotServer`` stream over tcp; droppy configs refused
  with "dropless" where JAX refuses them;
* ``make_sharded_moe`` over ``{"ep": 4}`` against JAX's on its 4-device
  CPU mesh (1e-5), and every collective and ``make_shuffle`` against
  JAX's ``shard_map`` collectives (exact, or 1e-6 for sums); the
  collectives and the expert dispatch across two gloo processes with two
  shards each equal the one-process run bit for bit;
* MoE training (``loss_fn``, ``value_and_grad``, ``Trainer``) against
  the JAX package's loss, and what stays refused: ``quantize_params`` on
  an MoE tree (tests/test_torch_mesh_train.py holds the gradients).

Debug preset (``n_experts=4``), float32, weights from the JAX package's
``init_params`` carried by ``params_from_numpy``."""

import asyncio
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from conftest import free_port
from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import PagedSlotServer as JaxPagedSlotServer
from starway_tpu.models import SlotServer as JaxSlotServer
from starway_tpu.models import forward as jax_forward
from starway_tpu.models import generate as jax_generate
from starway_tpu.models import init_params as jax_init_params
from starway_tpu.models.beam import generate_beam as jax_generate_beam
from starway_tpu.ops import collectives as jcol
from starway_tpu.parallel.all_to_all import make_shuffle as jax_make_shuffle
from starway_tpu.parallel.sharding import make_mesh as jax_mesh
from starway_tpu.parallel.sharding import shard_array, shard_map_fn
from starway_tpu_torch.models import (LlamaConfig, PagedSlotServer,
                                      SlotServer, Trainer, forward, generate,
                                      generate_beam, generate_lookup,
                                      generate_speculative, init_params,
                                      loss_fn)
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.llama import value_and_grad
from starway_tpu_torch.ops import collectives as col
from starway_tpu_torch.ops.quantize import quantize_params
from starway_tpu_torch.parallel import make_mesh, make_shuffle
from starway_tpu_torch.utils.optim import adamw
from torch_port_util import ep_runs, to_numpy, tree_to_numpy

jmoe = importlib.import_module("starway_tpu.models.moe")
tmoe = importlib.import_module("starway_tpu_torch.models.moe")
jspec = importlib.import_module("starway_tpu.models.speculative")

TESTS = Path(__file__).resolve().parent
ATOL = 1e-5
DROPLESS = dict(n_experts=4, moe_top_k=2, moe_swiglu=True,
                moe_capacity_factor=4.0)
E, D, FF = 4, 16, 32  # the layer-level tests' expert widths


def _pair(seed, **kw):
    jcfg = JaxConfig.preset("debug", **kw)
    jp = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, LlamaConfig.preset("debug", **kw), jp, params_from_numpy(
        tree_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def model():
    """The dropless Mixtral-style debug model."""
    return _pair(2, **DROPLESS)


def _prompts(seed, b, p, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (b, p), np.int32)


def _layer(seed, swiglu, e=E):
    """One layer of JAX expert weights (numpy) and tokens [2, 8, D]."""
    p = jmoe.init_moe_params(jax.random.PRNGKey(seed), 1, e, D, FF,
                             jnp.float32, swiglu=swiglu)
    w = {k: np.asarray(v[0]) for k, v in p.items()}
    x = np.random.default_rng(seed).standard_normal((2, 8, D), np.float32)
    return x, w


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- the layer


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("capacity_factor", [1.0, 4.0])
def test_switch_moe_matches_jax(k, swiglu, capacity_factor):
    x, w = _layer(3 + k + 2 * swiglu, swiglu)
    gate = {"w_gate": w["w_gate"]} if swiglu else {}
    jy, jaux, jst = jmoe.switch_moe(
        jnp.asarray(x), w["router"], w["w_in"], w["w_out"], k=k,
        capacity_factor=capacity_factor, with_stats=True, **gate)
    ty, taux, tst = tmoe.switch_moe(
        _t(x), _t(w["router"]), _t(w["w_in"]), _t(w["w_out"]), k=k,
        capacity_factor=capacity_factor, with_stats=True,
        **{n: _t(v) for n, v in gate.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    for name in ("drop_fraction", "expert_load"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   atol=1e-6)
    if capacity_factor == 1.0 and k == 2:
        assert float(tst["drop_fraction"]) > 0  # the drops are exercised

    # The routing itself: experts, gates, slots and keep.
    xt = x.reshape(-1, D)
    je, jg, _ = jmoe._route(jnp.asarray(xt), w["router"], k)
    te, tg, _ = tmoe._route(_t(xt), _t(w["router"]), k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    cap = tmoe.moe_capacity(xt.shape[0] * k, E, capacity_factor)
    assert cap == jmoe.moe_capacity(xt.shape[0] * k, E, capacity_factor)
    js, jk, jc = jmoe._dispatch_slots(je, E, cap)
    ts, tk, tc = tmoe._dispatch_slots(te, E, cap)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int32


@pytest.mark.parametrize("tie", ["all", "pair"])
def test_router_ties_go_to_the_lower_index(tie):
    """Equal router probabilities: lax.top_k picks the lower expert index;
    so does the port (torch.topk promises no order)."""
    x, w = _layer(9, True)
    router = np.array(w["router"])
    if tie == "all":
        router[:] = 0.0  # every probability 1/E
    else:
        router[:, 3] = router[:, 1] = np.abs(router).max() * 4  # 1 and 3 tie
    xt = np.abs(x.reshape(-1, D)) + 0.1
    for k in (1, 2):
        je, jg, jaux = jmoe._route(jnp.asarray(xt), router, k)
        te, tg, taux = tmoe._route(_t(xt), _t(router), k)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    want = [0, 1] if tie == "all" else [1, 3]
    assert te.reshape(2, -1)[:, 0].tolist() == want


@pytest.mark.parametrize("n_assign,e,cf", [(16, 4, 4.0), (14, 3, 3.0),
                                           (7, 8, 1.25), (1, 8, 8.0),
                                           (4096, 8, 8.0)])
def test_capacity_and_dropless_rule_match_jax(n_assign, e, cf):
    assert tmoe.moe_capacity(n_assign, e, cf) == jmoe.moe_capacity(
        n_assign, e, cf)
    for c in (cf, float(e)):
        jc = JaxConfig.preset("debug", n_experts=e, moe_capacity_factor=c)
        tc = LlamaConfig.preset("debug", n_experts=e, moe_capacity_factor=c)
        try:
            jmoe.require_dropless(jc, "ctx")
            want = None
        except ValueError as exc:
            want = str(exc)
        if want is None:
            tmoe.require_dropless(tc, "ctx")
        else:
            with pytest.raises(ValueError) as got:
                tmoe.require_dropless(tc, "ctx")
            assert str(got.value) == want and "dropless" in want


# ----------------------------------------------------------------- model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_tree_crosses_bit_for_bit(dtype):
    """params_from_numpy carries the JAX package's MoE tree, w_gate
    included, bit for bit; the port's init_params makes the same leaves
    and shapes."""
    jcfg = JaxConfig.preset("debug", dtype=dtype, **DROPLESS)
    jp = jax_init_params(jax.random.PRNGKey(4), jcfg)
    tp = params_from_numpy(tree_to_numpy(jp), device="cpu")
    for name, leaf in jp["layers"]["moe"].items():
        got = tp["layers"]["moe"][name]
        want = np.asarray(leaf)
        if dtype == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    mine = init_params(LlamaConfig.preset("debug", dtype=dtype, **DROPLESS),
                       seed=0, device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}

    assert shapes(mine) == shapes(tree_to_numpy(jp))


def test_forward_matches_jax(model):
    """Logits, the layers' summed aux, and the layer-stacked router stats
    of a with_stats moe_fn."""
    jcfg, tcfg, jp, tp = model
    toks = _prompts(5, 2, 12)
    jl, ja = jax_forward(jp, jnp.asarray(toks), jcfg, return_aux=True)
    tl, ta = forward(tp, torch.as_tensor(toks).long(), tcfg, return_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)

    def stats_fn(pkg, k):
        def fn(x, router_w, w_in, w_out, w_gate=None):
            return pkg.switch_moe(x, router_w, w_in, w_out, k=k, w_gate=w_gate,
                                  capacity_factor=4.0, with_stats=True)
        return fn

    jl, ja, jst = jax_forward(jp, jnp.asarray(toks), jcfg, return_aux=True,
                              moe_fn=stats_fn(jmoe, 2),
                              return_moe_stats=True)
    tl, ta, tst = forward(tp, torch.as_tensor(toks).long(), tcfg,
                          return_aux=True, moe_fn=stats_fn(tmoe, 2),
                          return_moe_stats=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tst["expert_load"].shape == (tcfg.n_layers, 4)
    for name in ("drop_fraction", "expert_load"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   atol=1e-6)

    dense = _pair(0)
    for pkg_forward, (cfg, params), tok in (
            (jax_forward, (dense[0], dense[2]), jnp.asarray(toks)),
            (forward, (dense[1], dense[3]), torch.as_tensor(toks).long())):
        with pytest.raises(ValueError, match="dense model"):
            pkg_forward(params, tok, cfg, return_moe_stats=True)
    with pytest.raises(ValueError, match="stats-producing moe_fn"):
        forward(tp, torch.as_tensor(toks).long(), tcfg,
                return_moe_stats=True)


@pytest.mark.parametrize("kind", ["droppy", "dropless"])
def test_generate_matches_jax(kind, model):
    """The twin of tests/test_generate.py::test_generate_moe, token for
    token; a droppy config generates aligned batches (its capacity is the
    JAX package's for the same shapes) and refuses ragged ones."""
    if kind == "droppy":
        jcfg, tcfg, jp, tp = _pair(2, n_experts=4)
    else:
        jcfg, tcfg, jp, tp = model
    prompt = _prompts(6, 2, 5)
    j = jax_generate(jp, jcfg, jnp.asarray(prompt), 6)
    t = generate(tp, tcfg, torch.as_tensor(prompt), 6)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    rows = [[6, 2, 9, 4, 1], [7, 3]]
    padded = np.asarray([r + [0] * (5 - len(r)) for r in rows], np.int32)
    lengths = np.asarray([5, 2], np.int32)
    if kind == "droppy":
        with pytest.raises(ValueError, match="dropless"):
            jax_generate(jp, jcfg, jnp.asarray(padded), 4,
                         prompt_lengths=jnp.asarray(lengths))
        with pytest.raises(ValueError, match="dropless"):
            generate(tp, tcfg, torch.as_tensor(padded), 4,
                     prompt_lengths=lengths)
        return
    ragged = generate(tp, tcfg, torch.as_tensor(padded), 6,
                      prompt_lengths=lengths)
    jr = jax_generate(jp, jcfg, jnp.asarray(padded), 6,
                      prompt_lengths=jnp.asarray(lengths))
    np.testing.assert_array_equal(ragged.numpy(), np.asarray(jr))
    for b, r in enumerate(rows):
        solo = generate(tp, tcfg, torch.tensor([r]), 6)[0, len(r):]
        assert torch.equal(ragged[b], solo), b


def _jax_solo(jp, jcfg, prompt, m):
    out = jax_generate(jp, jcfg, jnp.asarray([prompt], jnp.int32), m)
    return np.asarray(out[0, len(prompt):])


REQS = [(3, 5), (6, 4), (2, 6)]


def test_slot_server_dropless_matches_jax(model):
    """The twin of tests/test_serving.py::test_moe_continuous_batching_
    dropless: cohabiting slots equal the JAX server's tokens and each
    request's solo generate(); a droppy capacity is refused by both."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(9)
    reqs = [(list(map(int, rng.integers(1, 512, n))), m) for n, m in REQS]
    kw = dict(n_slots=2, max_len=64, chunk=4)
    jsrv, tsrv = JaxSlotServer(jp, jcfg, **kw), SlotServer(tp, tcfg, **kw)
    jr = [jsrv.submit(p, m) for p, m in reqs]
    tr = [tsrv.submit(p, m) for p, m in reqs]
    jd, td = jsrv.run(), tsrv.run()
    for (prompt, m), j, t in zip(reqs, jr, tr):
        np.testing.assert_array_equal(td[t], jd[j])
        np.testing.assert_array_equal(td[t], _jax_solo(jp, jcfg, prompt, m))

    droppy_j = JaxConfig.preset("debug", n_experts=4,
                                moe_capacity_factor=1.25)
    droppy_t = LlamaConfig.preset("debug", n_experts=4,
                                  moe_capacity_factor=1.25)
    with pytest.raises(ValueError, match="dropless") as jerr:
        JaxSlotServer(jp, droppy_j, n_slots=2, max_len=64)
    with pytest.raises(ValueError, match="dropless") as terr:
        SlotServer(tp, droppy_t, n_slots=2, max_len=64)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="dropless"):
        PagedSlotServer(tp, droppy_t, n_slots=2, max_len=64, page=16)


def test_rolling_slots_match_jax():
    """A windowed dropless MoE model serves through rolling slots, as in
    the JAX package's SlotServer (prompts past the window wrap it)."""
    jcfg, tcfg, jp, tp = _pair(7, sliding_window=8, **DROPLESS)
    rng = np.random.default_rng(11)
    reqs = [(list(map(int, rng.integers(1, 512, n))), m)
            for n, m in [(11, 6), (4, 9), (13, 3)]]
    kw = dict(n_slots=2, max_len=64, chunk=4)
    jsrv, tsrv = JaxSlotServer(jp, jcfg, **kw), SlotServer(tp, tcfg, **kw)
    assert tsrv.rolling and tsrv.cache["k"].shape[3] == 8
    jr = [jsrv.submit(p, m) for p, m in reqs]
    tr = [tsrv.submit(p, m) for p, m in reqs]
    jd, td = jsrv.run(), tsrv.run()
    for j, t in zip(jr, tr):
        np.testing.assert_array_equal(td[t], jd[j])


def test_paged_slot_server_matches_jax(model):
    """The paged server on an MoE model: the JAX PagedSlotServer's tokens
    without a prefix; with a registered prefix, generate(prefix +
    suffix)'s (JAX's)."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(12)
    reqs = [(list(map(int, rng.integers(1, 512, n))), m)
            for n, m in [(3, 6), (12, 4), (7, 5)]]
    kw = dict(n_slots=2, max_len=64, page=16, n_pages=9, chunk=4)
    jsrv, tsrv = JaxPagedSlotServer(jp, jcfg, **kw), PagedSlotServer(
        tp, tcfg, **kw)
    jr = [jsrv.submit(p, m) for p, m in reqs]
    tr = [tsrv.submit(p, m) for p, m in reqs]
    jd, td = jsrv.run(), tsrv.run()
    for j, t in zip(jr, tr):
        np.testing.assert_array_equal(td[t], jd[j])
    prefix = list(map(int, rng.integers(1, 512, 10)))
    pid = tsrv.register_prefix(prefix)
    suffixes = [([5, 9], 5), ([8, 1, 4, 2], 4)]
    rids = [tsrv.submit(s, m, prefix=pid) for s, m in suffixes]
    done = tsrv.run()
    for rid, (s, m) in zip(rids, suffixes):
        np.testing.assert_array_equal(done[rid],
                                      _jax_solo(jp, jcfg, prefix + s, m))
    tsrv.drop_prefix(pid)
    assert tsrv.pages_in_use == 0


def test_speculative_and_lookup_match_jax(model):
    """The twin of tests/test_speculative.py::test_moe_dropless_
    speculative_matches_generate: a self-draft at gamma 4 and prompt
    lookup give JAX's tokens and stats and generate()'s tokens; a droppy
    draft is admitted (it only proposes), a droppy target refused."""
    jcfg, tcfg, jp, tp = model
    prompt = _prompts(5, 2, 7)
    ref = generate(tp, tcfg, torch.as_tensor(prompt), 10)
    j, js = jspec.generate_speculative(jp, jcfg, jp, jcfg, jnp.asarray(prompt),
                                       10, gamma=4, return_stats=True)
    t, ts = generate_speculative(tp, tcfg, tp, tcfg, torch.as_tensor(prompt),
                                 10, gamma=4, return_stats=True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert torch.equal(t, ref)
    for name in ("macro_steps", "accepted"):
        np.testing.assert_array_equal(ts[name].numpy(), np.asarray(js[name]))
    j = jspec.generate_lookup(jp, jcfg, jnp.asarray(prompt), 10, gamma=4,
                              ngram=2)
    t = generate_lookup(tp, tcfg, torch.as_tensor(prompt), 10, gamma=4,
                        ngram=2)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert torch.equal(t, ref)

    droppy = LlamaConfig.preset("debug", n_experts=4)
    t = generate_speculative(tp, tcfg, tp, droppy, torch.as_tensor(prompt),
                             10, gamma=3)
    assert torch.equal(t, ref)
    for call in (lambda: generate_speculative(tp, droppy, tp, tcfg,
                                              torch.as_tensor(prompt), 4),
                 lambda: generate_lookup(tp, droppy, torch.as_tensor(prompt),
                                         4)):
        with pytest.raises(ValueError, match="dropless"):
            call()


def test_beam_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    prompt = _prompts(13, 2, 6)
    jo, js, jf = jax_generate_beam(jp, jcfg, jnp.asarray(prompt), 6, beams=3,
                                   return_all=True)
    to, ts, tf = generate_beam(tp, tcfg, torch.as_tensor(prompt).long(), 6,
                               beams=3, return_all=True)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    one = generate_beam(tp, tcfg, torch.as_tensor(prompt).long(), 6, beams=1)
    assert torch.equal(one, generate(tp, tcfg, torch.as_tensor(prompt), 6))


def test_remote_slot_server_stream(model, port, monkeypatch):
    """One RemoteSlotServer stream over tcp from an MoE model: the JAX
    package's generate() tokens."""
    from starway_tpu_torch.models.remote_serving import (
        RemoteGenerateSession, RemoteSlotServer)

    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    jcfg, tcfg, jp, tp = model
    prompt = [4, 8, 15, 16, 23]

    async def run():
        bridge = RemoteSlotServer(SlotServer(tp, tcfg, n_slots=2, max_len=64,
                                             chunk=4))
        bridge.server.listen("127.0.0.1", port)
        serve = asyncio.create_task(bridge.serve())
        session = await RemoteGenerateSession.aconnect("127.0.0.1", port)
        try:
            return await session.generate(prompt, 7)
        finally:
            bridge.stop()
            await serve
            await session.aclose()
            await bridge.aclose()

    got = asyncio.run(run())
    np.testing.assert_array_equal(got, _jax_solo(jp, jcfg, prompt, 7))


def test_training_and_quantization_stay_refused(model):
    """MoE training is ported: ``loss_fn`` (cross-entropy plus the
    balance term) and ``value_and_grad``'s loss equal the JAX package's,
    and the Trainer steps.  W8A16 expert weights stay refused in both
    packages."""
    jlf = importlib.import_module("starway_tpu.models.llama").loss_fn
    jcfg, tcfg, jp, tp = model
    batch = _prompts(1, 2, 9)
    want = float(jlf(jp, jnp.asarray(batch), jcfg))
    tb = torch.as_tensor(batch).long()
    assert abs(float(loss_fn(tp, tb, tcfg)) - want) < ATOL
    assert abs(float(value_and_grad(tp, tb, tcfg)[0]) - want) < ATOL
    trainer = Trainer(tcfg, adamw(1e-3), tp, donate=False)
    assert np.isfinite(trainer.step_sync(tb))
    with pytest.raises(NotImplementedError, match="MoE expert weights"):
        quantize_params(tp)


# --------------------------------------------------- the expert-parallel view


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("swiglu", [False, True])
def test_sharded_moe_matches_jax(k, swiglu):
    """make_sharded_moe over {"ep": 4} (tokens cut on the sequence,
    experts over ep) against the JAX package's on its {"ep": 4} CPU mesh,
    and against the global view at a dropless capacity (the twin of
    tests/test_parallel_extra.py's sharded-MoE tests), stats included."""
    x, w = _layer(20 + k, swiglu)
    args = [w["router"], w["w_in"], w["w_out"]] + (
        [w["w_gate"]] if swiglu else [])
    jmesh = jax_mesh({"ep": 4})
    jfn = jmoe.make_sharded_moe(jmesh, capacity_factor=4.0, k=k,
                                with_stats=True, swiglu=swiglu)
    shard = [lambda a: a] + [lambda a: shard_array(jmesh, a, "ep", None,
                                                   None)] * (len(args) - 1)
    jy, jaux, jst = jax.jit(jfn)(shard_array(jmesh, x, None, "ep", None),
                                 *[f(a) for f, a in zip(shard, args)])
    tfn = tmoe.make_sharded_moe(make_mesh({"ep": 4}, device="cpu"),
                                capacity_factor=4.0, k=k, with_stats=True,
                                swiglu=swiglu)
    ty, taux, tst = tfn(_t(x), *map(_t, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    for name in ("drop_fraction", "expert_load"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   atol=1e-6)
    gy, _ = tmoe.switch_moe(_t(x), *map(_t, args[:3]), capacity_factor=4.0,
                            k=k, w_gate=_t(args[3]) if swiglu else None)
    np.testing.assert_allclose(ty.numpy(), gy.numpy(), atol=ATOL)


def test_sharded_moe_as_the_models_moe_fn(model):
    jcfg, tcfg, jp, tp = model
    toks = torch.as_tensor(_prompts(8, 2, 12)).long()
    fn = tmoe.make_sharded_moe(make_mesh({"ep": 4}, device="cpu"),
                               capacity_factor=4.0, k=2, swiglu=True)
    got = forward(tp, toks, tcfg, moe_fn=fn)
    np.testing.assert_allclose(got.numpy(), forward(tp, toks, tcfg).numpy(),
                               atol=ATOL)
    moe = {n: t[0] for n, t in tp["layers"]["moe"].items()}
    with pytest.raises(ValueError, match="w_gate"):
        tmoe.make_sharded_moe(make_mesh({"ep": 4}, device="cpu"))(
            torch.zeros(1, 4, 128), moe["router"], moe["w_in"],
            moe["w_out"], moe["w_gate"])
    # A data axis beside ep now holds its slots (the dp x ep x tp step is
    # tests/test_torch_mesh_train.py's); a pipeline axis stays refused.
    assert make_mesh({"dp": 2, "ep": 4}, device="cpu").size == 8
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_mesh({"pp": 2, "ep": 4}, device="cpu")


# ------------------------------------------------------------ collectives

N = 4


def _jax_shards(fn, x, n=N):
    """``fn`` per shard of x's dim 0 under shard_map on an {"x": n} mesh;
    the per-shard outputs, concatenated on dim 0 by the out spec, split
    back."""
    mesh = jax_mesh({"x": n})
    run = jax.jit(shard_map_fn(mesh, fn, in_specs=(P("x"),),
                               out_specs=P("x")))
    return np.split(np.asarray(run(shard_array(mesh, x, "x"))), n)


COLLECTIVES = {
    "all_to_all_tiled": (
        lambda v: jcol.all_to_all(v, "x", 1, 0),
        lambda s, m: col.all_to_all(s, m, "x", 1, 0), (16, 8, 3)),
    "all_to_all_tiled_2_1": (
        lambda v: jcol.all_to_all(v, "x", 2, 1),
        lambda s, m: col.all_to_all(s, m, "x", 2, 1), (8, 2, 12)),
    "all_to_all_untiled": (
        lambda v: jcol.all_to_all(v, "x", 1, 0, tiled=False),
        lambda s, m: col.all_to_all(s, m, "x", 1, 0, tiled=False),
        (8, N, 3)),
    "all_to_all_untiled_0_2": (
        lambda v: jcol.all_to_all(v, "x", 0, 2, tiled=False),
        lambda s, m: col.all_to_all(s, m, "x", 0, 2, tiled=False),
        (N * N, 2, 3)),
    "all_gather_tiled": (
        lambda v: jcol.all_gather(v, "x", 1),
        lambda s, m: col.all_gather(s, m, "x", 1), (8, 5)),
    "all_gather_untiled": (
        lambda v: jcol.all_gather(v, "x", 0, tiled=False),
        lambda s, m: col.all_gather(s, m, "x", 0, tiled=False), (8, 5)),
    "psum": (lambda v: jcol.psum(v, "x"),
             lambda s, m: col.psum(s, m, "x"), (8, 5)),
    "pmean": (lambda v: jcol.pmean(v, "x"),
              lambda s, m: col.pmean(s, m, "x"), (8, 5)),
    "reduce_scatter": (
        lambda v: jcol.reduce_scatter(v, "x", 1),
        lambda s, m: col.reduce_scatter(s, m, "x", 1), (8, 12)),
    "ring_reduce": (lambda v: jcol.ring_reduce(v, "x"),
                    lambda s, m: col.ring_reduce(s, m, "x"), (8, 5)),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_matches_jax(name):
    jfn, tfn, shape = COLLECTIVES[name]
    x = np.random.default_rng(len(name)).standard_normal(shape, np.float32)
    want = _jax_shards(jfn, x)
    got = tfn([_t(s) for s in np.split(x, N)],
              make_mesh({"x": N}, device="cpu"))
    assert len(got) == N
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-6)


def test_shuffle_transposes_ownership():
    """The twin of tests/test_parallel.py::test_shuffle_transposes_
    ownership: dim-0 shards in, dim-1 shards out, values kept."""
    s, b, d = 16, 8, 4
    x = np.arange(s * b * d, dtype=np.float32).reshape(s, b, d)
    jmesh = jax_mesh({"x": 8})
    jy = jax_make_shuffle(jmesh, "x")(shard_array(jmesh, x, "x"))
    assert jy.sharding.spec == P(None, "x")
    got = make_shuffle(make_mesh({"x": 8}, device="cpu"), "x")(
        [_t(a) for a in np.split(x, 8)])
    for g, w in zip(got, np.split(np.asarray(jy), 8, axis=1)):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(torch.cat(got, dim=1).numpy(), x)


def test_collective_refusals():
    mesh = make_mesh({"x": N}, device="cpu")
    xs = [torch.zeros(6, 3)] * N
    with pytest.raises(ValueError, match="shards given"):
        col.psum(xs[:2], mesh, "x")
    with pytest.raises(ValueError, match="divide"):
        col.all_to_all(xs, mesh, "x", 0, 1)
    with pytest.raises(ValueError, match="equal"):
        col.all_to_all(xs, mesh, "x", 1, 0, tiled=False)
    with pytest.raises(ValueError, match="divide"):
        col.reduce_scatter(xs, mesh, "x", 1)


def test_ep_across_two_processes(tmp_path):
    """ep = 4 over two gloo processes, two shards each: the shards that
    cross go by torch.distributed point-to-point.  Every collective and
    the sharded MoE dispatch equal the one-process run bit for bit."""
    n, world = 4, 2
    rng = np.random.default_rng(17)
    _x, w = _layer(30, True)
    data = dict(
        x=rng.standard_normal((8, 8, 3), np.float32),
        u=rng.standard_normal((8, n, 3), np.float32),
        moe_x=rng.standard_normal((2, 8, D), np.float32),
        router=w["router"], w_in=w["w_in"], w_out=w["w_out"],
        w_gate=w["w_gate"])
    np.savez(tmp_path / "in.npz", n=n, **data)
    port = free_port()
    code = ("import sys; sys.path[:0] = sys.argv[1:3]\n"
            "from torch_port_util import ep_worker\n"
            "ep_worker(int(sys.argv[3]), int(sys.argv[4]), "
            "int(sys.argv[5]), sys.argv[6])\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(TESTS), str(TESTS.parent), str(r),
         str(world), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    mesh = make_mesh({"ep": n}, device="cpu")
    want = ep_runs({k: _t(v) for k, v in data.items()}, n, mesh, range(n))
    for r in range(world):
        got = np.load(tmp_path / f"out{r}.npz")
        for name, shards in want.items():
            for i in range(r * 2, r * 2 + 2):
                np.testing.assert_array_equal(got[f"{name}_{i}"],
                                              to_numpy(shards[i]),
                                              err_msg=f"{name} shard {i}")
