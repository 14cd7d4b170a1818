"""The port's rolling (sliding-window) paths against the JAX package's on
the same parameters: rolling ``decode_step`` teacher-forced through the
wrap, ``prefill_rolling`` by ``chunk`` and by ``widths``, ``generate()``'s
rolling branch at P = W, W + 1 and 2W + 3, and the rolling ``SlotServer``
(float32, int8 KV, W8A16) against the JAX ``SlotServer`` and against a
single-request loop over the port's own primitives; then the same server
behind ``RemoteSlotServer`` on the in-process transport.

Debug preset, float32, window 5 (8 for the servers), on the CPU.
Tolerances as tests/test_torch_llama.py: logits atol 1e-4, caches 1e-5,
int8 cache codes within one of JAX's (a value within float32 rounding of a
code boundary), greedy tokens exactly."""

import asyncio
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import SlotServer as JaxSlotServer
from starway_tpu.models import init_params as jax_init_params
from starway_tpu.ops.quantize import quantize_params as jax_quantize_params
from starway_tpu_torch.models import (LlamaConfig, PagedSlotServer,
                                      SlotServer, forward)
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.llama import rope_tables
from torch_port_util import to_numpy, to_torch, tree_to_numpy

jgen = importlib.import_module("starway_tpu.models.generate")
jax_decode_step = jax.jit(jgen.decode_step, static_argnames=("cfg", "rolling"))
tgen = importlib.import_module("starway_tpu_torch.models.generate")
tserving = importlib.import_module("starway_tpu_torch.models.serving")

LOGIT_ATOL = 1e-4
W = 5


def _model(window, seed, kv_quant="none", w8=False):
    kw = dict(sliding_window=window, kv_quant=kv_quant)
    jcfg, tcfg = JaxConfig.preset("debug", **kw), LlamaConfig.preset(
        "debug", **kw)
    jp = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    if w8:
        jp = jax_quantize_params(jp)
    return jcfg, tcfg, jp, params_from_numpy(tree_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module", params=["none", "int8"])
def models(request):
    return _model(W, 8, kv_quant=request.param)


def _tokens(seed, b=2, s=13):
    return np.random.default_rng(seed).integers(0, 512, (b, s), np.int32)


def _assert_caches_close(tcache, jcache):
    assert set(tcache) == set(jcache)
    for name in jcache:
        got, want = to_numpy(tcache[name]), np.asarray(jcache[name])
        assert got.shape == want.shape, name
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=name)


def test_rolling_decode_teacher_forced_through_the_wrap(models):
    """14 steps through a 5-slot cache: logits equal JAX's at every step
    (and the port's own windowed forward's), per-row positions, and the
    cache stays W slots; the position is passed as a [B] tensor.

    An int8 cache starts each port step from JAX's cache, so a code one
    off (a value within float32 rounding of a code boundary) cannot stay
    resident; at the one step whose own written code is one off, the
    logits are held within 2e-3 (one code's share of an attention output)
    instead of 1e-4."""
    jcfg, tcfg, jp, tp = models
    B, S = 2, 14
    toks = _tokens(0, B, S)
    full = forward(tp, torch.as_tensor(toks).long(), tcfg)
    jcache = jgen.init_rolling_cache(jcfg, B)
    tcache = tgen.init_rolling_cache(tcfg, B, device="cpu")
    jrope = jgen.cfg_rope_tables(jcfg, S)
    trope = rope_tables(S, tcfg.head_dim, tcfg.rope_theta)
    n_flip_steps = 0
    for i in range(S):
        if tcfg.kv_quant == "int8":
            tcache = {name: to_torch(c) for name, c in jcache.items()}
        pos = np.full((B,), i, np.int32)
        jlog, jcache = jax_decode_step(jp, jcache, jnp.asarray(toks[:, i]),
                                       jnp.asarray(pos), cfg=jcfg, rope=jrope,
                                       rolling=True)
        tlog, tcache = tgen.decode_step(tp, tcache,
                                        torch.as_tensor(toks[:, i]).long(),
                                        torch.as_tensor(pos), tcfg, trope,
                                        rolling=True)
        flips = sum(int((to_numpy(tcache[n]) != np.asarray(jcache[n])).sum())
                    for n in ("k", "v") if tcfg.kv_quant == "int8")
        n_flip_steps += flips > 0
        np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog),
                                   atol=2e-3 if flips else LOGIT_ATOL,
                                   err_msg=f"pos {i}")
        if tcfg.kv_quant == "none":
            np.testing.assert_allclose(to_numpy(tlog), to_numpy(full[:, i]),
                                       atol=2e-4, rtol=2e-4)
        _assert_caches_close(tcache, jcache)
    assert tcache["k"].shape[3] == W
    assert n_flip_steps <= 1


def test_rolling_decode_int_position_matches_tensor(models):
    """An int position (aligned batch) writes and attends as the [B]
    tensor does, past the wrap too."""
    _jcfg, tcfg, _jp, tp = models
    toks = _tokens(1, 2, 9)
    rope = rope_tables(9, tcfg.head_dim, tcfg.rope_theta)
    a = tgen.init_rolling_cache(tcfg, 2, device="cpu")
    b = tgen.init_rolling_cache(tcfg, 2, device="cpu")
    for i in range(9):
        tok = torch.as_tensor(toks[:, i]).long()
        la, a = tgen.decode_step(tp, a, tok, i, tcfg, rope, rolling=True)
        lb, b = tgen.decode_step(tp, b, tok, torch.full((2,), i), tcfg, rope,
                                 rolling=True)
        torch.testing.assert_close(la, lb, atol=0, rtol=0)
    for name in a:
        assert torch.equal(a[name], b[name]), name


# (plan, P): one chunk (P = 3 < W); chunks of 4 through P = W, W + 1 and
# 2W + 3; each denomination schedule past the window; the default plan.
PREFILL_CASES = [(dict(chunk=4), 3), (dict(chunk=4), W), (dict(chunk=4), W + 1),
                 (dict(chunk=4), 2 * W + 3), (dict(widths=(64, 8, 1)), W + 1),
                 (dict(widths=(64, 8, 1)), 2 * W + 3),
                 (dict(widths=(3, 1)), W), (dict(widths=(3, 1)), 2 * W + 3),
                 (dict(), 2 * W + 3)]


@pytest.mark.parametrize("plan,P", PREFILL_CASES,
                         ids=[f"{'-'.join(f'{k}{v}' for k, v in p.items())}"
                              f"-P{n}" for p, n in PREFILL_CASES])
def test_prefill_rolling_matches_jax(models, P, plan):
    jcfg, tcfg, jp, tp = models
    prompt = _tokens(4, 2, P)
    jlog, jcache = jgen.prefill_rolling(jp, jcfg, jnp.asarray(prompt), **plan)
    tlog, tcache = tgen.prefill_rolling(tp, tcfg, torch.as_tensor(prompt),
                                        **plan)
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog),
                               atol=LOGIT_ATOL)
    _assert_caches_close(tcache, jcache)


@pytest.mark.parametrize("P", [W, W + 1, 2 * W + 3])
def test_prefill_rolling_position_order(P):
    """The chunked prefill's rolling cache is the one-pass prefill's last
    W positions, each at slot p % W (the gather generate() makes), with
    the one-pass logits: chunks of 2 put c0 < W, where the cold slots
    are masked, and c0 past W."""
    _jcfg, tcfg, _jp, tp = _model(W, 8)
    prompt = torch.as_tensor(_tokens(5, 2, P)).long()
    lr, cr = tgen.prefill_rolling(tp, tcfg, prompt, chunk=2)
    lf, cf = tgen.prefill(tp, tcfg, prompt, P)
    torch.testing.assert_close(lr, lf, atol=2e-4, rtol=2e-4)
    src = (P - W) + (torch.arange(W) - (P - W)) % W
    for name in ("k", "v"):
        want = cf[name][:, :, :, src] if P > W else cf[name]
        torch.testing.assert_close(cr[name][:, :, :, :min(P, W)], want,
                                   atol=2e-5, rtol=2e-5)


def test_rolling_plan_cuts_as_the_reference():
    plan = tgen.rolling_plan
    assert plan(13, 5, chunk=4) == [4, 4, 4, 1]
    assert plan(13, 5) == [5, 5, 3]
    assert plan(3, 5) == [3]
    assert plan(75, 100, widths=(64, 8, 1)) == [64, 8, 1, 1, 1]
    assert plan(13, 5, widths=(64, 8, 1)) == [5, 5, 1, 1, 1]
    assert plan(13, 5, widths=(3, 1)) == [3, 3, 3, 3, 1]
    with pytest.raises(ValueError, match="cannot cover"):
        plan(13, 5, widths=(4, 2))


@pytest.mark.parametrize("P", [W, W + 1, 2 * W + 3])
def test_generate_rolling_matches_jax(models, P, monkeypatch):
    """generate() takes the rolling branch (every decode step sees a W-slot
    cache) and its greedy tokens equal JAX's."""
    jcfg, tcfg, jp, tp = models
    prompt = _tokens(P, 2, P)
    seen = []
    real = tgen.decode_step

    def spy(params, cache, *a, **kw):
        seen.append((cache["k"].shape[3], kw.get("rolling")))
        return real(params, cache, *a, **kw)

    monkeypatch.setattr(tgen, "decode_step", spy)
    got = tgen.generate(tp, tcfg, torch.as_tensor(prompt), 7)
    want = jgen.generate(jp, jcfg, jnp.asarray(prompt), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert seen and set(seen) == {(W, True)}


def test_generate_rolling_equals_the_full_reforward():
    """Greedy rolling generation equals re-running the windowed forward
    for every token (the JAX test's oracle, on the port alone)."""
    _jcfg, tcfg, _jp, tp = _model(W, 6)
    for P in (3, 9):
        prompt = torch.as_tensor(_tokens(P, 2, P)).long()
        out = tgen.generate(tp, tcfg, prompt, 7)
        toks = prompt
        for _ in range(7):
            nxt = forward(tp, toks, tcfg)[:, -1].argmax(-1)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
        assert torch.equal(out, toks), P


def test_rolling_refusals():
    jcfg, tcfg, _jp, tp = _model(W, 8)
    plain = LlamaConfig.preset("debug")
    rope = rope_tables(16, tcfg.head_dim, tcfg.rope_theta)
    tok = torch.tensor([1, 2])
    with pytest.raises(ValueError, match="sliding_window"):
        tgen.init_rolling_cache(plain, 1, device="cpu")
    with pytest.raises(ValueError, match="exactly sliding_window"):
        tgen.decode_step(tp, tgen.init_cache(tcfg, 2, 9, device="cpu"), tok,
                         0, tcfg, rope, rolling=True)
    with pytest.raises(ValueError, match="rope"):
        tgen.decode_step(tp, tgen.init_rolling_cache(tcfg, 2, device="cpu"),
                         tok, 0, tcfg, rolling=True)
    with pytest.raises(ValueError, match="sliding_window"):
        tgen.prefill_rolling(tp, plain, torch.tensor([[1, 2]]))
    with pytest.raises(ValueError, match="attn_fn"):
        tgen.prefill_rolling(tp, tcfg, torch.tensor([[1, 2]]),
                             attn_fn=lambda q, k, v: q)
    with pytest.raises(ValueError, match="cannot cover"):
        tgen.prefill_rolling(tp, tcfg, torch.tensor([[1, 2, 3]]),
                             widths=(2,))


# ------------------------------------------------------------ the server


def _oracle(params, cfg):
    """A single request greedily through the primitives of rolling
    admission and decode: prefill_rolling over the admission widths, then
    rolling decode_step and argmax (the port's rolling_primitive_oracle)."""

    def run(prompt, max_new, horizon):
        logits, cache = tserving._rolling_prefill_state(params, cfg, prompt)
        rope = rope_tables(horizon, cfg.head_dim, cfg.rope_theta)
        toks = [int(logits.argmax(-1)[0])]
        pos = len(prompt)
        while len(toks) < max_new:
            logits, cache = tgen.decode_step(
                params, cache, torch.tensor([toks[-1]]), torch.tensor([pos]),
                cfg, rope, rolling=True)
            toks.append(int(logits.argmax(-1)[0]))
            pos += 1
        return np.asarray(toks, np.int32)

    return run


ROLLING_REQS = [([5, 1, 7, 2, 9, 4, 3, 8, 6, 2, 7], 6), ([3, 8], 9),
                ([1, 2, 3, 4, 5, 6, 7, 8, 9, 1, 2, 3, 4], 4),
                (list(range(20, 28)), 5), (list(range(40, 49)), 7)]


@pytest.mark.parametrize("variant", ["float32", "int8_kv", "w8"])
def test_rolling_slot_server_matches_jax(variant):
    """Prompts shorter than, equal to and longer than W = 8, more
    requests than slots: every request's tokens equal the JAX server's
    and the single-request oracle's, and the cache is [L, n_slots, Hkv,
    W, D] whatever the lengths."""
    jcfg, tcfg, jp, tp = _model(8, 2, kv_quant="int8" if variant ==
                                "int8_kv" else "none", w8=variant == "w8")
    kw = dict(n_slots=2, max_len=64, chunk=4)
    jsrv, tsrv = JaxSlotServer(jp, jcfg, **kw), SlotServer(tp, tcfg, **kw)
    assert tuple(tsrv.cache["k"].shape) == (2, 2, 4, 8, 16)
    assert tsrv.buckets == ()
    jr = [jsrv.submit(p, m) for p, m in ROLLING_REQS]
    tr = [tsrv.submit(p, m) for p, m in ROLLING_REQS]
    jd, td = jsrv.run(), tsrv.run()
    oracle = _oracle(tp, tcfg)
    for (prompt, m), j, t in zip(ROLLING_REQS, jr, tr):
        np.testing.assert_array_equal(td[t], jd[j], err_msg=f"P={len(prompt)}")
        np.testing.assert_array_equal(td[t], oracle(prompt, m, 64))


def test_rolling_admission_state_matches_one_shot():
    """Admission's denomination plan and a one-shot prefill_rolling agree
    on the next-token logits (their partial merges differ in order)."""
    _jcfg, tcfg, _jp, tp = _model(8, 2)
    probe = np.asarray([5, 1, 7, 2, 9, 4, 3, 8, 6], np.int32)
    l_hybrid, _ = tserving._rolling_prefill_state(tp, tcfg, probe)
    l_oneshot, _ = tgen.prefill_rolling(tp, tcfg, torch.as_tensor(probe[None]))
    torch.testing.assert_close(l_hybrid, l_oneshot, atol=1e-4, rtol=1e-3)


def test_rolling_server_validation():
    _jcfg, tcfg, _jp, tp = _model(8, 2)
    srv = SlotServer(tp, tcfg, n_slots=1, max_len=32, chunk=2)
    with pytest.raises(ValueError, match="rolling"):
        srv.register_prefix([1, 2, 3])
    with pytest.raises(ValueError, match="exceeds"):
        srv.submit(list(range(1, 30)), 4)
    rid = srv.submit(list(range(1, 25)), 3)  # longer than any window
    assert len(srv.run()[rid]) == 3
    with pytest.raises(NotImplementedError, match="sliding-window"):
        PagedSlotServer(tp, tcfg)


def test_remote_rolling_server_inproc(monkeypatch):
    """RemoteSlotServer over a rolling SlotServer, in process: every
    stream equals the single-request oracle."""
    from starway_tpu_torch.models.remote_serving import (
        RemoteGenerateSession, RemoteSlotServer)
    from conftest import free_port

    monkeypatch.delenv("STARWAY_TLS", raising=False)
    monkeypatch.delenv("STARWAY_NATIVE", raising=False)
    _jcfg, tcfg, _jp, tp = _model(8, 2)
    reqs = ROLLING_REQS[:3]

    async def drive():
        bridge = RemoteSlotServer(SlotServer(tp, tcfg, n_slots=2, max_len=64,
                                             chunk=4))
        port = free_port()
        bridge.server.listen("127.0.0.1", port)
        task = asyncio.create_task(bridge.serve())
        session = await RemoteGenerateSession.aconnect("127.0.0.1", port)
        try:
            return await asyncio.gather(*(session.generate(p, m)
                                          for p, m in reqs))
        finally:
            bridge.stop()
            await task
            await session.aclose()
            await bridge.aclose()

    outs = asyncio.run(drive())
    oracle = _oracle(tp, tcfg)
    for (prompt, m), got in zip(reqs, outs):
        np.testing.assert_array_equal(got, oracle(prompt, m, 64))
