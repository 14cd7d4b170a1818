"""The port's serving slice as a whole (starway_tpu_torch.models.serving
and .generate) against the JAX package on the same parameters: greedy
SlotServer tokens equal the JAX SlotServer's and the port's own
generate(), token for token, for mixed lengths, more requests than slots,
eos, and the int8 KV + W8A16 tree; cancel and on_tokens behave as the
reference's; generate()'s ragged and logprob paths match JAX's.  Debug
preset, float32, on the CPU."""

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
from starway_tpu_torch.models import LlamaConfig, SlotServer, generate
from starway_tpu_torch.models.convert import params_from_numpy
from torch_port_util import to_numpy, tree_to_numpy

jgen = importlib.import_module("starway_tpu.models.generate")


@pytest.fixture(scope="module")
def jparams():
    return jax_init_params(jax.random.PRNGKey(0), JaxConfig.preset("debug"))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(tree_to_numpy(jparams), device="cpu")


def _oracle(params, cfg, prompt, max_new, eos_id=None):
    out = generate(params, cfg, torch.tensor([prompt]), max_new,
                   eos_id=eos_id)
    toks = out[0, len(prompt):].numpy()
    if eos_id is not None and eos_id in toks:
        toks = toks[: list(toks).index(eos_id) + 1]  # server stops at eos
    return toks


def _requests(seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, n).tolist(), m)
            for n, m in [(3, 6), (7, 4), (12, 9), (5, 1), (2, 11), (40, 3)]]


def _serve_both(jp, jcfg, tp, tcfg, reqs, **kw):
    jsrv = JaxSlotServer(jp, jcfg, **kw)
    tsrv = SlotServer(tp, tcfg, **kw)
    jr = [jsrv.submit(p, m) for p, m in reqs]
    tr = [tsrv.submit(p, m) for p, m in reqs]
    jd, td = jsrv.run(), tsrv.run()
    assert sorted(td) == tr
    return [jd[r] for r in jr], [td[r] for r in tr]


@pytest.mark.parametrize("quantized", [False, True])
def test_slot_server_matches_jax_and_generate(jparams, params, quantized):
    kw = dict(kv_quant="int8") if quantized else {}
    jcfg, tcfg = JaxConfig.preset("debug", **kw), LlamaConfig.preset(
        "debug", **kw)
    jp, tp = jparams, params
    if quantized:
        jp = jax_quantize_params(jparams)
        tp = params_from_numpy(tree_to_numpy(jp), device="cpu")
    reqs = _requests(0)
    jout, tout = _serve_both(jp, jcfg, tp, tcfg, reqs, n_slots=2,
                             max_len=64, chunk=4)
    for (prompt, max_new), j, t in zip(reqs, jout, tout):
        np.testing.assert_array_equal(t, j, err_msg=f"P={len(prompt)}")
        np.testing.assert_array_equal(t, _oracle(tp, tcfg, prompt, max_new))


def test_slot_server_eos_matches_jax(jparams, params):
    jcfg, tcfg = JaxConfig.preset("debug"), LlamaConfig.preset("debug")
    prompt = [5, 1, 7, 2, 9]
    eos = int(_oracle(params, tcfg, prompt, 8)[1])  # stop on token two
    reqs = [(prompt, 8), ([3, 8, 6], 5)]
    jout, tout = _serve_both(jparams, jcfg, params, tcfg, reqs, n_slots=2,
                             max_len=64, chunk=4, eos_id=eos)
    for (p, m), j, t in zip(reqs, jout, tout):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, _oracle(params, tcfg, p, m, eos))
    assert tout[0][-1] == eos and len(tout[0]) <= 8


def test_staggered_admission_matches_generate(params):
    cfg = LlamaConfig.preset("debug")
    srv = SlotServer(params, cfg, n_slots=2, max_len=64, chunk=3)
    r0 = srv.submit([4, 2, 8, 1], 9)
    srv.step()  # r0 is now mid-generation
    r1 = srv.submit([6, 6, 3], 7)
    done = srv.run()
    np.testing.assert_array_equal(done[r0],
                                  _oracle(params, cfg, [4, 2, 8, 1], 9))
    np.testing.assert_array_equal(done[r1], _oracle(params, cfg, [6, 6, 3], 7))


def test_sampled_serving_is_wellformed(params):
    cfg = LlamaConfig.preset("debug")
    srv = SlotServer(params, cfg, n_slots=2, max_len=64, chunk=4,
                     temperature=0.8, top_k=16, top_p=0.9, seed=3)
    rids = [srv.submit([1, 2, 3], 6), srv.submit([9, 9], 4)]
    done = srv.run()
    assert len(done[rids[0]]) == 6 and len(done[rids[1]]) == 4
    for toks in done.values():
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all()


def test_sampling_distribution():
    """The sampled path is held by distribution: draws from top-k=2 over
    two dominant logits land only on those two, near their softmax odds."""
    gen_mod = importlib.import_module("starway_tpu_torch.models.generate")
    logits = torch.tensor([[2.0, 1.0, -1.0, 0.0]]).repeat(4000, 1)
    g = torch.Generator().manual_seed(0)
    draws = gen_mod._sample(logits, g, 1.0, 2, None)
    assert set(draws.tolist()) <= {0, 1}
    p0 = float(np.exp(1.0) / (np.exp(1.0) + 1.0))
    assert abs(float((draws == 0).float().mean()) - p0) < 0.03
    filt = gen_mod._filter_logits(torch.tensor([[3.0, 2.0, 1.0, 0.0]]), 1.0,
                                  None, 0.7)
    want = jgen._filter_logits(jnp.asarray([[3.0, 2.0, 1.0, 0.0]]), 1.0,
                               None, 0.7)
    np.testing.assert_allclose(to_numpy(filt), np.asarray(want))


def test_serving_validation_and_unported(params):
    cfg = LlamaConfig.preset("debug")
    srv = SlotServer(params, cfg, n_slots=1, max_len=32)
    with pytest.raises(ValueError, match="max_new"):
        srv.submit([1, 2], 0)
    with pytest.raises(ValueError, match="empty"):
        srv.submit([], 3)
    with pytest.raises(ValueError, match="exceeds"):
        srv.submit(list(range(1, 30)), 10)
    with pytest.raises(ValueError, match="n_slots"):
        SlotServer(params, cfg, n_slots=0)
    with pytest.raises(ValueError, match="smallest suffix bucket"):
        srv.register_prefix(list(range(1, 32)))  # leaves no suffix room
    # Sliding-window models serve through rolling slots now
    # (tests/test_torch_rolling.py): W slots a row, no prompt buckets.
    rolling = SlotServer(params, LlamaConfig.preset("debug", sliding_window=8),
                         n_slots=1, max_len=32)
    assert rolling.cache["k"].shape[3] == 8 and rolling.buckets == ()
    # MoE serves when provably dropless (tests/test_torch_moe.py); the
    # default capacity factor of 1.25 is not.
    with pytest.raises(ValueError, match="dropless"):
        SlotServer(params, LlamaConfig.preset("debug", n_experts=4))


def test_cancel_pending_and_inflight(params):
    cfg = LlamaConfig.preset("debug")
    srv = SlotServer(params, cfg, n_slots=1, max_len=64, chunk=3)
    r0 = srv.submit([4, 2, 8, 1], 20)
    r1 = srv.submit([6, 6, 3], 7)
    r2 = srv.submit([9, 1, 5], 6)
    srv.step()
    assert srv.cancel(r1) is True       # pending: de-queued
    assert srv.cancel(r0) is True       # in flight: slot killed
    assert srv.cancel(r0) is False
    assert srv.cancel(12345) is False
    done = srv.run()
    assert sorted(done) == [r2]
    np.testing.assert_array_equal(done[r2], _oracle(params, cfg, [9, 1, 5], 6))


def test_cancel_emits_no_done_event(params):
    cfg = LlamaConfig.preset("debug")
    events = []
    srv = SlotServer(params, cfg, n_slots=2, max_len=64, chunk=3,
                     on_tokens=lambda rid, toks, done: events.append(
                         (rid, list(toks), done)))
    r0 = srv.submit([4, 2, 8], 12)
    r1 = srv.submit([7, 7], 5)
    srv.step()
    srv.cancel(r0)
    srv.run()
    assert [rid for rid, _t, d in events if d] == [r1]
    streamed = [t for rid, toks, d in events if rid == r1 for t in toks]
    np.testing.assert_array_equal(streamed, _oracle(params, cfg, [7, 7], 5))


def test_cancel_reentrant_from_on_tokens(params):
    cfg = LlamaConfig.preset("debug")
    state = {}

    def hook(rid, toks, done):
        if "r1" in state and rid == state["r0"] and not state.get("done"):
            state["done"] = True
            assert state["srv"].cancel(state["r1"]) is True

    srv = SlotServer(params, cfg, n_slots=2, max_len=64, chunk=3,
                     on_tokens=hook)
    state["srv"] = srv
    state["r0"] = srv.submit([4, 2, 8], 9)
    state["r1"] = srv.submit([7, 7], 9)
    done = srv.run()
    assert sorted(done) == [state["r0"]]
    np.testing.assert_array_equal(done[state["r0"]],
                                  _oracle(params, cfg, [4, 2, 8], 9))


def test_cancel_own_request_from_admit_callback(params):
    cfg = LlamaConfig.preset("debug")
    state = {}

    def hook(rid, toks, done):
        if rid == state.get("victim") and not done:
            state["srv"].cancel(rid)

    srv = SlotServer(params, cfg, n_slots=1, max_len=64, chunk=3,
                     on_tokens=hook)
    state["srv"] = srv
    state["victim"] = srv.submit([4, 2, 8, 1], 20)
    r1 = srv.submit([9, 1, 5], 6)
    done = srv.run()
    assert sorted(done) == [r1]
    np.testing.assert_array_equal(done[r1], _oracle(params, cfg, [9, 1, 5], 6))
    assert not srv.busy and not srv._slot_rid


def test_generate_ragged_logprobs_eos_match_jax(jparams, params):
    jcfg, tcfg = JaxConfig.preset("debug"), LlamaConfig.preset("debug")
    rng = np.random.default_rng(11)
    prompt = rng.integers(1, 512, (3, 7)).astype(np.int32)
    lengths = np.asarray([7, 3, 5], np.int32)
    jt, jlp = jgen.generate(jparams, jcfg, jnp.asarray(prompt), 6,
                            prompt_lengths=lengths, return_logprobs=True)
    tt, tlp = generate(params, tcfg, torch.as_tensor(prompt), 6,
                       prompt_lengths=lengths, return_logprobs=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4)
    eos = int(np.asarray(jt)[0, 2])
    ja = jgen.generate(jparams, jcfg, jnp.asarray(prompt), 5, eos_id=eos)
    ta = generate(params, tcfg, torch.as_tensor(prompt), 5, eos_id=eos)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    with pytest.raises(ValueError, match="prompt_lengths"):
        generate(params, tcfg, torch.as_tensor(prompt), 2,
                 prompt_lengths=[0, 1, 2])


@pytest.mark.parametrize("server", ["SlotServer", "PagedSlotServer"])
def test_server_frees_its_weights_without_the_cycle_collector(server):
    """A served-out server holds its weights and cache in no reference
    cycle: dropping the last names frees them at once, with the cycle
    collector off."""
    import gc
    import weakref

    from starway_tpu_torch.models import PagedSlotServer
    from starway_tpu_torch.utils.tree import tree_leaves

    cls, kw = ((SlotServer, {}) if server == "SlotServer"
               else (PagedSlotServer, dict(page=16)))
    cfg = LlamaConfig.preset("debug")
    jp = jax_init_params(jax.random.PRNGKey(1), JaxConfig.preset("debug"))
    params = params_from_numpy(tree_to_numpy(jp), device="cpu")
    embed = weakref.ref(params["embed"])
    srv = cls(params, cfg, n_slots=2, max_len=64, chunk=4, **kw)
    srv.submit([3, 1, 4], 5)
    srv.run()
    cache = weakref.ref(tree_leaves(srv.cache)[0])
    gc.disable()
    try:
        del params, srv
        assert embed() is None and cache() is None
    finally:
        gc.enable()
