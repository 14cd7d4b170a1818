"""Prefix caching in the port (starway_tpu_torch.models.speculative,
.serving and .paged) against the JAX package: ``chunk_decode_step`` on
the same params and caches (dense and int8, C=1 and C=5), the dense
``SlotServer``'s prefixed requests against the JAX ``SlotServer``'s, and
the paged server's shared prefix pages against the JAX
``PagedSlotServer``, all token for token and equal to ``generate(prefix +
suffix)`` (greedy, debug preset, float32, CPU).  Two defects of the JAX
paged server are absent here and shown against the stated behaviour: a
failing admission or prefix registration leaves the pool's pages and
refcounts as they were.

Tolerances: logits 1e-5 of max |logit|; cache entries 1e-5 (float32
values and int8 scales), int8 values within one quantization step (a value
on a rounding edge may round either way after another summation
order)."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import PagedSlotServer as JaxPagedSlotServer
from starway_tpu.models import SlotServer as JaxSlotServer
from starway_tpu.models import init_params as jax_init_params
from starway_tpu.models.generate import init_cache as jax_init_cache
from starway_tpu.models.llama import cfg_rope_tables as jax_rope
from starway_tpu.models.speculative import chunk_decode_step as jax_chunk
from starway_tpu_torch.models import (LlamaConfig, PagedSlotServer,
                                      SlotServer, chunk_decode_step,
                                      decode_step, generate)
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.llama import cfg_rope_tables
from torch_port_util import tree_to_numpy

paged_mod = importlib.import_module("starway_tpu_torch.models.paged")
serving_mod = importlib.import_module("starway_tpu_torch.models.serving")


@pytest.fixture(scope="module")
def jparams():
    return jax_init_params(jax.random.PRNGKey(0), JaxConfig.preset("debug"))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(tree_to_numpy(jparams), device="cpu")


def _oracle(params, cfg, prompt, max_new):
    out = generate(params, cfg, torch.tensor([prompt]), max_new)
    return out[0, len(prompt):].numpy()


# ------------------------------------------------------- chunk_decode_step
def _filled_cache(cfg_kw, seed, B, T):
    """A JAX cache of random contents (int8 with its scales when asked)
    and the same numbers for the port."""
    jcfg = JaxConfig.preset("debug", **cfg_kw)
    cache = jax_init_cache(jcfg, B, T)
    rng = np.random.default_rng(seed)
    filled = {}
    for name, a in cache.items():
        if a.dtype == jnp.int8:
            filled[name] = rng.integers(-127, 128, a.shape).astype(np.int8)
        elif name.endswith("scale"):
            filled[name] = rng.uniform(0.005, 0.02,
                                       a.shape).astype(np.float32)
        else:
            filled[name] = rng.standard_normal(a.shape).astype(np.float32)
    return filled


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("n_q", [1, 5])
def test_chunk_decode_step_matches_jax(jparams, params, kv_quant, n_q):
    kw = dict(kv_quant=kv_quant)
    jcfg, tcfg = JaxConfig.preset("debug", **kw), LlamaConfig.preset(
        "debug", **kw)
    B, T = 2, 32
    cache = _filled_cache(kw, 3, B, T)
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, 512, (B, n_q)).astype(np.int32)
    pos = np.asarray([4, 19], np.int32)
    jl, jc = jax_chunk(jparams, {n: jnp.asarray(a) for n, a in cache.items()},
                       jnp.asarray(tokens), jnp.asarray(pos), jcfg,
                       jax_rope(jcfg, T))
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tl, tc = chunk_decode_step(params, tc, torch.from_numpy(tokens).long(),
                               torch.from_numpy(pos), tcfg,
                               cfg_rope_tables(tcfg, T))
    jl = np.asarray(jl)
    assert tl.shape == (B, n_q, tcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=1e-5 * np.abs(jl).max())
    for name in cache:
        got, want = tc[name].numpy(), np.asarray(jc[name])
        if want.dtype == np.int8:
            # Quantized entries may differ by one step where the float
            # value sits on a rounding edge.
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_chunk_decode_step_of_one_is_decode_step(params):
    cfg = LlamaConfig.preset("debug")
    cache = {n: torch.from_numpy(a) for n, a in
             _filled_cache({}, 5, 2, 16).items()}
    other = {n: t.clone() for n, t in cache.items()}
    tok = torch.tensor([3, 9])
    pos = torch.tensor([2, 11], dtype=torch.int32)
    rope = cfg_rope_tables(cfg, 16)
    got, cache = chunk_decode_step(params, cache, tok[:, None], pos, cfg,
                                   rope)
    want, other = decode_step(params, other, tok, pos, cfg, rope)
    torch.testing.assert_close(got[:, 0], want, atol=1e-5, rtol=1e-5)
    for name in cache:
        torch.testing.assert_close(cache[name], other[name])


def test_chunk_decode_step_refuses_rolling_cache(params):
    cfg = LlamaConfig.preset("debug", sliding_window=8)
    cache = {n: torch.from_numpy(a) for n, a in
             _filled_cache({}, 6, 1, 8).items()}
    with pytest.raises(ValueError, match="rolling"):
        chunk_decode_step(params, cache, torch.tensor([[1, 2]]), 0, cfg,
                          cfg_rope_tables(cfg, 16))


# ------------------------------------------------------ dense SlotServer
def test_dense_prefix_caching_matches_jax_and_generate(jparams, params):
    """Requests sharing registered prefixes (two prefixes and none,
    cohabiting) generate exactly what the JAX server and
    generate(prefix + suffix) produce."""
    jcfg, tcfg = JaxConfig.preset("debug"), LlamaConfig.preset("debug")
    rng = np.random.default_rng(7)
    pre = {"a": list(map(int, rng.integers(1, 512, 9))),
           "b": list(map(int, rng.integers(1, 512, 4))), None: []}
    reqs = [(list(map(int, rng.integers(1, 512, n))), m, w)
            for n, m, w in [(3, 6, "a"), (7, 4, "a"), (2, 8, "b"),
                            (5, 5, None), (1, 7, "a")]]
    outs = []
    for srv in (JaxSlotServer(jparams, jcfg, n_slots=2, max_len=64, chunk=4),
                SlotServer(params, tcfg, n_slots=2, max_len=64, chunk=4)):
        pids = {"a": srv.register_prefix(pre["a"]),
                "b": srv.register_prefix(pre["b"]), None: None}
        rids = [srv.submit(s, m, prefix=pids[w]) for s, m, w in reqs]
        done = srv.run()
        assert sorted(done) == sorted(rids)
        outs.append([done[r] for r in rids])
    for (s, m, w), j, t in zip(reqs, *outs):
        np.testing.assert_array_equal(t, j, err_msg=f"prefix {w}")
        np.testing.assert_array_equal(t, _oracle(params, tcfg, pre[w] + s, m))


def test_dense_prefix_caching_int8_cache(jparams, params):
    """Prefix rows, the suffix ingest and decode on the int8 cache, whose
    scales ride along with the rows."""
    jcfg = JaxConfig.preset("debug", kv_quant="int8")
    tcfg = LlamaConfig.preset("debug", kv_quant="int8")
    rng = np.random.default_rng(8)
    pre = list(map(int, rng.integers(1, 512, 6)))
    suf = list(map(int, rng.integers(1, 512, 3)))
    outs = []
    for srv in (JaxSlotServer(jparams, jcfg, n_slots=2, max_len=64, chunk=4),
                SlotServer(params, tcfg, n_slots=2, max_len=64, chunk=4)):
        rid = srv.submit(suf, 6, prefix=srv.register_prefix(pre))
        outs.append(srv.run()[rid])
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], _oracle(params, tcfg, pre + suf, 6))


def test_prefix_validation(params):
    cfg = LlamaConfig.preset("debug")
    srv = SlotServer(params, cfg, n_slots=1, max_len=64, chunk=2)
    with pytest.raises(KeyError):
        srv.submit([1, 2], 4, prefix=99)
    pid = srv.register_prefix([1, 2, 3])
    with pytest.raises(ValueError, match="exceeds"):
        srv.submit([1] * 40, 30, prefix=pid)  # prefix + suffix + new > 64
    with pytest.raises(ValueError, match="suffix bucket"):
        srv.submit([1] * 40, 5, prefix=pid)  # 3 + the 64 bucket > 64
    with pytest.raises(ValueError, match="smallest suffix bucket"):
        srv.register_prefix([1] * 62)
    with pytest.raises(ValueError, match="empty"):
        srv.register_prefix([])
    rid = srv.submit([4, 5], 3, prefix=pid)
    with pytest.raises(ValueError, match="referenced"):
        srv.drop_prefix(pid)
    assert rid in srv.run()
    srv.drop_prefix(pid)
    with pytest.raises(KeyError):
        srv.submit([1, 2], 4, prefix=pid)


# ------------------------------------------------------------ paged server
@pytest.mark.parametrize("plen,suffixes", [
    (20, [[3, 1, 4], [1, 5], [9, 2, 6, 5]]),  # 1 shared page + a tail
    (16, [[7, 7, 2]]),                        # page-aligned: no tail
])
def test_paged_prefix_pages_match_jax_and_generate(jparams, params, plen,
                                                   suffixes):
    """Zero-copy prefix sharing: every suffix request generates what the
    JAX PagedSlotServer and generate(prefix + suffix) do, the shared page
    is counted once however many slots reference it, and dropping the
    prefix returns it."""
    jcfg, tcfg = JaxConfig.preset("debug"), LlamaConfig.preset("debug")
    prefix = list(map(int, np.random.default_rng(plen).integers(1, 512,
                                                                plen)))
    kw = dict(n_slots=3, max_len=64, page=16, n_pages=12, chunk=4)
    outs = []
    for srv in (JaxPagedSlotServer(jparams, jcfg, **kw),
                PagedSlotServer(params, tcfg, **kw)):
        pid = srv.register_prefix(prefix)
        assert srv.pages_in_use == plen // 16  # whole pages; tail aside
        rids = [srv.submit(s, 6, prefix=pid) for s in suffixes]
        srv.step()  # every request admitted: the shared page counted once
        assert srv.pages_in_use < 1 + 3 * 2 + 2
        done = srv.run()
        outs.append([done[r] for r in rids])
        assert srv.pages_in_use == plen // 16  # the registry's pages
        srv.drop_prefix(pid)
        assert srv.pages_in_use == 0
    for s, j, t in zip(suffixes, *outs):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, _oracle(params, tcfg, prefix + s, 6))


def test_paged_prefix_mixed_with_plain_requests(params):
    cfg = LlamaConfig.preset("debug")
    rng = np.random.default_rng(12)
    prefix = list(map(int, rng.integers(1, 512, 37)))
    reqs = [(list(map(int, rng.integers(1, 512, n))), m, w)
            for n, m, w in [(5, 7, True), (12, 4, False), (2, 9, True),
                            (20, 5, False), (9, 3, True)]]
    srv = PagedSlotServer(params, cfg, n_slots=2, max_len=128, page=16,
                          n_pages=20, chunk=3)
    pid = srv.register_prefix(prefix)
    rids = [srv.submit(s, m, prefix=pid if w else None) for s, m, w in reqs]
    done = srv.run()
    for rid, (s, m, w) in zip(rids, reqs):
        np.testing.assert_array_equal(
            done[rid], _oracle(params, cfg, (prefix if w else []) + s, m))
    assert srv.pages_in_use == 2
    srv.drop_prefix(pid)
    assert srv.pages_in_use == 0
    small = PagedSlotServer(params, cfg, n_slots=1, max_len=128, page=16,
                            n_pages=6, chunk=3)
    pid = small.register_prefix(prefix)
    with pytest.raises(ValueError, match="never be admitted"):
        small.submit([1] * 60, 4, prefix=pid)  # 37 + a 64 bucket: 7 pages


def _refs_and_pages(srv):
    return dict(srv._page_refs), srv.pages_in_use, list(srv._free)


def test_failed_prefixed_admission_leaks_no_pages(params, monkeypatch):
    """The device work of a prefixed admission fails: the free list, the
    pages in use and the shared pages' refcounts are as before, and the
    error propagates (the request is not re-queued)."""
    cfg = LlamaConfig.preset("debug")
    srv = PagedSlotServer(params, cfg, n_slots=2, max_len=64, page=16,
                          n_pages=10, chunk=4)
    pid = srv.register_prefix(list(range(1, 21)))
    before = _refs_and_pages(srv)

    def boom(*args, **kwargs):
        raise RuntimeError("device failure")

    monkeypatch.setattr(paged_mod, "paged_chunk_step", boom)
    srv.submit([4, 2, 8], 5, prefix=pid)
    with pytest.raises(RuntimeError, match="device failure"):
        srv.step()
    assert _refs_and_pages(srv) == before
    assert not srv.busy and not srv._tables.any()
    monkeypatch.undo()
    rid = srv.submit([4, 2, 8], 5, prefix=pid)
    np.testing.assert_array_equal(
        srv.run()[rid],
        _oracle(params, cfg, list(range(1, 21)) + [4, 2, 8], 5))
    assert _refs_and_pages(srv)[:2] == before[:2]


def test_failed_registration_and_plain_admission_leak_no_pages(
        params, monkeypatch):
    cfg = LlamaConfig.preset("debug")
    srv = PagedSlotServer(params, cfg, n_slots=2, max_len=64, page=16,
                          n_pages=10, chunk=4)
    before = _refs_and_pages(srv)

    def boom(*args, **kwargs):
        raise RuntimeError("device failure")

    monkeypatch.setattr(serving_mod, "prefill", boom)
    with pytest.raises(RuntimeError, match="device failure"):
        srv.register_prefix(list(range(1, 40)))
    srv.submit([4, 2, 8], 5)
    with pytest.raises(RuntimeError, match="device failure"):
        srv.step()
    assert _refs_and_pages(srv) == before and not srv._prefixes
    assert not srv.busy and not srv._tables.any()
