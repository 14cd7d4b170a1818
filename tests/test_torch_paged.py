"""The port's paged serving slice (starway_tpu_torch.ops.paged and
.models.paged) against the JAX package on the same numpy inputs: paged
decode attention on scrambled tables against the JAX Pallas kernel in
interpret mode, ``paged_decode_step`` against JAX's on the same pool, and
``PagedSlotServer`` against the JAX ``PagedSlotServer`` and the port's own
``generate()``, token for token (greedy, debug preset, float32, CPU).

Tolerances: attention float32 atol=rtol=1e-5 (summation order), bfloat16
2e-2 absolute on O(1) outputs (one bfloat16 rounding); step logits 1e-5 of
max |logit|."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import PagedSlotServer as JaxPagedSlotServer
from starway_tpu.models import init_params as jax_init_params
from starway_tpu.models.llama import cfg_rope_tables as jax_rope
from starway_tpu.models.paged import paged_decode_step as jax_paged_step
from starway_tpu.ops.pallas_paged import \
    paged_decode_attention as jax_paged_attention
from starway_tpu_torch.models import (LlamaConfig, PagedSlotServer, generate,
                                      init_paged_pool, paged_decode_step)
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.llama import cfg_rope_tables
from starway_tpu_torch.ops.paged import (gather_logical,
                                         paged_decode_attention,
                                         paged_decode_attention_reference)
from torch_port_util import to_numpy, to_torch, tree_to_numpy


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


# ------------------------------------------------------------------ kernel
def _scrambled(rng, b, max_pages, n_pages, pos, n_q, page):
    """A permuted block table whose entries past each slot's last live page
    are garbage that must never be read."""
    table = rng.permutation(n_pages)[:b * max_pages].reshape(b, max_pages)
    table = table.astype(np.int32)
    for i, p in enumerate(pos):
        table[i, (p + n_q - 1) // page + 1:] = 10 ** 6 + i
    return table


@pytest.mark.parametrize("page,n_q,dtype", [
    (16, 1, "float32"), (16, 4, "float32"), (128, 1, "float32"),
    (128, 4, "float32"), (16, 4, "bfloat16"), (128, 1, "bfloat16")])
def test_paged_attention_matches_jax_kernel(page, n_q, dtype):
    rng = np.random.default_rng(page + n_q)
    B, HQ, HKV, D, max_pages = 3, 4, 2, 32, 4
    n_pages = B * max_pages + 2
    cap = max_pages * page
    # Cursors straddle page edges: the last slot's chunk ends on the table.
    pos = [page - 1, page + 3, cap - n_q]
    table = _scrambled(rng, B, max_pages, n_pages, pos, n_q, page)
    kp, vp = (jnp.asarray(rng.standard_normal((n_pages, HKV, page, D),
                                              np.float32), dtype)
              for _ in range(2))
    q = jnp.asarray(rng.standard_normal((B, HQ, n_q, D), np.float32), dtype)
    want = jax_paged_attention(q, kp, vp, jnp.asarray(table),
                               jnp.asarray(pos, jnp.int32), interpret=True)
    got = paged_decode_attention(to_torch(q), to_torch(kp), to_torch(vp),
                                 torch.from_numpy(table),
                                 torch.tensor(pos, dtype=torch.int32))
    assert got.dtype == to_torch(q).dtype and got.shape == (B, HQ, n_q, D)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(
        atol=2e-2, rtol=0)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               **tol)


def test_paged_reference_equals_dense_over_gathered_view():
    """The plain version is the dense decode algebra over the logical view,
    whatever the table holds past the cursor."""
    from starway_tpu_torch.ops.decode import decode_attention_reference

    rng = np.random.default_rng(5)
    page, max_pages, n_pages = 16, 3, 8
    q = torch.from_numpy(rng.standard_normal((2, 4, 3, 16), np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((n_pages, 2, page, 16),
                                                   np.float32))
              for _ in range(2))
    pos = [5, 30]
    table = torch.from_numpy(_scrambled(rng, 2, max_pages, n_pages, pos, 3,
                                        page)[:, :max_pages])
    got = paged_decode_attention_reference(q, kp, vp, table,
                                           torch.tensor(pos))
    clean = torch.where(table >= n_pages, 0, table)
    want = decode_attention_reference(q, gather_logical(kp, clean),
                                      gather_logical(vp, clean),
                                      torch.tensor(pos))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("b,c,regime,n_split", [(16, 1, "decode", 2),
                                                  (1, 1, "decode", 16),
                                                  (1, 128, "ingest", 3),
                                                  (16, 8, "ingest", 1)])
def test_paged_plan_on_the_serving_shapes(b, c, regime, n_split):
    """The paged kernel's launch plan (ops/decode.py decode_plan over the
    table's capacity, max_pages * page = 4096 at the serving shape): 16
    slots at C=1 split 2 ways (256 blocks on 132 SMs), one slot at C=1 up
    to the cluster limit, the prefix-ingest suffix (C=128: 8 row tiles x
    8 kv heads, 3 ways) and a chunk of 8 (128 blocks, no split) in 64-row
    tiles; neither the cursors nor the page size enter."""
    from starway_tpu_torch.ops.decode import decode_plan

    for page in (16, 64, 128):
        assert decode_plan(b, 8, 4 * c, (4096 // page) * page) == (regime,
                                                                   n_split)


def test_paged_attention_refuses_int8_and_counts_no_cpu_launch():
    q = torch.zeros((1, 2, 1, 64))
    kp = torch.zeros((2, 1, 128, 64), dtype=torch.int8)
    table = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="int8"):
        paged_decode_attention(q, kp, kp, table, 0)
    before = paged_decode_attention.launches
    kf = torch.zeros((2, 1, 128, 64))
    paged_decode_attention(q, kf, kf, table, 0)
    assert paged_decode_attention.launches == before
    with pytest.raises(ValueError, match="table"):
        paged_decode_attention(q, kf, kf,
                               torch.zeros((2, 1), dtype=torch.int32), 0)


# -------------------------------------------------------------------- step
def test_paged_decode_step_matches_jax(jparams, params):
    """Same params, pool, scrambled table and cursors: logits within 1e-5
    of max |logit|; the written pool's pages equal JAX's."""
    jcfg, tcfg = JaxConfig.preset("debug"), LlamaConfig.preset("debug")
    rng = np.random.default_rng(9)
    page, max_pages, n_pages, B = 16, 3, 10, 3
    shape = (tcfg.n_layers, n_pages, tcfg.n_kv_heads, page, tcfg.head_dim)
    pool_np = {n: rng.standard_normal(shape, np.float32) for n in ("k", "v")}
    table = rng.permutation(np.arange(1, n_pages))[:B * max_pages]
    table = table.reshape(B, max_pages).astype(np.int32)
    pos = np.asarray([3, 16, 40], np.int32)  # one on a page edge
    token = np.asarray([7, 100, 511], np.int32)

    jl, jpool = jax_paged_step(jparams, {n: jnp.asarray(a) for n, a in
                                         pool_np.items()},
                               jnp.asarray(table), jnp.asarray(token),
                               jnp.asarray(pos), jcfg, jax_rope(jcfg, 48))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool_np.items()}
    tl, tpool = paged_decode_step(params, tpool, torch.from_numpy(table),
                                  torch.from_numpy(token).long(),
                                  torch.from_numpy(pos), tcfg,
                                  cfg_rope_tables(tcfg, 48))
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=1e-5 * np.abs(jl).max())
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy(),
                                   np.asarray(jpool[name]), atol=1e-5,
                                   rtol=1e-5)


def test_init_paged_pool_layout():
    cfg = LlamaConfig.preset("debug")
    pool = init_paged_pool(cfg, 5, 16, device="cpu")
    assert pool["k"].shape == (2, 5, cfg.n_kv_heads, 16, cfg.head_dim)
    assert pool["v"].dtype == cfg.compute_dtype and not pool["k"].any()


# ------------------------------------------------------------------ server
def test_paged_server_matches_jax_and_generate(jparams, params):
    """Mixed lengths, more requests than slots, pages recycling through
    the pool: every greedy continuation equals the JAX PagedSlotServer's
    and the port's generate()."""
    jcfg, tcfg = JaxConfig.preset("debug"), LlamaConfig.preset("debug")
    rng = np.random.default_rng(2)
    reqs = [(list(map(int, rng.integers(1, tcfg.vocab_size, n))), m)
            for n, m in [(3, 6), (7, 4), (12, 9), (5, 1), (2, 11), (9, 3)]]
    kw = dict(n_slots=2, max_len=64, page=16, n_pages=9, chunk=4)
    jsrv, tsrv = JaxPagedSlotServer(jparams, jcfg, **kw), PagedSlotServer(
        params, tcfg, **kw)
    jr = [jsrv.submit(p, m) for p, m in reqs]
    tr = [tsrv.submit(p, m) for p, m in reqs]
    jd, td = jsrv.run(), tsrv.run()
    assert sorted(td) == tr
    for (prompt, max_new), j, t in zip(reqs, jr, tr):
        np.testing.assert_array_equal(td[t], jd[j])
        np.testing.assert_array_equal(td[t],
                                      _oracle(params, tcfg, prompt, max_new))
    assert tsrv.pages_in_use == 0  # everything returned to the pool


def test_paged_server_undersized_pool_serves_short_requests(params):
    """4 slots x max_len 64 would reserve 16 pages densely; 7 pages (and
    the trash page) serve 8 short requests."""
    cfg = LlamaConfig.preset("debug")
    rng = np.random.default_rng(3)
    reqs = [(list(map(int, rng.integers(1, cfg.vocab_size, 4))), 6)
            for _ in range(8)]
    srv = PagedSlotServer(params, cfg, n_slots=4, max_len=64, page=16,
                          n_pages=8, chunk=4)
    assert srv.n_pages - 1 < srv.n_slots * srv.max_pages
    rids = [srv.submit(p, m) for p, m in reqs]
    done = srv.run()
    for rid, (prompt, max_new) in zip(rids, reqs):
        np.testing.assert_array_equal(done[rid],
                                      _oracle(params, cfg, prompt, max_new))
    assert srv.pages_in_use == 0


def test_paged_server_eos_and_staggered_admission(params):
    cfg = LlamaConfig.preset("debug")
    prompt = [5, 1, 7, 2, 9]
    eos = int(_oracle(params, cfg, prompt, 8)[1])
    srv = PagedSlotServer(params, cfg, n_slots=2, max_len=64, page=16,
                          n_pages=9, chunk=3, eos_id=eos)
    r0 = srv.submit(prompt, 8)
    done = dict(srv.step())  # r0 may already end inside this chunk
    r1 = srv.submit([3, 8, 6], 5)
    done.update(srv.run())
    np.testing.assert_array_equal(done[r0],
                                  _oracle(params, cfg, prompt, 8, eos))
    np.testing.assert_array_equal(done[r1],
                                  _oracle(params, cfg, [3, 8, 6], 5, eos))
    assert srv.pages_in_use == 0


def test_paged_server_cancel_frees_pages(params):
    cfg = LlamaConfig.preset("debug")
    srv = PagedSlotServer(params, cfg, n_slots=2, max_len=64, page=16,
                          n_pages=9, chunk=4)
    rid = srv.submit(list(range(1, 10)), 20)
    srv.step()
    assert srv.pages_in_use > 0
    assert srv.cancel(rid) is True
    assert srv.pages_in_use == 0
    r1 = srv.submit([4, 2, 8], 5)  # the pages recycle into the next request
    done = srv.run()
    np.testing.assert_array_equal(done[r1], _oracle(params, cfg, [4, 2, 8], 5))
    assert srv.pages_in_use == 0


def test_paged_server_pool_exhaustion_is_loud(params):
    """Lazy growth past the pool raises; it never corrupts."""
    cfg = LlamaConfig.preset("debug")
    srv = PagedSlotServer(params, cfg, n_slots=2, max_len=64, page=16,
                          n_pages=3, chunk=4)  # 2 usable pages
    srv.submit(list(range(1, 30)), 4)  # 2 pages at admission, a 3rd later
    srv.submit(list(range(1, 30)), 4)  # waits: no page is free
    with pytest.raises(RuntimeError, match="pool exhausted"):
        srv.run()


def test_paged_server_refusals(params):
    with pytest.raises(NotImplementedError, match="rolling"):
        PagedSlotServer(params, LlamaConfig.preset("debug",
                                                   sliding_window=16),
                        max_len=64)
    with pytest.raises(NotImplementedError, match="int8"):
        PagedSlotServer(params, LlamaConfig.preset("debug", kv_quant="int8"),
                        max_len=64)
    cfg = LlamaConfig.preset("debug")
    with pytest.raises(ValueError, match="divide"):
        PagedSlotServer(params, cfg, max_len=60, page=16)
    with pytest.raises(ValueError, match="trash"):
        PagedSlotServer(params, cfg, max_len=64, page=16, n_pages=1)


def test_paged_request_that_can_never_fit_is_refused_at_submit(params):
    """No livelock: a request whose admission needs more pages than the
    pool has is refused by submit(), and run() returns for the rest."""
    cfg = LlamaConfig.preset("debug")
    srv = PagedSlotServer(params, cfg, n_slots=2, max_len=64, page=16,
                          n_pages=3, chunk=4)  # 2 usable pages
    with pytest.raises(ValueError, match="never be admitted"):
        srv.submit(list(range(1, 40)), 4)  # a 64 bucket: 4 pages
    rid = srv.submit([4, 2, 8], 5)
    done = srv.run()
    assert sorted(done) == [rid] and not srv.busy
    np.testing.assert_array_equal(done[rid],
                                  _oracle(params, cfg, [4, 2, 8], 5))
