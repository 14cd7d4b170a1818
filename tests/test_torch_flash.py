"""The port's flash attention (starway_tpu_torch.ops.flash) against the
JAX package's Pallas flash kernels in interpret mode, on the same numpy
inputs: the forward (causal and not, a sequence that pads the blocks, a
sliding window, the log-sum-exp against JAX's ``_flash``) and the
gradients of the backward kernels (GQA 4:1 and 1:1, uneven S, window),
through ``flash_backward_reference`` and through autograd.

On the CPU the port's wrappers take their plain PyTorch versions; the CUDA
kernels are held against those versions on the card
(tests/test_torch_cuda.py).  Tolerances: float32 atol 1e-5 for o and lse
(summation order), 2e-5 for gradients (O(1) values summed over up to 64
keys and 4 grouped heads in another order); bfloat16 one rounding of the
largest value, 1e-2 of max |grad|."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from starway_tpu.ops.pallas_attention import _Cfg, _flash, flash_attention
from starway_tpu_torch.ops import flash as tflash
from torch_port_util import to_numpy, to_torch

ATOL = 1e-5
GRAD_ATOL = 2e-5


def _qkv(seed, s, hq=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, hq, s, d), np.float32),
            rng.standard_normal((2, hkv, s, d), np.float32),
            rng.standard_normal((2, hkv, s, d), np.float32))


@pytest.mark.parametrize("causal,window,s", [
    (True, None, 64), (False, None, 64), (True, None, 40), (False, None, 40),
    (True, 9, 64), (True, 20, 40)])
def test_flash_matches_jax_kernel(causal, window, s):
    q, k, v = _qkv(0, s)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window, block_q=32,
                           block_k=32, interpret=True)
    got = tflash.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                                 causal=causal, window=window)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 7)])
def test_flash_lse_matches_jax(causal, window):
    s = 40
    q, k, v = _qkv(1, s)
    cfg = _Cfg(causal=causal, sm_scale=16 ** -0.5, block_q=32, block_k=32,
               bwd_block_q=32, bwd_block_k=32, interpret=True, window=window)
    o, lse8 = _flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg)
    got_o, got_lse = tflash.flash_forward(to_torch(q), to_torch(k),
                                          to_torch(v), causal=causal,
                                          window=window)
    assert got_lse.shape == (2, 4, s) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(got_o), np.asarray(o), atol=ATOL)
    np.testing.assert_allclose(to_numpy(got_lse),
                               np.asarray(lse8)[..., 0].reshape(2, 4, s),
                               atol=ATOL)


def test_flash_bf16_matches_jax_kernel():
    """bfloat16 inputs: atol 2e-2, one bfloat16 rounding of O(1) outputs."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(2, 48))
    want = flash_attention(q, k, v, causal=True, block_q=32, block_k=32,
                           interpret=True)
    got = tflash.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                                 causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               atol=2e-2)


def test_flash_refuses_gradients_and_bad_windows():
    """Gradients now flow through flash_attention (the backward kernels'
    plain version on the CPU) and match autograd through the plain
    forward; a bad window is still refused."""
    q, k, v = (to_torch(a) for a in _qkv(3, 16))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    tflash.flash_attention(*leaves, causal=True).square().sum().backward()
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    tflash.flash_forward_reference(*plain, causal=True)[0].square().sum(
    ).backward()
    for got, want in zip(leaves, plain):
        torch.testing.assert_close(got.grad, want.grad, atol=GRAD_ATOL,
                                   rtol=0)
    with torch.no_grad():
        tflash.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="causal"):
        tflash.flash_forward(q.detach(), k, v, window=4)
    with pytest.raises(ValueError, match="window"):
        tflash.flash_forward(q.detach(), k, v, causal=True, window=0)


def _jax_grads(q, k, v, do, **kw):
    def loss(q, k, v):
        o = flash_attention(q, k, v, block_q=32, block_k=32, interpret=True,
                            **kw)
        return jnp.sum(o.astype(jnp.float32) * do)

    return [np.asarray(g, np.float32)
            for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("causal,window,s,hq,hkv", [
    (True, None, 64, 4, 1), (False, None, 64, 4, 1),
    (True, None, 64, 2, 2), (False, None, 64, 2, 2),
    (True, None, 40, 4, 1), (False, None, 40, 4, 2),
    (True, 9, 64, 4, 1), (True, 20, 40, 2, 2)])
def test_flash_gradients_match_jax_kernel(causal, window, s, hq, hkv):
    """dq/dk/dv of JAX's custom_vjp (the _bwd_dkv/_bwd_dq kernels in
    interpret mode) against the port's flash_backward_reference and
    against autograd through the port's flash_attention: causal and not,
    GQA 4:1 and 1:1, uneven S (40 pads JAX's 32-blocks), windows."""
    q, k, v = _qkv(4, s, hq=hq, hkv=hkv)
    do = np.random.default_rng(5).standard_normal(q.shape, np.float32)
    want = _jax_grads(q, k, v, do, causal=causal, window=window)
    tq, tk, tv, tdo = (to_torch(a) for a in (q, k, v, do))
    o, lse = tflash.flash_forward(tq, tk, tv, causal=causal, window=window)
    ref = tflash.flash_backward_reference(tq, tk, tv, o, lse, tdo,
                                          causal=causal, window=window)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tflash.flash_attention(*leaves, causal=causal, window=window)
    (out * tdo).sum().backward()
    for w, r, leaf in zip(want, ref, leaves):
        np.testing.assert_allclose(to_numpy(r), w, atol=GRAD_ATOL)
        np.testing.assert_allclose(to_numpy(leaf.grad), w, atol=GRAD_ATOL)


def test_flash_backward_matches_jax_bf16():
    """bfloat16 gradients: the same rounding points as the TPU kernels
    (p to dO's dtype, ds to the input dtype); atol 1e-2 of max |grad|."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(6, 48))
    do = jnp.asarray(np.random.default_rng(7).standard_normal(
        q.shape, np.float32), jnp.bfloat16)
    want = _jax_grads(q, k, v, do.astype(jnp.float32), causal=True)
    tq, tk, tv, tdo = (to_torch(a) for a in (q, k, v, do))
    o, lse = tflash.flash_forward(tq, tk, tv, causal=True)
    got = tflash.flash_backward(tq, tk, tv, o, lse, tdo, causal=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(to_numpy(g), w,
                                   atol=1e-2 * np.abs(w).max())


def test_dkv_splits_on_the_main_paths_shapes():
    """Pass A's split over query heads (ops/flash.py dkv_splits): none for
    plain training (B=2, S=2048, 8 kv heads: 512 blocks on 132 SMs); more
    than one at a ring shard (T=1024) and at a zigzag half shard (T=512);
    always a divisor of n_rep, and never past it."""
    assert tflash.dkv_splits(2, 8, 2048, 4) == 1
    assert tflash.dkv_splits(1, 8, 4096, 4) == 1
    for t in (1024, 512):
        n = tflash.dkv_splits(1, 8, t, 4)
        assert n > 1 and 4 % n == 0
    for b, hkv, t, n_rep in [(1, 1, 64, 8), (2, 2, 130, 4), (1, 8, 130, 1),
                             (1, 2, 1000, 6)]:
        n = tflash.dkv_splits(b, hkv, t, n_rep)
        assert 1 <= n <= n_rep and n_rep % n == 0
    assert tflash.dkv_splits(1, 1, 64, 8) == 8
    assert tflash.dkv_splits(1, 8, 130, 1) == 1


def test_dkv_splits_follow_the_cards_sm_count():
    """The split is planned for the card's SMs (the wrapper passes the
    count of k's device): a ring shard's 128 blocks split 4 ways on an
    H100 SXM's 132 SMs (the default), 2 ways on an H100 PCIe's 114, not at
    all on 16; plain training's 512 blocks split only on a card of more
    than 256 SMs."""
    assert tflash.dkv_splits(1, 8, 1024, 4) == 4
    assert tflash.dkv_splits(1, 8, 1024, 4, n_sms=132) == 4
    assert tflash.dkv_splits(1, 8, 1024, 4, n_sms=114) == 2
    assert tflash.dkv_splits(1, 8, 1024, 4, n_sms=16) == 1
    assert tflash.dkv_splits(2, 8, 2048, 4, n_sms=256) == 1
    assert tflash.dkv_splits(2, 8, 2048, 4, n_sms=257) == 2


def test_fwd_q_rows_on_the_main_paths_shapes():
    """The bf16 forward's q-tile height (ops/flash.py fwd_q_rows) on an
    H100 SXM's 132 SMs.  The wgmma kernel (head sizes 64 and 128, the
    main paths' llama3-8b heads) has 64-row tiles only, two blocks an SM;
    head size 16 keeps 64 rows.  Where the kernel has two heights (the
    mma.sync kernel at head size 32): 128 rows for prefill and training
    at S >= 2048 and for the ring's past block, 64 where the 128-row grid
    would not keep the card busy (admission buckets up to 1024, the
    ring's diagonal and partly dead blocks); blocks of equal work (a past
    block, zigzag's unmasked half shards) need a block for every other
    SM, a causal diagonal two blocks an SM."""
    assert tflash.q_heights(128) == tflash.q_heights(64) == (64,)
    assert tflash.q_heights(32) == (64, 128) and tflash.q_heights(16) == (64,)
    for s in (128, 512, 1024, 2048, 4096):
        for d in (64, 128):
            assert tflash.fwd_q_rows(1, 32, s, s, True, head_dim=d) == 64
            assert tflash.fwd_q_rows(2, 32, s, s, False, head_dim=d) == 64
    d32 = dict(head_dim=32)
    assert tflash.fwd_q_rows(1, 32, 2048, 2048, True, **d32) == 128
    assert tflash.fwd_q_rows(2, 32, 2048, 2048, True, **d32) == 128
    assert tflash.fwd_q_rows(1, 32, 4096, 4096, True, **d32) == 128
    for s in (128, 256, 512, 1024):
        assert tflash.fwd_q_rows(1, 32, s, s, True, **d32) == 64
    ring = dict(b=1, hq=32, s_len=1024, kv_len=1024, causal=True, **d32)
    assert tflash.fwd_q_rows(**ring, q_offset=1024, kv_offset=0) == 128
    assert tflash.fwd_q_rows(**ring, q_offset=1024, kv_offset=1024) == 64
    assert tflash.fwd_q_rows(**ring, q_offset=0, kv_offset=512) == 64
    assert tflash.fwd_q_rows(**ring, window=700, q_offset=1024,
                             kv_offset=0) == 64
    assert tflash.fwd_q_rows(1, 32, 512, 512, False, **d32) == 128
    assert tflash.fwd_q_rows(1, 32, 128, 128, False, **d32) == 64
    assert tflash.fwd_q_rows(1, 32, 1024, 1024, False, n_sms=514,
                             **d32) == 64
    assert tflash.fwd_q_rows(1, 32, 2048, 2048, True, n_sms=257, **d32) == 64
    assert tflash.fwd_q_rows(1, 32, 2048, 2048, True, n_sms=114, **d32) == 128
    for d, rows in ((16, 64), (32, 128), (64, 64), (128, 64)):
        assert tflash.fwd_q_rows(2, 32, 2048, 2048, True, head_dim=d) == rows


@pytest.mark.parametrize("causal,window,n_split", [(True, None, 2),
                                                   (True, 9, 4),
                                                   (False, None, 4)])
def test_dkv_split_partials_sum_to_the_whole(causal, window, n_split):
    """The algebra of a split pass A: the backward's function run on each
    group of query heads (split z takes heads [z * n_rep / n, (z + 1) *
    n_rep / n) of every kv head) gives dk/dv partials that sum to the
    whole pass's, and dq rows that are the whole's (float32, 1e-6 of the
    largest value: one summation-order rounding of values up to ~20)."""
    b, hq, hkv, s, d = 2, 8, 2, 40, 16
    n_rep = hq // hkv
    rng = np.random.default_rng(8)
    q, do = (to_torch(rng.standard_normal((b, hq, s, d), np.float32))
             for _ in range(2))
    k, v = (to_torch(rng.standard_normal((b, hkv, s, d), np.float32))
            for _ in range(2))
    lse = to_torch(rng.uniform(2.0, 4.0, (b, hq, s)).astype(np.float32))
    delta = to_torch(rng.standard_normal((b, hq, s)).astype(np.float32))
    args = (causal, window, d ** -0.5, 0, 0)
    dq, dk, dv = tflash._backward_plain(q, k, v, do, lse, delta, *args)
    per = n_rep // n_split
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for z in range(n_split):
        heads = [h * n_rep + r for h in range(hkv)
                 for r in range(z * per, (z + 1) * per)]
        gq, gk, gv = tflash._backward_plain(
            q[:, heads], k, v, do[:, heads], lse[:, heads], delta[:, heads],
            *args)
        torch.testing.assert_close(gq, dq[:, heads], rtol=0,
                                   atol=1e-6 * dq.abs().max().item())
        dk_sum += gk
        dv_sum += gv
    for got, want in ((dk_sum, dk), (dv_sum, dv)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_fwd_route_by_head_size(d):
    """The forward and the ring step's partial run on the wgmma kernel
    (csrc/flash_fwd_wgmma.cu) for bf16 at the main paths' head sizes (128:
    llama3-8b, Mistral-7B, Mixtral; 64), on the mma.sync kernel for heads
    of 16 and 32, and on the FMA loop for float32."""
    want = "wgmma" if d in (64, 128) else "mma"
    assert tflash.fwd_route(True, d) == want
    assert tflash.fwd_route(False, d) == "fma"
    assert tflash.WGMMA_HEAD_DIMS == (64, 128)


def test_flash_kernels_refuse_a_misaligned_base():
    """A view whose base is off the 16-byte grid (TMA's boxes and the
    mma.sync kernels' cp.async chunks both need it) is refused with a
    ValueError before any launch; the routes are decided from the
    arguments, never from a failed launch."""
    import inspect

    n = 2 * 4 * 64 * 128
    base = torch.zeros(8 + n, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    q = base[4:4 + n].view(2, 4, 64, 128)
    assert q.data_ptr() % 16 == 8
    k = v = base[8:].view(2, 4, 64, 128)
    tflash._check_kernel_args((k, k, v), "flash_forward")
    with pytest.raises(ValueError, match="16-byte aligned"):
        tflash._check_kernel_args((q, k, v), "flash_forward")
    for fn in (tflash.flash_forward, tflash._launch_forward,
               tflash.flash_partial, tflash._launch_partial):
        src = inspect.getsource(fn)
        assert "try:" not in src and "except" not in src, fn.__name__
