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
