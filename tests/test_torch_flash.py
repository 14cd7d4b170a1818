"""The port's flash-attention forward (starway_tpu_torch.ops.flash)
against the JAX package's Pallas flash kernel in interpret mode, on the
same numpy inputs: causal and not, a sequence that pads the blocks, a
sliding window, and the log-sum-exp against JAX's ``_flash``.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel is held against that version on the card (tests/test_torch_cuda.py).
Tolerances: float32 atol 1e-5 for o and lse (summation order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from starway_tpu.ops.pallas_attention import _Cfg, _flash, flash_attention
from starway_tpu_torch.ops import flash as tflash
from torch_port_util import to_numpy, to_torch

ATOL = 1e-5


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
    q, k, v = (to_torch(a) for a in _qkv(3, 16))
    with pytest.raises(NotImplementedError, match="backward"):
        tflash.flash_attention(q.requires_grad_(), k, v, causal=True)
    with torch.no_grad():
        tflash.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="causal"):
        tflash.flash_forward(q.detach(), k, v, window=4)
    with pytest.raises(ValueError, match="window"):
        tflash.flash_forward(q.detach(), k, v, causal=True, window=0)
