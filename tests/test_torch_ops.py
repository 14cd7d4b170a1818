"""The port's attention oracles and quantize functions
(starway_tpu_torch.ops.attention, .quantize) against the JAX package's on
the same numpy inputs.  Attention in float32: atol 1e-5 (the two frameworks
sum in different orders).  int8 codes: exactly equal (both round half to
even on the same float32 values); scales: float32 rtol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from starway_tpu.ops import attention as jatt
from starway_tpu.ops import quantize as jq
from starway_tpu_torch.ops import attention as tatt
from starway_tpu_torch.ops import quantize as tq
from torch_port_util import to_numpy, to_torch

ATOL = 1e-5


def _qkv(seed, b=2, hq=4, hkv=4, tq_=12, tkv=12, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, tq_, d), np.float32),
            rng.standard_normal((b, hkv, tkv, d), np.float32),
            rng.standard_normal((b, hkv, tkv, d), np.float32))


def test_constants_match():
    assert tatt.NEG_BIG == jatt.NEG_BIG
    assert tq.INT8_MAX == jq.INT8_MAX
    assert tq._MATMUL_LEAVES == jq._MATMUL_LEAVES


@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_repeat_kv(n_rep):
    _, k, _ = _qkv(0, hkv=2)
    np.testing.assert_array_equal(
        to_numpy(tatt.repeat_kv(to_torch(k), n_rep)),
        np.asarray(jatt.repeat_kv(jnp.asarray(k), n_rep)))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(causal=True),
    dict(causal=True, q_offset=8, kv_offset=4),
    dict(causal=True, window=3, q_offset=5, kv_offset=0),
    dict(kv_limit=7),
    dict(causal=True, kv_min=2, kv_offset=-3, q_offset=0),
])
def test_partial_attention(kw):
    q, k, v = _qkv(1)
    want = jatt.partial_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    got = tatt.partial_attention(to_torch(q), to_torch(k), to_torch(v), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), atol=ATOL,
                                   rtol=1e-5)


def test_merge_zero_finalize():
    q, k, v = _qkv(2)
    ja = jatt.partial_attention(jnp.asarray(q), jnp.asarray(k[:, :, :5]),
                                jnp.asarray(v[:, :, :5]), causal=True)
    jb = jatt.partial_attention(jnp.asarray(q), jnp.asarray(k[:, :, 5:]),
                                jnp.asarray(v[:, :, 5:]), causal=True,
                                kv_offset=5)
    jm = jatt.merge_partials(jatt.merge_partials(jatt.zero_partial(
        jnp.asarray(q)), ja), jb)
    tq_, tk, tv = to_torch(q), to_torch(k), to_torch(v)
    ta = tatt.partial_attention(tq_, tk[:, :, :5], tv[:, :, :5], causal=True)
    tb = tatt.partial_attention(tq_, tk[:, :, 5:], tv[:, :, 5:], causal=True,
                                kv_offset=5)
    tm = tatt.merge_partials(tatt.merge_partials(tatt.zero_partial(tq_), ta),
                             tb)
    for g, w in zip(tm, jm):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), atol=ATOL,
                                   rtol=1e-5)
    np.testing.assert_allclose(
        to_numpy(tatt.finalize_partial(*tm, out_dtype=torch.float32)),
        np.asarray(jatt.finalize_partial(*jm, out_dtype=jnp.float32)),
        atol=ATOL)


@pytest.mark.parametrize("causal,window,block_k,tkv", [
    (False, None, 512, 12), (True, None, 5, 12), (True, 4, 5, 12),
    (True, None, 8, 12), (False, None, 5, 12)])
def test_blockwise_attention(causal, window, block_k, tkv):
    q, k, v = _qkv(3, hq=4, hkv=2, tkv=tkv)
    want = jatt.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    block_k=block_k, window=window)
    got = tatt.blockwise_attention(to_torch(q), to_torch(k), to_torch(v),
                                   causal=causal, block_k=block_k,
                                   window=window)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 5)])
def test_attention_reference(causal, window):
    q, k, v = _qkv(4)
    want = jatt.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window)
    got = tatt.attention_reference(to_torch(q), to_torch(k), to_torch(v),
                                   causal=causal, window=window)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=ATOL)


def test_window_validation():
    q, k, v = (to_torch(a) for a in _qkv(5))
    with pytest.raises(ValueError, match="window"):
        tatt.partial_attention(q, k, v, causal=True, window=0)
    with pytest.raises(ValueError, match="causal"):
        tatt.blockwise_attention(q, k, v, window=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_codes_equal(dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 9, 16), np.float32) * 3.0
    x[0, 1, 4] = 0.0  # an all-zero vector: scale 0, codes 0
    # Values on the rounding boundary: x / scale lands on k + 0.5.
    x[1, 2, 3] = np.arange(16, dtype=np.float32) - 7.5
    jx = jnp.asarray(x, dtype)
    jcodes, jscale = jq.quantize_kv(jx)
    tcodes, tscale = tq.quantize_kv(to_torch(np.asarray(jx)))
    np.testing.assert_array_equal(to_numpy(tcodes), np.asarray(jcodes))
    np.testing.assert_allclose(to_numpy(tscale), np.asarray(jscale),
                               rtol=1e-6)
    np.testing.assert_allclose(
        to_numpy(tq.dequantize_kv(tcodes, tscale, torch.float32)),
        np.asarray(jq.dequantize_kv(jcodes, jscale, jnp.float32)), rtol=1e-6)


def test_quantize_weight_and_params_codes_equal():
    rng = np.random.default_rng(7)
    layers = {n: rng.standard_normal((2, 8, 12), np.float32)
              for n in jq._MATMUL_LEAVES}
    layers["attn_norm"] = np.ones((2, 8), np.float32)
    params = {"embed": rng.standard_normal((20, 8), np.float32),
              "layers": layers, "final_norm": np.ones((8,), np.float32),
              "lm_head": rng.standard_normal((8, 20), np.float32)}
    jparams = {k: ({n: jnp.asarray(a) for n, a in v.items()}
                   if isinstance(v, dict) else jnp.asarray(v))
               for k, v in params.items()}
    tparams = {k: ({n: to_torch(a) for n, a in v.items()}
                   if isinstance(v, dict) else to_torch(v))
               for k, v in params.items()}
    jout, tout = jq.quantize_params(jparams), tq.quantize_params(tparams)
    for name in jq._MATMUL_LEAVES:
        np.testing.assert_array_equal(to_numpy(tout["layers"][name]["q"]),
                                      np.asarray(jout["layers"][name]["q"]))
        np.testing.assert_allclose(to_numpy(tout["layers"][name]["s"]),
                                   np.asarray(jout["layers"][name]["s"]),
                                   rtol=1e-6)
    np.testing.assert_array_equal(to_numpy(tout["lm_head"]["q"]),
                                  np.asarray(jout["lm_head"]["q"]))
    assert tout["layers"]["attn_norm"] is tparams["layers"]["attn_norm"]
    assert tout["embed"] is tparams["embed"]
    with pytest.raises(NotImplementedError):
        tq.quantize_params({"layers": {"moe": {}}})
