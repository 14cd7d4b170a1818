"""The port's int8 matmul (starway_tpu_torch.ops.gemv) against the JAX
package's Pallas GEMV kernel in interpret mode, with a ragged F and
M > 8 (the port tiles M), and the port's ``matmul_w`` dispatch against
JAX's on raw and quantized weights.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel is held against that version on the card (tests/test_torch_cuda.py).
Tolerances: float32 rtol 1e-5 / atol 1e-5 (summation order), bfloat16
atol 2e-2."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from starway_tpu.models.llama import matmul_w as jax_matmul_w
from starway_tpu.ops.pallas_gemv import int8_matmul as jax_int8_matmul
from starway_tpu.ops.quantize import quantize_weight as jax_quantize_weight
from starway_tpu_torch.models.llama import matmul_w
from starway_tpu_torch.ops.gemv import int8_matmul, int8_matmul_reference
from torch_port_util import to_numpy, to_torch


def _operands(seed, m, d, f, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((m, d), np.float32), dtype)
    w = jax_quantize_weight(
        jnp.asarray(rng.standard_normal((d, f), np.float32) * d ** -0.5))
    return x, w


@pytest.mark.parametrize("m,d,f", [(1, 64, 128), (13, 96, 200),
                                   (8, 128, 333), (40, 32, 1000)])
def test_int8_matmul_matches_jax_kernel(m, d, f):
    x, w = _operands(0, m, d, f)
    want = jax_int8_matmul(x, w["q"], w["s"], interpret=True)
    got = int8_matmul(to_torch(x), to_torch(w["q"]), to_torch(w["s"]))
    assert got.shape == (m, f)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_int8_matmul_bf16_matches_jax_kernel():
    x, w = _operands(1, 12, 64, 200, "bfloat16")
    want = jax_int8_matmul(x, w["q"], w["s"], interpret=True)
    got = int8_matmul(to_torch(x), to_torch(w["q"]), to_torch(w["s"]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               atol=2e-2)


def test_int8_matmul_cpu_is_plain_and_validates():
    x, w = _operands(2, 3, 32, 48)
    tx, tqw, ts = to_torch(x), to_torch(w["q"]), to_torch(w["s"])
    before = int8_matmul.launches
    torch.testing.assert_close(int8_matmul(tx, tqw, ts),
                               int8_matmul_reference(tx, tqw, ts))
    assert int8_matmul.launches == before
    with pytest.raises(ValueError, match="int8"):
        int8_matmul(tx, tqw.float(), ts)
    with pytest.raises(ValueError, match="scale"):
        int8_matmul(tx, tqw, ts[:-1])


@pytest.mark.parametrize("quantized", [False, True])
def test_matmul_w_matches_jax(quantized):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 5, 32), np.float32))
    w = jnp.asarray(rng.standard_normal((32, 24), np.float32))
    if quantized:
        jw = jax_quantize_weight(w)
        tw = {"q": to_torch(jw["q"]), "s": to_torch(jw["s"])}
    else:
        jw, tw = w, to_torch(w)
    np.testing.assert_allclose(to_numpy(matmul_w(to_torch(x), tw)),
                               np.asarray(jax_matmul_w(x, jw)), rtol=1e-5,
                               atol=1e-5)
