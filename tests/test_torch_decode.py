"""The port's decode_attention (starway_tpu_torch.ops.decode) against the
JAX package's Pallas decode kernel run in interpret mode, both schedules
(stream=True and False), on the same numpy inputs.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is held against that version on the card
(tests/test_torch_cuda.py).  Tolerances: float32 atol 1e-5 (summation
order), bfloat16 atol 2e-2 (one bfloat16 rounding of O(1) outputs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from starway_tpu.ops.pallas_decode import decode_attention as jax_decode
from starway_tpu.ops.quantize import quantize_kv as jax_quantize_kv
from starway_tpu_torch.ops.decode import (decode_attention,
                                          decode_attention_reference)
from torch_port_util import to_numpy, to_torch

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, HQ, HKV, T, D = 3, 8, 2, 40, 16


def _inputs(seed, n_q, dtype, quant):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((B, HQ, n_q, D), np.float32), dtype)
    k = jnp.asarray(rng.standard_normal((B, HKV, T, D), np.float32), dtype)
    v = jnp.asarray(rng.standard_normal((B, HKV, T, D), np.float32), dtype)
    kw = {}
    if quant:
        k, kw["k_scale"] = jax_quantize_kv(k)
        v, kw["v_scale"] = jax_quantize_kv(v)
    return q, k, v, kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("n_q,window,quant,per_row", [
    (1, None, False, True),
    (1, None, False, False),
    (3, None, False, True),
    (1, 7, False, True),
    (3, 5, True, True),
    (1, None, True, False),
])
def test_decode_matches_jax_kernel(dtype, stream, n_q, window, quant,
                                   per_row):
    q, k, v, kw = _inputs(0, n_q, dtype, quant)
    pos = (np.asarray([0, 17, T - n_q], np.int32) if per_row
           else np.int32(21))
    want = jax_decode(q, k, v, jnp.asarray(pos), interpret=True,
                      stream=stream, block_k=16, window=window, **kw)
    tkw = {name: to_torch(a) for name, a in kw.items()}
    got = decode_attention(to_torch(q), to_torch(k), to_torch(v),
                           torch.as_tensor(pos), stream=stream,
                           window=window, **tkw)
    assert got.dtype == to_torch(q).dtype and got.shape == (B, HQ, n_q, D)
    np.testing.assert_allclose(to_numpy(got),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)


def test_decode_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the wrapper launches nothing: it is the plain version
    and leaves the launch count alone."""
    q, k, v, _ = _inputs(1, 1, "float32", False)
    before = decode_attention.launches
    args = (to_torch(q), to_torch(k), to_torch(v), 9)
    torch.testing.assert_close(decode_attention(*args),
                               decode_attention_reference(*args))
    assert decode_attention.launches == before


def test_decode_validation():
    q, k, v, kw = _inputs(2, 1, "float32", True)
    tq_, tk, tv = to_torch(q), to_torch(k), to_torch(v)
    with pytest.raises(ValueError, match="BOTH"):
        decode_attention(tq_, tk, tv, 0, k_scale=to_torch(kw["k_scale"]))
    with pytest.raises(ValueError, match="inconsistent"):
        decode_attention(tq_, tk, tv, 0)
    with pytest.raises(ValueError, match="window"):
        decode_attention(tq_, tk.float(), tv.float(), 0, window=0)
    with pytest.raises(ValueError, match="pos"):
        decode_attention(tq_, tk.float(), tv.float(), torch.tensor([1, 2]))
