"""Ulysses attention (starway_tpu_torch.parallel.ulysses) against the JAX
package's on its 4-device CPU mesh, on the same numpy inputs, float32.

The twins of tests/test_parallel_extra.py:21-114: outputs (causal and
not) and gradients within 1e-5 of the JAX function's, the sliding band,
the narrow grouped kv across the all-to-all and the pre-expanded fallback
when ``n_kv_heads`` does not split over the axis; and Ulysses as the
``attn_fn`` of a sharded tree's training step, against the unsharded
one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from starway_tpu.parallel import make_mesh as jax_mesh
from starway_tpu.parallel.sharding import shard_array
from starway_tpu.parallel.ulysses import (
    make_ulysses_attention as jax_ulysses)
from starway_tpu_torch.models import llama as tl
from starway_tpu_torch.parallel import (make_mesh, make_ulysses_attention,
                                        shard_tree)
from torch_port_util import to_numpy

ATOL = 1e-5
CASES = {  # (B, Hq, Hkv, S, D, causal, window)
    "causal": (2, 8, 4, 128, 32, True, None),
    "full": (2, 8, 4, 128, 32, False, None),
    "window": (1, 8, 4, 64, 16, True, 24),
    "gqa-expanded": (2, 8, 2, 128, 32, True, None),
}


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32)
            for h in (hq, hkv, hkv))


@pytest.mark.parametrize("case", sorted(CASES))
def test_ulysses_matches_jax(case):
    """Output and the gradients of ``sum(out * w)`` against the JAX
    function's (its ``shard_map`` over {"sp": 4})."""
    b, hq, hkv, s, d, causal, window = CASES[case]
    q, k, v = _qkv(sorted(CASES).index(case), b, hq, hkv, s, d)
    w = np.random.default_rng(1).standard_normal((b, hq, s, d)).astype(
        np.float32)
    jm = jax_mesh({"sp": 4})
    jul = jax_ulysses(jm, "sp", causal=causal, window=window)
    args = [shard_array(jm, jnp.asarray(x), None, None, "sp", None)
            for x in (q, k, v)]
    jout = jul(*args)
    jg = jax.grad(lambda *a: (jul(*a) * w).sum(), argnums=(0, 1, 2))(*args)
    tul = make_ulysses_attention(make_mesh({"sp": 4}, device="cpu"), "sp",
                                 causal=causal, window=window)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tul(*leaves)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to_numpy(out), np.asarray(jout), atol=ATOL)
    for leaf, g in zip(leaves, jg):
        np.testing.assert_allclose(to_numpy(leaf.grad), np.asarray(g),
                                   atol=ATOL)
    if window is not None:
        assert tul.handles_window and tul.window == window
        with pytest.raises(ValueError, match="causal"):
            make_ulysses_attention(make_mesh({"sp": 4}, device="cpu"),
                                   causal=False, window=window)


def test_ulysses_trains_a_sharded_tree():
    """Ulysses over sp = 4 as the attention of a training step on a tree
    sharded over {"dp": 2, "sp": 4}: the loss and gradients of the
    unsharded step."""
    cfg = tl.LlamaConfig.preset("debug", n_layers=1)
    params = tl.init_params(cfg, 0, device="cpu")
    batch = torch.as_tensor(np.random.default_rng(2).integers(
        0, 512, (4, 33))).long()
    mesh = make_mesh({"dp": 2, "sp": 4}, device="cpu")
    sh = shard_tree(params, mesh, _replicated(params))
    want_l, want_g = tl.value_and_grad(params, batch, cfg)
    got_l, got_g = tl.value_and_grad(sh, batch, cfg,
                                     make_ulysses_attention(mesh, "sp"))
    assert abs(float(got_l) - float(want_l)) < ATOL
    for name in ("wq", "wk", "wo", "w_down"):
        np.testing.assert_allclose(
            to_numpy(got_g["layers"][name].full()),
            to_numpy(want_g["layers"][name]), atol=ATOL)


def _replicated(params):
    from starway_tpu_torch.parallel import P

    if isinstance(params, dict):
        return {k: _replicated(v) for k, v in params.items()}
    return P()
