"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode): each carries the ``cuda`` marker and skips without a card.  Run them
on a GPU machine with

    STARWAY_TEST_REAL_TPU=1 python -m pytest -m cuda tests/test_torch_cuda.py

(the variable keeps tests/conftest.py from importing jax, which the GPU
machine need not have).  Tolerances: float32 outputs 1e-5 (the kernels sum
in another order than the plain versions), bfloat16 outputs 2e-2 (one
bfloat16 rounding of O(1) values); gradients 1e-4 of max |grad| in
float32 and 1e-2 (one bfloat16 ulp) in bfloat16, as they sum up to S
products.  TF32 is off for the comparisons.
"""

import numpy as np
import pytest
import torch

from starway_tpu_torch.models import (LlamaConfig, SlotServer, generate,
                                      init_params)
from starway_tpu_torch.ops.decode import (decode_attention,
                                          decode_attention_reference)
from starway_tpu_torch.ops.flash import (flash_backward,
                                         flash_backward_dkv, flash_backward_dq,
                                         flash_backward_reference,
                                         flash_forward, flash_forward_reference)
from starway_tpu_torch.ops.gemv import int8_matmul, int8_matmul_reference
from starway_tpu_torch.ops.quantize import quantize_kv

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("n_q,window,d", [(1, None, 128), (3, None, 32),
                                          (1, 5, 128), (4, 40, 64),
                                          (2, None, 16), (1, 70, 256)])
def test_decode_kernel_matches_plain(dev, dtype, quant, n_q, window, d):
    rng = np.random.default_rng(0)
    b, hq, hkv, t = 3, 8, 2, 200
    q = _randn(rng, (b, hq, n_q, d), dtype, dev)
    k = _randn(rng, (b, hkv, t, d), dtype, dev)
    v = _randn(rng, (b, hkv, t, d), dtype, dev)
    pos = torch.tensor([0, 77, t - n_q], dtype=torch.int32, device=dev)
    kw = dict(window=window)
    if quant:
        k, kw["k_scale"] = quantize_kv(k)
        v, kw["v_scale"] = quantize_kv(v)
    before = decode_attention.launches
    got = decode_attention(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_reference(q, k, v, pos, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,s,d", [
    (True, None, 100, 128), (False, None, 70, 64), (True, 17, 150, 16),
    (True, None, 256, 32)])
def test_flash_kernel_matches_plain(dev, dtype, causal, window, s, d):
    rng = np.random.default_rng(1)
    q = _randn(rng, (2, 4, s, d), dtype, dev)
    k = _randn(rng, (2, 2, s, d), dtype, dev)
    v = _randn(rng, (2, 2, s, d), dtype, dev)
    o, lse = flash_forward(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_forward_reference(q, k, v, causal=causal,
                                             window=window)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,f", [(1, 64, 128), (8, 200, 1000),
                                   (40, 96, 333), (130, 256, 520),
                                   (3, 300, 4096), (70, 160, 1024)])
def test_int8_matmul_kernel_matches_plain(dev, dtype, m, d, f):
    rng = np.random.default_rng(2)
    x = _randn(rng, (m, d), dtype, dev)
    wq = torch.from_numpy(rng.integers(-127, 128, (d, f), dtype=np.int8)).to(dev)
    scale = torch.from_numpy(
        rng.uniform(0.5, 1.5, f).astype(np.float32) / (127 * d ** 0.5)).to(dev)
    got = int8_matmul(x, wq, scale)
    torch.cuda.synchronize()
    want = int8_matmul_reference(x, wq, scale)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=1e-5)


@pytest.mark.parametrize("kv_quant,w8", [("none", False), ("int8", False),
                                         ("int8", True)])
def test_slot_server_on_cuda_matches_generate(dev, kv_quant, w8):
    """The serving path on the card: every request's greedy tokens equal
    its standalone generate() run (float32, debug widths), and the decode
    and flash kernels (and, for a W8A16 tree, the GEMV kernel) ran."""
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.ops.quantize import quantize_params

    cfg = LlamaConfig.preset("debug", kv_quant=kv_quant)
    params = init_params(cfg, 0, device=dev)
    if w8:
        params = quantize_params(params)
    rng = np.random.default_rng(3)
    reqs = [(list(rng.integers(1, cfg.vocab_size, n)), m)
            for n, m in [(3, 6), (7, 4), (12, 9), (5, 1), (2, 11)]]
    reset_launch_counts()
    srv = SlotServer(params, cfg, n_slots=2, max_len=64, chunk=4)
    rids = [srv.submit(p, m) for p, m in reqs]
    done = srv.run()
    counts = launch_counts()
    assert counts["decode_attention"] > 0 and counts["flash_forward"] > 0
    assert (counts["int8_matmul"] > 0) == w8
    for rid, (prompt, max_new) in zip(rids, reqs):
        out = generate(params, cfg, torch.tensor([prompt]), max_new)
        np.testing.assert_array_equal(done[rid],
                                      out[0, len(prompt):].cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,s,d,hq,hkv", [
    (True, None, 100, 128, 4, 2), (False, None, 70, 64, 4, 4),
    (True, 17, 150, 16, 8, 2), (True, None, 256, 32, 4, 1),
    (True, 40, 130, 128, 4, 2), (False, None, 64, 64, 2, 2)])
def test_flash_backward_kernels_match_plain(dev, dtype, causal, window, s, d,
                                            hq, hkv):
    """Both backward passes against flash_backward_reference: causal and
    not, windows, uneven S, GQA 4:1 and 1:1, every compiled head size;
    each pass launches once."""
    rng = np.random.default_rng(4)
    q = _randn(rng, (2, hq, s, d), dtype, dev)
    k = _randn(rng, (2, hkv, s, d), dtype, dev)
    v = _randn(rng, (2, hkv, s, d), dtype, dev)
    do = _randn(rng, (2, hq, s, d), dtype, dev)
    o, lse = flash_forward(q, k, v, causal=causal, window=window)
    before = (flash_backward_dkv.launches, flash_backward_dq.launches)
    got = flash_backward(q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_backward_dkv.launches, flash_backward_dq.launches) == (
        before[0] + 1, before[1] + 1)
    want = flash_backward_reference(q, k, v, o, lse, do, causal=causal,
                                    window=window)
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=rel * w.float().abs().max().item())


@pytest.mark.parametrize("policy", [None, "dots"])
def test_train_step_on_cuda_matches_plain_attention(dev, policy):
    """One value_and_grad step on the card through the flash kernels
    against the same step through the plain attention (float32, debug
    widths): loss rtol 1e-5, every gradient leaf within 1e-4 of its max;
    the forward and each backward pass launch once per layer."""
    from starway_tpu_torch.models import llama
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.ops.attention import blockwise_attention
    from starway_tpu_torch.utils.tree import tree_leaves

    cfg = LlamaConfig.preset("debug", remat=policy is not None,
                             remat_policy=policy)
    params = init_params(cfg, 0, device=dev)
    batch = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 130))).to(dev)
    reset_launch_counts()
    loss, grads = llama.value_and_grad(params, batch, cfg)
    counts = launch_counts()
    for name in ("flash_forward", "flash_backward_dkv", "flash_backward_dq"):
        assert counts[name] == cfg.n_layers, counts

    def plain(q, k, v):
        return blockwise_attention(q, k, v, causal=True)

    want_loss, want = llama.value_and_grad(params, batch, cfg, plain)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * w.abs().max().item())
