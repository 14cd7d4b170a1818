"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode): each carries the ``cuda`` marker and skips without a card.  Run them
on a GPU machine with

    STARWAY_TEST_REAL_TPU=1 python -m pytest -m cuda tests/test_torch_cuda.py

(the variable keeps tests/conftest.py from importing jax, which the GPU
machine need not have).  Tolerances: float32 outputs 1e-5 (the kernels sum
in another order than the plain versions), bfloat16 outputs 2e-2 (one
bfloat16 rounding of O(1) values; the int8 GEMV's, which reach ~6, each
within max(2e-2, 2 bf16 ulps of |want|)); gradients 1e-4 of max |grad| in
float32 and 1e-2 (one bfloat16 ulp) in bfloat16, as they sum up to S
products.  TF32 is off for the comparisons.
"""

import numpy as np
import pytest
import torch

from starway_tpu_torch.models import (LlamaConfig, PagedSlotServer,
                                      SlotServer, generate, init_params)
from starway_tpu_torch.ops.decode import (decode_attention,
                                          decode_attention_reference,
                                          tma_plan, tma_route)
from starway_tpu_torch.ops.paged import (paged_decode_attention,
                                         paged_decode_attention_reference)
from starway_tpu_torch.ops import flash as flash_ops
from starway_tpu_torch.ops.attention import NEG_BIG, scaled_tolerance_share
from starway_tpu_torch.ops.flash import (flash_backward,
                                         flash_backward_dkv, flash_backward_dq,
                                         flash_backward_reference,
                                         flash_forward, flash_forward_reference,
                                         flash_partial, flash_partial_bwd,
                                         flash_partial_bwd_reference,
                                         flash_partial_reference)
from starway_tpu_torch.ops.gemv import (gemv_plan, int8_matmul,
                                        int8_matmul_reference,
                                        int8_matmul_split_reference,
                                        launch_plan, tolerance_share)
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


def _assert_attention_close(got, want, dtype):
    """float32 to TOL; bf16 to a limit scaled to the output, as the outputs
    over thousands of keys are ~ TOL's bf16 value in size."""
    if dtype == torch.bfloat16:
        assert scaled_tolerance_share(got, want) <= 1.0
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=0)


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=dev, dtype=dtype)


# (n_q, window, d, hq, hkv, t, pos): small heads at every compiled head
# size; then the main path's heads (Hq 32, Hkv 8, D 128) at C = 1 (a decode
# step), 4 (a chunk verify) and 128 (a suffix ingest), with and without a
# window.  Row 0 sits at the cache's start, so its one live tile leaves
# most of the planned splits (up to 16 over T) with no tile: those must
# merge as identities.
DECODE_CASES = [(1, None, 128, 8, 2, 200, (0, 77, 199)),
                (3, None, 32, 8, 2, 200, (0, 77, 197)),
                (1, 5, 128, 8, 2, 200, (0, 77, 199)),
                (4, 40, 64, 8, 2, 200, (0, 77, 196)),
                (2, None, 16, 8, 2, 200, (0, 77, 198)),
                (1, 70, 256, 8, 2, 200, (0, 77, 199)),
                (1, None, 128, 32, 8, 2048, (0, 1000, 2047)),
                (4, None, 128, 32, 8, 2048, (0, 1000, 2044)),
                (128, None, 128, 32, 8, 2048, (0, 1000, 1920)),
                (1, 512, 128, 32, 8, 2048, (3, 1000, 2047)),
                (4, 100, 128, 32, 8, 2048, (3, 1000, 2044)),
                (128, 300, 128, 32, 8, 2048, (3, 1000, 1920))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("n_q,window,d,hq,hkv,t,pos", DECODE_CASES)
def test_decode_kernel_matches_plain(dev, dtype, quant, n_q, window, d, hq,
                                     hkv, t, pos):
    rng = np.random.default_rng(0)
    b = len(pos)
    q = _randn(rng, (b, hq, n_q, d), dtype, dev)
    k = _randn(rng, (b, hkv, t, d), dtype, dev)
    v = _randn(rng, (b, hkv, t, d), dtype, dev)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
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


def test_decode_kernel_takes_int_and_broadcast_pos(dev):
    """pos as an int (no device tensor) and as a one-element tensor read
    by every row (stride 0) gives the [B] tensor's result."""
    rng = np.random.default_rng(2)
    q = _randn(rng, (3, 32, 1, 128), torch.bfloat16, dev)
    k, v = (_randn(rng, (3, 8, 1024, 128), torch.bfloat16, dev)
            for _ in range(2))
    want = decode_attention(q, k, v, torch.full((3,), 700, dtype=torch.int32,
                                                device=dev))
    for pos in (700, torch.tensor([700], dtype=torch.int32, device=dev)):
        assert torch.equal(decode_attention(q, k, v, pos), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("n_q", [128, 512])
def test_decode_kernel_row_tiles_match_plain(dev, dtype, quant, n_q):
    """A suffix ingest's n_rep * C query rows (512 and 2048 at n_rep=4,
    D=128) run as tiles of the grid's row axis."""
    rng = np.random.default_rng(6)
    b, hq, hkv, t, d = 2, 8, 2, 1100, 128
    q = _randn(rng, (b, hq, n_q, d), dtype, dev)
    k = _randn(rng, (b, hkv, t, d), dtype, dev)
    v = _randn(rng, (b, hkv, t, d), dtype, dev)
    pos = torch.tensor([0, t - n_q - 37], dtype=torch.int32, device=dev)
    kw = {}
    if quant:
        k, kw["k_scale"] = quantize_kv(k)
        v, kw["v_scale"] = quantize_kv(v)
    got = decode_attention(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    want = decode_attention_reference(q, k, v, pos, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_kernel_on_a_circular_cache(dev, dtype, quant):
    """Rolling decode's call: a cache of W = 4096 slots at the main path's
    heads, positions past the window clamped to W - 1 on the device, no
    window mask; a row still filling (pos < W) masks its cold slots."""
    rng = np.random.default_rng(9)
    w, hq, hkv, d = 4096, 32, 8, 128
    q = _randn(rng, (3, hq, 1, d), dtype, dev)
    k = _randn(rng, (3, hkv, w, d), dtype, dev)
    v = _randn(rng, (3, hkv, w, d), dtype, dev)
    kw = {}
    if quant:
        k, kw["k_scale"] = quantize_kv(k)
        v, kw["v_scale"] = quantize_kv(v)
    pos = torch.tensor([w + 3, 5 * w + 1, 700], dtype=torch.int32,
                       device=dev).clamp(max=w - 1)
    got = decode_attention(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    want = decode_attention_reference(q, k, v, pos, **kw)
    _assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q", [4, 5])
def test_decode_kernel_windowed_chunk_verify(dev, dtype, n_q):
    """The speculative verify of a windowed model at the main path's heads:
    C = 4 (16 rows, the decode regime) and C = 5 (20 rows, the ingest
    regime), window 4096 over a 6200-slot cache."""
    from starway_tpu_torch.ops.decode import decode_plan

    assert decode_plan(3, 8, 4 * n_q, 6200)[0] == (
        "decode" if n_q == 4 else "ingest")
    rng = np.random.default_rng(10)
    q = _randn(rng, (3, 32, n_q, 128), dtype, dev)
    k = _randn(rng, (3, 8, 6200, 128), dtype, dev)
    v = _randn(rng, (3, 8, 6200, 128), dtype, dev)
    pos = torch.tensor([0, 4000, 6200 - n_q], dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, pos, window=4096)
    torch.cuda.synchronize()
    want = decode_attention_reference(q, k, v, pos, window=4096)
    _assert_attention_close(got, want, dtype)


def _paged_case(rng, dtype, dev, page, n_q, hq, hkv, pos):
    """q, pools and a scrambled table whose entries past each cursor are far
    out of the pool (a read of one would fault), as device tensors."""
    b, d, max_pages = len(pos), 128, 2048 // page
    n_pages = b * max_pages + 3
    pos = np.asarray(pos, np.int32)
    table = rng.permutation(n_pages)[:b * max_pages].reshape(b, max_pages)
    table = table.astype(np.int32)
    for i, p in enumerate(pos):
        table[i, (p + n_q - 1) // page + 1:] = 2 ** 30 + i
    q = _randn(rng, (b, hq, n_q, d), dtype, dev)
    kp = _randn(rng, (n_pages, hkv, page, d), dtype, dev)
    vp = _randn(rng, (n_pages, hkv, page, d), dtype, dev)
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.from_numpy(pos).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 64, 128])
@pytest.mark.parametrize("n_q", [1, 4, 128])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (32, 8)])
def test_paged_kernel_matches_plain(dev, dtype, page, n_q, hq, hkv):
    """Scrambled tables whose entries past each cursor are far out of the
    pool, cursors on and off page edges; small heads and the main path's
    (Hq 32, Hkv 8) at C = 1, 4 and 128.  Slot 0's cursor sits in its
    first page, so most of its planned splits get no tile."""
    rng = np.random.default_rng(7)
    q, kp, vp, table, pos = _paged_case(rng, dtype, dev, page, n_q, hq, hkv,
                                        [page - 1, 1000, 2048 - n_q])
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = paged_decode_attention_reference(q, kp, vp, table, pos)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("kernel,n_q", [("dense", 1), ("dense", 4),
                                        ("dense", 128), ("int8", 1),
                                        ("int8", 128), ("paged", 1),
                                        ("paged", 128), ("dense-wide", 1),
                                        ("int8-wide", 4)])
def test_decode_kernels_bf16_are_deterministic(dev, kernel, n_q):
    """Two bf16 calls of the dense (bf16 or int8 cache) or the paged
    kernel at the main path's heads give identical bits: the splits'
    partials are merged in split order, the warps' in warp order; "-wide":
    one row of 8 q / 2 kv heads over T = 8192, split past one cluster
    (ops/decode.py tma_plan: 64 blocks over T)."""
    rng = np.random.default_rng(15)
    wide = kernel.endswith("-wide")
    b, hq, hkv, t = (1, 8, 2, 8192) if wide else (3, 32, 8, 2048)
    pos = [t - n_q] if wide else [5, 1000, 2048 - n_q]
    if kernel == "paged":
        args = _paged_case(rng, torch.bfloat16, dev, 64, n_q, 32, 8, pos)
        call = lambda: paged_decode_attention(*args)  # noqa: E731
    else:
        if wide:
            assert tma_plan(b, hkv, t, _sms(dev)) > 16
        q = _randn(rng, (b, hq, n_q, 128), torch.bfloat16, dev)
        k, v = (_randn(rng, (b, hkv, t, 128), torch.bfloat16, dev)
                for _ in range(2))
        kw = {}
        if kernel.startswith("int8"):
            k, kw["k_scale"] = quantize_kv(k)
            v, kw["v_scale"] = quantize_kv(v)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        call = lambda: decode_attention(q, k, v, p, **kw)  # noqa: E731
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


# (d, n_q, window, shape, circular): the TMA kernel's route (bf16 q, n_rep *
# C <= 16 rows, D 64 and 128) at B x Hkv = 2 (one row of 8 q / 2 kv heads
# over T = 8192: 64 blocks over T, past one cluster) and 64 (8 rows of the
# main path's 32 / 8 heads over T = 2048: 4 blocks over T), C = 1 and 4,
# with and without a window, and on a circular cache (T = W = 4096, pos
# clamped to W - 1, no window).
TMA_SHAPES = {"b1": (1, 8, 2, 8192), "b8": (8, 32, 8, 2048),
              "ring": (3, 32, 8, 4096)}
TMA_CASES = [(d, n_q, window, shape, False)
             for d in (64, 128) for n_q in (1, 4)
             for window, shape in ((None, "b1"), (700, "b1"), (None, "b8"),
                                   (300, "b8"))] + [
    (d, n_q, None, "ring", True) for d in (64, 128) for n_q in (1, 4)]


def _tma_case(rng, d, n_q, shape, circular, dev):
    b, hq, hkv, t = TMA_SHAPES[shape]
    q = _randn(rng, (b, hq, n_q, d), torch.bfloat16, dev)
    k = _randn(rng, (b, hkv, t, d), torch.bfloat16, dev)
    v = _randn(rng, (b, hkv, t, d), torch.bfloat16, dev)
    if circular:
        pos = torch.tensor([t + 3, 5 * t + 1, 700], dtype=torch.int32,
                           device=dev).clamp(max=t - n_q)
    else:
        pos = torch.from_numpy(rng.integers(0, t - n_q + 1, b).astype(
            np.int32)).to(dev)
        pos[0] = t - n_q  # one row sees the whole cache
    return q, k, v, pos


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d,n_q,window,shape,circular", TMA_CASES)
def test_decode_tma_kernel_matches_plain(dev, quant, d, n_q, window, shape,
                                         circular):
    """csrc/decode_tma.cu against the plain version at the scaled limit
    phase 3 holds it to (ops/attention.py SCALED_TOL), bf16 and int8
    caches; each call is one launch, counted in tma_launches."""
    rng = np.random.default_rng(21)
    q, k, v, pos = _tma_case(rng, d, n_q, shape, circular, dev)
    b, hkv = k.shape[:2]
    assert tma_route(True, q.shape[1] // hkv * n_q, d)
    kw = dict(window=window)
    if quant:
        k, kw["k_scale"] = quantize_kv(k)
        v, kw["v_scale"] = quantize_kv(v)
    before = (decode_attention.launches, decode_attention.tma_launches)
    got = decode_attention(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert (decode_attention.launches,
            decode_attention.tma_launches) == (before[0] + 1, before[1] + 1)
    want = decode_attention_reference(q, k, v, pos, **kw)
    assert scaled_tolerance_share(got, want) <= 1.0


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d,n_q,window,shape", [(128, 1, None, "b1"),
                                                (128, 4, 700, "b1"),
                                                (64, 1, 300, "b8"),
                                                (128, 4, None, "b8")])
def test_decode_tma_kernel_ignores_dead_rows(dev, quant, d, n_q, window,
                                             shape):
    """Every cache row past a row's live keys and below its window holds
    NaN (k, v and the int8 scales): the result is finite and equals the
    plain version on the same cache with those rows zeroed, which the
    function does not read."""
    rng = np.random.default_rng(22)
    q, k, v, pos = _tma_case(rng, d, n_q, shape, False, dev)
    kw = dict(window=window)
    if quant:
        k, kw["k_scale"] = quantize_kv(k)
        v, kw["v_scale"] = quantize_kv(v)
    t = k.shape[2]
    kp = torch.arange(t, device=dev)[None, :]
    hi = pos[:, None].long() + n_q - 1
    dead = kp > hi
    if window is not None:
        dead |= kp <= pos[:, None].long() - window
    dead = dead[:, None, :].expand(k.shape[:3])
    clean = [x.clone() for x in (k, v)]
    if quant:
        for x in clean:
            x[dead] = 0
        scales = {n: s.masked_fill(dead, 0.0) for n, s in kw.items()
                  if n != "window"}
        for n in scales:
            kw[n].masked_fill_(dead, float("nan"))
        want = decode_attention_reference(q, *clean, pos, window=window,
                                          **scales)
    else:
        for x in clean:
            x[dead] = 0
        for x in (k, v):
            x[dead] = float("nan")
        want = decode_attention_reference(q, *clean, pos, window=window)
    got = decode_attention(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert scaled_tolerance_share(got, want) <= 1.0


# (b, hq, hkv, s, skv, d, causal, window): small shapes in both dtypes,
# every compiled head size; then bf16 at the main paths' heads (Hq 32, Hkv
# 8, D 128): S ragged over several tiles and S = 2048 at B = 2, a window
# of 40 that leaves rows 103-127 of q tile 1 with no key in its first live
# kv tile (their p must stay exactly 0 until a later tile), and
# non-causal Skv longer and shorter than S.
FLASH_CASES = [(2, 4, 2, 100, 100, 128, True, None),
               (2, 4, 2, 70, 70, 64, False, None),
               (2, 4, 2, 150, 150, 16, True, 17),
               (2, 4, 2, 256, 256, 32, True, None)]
FLASH_MAIN_PATH = [(2, 32, 8, 1000, 1000, 128, True, None),
                   (2, 32, 8, 2048, 2048, 128, True, None),
                   (1, 32, 8, 1000, 1000, 128, True, 40),
                   (2, 32, 8, 300, 700, 128, False, None),
                   (1, 8, 2, 700, 130, 64, False, None)]


def _q_tilings(dtype, d):
    """The q-tile heights to hold beside the planned one: bf16 runs the
    heights ops/flash.py q_heights gives (64 rows on the wgmma kernel at
    head sizes 64 and 128; 64 or 128 on mma.sync at 32, as fwd_q_rows
    plans them; 64 at 16), so each is held at every shape (launched
    directly); float32 has the FMA loop's one, which the wrapper's call
    holds."""
    if dtype != torch.bfloat16:
        return ()
    return flash_ops.q_heights(d)


def _misalign(t):
    """A copy of ``t`` whose base is 8 bytes off the 16-byte grid (TMA
    refuses it): the GEMV routes it to the mma.sync kernel, the flash
    wrappers refuse it."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    off = 8 // t.element_size()
    if flat.data_ptr() % 16:
        off += 8 // t.element_size()
    out = flat[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 8
    return out


@pytest.mark.parametrize(
    "dtype,b,hq,hkv,s,skv,d,causal,window",
    [(dt, *c) for dt in (torch.float32, torch.bfloat16) for c in FLASH_CASES]
    + [(torch.bfloat16, *c) for c in FLASH_MAIN_PATH])
def test_flash_kernel_matches_plain(dev, dtype, b, hq, hkv, s, skv, d,
                                    causal, window):
    """The forward against flash_forward_reference (bf16 inputs on the
    tensor-core kernels as planned and at both q-tile heights, float32 on
    the FMA loop); one launch a call of the wrapper,
    on the wgmma kernel exactly when fwd_route says so (bf16 at D 64 or
    128).  A q off the 16-byte grid is refused before any launch."""
    rng = np.random.default_rng(1)
    q = _randn(rng, (b, hq, s, d), dtype, dev)
    k = _randn(rng, (b, hkv, skv, d), dtype, dev)
    v = _randn(rng, (b, hkv, skv, d), dtype, dev)
    o_ref, lse_ref = flash_forward_reference(q, k, v, causal=causal,
                                             window=window)
    before = flash_forward.launches
    before_w = flash_forward.wgmma_launches
    outs = [flash_forward(q, k, v, causal=causal, window=window)]
    torch.cuda.synchronize()
    assert flash_forward.launches == before + 1
    wgmma = dtype == torch.bfloat16 and d in flash_ops.WGMMA_HEAD_DIMS
    assert flash_forward.wgmma_launches == before_w + wgmma
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_forward(_misalign(q), k, v, causal=causal, window=window)
    assert flash_forward.launches == before + 1
    outs += [flash_ops._launch_forward(q, k, v, rows, causal, d ** -0.5,
                                       window)
             for rows in _q_tilings(dtype, d)]
    for o, lse in outs:
        torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL[dtype],
                                   rtol=0)
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)


def _gemv_operands(seed, m, d, f, dtype, dev):
    rng = np.random.default_rng(seed)
    x = _randn(rng, (m, d), dtype, dev)
    wq = torch.from_numpy(rng.integers(-127, 128, (d, f), dtype=np.int8)).to(dev)
    scale = torch.from_numpy(
        rng.uniform(0.5, 1.5, f).astype(np.float32) / (127 * d ** 0.5)).to(dev)
    return x, wq, scale


# Both sides of the decode/prefill crossover (M = 32 | 33), split and
# unsplit D, 128- and 256-column prefill tiles (the last case takes 256),
# ragged M, D and F, and element-load paths: F % 16 != 0 (1000, 333, 520,
# 4001), D % 8 != 0 (300, 12) and D % 4 != 0 (201).  The bf16 prefill
# cases whose rows TMA takes (D % 8 == 0, F % 16 == 0) run the wgmma
# kernel, ragged M, D and the last 256-column tile included; the rest
# the mma.sync kernel, and so does every case with ``misaligned`` x.
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,f", [(1, 64, 128), (8, 200, 1000),
                                   (40, 96, 333), (130, 256, 520),
                                   (3, 300, 4096), (70, 160, 1024),
                                   (32, 2048, 640), (33, 2048, 640),
                                   (16, 1024, 256), (17, 512, 384),
                                   (24, 201, 160), (64, 12, 4096),
                                   (65, 1000, 2048), (300, 520, 1040),
                                   (1030, 520, 4001), (100, 200, 4000),
                                   (33, 64, 272)])
def test_int8_matmul_kernel_matches_plain(dev, dtype, m, d, f, misaligned):
    x, wq, scale = _gemv_operands(2, m, d, f, dtype, dev)
    if misaligned:
        x = _misalign(x)
    before = int8_matmul.wgmma_launches
    got = int8_matmul(x, wq, scale)
    torch.cuda.synchronize()
    wgmma = (dtype == torch.bfloat16 and m > 32 and d % 8 == 0
             and f % 16 == 0 and not misaligned)
    assert int8_matmul.wgmma_launches == before + wgmma
    want = int8_matmul_reference(x, wq, scale)
    assert_gemv_close(got, want)


def assert_gemv_close(got, want):
    """float32: 1e-5 (summation order).  bfloat16: each element within
    max(2e-2, 2 bf16 ulps of |want|), ulp_bf16(v) = 2^(floor(log2 v) - 7):
    the kernel and the plain version each round one float32 sum taken in
    another order, and outputs above 4 have ulps above 2e-2
    (ops/gemv.py tolerance_share)."""
    share = tolerance_share(got, want)
    assert share <= 1, f"worst element at {share:.3f} of its tolerance"


@pytest.mark.parametrize("m", [8, 64, 512])
@pytest.mark.parametrize("d,f", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096), (4096, 128256),
                                 (4096, 2048), (2048, 4096), (4096, 512),
                                 (2048, 1024), (4096, 7168), (7168, 4096),
                                 (2048, 14336), (14336, 2048),
                                 (4096, 64128), (2048, 128256)])
def test_int8_matmul_main_path_shapes(dev, m, d, f):
    """llama3-8b's projections and lm_head, whole and at the tp halves of
    F and of D, at decode M=8 and prefill M=64 and 512, bf16: the regime
    gemv_plan picks launches (the prefill regime on the wgmma kernel, as
    ops/gemv.py launch_plan plans it), and the result matches the plain
    version and the split sum in the kernel's order."""
    x, wq, scale = _gemv_operands(4, m, d, f, torch.bfloat16, dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    regime, splits = gemv_plan(m, d, f, n_sms)
    assert regime == ("decode" if m == 8 else "prefill")
    plan = launch_plan(m, d, f, n_sms, static=True)
    assert plan[1] == (4 if regime == "prefill" else 3)
    before = dict(int8_matmul.regime_launches)
    before_w = int8_matmul.wgmma_launches
    got = int8_matmul(x, wq, scale, static_weight=True)
    torch.cuda.synchronize()
    assert int8_matmul.regime_launches[regime] == before[regime] + 1
    assert int8_matmul.wgmma_launches == before_w + (regime == "prefill")
    assert_gemv_close(got, int8_matmul_reference(x, wq, scale))
    assert_gemv_close(got, int8_matmul_split_reference(
        x, wq, scale, plan[-1]))


@pytest.mark.parametrize("m,d,f", [(8, 4096, 4096), (8, 4096, 128256),
                                   (24, 14336, 1024), (512, 4096, 4096),
                                   (96, 1024, 2000), (2048, 4096, 1024),
                                   (512, 4096, 14336), (512, 4096, 1024),
                                   (64, 14336, 2048)])
def test_int8_matmul_bf16_is_deterministic(dev, m, d, f):
    """Two bf16 calls on the same inputs give identical bits in both
    regimes, split or not: no atomics, partials summed in split order."""
    x, wq, scale = _gemv_operands(5, m, d, f, torch.bfloat16, dev)
    first = int8_matmul(x, wq, scale)
    second = int8_matmul(x, wq, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("m,d,f", [(8, 4096, 1024), (24, 2048, 640),
                                   (8, 4096, 4096), (16, 4096, 4096)])
def test_int8_matmul_reads_x_after_the_kernel_ahead(dev, m, d, f):
    """An early (programmatic dependent) launch starts before the kernel
    ahead of it ends: each call here takes an x that the elementwise
    kernel just before it wrote, and must see all of it.  All but the
    last shape launch early on the H100."""
    x, wq, scale = _gemv_operands(6, m, d, f, torch.bfloat16, dev)
    xs, outs = [], []
    for _ in range(30):
        x = x * 1.01
        xs.append(x)
        outs.append(int8_matmul(x, wq, scale))
    torch.cuda.synchronize()
    for x, got in zip(xs, outs):
        assert_gemv_close(got, int8_matmul_reference(x, wq, scale))


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


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_rolling_server_and_decoders_on_cuda(dev, kv_quant):
    """The rolling SlotServer, the speculative decoders and beam search on
    the card (float32, debug widths, window 8): the server's tokens equal
    a single-request loop over its primitives (prefill_rolling over the
    admission widths, rolling decode_step, argmax), and speculative,
    lookup and beams=1 equal generate() on the card."""
    from starway_tpu_torch.models import (generate_beam, generate_lookup,
                                          generate_speculative)
    from starway_tpu_torch.models.generate import decode_step
    from starway_tpu_torch.models.llama import rope_tables
    from starway_tpu_torch.models.serving import _rolling_prefill_state

    cfg = LlamaConfig.preset("debug", sliding_window=8, kv_quant=kv_quant)
    params = init_params(cfg, 0, device=dev)
    rope = rope_tables(64, cfg.head_dim, cfg.rope_theta, device=dev)
    rng = np.random.default_rng(4)
    reqs = [(list(rng.integers(1, cfg.vocab_size, n)), m)
            for n, m in [(3, 6), (11, 4), (20, 9), (8, 5)]]
    srv = SlotServer(params, cfg, n_slots=2, max_len=64, chunk=4)
    rids = [srv.submit(t, m) for t, m in reqs]
    done = srv.run()
    for rid, (prompt, max_new) in zip(rids, reqs):
        logits, cache = _rolling_prefill_state(params, cfg, prompt)
        toks = [int(logits.argmax(-1)[0])]
        while len(toks) < max_new:
            pos = torch.tensor([len(prompt) + len(toks) - 1], device=dev)
            logits, cache = decode_step(params, cache,
                                        torch.tensor([toks[-1]], device=dev),
                                        pos, cfg, rope, rolling=True)
            toks.append(int(logits.argmax(-1)[0]))
        np.testing.assert_array_equal(done[rid], toks)
    prompt = torch.tensor(rng.integers(1, cfg.vocab_size, (2, 12)))
    want = generate(params, cfg, prompt, 10)
    assert want.device.type == "cuda"
    for got in (generate_speculative(params, cfg, params, cfg, prompt, 10,
                                     gamma=4),
                generate_lookup(params, cfg, prompt, 10, gamma=5),
                generate_beam(params, cfg, prompt, 10, beams=1)):
        assert torch.equal(got, want)


def test_paged_and_prefix_servers_on_cuda_match_generate(dev):
    """Paged serving with and without a shared prefix, and the dense
    server's prefix caching, on the card: greedy tokens equal generate()'s
    (float32, debug widths); the paged kernel runs every decode step."""
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = LlamaConfig.preset("debug")
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(8)
    prefix = list(rng.integers(1, cfg.vocab_size, 37))
    reqs = [(list(rng.integers(1, cfg.vocab_size, n)), m, w)
            for n, m, w in [(3, 6, True), (7, 4, False), (12, 9, True),
                            (50, 5, False), (2, 11, True)]]
    for make in (lambda: PagedSlotServer(params, cfg, n_slots=2, max_len=128,
                                         page=16, n_pages=20, chunk=4),
                 lambda: SlotServer(params, cfg, n_slots=2, max_len=128,
                                    chunk=4)):
        srv = make()
        reset_launch_counts()
        pid = srv.register_prefix(prefix)
        rids = [srv.submit(p, m, prefix=pid if w else None)
                for p, m, w in reqs]
        done = srv.run()
        counts = launch_counts()
        paged = isinstance(srv, PagedSlotServer)
        assert (counts["paged_decode_attention"] > 0) == paged, counts
        assert (counts["decode_attention"] > 0) != paged, counts
        for rid, (p, m, w) in zip(rids, reqs):
            full = (prefix if w else []) + p
            out = generate(params, cfg, torch.tensor([full]), m)
            np.testing.assert_array_equal(done[rid],
                                          out[0, len(full):].cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,causal,window,s,d,hq,hkv", [
    (2, True, None, 100, 128, 4, 2), (2, False, None, 70, 64, 4, 4),
    (2, True, 17, 150, 16, 8, 2), (2, True, None, 256, 32, 4, 1),
    (2, True, 40, 130, 128, 4, 2), (2, False, None, 64, 64, 2, 2),
    (1, True, None, 1000, 128, 8, 8), (1, True, None, 1000, 128, 8, 2),
    (1, True, None, 1000, 128, 8, 1), (1, True, None, 2048, 128, 8, 8),
    (1, True, None, 2048, 128, 8, 2), (1, True, None, 2048, 128, 8, 1),
    (1, True, 100, 1000, 128, 8, 2), (1, True, 33, 200, 64, 8, 2),
    (1, True, None, 1000, 64, 8, 1), (2, False, None, 130, 64, 8, 2)])
def test_flash_backward_kernels_match_plain(dev, dtype, b, causal, window, s,
                                            d, hq, hkv):
    """Both backward passes against flash_backward_reference: causal and
    not, windows (one ending inside a tile), uneven S, GQA 8:1, 4:1, 2:1
    and 1:1, every compiled head size, grids small enough that pass A
    splits its query heads (ops/flash.py dkv_splits) and the training
    shapes' per-sequence length; each pass launches once, on the wgmma
    kernels exactly when bwd_route says so (bf16 at D 64 or 128)."""
    rng = np.random.default_rng(4)
    q = _randn(rng, (b, hq, s, d), dtype, dev)
    k = _randn(rng, (b, hkv, s, d), dtype, dev)
    v = _randn(rng, (b, hkv, s, d), dtype, dev)
    do = _randn(rng, (b, hq, s, d), dtype, dev)
    o, lse = flash_forward(q, k, v, causal=causal, window=window)
    before = (flash_backward_dkv.launches, flash_backward_dq.launches,
              flash_backward_dkv.wgmma_launches,
              flash_backward_dq.wgmma_launches)
    got = flash_backward(q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    wgmma = int(flash_ops.bwd_route(dtype == torch.bfloat16, d) == "wgmma")
    assert (flash_backward_dkv.launches, flash_backward_dq.launches,
            flash_backward_dkv.wgmma_launches,
            flash_backward_dq.wgmma_launches) == (
        before[0] + 1, before[1] + 1, before[2] + wgmma, before[3] + wgmma)
    want = flash_backward_reference(q, k, v, o, lse, do, causal=causal,
                                    window=window)
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=rel * w.float().abs().max().item())


@pytest.mark.parametrize("b,s,hq,hkv,d", [(2, 2048, 32, 8, 128),
                                          (1, 1000, 8, 2, 128),
                                          (1, 1024, 32, 8, 64)])
def test_flash_backward_bf16_is_deterministic(dev, b, s, hq, hkv, d):
    """Two bf16 backward calls on the same inputs give identical bits: no
    atomics, and a split pass A sums its partials in a fixed order (the
    second and third shapes split, the first does not); the wgmma
    kernels at both of their head sizes."""
    rng = np.random.default_rng(13)
    q, do = (_randn(rng, (b, hq, s, d), torch.bfloat16, dev)
             for _ in range(2))
    k, v = (_randn(rng, (b, hkv, s, d), torch.bfloat16, dev)
            for _ in range(2))
    o, lse = flash_forward(q, k, v, causal=True)
    before = flash_backward_dkv.wgmma_launches
    first = flash_backward(q, k, v, o, lse, do, causal=True)
    second = flash_backward(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert flash_backward_dkv.wgmma_launches == before + 2
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("kernel", ["forward", "partial"])
def test_flash_forward_bf16_is_deterministic(dev, kernel, d):
    """Two bf16 calls of the forward (B=2, S=2048, causal) or of the ring
    step's partial (a past block and a diagonal one, T=1024) on the same
    inputs give identical bits: each row's sums are taken in a fixed
    order (the wgmma kernel at both of its head sizes)."""
    rng = np.random.default_rng(14)
    b, s = (2, 2048) if kernel == "forward" else (1, 1024)
    q = _randn(rng, (b, 32, s, d), torch.bfloat16, dev)
    k, v = (_randn(rng, (b, 8, s, d), torch.bfloat16, dev)
            for _ in range(2))
    if kernel == "forward":
        calls = [lambda: flash_forward(q, k, v, causal=True)]
    else:
        calls = [lambda off=off: flash_partial(q, k, v, 1024, off)
                 for off in (0, 1024)]
    for call in calls:
        first, second = call(), call()
        torch.cuda.synchronize()
        for a, b_ in zip(first, second):
            assert torch.equal(a, b_)


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


# Ring steps: (q_offset, kv_offset, window, causal) at T = Tkv = 130 (a
# ragged last tile): a whole past block, the diagonal, a dead block whose
# last live tile index (q_off + q0 + 63 - kv_off) / 64 is negative, a
# dead block just past the diagonal, a band edge, rows 0..63 dead and the
# rest partly live, and an unmasked pair.
RING_STEPS = [(130, 0, None, True), (130, 130, None, True),
              (0, 300, None, True), (0, 130, None, True),
              (130, 0, 70, True), (0, 64, None, True),
              (0, 130, None, False)]


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 32),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128)])
@pytest.mark.parametrize("q_off,kv_off,window,causal", RING_STEPS)
def test_flash_partial_kernel_matches_plain(dev, dtype, d, q_off, kv_off,
                                            window, causal):
    """The ring step's partial against flash_partial_reference, GQA 4:1:
    o / l to the output tolerance, m and l to float32 summation order, and
    rows that see no key exactly the identity (o = 0, m = NEG_BIG, l = 0);
    one launch a call of the wrapper, bf16 on the wgmma kernel at head
    sizes 64 and 128 (on mma.sync at 32).  bf16 as planned and at both
    q-tile heights, and also at the main paths' head size."""
    rng = np.random.default_rng(9)
    t = 130
    q = _randn(rng, (2, 8, t, d), dtype, dev)
    k = _randn(rng, (2, 2, t, d), dtype, dev)
    v = _randn(rng, (2, 2, t, d), dtype, dev)
    kw = dict(causal=causal, window=window)
    o_r, m_r, l_r = flash_partial_reference(q, k, v, q_off, kv_off, **kw)
    dead = l_r == 0
    live = ~dead
    before = flash_partial.launches
    before_w = flash_partial.wgmma_launches
    outs = [flash_partial(q, k, v, q_off, kv_off, **kw)]
    torch.cuda.synchronize()
    assert flash_partial.launches == before + 1
    assert flash_partial.wgmma_launches == before_w + (
        dtype == torch.bfloat16 and d in flash_ops.WGMMA_HEAD_DIMS)
    outs += [flash_ops._launch_partial(q, k, v, q_off, kv_off, rows, causal,
                                       d ** -0.5, window)
             for rows in _q_tilings(dtype, d)]
    for o, m, l in outs:
        assert o.dtype == m.dtype == l.dtype == torch.float32
        assert (o[dead] == 0).all() and (l[dead] == 0).all()
        assert (m[dead] == NEG_BIG).all()
        torch.testing.assert_close(m[live], m_r[live], atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(l[live], l_r[live], atol=0, rtol=1e-4)
        torch.testing.assert_close(
            (o / l.clamp(min=1e-30)[..., None])[live],
            (o_r / l_r.clamp(min=1e-30)[..., None])[live], atol=TOL[dtype],
            rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_off,kv_off,window,causal", RING_STEPS)
@pytest.mark.parametrize("d", [64, 128])
def test_flash_partial_bwd_kernels_match_plain(dev, dtype, q_off, kv_off,
                                               window, causal, d):
    """The ring step's gradients in float32 against the plain step, from
    lse and delta of the whole attention; dead steps give exact zeros.
    One count on flash_partial_bwd and none on the plain backward's
    wrappers.  The grid (3 kv tiles x 4 kv heads) is small enough that
    pass A splits its query heads, as at the ring's shards."""
    rng = np.random.default_rng(10)
    t = 130
    q, do = (_randn(rng, (2, 8, t, d), dtype, dev) for _ in range(2))
    k, v = (_randn(rng, (2, 2, t, d), dtype, dev) for _ in range(2))
    lse = torch.from_numpy(rng.uniform(3.0, 5.0, (2, 8, t)).astype(
        np.float32)).to(dev)
    delta = _randn(rng, (2, 8, t), torch.float32, dev)
    kw = dict(causal=causal, window=window)
    before = (flash_partial_bwd.launches, flash_backward_dkv.launches,
              flash_backward_dq.launches)
    before_w = flash_partial_bwd.wgmma_launches
    got = flash_partial_bwd(q, do, k, v, lse, delta, q_off, kv_off, **kw)
    torch.cuda.synchronize()
    assert (flash_partial_bwd.launches, flash_backward_dkv.launches,
            flash_backward_dq.launches) == (before[0] + 1, *before[1:])
    want = flash_partial_bwd_reference(q, do, k, v, lse, delta, q_off,
                                       kv_off, **kw)
    assert flash_partial_bwd.wgmma_launches == before_w + (
        flash_ops.bwd_route(dtype == torch.bfloat16, d) == "wgmma")
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        scale = w.abs().max().item()
        if scale == 0:
            assert (g == 0).all()
            continue
        torch.testing.assert_close(g, w, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 32),
                                     (torch.bfloat16, 32),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128)])
def test_flash_backward_keeps_the_input_dtype(dev, dtype, d):
    """The plain backward's passes write the input dtype after the ring
    step's float32 outputs were added to the same kernels (the wgmma
    kernels' bf16 and float32 epilogues at D 64 and 128)."""
    rng = np.random.default_rng(11)
    q, do = (_randn(rng, (1, 4, 96, d), dtype, dev) for _ in range(2))
    k, v = (_randn(rng, (1, 2, 96, d), dtype, dev) for _ in range(2))
    o, lse = flash_forward(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(dim=-1)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, causal=True,
                                sm_scale=d ** -0.5)
    dq = flash_backward_dq(q, k, v, do, lse, delta, causal=True,
                           sm_scale=d ** -0.5)
    f32 = flash_partial_bwd(q, do, k, v, lse, delta, 0, 0, causal=True)
    torch.cuda.synchronize()
    for g, w in zip((dq, dk, dv), f32):
        assert g.dtype == dtype and w.dtype == torch.float32
        torch.testing.assert_close(g.float(), w.to(dtype).float(), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_backward_delta_kernel_matches_plain(dev, dtype, d):
    """The delta kernel (rowsum(dO * O), float32) against its plain
    version at every head size and both types, rows not a multiple of a
    block's; one launch a call; bit-for-bit repeatable."""
    rng = np.random.default_rng(17)
    o, do = (_randn(rng, (2, 5, 77, d), dtype, dev) for _ in range(2))
    before = flash_ops.flash_backward_delta.launches
    got = flash_ops.flash_backward_delta(o, do)
    again = flash_ops.flash_backward_delta(o, do)
    want = flash_ops.flash_backward_delta_reference(o, do)
    torch.cuda.synchronize()
    assert flash_ops.flash_backward_delta.launches == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_refuses_a_misaligned_base(dev, d):
    """A q, k, v or dO off the 16-byte grid (TMA refuses its tensor map)
    is refused by each backward wrapper with a ValueError before any
    launch; lse and delta, which the kernels read by plain loads (a row of
    a ragged S starts anywhere), are taken off the grid and give the
    aligned call's bits."""
    rng = np.random.default_rng(15)
    q, do = (_randn(rng, (1, 8, 130, d), torch.bfloat16, dev)
             for _ in range(2))
    k, v = (_randn(rng, (1, 2, 130, d), torch.bfloat16, dev)
            for _ in range(2))
    lse = torch.from_numpy(rng.uniform(3.0, 5.0, (1, 8, 130)).astype(
        np.float32)).to(dev)
    delta = _randn(rng, (1, 8, 130), torch.float32, dev)
    kw = dict(causal=True, sm_scale=d ** -0.5)
    calls = {
        "dkv": lambda *a: flash_backward_dkv(*a, **kw),
        "dq": lambda *a: flash_backward_dq(*a, **kw),
        "partial": lambda q_, k_, v_, do_, l_, dl_: flash_partial_bwd(
            q_, do_, k_, v_, l_, dl_, 0, 0, **kw)}
    counts = (flash_backward_dkv.launches, flash_backward_dq.launches,
              flash_partial_bwd.launches)
    args = [q, k, v, do, lse, delta]
    for name, call in calls.items():
        for i in range(4):
            bad = list(args)
            bad[i] = _misalign(args[i])
            with pytest.raises(ValueError, match="16-byte aligned"):
                call(*bad)
    assert counts == (flash_backward_dkv.launches, flash_backward_dq.launches,
                      flash_partial_bwd.launches)
    for name, call in calls.items():
        want = call(*args)
        got = call(q, k, v, do, _misalign(lse), _misalign(delta))
        torch.cuda.synchronize()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), name


@pytest.mark.parametrize("layout,window", [("ring", None), ("zigzag", None),
                                           ("ring", 90)])
def test_ring_attention_on_cuda_matches_cpu(dev, layout, window):
    """Ring attention through the kernels on the card against the same
    ring through the plain steps on the CPU (float32, sp = 4, GQA 2):
    output 1e-5, gradients 1e-4 of max |grad|; n^2 (zigzag 2 n^2 + n)
    partial launches forward and backward when no band skips a step."""
    from starway_tpu_torch.parallel import (make_mesh, make_ring_attention,
                                            make_zigzag_ring_attention)

    rng = np.random.default_rng(12)
    q, vd = (rng.standard_normal((2, 4, 512, 64), np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((2, 2, 512, 64), np.float32)
            for _ in range(2))
    res, launched = {}, {}
    for where in (dev, torch.device("cpu")):
        mesh = make_mesh({"sp": 4}, device=where)
        fn = (make_ring_attention(mesh, window=window) if layout == "ring"
              else make_zigzag_ring_attention(mesh))
        leaves = [torch.from_numpy(x).to(where).requires_grad_()
                  for x in (q, k, v)]
        before = (flash_partial.launches, flash_partial_bwd.launches)
        out = fn(*leaves)
        (out * torch.from_numpy(vd).to(where)).sum().backward()
        launched[where.type] = (flash_partial.launches - before[0],
                                flash_partial_bwd.launches - before[1])
        res[where.type] = [out.detach().cpu()] + [x.grad.cpu()
                                                  for x in leaves]
    assert launched["cpu"] == (0, 0)
    if window is None:
        n = 16 if layout == "ring" else 36
        assert launched["cuda"] == (n, n)
    for g, w in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * w.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,swiglu", [(1, False), (2, True)])
def test_switch_moe_on_cuda_matches_cpu(dev, dtype, k, swiglu):
    """The MoE FFN on the card against the same call on the CPU: equal
    routing (experts and slots), y within 1e-5 (float32) or 2e-2 of max
    |y| (bfloat16: one rounding of the expert outputs)."""
    from starway_tpu_torch.models import moe

    g = torch.Generator().manual_seed(5)
    e, d, f = 8, 128, 256
    x = torch.randn(2, 64, d, generator=g).to(dtype)
    w = moe.init_moe_params(g, 1, e, d, f, dtype, swiglu=swiglu)
    w = {n: t[0] for n, t in w.items()}
    res = {}
    for where in (dev, torch.device("cpu")):
        args = {n: t.to(where) for n, t in w.items()}
        y, aux, st = moe.switch_moe(
            x.to(where), args["router"], args["w_in"], args["w_out"],
            capacity_factor=float(e), k=k, with_stats=True,
            w_gate=args.get("w_gate"))
        route = moe._route(x.to(where).reshape(-1, d), args["router"], k)[0]
        res[where.type] = (y.cpu().float(), aux.cpu(), st, route.cpu())
    (yg, ag, sg, rg), (yc, ac, sc, rc) = res["cuda"], res["cpu"]
    assert torch.equal(rg, rc)
    assert float(sg["drop_fraction"]) == 0.0
    torch.testing.assert_close(sg["expert_load"].cpu(), sc["expert_load"])
    tol = TOL[dtype] * (yc.abs().max().item() if dtype == torch.bfloat16
                        else 1.0)
    torch.testing.assert_close(yg, yc, rtol=0, atol=tol)
    torch.testing.assert_close(ag, ac, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decode_step_on_cuda_matches_cpu(dev, dtype):
    """One MoE decode step (after a prefill) on the card against the CPU
    run on the same weights: logits within 1e-4 (float32: the kernels sum
    in another order) or 5e-2 of max |logit| (bfloat16, as chip_smoke.py's
    LOGIT_REL_TOL); the decode kernel launches once a layer."""
    from starway_tpu_torch.models import decode_step, prefill
    from starway_tpu_torch.models.llama import cfg_rope_tables
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.utils.tree import tree_map

    cfg = LlamaConfig.preset("debug", n_experts=4, moe_top_k=2,
                             moe_swiglu=True, moe_capacity_factor=4.0,
                             dtype=dtype)
    cpu = init_params(cfg, 3, device="cpu")
    prompt = torch.tensor(np.random.default_rng(6).integers(1, 512, (2, 9)))
    res = {}
    for where in (dev, torch.device("cpu")):
        params = tree_map(lambda t: t.to(where), cpu)
        logits, cache = prefill(params, cfg, prompt.to(where), 16)
        tok = logits.argmax(-1)
        reset_launch_counts()
        out, _ = decode_step(params, cache, tok, 9, cfg,
                             cfg_rope_tables(cfg, 16, device=where))
        res[where.type] = (out.cpu(), launch_counts()["decode_attention"])
    (got, n_cuda), (want, n_cpu) = res["cuda"], res["cpu"]
    assert (n_cuda, n_cpu) == (cfg.n_layers, 0)
    scale = 1.0 if dtype == "float32" else 5e-2 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 if dtype == "float32" else scale)


def test_moe_servers_on_cuda_match_generate(dev):
    """A dropless MoE model on the card (float32, debug widths): the dense
    and paged servers' greedy tokens equal generate()'s, and the decode,
    paged and flash kernels ran."""
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = LlamaConfig.preset("debug", n_experts=4, moe_top_k=2,
                             moe_swiglu=True, moe_capacity_factor=4.0)
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(7)
    reqs = [(list(rng.integers(1, cfg.vocab_size, n)), m)
            for n, m in [(3, 6), (12, 4), (7, 9)]]
    reset_launch_counts()
    for srv in (SlotServer(params, cfg, n_slots=2, max_len=64, chunk=4),
                PagedSlotServer(params, cfg, n_slots=2, max_len=64, page=16,
                                chunk=4)):
        rids = [srv.submit(p, m) for p, m in reqs]
        done = srv.run()
        for rid, (prompt, max_new) in zip(rids, reqs):
            out = generate(params, cfg, torch.tensor([prompt]), max_new)
            np.testing.assert_array_equal(
                done[rid], out[0, len(prompt):].cpu().numpy())
    counts = launch_counts()
    assert all(counts[name] > 0 for name in (
        "decode_attention", "paged_decode_attention", "flash_forward"))


# ------------------------------------------- the mesh paths' shard shapes

# llama3-8b's heads over tp = 2 (16 q, 4 kv heads), dp's halved batch, and
# Ulysses' 8 q and 2 kv heads a slot over the whole sequence.
SHARD_HEADS = [(1, 16, 4, 512), (1, 8, 2, 1024)]


@pytest.mark.parametrize("b,hq,hkv,s", SHARD_HEADS)
def test_flash_kernels_at_shard_shapes(dev, b, hq, hkv, s):
    """The flash forward and backward at the heads a tp or Ulysses slot
    runs, bf16, against their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn(b, h, s, 128, generator=gen, device=dev)
                   .bfloat16() for h in (hq, hkv, hkv, hq))
    o, lse = flash_forward(q, k, v, causal=True)
    o_r, _ = flash_forward_reference(q, k, v, causal=True)
    _assert_attention_close(o, o_r, torch.bfloat16)
    for g, w in zip(flash_backward(q, k, v, o, lse, do, causal=True),
                    flash_backward_reference(q, k, v, o, lse, do,
                                             causal=True)):
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err <= 1e-2


@pytest.mark.parametrize("quant", [False, True])
def test_decode_kernel_at_tp_heads(dev, quant):
    """The decode kernel at a tp slot's 16 q / 4 kv heads, C = 1 and 4."""
    gen = torch.Generator(device=dev).manual_seed(8)
    kc, vc = (torch.randn(4, 4, 1024, 128, generator=gen, device=dev)
              .bfloat16() for _ in range(2))
    kw = {}
    if quant:
        (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
        kw = dict(k_scale=ks, v_scale=vs)
    pos = torch.tensor([100, 500, 900, 1000], dtype=torch.int32, device=dev)
    for c in (1, 4):
        q = torch.randn(4, 16, c, 128, generator=gen, device=dev).bfloat16()
        got = decode_attention(q, kc, vc, pos, **kw)
        want = decode_attention_reference(q, kc, vc, pos, **kw)
        assert (got.float() - want.float()).abs().max() <= TOL[torch.bfloat16]


@pytest.mark.parametrize("d,f", [(4096, 7168), (2048, 4096), (4096, 64128)])
def test_gemv_at_tp_widths(dev, d, f):
    """The int8 GEMV at the tp widths of llama3-8b: gate/up, a row-parallel
    wo, the vocab-split lm_head; decode and prefill rows."""
    from starway_tpu_torch.ops.quantize import quantize_weight

    gen = torch.Generator(device=dev).manual_seed(9)
    w = quantize_weight(torch.randn(d, f, generator=gen, device=dev)
                        .bfloat16() * 0.02)
    for m in (8, 64):
        x = torch.randn(m, d, generator=gen, device=dev).bfloat16()
        assert tolerance_share(int8_matmul(x, w["q"], w["s"]),
                               int8_matmul_reference(x, w["q"],
                                                     w["s"])) <= 1


def test_tp_server_on_cuda_matches_unsharded(dev):
    """A float32 tree over {"tp": 2} on the card: the SlotServer's tokens
    equal the unsharded generate()'s, each slot's kernels at its heads."""
    from starway_tpu_torch.models import param_specs
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.parallel import make_mesh, shard_tree

    cfg = LlamaConfig.preset("debug")
    params = init_params(cfg, 0, device=dev)
    sharded = shard_tree(params, make_mesh({"tp": 2}, device=dev),
                         param_specs(cfg))
    reqs = [([3, 1, 4, 1, 5], 6), ([2, 7, 1, 8], 5)]
    reset_launch_counts()
    srv = SlotServer(sharded, cfg, n_slots=2, max_len=64, chunk=4)
    rids = [srv.submit(p, m) for p, m in reqs]
    done = srv.run()
    assert launch_counts()["decode_attention"] > 0
    for rid, (p, m) in zip(rids, reqs):
        want = generate(params, cfg, torch.tensor([p], device=dev), m)
        np.testing.assert_array_equal(done[rid],
                                      want[0, len(p):].cpu().numpy())


def test_sharded_train_step_on_cuda_matches_cpu(dev):
    """One loss and gradient over dp x tp x sp = 2 x 2 x 2 on the card
    (ring-step kernels at tp's heads) against the same step on the CPU."""
    from starway_tpu_torch.models import param_specs
    from starway_tpu_torch.models.llama import (make_sharded_attn,
                                                value_and_grad)
    from starway_tpu_torch.parallel import make_mesh, shard_tree

    cfg = LlamaConfig.preset("debug", n_layers=1)
    params = init_params(cfg, 0, device="cpu")
    batch = torch.randint(0, 512, (2, 65), generator=torch.Generator()
                          .manual_seed(3))
    out = {}
    for where in ("cpu", "cuda"):
        mesh = make_mesh({"dp": 2, "tp": 2, "sp": 2}, device=where)
        tree = shard_tree(params, mesh, param_specs(cfg))
        out[where] = value_and_grad(tree, batch.to(where), cfg,
                                    make_sharded_attn(mesh))
    assert abs(out["cpu"][0].item() - out["cuda"][0].item()) < 1e-4
    for name in ("wq", "wo", "w_down"):
        a = out["cpu"][1]["layers"][name].full()
        b = out["cuda"][1]["layers"][name].full().cpu()
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()
