"""The port's int8 matmul (starway_tpu_torch.ops.gemv) against the JAX
package's Pallas GEMV kernel in interpret mode, with a ragged F and
M > 8 (the port tiles M), and the port's ``matmul_w`` dispatch against
JAX's on raw and quantized weights; the kernels' plan (regime and split of
D) at the serving path's shapes, and the split's order of summation.

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
from starway_tpu_torch.ops import gemv as tgemv
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


# llama3-8b's projections (wq/wo, wk/wv, gate/up, down) and lm_head.
PROJ = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
LM_HEAD = (4096, 128256)


@pytest.mark.parametrize("n_sms", [132, 114])
@pytest.mark.parametrize("m", [8, 64, 128, 256, 512, 1024, 2048])
def test_gemv_plan_on_the_main_paths_shapes(n_sms, m):
    """The serving step's M = 8 runs the decode regime, every prefill
    bucket (64-2048) the prefill regime.  The split of D leaves no chunk
    empty, covers D, and stays within one cluster (16 blocks at decode, 8
    at prefill).  Decode: about 2 blocks an SM (the weight stream needs
    the bytes in flight) unless the cluster is full.  Prefill: a power of
    two up to 4 that keeps the grid within one wave (a block an SM) and
    doubles no further, or, past 4, as many splits of 128-column blocks
    (two an SM) as fill CLUSTER_FILL of their slots."""
    shapes = PROJ + [LM_HEAD] if m == 8 else PROJ
    for d, f in shapes:
        regime, splits = tgemv.gemv_plan(m, d, f, n_sms)
        assert regime == ("decode" if m == 8 else "prefill")
        chunk = tgemv.split_chunk(d, regime, splits)
        assert chunk % tgemv.SPLIT_UNIT[regime] == 0
        assert -(-d // chunk) == splits
        cap = tgemv.MAX_SPLITS[regime]
        assert 1 <= splits <= cap
        tiles = tgemv._tiles(regime, m, f, n_sms)
        blocks = tiles * splits
        if regime == "decode":
            assert blocks >= 0.9 * 2 * n_sms or splits == cap, (d, f, blocks)
            if tiles >= 2 * n_sms:
                assert splits == 1  # a full grid is not split
        else:
            narrow = tgemv.prefill_tile(m, f, n_sms)[1] == 128
            fill = int(tgemv.CLUSTER_FILL * 2 * n_sms)
            if splits > 4:  # 128-column blocks, two an SM, as many as fit
                assert narrow and blocks <= fill
                assert splits == cap or blocks + tiles > fill, (d, f, splits)
            else:  # a power of two within one wave, doubling no further
                assert splits & (splits - 1) == 0
                assert splits == 1 or blocks <= n_sms
                assert 2 * blocks > n_sms or (
                    splits == 4 and not (narrow and 5 * tiles <= fill)
                ), (d, f, splits)
    assert tgemv.gemv_plan(8, *LM_HEAD, n_sms) == ("decode", 1)


def test_gemv_plan_at_measured_shapes():
    """The plans the H100 measurements chose (132 SMs, ops/gemv_sweep.py):
    decode splits at M=8; prefill one wave, split 2 ways where the grid is
    half the card, 7 or 8 ways on small grids of 128-column blocks (32
    tiles in clusters of 8 would ask for 256 of the 264 slots)."""
    plan = tgemv.gemv_plan
    assert plan(8, 4096, 4096, 132) == ("decode", 9)
    assert plan(8, 4096, 1024, 132) == ("decode", 16)
    assert plan(8, 4096, 14336, 132) == ("decode", 3)
    assert plan(512, 4096, 4096, 132) == ("prefill", 2)
    assert plan(512, 4096, 1024, 132) == ("prefill", 7)
    assert plan(128, 4096, 4096, 132) == ("prefill", 7)
    assert plan(128, 14336, 4096, 132) == ("prefill", 7)
    assert plan(512, 4096, 14336, 132) == ("prefill", 1)
    assert plan(512, 14336, 4096, 132) == ("prefill", 2)
    assert plan(1024, 4096, 4096, 132) == ("prefill", 1)
    assert plan(2048, 4096, 1024, 132) == ("prefill", 2)
    assert plan(128, 4096, 1024, 132) == ("prefill", 8)
    assert plan(1024, 4096, 1024, 132) == ("prefill", 2)
    # 128-column tiles where the 256-column grid is under a quarter of
    # the card (wk/wv at M=1024: 63.4 us against 78.7 at 256, 2 splits).
    assert tgemv.prefill_tile(64, 4096, 132) == (64, 128)
    assert tgemv.prefill_tile(512, 1024, 132) == (128, 128)
    assert tgemv.prefill_tile(1024, 1024, 132) == (128, 128)
    assert tgemv.prefill_tile(512, 4096, 132) == (128, 256)
    assert tgemv.prefill_tile(2048, 1024, 132) == (128, 256)


@pytest.mark.parametrize("n_sms", [132, 114])
@pytest.mark.parametrize("m", [8, 16, 32, 512])
def test_early_launch_only_for_one_wave_decode_grids(n_sms, m):
    """The decode kernel goes out as an early (programmatic dependent)
    launch, code 3, at M up to 8 and for grids of at most one block an
    SM; any other bf16 grid with code 1 (decode) or 2 (prefill).  On 132
    SMs that is every decode shape of the path at M=8, and llama3-8b's
    wk/wv (8 column tiles x 16 splits) alone at M = 16 and 32."""
    for d, f in PROJ + [LM_HEAD]:
        regime, splits = tgemv.gemv_plan(m, d, f, n_sms)
        blocks = tgemv._tiles(regime, m, f, n_sms) * splits
        early = tgemv.early_launch(regime, m, f, splits, n_sms)
        assert early == (regime == "decode" and (m <= 8 or blocks <= n_sms))
        if n_sms == 132 and m <= 32:
            assert early == (m == 8 or (d, f) == (4096, 1024)), (d, f)
        tile = (tgemv.prefill_tile(m, f, n_sms) if regime == "prefill"
                else (0, 0))
        plan = tgemv.make_plan(regime, d, splits, tile, early)
        assert plan == (regime, 3 if early else 1 if regime == "decode"
                        else 2, *tile, splits,
                        tgemv.split_chunk(d, regime, splits))
        late = tgemv.make_plan(regime, d, splits, tile, False)
        assert late[1] == (1 if regime == "decode" else 2)


@pytest.mark.parametrize("m,regime", [(1, "decode"), (31, "decode"),
                                      (32, "decode"), (33, "prefill"),
                                      (64, "prefill"), (100, "prefill")])
def test_gemv_plan_switches_regime_at_the_crossover(m, regime):
    """Chunked and speculative steps send M = B * C near the crossover:
    M up to 32 is decode, above it prefill, for any D and F; a D too
    short to split is not split."""
    for d, f in PROJ + [(200, 1000), (12, 4096)]:
        got, splits = tgemv.gemv_plan(m, d, f, 132)
        assert got == regime
        assert 1 <= splits <= -(-d // tgemv.SPLIT_UNIT[regime])
    assert tgemv.gemv_plan(m, 12, 4096, 132)[1] == 1


@pytest.mark.parametrize("m,d,f", [(8, 4096, 1024), (512, 4096, 1024),
                                   (24, 14336, 640), (40, 300, 333)])
def test_gemv_split_partials_sum_to_the_whole(m, d, f):
    """The algebra of a split: float32 partial products over the plan's D
    chunks, summed in split order, equal the whole product (float32, 1e-6
    of the largest value: one summation-order rounding), and so does the
    port's split reference against its plain version."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((m, d), np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (d, f), dtype=np.int8))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, f).astype(np.float32)
                             / (127 * d ** 0.5))
    regime, splits = tgemv.gemv_plan(m, d, f, 132)
    chunk = tgemv.split_chunk(d, regime, splits)
    assert splits > 1
    whole = x @ wq.float()
    parts = torch.zeros_like(whole)
    for z in range(splits):
        rows = slice(z * chunk, min((z + 1) * chunk, d))
        assert rows.start < rows.stop
        parts += x[:, rows] @ wq[rows].float()
    tol = 1e-6 * whole.abs().max().item()
    torch.testing.assert_close(parts, whole, rtol=0, atol=tol)
    want = int8_matmul_reference(x, wq, scale)
    got = tgemv.int8_matmul_split_reference(x, wq, scale, chunk)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * want.abs().max().item())


# The main paths' W8A16 projections (llama3-8b's wq/wo, wk/wv, gate/up,
# down, lm_head), each also at the tp halves of F and of D.
WGMMA_SHAPES = [(d // dd, f // ff) for d, f in PROJ + [LM_HEAD]
                for dd, ff in ((1, 1), (1, 2), (2, 1))]


@pytest.mark.parametrize("m", [64, 128, 512, 1024, 2048])
@pytest.mark.parametrize("d,f", WGMMA_SHAPES)
def test_main_path_prefill_shapes_take_the_wgmma_kernel(m, d, f):
    """Every main-path projection in the prefill regime, whole and at the
    tp halves, launches csrc/w8a16_wgmma.cu (code 4) at wgmma_plan's tile
    and split; the decode regime keeps its mma.sync kernel and plan."""
    assert tgemv.prefill_route(d, f) == "wgmma"
    tile_m, splits = tgemv.wgmma_plan(m, d, f, 132)
    plan = tgemv.launch_plan(m, d, f, 132, static=True)
    assert plan == ("prefill", 4, tile_m, tgemv.WGMMA_TILE_F, splits,
                    tgemv.split_chunk(d, "prefill", splits))
    decode = tgemv.launch_plan(8, d, f, 132, static=True)
    assert decode[:2] == ("decode", 3)
    assert decode == tgemv.make_plan(
        "decode", d, tgemv.gemv_plan(8, d, f, 132)[1], (0, 0), True)


@pytest.mark.parametrize("n_sms", [132, 114])
@pytest.mark.parametrize("m", [33, 64, 65, 128, 512, 2048])
def test_wgmma_plan_tiles_and_splits(n_sms, m):
    """The wgmma kernel's tile is 64 rows of x up to M = 64, else 128, by
    256 columns of F (two consumer warpgroups of 128); a grid under one
    wave of a block an SM splits D into whole 64-row stages, as many ways
    (up to 8, one cluster) as keep it within the wave, every chunk
    non-empty; a grid of a wave or more is not split."""
    for d, f in WGMMA_SHAPES:
        tile_m, splits = tgemv.wgmma_plan(m, d, f, n_sms)
        assert tile_m == (64 if m <= 64 else 128)
        tiles = -(-m // tile_m) * -(-f // tgemv.WGMMA_TILE_F)
        chunk = tgemv.split_chunk(d, "prefill", splits)
        assert chunk % 64 == 0 and -(-d // chunk) == splits
        assert 1 <= splits <= tgemv.MAX_SPLITS["prefill"]
        if tiles >= n_sms:
            assert splits == 1
        else:
            assert tiles * splits <= n_sms
            want = min(tgemv.MAX_SPLITS["prefill"], n_sms // tiles)
            assert splits == -(-d // tgemv.split_chunk(d, "prefill", want))
    assert tgemv.wgmma_plan(512, 4096, 14336, 132) == (128, 1)
    assert tgemv.wgmma_plan(512, 14336, 4096, 132) == (128, 2)
    assert tgemv.wgmma_plan(512, 4096, 1024, 132) == (128, 8)
    assert tgemv.wgmma_plan(64, 4096, 1024, 132) == (64, 8)


@pytest.mark.parametrize("m,d,f,aligned", [
    (512, 4100, 4096, True),    # x's rows: 8200 bytes, not a multiple of 16
    (512, 4096, 1000, True),    # the weight's rows: 1000 bytes
    (130, 256, 520, True),
    (40, 300, 333, True),
    (512, 4096, 14336, False),  # a base off the 16-byte grid
    (100, 12, 4096, True)])
def test_strides_tma_refuses_route_to_the_mma_kernel(m, d, f, aligned):
    """Operands TMA refuses (a row stride that is not a multiple of 16
    bytes, a base that is not 16-byte aligned) take the mma.sync prefill
    kernel (code 2) under gemv_plan's plan; code 4 is never planned for
    them."""
    assert tgemv.prefill_route(d, f, aligned) == "mma"
    plan = tgemv.launch_plan(m, d, f, 132, aligned=aligned)
    regime, splits = tgemv.gemv_plan(m, d, f, 132)
    assert plan == tgemv.make_plan(regime, d, splits,
                                   tgemv.prefill_tile(m, f, 132), False)
    assert plan[1] == 2
    assert tgemv.launch_plan(m, d, f, 132, bf16=False)[0] == "fma"


def test_no_fallback_around_a_launch():
    """A failed build or launch raises: the wrapper and its launcher catch
    nothing, so no call carries on with another kernel or the plain
    version."""
    import inspect

    for fn in (tgemv.int8_matmul, tgemv.launch, tgemv.launch_plan):
        src = inspect.getsource(fn)
        assert "try:" not in src and "except" not in src, fn.__name__
