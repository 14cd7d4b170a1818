"""Int8-weight matmul (W8A16): the hand-written CUDA kernels
(csrc/int8_gemv.cu) and their plain PyTorch version.

``x [M, D] @ (wq int8 [D, F] * scale f32 [F]) -> [M, F]`` in x's dtype,
accumulated in float32 with the per-column scale applied after the
product (ops/quantize.py:quantize_weight).

A bfloat16 x takes one of two regimes on the tensor cores, chosen by
:func:`gemv_plan` from the shapes alone: "decode" (M up to
``DECODE_MAX_M``: the weight stream bounds it, and D is split so that
every SM holds about two blocks) or "prefill" (above: the multiply-adds
bound it, and D is split only where the grid is under one block an SM).
The splits of an output tile are one thread block cluster that sums its
float32 partials in split order in shared memory: no workspace, no
second kernel, and two calls give identical bits.  For a static weight
(a model's parameters), where :func:`early_launch` says so, the decode
kernel is a programmatic dependent launch that starts streaming its
weight while the kernel ahead finishes.  A float32 x takes the FMA
kernel ("fma").

The prefill regime runs on Hopper's wgmma fed by TMA
(csrc/w8a16_wgmma.cu, planned by :func:`wgmma_plan`) wherever TMA takes
the operands (:func:`prefill_route`: D % 8 == 0, F % 16 == 0, 16-byte
aligned bases), which every projection of the serving paths meets; the
mma.sync prefill kernel (planned by :func:`gemv_plan`) takes the rest.
"""

from __future__ import annotations

import functools

import torch

from . import _build

DECODE_MAX_M = 32    # the crossover: M above it runs the prefill regime
DECODE_COLS = 128    # F columns a decode block
SPLIT_UNIT = {"decode": 16, "prefill": 64}  # rows of D: a k16 step, a stage
MAX_SPLITS = {"decode": 16, "prefill": 8}  # a tile's splits: one cluster
# Share of the card's 128-column prefill slots (two an SM) a split grid
# fills: clusters pack into the GPCs unevenly, and a grid that asks for
# every slot ran as two waves on the H100 (ops/gemv_sweep.py).
CLUSTER_FILL = 0.85
REGIMES = ("decode", "prefill", "fma")
# A bf16 result is held, element by element, to max(BF16_ATOL, BF16_ULPS
# bf16 ulps of |want|): the kernel and the plain version each round a
# float32 sum taken in another order, and outputs above 4 have ulps above
# 2e-2.  float32 results: FLOAT32_TOL (summation order).
BF16_ATOL = 2e-2
BF16_ULPS = 2
FLOAT32_TOL = 1e-5


def _check_args(x, wq, scale):
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"want x [M, D] and wq [D, F], got "
                         f"{tuple(x.shape)}, {tuple(wq.shape)}")
    if wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8, got {wq.dtype}")
    if scale.shape != (wq.shape[1],) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32 [{wq.shape[1]}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def prefill_tile(m: int, f: int, n_sms: int) -> tuple[int, int]:
    """(rows of x, columns of F) a prefill block takes: 64 rows up to M =
    64, else 128; 256 columns, or 128 where the 256-column grid is under
    a quarter of the card (more blocks beat the wider tile there)."""
    tile_m = 64 if m <= 64 else 128
    narrow = _cdiv(m, tile_m) * _cdiv(f, 256) * 4 < n_sms
    return tile_m, 128 if narrow else 256


def _tiles(regime: str, m: int, f: int, n_sms: int) -> int:
    if regime == "decode":
        return _cdiv(f, DECODE_COLS)
    tile_m, tile_n = prefill_tile(m, f, n_sms)
    return _cdiv(m, tile_m) * _cdiv(f, tile_n)


def gemv_plan(m: int, d: int, f: int, n_sms: int) -> tuple[str, int]:
    """(regime, splits) of a bfloat16 ``[m, d] @ [d, f]``: "decode" for m
    up to ``DECODE_MAX_M``, else "prefill"; D is cut into ``splits``
    chunks of :func:`split_chunk` rows, and an output tile's splits are
    one thread block cluster (``MAX_SPLITS``).

    Decode streams the weight: enough splits for about 2 blocks an SM at
    M up to 16 (bytes in flight), 1 above (twice the x rows and registers
    a block); rounding the chunk to whole k steps may leave a little less.
    Prefill multiplies: the largest power of two up to 4 that keeps the
    grid within one wave (a block an SM); where that is 4 and the blocks
    are 128 columns wide (two an SM), as many splits, up to 8, as fill
    ``CLUSTER_FILL`` of those slots (256-column clusters past 4, and odd
    sizes on multi-wave grids, ran slower on the H100:
    ops/gemv_sweep.py)."""
    regime = "decode" if m <= DECODE_MAX_M else "prefill"
    tiles = _tiles(regime, m, f, n_sms)
    cap = MAX_SPLITS[regime]
    if regime == "decode":
        per_sm = 2 if m <= 16 else 1
        want = min(_cdiv(per_sm * n_sms, tiles), cap)
    else:
        want = 1
        while want < 4 and tiles * 2 * want <= n_sms:
            want *= 2
        narrow = prefill_tile(m, f, n_sms)[1] == 128
        if want == 4 and narrow:
            fill = int(CLUSTER_FILL * 2 * n_sms)
            want = max(want, min(cap, fill // tiles))
    if want <= 1:
        return regime, 1
    return regime, _cdiv(d, split_chunk(d, regime, want))


WGMMA_TILE_F = 256  # F columns a block of the wgmma kernel, 128 a consumer


def prefill_route(d: int, f: int, aligned: bool = True) -> str:
    """The prefill regime's kernel: "wgmma" (csrc/w8a16_wgmma.cu) where TMA
    takes the operands, x's rows (D * 2 bytes) and the weight's (F bytes)
    multiples of 16 bytes (D % 8 == 0, F % 16 == 0) and every base 16-byte
    aligned (``aligned``), else "mma" (csrc/int8_gemv.cu).  Decided from
    the arguments alone, never from a failed launch."""
    return "wgmma" if aligned and d % 8 == 0 and f % 16 == 0 else "mma"


def wgmma_plan(m: int, d: int, f: int, n_sms: int) -> tuple[int, int]:
    """(tile_m, splits) of the wgmma prefill kernel: 64 rows of x a block
    up to M = 64, else 128, by ``WGMMA_TILE_F`` columns; D split (chunks
    of whole 64-row stages, up to ``MAX_SPLITS["prefill"]``, one cluster)
    as many ways as keep the grid within one wave of a block an SM (a
    block of 384 threads and ~130 KB of shared memory holds an SM), where
    the unsplit grid is under one."""
    tile_m = 64 if m <= 64 else 128
    tiles = _cdiv(m, tile_m) * _cdiv(f, WGMMA_TILE_F)
    want = max(1, min(MAX_SPLITS["prefill"], n_sms // tiles))
    if want <= 1:
        return tile_m, 1
    return tile_m, _cdiv(d, split_chunk(d, "prefill", want))


def early_launch(regime: str, m: int, f: int, splits: int,
                 n_sms: int) -> bool:
    """Whether the decode kernel of a static weight goes out as a
    programmatic dependent launch, whose launch and first weight loads
    then overlap the kernel ahead (the GEMV of q before k's, of k before
    v's): at M up to 8 (one n-tile of x rows, the serving step's M), and
    for a grid of at most one block an SM at any decode M.  On the H100
    these ran faster so launched, and larger grids at M = 16 slower
    (ops/gemv_sweep.py times both)."""
    if regime != "decode":
        return False
    return m <= 8 or _tiles(regime, m, f, n_sms) * splits <= n_sms


def split_chunk(d: int, regime: str, splits: int) -> int:
    """Rows of D each split sums, whole k steps of the regime's kernel:
    split z takes rows [z * chunk, min((z + 1) * chunk, d))."""
    unit = SPLIT_UNIT[regime]
    return _cdiv(_cdiv(d, splits), unit) * unit


def int8_matmul_reference(x, wq, scale):
    """The kernel's function in plain PyTorch: ``(x @ wq) * scale`` in
    float32, cast to x's dtype."""
    _check_args(x, wq, scale)
    return ((x.float() @ wq.float()) * scale).to(x.dtype)


def int8_matmul_split_reference(x, wq, scale, chunk: int):
    """The split kernels' order of summation in plain PyTorch: float32
    partial products over D chunks of ``chunk`` rows, summed chunk by
    chunk, then scaled and cast to x's dtype."""
    _check_args(x, wq, scale)
    acc = torch.zeros((x.shape[0], wq.shape[1]), dtype=torch.float32,
                      device=x.device)
    for r in range(0, x.shape[1], chunk):
        acc += x[:, r:r + chunk].float() @ wq[r:r + chunk].float()
    return (acc * scale).to(x.dtype)


def bf16_ulp(v):
    """One bf16 ulp at each element of ``v``: 2^(floor(log2 |v|) - 7)."""
    return torch.exp2(torch.floor(torch.log2(v.abs())) - 7)


def tolerance_share(got, want) -> float:
    """The worst element's ``|got - want|`` as a share of its tolerance:
    max(BF16_ATOL, BF16_ULPS ulps of |want|) for a bf16 ``got``, else
    FLOAT32_TOL (absolute and relative).  At most 1 passes."""
    want = want.float()
    if got.dtype == torch.bfloat16:
        tol = (BF16_ULPS * bf16_ulp(want)).clamp(min=BF16_ATOL)
    else:
        tol = FLOAT32_TOL * (1 + want.abs())
    return ((got.float() - want).abs() / tol).max().item()


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launch_plan(m: int, d: int, f: int, bf16: bool, static: bool,
                 index: int, aligned: bool = True):
    """:func:`launch_plan` on the card ``index``; cached, as a decode step
    makes ~225 calls."""
    return launch_plan(m, d, f, _n_sms(index), bf16=bf16, static=static,
                       aligned=aligned)


def launch_plan(m: int, d: int, f: int, n_sms: int, *, bf16: bool = True,
                static: bool = False, aligned: bool = True) -> tuple:
    """:func:`make_plan` of the plan for one call on a card of ``n_sms``
    SMs: the prefill regime on the kernel :func:`prefill_route` picks
    (wgmma: :func:`wgmma_plan`), else :func:`gemv_plan`'s, launched early
    where :func:`early_launch` says so and the weight is ``static``."""
    if not bf16:
        return "fma", 0, 0, 0, 1, d
    regime, splits = gemv_plan(m, d, f, n_sms)
    if regime == "prefill" and prefill_route(d, f, aligned) == "wgmma":
        tile_m, splits = wgmma_plan(m, d, f, n_sms)
        return make_plan(regime, d, splits, (tile_m, WGMMA_TILE_F), False,
                         "wgmma")
    tile = prefill_tile(m, f, n_sms) if regime == "prefill" else (0, 0)
    early = static and early_launch(regime, m, f, splits, n_sms)
    return make_plan(regime, d, splits, tile, early)


def make_plan(regime: str, d: int, splits: int, tile, early: bool,
              route: str = "mma") -> tuple:
    """(regime, its code for the C entry point, prefill tile rows and
    columns, splits, chunk) of a bf16 launch.  Codes: 1 decode, 3 decode
    as an early launch (``early``), 2 prefill on mma.sync, 4 prefill on
    wgmma (``route``)."""
    if regime == "decode":
        code = 3 if early else 1
    else:
        code = 4 if route == "wgmma" else 2
    return (regime, code, *tile, splits, split_chunk(d, regime, splits))


def int8_matmul(x, wq, scale, *, static_weight: bool = False):
    """``x [M, D] @ (wq int8 [D, F] * scale f32 [F]) -> [M, F]``.

    CUDA tensors launch the kernels (csrc/int8_gemv.cu, and for the
    prefill regime csrc/w8a16_wgmma.cu where :func:`prefill_route` says so)
    in the plan of :func:`launch_plan`, CPU tensors take
    :func:`int8_matmul_reference`.
    ``static_weight``: nothing writes ``wq`` while calls run (a served
    model's parameters), so the decode kernel may read it before the
    kernel ahead in the stream has finished (:func:`early_launch`)."""
    _check_args(x, wq, scale)
    if not x.is_cuda:
        return int8_matmul_reference(x, wq, scale)
    aligned = (x.data_ptr() | wq.data_ptr() | scale.data_ptr()) % 16 == 0
    plan = _launch_plan(x.shape[0], x.shape[1], wq.shape[1],
                        x.dtype == torch.bfloat16, static_weight,
                        x.device.index or 0, aligned)
    out = launch(x, wq, scale, plan)
    int8_matmul.launches += 1
    int8_matmul.regime_launches[plan[0]] += 1
    int8_matmul.wgmma_launches += plan[1] == 4
    return out


int8_matmul.launches = 0
int8_matmul.regime_launches = dict.fromkeys(REGIMES, 0)
int8_matmul.wgmma_launches = 0  # prefill launches on csrc/w8a16_wgmma.cu


def launch(x, wq, scale, plan):
    """Launch the kernel of ``plan`` (a :func:`make_plan` tuple) on CUDA
    tensors, uncounted: :func:`int8_matmul`'s launch, and the sweep's
    (ops/gemv_sweep.py) under plans gemv_plan does not pick."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    for t in (wq, scale):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
    if not (x.is_contiguous() and wq.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("int8_matmul needs contiguous tensors")
    m, d = x.shape
    f = wq.shape[1]
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    regime, code, tile_m, tile_n, splits, chunk = plan
    xp, wp = x.data_ptr(), wq.data_ptr()
    if code == 4:
        err = _build.library().sw_int8_matmul_wgmma(
            xp, wp, scale.data_ptr(), out.data_ptr(), m, d, f, tile_m,
            splits, chunk, _build.stream_ptr(x))
        _build.check(err, "int8_matmul")
        return out
    vec = f % 16 == 0 and wp % 16 == 0  # 16-byte weight loads
    if regime == "decode":  # and 8-byte loads of x
        vec = vec and d % 4 == 0 and xp % 8 == 0
    elif regime == "prefill":  # and 16-byte copies of x
        vec = vec and d % 8 == 0 and xp % 16 == 0
    err = _build.library().sw_int8_matmul(
        xp, wp, scale.data_ptr(), out.data_ptr(), m, d, f,
        int(x.dtype == torch.bfloat16), int(vec), code, tile_m, tile_n,
        splits, chunk, _build.stream_ptr(x))
    _build.check(err, "int8_matmul")
    return out
