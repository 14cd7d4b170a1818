"""The port's decode_attention (starway_tpu_torch.ops.decode) against the
JAX package's Pallas decode kernel run in interpret mode, both schedules
(stream=True and False), on the same numpy inputs.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is held against that version on the card
(tests/test_torch_cuda.py).  Tolerances: float32 atol 1e-5 (summation
order), bfloat16 atol 2e-2 (one bfloat16 rounding of O(1) outputs)."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from starway_tpu.ops.pallas_decode import decode_attention as jax_decode
from starway_tpu.ops.quantize import quantize_kv as jax_quantize_kv
from starway_tpu_torch.ops.decode import (KEYS, N_SMS, TMA_MAX_PER_SM,
                                          TMA_MAX_SPLITS, TMA_MERGE_GROUP,
                                          TMA_MIN_TILES, TMA_SINGLE_MERGE,
                                          TMA_TILES_PER_SPLIT,
                                          call_plan, decode_attention,
                                          decode_attention_reference,
                                          decode_plan, launch_plan,
                                          max_splits, pos_arg, tma_plan,
                                          tma_route)
from starway_tpu_torch.ops.attention import NEG_BIG, scaled_tolerance_share
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


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("rows,regime", [(1, "decode"), (4, "decode"),
                                         (16, "decode"), (17, "ingest"),
                                         (32, "ingest"), (512, "ingest")])
def test_decode_plan_regime_by_rows(rows, regime):
    """n_rep * C rows that fit one m16 tile (C=1 and the chunk verify's
    C=4 at n_rep=4) take the decode regime; more take 64-row tiles."""
    assert decode_plan(8, 8, rows, 2048)[0] == regime


@pytest.mark.parametrize("b,c,t,want", [
    (8, 1, 2048, ("tma", 8)), (16, 1, 4096, ("tma", 4)),
    (1, 1, 2048, ("tma", 16)), (1, 4, 8192, ("tma", TMA_SINGLE_MERGE)),
    (1, 128, 4096, ("ingest", 3))])
def test_decode_plan_fills_the_card(b, c, t, want):
    """llama3-8b heads (Hkv 8, n_rep 4) at the serving shapes: a call in
    the decode regime takes the TMA kernel, whose split over T gives the
    longest row's share about TMA_TILES_PER_SPLIT tiles and the grid a
    block for each of an H100 SXM's 132 SMs, within TMA_MAX_PER_SM blocks
    an SM and one split for every TMA_MIN_TILES tiles (one slot at C=1
    over 2048: 32 tiles, 16 splits); the ingest regime keeps the cluster
    kernel's plan (1.5 blocks an SM, at most max_splits)."""
    regime, n_split = call_plan(b, 8, 4 * c, t)
    assert (regime, n_split) == want
    if regime == "tma":
        tiles = -(-t // KEYS)
        capped = (b * 8 * n_split > TMA_MAX_PER_SM * N_SMS - b * 8
                  or n_split == -(-tiles // TMA_MIN_TILES)
                  or n_split == TMA_SINGLE_MERGE)
        assert b * 8 * n_split <= TMA_MAX_PER_SM * N_SMS
        assert b * 8 * n_split >= N_SMS or capped
        assert -(-tiles // n_split) <= TMA_TILES_PER_SPLIT or capped
    else:
        units = b * 8 * -(-4 * c // 64)
        assert 1 <= n_split <= max_splits(128) == 16
        assert units * n_split <= 1.5 * N_SMS < units * (n_split + 1)


def test_decode_plan_limits():
    """The TMA kernel's split never exceeds one for every TMA_MIN_TILES
    tiles the cache holds nor TMA_MAX_SPLITS, and a grid that already
    fills the card takes none; the cluster kernel's, at the head sizes
    and rows it keeps, never exceeds the tiles nor the cluster limit at
    D=256 (8)."""
    assert call_plan(1, 1, 4, 100) == ("tma", 1)  # 2 tiles
    assert call_plan(1, 1, 4, 300) == ("tma", 3)  # 5 tiles
    assert call_plan(1, 1, 4, 1 << 20) == ("tma", TMA_MAX_SPLITS)
    assert call_plan(64, 8, 4, 2048) == ("tma", 1)
    assert call_plan(1, 8, 4, 2048, d=64) == ("tma", 16)
    assert call_plan(1, 2, 4, 4096) == ("tma", TMA_SINGLE_MERGE)
    assert decode_plan(1, 1, 4, 100)[1] == -(-100 // KEYS) == 2
    assert call_plan(1, 8, 4, 4096, d=256) == ("decode", max_splits(256))
    assert max_splits(256) == 8
    assert call_plan(8, 8, 4, 4096, d=256) == ("decode", 1)  # one an SM
    assert call_plan(1, 8, 4, 2048, d=32) == ("decode", 16)
    assert call_plan(8, 8, 512, 2048)[1] == 1
    assert call_plan(8, 8, 32, 2048) == ("ingest", 3)


@pytest.mark.parametrize("units", [1, 2, 8, 16, 64])
@pytest.mark.parametrize("t", [8192, 1 << 16])
def test_tma_plan_fills_the_card(units, t):
    """At every B x Hkv of the serving paths the TMA kernel's grid fills
    the card's 132 SMs (at least one block each, at most TMA_MAX_PER_SM),
    unless the cache has too few tiles (one split for every
    TMA_MIN_TILES); it never splits past the tiles T holds.  Where B x Hkv
    is small the split runs past one 16-block cluster: one row of 2 kv
    heads over T=8192 launches over 100 blocks."""
    for b, hkv in ((units, 1), (1, units)):
        n = tma_plan(b, hkv, t)
        tiles = -(-t // KEYS)
        assert 1 <= n <= min(tiles, TMA_MAX_SPLITS)
        assert units * n <= TMA_MAX_PER_SM * N_SMS
        assert units * n >= N_SMS or n == -(-tiles // TMA_MIN_TILES)
    assert tma_plan(1, 2, 8192) * 2 >= 100
    assert tma_plan(1, 2, 8192) > max_splits(128)


def test_paged_kernel_keeps_the_cluster_plan():
    """The paged kernel (ops/paged.py) has no TMA route: its launches ask
    for the cluster kernel's plan, whichever regime the rows give."""
    for rows in (4, 16, 17):
        assert call_plan(16, 8, rows, 4096, tma=False) == decode_plan(
            16, 8, rows, 4096)
    assert call_plan(16, 8, 4, 4096)[0] == "tma"
    import starway_tpu_torch.ops.paged as paged
    assert "q.device.index or 0, False)" in inspect.getsource(
        paged.paged_decode_attention)


@pytest.mark.parametrize("bf16,rows,d,want", [
    (True, 4, 128, True), (True, 16, 128, True), (True, 8, 64, True),
    (True, 17, 128, False), (True, 4, 32, False), (True, 4, 256, False),
    (False, 4, 128, False)])
def test_tma_route(bf16, rows, d, want):
    """bf16 q in the decode regime (n_rep * C <= 16 rows) at head sizes 64
    and 128 takes csrc/decode_tma.cu; the ingest regime, the other head
    sizes and float32 keep csrc/decode_attention.cu."""
    assert tma_route(bf16, rows, d) is want
    assert (call_plan(8, 8, rows, 2048, d, bf16)[0] == "tma") is want


def test_decode_plan_follows_the_named_card():
    """Without a card the plan is the H100 SXM's (132 SMs); the wrapper
    passes the SM count of q's card."""
    assert call_plan(8, 8, 4, 2048) == call_plan(8, 8, 4, 2048, n_sms=132)
    assert call_plan(8, 8, 4, 2048, n_sms=114) == ("tma", 7)
    assert call_plan(8, 8, 4, 2048, n_sms=264) == ("tma", 8)
    assert call_plan(8, 8, 4, 2048, n_sms=16) == ("tma", 1)
    assert tma_plan(1, 2, 65536, n_sms=78) == 156
    assert decode_plan(8, 8, 4, 2048, n_sms=114)[1] == 3
    assert decode_plan(8, 8, 4, 2048, n_sms=264)[1] == 8
    assert decode_plan(8, 8, 4, 2048, n_sms=16)[1] == 1


def test_decode_plan_takes_no_pos():
    """Nothing the launch plans depends on the positions: the kernels find
    each split's tiles from pos on the device, and the host never reads
    it (a read would stall the host-bound decode step and break CUDA-graph
    capture)."""
    for fn in (decode_plan, tma_plan, call_plan, launch_plan.__wrapped__):
        assert not any("pos" in name
                       for name in inspect.signature(fn).parameters)


def test_pos_arg_passes_device_tensors_as_they_are():
    """pos reaches the kernel as given: an int as a value, an int32 [B] or
    one-element tensor by pointer (stride 1 or 0, no copy); other dtypes
    are converted on their device; a wrong length is refused."""
    dev = torch.device("cpu")
    assert pos_arg(7, 3, dev) == (None, 0, 7)
    assert pos_arg(np.int32(7), 3, dev) == (None, 0, 7)
    p = torch.tensor([1, 2, 3], dtype=torch.int32)
    got, stride, _ = pos_arg(p, 3, dev)
    assert got is p and stride == 1
    one = torch.tensor([5], dtype=torch.int32)
    got, stride, _ = pos_arg(one, 3, dev)
    assert got is one and stride == 0
    got, stride, _ = pos_arg(torch.tensor([1, 2, 3]), 3, dev)
    assert got.dtype == torch.int32 and got.tolist() == [1, 2, 3]
    with pytest.raises(ValueError, match="pos"):
        pos_arg(torch.tensor([1, 2], dtype=torch.int32), 3, dev)


def _partial(q, k, v, keep, sm_scale):
    """Unnormalised (o, m, l) of float32 rows over the kept keys; the
    identity (0, NEG_BIG, 0) where a row keeps none."""
    s = (q @ k.T) * sm_scale
    s = torch.where(keep, s, torch.full_like(s, -torch.inf))
    m = s.amax(-1).clamp(min=-0.9e30)
    p = torch.exp(s - m[:, None])
    return p @ v, m, p.sum(-1)


def _shares(kernel, n_tiles, n_split, reach):
    """Each split's live tiles [lo, hi), in split order, for a row with
    ``n_tiles`` live tiles of the ``reach`` a row can have: the cluster
    kernel's (csrc/decode_tiles.cuh: [z T / n, (z + 1) T / n)) or the TMA
    kernel's (csrc/decode_tma.cu: [z per, (z + 1) per), per =
    ceil(reach / n), and only the first ceil(T / per) splits busy)."""
    if kernel == "cluster":
        return [(z * n_tiles // n_split, (z + 1) * n_tiles // n_split)
                for z in range(n_split)]
    per = -(-reach // n_split)
    busy = -(-n_tiles // per)
    return [(z * per, min((z + 1) * per, n_tiles)) for z in range(busy)]


def _merge(parts):
    """(o, m, l) partials merged in their order with weight exp(m_z - M),
    as the kernels sum them: a partial of the same form."""
    m_all = parts[0][1]
    for _, m, _ in parts[1:]:
        m_all = torch.maximum(m_all, m)
    o = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for o_z, m, l_z in parts:
        w = torch.exp(m - m_all)
        o = o + o_z * w[:, None]
        l = l + l_z * w
    return o, m_all, l


@pytest.mark.parametrize("kernel,n_split,pos", [
    ("cluster", 4, [900, 37]), ("cluster", 16, [2000, 100]),
    ("cluster", 5, [63, 64]), ("tma", 4, [900, 37]),
    ("tma", 33, [8191, 2000, 100]), ("tma", 66, [8191, 4100, 63]),
    ("tma", 256, [8191, 64])])
def test_split_shares_merge_to_the_whole(kernel, n_split, pos):
    """The kernels' split over T in plain arithmetic, in the order each
    kernel merges: every split leaves an (o, m, l) partial (the cluster
    kernel's short rows leave whole splits empty: the identity; the TMA
    kernel sizes its shares from the longest row a cache of T = 8192 can
    hold, so a short row takes few splits and none is empty), and merging
    them in split order with weight exp(m_z - M) (the TMA kernel past
    TMA_SINGLE_MERGE busy splits: each group of TMA_MERGE_GROUP in split
    order, then the groups in group order) gives the attention of the
    whole (float32, 1e-5), past one cluster too."""
    rng = np.random.default_rng(3)
    d, t, sm = 16, 8192, 16 ** -0.5
    for p in pos:
        q = torch.from_numpy(rng.standard_normal((4, d), np.float32))
        k, v = (torch.from_numpy(rng.standard_normal((t, d), np.float32))
                for _ in range(2))
        kp = torch.arange(t)
        n_tiles = -(-(p + 1) // KEYS)
        shares = _shares(kernel, n_tiles, n_split, -(-t // KEYS))
        assert [lo for lo, _ in shares] == sorted(lo for lo, _ in shares)
        assert sum(hi - lo for lo, hi in shares) == n_tiles
        parts = []
        for lo, hi in shares:
            keep = ((kp >= lo * KEYS) & (kp < hi * KEYS)
                    & (kp <= p))[None, :].expand(4, t)
            parts.append(_partial(q, k, v, keep, sm))
        if kernel == "tma" and len(parts) > TMA_SINGLE_MERGE:
            # groups of TMA_MERGE_GROUP splits, then the groups, in order
            parts = [_merge(parts[i:i + TMA_MERGE_GROUP])
                     for i in range(0, len(parts), TMA_MERGE_GROUP)]
        o, _, l = _merge(parts)
        want = torch.softmax(torch.where(kp[None, :] <= p, (q @ k.T) * sm,
                                         torch.tensor(-torch.inf)), -1) @ v
        torch.testing.assert_close(o / l[:, None], want, atol=1e-5, rtol=0)
        empty = sum(lo == hi for lo, hi in shares)
        if kernel == "cluster":
            assert empty == max(0, n_split - n_tiles)
        else:  # no empty share is merged; no share outgrows the longest row's
            assert empty == 0 and len(shares) <= n_split
            assert max(hi - lo for lo, hi in shares) <= -(-(t // KEYS)
                                                        // n_split)


def _online_softmax(q, k, v, pos, window, drop_tile=None):
    """The bf16 decode kernel's arithmetic in plain PyTorch: keys in
    KEYS-row tiles, a running max, p rounded to bf16 against it before
    p @ v, a bf16 output; ``drop_tile`` leaves one tile out, as a faulty
    kernel would."""
    b, hq, c, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rows = hq // hkv * c
    qg = q.reshape(b, hkv, rows, d).float()
    q_pos = pos[:, None, None, None].long() + (torch.arange(rows) % c)[
        None, None, :, None]
    m = torch.full((b, hkv, rows, 1), NEG_BIG)
    l = torch.zeros(b, hkv, rows, 1)
    acc = torch.zeros(b, hkv, rows, d)
    for j0 in range(0, t, KEYS):
        kp = torch.arange(j0, min(j0 + KEYS, t))[None, None, None, :]
        keep = (kp <= q_pos) & (j0 // KEYS != drop_tile)
        if window is not None:
            keep = keep & (kp > q_pos - window)
        s = qg @ k[:, :, j0:j0 + KEYS].float().transpose(-1, -2) * d ** -0.5
        s = torch.where(keep, s, torch.full_like(s, NEG_BIG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(keep, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ v[
            :, :, j0:j0 + KEYS].float()
        m = m_new
    return (acc / l).to(torch.bfloat16).reshape(b, hq, c, d)


@pytest.mark.parametrize("c,t,pos,window,drop", [
    (1, 4096, [100, 9000], None, 1),   # a circular cache, pos clamped
    (5, 4654, [4600, 4647], 4096, 40),  # a windowed verify, C = 5
    (1, 544, [543, 543], 4096, 5),      # beam rows
])
def test_scaled_tolerance_tells_a_dropped_tile(c, t, pos, window, drop):
    """ops/attention.py's scaled limit, which chip_smoke.py holds the bf16
    kernels to at phase 18's shapes (Hq=32, Hkv=8, D=128), against a model
    of the kernel's arithmetic: the kernel's roundings stay under half of
    it, and a kernel that drops one 64-key tile of the window is over
    four times it."""
    gen = torch.Generator().manual_seed(t)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
               for shape in ((2, 32, c, 128), (2, 8, t, 128),
                             (2, 8, t, 128)))
    pos = torch.tensor(pos, dtype=torch.int32).clamp(max=t - 1)
    want = decode_attention_reference(q, k, v, pos, window=window)
    assert scaled_tolerance_share(
        _online_softmax(q, k, v, pos, window), want) <= 0.5
    assert scaled_tolerance_share(
        _online_softmax(q, k, v, pos, window, drop_tile=drop), want) > 4
