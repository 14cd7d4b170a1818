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
from starway_tpu_torch.ops.decode import (KEYS, N_SMS, decode_attention,
                                          decode_attention_reference,
                                          decode_plan, launch_plan,
                                          max_splits, pos_arg)
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


@pytest.mark.parametrize("b,c,t,want", [(8, 1, 2048, 4), (16, 1, 4096, 2),
                                        (1, 1, 2048, 16), (1, 128, 4096, 3)])
def test_decode_plan_fills_the_card(b, c, t, want):
    """llama3-8b heads (Hkv 8, n_rep 4) at the serving shapes: the split
    over T is the largest that keeps the grid within two decode blocks (or
    1.5 ingest blocks) for each of an H100 SXM's 132 SMs, unless the
    cluster limit stops it first (one slot at C=1: 8 kv heads x 16 = 128
    blocks), and stays a cluster that launches."""
    regime, n_split = decode_plan(b, 8, 4 * c, t)
    units = b * 8 * -(-4 * c // (16 if regime == "decode" else 64))
    target = {"decode": 2.0, "ingest": 1.5}[regime] * N_SMS
    assert n_split == want
    assert 1 <= n_split <= max_splits(128) == 16
    assert units * n_split <= target
    assert units * (n_split + 1) > target or n_split == max_splits(128)


def test_decode_plan_limits():
    """The split never exceeds the tiles the cache holds nor the cluster
    limit at D=256 (8); a grid that already fills the card takes none."""
    assert decode_plan(1, 1, 4, 100)[1] == -(-100 // KEYS) == 2
    assert decode_plan(1, 8, 4, 4096, d=256)[1] == max_splits(256) == 8
    assert decode_plan(8, 8, 4, 4096, d=256)[1] == 1  # one block an SM
    assert decode_plan(64, 8, 4, 2048)[1] == 1
    assert decode_plan(1, 8, 4, 2048, d=64) == ("decode", 16)
    assert decode_plan(8, 8, 512, 2048)[1] == 1
    assert decode_plan(8, 8, 32, 2048) == ("ingest", 3)


def test_decode_plan_follows_the_named_card():
    """Without a card the plan is the H100 SXM's (132 SMs); the wrapper
    passes the SM count of q's card."""
    assert decode_plan(8, 8, 4, 2048) == decode_plan(8, 8, 4, 2048,
                                                     n_sms=132)
    assert decode_plan(8, 8, 4, 2048, n_sms=114)[1] == 3
    assert decode_plan(8, 8, 4, 2048, n_sms=264)[1] == 8
    assert decode_plan(8, 8, 4, 2048, n_sms=16)[1] == 1


def test_decode_plan_takes_no_pos():
    """Nothing the launch plans depends on the positions: the kernels find
    each split's tiles from pos on the device, and the host never reads
    it (a read would stall the host-bound decode step and break CUDA-graph
    capture)."""
    for fn in (decode_plan, launch_plan.__wrapped__):
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


@pytest.mark.parametrize("n_split,pos", [(4, [900, 37]), (16, [2000, 100]),
                                         (5, [63, 64])])
def test_split_shares_merge_to_the_whole(n_split, pos):
    """The kernels' split over T in plain arithmetic: split z of n takes
    live tiles [z T / n, (z + 1) T / n) of a row's T; each leaves an
    (o, m, l) partial (the identity where its share is empty, as short
    rows leave whole splits), and merging them in split order with weight
    exp(m_z - M) gives the attention of the whole (float32, 1e-5)."""
    rng = np.random.default_rng(3)
    d, t, sm = 16, 2048, 16 ** -0.5
    for p in pos:
        q = torch.from_numpy(rng.standard_normal((4, d), np.float32))
        k, v = (torch.from_numpy(rng.standard_normal((t, d), np.float32))
                for _ in range(2))
        kp = torch.arange(t)
        n_tiles = -(-(p + 1) // KEYS)
        parts, empty = [], 0
        for z in range(n_split):
            lo, hi = z * n_tiles // n_split, (z + 1) * n_tiles // n_split
            empty += lo == hi
            keep = ((kp >= lo * KEYS) & (kp < hi * KEYS)
                    & (kp <= p))[None, :].expand(4, t)
            parts.append(_partial(q, k, v, keep, sm))
        m_all = torch.stack([m for _, m, _ in parts]).amax(0)
        o = sum(o * torch.exp(m - m_all)[:, None] for o, m, _ in parts)
        l = sum(l * torch.exp(m - m_all) for _, m, l in parts)
        want = torch.softmax(torch.where(kp[None, :] <= p, (q @ k.T) * sm,
                                         torch.tensor(-torch.inf)), -1) @ v
        torch.testing.assert_close(o / l[:, None], want, atol=1e-5, rtol=0)
        assert empty == max(0, n_split - n_tiles)


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
