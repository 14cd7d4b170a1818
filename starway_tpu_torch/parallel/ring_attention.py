"""Ring attention: sequence-parallel exact attention over the shards of a
mesh axis.

Port of the JAX package's ``parallel/ring_attention.py``.  Each shard owns
a slice of the sequence of q/k/v; the kv shards rotate around the axis
(ops/collectives.py ``ring_shift``) while every shard accumulates
online-softmax partials against its resident queries, merged with the
associative ``merge_partials`` (ops/attention.py), so exactness does not
depend on the order in which blocks arrive.  The mesh's shards may sit
several to a process (parallel/sharding.py): all ``n`` in one process
rotate as a list, which runs every ring step at its real global offsets on
one card.

Each ring step is a kernel: the partial of one (q shard, kv shard) pair is
``flash_partial`` and its gradient ``flash_partial_bwd`` (ops/flash.py),
the CUDA kernels on CUDA tensors and their plain versions on the CPU.
Both ring variants are ``torch.autograd.Function``s:

* forward: ``n`` steps per shard, merged, finalised; the row log-sum-exp
  ``lse = m + log(max(l, 1e-30))`` is kept for the backward;
* backward: a second ring pass.  Each shard keeps its q/dO/lse/delta and
  accumulates dq; the float32 dk/dv accumulators rotate with their kv
  shard, and after the last step one more shift sends each home having
  summed every shard's contribution.

The plain ring runs every step, a dead causal step included (its kernel
writes the identity partial), as the JAX package's step structure does:
``n * n`` partial launches a call, forward and backward alike.  The zigzag
layout runs ``2 n^2 + n``.  With a sliding window the steps out of the
band are skipped and the rotations stop after the band (``_ring_steps``).

Functions take this process's slice of the sequence, ``[B, H, T_proc,
D]`` with ``T_proc = n / world * t_local``; with one process that is the
whole sequence.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.attention import finalize_partial, merge_partials
from ..ops.collectives import axis_index, axis_size, ring_shift
from ..ops.flash import flash_partial, flash_partial_bwd
from .sharding import cut_blocks, join_blocks


def _check_mesh(q, mesh, axis_name):
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis_name!r}")
    if q.device.type != mesh.device.type:
        raise ValueError(f"inputs on {q.device}, mesh on {mesh.device}")


def _lse_of(acc):
    """Merged partial -> log-sum-exp (float32), the backward's row
    statistic."""
    _, m, l = acc
    return m + torch.log(torch.clamp(l, min=1e-30))


def _merge(acc, part):
    """Merge into an accumulator; the first partial is taken as it is
    (merging it with the identity partial gives it back exactly)."""
    return part if acc is None else merge_partials(acc, part)


def _band_live(q_off, kv_off, tq, tk, causal, window) -> bool:
    """Does the (q shard, kv shard) pair see any key under the causal
    mask and the window band?"""
    live = True
    if causal:
        live = q_off + tq - 1 >= kv_off
    if window is not None:
        live = live and q_off - (kv_off + tk - 1) < window
    return live


def _ring_steps(n: int, t_local: int, window) -> int:
    """How many ring steps can ever be live under the band: shard ``my``
    attends shard ``my - i`` only while ``i * t_local`` reaches back less
    than ``window`` (plus its own diagonal), so the loop and the rotations
    stop after the band."""
    if window is None:
        return n
    return min(n, (window - 2 + t_local) // t_local + 1)


# ------------------------------------------------------------ plain ring


def _ring_fwd(qs, ks, vs, mesh, axis, causal, sm_scale, window):
    n = axis_size(mesh, axis)
    mine = axis_index(mesh, axis)
    t = qs[0].shape[2]
    steps = _ring_steps(n, t, window)
    accs = [None] * len(qs)
    k_cur, v_cur = ks, vs
    for i in range(steps):
        for j, my in enumerate(mine):
            q_off, kv_off = my * t, ((my - i) % n) * t
            if window is None or _band_live(q_off, kv_off, t, t, causal,
                                            window):
                accs[j] = _merge(accs[j], flash_partial(
                    qs[j], k_cur[j], v_cur[j], q_off, kv_off, causal=causal,
                    sm_scale=sm_scale, window=window))
        if i < steps - 1:  # the last step skips the rotation
            k_cur = ring_shift(k_cur, mesh, axis, 1)
            v_cur = ring_shift(v_cur, mesh, axis, 1)
    outs = [finalize_partial(*a, out_dtype=qs[0].dtype) for a in accs]
    return outs, [_lse_of(a) for a in accs]


def _ring_bwd(qs, ks, vs, dos, lses, deltas, mesh, axis, causal, sm_scale,
              window):
    n = axis_size(mesh, axis)
    mine = axis_index(mesh, axis)
    t = qs[0].shape[2]
    steps = _ring_steps(n, t, window)
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
          for k in ks]
    dv = [torch.zeros_like(x) for x in dk]
    k_cur, v_cur = ks, vs
    for i in range(steps):
        for j, my in enumerate(mine):
            q_off, kv_off = my * t, ((my - i) % n) * t
            if window is None or _band_live(q_off, kv_off, t, t, causal,
                                            window):
                g = flash_partial_bwd(qs[j], dos[j], k_cur[j], v_cur[j],
                                      lses[j], deltas[j], q_off, kv_off,
                                      causal=causal, sm_scale=sm_scale,
                                      window=window)
                dq[j].add_(g[0])
                dk[j].add_(g[1])
                dv[j].add_(g[2])
        if i < steps - 1:
            # dk/dv accumulators rotate with their kv shard.
            k_cur, v_cur, dk, dv = (ring_shift(x, mesh, axis, 1)
                                    for x in (k_cur, v_cur, dk, dv))
    # After steps - 1 rotations each shard's gradient sits steps - 1 hops
    # from its owner: one shift of the remaining distance sends it home.
    home = (n - (steps - 1)) % n
    dk = ring_shift(dk, mesh, axis, home)
    dv = ring_shift(dv, mesh, axis, home)
    return dq, dk, dv


class _Ring(torch.autograd.Function):
    """The JAX package's ``_ring`` custom_vjp, over the slots of a
    process: ``per`` q, k and v blocks in, ``per`` outputs out."""

    @staticmethod
    def forward(ctx, mesh, axis, causal, sm_scale, window, per, *blocks):
        qs, ks, vs = (list(blocks[i * per:(i + 1) * per]) for i in range(3))
        outs, lses = _ring_fwd(qs, ks, vs, mesh, axis, causal, sm_scale,
                               window)
        ctx.save_for_backward(*qs, *ks, *vs, *lses, *outs)
        ctx.cfg = (mesh, axis, causal, sm_scale, window, per)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        mesh, axis, causal, sm_scale, window, per = ctx.cfg
        saved = ctx.saved_tensors
        qs, ks, vs, lses, outs = (list(saved[i * per:(i + 1) * per])
                                  for i in range(5))
        dos = [do.contiguous() for do in dos]  # the kernels' layout
        deltas = [(do.float() * o.float()).sum(dim=-1)
                  for do, o in zip(dos, outs)]
        dq, dk, dv = _ring_bwd(qs, ks, vs, dos, lses, deltas, mesh,
                               axis, causal, sm_scale, window)
        return (None,) * 6 + tuple(
            [g.to(q.dtype) for g, q in zip(dq, qs)]
            + [g.to(k.dtype) for g, k in zip(dk, ks)]
            + [g.to(v.dtype) for g, v in zip(dv, vs)])


def ring_attention_slots(qs, ks, vs, mesh, axis_name: str = "sp", *,
                         causal: bool = True,
                         sm_scale: Optional[float] = None,
                         window: Optional[int] = None) -> list:
    """Ring attention over the slots of this process: ``qs``/``ks``/``vs``
    hold each slot's sequence block (``[B, Hq, t, D]`` and grouped ``[B,
    Hkv, t, D]``), in slot order; the ring runs along ``axis_name`` in
    every group of slots that share the other coordinates.  Returns the
    slots' output blocks.  Differentiable (the module docstring)."""
    _check_mesh(qs[0], mesh, axis_name)
    if window is not None:
        if not causal:
            raise ValueError("window requires causal attention")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if sm_scale is None:
        sm_scale = 1.0 / (qs[0].shape[-1] ** 0.5)
    blocks = [x.contiguous() for x in (*qs, *ks, *vs)]
    return list(_Ring.apply(mesh, axis_name, bool(causal), float(sm_scale),
                            None if window is None else int(window),
                            len(qs), *blocks))


def ring_attention(q, k, v, mesh, axis_name: str = "sp", *,
                   causal: bool = True, sm_scale: Optional[float] = None,
                   window: Optional[int] = None):
    """Ring attention over this process's slice of the sequence: q
    ``[B, Hq, T_proc, D]``, grouped k/v ``[B, Hkv, T_proc, D]`` (the ring
    rotates the narrow kv shards; the kernels index the head groups), in
    natural order.  Returns the output slice in q's dtype.  After step
    ``i`` shard ``my`` holds kv shard ``(my - i) mod n``; global offsets
    feed the causal mask.  Differentiable (the module docstring).

    ``window`` (requires ``causal``): Mistral-style sliding band; ring
    steps wholly out of the band are skipped and the rotations stop after
    it, so the work scales with the band, not the sequence."""
    _check_mesh(q, mesh, axis_name)
    per = len(axis_index(mesh, axis_name))
    if q.shape[2] % per or k.shape[2] != q.shape[2]:
        raise ValueError(f"sequence {q.shape[2]} (k/v {k.shape[2]}) does "
                         f"not split into {per} shards")
    spec = (None, None, axis_name, None)
    outs = ring_attention_slots(
        *(cut_blocks(x, mesh, spec) for x in (q, k, v)), mesh, axis_name,
        causal=causal, sm_scale=sm_scale, window=window)
    return join_blocks(outs, mesh, spec)


# ------------------------------------------------------------ zigzag ring


def zigzag_indices(s: int, n: int) -> np.ndarray:
    """Global sequence permutation for the zigzag causal layout: shard
    ``d`` holds blocks ``d`` and ``2n - 1 - d`` of ``2n`` equal blocks, so
    every shard has the same causal work at every step (Brandon et al.,
    Striped Attention, arXiv:2311.09431).  Returns the gather indices
    (length ``s``, requires ``2n | s``); invert with ``np.argsort``."""
    if s % (2 * n):
        raise ValueError(f"zigzag needs sequence length divisible by "
                         f"2n={2 * n}, got {s}")
    sb = s // (2 * n)
    blocks = []
    for d in range(n):
        blocks += [d, 2 * n - 1 - d]
    return np.concatenate([np.arange(b * sb, (b + 1) * sb) for b in blocks])


def _zz_fwd(qs, ks, vs, mesh, axis, sm_scale):
    """Shards are ``[2, B, H, sb, D]``: the front (lo) and back (hi)
    half-blocks."""
    n = axis_size(mesh, axis)
    sb = qs[0].shape[3]
    acc_lo, acc_hi = [None] * len(qs), [None] * len(qs)
    k_cur, v_cur = ks, vs
    for i in range(n):
        for j, my in enumerate(axis_index(mesh, axis)):
            src = (my - i) % n
            off_lo, off_hi = my * sb, (2 * n - 1 - my) * sb
            src_lo, src_hi = src * sb, (2 * n - 1 - src) * sb
            (q_lo, q_hi), (k_lo, k_hi), (v_lo, v_hi) = qs[j], k_cur[j], v_cur[j]
            # Back blocks see every front block: this pair needs no mask.
            acc_hi[j] = _merge(acc_hi[j], flash_partial(
                q_hi, k_lo, v_lo, off_hi, src_lo, causal=False,
                sm_scale=sm_scale))
            if my >= src:  # live, diagonal at equality
                acc_lo[j] = _merge(acc_lo[j], flash_partial(
                    q_lo, k_lo, v_lo, off_lo, src_lo, causal=True,
                    sm_scale=sm_scale))
            if my <= src:
                acc_hi[j] = _merge(acc_hi[j], flash_partial(
                    q_hi, k_hi, v_hi, off_hi, src_hi, causal=True,
                    sm_scale=sm_scale))
            # Front queries never see back keys: that pair never runs.
        if i < n - 1:
            k_cur = ring_shift(k_cur, mesh, axis, 1)
            v_cur = ring_shift(v_cur, mesh, axis, 1)
    dt = qs[0].dtype
    outs = [torch.stack([finalize_partial(*lo, out_dtype=dt),
                         finalize_partial(*hi, out_dtype=dt)])
            for lo, hi in zip(acc_lo, acc_hi)]
    lses = [torch.stack([_lse_of(lo), _lse_of(hi)])
            for lo, hi in zip(acc_lo, acc_hi)]
    return outs, lses


def _zz_bwd(qs, ks, vs, dos, lses, deltas, mesh, axis, sm_scale):
    n = axis_size(mesh, axis)
    sb = qs[0].shape[3]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
          for k in ks]
    dv = [torch.zeros_like(x) for x in dk]
    k_cur, v_cur = ks, vs
    for i in range(n):
        for j, my in enumerate(axis_index(mesh, axis)):
            src = (my - i) % n
            off_lo, off_hi = my * sb, (2 * n - 1 - my) * sb
            src_lo, src_hi = src * sb, (2 * n - 1 - src) * sb
            q, do, lse, dl = qs[j], dos[j], lses[j], deltas[j]
            kc, vc = k_cur[j], v_cur[j]

            def step(a, b, q_off, kv_off, causal):
                g = flash_partial_bwd(q[a], do[a], kc[b], vc[b], lse[a],
                                      dl[a], q_off, kv_off, causal=causal,
                                      sm_scale=sm_scale)
                dq[j][a].add_(g[0])
                dk[j][b].add_(g[1])
                dv[j][b].add_(g[2])

            step(1, 0, off_hi, src_lo, False)  # hi-lo: always live
            if my >= src:
                step(0, 0, off_lo, src_lo, True)
            if my <= src:
                step(1, 1, off_hi, src_hi, True)
        if i < n - 1:
            k_cur, v_cur, dk, dv = (ring_shift(x, mesh, axis, 1)
                                    for x in (k_cur, v_cur, dk, dv))
    return dq, ring_shift(dk, mesh, axis, 1), ring_shift(dv, mesh, axis, 1)


def _halves(x):
    """A zigzag slot block ``[B, H, 2 sb, D]`` -> ``[2, B, H, sb, D]``."""
    b, h, t, d = x.shape
    return x.reshape(b, h, 2, t // 2, d).permute(2, 0, 1, 3, 4).contiguous()


def _unhalves(x):
    """Inverse of :func:`_halves`."""
    _, b, h, sb, d = x.shape
    return x.permute(1, 2, 0, 3, 4).reshape(b, h, 2 * sb, d)


class _Zigzag(torch.autograd.Function):
    """The JAX package's ``_zigzag`` custom_vjp, over the slots of a
    process."""

    @staticmethod
    def forward(ctx, mesh, axis, sm_scale, per, *blocks):
        qs, ks, vs = ([_halves(x) for x in blocks[i * per:(i + 1) * per]]
                      for i in range(3))
        outs, lses = _zz_fwd(qs, ks, vs, mesh, axis, sm_scale)
        ctx.save_for_backward(*qs, *ks, *vs, *lses, *outs)
        ctx.cfg = (mesh, axis, sm_scale, per)
        return tuple(_unhalves(o) for o in outs)

    @staticmethod
    def backward(ctx, *dos):
        mesh, axis, sm_scale, per = ctx.cfg
        saved = ctx.saved_tensors
        qs, ks, vs, lses, outs = (list(saved[i * per:(i + 1) * per])
                                  for i in range(5))
        dos = [_halves(do) for do in dos]
        deltas = [(do.float() * o.float()).sum(dim=-1)
                  for do, o in zip(dos, outs)]
        dq, dk, dv = _zz_bwd(qs, ks, vs, dos, lses, deltas, mesh, axis,
                             sm_scale)
        return (None,) * 4 + tuple(
            [_unhalves(g).to(q.dtype) for g, q in zip(dq, qs)]
            + [_unhalves(g).to(k.dtype) for g, k in zip(dk, ks)]
            + [_unhalves(g).to(v.dtype) for g, v in zip(dv, vs)])


def zigzag_ring_attention_slots(qs, ks, vs, mesh, axis_name: str = "sp", *,
                                sm_scale: Optional[float] = None) -> list:
    """Causal zigzag ring attention over the slots of this process: each
    slot's block holds, in order, sequence blocks ``my`` and ``2n - 1 -
    my`` of ``2n`` (:func:`zigzag_indices`).  Differentiable."""
    _check_mesh(qs[0], mesh, axis_name)
    if qs[0].shape[2] % 2:
        raise ValueError(f"zigzag slot blocks need two equal halves, got "
                         f"{qs[0].shape[2]} rows")
    if sm_scale is None:
        sm_scale = 1.0 / (qs[0].shape[-1] ** 0.5)
    return list(_Zigzag.apply(mesh, axis_name, float(sm_scale), len(qs),
                              *qs, *ks, *vs))


def zigzag_ring_attention(q, k, v, mesh, axis_name: str = "sp", *,
                          sm_scale: Optional[float] = None):
    """Causal ring attention over this process's slice in the zigzag
    layout (:func:`zigzag_indices`): each shard's first half is block
    ``my`` of the sequence, its second half block ``2n - 1 - my``.  Per
    step the four (q half, kv half) pairs are fully live (back q, front
    kv: no mask), diagonal or live (front-front while ``my >= src``,
    back-back while ``my <= src``), or never live (front q, back kv), and
    only the live ones run.  Differentiable (the module docstring)."""
    _check_mesh(q, mesh, axis_name)
    per = len(mesh.local_range(axis_name))
    if q.shape[2] % (2 * per) or k.shape[2] != q.shape[2]:
        raise ValueError(f"zigzag shards need two equal halves: sequence "
                         f"{q.shape[2]} (k/v {k.shape[2]}) over {per} "
                         f"shards")
    spec = (None, None, axis_name, None)
    outs = zigzag_ring_attention_slots(
        *(cut_blocks(x, mesh, spec) for x in (q, k, v)), mesh, axis_name,
        sm_scale=sm_scale)
    return join_blocks(outs, mesh, spec)


def zigzag_wrap(inner, n: int):
    """Wrap a zigzag-layout attention callable so that it takes and returns
    natural-order sequences: permutes q/k/v into the zigzag order, runs
    ``inner``, inverts the permutation on the output."""

    def fn(q, k, v):
        perm = torch.from_numpy(zigzag_indices(q.shape[2], n)).to(q.device)
        inv = torch.argsort(perm)
        out = inner(*(x.index_select(2, perm) for x in (q, k, v)))
        return out.index_select(2, inv)

    return fn


def make_zigzag_ring_attention(mesh, axis_name: str = "sp", *,
                               sm_scale: Optional[float] = None):
    """Causal zigzag ring attention on natural-order sequences ``[B, H, S,
    D]`` (this process's slice on a mesh with a process group): the
    permutation into and out of the zigzag order wraps
    :func:`zigzag_ring_attention`.  Across processes the permutation moves
    tokens between them: each slot gathers the sequence over the axis
    (a differentiable ``all_gather``), takes its zigzag blocks, and gathers
    the outputs back before the inverse permutation."""
    from ..ops.collectives import all_gather

    n = mesh.shape[axis_name]
    if mesh.world == 1:
        def local(q, k, v):
            return zigzag_ring_attention(q, k, v, mesh, axis_name,
                                         sm_scale=sm_scale)

        return zigzag_wrap(local, n)
    spec = (None, None, axis_name, None)

    def fn(q, k, v):
        mine = axis_index(mesh, axis_name)
        whole = [all_gather(cut_blocks(x, mesh, spec), mesh, axis_name, 2)
                 for x in (q, k, v)]
        s_len = whole[0][0].shape[2]
        perm = torch.from_numpy(zigzag_indices(s_len, n)).to(q.device)
        t = s_len // n
        blocks = [[x.index_select(2, perm[i * t:(i + 1) * t])
                   for x, i in zip(xs, mine)] for xs in whole]
        outs = all_gather(zigzag_ring_attention_slots(
            *blocks, mesh, axis_name, sm_scale=sm_scale), mesh, axis_name, 2)
        inv = torch.argsort(perm)
        return join_blocks([o.index_select(2, inv)[:, :, i * t:(i + 1) * t]
                            for o, i in zip(outs, mine)], mesh, spec)

    return fn


def make_ring_attention(mesh, axis_name: str = "sp", *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None):
    """:func:`ring_attention` bound to a mesh: ``fn(q, k, v)`` on this
    process's natural-order slice (the whole sequence on a mesh without a
    group)."""

    def fn(q, k, v):
        return ring_attention(q, k, v, mesh, axis_name, causal=causal,
                              sm_scale=sm_scale, window=window)

    return fn
