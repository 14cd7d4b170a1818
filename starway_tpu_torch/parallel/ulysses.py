"""Ulysses-style sequence parallelism: all-to-all head/sequence re-sharding.

Port of the JAX package's ``parallel/ulysses.py``, the second long-context
strategy beside ring attention.  Where the ring keeps queries resident and
rotates kv, Ulysses re-shards: an all-to-all over the sequence axis turns
[heads: whole, sequence: cut] into [heads: cut, sequence: whole], the
attention runs locally over the whole sequence, and a reverse all-to-all
restores the layout (ops/collectives.py; each is differentiable).

Requires ``n_heads % axis_size == 0``.  Grouped kv stays narrow across the
all-to-all whenever ``n_kv_heads % axis_size == 0``: the collectives move
``1 / n_rep`` of the expanded traffic, and the slot that gets q heads
``[d H / n, (d + 1) H / n)`` gets exactly their kv heads; otherwise kv is
expanded first so the head shards align.

The local attention is the flash kernel (ops/flash.py: the forward and,
under autograd, its two backward passes) on CUDA tensors, and the
blockwise loop on the CPU.
"""

from __future__ import annotations

from typing import Optional

from ..ops.attention import blockwise_attention, repeat_kv
from ..ops.collectives import all_gather, all_to_all, axis_index


def _local_attention(q, k, v, causal, sm_scale, window):
    if q.is_cuda:
        from ..ops.flash import flash_attention

        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal,
                               sm_scale=sm_scale, window=window)
    return blockwise_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               window=window)


def ulysses_attention(qs, ks, vs, mesh, axis_name: str = "sp", *,
                      causal: bool = True, sm_scale: Optional[float] = None,
                      window: Optional[int] = None) -> list:
    """Ulysses attention over this process's slots: ``qs``/``ks``/``vs``
    hold each slot's sequence block ``[B, H, T_local, D]`` with the whole
    head dimension (the JAX package's per-device body); returns each
    slot's block of the output.

    ``window``: sliding band.  After the re-shard each slot holds the whole
    sequence of its heads, so the band is the local attention's mask."""
    if window is not None and not causal:
        raise ValueError("window requires causal attention")
    n = mesh.shape[axis_name]
    if qs[0].shape[1] % n:
        raise ValueError(f"n_heads={qs[0].shape[1]} does not split over "
                         f"{axis_name}={n}")
    n_rep = qs[0].shape[1] // ks[0].shape[1]
    if n_rep > 1 and ks[0].shape[1] % n:
        # Narrow heads do not split evenly over the axis: expand first.
        ks = [repeat_kv(k, n_rep) for k in ks]
        vs = [repeat_kv(v, n_rep) for v in vs]
    # [B, H, T/n, D] -> [B, H/n, T, D]: scatter heads, gather sequence.
    q2, k2, v2 = (all_to_all(x, mesh, axis_name, 1, 2) for x in (qs, ks, vs))
    o2 = [_local_attention(q, k, v, causal, sm_scale, window)
          for q, k, v in zip(q2, k2, v2)]
    # Restore: [B, H/n, T, D] -> [B, H, T/n, D].
    return all_to_all(o2, mesh, axis_name, 2, 1)


def make_ulysses_attention(mesh, axis_name: str = "sp", *,
                           causal: bool = True,
                           sm_scale: Optional[float] = None,
                           window: Optional[int] = None):
    """Global-view Ulysses attention: ``fn(q, k, v)`` on the whole
    sequence ``[B, H, S, D]`` (this process's slice of it on a mesh with a
    process group), cut over ``axis_name``.  Its ``slots(qs, ks, vs)``
    takes the slots' whole-sequence tensors of a sharded tree's forward
    (models/sharded.py) and returns each slot's whole output.  ``window``:
    sliding band (see :func:`ulysses_attention`; the fn declares
    ``handles_window``)."""
    from .sharding import cut_blocks, join_blocks

    if window is not None and not causal:
        # Fail at build, not at the first call (as make_sharded_attn does).
        raise ValueError("window requires causal attention")
    spec = (None, None, axis_name, None)

    def run(qs, ks, vs):
        return ulysses_attention(qs, ks, vs, mesh, axis_name, causal=causal,
                                 sm_scale=sm_scale, window=window)

    def fn(q, k, v):
        return join_blocks(run(*(cut_blocks(x, mesh, spec)
                                 for x in (q, k, v))), mesh, spec)

    def slots(qs, ks, vs):
        n = mesh.shape[axis_name]
        t = qs[0].shape[2] // n
        mine = axis_index(mesh, axis_name)
        blocks = [[x[:, :, i * t:(i + 1) * t] for x, i in zip(xs, mine)]
                  for xs in (qs, ks, vs)]
        return all_gather(run(*blocks), mesh, axis_name, 2)

    fn.slots = slots
    fn.mesh = mesh
    if window is not None:
        # resolve_attn_fn's windowed-config contract (models/llama.py).
        fn.handles_window = True
        fn.window = window
    return fn
