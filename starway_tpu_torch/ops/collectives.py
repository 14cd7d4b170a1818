"""Mesh collectives of the port: the ring rotation of ring attention.

Port of the JAX package's ``ops/collectives.py`` (``axis_size``,
``axis_index``, ``ring_shift``) over the port's mesh
(parallel/sharding.py).  A collective takes the list of this process's
shards of one tensor along a mesh axis and returns the list after the
exchange.  Shards that stay in the process only move in the list; a shard
that crosses to another process goes by ``torch.distributed``
point-to-point (``batch_isend_irecv``).  The rest of the JAX file
(``all_to_all``, ``psum``, ``ring_reduce`` and the others) waits for the
rest of the parallel layer (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size(mesh, axis: str) -> int:
    """Number of shards along ``axis``."""
    return mesh.shape[axis]


def axis_index(mesh, axis: str) -> range:
    """Global indices of this process's shards along ``axis`` (one index
    per shard: a process may hold several)."""
    return mesh.local_range(axis)


def ring_shift(shards, mesh, axis: str, shift: int = 1) -> list:
    """Rotate shards around the ring of ``axis``: shard ``i`` moves to
    position ``(i + shift) % n``.  ``shards`` is this process's list, in
    the order of :func:`axis_index`; all have one shape and dtype."""
    n = mesh.shape[axis]
    local = mesh.local_range(axis)
    if len(shards) != len(local):
        raise ValueError(f"{len(shards)} shards given; this process holds "
                         f"{len(local)} of axis {axis!r}")
    shift %= n
    if shift == 0:
        return list(shards)
    per = len(local)
    out, ops = [], []
    for g in local:  # receives, in the order of the receiving position
        src = (g - shift) % n
        if src in local:
            out.append(shards[src - local.start])
        else:
            buf = torch.empty_like(shards[0])
            out.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf,
                                  mesh.global_rank(src // per), mesh.group,
                                  tag=g))
    for j, g in enumerate(local):  # sends, in the order of the destination
        dst = (g + shift) % n
        if dst not in local:
            ops.append(dist.P2POp(dist.isend, shards[j],
                                  mesh.global_rank(dst // per), mesh.group,
                                  tag=dst))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out
