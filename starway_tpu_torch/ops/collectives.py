"""Mesh collectives of the port, over the port's mesh
(parallel/sharding.py).

Port of the JAX package's ``ops/collectives.py``: ``axis_size``,
``axis_index``, ``ring_shift`` (the rotation of ring attention),
``all_to_all`` (the expert dispatch of MoE and the KV-cache shuffle),
``all_gather``, ``psum``, ``pmean``, ``reduce_scatter`` and
``ring_reduce``.  A collective takes the list of this process's shards of
one tensor along a mesh axis, in the order of :func:`axis_index`, and
returns the list after the exchange.  Shards that stay in the process only
move in the list; a shard that crosses to another process goes by
``torch.distributed`` point-to-point (``batch_isend_irecv``: gloo on the
CPU, NCCL across cards).  Reductions add the shards in the order of their
global index, so every shard receives the same bits.
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


def _check(shards, mesh, axis: str) -> range:
    local = mesh.local_range(axis)
    if len(shards) != len(local):
        raise ValueError(f"{len(shards)} shards given; this process holds "
                         f"{len(local)} of axis {axis!r}")
    return local


def ring_shift(shards, mesh, axis: str, shift: int = 1) -> list:
    """Rotate shards around the ring of ``axis``: shard ``i`` moves to
    position ``(i + shift) % n``.  ``shards`` is this process's list, in
    the order of :func:`axis_index`; all have one shape and dtype."""
    n = mesh.shape[axis]
    local = _check(shards, mesh, axis)
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


def _exchange(blocks, mesh, axis: str) -> list:
    """``blocks[s][j]``: what local shard ``s`` sends to global shard
    ``j`` (all of one shape and dtype).  Returns ``got`` with
    ``got[s][i]`` what local shard ``s`` received from global shard ``i``.
    Both sides of a process pair post their messages in the order of
    ``(i, j)``, so NCCL, which ignores tags, pairs them as gloo does."""
    n = mesh.shape[axis]
    local = mesh.local_range(axis)
    per = len(local)
    got = [[None] * n for _ in local]
    ops = []
    for i in range(n):
        for j in range(n):
            if i in local and j in local:
                got[j - local.start][i] = blocks[i - local.start][j]
            elif i in local:
                ops.append(dist.P2POp(
                    dist.isend, blocks[i - local.start][j].contiguous(),
                    mesh.global_rank(j // per), mesh.group, tag=i * n + j))
            elif j in local:
                like = blocks[0][0]
                buf = torch.empty(like.shape, dtype=like.dtype,
                                  device=like.device)
                got[j - local.start][i] = buf
                ops.append(dist.P2POp(dist.irecv, buf,
                                      mesh.global_rank(i // per), mesh.group,
                                      tag=i * n + j))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


def all_to_all(shards, mesh, axis: str, split_axis: int, concat_axis: int,
               *, tiled: bool = True) -> list:
    """Transpose shard ownership: each shard is cut along ``split_axis``
    into one block per shard of ``axis``, block ``j`` goes to shard ``j``,
    and each shard joins what it receives, in the order of the senders,
    along ``concat_axis``.  ``tiled``: blocks are slices (``split_axis``
    shrinks n times, ``concat_axis`` grows n times); otherwise
    ``split_axis`` must have size n, each block drops it and the received
    blocks are stacked on a new ``concat_axis`` (``lax.all_to_all``'s
    shapes)."""
    _check(shards, mesh, axis)
    n = mesh.shape[axis]
    for x in shards:
        size = x.shape[split_axis]
        if (size % n) if tiled else (size != n):
            raise ValueError(
                f"split axis {split_axis} of size {size} does not "
                f"{'divide into' if tiled else 'equal'} {n} shards of "
                f"{axis!r}")
    if tiled:
        blocks = [list(x.chunk(n, dim=split_axis)) for x in shards]
    else:
        blocks = [list(x.unbind(split_axis)) for x in shards]
    join = torch.cat if tiled else torch.stack
    return [join(got, dim=concat_axis)
            for got in _exchange(blocks, mesh, axis)]


def all_gather(shards, mesh, axis: str, dim: int = 0, *,
               tiled: bool = True) -> list:
    """Every shard receives all shards of ``axis`` in order, concatenated
    along ``dim`` (``tiled``) or stacked on a new ``dim``."""
    _check(shards, mesh, axis)
    n = mesh.shape[axis]
    join = torch.cat if tiled else torch.stack
    return [join(got, dim=dim) for got in
            _exchange([[x] * n for x in shards], mesh, axis)]


def _sum(blocks):
    out = blocks[0]
    for b in blocks[1:]:
        out = out + b
    return out


def psum(shards, mesh, axis: str) -> list:
    """Every shard receives the sum of all shards of ``axis``."""
    _check(shards, mesh, axis)
    n = mesh.shape[axis]
    return [_sum(got) for got in
            _exchange([[x] * n for x in shards], mesh, axis)]


def pmean(shards, mesh, axis: str) -> list:
    """Every shard receives the mean of all shards of ``axis``."""
    n = mesh.shape[axis]
    return [s / n for s in psum(shards, mesh, axis)]


def reduce_scatter(shards, mesh, axis: str, scatter_axis: int = 0) -> list:
    """The sum of all shards of ``axis``, cut along ``scatter_axis`` into n
    blocks: shard ``j`` receives block ``j`` (``lax.psum_scatter`` tiled)."""
    _check(shards, mesh, axis)
    n = mesh.shape[axis]
    for x in shards:
        if x.shape[scatter_axis] % n:
            raise ValueError(f"scatter axis {scatter_axis} of size "
                             f"{x.shape[scatter_axis]} does not divide into "
                             f"{n} shards of {axis!r}")
    blocks = [list(x.chunk(n, dim=scatter_axis)) for x in shards]
    return [_sum(got) for got in _exchange(blocks, mesh, axis)]


def ring_reduce(shards, mesh, axis: str, op=None) -> list:
    """All-reduce built from ``n - 1`` :func:`ring_shift` steps: each shard
    combines (``op``, default addition) what passes it around the ring, so
    shard ``i`` sums in the order ``i, i - 1, ..., i + 1``."""
    _check(shards, mesh, axis)
    n = mesh.shape[axis]
    if op is None:
        op = torch.add
    acc, buf = list(shards), list(shards)
    for _ in range(n - 1):
        buf = ring_shift(buf, mesh, axis, 1)
        acc = [op(a, b) for a, b in zip(acc, buf)]
    return acc
