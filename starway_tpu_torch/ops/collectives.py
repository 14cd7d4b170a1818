"""Mesh collectives of the port, over the port's mesh
(parallel/sharding.py).

Port of the JAX package's ``ops/collectives.py``: ``axis_size``,
``axis_index``, ``ring_shift`` (the rotation of ring attention),
``all_to_all`` (the expert dispatch of MoE, Ulysses and the KV-cache
shuffle), ``all_gather``, ``psum``, ``pmean``, ``reduce_scatter`` and
``ring_reduce``, and ``broadcast`` from one coordinate (a pipeline's head
gradient and input cotangent).  A collective takes the list of this process's slots of
one tensor, in slot order (parallel/sharding.py ``Mesh.local_slots``), and
returns the list after the exchange.  On a mesh of several axes it works
along one axis: within each group of slots that share every other
coordinate, as ``shard_map``'s collectives do.  Slots that stay in the
process only move in the list; a slot that crosses to another process
goes by ``torch.distributed`` point-to-point (``batch_isend_irecv``: gloo
on the CPU, NCCL across cards).  Both sides of a process pair post their
messages in the order of ``(source slot, destination slot)``, so NCCL,
which ignores tags, pairs them as gloo does.  Reductions add the slots in
the order of their coordinate along the axis, so every slot of a group
receives the same bits.

Every collective is a ``torch.autograd.Function`` whose backward is its
adjoint, computed by the same exchanges (``psum`` <-> ``psum``,
``all_gather`` <-> ``reduce_scatter``, ``all_to_all`` <-> the inverse
``all_to_all``, ``ring_shift(s)`` <-> ``ring_shift(-s)``): a training step
whose slots sit in several processes differentiates through them, and
gives the bits of the one-process run, whose backward runs the same
arithmetic.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.profiler import record_function

# The profiler range around every collective and its adjoint: a trace
# attributes to it the device time of the copies and sums it launches.
RANGE = "collective"


def axis_size(mesh, axis: str) -> int:
    """Number of slots along ``axis``."""
    return mesh.shape[axis]


def axis_index(mesh, axis: str) -> list:
    """The coordinate along ``axis`` of each of this process's slots, in
    slot order (a process may hold several)."""
    return [mesh.slot_coords(i)[axis] for i in mesh.local_slots]


def _check(shards, mesh, axis: str) -> None:
    if axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    if len(shards) != len(mesh.local_slots):
        raise ValueError(f"{len(shards)} shards given; this process holds "
                         f"{len(mesh.local_slots)} slots of the mesh "
                         f"{mesh.shape}")


def _peer(mesh, index: int, axis: str, coord: int) -> int:
    """The slot of ``index``'s group along ``axis`` at ``coord``."""
    c = mesh.slot_coords(index)
    c[axis] = coord
    return mesh.slot_at(c)


def _post(ops) -> None:
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _raw_ring_shift(shards, mesh, axis: str, shift: int) -> list:
    n = mesh.shape[axis]
    shift %= n
    if shift == 0:
        return list(shards)
    local = mesh.local_slots
    out = [None] * len(local)
    ops = []
    for src in range(mesh.size):  # every (source, destination) pair
        dst = _peer(mesh, src, axis, (mesh.slot_coords(src)[axis] + shift)
                    % n)
        if src in local and dst in local:
            out[dst - local.start] = shards[src - local.start]
        elif src in local:
            ops.append(dist.P2POp(dist.isend,
                                  shards[src - local.start].contiguous(),
                                  mesh.rank_of(dst), mesh.group, tag=dst))
        elif dst in local:
            like = shards[0]
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device=like.device)
            out[dst - local.start] = buf
            ops.append(dist.P2POp(dist.irecv, buf, mesh.rank_of(src),
                                  mesh.group, tag=dst))
    _post(ops)
    return out


def _exchange(blocks, mesh, axis: str) -> list:
    """``blocks[s][j]``: what local slot ``s`` sends to the slot at
    coordinate ``j`` of its group (all of one shape and dtype).  Returns
    ``got`` with ``got[s][i]`` what local slot ``s`` received from the
    slot at coordinate ``i``."""
    n = mesh.shape[axis]
    local = mesh.local_slots
    got = [[None] * n for _ in local]
    like = blocks[0][0]
    ops = []
    for src in range(mesh.size):
        i = mesh.slot_coords(src)[axis]
        for j in range(n):
            dst = _peer(mesh, src, axis, j)
            if src in local and dst in local:
                got[dst - local.start][i] = blocks[src - local.start][j]
            elif src in local:
                ops.append(dist.P2POp(
                    dist.isend, blocks[src - local.start][j].contiguous(),
                    mesh.rank_of(dst), mesh.group, tag=src * n + j))
            elif dst in local:
                buf = torch.empty(like.shape, dtype=like.dtype,
                                  device=like.device)
                got[dst - local.start][i] = buf
                ops.append(dist.P2POp(dist.irecv, buf, mesh.rank_of(src),
                                      mesh.group, tag=src * n + j))
    _post(ops)
    return got


def _sum(blocks):
    out = blocks[0]
    for b in blocks[1:]:
        out = out + b
    return out


def _raw_all_to_all(shards, mesh, axis, split_axis, concat_axis, tiled):
    n = mesh.shape[axis]
    if tiled:
        blocks = [list(x.chunk(n, dim=split_axis)) for x in shards]
    else:
        blocks = [list(x.unbind(split_axis)) for x in shards]
    join = torch.cat if tiled else torch.stack
    return [join(got, dim=concat_axis)
            for got in _exchange(blocks, mesh, axis)]


def _raw_all_gather(shards, mesh, axis, dim, tiled):
    n = mesh.shape[axis]
    join = torch.cat if tiled else torch.stack
    return [join(got, dim=dim) for got in
            _exchange([[x] * n for x in shards], mesh, axis)]


def _raw_psum(shards, mesh, axis):
    n = mesh.shape[axis]
    return [_sum(got) for got in
            _exchange([[x] * n for x in shards], mesh, axis)]


def _raw_reduce_scatter(shards, mesh, axis, dim, tiled):
    n = mesh.shape[axis]
    if tiled:
        blocks = [list(x.chunk(n, dim=dim)) for x in shards]
    else:
        blocks = [list(x.unbind(dim)) for x in shards]
    return [_sum(got) for got in _exchange(blocks, mesh, axis)]


class _Collective(torch.autograd.Function):
    """``fwd(list) -> list`` with the adjoint ``bwd(list) -> list`` over
    the slots of a process."""

    @staticmethod
    def forward(ctx, fwd, bwd, *shards):
        ctx.bwd = bwd
        out = fwd(list(shards))
        # An output that is an input unchanged (a slot that stays in its
        # place) leaves as a view, so autograd keeps the two apart.
        ids = {id(x) for x in shards}
        return tuple(y.view_as(y) if id(y) in ids else y for y in out)

    @staticmethod
    def backward(ctx, *grads):  # missing cotangents arrive as zeros
        with record_function(RANGE):
            return (None, None) + tuple(ctx.bwd(list(grads)))


def _apply(fwd, bwd, shards) -> list:
    with record_function(RANGE):
        if not any(isinstance(x, torch.Tensor) and x.requires_grad
                   for x in shards) or not torch.is_grad_enabled():
            return fwd(list(shards))
        return list(_Collective.apply(fwd, bwd, *shards))


def ring_shift(shards, mesh, axis: str, shift: int = 1) -> list:
    """Rotate slots around the ring of ``axis``: the slot at coordinate
    ``i`` moves to ``(i + shift) % n`` of its group.  ``shards`` is this
    process's list, in slot order; all have one shape and dtype."""
    _check(shards, mesh, axis)
    return _apply(lambda xs: _raw_ring_shift(xs, mesh, axis, shift),
                  lambda gs: _raw_ring_shift(gs, mesh, axis, -shift), shards)


def all_to_all(shards, mesh, axis: str, split_axis: int, concat_axis: int,
               *, tiled: bool = True) -> list:
    """Transpose slot ownership: each slot is cut along ``split_axis``
    into one block per slot of its group along ``axis``, block ``j`` goes
    to coordinate ``j``, and each slot joins what it receives, in the
    order of the senders, along ``concat_axis``.  ``tiled``: blocks are
    slices (``split_axis`` shrinks n times, ``concat_axis`` grows n
    times); otherwise ``split_axis`` must have size n, each block drops it
    and the received blocks are stacked on a new ``concat_axis``
    (``lax.all_to_all``'s shapes)."""
    _check(shards, mesh, axis)
    n = mesh.shape[axis]
    for x in shards:
        size = x.shape[split_axis]
        if (size % n) if tiled else (size != n):
            raise ValueError(
                f"split axis {split_axis} of size {size} does not "
                f"{'divide into' if tiled else 'equal'} {n} shards of "
                f"{axis!r}")
    return _apply(
        lambda xs: _raw_all_to_all(xs, mesh, axis, split_axis, concat_axis,
                                   tiled),
        lambda gs: _raw_all_to_all(gs, mesh, axis, concat_axis, split_axis,
                                   tiled), shards)


def all_gather(shards, mesh, axis: str, dim: int = 0, *,
               tiled: bool = True) -> list:
    """Every slot receives all slots of its group along ``axis`` in
    order, concatenated along ``dim`` (``tiled``) or stacked on a new
    ``dim``."""
    _check(shards, mesh, axis)
    return _apply(
        lambda xs: _raw_all_gather(xs, mesh, axis, dim, tiled),
        lambda gs: _raw_reduce_scatter(gs, mesh, axis, dim, tiled), shards)


def psum(shards, mesh, axis) -> list:
    """Every slot receives the sum of all slots of its group along
    ``axis`` (a name, or a tuple of names: one sum after another, in the
    order given)."""
    for name in ((axis,) if isinstance(axis, str) else tuple(axis)):
        _check(shards, mesh, name)
        shards = _apply(lambda xs, a=name: _raw_psum(xs, mesh, a),
                        lambda gs, a=name: _raw_psum(gs, mesh, a), shards)
    return list(shards)


def pmean(shards, mesh, axis) -> list:
    """Every slot receives the mean of all slots of its group along
    ``axis`` (a name or a tuple of names)."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    n = 1
    for name in names:
        n *= mesh.shape[name]
    return [s / n for s in psum(shards, mesh, names)]


def reduce_scatter(shards, mesh, axis: str, scatter_axis: int = 0) -> list:
    """The sum of all slots of the group along ``axis``, cut along
    ``scatter_axis`` into n blocks: the slot at coordinate ``j`` receives
    block ``j`` (``lax.psum_scatter`` tiled)."""
    _check(shards, mesh, axis)
    n = mesh.shape[axis]
    for x in shards:
        if x.shape[scatter_axis] % n:
            raise ValueError(f"scatter axis {scatter_axis} of size "
                             f"{x.shape[scatter_axis]} does not divide into "
                             f"{n} shards of {axis!r}")
    return _apply(
        lambda xs: _raw_reduce_scatter(xs, mesh, axis, scatter_axis, True),
        lambda gs: _raw_all_gather(gs, mesh, axis, scatter_axis, True),
        shards)


def broadcast(shards, mesh, axis: str, coord: int, like=None) -> list:
    """Every slot receives the slot at coordinate ``coord`` of its group
    along ``axis``: the ``psum`` of a value that only ``coord`` holds,
    without the sum.  The entries of the other slots are not read and may
    be None; ``like``, a tensor of the value's shape and dtype (a ``meta``
    one will do), shapes what a process that holds no slot at ``coord``
    receives on the mesh's device.  Slots of one process share the
    tensor; it has no adjoint (values outside autograd)."""
    local = mesh.local_slots
    out = [None] * len(local)
    ops = []
    for dst in range(mesh.size):
        src = _peer(mesh, dst, axis, coord)
        if src in local and dst in local:
            out[dst - local.start] = shards[src - local.start]
        elif src in local:
            ops.append(dist.P2POp(dist.isend,
                                  shards[src - local.start].contiguous(),
                                  mesh.rank_of(dst), mesh.group, tag=dst))
        elif dst in local:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device=mesh.device)
            out[dst - local.start] = buf
            ops.append(dist.P2POp(dist.irecv, buf, mesh.rank_of(src),
                                  mesh.group, tag=dst))
    _post(ops)
    return out


def ring_reduce(shards, mesh, axis: str, op=None) -> list:
    """All-reduce built from ``n - 1`` :func:`ring_shift` steps: each slot
    combines (``op``, default addition) what passes it around the ring, so
    the slot at ``i`` sums in the order ``i, i - 1, ..., i + 1``."""
    _check(shards, mesh, axis)
    n = mesh.shape[axis]
    if op is None:
        op = torch.add
    acc, buf = list(shards), list(shards)
    for _ in range(n - 1):
        buf = ring_shift(buf, mesh, axis, 1)
        acc = [op(a, b) for a, b in zip(acc, buf)]
    return acc
