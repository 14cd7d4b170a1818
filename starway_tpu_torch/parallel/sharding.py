"""The port's mesh: named axis sizes, the device the shards live on, and
the process group that holds them.

Port of the JAX package's ``parallel/sharding.py::make_mesh``.  A JAX mesh
places one shard on each device; the port's mesh places the shards of its
one sharded axis (the sequence axis ``"sp"`` of ring attention, or the
expert axis ``"ep"`` of MoE) on processes, ``n / world`` consecutive
shards in each process of the group: process ``r``
holds shards ``r * n / world .. (r + 1) * n / world - 1``.  Without a group
one process holds all ``n``.  This is the counterpart of the virtual mesh
on which the JAX package's tests hold 8 CPU devices in one process, and
what lets ring attention run at real ring offsets on one card: shards that
share a process rotate as a list, and only a shard that crosses to another
process goes through ``torch.distributed`` (ops/collectives.py).

Data and tensor parallel axes are not ported yet: ``dp`` and ``tp`` must
have size 1, and so must every axis other than the sharded one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

_NOT_PORTED = ("only one mesh axis (the sequence axis of ring attention "
               "or the expert axis of MoE) may be larger than 1 in this "
               "port; data and tensor "
               "parallelism wait for the rest of the parallel layer "
               "(ROADMAP.md, Queue 1 item 6)")


class Mesh:
    """Axis sizes (``shape``, in the order given), the shards' ``device``
    and the process ``group`` (None: this process holds every shard)."""

    def __init__(self, shape: dict, device: torch.device, group=None):
        self.shape = dict(shape)
        self.device = device
        self.group = group

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    def local_range(self, axis: str) -> range:
        """Global indices of this process's shards along ``axis``."""
        n = self.shape[axis]
        if n == 1:
            return range(1)
        per = n // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    def global_rank(self, group_rank: int) -> int:
        """The default group's rank of a rank of this mesh's group."""
        if self.group is None or self.group == dist.group.WORLD:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    def __repr__(self):
        return (f"Mesh({self.shape}, device={self.device}, "
                f"world={self.world}, rank={self.rank})")


def make_mesh(axes: dict, device=None, group=None) -> Mesh:
    """A mesh of ``{"dp": 1, "tp": 1, "sp": n}``-style axis sizes (or
    ``{"ep": n}``: one axis above size 1, never dp or tp).

    ``device``: where the shards live (``cuda`` unless given);
    ``group``: a ``torch.distributed`` process group whose processes hold
    the sharded axis's shards, ``n / world`` each (the module docstring);
    None keeps them all in this process."""
    sizes = {}
    for name, size in axes.items():
        if int(size) != size or size < 1:
            raise ValueError(f"axis {name!r} needs a size >= 1, got {size}")
        sizes[name] = int(size)
    sharded = [name for name, size in sizes.items() if size > 1]
    if len(sharded) > 1 or any(name in ("dp", "tp") for name in sharded):
        raise NotImplementedError(f"mesh {sizes}: {_NOT_PORTED}")
    mesh = Mesh(sizes, torch.device("cuda" if device is None else device),
                group)
    if sharded and sizes[sharded[0]] % mesh.world:
        raise ValueError(f"axis {sharded[0]!r} of size {sizes[sharded[0]]} "
                         f"does not split over {mesh.world} processes")
    return mesh
