"""The port's mesh: named axis sizes over slots, the device the slots live
on, and the process group that holds them.

Port of the JAX package's ``parallel/sharding.py``.  A JAX mesh is a grid
of devices, one shard a device; the port's mesh is the same grid of
*slots* (reshard/api.py :class:`~starway_tpu_torch.reshard.api.SlotMesh`):
axes in the order given, slots numbered row-major (the last axis fastest),
as ``np.array(devices).reshape(shape)`` numbers the devices.  A process
of the group holds a contiguous block of ``size / world`` slots: process
``r`` holds slots ``r * per .. (r + 1) * per - 1``.  Without a group one
process holds them all.  That is the counterpart of the virtual mesh on
which the JAX package's tests hold 8 CPU devices in one process, and what
lets one card run every shard of a mesh at its real shape: slots that
share a process exchange by moving tensors in a list, and only a slot
that crosses to another process goes through ``torch.distributed``
(ops/collectives.py).

:func:`mesh_sharding` and :func:`shard_array` are the port's face of
``NamedSharding`` and ``device_put``: a ``ShardedTensor`` holds this
process's boxes, slots whose boxes are equal sharing one tensor.

A pipeline axis (``"pp"``) above size 1 is refused: the pipelines come
with the next slice (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..reshard.api import ShardedTensor, SlotMesh, SlotSharding


class P:
    """A ``PartitionSpec``: per dimension None, an axis name or a tuple of
    names.  Not a tuple, so that a tree of specs (``param_specs``,
    ``fsdp_specs``) keeps each spec as one leaf (utils/tree.py)."""

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, (P, tuple)) and tuple(self) == tuple(other)

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


class Mesh(SlotMesh):
    """Axis sizes (``shape``, in the order given) over row-major slots,
    the slots' ``device`` and the process ``group`` (None: this process
    holds every slot)."""

    def __init__(self, shape: dict, device: torch.device, group=None):
        self.group = group
        self.device = torch.device(device)
        size = math.prod(int(s) for s in shape.values())
        if size % self.world:
            raise ValueError(f"mesh {dict(shape)} of {size} slots does not "
                             f"split over {self.world} processes")
        per = size // self.world
        super().__init__(shape, devices=self.device,
                         ranks=[i // per for i in range(size)])
        self.size = size

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def local_slots(self) -> range:
        """Indices of the slots this process holds, in order."""
        per = self.size // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    def slot_coords(self, index: int) -> dict:
        """Slot ``index``'s coordinate on each axis."""
        return self.coords(self.slots[index])

    def slot_at(self, coords: dict) -> int:
        """The index of the slot at ``coords`` (row-major)."""
        index = 0
        for name in self.axis_names:
            index = index * self.shape[name] + coords[name]
        return index

    def rank_of(self, index: int) -> int:
        """The default group's rank of the process holding slot ``index``."""
        return self.global_rank(self.slots[index].rank)

    def local_range(self, axis: str) -> range:
        """The coordinates along ``axis`` that this process's slots take,
        in order (every coordinate of an axis the process holds whole)."""
        seen = sorted({self.slot_coords(i)[axis] for i in self.local_slots})
        return range(seen[0], seen[-1] + 1)

    def global_rank(self, group_rank: int) -> int:
        """The default group's rank of a rank of this mesh's group."""
        if self.group is None or self.group == dist.group.WORLD:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    def __repr__(self):
        return (f"Mesh({self.shape}, device={self.device}, "
                f"world={self.world}, rank={self.rank})")


def make_mesh(axes: dict, device=None, group=None) -> Mesh:
    """A mesh of ``{"dp": 2, "tp": 2, "sp": 2}``-style axis sizes, axes in
    dict order.

    ``device``: where the slots live (``cuda`` unless given);
    ``group``: a ``torch.distributed`` process group whose processes hold
    the slots, ``size / world`` contiguous slots each (the module
    docstring); None keeps them all in this process."""
    sizes = {}
    for name, size in axes.items():
        if int(size) != size or size < 1:
            raise ValueError(f"axis {name!r} needs a size >= 1, got {size}")
        sizes[name] = int(size)
    if sizes.get("pp", 1) > 1:
        raise NotImplementedError(
            f"mesh {sizes}: a pipeline axis is not ported yet; the "
            f"pipelines come with the next slice (ROADMAP.md, Queue 1 "
            f"item 6)")
    return Mesh(sizes, torch.device("cuda" if device is None else device),
                group)


def mesh_sharding(mesh: Mesh, *spec) -> SlotSharding:
    """``NamedSharding`` shorthand: ``mesh_sharding(mesh, 'dp', None,
    'tp')``."""
    return SlotSharding(mesh, spec)


def _box_slices(box) -> tuple:
    return tuple(slice(lo, hi) for lo, hi in box)


def shard_array(mesh: Mesh, x, *spec) -> ShardedTensor:
    """``device_put`` of ``x`` (a tensor or numpy array, the global value)
    onto ``mesh_sharding(mesh, *spec)``: this process's slots get their
    boxes on the mesh's device, one copy for the slots that share a box."""
    x = torch.as_tensor(x)
    sharding = SlotSharding(mesh, spec)
    boxes = sharding.indices_map(x.shape)
    copies, shards = {}, {}
    for index in mesh.local_slots:
        slot = mesh.slots[index]
        box = boxes[slot]
        if box not in copies:
            copies[box] = x[_box_slices(box)].to(
                mesh.device, copy=True).contiguous()
        shards[slot] = copies[box]
    return ShardedTensor(x.shape, x.dtype, sharding, shards)


def local_shards(x: ShardedTensor) -> list:
    """The tensors of this process's slots, in slot order (slots sharing
    a box give the same tensor)."""
    mesh = x.sharding.mesh
    return [x.shards[mesh.slots[i]] for i in mesh.local_slots]


def spec_axes(spec) -> list:
    """The mesh axes a ``PartitionSpec``-like tuple names, in order."""
    out = []
    for entry in spec:
        if entry is None:
            continue
        out.extend((entry,) if isinstance(entry, str) else tuple(entry))
    return out


def _split_counts(mesh: Mesh, spec, ndim: int) -> list:
    """How many ways ``spec`` splits each of ``ndim`` dimensions."""
    out = []
    for d in range(ndim):
        entry = spec[d] if d < len(spec) else None
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(math.prod(mesh.shape[a] for a in names))
    return out


def _local_boxes(mesh: Mesh, spec, shape) -> list:
    """Each local slot's box of a global ``shape`` under ``spec``, and
    the origin of the process's box (their lower corner)."""
    boxes = SlotSharding(mesh, spec).indices_map(shape)
    mine = [boxes[mesh.slots[i]] for i in mesh.local_slots]
    origin = tuple(min(b[d][0] for b in mine) for d in range(len(shape)))
    return mine, origin


def cut_blocks(x, mesh: Mesh, spec) -> list:
    """This process's box ``x`` of a tensor sharded by ``spec`` -> the
    block of each local slot, in slot order (views; differentiable)."""
    counts = _split_counts(mesh, spec, x.dim())
    unit, _ = _local_boxes(mesh, spec, counts)  # each box's index a dim
    held = [len({box[d] for box in unit}) for d in range(x.dim())]
    for d in range(x.dim()):
        if x.shape[d] % held[d]:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                             f"split into the {held[d]} blocks this "
                             f"process holds")
    shape = [x.shape[d] * counts[d] // held[d] for d in range(x.dim())]
    mine, origin = _local_boxes(mesh, spec, shape)
    return [x[tuple(slice(lo - o, hi - o) for (lo, hi), o in
                    zip(box, origin))] for box in mine]


def join_blocks(blocks, mesh: Mesh, spec):
    """Inverse of :func:`cut_blocks`: the process's box from the blocks of
    its slots (one of each group of slots that hold the same box)."""
    counts = _split_counts(mesh, spec, blocks[0].dim())
    shape = [blocks[0].shape[d] * counts[d] for d in range(blocks[0].dim())]
    mine, _ = _local_boxes(mesh, spec, shape)
    distinct = {}
    for box, block in zip(mine, blocks):
        distinct.setdefault(box, block)

    def build(items, d):
        if d == len(shape) or len(items) == 1:
            return items[0][1]
        starts = sorted({box[d][0] for box, _ in items})
        return torch.cat([build([it for it in items if it[0][d][0] == lo],
                                d + 1) for lo in starts], dim=d)

    return build(list(distinct.items()), 0)
