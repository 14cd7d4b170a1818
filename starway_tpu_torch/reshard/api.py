"""swshard's torch face: the public ``redistribute()`` over torch shardings.

The port's counterpart of the JAX package's ``reshard/api.py``, and the
only module under reshard/ that imports torch: the planner and the
executor stay pure data.  It lowers a sharding into the planner's
:class:`~.plan.ShardSpec`, exchanges each rank's contribution over the
fabric (so participants on different meshes or process sets need no
shared namespace), drives :func:`~.executor.execute`, and hands back the
destination shards.

A JAX sharding places one shard on each device of a mesh.  The port
describes the same thing without a process group:

* :class:`SlotMesh` -- named axis sizes over *slots*, row-major; each
  :class:`Slot` carries the ``torch.device`` its shard lives on (slots may
  share one card) and the participant rank that owns it.
* :class:`SlotSharding` -- a mesh and a ``PartitionSpec``-like tuple (one
  entry a dimension: None, an axis name, or a tuple of axis names).  Its
  :meth:`~SlotSharding.indices_map` gives every slot the box that
  ``NamedSharding.devices_indices_map`` gives its device for the same
  mesh shape and spec, and refuses an uneven split as JAX does.
* :class:`ShardedTensor` -- shape, dtype, sharding and ``{slot: tensor}``,
  the counterpart of a sharded ``jax.Array``.  A pure receiver passes an
  :class:`ArrayRef` instead.

A DTensor lowers too: its ``Shard(d)`` and ``Replicate()`` placements over
its ``DeviceMesh`` give this process's box through DTensor's own
``compute_local_shape_and_global_offset`` (so an uneven ``Shard`` follows
``torch.chunk`` as DTensor stores it); ``Partial`` is refused.  A
destination given as ``(device_mesh, placements)`` comes back as a DTensor
through :meth:`ReshardResult.to_dtensor`.

>>> res = await redistribute(src, SlotSharding(mesh, (None, "x")),
...                          peers={1: port}, rank=0, lease_slot=3)
>>> res.array   # the destination ShardedTensor (this rank's shards)

The wire is the JAX package's: the spec exchange's JSON (dtype names
such as ``"bfloat16"`` included) and the schedule's tags are the same
bytes, so a JAX rank and a torch rank redistribute one array together.
"""

from __future__ import annotations

import asyncio
import json
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..device import _torch_dtype
from . import executor as _executor
from . import tags as _tags
from .plan import Block, ShardSpec, box_nbytes, build_plan

__all__ = ["ArrayRef", "ReshardResult", "redistribute", "spec_from_sharding",
           "default_rank_of", "Slot", "SlotMesh", "SlotSharding",
           "ShardedTensor"]


def _dtype_name(dtype: torch.dtype) -> str:
    """The spec exchange's dtype name: numpy's (and the JAX package's)."""
    return str(dtype).removeprefix("torch.")


class ArrayRef:
    """Descriptor standing in for an array this process does not hold
    (the pure-receiver side of a redistribution)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = _torch_dtype(dtype)


# ------------------------------------------------------------- shardings


class Slot(NamedTuple):
    """One shard's place: its row-major index in the mesh, the device that
    holds it, and the participant rank that owns it."""

    index: int
    device: torch.device
    rank: int


def _per_slot(value, n: int, what: str) -> list:
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"{what}: {len(value)} given for {n} slots")
        return list(value)
    return [value] * n


class SlotMesh:
    """Named axis sizes over slots (the counterpart of ``jax.sharding.Mesh``).

    ``devices``: one device for every slot or a sequence, one a slot
    (default: the current CUDA device); ``ranks``: one rank for every slot
    or a sequence (default 0: one process holds the mesh)."""

    def __init__(self, axes: dict, devices=None, ranks=0):
        self.shape = {}
        for name, size in axes.items():
            if int(size) != size or size < 1:
                raise ValueError(f"axis {name!r} needs a size >= 1, got {size}")
            self.shape[str(name)] = int(size)
        self.axis_names = tuple(self.shape)
        n = math.prod(self.shape.values())
        if devices is None:
            from ..device import _target_device

            devices = _target_device(None)
        devs = [torch.device(d) for d in _per_slot(devices, n, "devices")]
        self.slots = tuple(Slot(i, d, int(r)) for i, (d, r) in enumerate(
            zip(devs, _per_slot(ranks, n, "ranks"))))

    def coords(self, slot: Slot) -> dict:
        """The slot's coordinate on each axis (row-major, last axis fastest)."""
        out, rest = {}, slot.index
        for name in reversed(self.axis_names):
            rest, out[name] = divmod(rest, self.shape[name])
        return out

    def __repr__(self):
        return f"SlotMesh({self.shape}, ranks={sorted({s.rank for s in self.slots})})"


class SlotSharding:
    """A mesh and a ``PartitionSpec``-like tuple (the counterpart of
    ``NamedSharding``): entry ``d`` names the axes dimension ``d`` is split
    over -- None (replicated), an axis name, or a tuple of axis names, the
    first the most significant.  Unnamed trailing dimensions are whole."""

    def __init__(self, mesh: SlotMesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)
        self._axes = []
        seen = set()
        for entry in self.spec:
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            for name in names:
                if name not in mesh.shape:
                    raise ValueError(f"axis {name!r} of spec {self.spec} is "
                                     f"not in the mesh {mesh.axis_names}")
                if name in seen:
                    raise ValueError(f"spec {self.spec} names axis {name!r} "
                                     f"twice; an axis splits one dimension")
                seen.add(name)
            self._axes.append(names)

    @property
    def slots(self) -> tuple:
        return self.mesh.slots

    def indices_map(self, shape) -> dict:
        """``{slot: box}`` for an array of ``shape``: the box (per dimension
        a half-open ``(lo, hi)``) JAX's ``devices_indices_map`` gives the
        device at the slot's place.  A dimension that its axes do not
        divide evenly is refused, as JAX refuses it."""
        shape = tuple(int(s) for s in shape)
        if len(self._axes) > len(shape) and any(self._axes[len(shape):]):
            raise ValueError(f"spec {self.spec} splits more dimensions than "
                             f"the shape {shape} has")
        parts = []
        for d, dim in enumerate(shape):
            names = self._axes[d] if d < len(self._axes) else ()
            n = math.prod(self.mesh.shape[a] for a in names)
            if dim % n:
                raise ValueError(
                    f"spec {self.spec} splits dimension {d} of {shape} "
                    f"{n} ways, which does not divide {dim}; the split "
                    f"must be even")
            parts.append((names, dim // n))
        out = {}
        for slot in self.mesh.slots:
            coords = self.mesh.coords(slot)
            box = []
            for names, size in parts:
                idx = 0
                for a in names:
                    idx = idx * self.mesh.shape[a] + coords[a]
                box.append((idx * size, (idx + 1) * size))
            out[slot] = tuple(box)
        return out

    def __repr__(self):
        return f"SlotSharding({self.mesh!r}, {self.spec})"


def _box_shape(box) -> tuple:
    return tuple(hi - lo for lo, hi in box)


def _box_slices(box) -> tuple:
    return tuple(slice(lo, hi) for lo, hi in box)


class ShardedTensor:
    """A global tensor held as shards (the counterpart of a sharded
    ``jax.Array``): ``shape``, ``dtype``, ``sharding`` and ``shards``,
    ``{slot: tensor}`` for the slots this process holds, each tensor the
    contiguous box of its slot on the slot's device."""

    def __init__(self, shape, dtype, sharding: SlotSharding, shards: dict):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = _torch_dtype(dtype)
        self.sharding = sharding
        self.shards = dict(shards)
        boxes = sharding.indices_map(self.shape)
        for slot, t in self.shards.items():
            if (tuple(t.shape) != _box_shape(boxes[slot])
                    or t.dtype != self.dtype):
                raise ValueError(f"shard of slot {slot.index} is "
                                 f"{tuple(t.shape)} {t.dtype}, its box "
                                 f"{boxes[slot]} of {self.dtype}")

    @classmethod
    def from_tensor(cls, full: torch.Tensor, sharding: SlotSharding,
                    rank: Optional[int] = None) -> "ShardedTensor":
        """Shard ``full`` under ``sharding``: every slot's box, copied onto
        the slot's device (only the slots of ``rank`` when given)."""
        shards = {}
        for slot, box in sharding.indices_map(full.shape).items():
            if rank is None or slot.rank == rank:
                shards[slot] = full[_box_slices(box)].to(
                    slot.device, copy=True).contiguous()
        return cls(full.shape, full.dtype, sharding, shards)

    @property
    def device(self) -> torch.device:
        """The device of the first shard held."""
        return next(iter(self.shards.values())).device

    def _distinct(self) -> list:
        """The slots held, grouped by the one tensor they share: ``[(value,
        [slot, ...]), ...]`` in the order of the first slot of each."""
        groups: dict = {}
        for slot in sorted(self.shards, key=lambda s: s.index):
            value = self.shards[slot]
            groups.setdefault(id(value), (value, []))[1].append(slot)
        return list(groups.values())

    def tree_children(self) -> list:
        """What utils/tree.py sees as the leaves under this node: each
        tensor held once, slots sharing a box giving one."""
        return [value for value, _ in self._distinct()]

    def tree_rebuild(self, children) -> "ShardedTensor":
        """This node with ``children`` (one for each of
        :meth:`tree_children`, any objects) in place of its tensors, the
        slots that shared a tensor sharing its replacement."""
        out = object.__new__(ShardedTensor)
        out.shape, out.dtype, out.sharding = (self.shape, self.dtype,
                                              self.sharding)
        out.shards = {}
        for child, (_, slots) in zip(children, self._distinct()):
            for slot in slots:
                out.shards[slot] = child
        first = children[0] if children else None
        if isinstance(first, torch.Tensor):
            out.dtype = first.dtype
        return out

    def full(self) -> torch.Tensor:
        """Assemble the global tensor from the shards held, on the first
        shard's device; raises if they do not cover it."""
        if not self.shards:
            raise ValueError("no shards held: nothing to assemble")
        boxes = self.sharding.indices_map(self.shape)
        first = next(iter(self.shards.values()))
        out = torch.empty(self.shape, dtype=self.dtype, device=first.device)
        covered = set()
        for slot, t in self.shards.items():
            box = boxes[slot]
            if box not in covered:
                out[_box_slices(box)].copy_(t)
                covered.add(box)
        # Distinct boxes of one sharding are disjoint: they cover the
        # tensor exactly when their sizes add up to it.
        if sum(math.prod(_box_shape(b)) for b in covered) != out.numel():
            raise ValueError(f"the {len(self.shards)} shards held do not "
                             f"cover {self.shape}")
        return out

    def __repr__(self):
        return (f"ShardedTensor({self.shape}, {self.dtype}, "
                f"{len(self.shards)} shards, {self.sharding!r})")


def default_rank_of(slot) -> int:
    """Slot -> participant rank: the rank the slot carries (tests override
    it to simulate many ranks on one mesh, as the JAX package's do)."""
    return int(slot.rank)


# ------------------------------------------------------- DTensor layouts


def _is_dtensor(x) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a torch built without the distributed package
        return False
    return isinstance(x, DTensor)


def _is_dtensor_layout(sharding) -> bool:
    """A ``(device_mesh, placements)`` pair."""
    try:
        from torch.distributed.device_mesh import DeviceMesh
    except ImportError:
        return False
    return (isinstance(sharding, tuple) and len(sharding) == 2
            and isinstance(sharding[0], DeviceMesh))


def _dtensor_box(shape, mesh, placements, rank: int):
    """This process's (slot, box) under a DTensor layout: its box from
    DTensor's own shard arithmetic (``torch.chunk`` for an uneven
    ``Shard``); None when this process is not in the mesh."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    for p in placements:
        if not isinstance(p, (Shard, Replicate)):
            raise ValueError(
                f"placement {p!r}: only Shard(d) and Replicate() lower to a "
                f"redistribution (a Partial holds summands, not a box of "
                f"the tensor; reduce it first)")
    if mesh.get_coordinate() is None:
        return None
    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), mesh, placements)
    box = tuple((o, o + n) for o, n in zip(offset, local))
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    return Slot(int(torch.distributed.get_rank()), dev, rank), box


# ------------------------------------------------------------ lowering


def spec_from_sharding(sharding, shape, itemsize,
                       rank_of: Callable = default_rank_of,
                       only_rank: Optional[int] = None) -> ShardSpec:
    """Lower a :class:`SlotSharding` into a pure-data :class:`ShardSpec`;
    ``only_rank`` keeps just that rank's blocks -- the contribution the
    spec exchange ships.  A DTensor layout ``(device_mesh, placements)``
    lowers to this process's block, as rank ``only_rank`` (default 0)."""
    if _is_dtensor_layout(sharding):
        r = 0 if only_rank is None else only_rank
        found = _dtensor_box(shape, sharding[0], sharding[1], r)
        blocks = [] if found is None else [Block(r, found[1])]
        return ShardSpec(tuple(shape), itemsize, blocks)
    blocks = []
    for slot, box in sharding.indices_map(tuple(shape)).items():
        r = rank_of(slot)
        if only_rank is None or r == only_rank:
            blocks.append(Block(r, box))
    return ShardSpec(tuple(shape), itemsize, blocks)


def _local_boxes(sharding, shape, rank, rank_of) -> dict:
    """``{slot: box}`` of the slots ``rank`` holds under ``sharding``."""
    if sharding is None:
        return {}
    if _is_dtensor_layout(sharding):
        found = _dtensor_box(shape, sharding[0], sharding[1], rank)
        return {} if found is None else {found[0]: found[1]}
    return {slot: box for slot, box in sharding.indices_map(shape).items()
            if rank_of(slot) == rank}


def _spec(shape, itemsize, rank, boxes) -> ShardSpec:
    # An empty box (an uneven torch.chunk's last shard) holds nothing to
    # plan; its slot still receives its empty tensor.
    return ShardSpec(shape, itemsize, [Block(rank, b) for b in boxes
                                       if all(hi > lo for lo, hi in b)])


class ReshardResult:
    """This rank's destination shards, ``{slot: tensor}``, and the run's
    stats.  :attr:`array` is the destination :class:`ShardedTensor`;
    simulated-rank callers (several ranks in one process) :meth:`merge`
    their results first.  A DTensor destination comes back through
    :meth:`to_dtensor`."""

    def __init__(self, shape, dtype, sharding, shards: dict, stats: dict):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = shards
        self.stats = stats

    def merge(self, other: "ReshardResult") -> "ReshardResult":
        self.shards.update(other.shards)
        return self

    @property
    def array(self) -> ShardedTensor:
        if self.sharding is None:
            raise ValueError("no destination sharding on this rank "
                             "(pure sender) -- there is nothing to assemble")
        if _is_dtensor_layout(self.sharding):
            raise ValueError("a DTensor destination: use to_dtensor()")
        return ShardedTensor(self.shape, self.dtype, self.sharding,
                             self.shards)

    def to_dtensor(self):
        """The destination as a DTensor on its ``(device_mesh, placements)``
        (``DTensor.from_local`` over this process's shard)."""
        from torch.distributed.tensor import DTensor

        if not _is_dtensor_layout(self.sharding):
            raise ValueError("the destination is not a DTensor layout")
        mesh, placements = self.sharding
        (local,) = self.shards.values()
        stride = torch.empty(self.shape, device="meta").stride()
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(self.shape), stride=stride)


# ------------------------------------------------------------ spec exchange


def _ctl_payload(obj: dict):
    raw = json.dumps(obj, separators=(",", ":"), sort_keys=True).encode()
    return np.frombuffer(raw, dtype=np.uint8).copy()


async def _exchange_specs(rank, peers, lease, src_spec, dst_spec,
                          shape, itemsize, dtype_name, ctl_bytes, timeout):
    """All-gather the per-rank spec contributions over the ports: my
    contribution goes out on ``ctl_tag(rank)``, each peer's arrives on
    ``ctl_tag(peer)``.  Returns the merged (src, dst) specs."""
    mine = {
        "rank": rank,
        "shape": list(shape),
        "itemsize": itemsize,
        "dtype": dtype_name,
        "src": src_spec.to_dict()["blocks"],
        "dst": dst_spec.to_dict()["blocks"],
    }
    payload = _ctl_payload(mine)
    if len(payload) > ctl_bytes:
        raise ValueError(
            f"spec contribution ({len(payload)} B) exceeds the ctl buffer "
            f"({ctl_bytes} B); raise ctl_bytes")
    bufs = {p: np.empty(ctl_bytes, dtype=np.uint8) for p in peers}
    ops = [peers[p].arecv(bufs[p], lease.ctl_tag(p), _executor.FULL_MASK)
           for p in sorted(peers)]
    ops += [peers[p].asend(payload, lease.ctl_tag(rank)) for p in sorted(peers)]
    gathered = asyncio.gather(*ops)
    if timeout is not None:
        results = await asyncio.wait_for(gathered, timeout)
    else:
        results = await gathered
    src, dst = src_spec, dst_spec
    for (_, ln), p in zip(results[:len(peers)], sorted(peers)):
        theirs = json.loads(bytes(memoryview(bufs[p])[:ln]).decode())
        if (tuple(theirs["shape"]) != tuple(shape)
                or int(theirs["itemsize"]) != itemsize
                or theirs["dtype"] != dtype_name):
            raise ValueError(
                f"rank {p} describes a different array "
                f"({theirs['shape']}/{theirs['dtype']}) than this rank "
                f"({list(shape)}/{dtype_name})")
        src = src.merged(ShardSpec(shape, itemsize,
                                   [Block.from_dict(b) for b in theirs["src"]]))
        dst = dst.merged(ShardSpec(shape, itemsize,
                                   [Block.from_dict(b) for b in theirs["dst"]]))
    return src, dst


# ----------------------------------------------------------- local IO


def _box_contains(outer, inner) -> bool:
    return all(olo <= ilo and ihi <= ohi
               for (olo, ohi), (ilo, ihi) in zip(outer, inner))


def _local_slices(outer, inner):
    return tuple(slice(ilo - olo, ihi - olo)
                 for (olo, _), (ilo, ihi) in zip(outer, inner))


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A box's bytes: the flat uint8 view of a contiguous copy (or of the
    box itself, where it is contiguous already)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _bytes_tensor(data) -> torch.Tensor:
    """Flat uint8 bytes as a tensor: a tensor as it is, a host buffer
    aliased (copied when it is read-only)."""
    if isinstance(data, torch.Tensor):
        return data
    arr = np.frombuffer(data, dtype=np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


# -------------------------------------------------------------- entry point


async def redistribute(array_or_ref, dst_sharding=None, peers=None, *,
                       rank: int = 0, rank_of: Callable = default_rank_of,
                       src_sharding=None, lease=None, lease_slot=None,
                       budget: Optional[int] = None, via: str = "host",
                       round_timeout: Optional[float] = None,
                       ctl_bytes: int = 1 << 18) -> ReshardResult:
    """Move a tensor between two shardings over the starway fabric.

    ``array_or_ref`` is this process's view of the SOURCE: a
    :class:`ShardedTensor` or a DTensor (source holder), or an
    :class:`ArrayRef` (pure receiver).  ``dst_sharding`` is the
    destination: a :class:`SlotSharding` or a DTensor layout
    ``(device_mesh, placements)`` (None on a pure sender).  ``peers`` maps
    the other participants' ranks to duck-typed ports
    (``asend``/``arecv``/``aflush`` -- parallel/dp_exchange.py's ports
    fit); omit it for a purely local retile.

    Every participant passes the same ``lease_slot`` (reserved-tag
    coordination, reshard/tags.py) and a unique ``rank``.  ``via`` picks
    the transfer representation: ``"host"`` (flat uint8 host staging,
    works everywhere) or ``"device"`` (each transfer's slice of the source
    sent as a device payload and received into a ``DeviceBuffer`` on the
    destination slot's device, placed into the destination shards on that
    device -- the pull carries it when the connection negotiated one).
    ``budget`` caps one message's bytes (default: the largest shard).

    Returns a :class:`ReshardResult`: ``result.array`` is the destination
    :class:`ShardedTensor` (raises on a pure sender),
    ``result.to_dtensor()`` a DTensor destination.
    """
    peers = dict(peers or {})
    if rank in peers:
        raise ValueError(f"peers must not contain this rank ({rank})")
    if via not in ("host", "device"):
        raise ValueError(f"via={via!r}: expected 'host' or 'device'")

    shape = tuple(int(s) for s in array_or_ref.shape)
    dtype = _torch_dtype(array_or_ref.dtype)
    itemsize = int(dtype.itemsize)

    # ---- local contributions ----------------------------------------
    src_tensors: list = []  # [(box, tensor)] of this rank's source shards
    if isinstance(array_or_ref, ArrayRef):
        src_boxes = {}
    elif _is_dtensor(array_or_ref):
        layout = (array_or_ref.device_mesh, tuple(array_or_ref.placements))
        sh = src_sharding if src_sharding is not None else layout
        src_boxes = _local_boxes(sh, shape, rank, rank_of)
        local = array_or_ref.to_local()
        src_tensors = [(box, local) for box in src_boxes.values()]
    elif isinstance(array_or_ref, ShardedTensor):
        sh = src_sharding if src_sharding is not None \
            else array_or_ref.sharding
        src_boxes = _local_boxes(sh, shape, rank, rank_of)
        missing = [s.index for s in src_boxes
                   if s not in array_or_ref.shards]
        if missing:
            raise ValueError(f"rank {rank} owns slots {missing} of the "
                             f"source but the ShardedTensor holds none of "
                             f"them")
        src_tensors = [(box, array_or_ref.shards[slot])
                       for slot, box in src_boxes.items()]
    else:
        raise TypeError(
            f"array_or_ref must be a ShardedTensor, a DTensor or an "
            f"ArrayRef, got {type(array_or_ref)!r}")
    src_spec = _spec(shape, itemsize, rank, src_boxes.values())

    dst_boxes = _local_boxes(dst_sharding, shape, rank, rank_of)
    dst_spec = _spec(shape, itemsize, rank, dst_boxes.values())

    # ---- spec exchange + plan ---------------------------------------
    own_lease = None
    if lease is None:
        lease = own_lease = _tags.lease(lease_slot)
    try:
        if peers:
            src_spec, dst_spec = await _exchange_specs(
                rank, peers, lease, src_spec, dst_spec, shape, itemsize,
                _dtype_name(dtype), ctl_bytes, round_timeout)
        plan = build_plan(src_spec, dst_spec, budget=budget)

        # ---- local IO callbacks -------------------------------------
        dst_bufs = {slot: torch.empty(_box_shape(box), dtype=dtype,
                                      device=slot.device)
                    for slot, box in dst_boxes.items()}

        def src_box(box) -> torch.Tensor:
            for sbox, t in src_tensors:
                if _box_contains(sbox, box):
                    return t[_local_slices(sbox, box)]
            raise KeyError(f"no local source shard contains {box}")

        def read_box(box):
            flat = _flat(src_box(box))
            # "device": the bytes stay where the shard is (local copies
            # and payloads); "host": flat uint8 host staging.
            return flat if via == "device" else flat.cpu().numpy()

        def write_box(box, data):
            shaped = None
            for slot, dbox in dst_boxes.items():
                if _box_contains(dbox, box):
                    if shaped is None:
                        shaped = _bytes_tensor(data).view(dtype).reshape(
                            _box_shape(box))
                    dst_bufs[slot][_local_slices(dbox, box)].copy_(shaped)

        hooks = {}
        if via == "device":
            hooks = _device_hooks(plan, read_box, write_box, dst_boxes)

        stats = await _executor.execute(
            plan, rank, peers, read_box, write_box,
            tag_of=lambda t: lease.data_tag(t.tag_off),
            round_timeout=round_timeout, **hooks)
    finally:
        if own_lease is not None:
            own_lease.release()

    stats["plan_rounds"] = plan.rounds
    stats["peak_staging_bound"] = 2 * plan.budget
    return ReshardResult(shape, dtype, dst_sharding, dst_bufs, stats)


def _device_hooks(plan, read_box, write_box, dst_boxes):
    """Device-plane transfer hooks: each payload is the transfer's pieces
    of the source, contiguous on the source's device; each sink is a
    ``DeviceBuffer`` on the device of the destination slot that takes the
    transfer's first piece; its pieces are copied into the destination
    shards there (never through the host)."""
    from ..device import DeviceBuffer

    def make_payload(t):
        parts = [read_box(p.box) for p in t.pieces]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def make_sink(t):
        first = t.pieces[0].box
        device = next(slot.device for slot, box in dst_boxes.items()
                      if _box_contains(box, first))
        return DeviceBuffer((t.nbytes,), torch.uint8, device=device)

    def consume_sink(t, sink):
        flat = sink.array
        off = 0
        for p in t.pieces:
            nb = box_nbytes(p.box, plan.itemsize)
            write_box(p.box, flat[off:off + nb])
            off += nb

    return {"make_payload": make_payload, "make_sink": make_sink,
            "consume_sink": consume_sink}
