"""swshard tag-space leases: schedule tags that cannot collide with users.

Redistribution schedules address their messages with ordinary matcher
tags, so a schedule tag equal to a user tag would cross-deliver.  The
fix is a **reserved namespace**: the top byte ``0xE5`` ("swshard") of the
64-bit tag space belongs to this module -- user code keeps every tag
below ``RESHARD_TAG_BASE`` (all prior tag users in this tree do:
benchmark tags sit at 0x1AA0-0x2B5x, the trainer's DP exchange under
0x90000, perf probes at 0x7E57...0000) -- and inside it, concurrent
schedules are kept apart by **leases**: fixed-width slots handed out by
a process-local registry.

A lease is a coordination point, not a lock server: all participants of
one redistribution pass the same ``slot`` (the way they already share a
``base_tag`` in parallel/dp_exchange.py) and the registry guarantees
that two live leases *in one process* never overlap -- double-acquiring
a slot, or leasing while every slot is live, raises instead of silently
reusing tags.  ``python -m starway_tpu.analysis`` has no opinion here;
tests/test_reshard.py pins the collision behaviour.

Layout of one lease (``SLOT_SPAN`` = 2^20 tags):

* ``base + 0 .. base + CTL_TAGS-1`` -- control tags (spec exchange:
  ``ctl_tag(rank)`` = ``base + rank``).
* ``base + CTL_TAGS ..`` -- data tags (``data_tag(i)`` for transfer
  ``tag_off`` ``i``).
"""

from __future__ import annotations

import threading

__all__ = [
    "RESHARD_TAG_BASE",
    "RESHARD_TAG_END",
    "SLOT_SPAN",
    "SLOTS",
    "CTL_TAGS",
    "TagLease",
    "lease",
    "is_reshard_tag",
]

#: Bottom of the reserved namespace: tags with top byte 0xE5.
RESHARD_TAG_BASE = 0xE5 << 56
#: One past the last reserved tag.
RESHARD_TAG_END = 0xE6 << 56
#: Tags per lease slot (control + data).
SLOT_SPAN = 1 << 20
#: Concurrent lease slots the namespace is divided into (bounded so the
#: registry's bookkeeping stays a small set; the namespace itself would
#: fit 2^36 slots).
SLOTS = 1 << 12
#: Control tags reserved at the bottom of each slot (one per participant
#: rank for the spec exchange; ranks above this use an explicit spec).
CTL_TAGS = 1 << 10

_lock = threading.Lock()
_live: set = set()
_next_slot = 0  # rotating auto-assign cursor (see lease())


def is_reshard_tag(tag: int) -> bool:
    """True for tags inside the reserved swshard namespace."""
    return RESHARD_TAG_BASE <= int(tag) < RESHARD_TAG_END


class TagLease:
    """One leased slot of the reserved namespace.  Context-manageable;
    releasing twice is a no-op.  Tag accessors bounds-check so a
    schedule can never silently spill into a neighbouring lease.

    Direct construction (``TagLease(slot)``) is pure tag arithmetic --
    no registry entry, so its release() never touches the registry; only
    :func:`lease` registers (``_owned``), so a direct instance used as a
    context manager cannot silently free a slot some live lease() holds.
    """

    __slots__ = ("slot", "base", "_released", "_owned")

    def __init__(self, slot: int, _owned: bool = False):
        self.slot = int(slot)
        self.base = RESHARD_TAG_BASE + self.slot * SLOT_SPAN
        self._released = False
        self._owned = _owned

    def ctl_tag(self, rank: int) -> int:
        if not (0 <= rank < CTL_TAGS):
            raise ValueError(f"ctl rank {rank} outside lease (max {CTL_TAGS})")
        return self.base + rank

    def data_tag(self, i: int) -> int:
        if not (0 <= i < SLOT_SPAN - CTL_TAGS):
            raise ValueError(
                f"data tag index {i} outside lease span {SLOT_SPAN}")
        return self.base + CTL_TAGS + i

    def release(self) -> None:
        if not self._released:
            self._released = True
            if self._owned:
                with _lock:
                    _live.discard(self.slot)

    def __enter__(self) -> "TagLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TagLease(slot={self.slot}, base=0x{self.base:x})"


def lease(slot=None) -> TagLease:
    """Acquire a lease.

    ``slot=None`` auto-assigns a free slot (single-process / tests) from
    a ROTATING cursor, not lowest-free: a schedule that failed with
    receives still posted must not see its slot -- and therefore its
    tags -- handed straight back to the retry (executor.py round_timeout
    note).  Distributed participants pass the SAME explicit ``slot`` --
    the shared-coordinate contract -- and each process's registry still
    refuses a slot already live locally (two overlapping redistributions
    coordinating on one slot is the collision this exists to catch).
    """
    global _next_slot
    with _lock:
        if slot is None:
            slot = next((s % SLOTS for s in range(_next_slot,
                                                  _next_slot + SLOTS)
                         if s % SLOTS not in _live), None)
            if slot is None:
                raise RuntimeError(
                    f"swshard tag namespace exhausted ({SLOTS} live leases)")
            _next_slot = (slot + 1) % SLOTS
        else:
            slot = int(slot)
            if not (0 <= slot < SLOTS):
                raise ValueError(f"lease slot {slot} outside [0, {SLOTS})")
            if slot in _live:
                raise RuntimeError(
                    f"swshard tag lease slot {slot} is already live in this "
                    "process -- concurrent schedules must use distinct slots")
        _live.add(slot)
    return TagLease(slot, _owned=True)
