"""swshard: array redistribution compiled into minimal-memory p2p schedules.

The bridge between the SPMD layer (DESIGN.md §8) and the p2p runtime
(ROADMAP item 2; DESIGN.md §20): given a source and a destination
sharding -- possibly on different meshes or different process sets -- a
**planner** (plan.py) computes the per-rank block intersections and
compiles them into rounds of all-to-all-shaped tagged transfers whose
per-host staging stays O(shard), an **executor** (executor.py) runs the
schedule over the existing Client/Server fabric with flush barriers
between rounds, and a **tag lease** (tags.py) keeps schedule tags in a
reserved namespace that cannot collide with user tags.  The torch face --
``redistribute()`` / ``ArrayRef`` / ``spec_from_sharding`` and the
sharding descriptions they take (``SlotMesh``, ``SlotSharding``,
``ShardedTensor``, a DTensor's mesh and placements) -- lives in api.py,
the only module here that imports torch.

Follows "Memory-efficient array redistribution through portable
collective communication" (arxiv 2112.01075), built from starway p2p
instead of XLA collectives, so it composes with every opt-in plane the
fabric carries: sessions (§14), striping (§17), flow control (§18),
integrity (§19).
"""

from __future__ import annotations

from .plan import Block, Piece, Plan, ShardSpec, Transfer, build_plan  # noqa: F401
from .tags import RESHARD_TAG_BASE, TagLease, is_reshard_tag, lease  # noqa: F401
from .executor import execute, reset_staging_peak, staging_snapshot  # noqa: F401


def __getattr__(name):
    # torch-importing names resolve lazily so `import
    # starway_tpu_torch.reshard` stays cheap for the planner alone.
    if name in ("redistribute", "ArrayRef", "ReshardResult",
                "spec_from_sharding", "default_rank_of", "Slot",
                "SlotMesh", "SlotSharding", "ShardedTensor"):
        from . import api

        return getattr(api, name)
    raise AttributeError(name)


__all__ = [
    "Block", "Piece", "Plan", "ShardSpec", "Transfer", "build_plan",
    "RESHARD_TAG_BASE", "TagLease", "is_reshard_tag", "lease",
    "execute", "staging_snapshot", "reset_staging_peak",
    "redistribute", "ArrayRef", "ReshardResult", "spec_from_sharding",
    "default_rank_of", "Slot", "SlotMesh", "SlotSharding", "ShardedTensor",
]
