"""Sharded all-to-all shuffles: the KV-cache disaggregation pattern.

Port of the JAX package's ``parallel/all_to_all.py``: a tensor sharded on
dim 0 over a mesh axis comes out sharded on another dim, through one
``all_to_all`` (ops/collectives.py) in which every shard sends 1/n of
itself to each peer.
"""

from __future__ import annotations

from ..ops.collectives import all_to_all


def make_shuffle(mesh, axis_name: str, *, split_axis: int = 1,
                 concat_axis: int = 0):
    """The resharding shuffle over ``axis_name``: ``shuffle(shards) ->
    shards``, taking this process's dim-0 blocks of a tensor (in the order
    of ``mesh.local_range(axis_name)``) and returning its dim-
    ``split_axis`` blocks.  For a ``[S, B, ...]`` KV cache sharded on S,
    ``make_shuffle(mesh, "x")`` yields the cache sharded on B."""

    def shuffle(shards):
        return all_to_all(shards, mesh, axis_name, split_axis, concat_axis)

    return shuffle
