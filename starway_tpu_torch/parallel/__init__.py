"""The parallel layer of the port, so far its ring attention: the mesh
(sharding), the ring rotation (ops/collectives.py) and sequence-parallel
ring attention, plain, zigzag and windowed (ring_attention).  The rest of
the JAX package's parallel layer (Ulysses, FSDP, pipelines, MoE dispatch)
waits for later slices (ROADMAP.md, Queue 1 item 13)."""

from .ring_attention import (make_ring_attention, make_zigzag_ring_attention,
                             ring_attention, zigzag_indices,
                             zigzag_ring_attention, zigzag_wrap)
from .sharding import Mesh, make_mesh

__all__ = [
    "Mesh", "make_mesh", "make_ring_attention", "make_zigzag_ring_attention",
    "ring_attention", "zigzag_indices", "zigzag_ring_attention",
    "zigzag_wrap",
]
