"""The parallel layer of the port: the mesh (sharding), the ring rotation
(ops/collectives.py), sequence-parallel ring attention, plain, zigzag and
windowed (ring_attention), and the pytree transfer at a data-parallel
boundary over the transport (dp_exchange).  The rest of the JAX package's
parallel layer (Ulysses, FSDP, pipelines, MoE dispatch) waits for later
slices (ROADMAP.md, Queue 1 item 6)."""

from .dp_exchange import ClientPort, ServerPort, recv_pytree, send_pytree
from .ring_attention import (make_ring_attention, make_zigzag_ring_attention,
                             ring_attention, zigzag_indices,
                             zigzag_ring_attention, zigzag_wrap)
from .sharding import Mesh, make_mesh

__all__ = [
    "ClientPort", "Mesh", "ServerPort", "make_mesh", "make_ring_attention",
    "make_zigzag_ring_attention", "recv_pytree", "ring_attention",
    "send_pytree", "zigzag_indices", "zigzag_ring_attention", "zigzag_wrap",
]
