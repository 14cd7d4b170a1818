"""The parallel layer of the port: the mesh (sharding; one axis above
size 1, the sequence axis "sp" or the expert axis "ep"), the collectives
(ops/collectives.py), sequence-parallel ring attention, plain, zigzag and
windowed (ring_attention), the KV-cache shuffle (all_to_all), and the
pytree transfer at a data-parallel boundary over the transport
(dp_exchange).  The expert-parallel MoE dispatch is models/moe.py.  The
rest of the JAX package's parallel layer (dp and tp axes, Ulysses, FSDP,
pipelines) waits for later slices (ROADMAP.md, Queue 1 item 6)."""

from .all_to_all import make_shuffle
from .dp_exchange import ClientPort, ServerPort, recv_pytree, send_pytree
from .ring_attention import (make_ring_attention, make_zigzag_ring_attention,
                             ring_attention, zigzag_indices,
                             zigzag_ring_attention, zigzag_wrap)
from .sharding import Mesh, make_mesh

__all__ = [
    "ClientPort", "Mesh", "ServerPort", "make_mesh", "make_ring_attention",
    "make_shuffle",
    "make_zigzag_ring_attention", "recv_pytree", "ring_attention",
    "send_pytree", "zigzag_indices", "zigzag_ring_attention", "zigzag_wrap",
]
