"""The parallel layer of the port: the mesh of several axes and its
shardings (sharding), the collectives along one of its axes
(ops/collectives.py), sequence-parallel ring attention, plain, zigzag and
windowed (ring_attention), Ulysses attention (ulysses), ZeRO/FSDP
sharding of parameters and optimizer state (fsdp), the 1F1B pipeline
schedules over a ``"pp"`` axis, plain (pipeline) and with virtual chunks
(interleaved), the KV-cache shuffle (all_to_all), and the pytree transfer
at a data-parallel boundary over the transport (dp_exchange).  Tensor
parallelism and the expert-parallel MoE live in the model
(models/sharded.py, models/moe.py), and the pipelined Llama in
models/pp_llama.py."""

from .all_to_all import make_shuffle
from .dp_exchange import ClientPort, ServerPort, recv_pytree, send_pytree
from .fsdp import fsdp_specs, make_fsdp_train_step, shard_tree
from .interleaved import (build_interleaved_schedule,
                          make_interleaved_pipeline_train)
from .pipeline import make_pipeline, make_pipeline_train
from .ring_attention import (make_ring_attention, make_zigzag_ring_attention,
                             ring_attention, zigzag_indices,
                             zigzag_ring_attention, zigzag_wrap)
from .sharding import Mesh, P, make_mesh, mesh_sharding, shard_array
from .ulysses import make_ulysses_attention, ulysses_attention

__all__ = [
    "ClientPort", "Mesh", "P", "ServerPort", "build_interleaved_schedule",
    "fsdp_specs", "make_fsdp_train_step", "make_interleaved_pipeline_train",
    "make_mesh", "make_pipeline", "make_pipeline_train",
    "make_ring_attention",
    "make_shuffle", "make_ulysses_attention", "make_zigzag_ring_attention",
    "mesh_sharding", "recv_pytree", "ring_attention", "send_pytree",
    "shard_array", "shard_tree", "ulysses_attention", "zigzag_indices",
    "zigzag_ring_attention", "zigzag_wrap",
]
