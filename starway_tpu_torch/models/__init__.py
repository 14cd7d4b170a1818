"""The Llama model and its paths: config, forward and the train step
(llama), KV-cache decode and generation (generate), multi-token ingestion
(speculative), continuous batching over a dense cache (serving) or a page
pool (paged), serving over the transport (remote_serving), the training
harness (trainer), and numpy tree conversion (convert)."""

from .convert import params_from_numpy
from .generate import decode_step, generate, init_cache, prefill
from .llama import (LlamaConfig, LlamaModel, forward, init_params, loss_fn,
                    make_sharded_attn, make_train_step)
from .paged import PagedSlotServer, init_paged_pool, paged_decode_step
from .remote_serving import RemoteGenerateSession, RemoteSlotServer
from .serving import SlotServer
from .speculative import chunk_decode_step
from .trainer import Trainer

__all__ = [
    "LlamaConfig", "LlamaModel", "PagedSlotServer", "RemoteGenerateSession",
    "RemoteSlotServer", "SlotServer", "Trainer",
    "chunk_decode_step", "decode_step", "forward", "generate", "init_cache",
    "init_paged_pool", "init_params", "loss_fn", "make_sharded_attn",
    "make_train_step",
    "paged_decode_step", "params_from_numpy", "prefill",
]
