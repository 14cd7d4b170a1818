"""The Llama model and its paths: config, forward and the train step
(llama), the mixture-of-experts FFN in its global and expert-parallel
views (moe), KV-cache decode and generation with rolling sliding-window caches
(generate), the model over a mesh of several axes (sharded), the
pipeline-parallel Llama (pp_llama),
speculative and prompt-lookup decoding (speculative), beam
search (beam), continuous batching over a dense or rolling cache (serving)
or a page pool (paged), serving over the transport (remote_serving), the
training harness (trainer), and tree conversion from numpy (convert) and
from HuggingFace checkpoints (hf_convert)."""

from .beam import generate_beam
from .convert import params_from_numpy
from .generate import (decode_step, generate, init_cache, init_rolling_cache,
                       prefill, prefill_rolling)
from .hf_convert import config_from_hf, params_from_hf
from .llama import (LlamaConfig, LlamaModel, forward, init_params, loss_fn,
                    make_sharded_attn, make_train_step, param_specs,
                    quantized_param_specs)
from .paged import PagedSlotServer, init_paged_pool, paged_decode_step
from .pp_llama import (make_pp_llama_train, pp_merge_params, pp_param_specs,
                       pp_split_params, ppv_merge_params, ppv_split_params,
                       shard_pp_params, shard_ppv_params)
from .remote_serving import RemoteGenerateSession, RemoteSlotServer
from .serving import SlotServer
from .speculative import (chunk_decode_step, draft_from_truncation,
                          generate_lookup, generate_speculative)
from .trainer import Trainer

__all__ = [
    "LlamaConfig", "LlamaModel", "PagedSlotServer", "RemoteGenerateSession",
    "RemoteSlotServer", "SlotServer", "Trainer",
    "chunk_decode_step", "config_from_hf", "decode_step",
    "draft_from_truncation", "forward", "generate", "generate_beam",
    "generate_lookup", "generate_speculative", "init_cache",
    "init_paged_pool", "init_params", "init_rolling_cache", "loss_fn",
    "make_pp_llama_train", "make_sharded_attn", "make_train_step",
    "paged_decode_step", "param_specs", "params_from_hf",
    "params_from_numpy", "pp_merge_params", "pp_param_specs",
    "pp_split_params", "ppv_merge_params", "ppv_split_params", "prefill",
    "prefill_rolling", "quantized_param_specs", "shard_pp_params",
    "shard_ppv_params",
]
