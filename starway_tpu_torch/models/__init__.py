"""The Llama serving path: config and forward (llama), KV-cache decode and
generation (generate), continuous batching (serving), and numpy tree
conversion (convert)."""

from .convert import params_from_numpy
from .generate import decode_step, generate, init_cache, prefill
from .llama import LlamaConfig, LlamaModel, forward, init_params
from .serving import SlotServer

__all__ = [
    "LlamaConfig", "LlamaModel", "SlotServer", "decode_step", "forward",
    "generate", "init_cache", "init_params", "params_from_numpy", "prefill",
]
