"""The Llama model and its paths: config, forward and the train step
(llama), KV-cache decode and generation (generate), continuous batching
(serving), the training harness (trainer), and numpy tree conversion
(convert)."""

from .convert import params_from_numpy
from .generate import decode_step, generate, init_cache, prefill
from .llama import (LlamaConfig, LlamaModel, forward, init_params, loss_fn,
                    make_train_step)
from .serving import SlotServer
from .trainer import Trainer

__all__ = [
    "LlamaConfig", "LlamaModel", "SlotServer", "Trainer", "decode_step",
    "forward", "generate", "init_cache", "init_params", "loss_fn",
    "make_train_step", "params_from_numpy", "prefill",
]
