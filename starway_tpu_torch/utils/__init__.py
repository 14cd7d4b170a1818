"""Utilities of the training path: tracing and telemetry on
``torch.profiler``, checkpointing (npz), token batching, tree helpers and
the AdamW optimizer."""

from .data import TokenBatcher, load_tokens
from .optim import adamw
from .trace import OpTimer, profile_to, trace_span

__all__ = ["OpTimer", "TokenBatcher", "adamw", "load_tokens", "profile_to",
           "trace_span"]
