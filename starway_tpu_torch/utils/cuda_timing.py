"""Time of a call on an NVIDIA GPU, and the work an attention call does.

:func:`card_name` is the card's name and power limit, which every time
kept beside a number names.

:func:`event_ms` times one call between CUDA events (its host enqueue
included).  :func:`graph_us` times ``n`` calls captured in one CUDA graph
(no host enqueue in the figure), as a decode step sees a short call: many
back-to-back launches; :func:`cold_copies` gives each call its own copy
of the operand, so that no call finds it in the L2 cache.
:func:`visible_pairs` counts the (query, key) pairs an attention call
computes, the basis of its flop count.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch


def card_name() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median ms of one ``fn()`` on the current stream, between CUDA
    events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_us(call, copies, n: int = 20) -> float:
    """Device us of one ``call(copy)``: n calls on ``copies`` in turn,
    captured in one CUDA graph, median of 10 replays."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(3):
            call(copies[i % len(copies)])
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(n):
            call(copies[i % len(copies)])
    graph.replay()
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / n)
    return statistics.median(times)


def cold_copies(t, min_bytes: int = 256 << 20) -> list:
    """``t`` and enough copies that cycling through them reads more than
    the 50 MB L2 between two uses of one copy."""
    n = max(1, -(-min_bytes // (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(n - 1)]


def visible_pairs(s_len: int, kv_len: int, q_offset: int = 0,
                  kv_offset: int = 0, causal: bool = True,
                  window=None) -> int:
    """(q, k) pairs that attention of ``s_len`` queries at global position
    ``q_offset`` over ``kv_len`` keys at ``kv_offset`` computes: all of
    them without a causal mask, else those with ``k <= q`` (and ``k > q -
    window``)."""
    if not causal:
        return s_len * kv_len
    qp = q_offset + np.arange(s_len)[:, None]
    kp = kv_offset + np.arange(kv_len)[None, :]
    vis = qp >= kp
    if window is not None:
        vis &= kp > qp - window
    return int(vis.sum())
