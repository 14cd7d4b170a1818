"""Device time of a short call on an NVIDIA GPU, as a decode step sees it:
many back-to-back launches, each reading its weight from device memory.

:func:`graph_us` times ``n`` calls captured in one CUDA graph (no host
enqueue in the figure); :func:`cold_copies` gives each call its own copy
of the operand, so that no call finds it in the L2 cache.
"""

from __future__ import annotations

import statistics

import torch


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
