"""Tracing and telemetry on ``torch.profiler``.

* :func:`trace_span` / :func:`profile_to` -- annotate host-side phases so
  they show up beside the device kernels in a ``torch.profiler`` trace
  (Perfetto / chrome://tracing).
* :class:`OpTimer` -- a small host-side span recorder (p50/p95/mean
  summaries), the same vocabulary as the JAX package's.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import defaultdict
from pathlib import Path
from typing import Iterator


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """A named range on the profiler timeline when a trace is active (a
    cheap no-op otherwise)."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block (host, and the card when CUDA is available) and
    write a chrome trace to ``log_dir/trace.json``.  Yields the profiler,
    whose ``key_averages()`` sum the kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class OpTimer:
    """Accumulates named durations; summarises like the bench metrics."""

    def __init__(self) -> None:
        self._samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out: dict[str, dict[str, float]] = {}
        for name, xs in self._samples.items():
            if not xs:
                continue
            s = sorted(xs)
            out[name] = {
                "count": float(len(s)),
                "mean_us": statistics.fmean(s) * 1e6,
                "p50_us": s[len(s) // 2] * 1e6,
                "p95_us": s[min(len(s) - 1, int(len(s) * 0.95))] * 1e6,
                "total_s": sum(s),
            }
        return out
