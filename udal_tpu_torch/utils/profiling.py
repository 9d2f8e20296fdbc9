"""Tracing and latency hooks.

Port of ``udal_tpu/utils/profiling.py``: ``trace`` records a
``torch.profiler`` trace (host and, with a card, CUDA activities) and
writes it as a Chrome trace JSON under ``logdir``, readable in
``chrome://tracing`` or Perfetto (no TensorBoard plugin needed);
``device_memory_stats`` gives each card's allocated bytes; and
``LatencyRecorder`` collects wall-clock latencies with an IQR-filtered
summary.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (yields the ``torch.profiler.profile``); on exit
    write ``<logdir>/trace_<pid>_<ns>.json`` in the Chrome trace format."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_memory_stats() -> Dict[str, float]:
    """Bytes allocated on each card, ``{"cuda:<i>": bytes}``; ``{}`` without
    one (as the JAX function gives on a backend with no statistics)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": float(torch.cuda.memory_allocated(i))
            for i in range(torch.cuda.device_count())}


class LatencyRecorder:
    """Wall-clock step latencies with IQR-filtered summary."""

    def __init__(self):
        self.samples: List[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        r = np.asarray(self.samples)
        if not len(r):
            return {}
        q1, q3 = np.percentile(r, [25, 75])
        iqr = q3 - q1
        keep = r[(r >= q1 - 1.5 * iqr) & (r <= q3 + 1.5 * iqr)]
        return {"mean": float(keep.mean()), "std": float(keep.std()),
                "median": float(np.median(keep)), "n": int(len(keep)),
                "n_outliers": int(len(r) - len(keep))}
