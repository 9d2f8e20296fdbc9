"""The traced record of a run: torch.profiler over a few calls, reduced.

The busy time is the union of the device's kernel, copy and set spans
(as ``chip_smoke.py``'s ``profile_calls`` takes it); the breakdown names
the device operations that took the most time and the longest idle gaps
of the device by the host operation that was running at each gap's middle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

Span = Tuple[str, float, float]        # name, start, end (seconds)


def _profiled(fn: Callable[[int], object], calls: int, first: int, host: bool):
    """``fn(first + j)`` for ``calls`` calls under torch.profiler: the device
    spans, the host's operator spans (with ``host``) and the window's seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for j in range(calls):
            fn(first + j)
        window = time.perf_counter() - t0
    device: List[Span] = []
    hosted: List[Span] = []
    for e in prof.events():
        span = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        (device if e.device_type == DeviceType.CUDA else hosted).append(span)
    return device, hosted, window


def trace(fn: Callable[[int], object], calls: int, first: int) -> Dict:
    """Two traces of ``calls`` calls each. The first records the device
    alone, so that the host runs at about its unprofiled speed: its device
    spans (``device``) and the window's seconds (``traced_s``) give the busy
    and idle shares. The second records the host's operators too, which
    slows the host: its spans (``gap_device``, ``host``) name what the host
    was doing in the device's idle gaps."""
    device, _, traced_s = _profiled(fn, calls, first, host=False)
    gap_device, host, _ = _profiled(fn, calls, first + calls, host=True)
    return dict(device=device, traced_s=traced_s, gap_device=gap_device, host=host,
                calls=calls)


def union(spans: List[Span]) -> List[Tuple[float, float]]:
    """The spans' union as sorted disjoint intervals."""
    out: List[List[float]] = []
    for _, start, end in sorted(spans, key=lambda s: s[1]):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def busy_s(spans: List[Span]) -> float:
    return sum(b - a for a, b in union(spans))


def top_device_ops(spans: List[Span], n: int = 10) -> List[List]:
    total: Dict[str, float] = defaultdict(float)
    for name, start, end in spans:
        total[name] += end - start
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(device: List[Span], host: List[Span], n: int = 10) -> List[List]:
    """The device's idle gaps inside the traced window, summed by the
    innermost host operation running at each gap's middle (host spans nest,
    so it is the latest-starting one that still runs; one that started more
    than 64 operators back is the host running Python between operators)."""
    busy = union(device)
    total: Dict[str, float] = defaultdict(float)
    host = sorted(host, key=lambda s: s[1])
    starts = [s[1] for s in host]
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid, name = (a + b) / 2, "(host between operators)"
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(last - 64, -1), -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        total[name] += b - a
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
