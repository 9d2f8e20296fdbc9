"""The memory the driver's CUDA-graph pool holds, in GiB: the largest
``pool_bytes`` over the traced root ``serve`` spans (the program sets it
from the allocator's segments of the pool while a profiler runs), read
as ``serve.prep_ms`` reads its spans. ``peak_mem_gib`` leaves this pool
out: a replay allocates nothing. Nothing where no root carries it."""

from bench_torch import harness

UNIT = "GiB"
_spans = harness.module("metrics", "serve.prep_ms")


def read(record):
    traced = _spans.traced(record)
    if traced is None:
        return None
    held = [r.attrs["pool_bytes"] for r in traced[0] if "pool_bytes" in r.attrs]
    return max(held) / 2**30 if held else None
