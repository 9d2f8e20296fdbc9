"""The caller's milliseconds between two traced calls: Σ over consecutive
root ``serve`` spans of (next start − this end) ÷ (calls − 1), the time
outside the program, mostly the read-back's wait for the card (spans read
as ``serve.prep_ms`` reads them)."""

from bench_torch import harness

UNIT = "ms"
_spans = harness.module("metrics", "serve.prep_ms")


def read(record):
    t = _spans.traced(record)
    if t is None or len(t[0]) < 2:
        return None
    roots = t[0]
    return sum(b.start_ns - a.end_ns for a, b in zip(roots, roots[1:])) / 1e6 / (len(roots) - 1)
