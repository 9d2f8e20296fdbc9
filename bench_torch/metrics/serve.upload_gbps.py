"""The frames' upload rate in the traced calls: Σ ``bytes`` taken from host
memory ÷ Σ duration of the ``serve.upload`` spans, in GB/s (spans read as
``serve.prep_ms`` reads them). A pageable upload stages through a pinned
buffer of CUDA's; a pinned one is a plain DMA."""

from bench_torch import harness

UNIT = "GB/s"
_spans = harness.module("metrics", "serve.prep_ms")


def read(record):
    t = _spans.traced(record)
    if t is None:
        return None
    uploads = [s for s in t[1] if s.name == "serve.upload"]
    ns = sum(s.end_ns - s.start_ns for s in uploads)
    if not ns:
        return None
    return sum(s.attrs.get("bytes", 0) for s in uploads) / ns
