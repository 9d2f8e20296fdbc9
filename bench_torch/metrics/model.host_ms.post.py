"""The host's milliseconds a traced call in the post-processing's dispatch
(span ``post``: ``pre_nms``, soft-NMS and the gathers), self time, read
as ``serve.prep_ms`` reads its span."""

from bench_torch import harness

UNIT = "ms"
_spans = harness.module("metrics", "serve.prep_ms")


def read(record):
    return _spans.self_ms(record, "post")
