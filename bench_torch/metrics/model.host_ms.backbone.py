"""The host's milliseconds a traced call in the backbone's eager dispatch
(span ``model.backbone``: the MC path's shared prefix and block-0 fold,
and the blocks at B or T·B), self time, read as ``serve.prep_ms`` reads
its span."""

from bench_torch import harness

UNIT = "ms"
_spans = harness.module("metrics", "serve.prep_ms")


def read(record):
    return _spans.self_ms(record, "model.backbone")
