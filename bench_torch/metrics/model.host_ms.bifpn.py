"""The host's milliseconds a traced call in the BiFPN's eager dispatch
(span ``model.bifpn``: the P6/P7 resampling and the fpn cells), self
time, read as ``serve.prep_ms`` reads its span."""

from bench_torch import harness

UNIT = "ms"
_spans = harness.module("metrics", "serve.prep_ms")


def read(record):
    return _spans.self_ms(record, "model.bifpn")
