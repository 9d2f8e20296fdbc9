"""The host's milliseconds a traced call in an ensemble's stack of its
members' outputs (span ``model.stack``: eager, a ``torch.stack`` a map;
replayed, the graph's launch), self time ÷ the calls, read as
``serve.prep_ms`` reads its span. Nothing where the program opens no
such span (a single network)."""

from bench_torch import harness

UNIT = "ms"
_spans = harness.module("metrics", "serve.prep_ms")


def read(record):
    return _spans.self_ms(record, "model.stack")
