"""The host's milliseconds a traced call in the heads' eager dispatch (span
``model.heads``: the T-fold repeat where only the heads drop out, the
class and box nets, the NHWC views and the sample split), self time,
read as ``serve.prep_ms`` reads its span."""

from bench_torch import harness

UNIT = "ms"
_spans = harness.module("metrics", "serve.prep_ms")


def read(record):
    return _spans.self_ms(record, "model.heads")
