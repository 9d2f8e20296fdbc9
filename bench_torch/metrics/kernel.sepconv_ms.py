"""The fused separable-conv kernel's device time a call (ms): the sum of its
launches' spans in the trace of the device alone over the traced calls.
Nothing where the trace holds no launch of it."""

UNIT = "ms"


def read(record):
    if record["kind"] != "serve":
        return None
    spans = [e - s for name, s, e in record["device"] if "fused_sepconv" in name]
    if not spans:
        return None
    return 1e3 * sum(spans) / record["calls"]
