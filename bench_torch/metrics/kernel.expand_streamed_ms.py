"""The streamed layout's device time a call (ms): the sum of the spans of
``expand_dw_tc_kernel_streamed`` in the trace of the device alone over the
traced calls. Nothing where the trace holds no launch of it."""

UNIT = "ms"
STREAMED = "expand_dw_tc_kernel_streamed"


def read(record):
    if record["kind"] != "serve":
        return None
    spans = [e - s for name, s, e in record["device"] if STREAMED in name]
    if not spans:
        return None
    return 1e3 * sum(spans) / record["calls"]
