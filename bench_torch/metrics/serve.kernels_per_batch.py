"""Device kernels, copies and sets a served batch, counted in the trace:
the eager host's dispatch, which a fused or graph-captured serve cuts."""

UNIT = "kernels"


def read(record):
    if record["kind"] != "serve":
        return None
    return len(record["device"]) / record["calls"]
