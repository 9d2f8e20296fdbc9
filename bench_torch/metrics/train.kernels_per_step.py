"""Device kernels, copies and sets a training step, counted in the trace
that records the device alone: the eager forward and backward's
dispatch, which fusion or a captured step cuts."""

UNIT = "kernels"


def read(record):
    if record["kind"] != "train":
        return None
    return len(record["device"]) / record["calls"]
