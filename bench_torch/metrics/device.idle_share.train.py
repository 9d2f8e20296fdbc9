"""The share of the traced training steps' window in which the card runs
nothing: 100 − the union of the device's spans over the window's seconds,
both from the trace that records the device alone, as
``device.idle_share.serve`` reads a serve's."""

from bench_torch import profile

UNIT = "%"


def read(record):
    if record["kind"] != "train":
        return None
    return 100.0 * (1.0 - profile.busy_s(record["device"]) / record["traced_s"])
