"""The share of the traced calls' window in which the card runs nothing:
100 − the union of the device's spans over the window's seconds, both
from the trace that records the device alone (``profile.trace``), so the
host runs at about its unprofiled speed and the share is never below 0."""

from bench_torch import profile

UNIT = "%"


def read(record):
    if record["kind"] != "serve":
        return None
    return 100.0 * (1.0 - profile.busy_s(record["device"]) / record["traced_s"])
