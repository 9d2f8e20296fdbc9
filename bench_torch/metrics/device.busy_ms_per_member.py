"""The card's busy milliseconds a traced call for one ensemble member: the
union of the device's spans in the trace that records the device alone
÷ the calls ÷ N, the members a frame (the traced roots' ``samples``).
Everything the card runs in a call counts (the upload, the stack and
the post-processing too), so it falls with a member's kernels and with
what the members share. Nothing where no span carries ``member`` (a
single network, or a program that marks no member)."""

from bench_torch import harness, profile

UNIT = "ms"
_members = harness.module("metrics", "model.host_ms.member")


def read(record):
    m = _members.members(record)
    if m is None:
        return None
    n = m[3]
    return 1e3 * profile.busy_s(record["device"]) / record["calls"] / n
