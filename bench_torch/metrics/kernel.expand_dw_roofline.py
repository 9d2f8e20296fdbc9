"""The fused expand + depthwise kernel's share of its roofline: the sum of
its launches' bounds (``roofline.expand_bound`` of each launch's shapes)
over the sum of its device time in the trace. Nothing where the trace
does not hold the call's launches of ``expand_dw_tc_kernel``."""

UNIT = "%"
KERNEL = "expand_dw_tc_kernel"


def read(record):
    if record["kind"] != "serve" or not record["expand_bound_s"]:
        return None
    spans = [(s, e) for name, s, e in record["device"] if KERNEL in name]
    launches = record.get("expand_launches_per_call")
    if not spans or (launches is not None and len(spans) != launches * record["calls"]):
        return None
    return 100.0 * record["expand_bound_s"] * record["calls"] / sum(e - s for s, e in spans)
