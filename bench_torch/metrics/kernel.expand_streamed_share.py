"""How often the fused expand + depthwise streams its weights: 100 × the
launches of ``expand_dw_tc_kernel_streamed`` (16-byte copies, We^T through
the ring with x) over all launches of ``expand_dw_tc_kernel`` (either
layout) in the trace of the device alone. Below 100 where launches fall to
the plain loads, which keep We^T resident; nothing where the trace holds
no launch of the kernel."""

UNIT = "%"
KERNEL, STREAMED = "expand_dw_tc_kernel", "expand_dw_tc_kernel_streamed"


def read(record):
    if record["kind"] != "serve":
        return None
    launches = [name for name, _, _ in record["device"] if KERNEL in name]
    if not launches:
        return None
    return 100.0 * sum(STREAMED in name for name in launches) / len(launches)
