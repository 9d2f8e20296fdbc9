"""The separable convs' hit share of the fused kernel: 100 × the launches of
``fused_sepconv`` kernels over those and ATen's depthwise
(``conv_depthwise2d``, the unfused chain's first operation) in the trace of
the device alone. 0 where every separable conv runs unfused, 100 where each
takes the kernel; nothing where the trace holds neither."""

UNIT = "%"


def read(record):
    if record["kind"] != "serve":
        return None
    fused = sum(1 for name, _, _ in record["device"] if "fused_sepconv" in name)
    unfused = sum(1 for name, _, _ in record["device"] if "conv_depthwise2d" in name)
    if fused + unfused == 0:
        return None
    return 100.0 * fused / (fused + unfused)
