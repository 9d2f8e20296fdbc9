"""How often the fused separable conv keeps W resident: 100 × the launches
of ``fused_sepconv_resident_kernel`` (the persistent kernel that Cin > 128
takes) over all launches of ``fused_sepconv`` kernels in the trace of the
device alone. 0 where every launch takes the first kernel (Cin ≤ 128, as
at d0); nothing where the trace holds no launch of either, or the record
is not a serve's."""

UNIT = "%"
KERNEL, RESIDENT = "fused_sepconv", "fused_sepconv_resident_kernel"


def read(record):
    if record["kind"] != "serve":
        return None
    launches = [name for name, _, _ in record["device"] if KERNEL in name]
    if not launches:
        return None
    return 100.0 * sum(RESIDENT in name for name in launches) / len(launches)
