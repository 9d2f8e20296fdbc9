"""The reader of the fused separable conv's resident share on hand-made
records: the share over mixed launches of its two kernels, 0 with no
resident launch, and nothing where the trace holds no launch of the
fused separable conv or the record is not a serve's."""

from __future__ import annotations

from bench_torch import harness

READERS = harness.metric_readers()
FIRST = "void (anonymous namespace)::fused_sepconv_tc_kernel<2, true>(__nv_bfloat16 const*)"
RESIDENT = ("void (anonymous namespace)::fused_sepconv_resident_kernel<true, true>"
            "(__nv_bfloat16 const*)")
OTHER = "void (anonymous namespace)::expand_dw_tc_kernel_streamed<3, 1>(__nv_bfloat16 const*)"


def record(device, kind="serve", calls=2):
    return dict(kind=kind, device=device, calls=calls)


def share(device, **kw):
    return READERS["kernel.sepconv_resident_share"].read(record(device, **kw))


def test_share_of_the_resident_launches():
    device = [(RESIDENT, 0.0, 0.001), (OTHER, 0.001, 0.002), (FIRST, 0.002, 0.003),
              (RESIDENT, 0.003, 0.004), (RESIDENT, 0.004, 0.005)]
    assert share(device) == 75.0
    assert share([(RESIDENT, 0.0, 0.001)] * 3) == 100.0


def test_no_resident_launch_reads_0():
    assert share([(FIRST, 0.0, 0.001), (OTHER, 0.001, 0.002)]) == 0.0


def test_nothing_without_the_kernel_or_outside_a_serve():
    assert share([(OTHER, 0.0, 0.001)]) is None
    assert share([]) is None
    assert share([(RESIDENT, 0.0, 0.001)], kind="train") is None
