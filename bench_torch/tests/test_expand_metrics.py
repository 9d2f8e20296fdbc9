"""The two readers of the fused expand's layouts on hand-made records: the
streamed share over either layout's launches, the streamed launches'
device time a call, and nothing where the trace holds no launch to read
or the record is not a serve's."""

from __future__ import annotations

from bench_torch import harness

READERS = harness.metric_readers()
RESIDENT = "void (anonymous namespace)::expand_dw_tc_kernel<3, 1>(__nv_bfloat16 const*)"
STREAMED = "void (anonymous namespace)::expand_dw_tc_kernel_streamed<3, 1>(__nv_bfloat16 const*)"
OTHER = "void (anonymous namespace)::fused_sepconv_tc_kernel<2, true>(__nv_bfloat16 const*)"


def record(device, kind="serve", calls=2):
    return dict(kind=kind, device=device, calls=calls)


def test_share_and_time_of_the_streamed_launches():
    device = [(RESIDENT, 0.0, 0.001), (STREAMED, 0.001, 0.004), (OTHER, 0.004, 0.005),
              (RESIDENT, 0.005, 0.006), (STREAMED, 0.006, 0.007)]
    assert READERS["kernel.expand_streamed_share"].read(record(device)) == 50.0
    assert abs(READERS["kernel.expand_streamed_ms"].read(record(device)) - 2.0) < 1e-9


def test_all_resident_reads_0_and_no_time():
    device = [(RESIDENT, 0.0, 0.001), (OTHER, 0.001, 0.002)]
    assert READERS["kernel.expand_streamed_share"].read(record(device)) == 0.0
    assert READERS["kernel.expand_streamed_ms"].read(record(device)) is None


def test_nothing_without_the_kernel_or_outside_a_serve():
    for name in ("kernel.expand_streamed_share", "kernel.expand_streamed_ms"):
        assert READERS[name].read(record([(OTHER, 0.0, 0.001)])) is None
        assert READERS[name].read(record([(STREAMED, 0.0, 0.001)], kind="train")) is None
