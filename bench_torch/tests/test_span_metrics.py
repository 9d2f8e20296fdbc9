"""The eight readers of the program's spans on hand-made buffers and
records, against values computed by hand: self time less the spans
inside, the caller's waits between roots, the upload rate, only the
calls traced with the device alone, the card's idle gaps inside the
model's dispatch against those between calls, and nothing where the
record is not a serve's or the program records no spans."""

from __future__ import annotations

import pytest

from bench_torch import harness
from udal_tpu_torch.utils import profiling

READERS = harness.metric_readers()
SPAN_READERS = ("serve.host_wait_ms", "serve.upload_gbps", "serve.prep_ms",
                "model.host_ms.backbone", "model.host_ms.bifpn", "model.host_ms.heads",
                "model.host_ms.post")
MS = 1_000_000      # ns


def _call(first_id: int, t0: int, stages, wait: int):
    """A root ``serve`` span at ``t0`` (ns) with ``stages`` [(name, ms,
    attrs)] back to back from t0 + 0.5 ms, its end 0.5 ms after the last;
    returns the spans and the next call's start, ``wait`` ns later."""
    root = profiling.Span("serve", first_id, None, first_id, t0)
    out, t, sid = [root], t0 + MS // 2, first_id
    for name, ms, attrs in stages:
        sid += 1
        out.append(profiling.Span(name, sid, first_id, first_id, t, t + int(ms * MS),
                                  dict(attrs)))
        t += int(ms * MS)
    root.end_ns = t + MS // 2
    return out, root.end_ns + wait


def _buffer():
    """Two calls traced with the device alone (4 ms apart), then a call of
    the second trace (6 ms later) that the readers leave out. Call 1's
    ``serve.prep`` holds a 0.5 ms span, so its self time is 1.5 ms."""
    a, t = _call(1, 0, [("serve.upload", 1, dict(bytes=4_000_000, pinned=False)),
                        ("serve.prep", 2, {}), ("model.backbone", 3, {}),
                        ("model.bifpn", 0.5, {}), ("model.heads", 1, {}), ("post", 1.5, {})],
                 4 * MS)
    inner = a[2]
    a.append(profiling.Span("inner", 99, inner.id, 1, inner.start_ns + MS // 2,
                            inner.start_ns + MS))
    b, t = _call(20, t, [("serve.upload", 1, dict(bytes=4_000_000, pinned=False)),
                         ("serve.prep", 1, {}), ("model.backbone", 1.5, {}),
                         ("model.backbone", 0.5, {}), ("model.bifpn", 1.5, {}),
                         ("model.heads", 2, {}), ("post", 0.5, {})], 6 * MS)
    c, _ = _call(40, t, [("serve.upload", 9, dict(bytes=1, pinned=False)),
                         ("serve.prep", 9, {}), ("model.backbone", 9, {}),
                         ("model.bifpn", 9, {}), ("model.heads", 9, {}), ("post", 9, {})], 0)
    return a + b + c


WANT = {"serve.host_wait_ms": 4.0, "serve.upload_gbps": 8e6 / 2e6,
        "serve.prep_ms": (1.5 + 1.0) / 2, "model.host_ms.backbone": (3 + 1.5 + 0.5) / 2,
        "model.host_ms.bifpn": (0.5 + 1.5) / 2, "model.host_ms.heads": (1 + 2) / 2,
        "model.host_ms.post": (1.5 + 0.5) / 2}


def _record(kind="serve"):
    """The second trace's device spans and host markers (seconds): busy
    [0, 1], [2, 3], [5, 6], [6.5, 7]; ``model.heads`` spans the gap (1, 2),
    ``post`` the gap (6, 6.5), ``serve.prep`` the gap (3, 5) between calls."""
    device = [("k", 0.0, 1.0), ("k", 2.0, 2.5), ("copy", 2.4, 3.0), ("k", 5.0, 6.0),
              ("k", 6.5, 7.0)]
    host = [("udal:model.heads>", 1.2, 1.21), ("aten::conv2d", 1.3, 1.4),
            ("udal:model.heads<", 1.79, 1.8), ("udal:serve.prep>", 3.1, 3.11),
            ("udal:serve.prep<", 4.9, 4.91), ("udal:post>", 6.1, 6.11),
            ("udal:post<", 6.39, 6.4)]
    return dict(kind=kind, calls=2, device=device, gap_device=device, host=host,
                traced_s=7.0)


@pytest.fixture
def buffer(monkeypatch):
    spans = _buffer()
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return spans


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_by_hand(buffer, name):
    assert READERS[name].read(_record()) == pytest.approx(WANT[name], rel=1e-9)


def test_idle_gaps_inside_the_dispatch_against_those_between_calls():
    # gaps (1, 2) inside model.heads and (6, 6.5) inside post count; (3, 5),
    # inside serve.prep between calls, does not: 1.5 of 3.5 s
    got = READERS["device.idle_in_dispatch.serve"].read(_record())
    assert got == pytest.approx(100 * 1.5 / 3.5, rel=1e-12)


@pytest.mark.parametrize("name", SPAN_READERS + ("device.idle_in_dispatch.serve",))
def test_nothing_for_a_record_not_a_serves(buffer, name):
    assert READERS[name].read(_record(kind="train")) is None


@pytest.mark.parametrize("name", SPAN_READERS + ("device.idle_in_dispatch.serve",))
def test_nothing_where_the_program_records_no_spans(monkeypatch, name):
    """As the parent program reads: no ``spans`` in its profiling module,
    no markers in its trace."""
    monkeypatch.delattr(profiling, "spans")
    record = _record()
    record["host"] = [e for e in record["host"] if not e[0].startswith("udal:")]
    assert READERS[name].read(record) is None


def test_fewer_roots_than_traced_calls_read_nothing(monkeypatch):
    spans = _buffer()[:8]       # call 1 alone
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    for name in SPAN_READERS:
        assert READERS[name].read(_record()) is None
