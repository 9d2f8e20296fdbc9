"""The port's serve-path spans (``utils/profiling.py`` ``span``) on the CPU.

Off without a profiler; under ``torch.profiler`` one root ``serve`` span
a call with its stages in order, each with its two empty markers on the
profiler's clock; the roots of back-to-back calls tile the loop; the
buffer stays bounded; the served tuples do not depend on tracing; and
``trace`` writes the spans into its Chrome trace. On the tiny d0 of
``test_torch_fixtures.py``, random weights.
"""

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_fixtures import HEAD_ONLY, IMAGE, small_overrides  # noqa: E402
from udal_tpu_torch.apps.serving import ServingDriver  # noqa: E402
from udal_tpu_torch.utils import profiling  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
B = 2
NATIVE = (90, 150)
STAGES = ["serve", "serve.upload", "serve.prep", "model.backbone", "model.bifpn",
          "model.heads", "post"]
# the MC fast path opens the backbone twice: the shared prefix and block-0
# fold, then blocks 1 on at T·B
MC_STAGES = STAGES[:4] + ["model.backbone"] + STAGES[4:]


def _server(extra=None, samples=3, seed=0):
    mc = extra is not None
    overrides = dict(small_overrides(mc, samples), **(extra or {}))
    return ServingDriver.create("efficientdet-d0", overrides=overrides, device="cpu",
                                mc_seed=seed)


@pytest.fixture(scope="module")
def servers():
    return dict(det=_server(), mc=_server({}), head=_server(dict(HEAD_ONLY)))


def _frames(hw=(100, 160), seed=3):
    return np.random.RandomState(seed).randint(0, 256, (B,) + hw + (3,)).astype(np.uint8)


def _warp():
    h, w = NATIVE
    scale = min(IMAGE / h, IMAGE / w)
    sh, sw = int(h * scale), int(w * scale)
    return dict(valid_hw=np.asarray([[sh, sw]] * B, np.int32),
                image_scales=np.full((B,), 1.0 / scale, np.float32),
                warp_scale=np.asarray([[sh / h, sw / w]] * B, np.float32),
                warp_offset=np.zeros((B, 2), np.float32))


CALLS = {
    "serve": ("det", lambda d: d.serve(_frames()), STAGES),
    "uint8_warp": ("det", lambda d: d.serve_preprocessed_uint8(_frames(NATIVE), **_warp()),
                   STAGES),
    "mc_fast": ("mc", lambda d: d.serve(_frames()), MC_STAGES),
    "head_only": ("head", lambda d: d.serve_preprocessed_uint8(_frames(NATIVE), **_warp()),
                  STAGES),
}


def _profiled(fn, *args):
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, profiling.spans(), prof


def test_without_a_profiler_nothing_is_recorded(servers):
    profiling.clear_spans()
    servers["det"].serve(_frames())
    assert profiling.spans() == []
    off = profiling.span("serve")
    assert off is profiling.span("model.heads", batch=3) is profiling._OFF
    with off as s:
        assert s is None


@pytest.mark.parametrize("path", sorted(CALLS))
def test_one_root_a_call_and_its_stages_in_order(servers, path):
    which, call, stages = CALLS[path]
    _, spans, _ = _profiled(call, servers[which])
    assert [s.name for s in spans] == stages
    root = spans[0]
    assert root.parent is None and root.root == root.id
    assert root.attrs == dict(entry="serve" if path in ("serve", "mc_fast")
                              else "serve_preprocessed_uint8",
                              batch=B, samples=1 if which == "det" else 3)
    assert all(s.parent == root.id and s.root == root.id for s in spans[1:])
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans[1:], spans[2:]))
    assert root.start_ns <= spans[1].start_ns and spans[-1].end_ns <= root.end_ns
    heads = next(s for s in spans if s.name == "model.heads")
    assert heads.attrs["batch"] == (B if which == "det" else 3 * B)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_upload_counts_the_frames_bytes(servers, kind):
    frames = _frames()
    given = frames if kind == "numpy" else torch.from_numpy(frames)
    _, spans, _ = _profiled(servers["det"].serve, given)
    upload = [s for s in spans if s.name == "serve.upload"]
    assert len(upload) == 1
    assert upload[0].attrs == dict(bytes=frames.nbytes, pinned=False)


def test_markers_pair_every_span_in_order_and_enclose_nothing(servers):
    _, spans, prof = _profiled(CALLS["mc_fast"][1], servers["mc"])
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    marks = [e for e in events if e.name.startswith(profiling.MARKER)]
    want = []
    for s in spans:     # the buffer's order of starts and ends
        want += [(s.start_ns, f"udal:{s.name}>"), (s.end_ns, f"udal:{s.name}<")]
    assert [e.name for e in marks] == [name for _, name in sorted(want)]
    for m in marks:
        assert not m.cpu_children
        inside = [e for e in events if e is not m and e.thread == m.thread
                  and m.time_range.start < e.time_range.start < m.time_range.end]
        assert inside == []


def test_roots_of_back_to_back_calls_tile_the_loop(servers):
    d = servers["det"]
    frames = _frames()
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.perf_counter_ns()
        for _ in range(3):
            d.serve(frames)
        loop = time.perf_counter_ns() - t0
    roots = [s for s in profiling.spans() if s.parent is None]
    assert len(roots) == 3
    durations = sum(r.end_ns - r.start_ns for r in roots)
    gaps = sum(b.start_ns - a.end_ns for a, b in zip(roots, roots[1:]))
    assert all(b.start_ns >= a.end_ns for a, b in zip(roots, roots[1:]))
    assert abs(durations + gaps - loop) <= 0.01 * loop


def test_the_buffer_stays_bounded():
    profiling.clear_spans()
    old = profiling.Span("old", 0, None, 0, 0, 0)
    profiling._BUFFER.extend([old] * profiling.MAX_SPANS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for name in ("a", "b", "c"):
            with profiling.span(name):
                pass
    spans = profiling.spans()
    assert len(spans) == profiling.MAX_SPANS == 65536
    assert [s.name for s in spans[-3:]] == ["a", "b", "c"] and spans[0] is old
    profiling.clear_spans()
    assert profiling.spans() == []


def test_served_tuples_are_the_same_with_tracing_on_and_off():
    frames = _frames()
    off = _server({}, seed=11).serve(frames)
    on, spans, _ = _profiled(_server({}, seed=11).serve, frames)
    assert len(spans) == len(MC_STAGES)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_threads_spans_do_not_nest_under_another_threads():
    profiling.clear_spans()
    seen = {}

    def other():
        with profiling.span("model.heads") as s:
            seen["s"] = s

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("serve") as root:
            with profiling.span("serve") as again:
                assert again is None        # the same stage entered again
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
    assert seen["s"].parent is None and seen["s"].root == seen["s"].id
    assert [s.name for s in profiling.spans()] == ["serve", "model.heads"]
    assert root.end_ns is not None


def test_trace_writes_the_spans_on_their_own_row(servers, tmp_path):
    profiling.clear_spans()
    with profiling.trace(str(tmp_path)):
        servers["head"].serve(_frames())
    spans = profiling.spans()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    rows = [e for e in events if e.get("cat") == "udal_span"]
    assert [e["name"] for e in rows] == [s.name for s in spans] == STAGES
    assert {e["tid"] for e in rows} == {"udal spans"}
    opens = sorted((e for e in events if str(e.get("name")).endswith(">")
                    and str(e.get("name")).startswith("udal:")), key=lambda e: e["ts"])
    assert [e["ts"] for e in rows] == [e["ts"] for e in opens]
    root = rows[0]
    assert all(root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"]
               for e in rows[1:])
    assert [e["args"]["id"] for e in rows] == [s.id for s in spans]


def test_every_span_has_its_metric_in_the_benchmark():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer"]}
    assert sorted(profiling.SPANS) == sorted(STAGES)
    for metric in profiling.SPANS.values():
        assert metric in names
        assert (REPO / "bench_torch" / "metrics" / f"{metric}.py").is_file()
