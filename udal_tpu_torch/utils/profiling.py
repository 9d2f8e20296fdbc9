"""Tracing: the program's spans, a Chrome trace, device memory.

Port of ``udal_tpu/utils/profiling.py``: ``trace`` records a
``torch.profiler`` trace (host and, with a card, CUDA activities) and
writes it as a Chrome trace JSON under ``logdir``, readable in
``chrome://tracing`` or Perfetto (no TensorBoard plugin needed), with the
program's spans on a row of their own; ``device_memory_stats`` gives each
card's allocated bytes; ``KernelLaunches`` counts the port's kernels in a
trace of the card.

``span(name, **attrs)`` times one stage of the serve path where it runs
(``SPANS`` names each stage and the benchmark metric that reads it). It
records only while a ``torch.profiler`` session is active in the process;
otherwise it returns one shared no-op context, so an unprofiled run pays a
function call and a flag read a span. A recorded span goes into a bounded
buffer (``spans()``, ``clear_spans()``) with its id, its parent's (from a
per-thread stack), its root's, its start and end from
``time.perf_counter_ns`` and its attributes. Right after its start and
right before its end it opens and at once closes an empty
``record_function`` marker, ``udal:<name>>`` and ``udal:<name><``: they
enclose no operator, so they put nothing on the device's timeline, and
in a trace of the host's operators they place the span on the profiler's
clock, the clock of the device's kernels.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as _autograd_profiler

# each span the program opens, and the benchmark metric that reads it
# (``bench_torch/metrics/``); ``device.idle_in_dispatch.serve`` reads the
# markers of the ``model.*`` spans and of ``post``, ``model.graph_replay_share``
# the ``graph`` attribute of the ``serve`` root (``annotate``),
# ``serve.graph_pool_gib`` its ``pool_bytes``, and ``model.host_ms.member``
# the ensemble members' stage spans, which carry attribute ``member``
SPANS = {
    "serve": "serve.host_wait_ms",
    "serve.upload": "serve.upload_gbps",
    "serve.prep": "serve.prep_ms",
    "model.backbone": "model.host_ms.backbone",
    "model.bifpn": "model.host_ms.bifpn",
    "model.heads": "model.host_ms.heads",
    "model.stack": "model.host_ms.stack",
    "post": "model.host_ms.post",
}
MAX_SPANS = 65536
MARKER = "udal:"
# the port's kernels by the names a trace of the card gives them, for each
# wrapper's launch counter: the fused depthwise (fast path, general path),
# the fused expand + depthwise (bf16 resident and streamed, f32), soft-NMS,
# the fused separable conv (Cin <= 128, and the resident kernel beyond)
KERNELS = {"fused_dw": ("fused_dw_rows_kernel", "fused_dw_kernel"),
           "fused_expand_dw": ("expand_dw_tc_kernel", "expand_dw_tc_kernel_streamed",
                               "fused_expand_dw_kernel"),
           "soft_nms": ("soft_nms_kernel",),
           "fused_sepconv": ("fused_sepconv_tc_kernel", "fused_sepconv_resident_kernel")}


@dataclasses.dataclass(eq=False)
class Span:
    """One recorded stage; ``end_ns`` is None while it is open."""
    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: Optional[int] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


_BUFFER: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_THREAD = threading.local()
_OFF = contextlib.nullcontext()


def _marker(name: str) -> None:
    with torch.profiler.record_function(name):
        pass


class _Recording:
    """The context of a span while the profiler runs: yields the ``Span``
    (whose ``attrs`` the caller may still fill), or None inside an open
    span of the same name (the same stage entered again, as an entry
    that calls another)."""

    __slots__ = ("name", "attrs", "span")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs, self.span = name, attrs, None

    def __enter__(self) -> Optional[Span]:
        stack = getattr(_THREAD, "stack", None)
        if stack is None:
            stack = _THREAD.stack = []
        if any(s.name == self.name for s in stack):
            return None
        parent = stack[-1] if stack else None
        sid = next(_IDS)
        s = Span(self.name, sid, parent.id if parent else None,
                 parent.root if parent else sid, time.perf_counter_ns(), attrs=self.attrs)
        _marker(f"{MARKER}{self.name}>")
        stack.append(s)
        _BUFFER.append(s)
        self.span = s
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        if s is not None:
            _THREAD.stack.pop()
            _marker(f"{MARKER}{s.name}<")
            s.end_ns = time.perf_counter_ns()
        return False


def span(name: str, **attrs):
    """A context that records stage ``name`` while a profiler runs, else
    the shared no-op. The caller evaluates ``attrs``: pass cheap ones and
    set costly ones on the yielded ``Span`` when it is not None."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, attrs)


def annotate(name: str, **attrs) -> None:
    """Set ``attrs`` on the innermost recording span called ``name``; nothing
    where none is open or no profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    for s in reversed(getattr(_THREAD, "stack", ())):
        if s.name == name:
            s.attrs.update(attrs)
            return


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most ``MAX_SPANS``)."""
    return list(_BUFFER)


def clear_spans() -> None:
    _BUFFER.clear()


def _add_spans(path: str, recorded: List[Span]) -> None:
    """Write ``recorded`` into the Chrome trace at ``path`` as complete
    events on a row of their own, each from its start marker to its end
    marker (the k-th span of a name pairs with the k-th markers of it)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    marks = collections.defaultdict(list)
    for e in events:
        if (str(e.get("name", "")).startswith(MARKER) and e.get("ph") == "X"
                and e.get("cat") != "gpu_user_annotation"):
            marks[e["name"]].append(e)
    for v in marks.values():
        v.sort(key=lambda e: e["ts"])
    taken = collections.Counter()
    added = []
    for s in recorded:
        k = taken[s.name]
        taken[s.name] += 1
        opens, closes = marks[f"{MARKER}{s.name}>"], marks[f"{MARKER}{s.name}<"]
        if s.end_ns is None or k >= len(opens) or k >= len(closes):
            continue
        o, c = opens[k], closes[k]
        added.append(dict(ph="X", cat="udal_span", name=s.name, pid=o["pid"], tid="udal spans",
                          ts=o["ts"], dur=c["ts"] + c.get("dur", 0) - o["ts"],
                          args=dict(s.attrs, id=s.id, parent=s.parent, root=s.root)))
    if added:
        events.append(dict(ph="M", name="thread_name", pid=added[0]["pid"], tid="udal spans",
                           args=dict(name="udal spans")))
        events.extend(added)
        with open(path, "w") as f:
            json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (yields the ``torch.profiler.profile``); on exit
    write ``<logdir>/trace_<pid>_<ns>.json`` in the Chrome trace format,
    the spans recorded in the block on their own row."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    since = next(_IDS)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        _add_spans(path, [s for s in spans() if s.id > since])


def device_memory_stats() -> Dict[str, float]:
    """Bytes allocated on each card, ``{"cuda:<i>": bytes}``; ``{}`` without
    one (as the JAX function gives on a backend with no statistics)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": float(torch.cuda.memory_allocated(i))
            for i in range(torch.cuda.device_count())}


class KernelLaunches:
    """The port's kernels launched on the card from ``start()`` to
    ``stop()`` (or in a ``with`` block), read from a ``torch.profiler``
    trace of CUDA activity: ``counts`` is (fused_dw, fused_expand_dw,
    soft_nms) as ``KERNELS`` names them, ``fast`` the fused depthwise's
    fast-path launches, ``sepconv`` the fused separable conv's launches
    (either kernel), ``sepconv_resident`` those of its resident kernel.
    A replayed CUDA graph launches its kernels without
    their wrappers, whose counters see the eager and captured calls alone;
    the trace sees every launch."""

    # seconds of an idle card on each side of the traced work: the profiler
    # drops a kernel whose time on the card's clock falls outside its
    # window, and that clock may stray from the host's over a long process
    MARGIN_S = 0.05

    def __init__(self):
        self.counts, self.fast, self.sepconv, self._prof = (0, 0, 0), 0, 0, None
        self.sepconv_resident = 0

    def start(self) -> "KernelLaunches":
        """Start a trace (ending one that runs); without a card, count 0."""
        self.stop()
        self.counts, self.fast, self.sepconv, self.sepconv_resident = (0, 0, 0), 0, 0, 0
        if torch.cuda.is_available():
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.start()
            torch.cuda.synchronize()
            time.sleep(self.MARGIN_S)
        return self

    def stop(self) -> "KernelLaunches":
        """End the trace (if one runs) and count its kernels."""
        if self._prof is None:
            return self
        torch.cuda.synchronize()
        time.sleep(self.MARGIN_S)
        prof, self._prof = self._prof, None
        prof.stop()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]

        def launched(kernel: str) -> int:
            return sum(1 for n in names if re.search(rf"\b{kernel}\b", n))

        by_wrapper = {w: sum(launched(k) for k in ks) for w, ks in KERNELS.items()}
        self.counts = tuple(by_wrapper[w] for w in ("fused_dw", "fused_expand_dw", "soft_nms"))
        self.fast = launched(KERNELS["fused_dw"][0])
        self.sepconv = by_wrapper["fused_sepconv"]
        self.sepconv_resident = launched(KERNELS["fused_sepconv"][1])
        return self

    __enter__ = start

    def __exit__(self, *exc) -> None:
        self.stop()
