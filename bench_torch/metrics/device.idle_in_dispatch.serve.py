"""Of the card's idle time in the trace that records the host's operators,
the share spent waiting on the model's eager dispatch: of the idle gaps
between the union intervals of ``gap_device``, the share of their seconds
whose middle falls inside a ``model.*`` or ``post`` span, each rebuilt
from its two markers in ``host`` (``udal:<span>>`` and ``udal:<span><``,
on the profiler's clock, the device spans' clock). The rest waits on the
upload, the preparation, the read-back or the caller. Nothing where the
program leaves no markers."""

import bisect

from bench_torch import profile

UNIT = "%"
MARKER = "udal:"


def dispatch_spans(host):
    """(start, end) of each ``model.*`` or ``post`` span, from its markers."""
    opened, out = {}, []
    for name, start, end in sorted(host, key=lambda s: s[1]):
        if not name.startswith(MARKER):
            continue
        stage, edge = name[len(MARKER):-1], name[-1]
        if not (stage.startswith("model.") or stage == "post"):
            continue
        if edge == ">":
            opened.setdefault(stage, []).append(start)
        elif edge == "<" and opened.get(stage):
            out.append((opened[stage].pop(), end))
    return out


def read(record):
    if record["kind"] != "serve":
        return None
    spans = profile.union([("", a, b) for a, b in dispatch_spans(record["host"])])
    busy = profile.union(record["gap_device"])
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
    total = sum(b - a for a, b in gaps)
    if not spans or total <= 0:
        return None
    starts = [a for a, _ in spans]
    inside = 0.0
    for a, b in gaps:
        j = bisect.bisect_right(starts, (a + b) / 2) - 1
        if j >= 0 and spans[j][1] >= (a + b) / 2:
            inside += b - a
    return 100.0 * inside / total
