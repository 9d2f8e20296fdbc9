"""The host's milliseconds a traced call in the serve's preparation on the
device (span ``serve.prep``: the resize or warp and the normalisation),
self time: the span less what spans inside it cover.

Here too for the other span readers: the program's span buffer
(``udal_tpu_torch.utils.profiling.spans()``) holds the spans of the
calls ``profile.trace`` traced, the first ``calls`` root ``serve`` spans
those traced with the device alone (the host nearest its unprofiled
speed). Nothing where the program records no spans."""

UNIT = "ms"


def traced(record):
    """The first ``record["calls"]`` root ``serve`` spans and the finished
    spans under them, or None."""
    if record["kind"] != "serve":
        return None
    from udal_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    done = [s for s in spans() if s.end_ns is not None]
    roots = [s for s in done if s.parent is None and s.name == "serve"][:record["calls"]]
    if not roots or len(roots) < record["calls"]:
        return None
    ids = {r.id for r in roots}
    return roots, [s for s in done if s.parent is not None and s.root in ids]


def self_ms(record, name):
    """Σ self time of the spans called ``name`` ÷ the calls, in ms."""
    t = traced(record)
    if t is None:
        return None
    roots, inner = t
    spans = [s for s in inner if s.name == name]
    if not spans:
        return None
    ids = {s.id for s in spans}
    covered = sum(s.end_ns - s.start_ns for s in inner if s.parent in ids)
    return (sum(s.end_ns - s.start_ns for s in spans) - covered) / 1e6 / len(roots)


def read(record):
    return self_ms(record, "serve.prep")
