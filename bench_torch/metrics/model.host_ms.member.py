"""The host's milliseconds a traced call for one ensemble member: Σ self
time of the spans that carry attribute ``member`` (each member's
``model.backbone``, ``model.bifpn`` and ``model.heads``; replayed, the
launch of its three graphs) ÷ the calls ÷ N, the members a frame (the
roots' ``samples``), spans read as ``serve.prep_ms`` reads them. Nothing
where no span carries ``member`` (a single network)."""

from bench_torch import harness

UNIT = "ms"
_spans = harness.module("metrics", "serve.prep_ms")


def members(record):
    """(the traced roots, the spans under them that carry ``member``, N
    from the roots' ``samples``), or None where no span carries it."""
    t = _spans.traced(record)
    if t is None:
        return None
    roots, inner = t
    marked = [s for s in inner if "member" in s.attrs]
    samples = {r.attrs.get("samples") for r in roots}
    if not marked or len(samples) != 1 or None in samples:
        return None
    return roots, inner, marked, samples.pop()


def read(record):
    m = members(record)
    if m is None:
        return None
    roots, inner, marked, n = m
    ids = {s.id for s in marked}
    covered = sum(s.end_ns - s.start_ns for s in inner if s.parent in ids)
    return (sum(s.end_ns - s.start_ns for s in marked) - covered) / 1e6 / len(roots) / n
