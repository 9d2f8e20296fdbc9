"""The share of the traced calls whose model step replayed CUDA graphs, in
%: 100 × the traced root ``serve`` spans whose attribute ``graph`` is
``replay`` ÷ the traced roots, read as ``serve.prep_ms`` reads its spans.
Nothing where the program sets no ``graph`` attribute."""

from bench_torch import harness

UNIT = "%"
_spans = harness.module("metrics", "serve.prep_ms")


def read(record):
    traced = _spans.traced(record)
    if traced is None:
        return None
    roots = traced[0]
    if not any("graph" in r.attrs for r in roots):
        return None
    return 100.0 * sum(r.attrs.get("graph") == "replay" for r in roots) / len(roots)
