"""Milliseconds of the host's own work a call: serve.run's host interval
less its serve.wait (the host blocked on the device) and serve.fetch (the
copies back) children; what is left is the checks, allocations, launches
and the result's assembly. Over the recorded calls (_spans.py)."""

from benchmark.metrics import _spans

UNIT = "ms"
MOVES = "reads_per_s"
SOURCE = "program_span"


def probe(readings, pool, run_kw):
    _spans.record(readings, pool, run_kw)


def read(r):
    calls = r.get("spans")
    if not calls:
        return None
    own = []
    for c in calls:
        (root,) = _spans.named(c, "serve.run")
        waits = _spans.named(c, "serve.wait") + _spans.named(c, "serve.fetch")
        own.append(_spans.length(root["host"]) - sum(_spans.length(s["host"]) for s in waits))
    return 1e-6 * sum(own) / len(own)
