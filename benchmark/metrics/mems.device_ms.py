"""Milliseconds of device time a call in the MEM engine: the device interval
of find_mems' mems.find span (resolve_seeds, K3 and their fills), timed by
the span's CUDA events, not by the profiler's kernel records. Over the
recorded calls (_spans.py); on the CPU the span's host interval."""

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
    found = [s["device"] for c in calls for s in _spans.named(c, "mems.find")]
    if len(found) != len(calls) or None in found:
        return None
    return 1e-6 * sum(_spans.length(d) for d in found) / len(found)
