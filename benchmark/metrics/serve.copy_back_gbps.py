"""GB/s of the copies back to the host: serve.run's counter
serve.copy_back_bytes over the summed host time of its serve.copy.<field>
spans (one a result tensor), over the recorded calls (_spans.py)."""

from benchmark.metrics import _spans

UNIT = "GB/s"
MOVES = "reads_per_s"
SOURCE = "program_span"


def probe(readings, pool, run_kw):
    _spans.record(readings, pool, run_kw)


def read(r):
    calls = r.get("spans")
    if not calls:
        return None
    nbytes = sum(c["counters"].get("serve.copy_back_bytes", 0) for c in calls)
    ns = sum(_spans.length(s["host"]) for c in calls for s in c["spans"]
             if s["name"].startswith("serve.copy."))
    if ns <= 0 or nbytes <= 0:
        return None
    return nbytes / ns
