"""Microseconds of K3 a step of its longest chain: the device interval of
find_mems' mems.k3 span (K3's fills and launch, timed by the span's CUDA
events) over the counter mems.k3.max_steps (the most extension steps one
read took), the median over the recorded calls (_spans.py). Near 0.6 us K3
is bound by one lane's chain of dependent loads; far above it, by
throughput. Reads nothing where a call lacks the counter or the interval."""

from statistics import median

from benchmark.metrics import _spans

UNIT = "us"
MOVES = "reads_per_s"
SOURCE = "program_span"


def probe(readings, pool, run_kw):
    _spans.record(readings, pool, run_kw)


def read(r):
    calls = r.get("spans")
    if not calls:
        return None
    per_step = []
    for c in calls:
        steps = c["counters"].get("mems.k3.max_steps")
        found = [s["device"] for s in _spans.named(c, "mems.k3")]
        if not steps or len(found) != 1 or found[0] is None:
            return None
        per_step.append(1e-3 * _spans.length(found[0]) / steps)
    return median(per_step)
