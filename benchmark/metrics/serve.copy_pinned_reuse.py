"""Percent of the recorded calls (_spans.py) whose copies back drew every
page-locked host block from the caching host allocator: serve.run's counter
serve.copy.host_allocs, the blocks its copies had to allocate, is 0. A
program without that counter reads nothing."""

from benchmark.metrics import _spans

UNIT = "%"
MOVES = "reads_per_s"
SOURCE = "program_counter"


def probe(readings, pool, run_kw):
    _spans.record(readings, pool, run_kw)


def read(r):
    calls = r.get("spans")
    if not calls:
        return None
    allocs = [c["counters"].get("serve.copy.host_allocs") for c in calls]
    if None in allocs:
        return None
    return 100.0 * sum(n == 0 for n in allocs) / len(allocs)
