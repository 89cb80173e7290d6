"""Percent of the reads K3 keeps in flight at once that a launch fills: the
counter mems.k3.lanes (the launch's reads) over mems.k3.resident_lanes (on
the card, its instantiation's resident threads by the CUDA occupancy API;
in the plain version, whose lockstep advances every read together, the
launch's reads), the median over the recorded calls (_spans.py). Above 100
a launch runs in more than one wave. Reads nothing where a call lacks
either counter, as a program without them."""

from statistics import median

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
    fills = []
    for c in calls:
        lanes = c["counters"].get("mems.k3.lanes")
        resident = c["counters"].get("mems.k3.resident_lanes")
        if not lanes or not resident:
            return None
        fills.append(100.0 * lanes / resident)
    return median(fills)
