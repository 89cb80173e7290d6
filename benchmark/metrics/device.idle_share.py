"""The share of the traced window in which no operation ran on the card
(kernels, copies, sets), from the profiler's trace, whose kernel records are
held against the program's launch counts."""

UNIT = "%"
MOVES = "reads_per_s"
SOURCE = "device_trace"


def read(r):
    prof = r.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
