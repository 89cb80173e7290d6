"""Milliseconds a call spends bringing its results back to the host
(serve.run's "fetch" span), over the calls of the window."""

UNIT = "ms"
MOVES = "reads_per_s"
SOURCE = "program_span"


def read(r):
    calls = r["calls"]
    if not calls:
        return None
    return 1e3 * sum(c["seconds"]["fetch"] for c in calls) / len(calls)
