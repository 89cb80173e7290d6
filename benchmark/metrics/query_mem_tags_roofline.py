"""The tag counts' (K4) share of their bandwidth roofline in the traced
window, by the kernel's device time in the profiler's trace, against the
bytes bound of the calls' MEM slots."""

from benchmark.metrics._bounds import share, tags_bytes

UNIT = "%"
MOVES = "reads_per_s"
SOURCE = "device_trace"


def read(r):
    prof = r.get("profile")
    if not prof:
        return None
    s = r["shape"]
    per_call = tags_bytes(s["reads_per_call"], s["capacity"], s["tag_runs"], s["pos_bytes"])
    return share(r["traced_calls"] * per_call, prof["kernel_s"]["query_mem_tags_kernel"])
