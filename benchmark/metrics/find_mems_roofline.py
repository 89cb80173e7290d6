"""The MEM engine's share of its bandwidth roofline: find_mems' kernels
(resolve_seeds and K3) in the traced window, by their device time in the
profiler's trace, against the bytes bound of the calls' batches."""

from benchmark.metrics._bounds import mems_bytes, share

UNIT = "%"
MOVES = "reads_per_s"
SOURCE = "device_trace"


def read(r):
    prof = r.get("profile")
    if not prof:
        return None
    s = r["shape"]
    seconds = prof["kernel_s"]["find_mems_kernel"] + prof["kernel_s"]["resolve_seeds_kernel"]
    per_call = mems_bytes(s["reads_per_call"], s["read_len"], s["capacity"], s["runs"],
                          s["pos_bytes"])
    return share(r["traced_calls"] * per_call, seconds)
