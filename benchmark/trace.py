"""The traced window: a fixed number of served calls under torch.profiler,
read from the profiler's chrome trace.

The profiler has been seen to lose kernel records on the card (some or all
of a trace's). So every trace is held against the launches the program
counted for the same calls (each kernel wrapper's `launches`): a trace that
holds fewer records of a counted kernel than were launched is taken again,
and after `ATTEMPTS` such traces the run fails.
"""

from __future__ import annotations

import json
import pathlib

import torch

ATTEMPTS = 5
#: device-side event categories of the chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host-side categories that say what the host was doing during a gap
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "benchmark.traced_window"
TOP = 10


class LostRecords(RuntimeError):
    pass


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    argument list, at most 120 characters."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0][:120]


def _merge(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list[dict], counted: dict[str, int]) -> dict:
    """busy_s, window_s, the device time of each operation by name, the idle
    gaps by what the host was doing, and the device seconds of the counted
    kernels (name -> seconds). Raises LostRecords where a counted kernel has
    fewer records than launches."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise LostRecords(f"the trace holds {len(win)} window annotations")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
           and w0 <= e["ts"] and e["ts"] + e["dur"] <= w1]
    seen = {k: 0 for k in counted}
    kernel_s = {k: 0.0 for k in counted}
    for e in dev:
        for k in counted:
            if e["cat"] == "kernel" and k in e["name"]:
                seen[k] += 1
                kernel_s[k] += e["dur"] * 1e-6
    lost = {k: (seen[k], counted[k]) for k in counted if seen[k] != counted[k]}
    if lost:
        raise LostRecords(f"kernel records / launches: {lost}")
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    ops: dict[str, float] = {}
    for e in dev:
        ops[_short(e["name"])] = ops.get(_short(e["name"]), 0.0) + e["dur"] * 1e-6
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
            and e.get("name") != WINDOW]
    gaps: dict[str, float] = {}
    edges = [w0] + [x for span in busy for x in span] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        cover = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = min(cover, key=lambda e: e["dur"])["name"] if cover else "host, no torch call"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in top_gaps],
            "kernel_s": kernel_s}


def traced_calls(call, n_calls: int, kernels: dict, path: pathlib.Path) -> dict:
    """Run call(i) for i < n_calls under the profiler and summarize the
    trace. kernels: a substring of a kernel's name in the trace -> the
    wrapper that counts its launches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    path.parent.mkdir(parents=True, exist_ok=True)
    last = None
    for _ in range(ATTEMPTS):
        before = {k: w.launches for k, w in kernels.items()}
        with profile(activities=acts) as prof:
            if cuda:
                # about a millisecond on the card before the window: a trace
                # whose first kernel came at once has lost records of it
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
            with record_function(WINDOW):
                for i in range(n_calls):
                    call(i)
                if cuda:
                    torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        counted = {k: w.launches - before[k] for k, w in kernels.items()}
        try:
            return summarize(events, counted)
        except LostRecords as e:
            last = e
    raise LostRecords(f"{ATTEMPTS} traces lost records; the last: {last}")
