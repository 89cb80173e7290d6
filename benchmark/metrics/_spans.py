"""The program's own spans (pangenome_index_tpu_torch/spans.py) for the
per-layer metrics that read them. The first of their probes to run calls
`record`: one warm call, then `readings["traced_calls"]` calls on the pool's
batches in turn inside one `spans.recording` block (no profiler running),
each call's spans read (their events resolved) after it. readings["spans"]
keeps one entry a call: "spans", each a dict of name, call, parent (an index
into the call's spans), host and device intervals (ns on the host's clock,
device None where the span has none), and "counters", the call's own. A
program without the recorder leaves readings["spans"] None, and those
metrics read nothing."""

import importlib


def record(readings, pool, run_kw):
    if "spans" in readings:
        return
    try:
        spans = importlib.import_module("pangenome_index_tpu_torch.spans")
    except ModuleNotFoundError as e:
        if e.name != "pangenome_index_tpu_torch.spans":
            raise
        readings["spans"] = None
        return
    from pangenome_index_tpu_torch import serve

    serve.run(pool[0], **run_kw)
    calls = []
    with spans.recording(pool[0].codes.device) as rec:
        for i in range(readings.get("traced_calls") or len(pool)):
            first, before = len(rec.spans), dict(rec.counters)
            serve.run(pool[i % len(pool)], **run_kw)
            calls.append({
                "spans": [{"name": s.name, "call": s.call,
                           "parent": None if s.parent is None else s.parent - first,
                           "host": s.host, "device": s.device} for s in rec.spans[first:]],
                "counters": {k: v - before.get(k, 0) for k, v in rec.counters.items()}})
    readings["spans"] = calls


def named(call, name):
    """The spans of a call named `name`."""
    return [s for s in call["spans"] if s["name"] == name]


def length(interval):
    return interval[1] - interval[0]
