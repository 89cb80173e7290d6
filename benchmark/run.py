"""The benchmark of pangenome_index_tpu_torch: one cell of BENCHMARK.json a run.

    python3 -m benchmark.run --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1> [--control <name>]

run from the root of a checkout on a machine with an NVIDIA card. A cell is
a configuration (benchmark/configs/<config>.json: the pangenome, its rank
mode and seed tiers, the search's settings and the guarantees) under a
traffic mix (benchmark/traffic/<traffic>.json: read length, error rate,
reads a call, distinct batches in the pool). The run:

1. set-up (setup_s): the sequences, the index and tag array (built on the
   card by the program's BWT build), the pool's reads, all from --seed; one
   serve.prepare of the whole pool (the tables and seed tiers once, every
   read's windows), each pool batch its slice; one serve.run of each
   (warm-up; the first run in a checkout also builds the kernels);
2. the window: one client calls serve.run on the pool's batches in turn,
   each call returning host arrays, for --seconds. The end-to-end metrics
   (benchmark/metrics/<metric>.py, as the per-layer ones) read the calls
   completed inside the window. The first call's
   answers on each batch are kept whole, every later call's for a sample of
   its reads drawn from the seed;
3. with --trace 1, the per-layer readings: a fixed number of calls under
   torch.profiler (benchmark/trace.py), with_stats calls, and each per-layer
   metric's reader;
4. the device's peak memory is read, the program's state freed, and the
   plain reference (benchmark/reference.py, no part of the program) works
   out every kept read's MEMs and tag counts from the text alone; any
   difference makes `correct` false.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last `compared`: each
number compared with its limit, which the last lines of standard error
repeat). Without a card, or with fewer cards than the cell asks for, the run
prints no result and exits 2. --control <name> puts the reference,
computed with one of the configuration's guarantees broken (CONTROLS), in
the program's place for the compared reads: such a run has to come out not
correct.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np

#: the process's start, which set-up counts from
STARTED = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent.parent
#: modules that no run may hold once its window has closed (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "pangenome_index_tpu")
#: reads the reference takes at once, by device type
REFERENCE_BLOCK = {"cuda": 262144, "cpu": 4096}
#: the program's kernels whose trace records are held against their launches:
#: a substring of the kernel's name in the trace -> its wrapper in KERNELS
TRACED_KERNELS = {"find_mems_kernel": "find_mems",
                  "resolve_seeds_kernel": "resolve_seeds",
                  "query_mem_tags_kernel": "query_mem_tags"}


# --------------------------------------------------------------- the files

def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(items: list[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(bench: dict, workload: str, root: pathlib.Path = ROOT):
    """(the workload's entry, its configuration, its traffic mix): the
    configuration's file as BENCHMARK.json names it, the mix's
    benchmark/traffic/<traffic>.json."""
    cell = _named(bench["workloads"], workload, "workload")
    entry = _named(bench["configs"], cell["config"], "configuration")
    cfg = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, mix


def metrics_of(bench: dict, kind: str, workload: str) -> list[dict]:
    """The cell's metrics of one kind: those that list it, or list no cells."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def load_reader(name: str, root: pathlib.Path = ROOT):
    """benchmark/metrics/<name>.py as a module (its reader `read`, `UNIT`,
    `MOVES`, and an optional `probe`)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------- controls

#: the controls: the reference in the program's place with one of the
#: configuration's guarantees broken, each a shortcut a later change might
#: take -> the guarantee it breaks
CONTROLS = {
    "skip_rescan": "every MEM of the reference tool's search: the next search "
                   "starts at a MEM's end, step 3's backward rescan left out",
    "int32": "positions at the width the index's n needs: BWT positions in 32 bits",
}


def _int32(ans: dict) -> dict:
    """The answers with their BWT positions wrapped to 32 bits."""
    out = dict(ans)
    out["slots"] = ans["slots"].copy()
    out["slots"][..., 2:] = out["slots"][..., 2:].astype(np.int32)
    return out


# --------------------------------------------------------------- the check

def compare(got: dict, want: dict, capacity: int) -> dict:
    """Reads whose MEM count, kept MEMs (start, end, bwt_start, size) or tag
    counts (distinct tags, overflow) differ from the reference's. Slots past
    a read's count are not compared."""
    keep = np.arange(capacity)[None, :] < np.minimum(want["count"], capacity)[:, None]
    slots = (got["slots"] != want["slots"]).any(axis=2) & keep
    tags = ((got["nu"] != want["nu"]) | (got["ov"] != want["ov"])) & keep
    return {"count_wrong": int((got["count"] != want["count"]).sum()),
            "mems_wrong": int(slots.any(axis=1).sum()),
            "tags_wrong": int(tags.any(axis=1).sum())}


#: every compared number's limit: the answers are exact
LIMITS = {"count_wrong": 0, "mems_wrong": 0, "tags_wrong": 0}


def _answers(res, rows) -> dict:
    """The sampled rows of a ServeResult, in the reference's layout."""
    return {"count": res.count[rows].astype(np.int64),
            "slots": np.stack([res.start[rows], res.end[rows], res.bwt_start[rows],
                               res.size[rows]], axis=2).astype(np.int64),
            "nu": res.tag_nu[rows].astype(np.int64), "ov": res.tag_ov[rows].astype(bool)}


def _cat(parts: list[dict]) -> dict:
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


# ------------------------------------------------------------------ the run

#: a Batch's per-read tensors: the reads and their seed windows
_PER_READ = ("mer_keys", "mer_valid", "sdict_idx")


def pool_batch(whole, lo: int, hi: int):
    """Reads lo .. hi - 1 of a prepared Batch as a Batch of their own: the
    same tables and seed tiers, the slices of its per-read tensors."""
    kw = dict(whole.seed_kw)
    for k in _PER_READ:
        kw[k] = kw[k][lo:hi]
    return dataclasses.replace(whole, codes=whole.codes[lo:hi],
                               lengths=whole.lengths[lo:hi], seed_kw=kw)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", control: str | None = None,
             root: pathlib.Path = ROOT, work_dir=None,
             started: float | None = None) -> tuple[dict, list[str]]:
    """One run of a cell: (the result line's object, the compared numbers'
    lines for standard error). device "cpu" runs the program's plain
    versions (tests only: no card is looked for). The traced window's
    trace file goes to work_dir (benchmark/.cache by default). Set-up
    counts from `started` (perf_counter), by default the call."""
    t_setup = time.perf_counter() if started is None else started
    import torch

    from pangenome_index_tpu_torch import KERNELS, serve

    from . import data, reference
    from . import trace as tracing

    bench = load_benchmark(root)
    cell, cfg, mix = cell_files(bench, workload, root)
    if mix["clients"] != 1:
        raise ValueError(f"traffic {mix['name']}: the harness runs one closed-loop client")
    if control is not None and control not in cfg["controls"]:
        raise ValueError(f"control {control!r}: the configuration has {cfg['controls']}")
    work = pathlib.Path(work_dir) if work_dir else root / "benchmark" / ".cache"
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def log(msg):
        print(f"[{time.perf_counter() - t_setup:.2f} s] {msg}", file=sys.stderr, flush=True)

    # 1. set-up
    lines = data.sequences(cfg, seed)
    log(f"{workload}: {len(lines)} sequences")
    idx, tags = data.index(cfg, lines, dev)
    build_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    if cuda:  # the build stands in for loading an index: its peak is its own
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"index: n {idx.n}, {idx.n_runs} runs, {tags.n_runs} tag runs; "
        f"the build's device peak {build_peak} bytes")
    n_batches, per_batch = mix["pool_batches"], mix["reads_per_call"]
    hosts = [data.reads(lines, per_batch, mix["read_len"], mix["error_rate"],
                        data.rng(seed, 1, b)) for b in range(n_batches)]
    # one prepare over the whole pool: the tables and seed tiers once, every
    # read's windows; each pool batch is its slice of the reads
    whole = serve.prepare(idx, tags, np.concatenate([h[0] for h in hosts]),
                          np.concatenate([h[1] for h in hosts]), dev,
                          rank_mode=cfg["rank_mode"], min_occ=cfg["min_occ"],
                          mer_m=cfg["mer_m"], sdict_s=cfg["sdict_s"])
    pool = [pool_batch(whole, b * per_batch, (b + 1) * per_batch) for b in range(n_batches)]
    log("the pool prepared: " + ", ".join(f"{k} {v:.3f} s" for k, v in whole.seconds.items()))
    run_kw = dict(min_len=cfg["min_len"], min_occ=cfg["min_occ"],
                  capacity=cfg["capacity"], tag_capacity=cfg["tag_capacity"])
    res = [serve.run(b, **run_kw) for b in pool][-1]
    sync()
    shape = {"reads_per_call": per_batch, "read_len": mix["read_len"],
             "capacity": cfg["capacity"], "tag_capacity": cfg["tag_capacity"],
             "runs": idx.n_runs, "n": idx.n, "tag_runs": tags.n_runs,
             "pos_bytes": 8 if idx.n >= 2**31 else 4}
    readings = {"shape": shape, "pool_reads": n_batches * per_batch,
                "windows_s": whole.seconds["windows"],
                "dict_hit_rate": whole.dict_hit_rate}
    readings["setup_s"] = time.perf_counter() - t_setup
    log("set-up done")

    # 2. the window. The first call on each batch is checked whole, every
    # later call on a sample of its reads drawn from the seed
    per_call = mix["checked_reads_per_call"]
    calls, checked = [], []
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        b = len(calls) % len(pool)
        res = serve.run(pool[b], **run_kw)
        t1 = time.perf_counter()
        calls.append({"batch": b, "reads": len(res.count), "start": t0, "end": t1,
                      "seconds": res.seconds})
        if len(calls) <= len(pool):
            checked.append((b, None, res))
        else:
            rows = data.rng(seed, 2, len(calls)).choice(len(res.count), per_call, replace=False)
            checked.append((b, rows, _answers(res, rows)))
    done = [c for c in calls if c["end"] <= deadline]
    lat = np.array([c["end"] - c["start"] for c in calls]) * 1e3
    fetch = np.array([c["seconds"]["fetch"] for c in calls]) * 1e3
    by_batch = [fetch[b::len(pool)] for b in range(len(pool))]
    log(f"window: {len(calls)} calls, {len(done)} inside it; ms a call (quartiles) "
        f"{np.percentile(lat, [25, 50, 75]).round(3).tolist()}, of it the fetch "
        f"{np.percentile(fetch, [25, 50, 75]).round(3).tolist()}; the fetch's median by "
        f"pool batch {[round(float(np.median(f)), 3) for f in by_batch if f.size]}, by fifth of "
        f"the window {[round(float(np.median(f)), 3) for f in np.array_split(fetch, 5) if f.size]}")
    readings.update(calls=calls, done=done, window_s=seconds)

    # 3. the per-layer readings
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": cell["chips"]}
    breakdown = None
    if trace:
        layer_metrics = metrics_of(bench, "per_layer", workload)
        counters = {k: KERNELS[w] for k, w in TRACED_KERNELS.items()}
        prof = tracing.traced_calls(
            lambda i: serve.run(pool[i % len(pool)], **run_kw),
            mix["traced_calls"], counters, work / "trace.json")
        readings["profile"] = prof
        readings["traced_calls"] = mix["traced_calls"]
        dev_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        breakdown = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    else:
        layer_metrics = metrics_of(bench, "end_to_end", workload)
    readers = {m["name"]: load_reader(m["name"], root) for m in layer_metrics}
    for r in readers.values():
        if hasattr(r, "probe"):
            r.probe(readings, pool, run_kw)
    metrics = {}
    for name, r in readers.items():
        v = r.read(readings)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": r.UNIT}
    dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    log("readings taken")

    # 4. the check: the program's state freed, then the reference
    del pool, whole, res
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got, want = [], []
    fmd = reference.fmd_index(lines, dev)
    ref_tags = reference.tag_runs(fmd, cfg["node_len"], cfg["copies"])

    def answers(b, **kw):
        codes, lens = hosts[b]
        out = reference.answers(
            fmd, torch.from_numpy(codes), torch.from_numpy(lens), min_len=cfg["min_len"],
            min_occ=cfg["min_occ"], capacity=cfg["capacity"],
            tag_capacity=cfg["tag_capacity"], tags=ref_tags, copies=cfg["copies"],
            block=REFERENCE_BLOCK[dev.type], **kw)
        return dict(zip(("count", "slots", "nu", "ov"), (a.cpu().numpy() for a in out)))

    batches = sorted({b for b, _, _ in checked})
    ref = {b: answers(b) for b in batches}
    multi = sum(int(((r["nu"] > 1).any(axis=1)).sum()) for r in ref.values())
    over = sum(int(r["ov"].any(axis=1).sum()) for r in ref.values())
    alt = {b: answers(b, rescan=False) for b in batches} if control == "skip_rescan" else None
    for b, rows, ans in checked:
        if rows is None:
            rows = np.arange(len(ans.count))
            ans = _answers(ans, rows)
        want.append({k: v[rows] for k, v in ref[b].items()})
        got.append({k: v[rows] for k, v in alt[b].items()} if alt else ans)
    got, want = _cat(got), _cat(want)
    if control == "int32":
        got = _int32(want)
    found = compare(got, want, cfg["capacity"])
    log(f"reference: {len(ref)} batches; {len(want['count'])} answers compared, "
        f"{int(want['count'].sum())} MEMs, {int(want['nu'].sum())} distinct tags; of the "
        f"first calls' reads {multi} with a MEM of several tags, {over} with one past "
        f"the tag capacity")
    compared = {k: {"value": v, "limit": LIMITS[k]} for k, v in found.items()}
    correct = all(v <= LIMITS[k] for k, v in found.items())
    attempted = sum(c["reads"] for c in calls)
    line = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
            "device": dev_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checked_reads"] = int(len(want["count"]))
    line["compared"] = compared
    notes = [f"{k} {v['value']} limit {v['limit']}" for k, v in compared.items()]
    return line, notes


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=sorted(CONTROLS), default=None)
    args = p.parse_args(argv)
    import torch

    cell = _named(load_benchmark()["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s), this machine "
              f"has {have}", file=sys.stderr)
        return 2
    line, notes = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           control=args.control, started=STARTED)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for note in notes:
        print(note, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
