"""Where the MEM kernel's (K3) time goes on one CUDA card: the bench
workload of chip_smoke.py through find_mems with parts of the work taken
away, one JSON line per configuration.

    python -m pangenome_index_tpu_torch.mems_probe

The workload (bench_workload, which chip_smoke.py drives too): the 20 Mbp
synthetic pangenome (8 haplotypes), 16384 reads of 150 bp with 1% errors,
min_len 20, min_occ 1, m=14 seed table, s=19 dictionary, MEM capacity 8,
reads in input order (serve.prepare).
Configurations: the seed tiers (both, either, none: without seeds a read
takes more steps, each without a lookup); the hardest and the easiest N
reads alone (fewer warps on an SM: a kernel bound by the latency of its
longest chain keeps its time, one bound by a rate gets faster); the reads
sorted by seed difficulty (mertable.seed_difficulty, the work sort the JAX
command line runs across chunks); a mixed batch (mixed_reads: lengths 50 to
1000 bp, error rates 0 to 10%) in input order and sorted, in turns, with
what the sort itself costs there (the proxy and the argsort, the gathers
that put the results back in input order); and backward search (K7) on N
reads. Times are the kernels' device
times by CUDA events around each launch (launch_ms), each the mean of
three launches; every line
carries the card's name and power limit. The last lines count the SASS
instructions of the MEM and count kernels, and the POPC among them
(cuobjdump; a line says so where the toolkit lacks it): a chain's step costs
its instructions one after the other.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from . import _build, gather_probe
from .ops.count import count
from .ops.mems import find_mems
from .ops.mertable import seed_difficulty
from .serve import prepare
from .utils import synth
from .utils.alphabet import BYTE_TO_CODE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_LEN, N_HAPS, SNP_RATE, INDEX_SEED = 2_500_000, 8, 0.002, 3
N_READS, READ_LEN, READ_ERRORS, READ_SEED = 16384, 150, 0.01, 1
MIN_LEN, MIN_OCC, MER_M, SDICT_S, MEM_CAP = 20, 1, 14, 19, 8
MIXED_LEN, MIXED_ERRORS = (50, 1000), 0.10  # the mixed batch: bp, substitution rate
PER_READ = ("mer_keys", "mer_valid", "sdict_idx")
TIERS = {"both": None, "dictionary only": ("sdict_vals", "sdict_idx", "sdict_m"),
         "m-mer table only": ("mer_table", "mer_keys", "mer_valid", "mer_m"),
         "none": ()}


def bench_workload(cache: str):
    """The bench workload, built once and cached under `cache`: (index, its
    text lines, the reads as bytes, their codes [N_READS, READ_LEN] and
    lengths [N_READS] as int32, the tag array, the stem of the index's files
    and caches under `cache`)."""
    idx, lines = synth.build_synth_index(BASE_LEN, N_HAPS, snp_rate=SNP_RATE,
                                         seed=INDEX_SEED, cache_dir=cache)
    reads = synth.synth_reads(lines, N_READS, READ_LEN, error_rate=READ_ERRORS,
                              seed=READ_SEED)
    codes = BYTE_TO_CODE[np.frombuffer(b"".join(reads), np.uint8)]
    codes = codes.reshape(N_READS, READ_LEN).astype(np.int32)
    lens = np.full(N_READS, READ_LEN, np.int32)
    tags = synth.synth_tag_array(idx, cache_dir=cache)
    stem = os.path.join(cache, f"bench_{BASE_LEN}_{N_HAPS}_{INDEX_SEED}")
    return idx, lines, reads, codes, lens, tags, stem


def mixed_reads(lines: list[bytes], n_reads: int, seed: int = 4):
    """A batch of unlike reads from a seed: each a substring of a random
    haplotype, its length uniform in MIXED_LEN, with substitutions at a rate
    of its own, uniform in [0, MIXED_ERRORS]. Returns (codes [n_reads,
    MIXED_LEN[1]] int32 right-padded with 0, lengths [n_reads] int32)."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    codes = np.zeros((n_reads, MIXED_LEN[1]), np.int32)
    lens = rng.integers(MIXED_LEN[0], MIXED_LEN[1] + 1, n_reads).astype(np.int32)
    for i, n in enumerate(lens):
        line = lines[int(rng.integers(len(lines)))]
        a = int(rng.integers(0, len(line) - n))
        read = np.frombuffer(line[a : a + n], np.uint8).copy()
        hit = rng.random(n) < rng.uniform(0.0, MIXED_ERRORS)
        read[hit] = alphabet[rng.integers(0, 4, int(hit.sum()))]
        codes[i, :n] = BYTE_TO_CODE[read]
    return codes, lens


#: the kernel of trace_head and trace_tail (torch.cuda._sleep), to leave out
#: of a trace's sums
TAIL_KERNEL = "spin_kernel"


def trace_head() -> None:
    """About a millisecond of spinning on the card and a wait, the first
    work under a profiler, so that the work measured starts after it: a
    trace whose first K3 call came at once recorded 2 of its 3 launches."""
    torch.cuda._sleep(2_000_000)
    torch.cuda.synchronize()


def trace_tail() -> None:
    """Sixteen short spin kernels and a wait, the last work under a
    profiler, so that a trace that drops its last records drops these."""
    for _ in range(16):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


#: spin cycles queued ahead of each launch that launch_ms times (about 50 us
#: on an H100): the host's work of launching is done before the GPU reaches
#: the start event
SPIN_CYCLES = 100_000


def launch_ms(fn, *entries: str, reps: int = 3):
    """Device time of the launches fn() makes through the C entry points
    whose names hold one of `entries`: ({entry: (mean ms a call, launches a
    call)}, the last call's result), over reps calls after one warm-up call.
    Each such launch is timed alone by CUDA events around it, behind a short
    spin. torch.profiler is not used: on the card it loses kernel records,
    some or all of a trace's, more often the longer the process has run."""
    fn()
    torch.cuda.synchronize()
    launch, marks = _build.launch, []

    def timed(name, *args):
        hit = next((e for e in entries if e in name), None)
        if hit is None:
            return launch(name, *args)
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        launch(name, *args)
        b.record()
        marks.append((hit, a, b))

    _build.launch = timed
    try:
        for _ in range(reps):
            out = fn()
    finally:
        _build.launch = launch
    torch.cuda.synchronize()
    spent = {e: [0.0, 0] for e in entries}
    for e, a, b in marks:
        spent[e][0] += a.elapsed_time(b)
        spent[e][1] += 1
    return {e: (ms / reps, n / reps) for e, (ms, n) in spent.items()}, out


def event_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of fn() over reps eager calls, by CUDA events."""
    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def sass_instructions() -> dict[str, tuple[int, int]] | None:
    """(SASS instructions, POPC instructions among them: two to a 64-bit
    popcount) of every find_mems, resolve_seeds and count kernel in the built
    library, by (demangled-enough) kernel name; None where the toolkit has
    no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, popc, name = collections.Counter(), collections.Counter(), None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"\d+(find_mems_kernel|resolve_seeds_kernel|count_kernel)"
                          r"(?:IN3pgt\d+(\w+?Rank))?", m.group(1))
            name = None if k is None else \
                k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
            popc[name] += " POPC " in line
    return {k: (n, popc[k]) for k, n in counts.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("mems_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = gather_probe.card_name(dev)
    cache = os.path.join(REPO, ".bench_cache")
    idx, lines, _, codes, lens, tags, stem = bench_workload(cache)
    sdict_path = f"{stem}.ri.sdict{SDICT_S}.npz"
    bt = prepare(idx, tags, codes, lens, dev, min_occ=MIN_OCC, mer_m=MER_M,
                 sdict_s=SDICT_S, sdict_path=sdict_path)

    def work_order(b):
        """The reads of a batch sorted by seed difficulty, easiest first."""
        kw = b.seed_kw
        return torch.argsort(seed_difficulty(kw["mer_table"], kw["mer_keys"],
                                             kw["mer_valid"], MIN_OCC, b.lengths,
                                             MER_M), stable=True)

    def k3(b, what, sel, tiers="both", order=None):
        pick = (lambda a: a[sel].contiguous()) if order is None else \
            (lambda a: a[order][sel].contiguous())
        keep = TIERS[tiers]
        kw = {k: (pick(v) if k in PER_READ else v) for k, v in b.seed_kw.items()
              if keep is None or k in keep}
        c, n = pick(b.codes), pick(b.lengths)
        got, (_, stats) = launch_ms(
            lambda: find_mems(b.tables, c, n, MIN_LEN, MIN_OCC, capacity=MEM_CAP,
                              with_stats=True, **kw), "pgt_find_mems")
        ms = got["pgt_find_mems"][0]
        steps = stats["steps"]
        print(json.dumps({
            "kernel": "find_mems", "reads": what, "n_reads": int(c.shape[0]),
            "seed_tiers": tiers, "ms": ms, "max_steps": int(steps.max()),
            "mean_steps": float(steps.float().mean()),
            "us_per_step_of_longest": ms * 1e3 / int(steps.max()), "card": card}),
            flush=True)

    whole = slice(None)
    order = work_order(bt)
    for tiers in TIERS:
        k3(bt, "all, input order", whole, tiers)
    for n in (512, 2048, 8192):
        k3(bt, f"hardest {n}", slice(N_READS - n, N_READS), order=order)
    k3(bt, "easiest 8192", slice(0, 8192), order=order)
    k3(bt, "all, sorted", whole, order=order)
    k3(bt, "hardest 2048, no seeds", slice(N_READS - 2048, N_READS), "none", order)
    del bt

    # unlike reads: does the work sort pay where a warp's reads differ?
    mcodes, mlens = mixed_reads(lines, N_READS)
    mixed = prepare(idx, tags, mcodes, mlens, dev, min_occ=MIN_OCC, mer_m=MER_M,
                    sdict_s=SDICT_S, sdict_path=sdict_path)
    tables = mixed.tables
    order = work_order(mixed)
    for what, o in (("input order", None), ("sorted", order), ("sorted", order),
                    ("input order", None)):
        k3(mixed, f"mixed 50-1000 bp, 0-10% errors, {what}", whole, order=o)
    # what the sort itself costs on the card: the proxy and the argsort once
    # a batch, the gathers that put seven result arrays back in input order
    # once a run
    res = find_mems(tables, mixed.codes, mixed.lengths, MIN_LEN, MIN_OCC,
                    capacity=MEM_CAP, **mixed.seed_kw)
    inv = torch.argsort(order)
    for what, fn in (("proxy and argsort", lambda: work_order(mixed)),
                     ("inverse permutation of the results",
                      lambda: [a[inv] for a in (*res[:5], res.start, res.size)])):
        print(json.dumps({"work sort": what, "n_reads": N_READS,
                          "ms": event_ms(fn), "card": card}), flush=True)
    del mixed, res

    # backward search of reads that occur (error-free), so every read takes
    # all its steps
    exact = synth.synth_reads(lines, N_READS, READ_LEN, error_rate=0.0, seed=2)
    qc = BYTE_TO_CODE[np.frombuffer(b"".join(exact), np.uint8)]
    qc = torch.from_numpy(qc.reshape(N_READS, READ_LEN).astype(np.int32)).to(dev)
    ql = torch.from_numpy(lens).to(dev)
    for n in (2048, 8192, N_READS):
        ms = launch_ms(lambda: count(tables, qc[:n], ql[:n]), "pgt_count")[0]["pgt_count"][0]
        print(json.dumps({"kernel": "count", "n_reads": n, "ms": ms,
                          "us_per_step": ms * 1e3 / READ_LEN, "card": card}), flush=True)
    sass = sass_instructions()
    if sass is None:
        print(json.dumps({"sass_instructions": "skipped: no cuobjdump found"}),
              flush=True)
    for name, (n, n_popc) in sorted((sass or {}).items()):
        print(json.dumps({"kernel": name, "sass_instructions": n,
                          "popc_instructions": n_popc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
