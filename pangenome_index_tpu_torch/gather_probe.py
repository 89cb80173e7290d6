"""Gather-rate probe on one CUDA card: random 64-byte row gathers from a
20 MB table, independent (K5 row_gather) and as dependent chains (K5
gather_chain).

    python -m pangenome_index_tpu_torch.gather_probe

The sweep of examples/gather_pipeline_probe.py:main on the card: a
[312500, 16] int32 table (a 20 Mbp checkpoint table's size) of random
values, B in {4096, 16384, 65536, 262144} random rows per launch, grouped
copies of G in {8, 64} consecutive rows at B = 65536 with group-aligned
starts, and a sweep of the row loads each thread keeps in flight (`depth`)
in place of the TPU's DMA copies in flight (K). The table and the indices
come from numpy.random.default_rng(0), as in the JAX script. Prints one
JSON line per configuration, with rows/s and microseconds, and the card's
name and power limit; any failure ends the run.

Times are the kernel's device time: REPS launches captured in a CUDA
graph and replayed back to back, so the wrapper's host cost per call (some
20 us, more than a gather of 262144 rows takes) does not hide the gather.
Graph replays launch the kernels without counting them: the launch counts
count the wrapper calls.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from .ops.gather_probe import DEPTHS, ITERS, WIDTH, gather_chain, row_gather

#: rows of the probe's table (the 20 Mbp checkpoint table: 20 MB)
ROWS = 312_500
BATCHES = (4096, 16384, 65536, 262144)
GROUPS = (8, 64)
GROUP_BATCH = 65536
#: launches per timed graph replay
REPS = 20


def card_name(device) -> str:
    """`name, power limit` of the card as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(device.index or 0)],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device milliseconds of fn()'s launch over reps launches
    captured in a CUDA graph and replayed back to back; a large fn (a
    whole seed-table build) is captured once, reps=1."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def make_table(rng: np.random.Generator, device) -> torch.Tensor:
    table = rng.integers(0, 1 << 20, (ROWS, WIDTH)).astype(np.int32)
    return torch.from_numpy(table).to(device)


def grouped_indices(rng: np.random.Generator, group: int, batch: int) -> np.ndarray:
    """Group-aligned random starts, each repeated `group` times
    (gather_pipeline_probe.py:172-173)."""
    return ((rng.integers(0, (ROWS - group) // group, batch // group) * group)
            .repeat(group).astype(np.int32))


def sweep(device):
    """Yield one record per configuration (dicts with kind, B, rows_per_s and
    the time), launching the K5 kernels on `device`."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    T = make_table(rng, device)

    def put(a):
        return torch.from_numpy(a).to(device)

    def rows(B, G, idx):
        for depth in DEPTHS:
            ms = time_ms(lambda: row_gather(T, idx, G, depth))
            yield {"kind": "row_gather", "B": B, "G": G, "depth": depth,
                   "rows_per_s": B / ms * 1e3, "us": ms * 1e3}

    for B in BATCHES:
        yield from rows(B, 1, put(rng.integers(0, ROWS, B).astype(np.int32)))
    for B in BATCHES:
        idx = put(rng.integers(0, ROWS, B).astype(np.int32))
        ms = time_ms(lambda: gather_chain(T, idx, ITERS))
        yield {"kind": "gather_chain", "B": B, "iters": ITERS,
               "rows_per_s": B * ITERS / ms * 1e3, "us_per_iter": ms * 1e3 / ITERS}
    for G in GROUPS:
        yield from rows(GROUP_BATCH, G, put(grouped_indices(rng, G, GROUP_BATCH)))


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_name(dev)
    for rec in sweep(dev):
        print(json.dumps({**rec, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
