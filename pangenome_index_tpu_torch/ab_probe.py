"""Device times of locate (K8) and of the tag merge's sort (merge_rows,
merge_rows_shard) at chip_smoke.py's shapes, through the port of the checkout
at --root (default: the one holding this file); one JSON line on stdout.

    python3 pangenome_index_tpu_torch/ab_probe.py [--root DIR] [--cache DIR]

Two checkouts (a parent unpacked with git archive, and this one) are
compared in one run on one card by running it on each in turns: parent,
change, change, parent. Each run builds its checkout's kernels; the bench
index is cached under --cache (default: .bench_cache of this checkout) and
shared. Card only: it exits 1 where there is no CUDA device.

  * locate_batch at capacity 64 on 98304 intervals of the bench index (half
    at run heads, half mid-run, sizes 1 to 200), through int32 tables and
    through int64 ones (two-level rows of 2^24 positions, as chip_smoke.py's
    same-index comparison), and on as many intervals of the k-copy index
    past 2^31 (chip_smoke.k_copy_index, 108 copies, int64);
  * merge_rows on 40,000,080 rows of 3 components (the graph build's count;
    random labels, 48 endmarker rows), and merge_rows_shard on its second
    half with the first half's counts as base (the mesh path's shard).

Times are CUDA-graph replays of the wrapper (gather_probe.time_ms), the
same timer as chip_smoke.py's kernels line. Beside each time, a digest of
the call's output (its values weighted by their index, summed), which must
be the same for every checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_INTERVALS = 98304
CAPACITY = 64
K_COPIES = 108
MERGE_ROWS = 40_000_080


def intervals(idx, rng, np):
    """(start, size) int64: half at run heads, half mid-run, sizes 1 to 200
    inside the BWT."""
    half = N_INTERVALS // 2
    heads = idx.run_start[rng.integers(0, idx.n_runs, half)]
    long_runs = np.flatnonzero(idx.run_len > 1)
    j = long_runs[rng.integers(0, len(long_runs), half)]
    start = np.concatenate((heads, idx.run_start[j] + rng.integers(1, idx.run_len[j])))
    size = np.minimum(rng.integers(1, 201, N_INTERVALS), idx.n - start)
    return start.astype(np.int64), size.astype(np.int64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose port is timed")
    ap.add_argument("--cache", default=os.path.join(HERE, ".bench_cache"))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pangenome_index_tpu_torch import _build, gather_probe
    from pangenome_index_tpu_torch.mems_probe import bench_workload
    from pangenome_index_tpu_torch.ops import locate, merge
    from pangenome_index_tpu_torch.ops.tables import rindex_to_device

    dev = torch.device("cuda", 0)
    _build.lib()
    out = {"root": root, "card": gather_probe.card_name(dev)}
    idx = bench_workload(args.cache)[0]
    rng = np.random.default_rng(31)

    def digest(x):
        x = x.reshape(-1).long()
        return int((x * torch.arange(1, x.numel() + 1, device=dev)).sum())

    def timed(name, fn, result):
        out[name + "_ms"] = gather_probe.time_ms(fn)
        out[name + "_digest"] = digest(result(fn()))

    def located(name, t, start, size):
        st, sz = (torch.from_numpy(a).to(dev, t.pos_dtype) for a in (start, size))
        timed(name, lambda: locate.locate_batch(t, st, sz, CAPACITY), lambda r: r.positions)

    start, size = intervals(idx, rng, np)
    located("locate_int32", rindex_to_device(idx, dev), start, size)
    located("locate_int64_same_index",
            rindex_to_device(idx, dev, checkpoint=True, super_shift=24, dtype=torch.int64),
            start, size)
    big, _ = chip_smoke.k_copy_index(idx, None, K_COPIES)
    start2, size2 = intervals(big, rng, np)
    located("locate_int64_2g", rindex_to_device(big, dev, dtype=torch.int64), start2, size2)
    del big

    comp = rng.integers(0, 3, MERGE_ROWS).astype(np.int32)
    comp[:48] = -1
    counts = np.bincount(comp[comp >= 0], minlength=3)
    offsets = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    stream = rng.integers(0, 1 << 45, int(offsets[-1])).astype(np.int64)
    c, s, o = (torch.from_numpy(a).to(dev) for a in (comp, stream, offsets))
    timed("merge_rows", lambda: merge.merge_rows(c, s, o), lambda r: r)
    half = -(-MERGE_ROWS // 2)
    first, second = c[:half].contiguous(), c[half:].contiguous()
    base = torch.bincount(first.long()[first >= 0], minlength=3)[:3]
    timed("merge_rows_shard", lambda: merge.merge_rows_shard(second, s, o, lambda counts: base),
          lambda r: r)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
