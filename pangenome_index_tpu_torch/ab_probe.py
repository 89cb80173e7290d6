"""Device times of the kernels that rank through dense records, through
bucketed runs and through a model shard's runs (and of K3 and K7 through
checkpoint rows beside them), at chip_smoke.py's shapes, through the port
of the checkout at --root (default: the one holding this file); one JSON
line on stdout.

    python3 pangenome_index_tpu_torch/ab_probe.py [--root DIR] [--cache DIR]

Two checkouts (a parent unpacked with git archive, and this one) are
compared in one run on one card by running it on each in turns: parent,
change, change, parent. Each run builds its checkout's kernels; the bench
index is cached under --cache (default: .bench_cache of this checkout) and
shared. Card only: it exits 1 where there is no CUDA device. It uses only
entry points both checkouts have (serve.prepare, mems.find_mems,
count.count, sparsedict.build_sparse_dict_device,
mertable.build_mer_table_device, sharding.pad_rindex_tables and
virtual_shards, a shard's rank6, mems.mem_step_fused and
find_mems_lockstep).

  * K1's row gather (dense_rank.gather_rows) of every record of the bench
    index in order, as the dense table check takes them, and of 32768
    random records, and of the m=14 seed table's 3-word rows at every
    window of the bench reads (mertable.seed_difficulty's gather): device
    ms by CUDA-graph replay (gather_probe.time_ms, as chip_smoke.py's
    kernels line);
  * through dense records and through checkpoint rows (serve.prepare's
    rank_mode "dense" and "checkpoint"): K3 on all 16384 bench reads with
    the serving path's seed tiers, K7 (count.count) on chip_smoke.py's
    query-tags reads (16384 exact reads, then the first 1024 bench reads),
    and the dictionary's and the seed table's level kernels over whole
    s=19 and m=14 builds, each by CUDA events around each launch, the
    mean of three calls;
  * K3 (find_mems) through bucketed runs on all 16384 bench reads with the
    serving path's seed tiers (m=14 seed table, s=19 dictionary), int32 on
    the bench index and int64 on the k-copy index past 2^31
    (chip_smoke.k_copy_index, 108 copies; m=13): device ms by CUDA events
    around each launch (mems_probe.launch_ms), the mean of three calls;
  * over the bench index's runs padded to 4 shards, as 2 virtual shards:
    3b (a shard's rank6 partials) at the positions of the engine's first
    iteration, the fused step through runs at iteration 100 (CUDA-graph
    replay of the wrapper, gather_probe.time_ms, as chip_smoke.py's kernels
    line), and the whole engine (find_mems_lockstep) on all reads, its wall
    the least of three calls after a warm one;
  * the level kernels through bucketed runs, int32 (bench index) and int64
    (k-copy index): the device ms of a whole s=19 dictionary build
    (sparsedict.build_sparse_dict_device, sdict_level) and of a whole seed
    table build (mertable.build_mer_table_device, mer_level; m=14 and 13)
    by CUDA events around each launch, the mean of three builds, with
    their launches a build;
  * the registers ptxas gave each kernel instantiated on DenseRank or
    BucketRank, and the row gather's kernels (the checkout's build log).

Beside each time, a digest of the call's output (its values weighted by
their index, summed), which must be the same for every checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_COPIES = 108
MER_M_2G = 13
MID_ITERS = 100


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
    from pangenome_index_tpu_torch.cli import pack_reads
    from pangenome_index_tpu_torch.mems_probe import (MEM_CAP, MER_M, MIN_LEN, MIN_OCC,
                                                      N_READS, READ_LEN, SDICT_S,
                                                      bench_workload, launch_ms)
    from pangenome_index_tpu_torch.ops import count, dense_rank, mems, mertable, sparsedict
    from pangenome_index_tpu_torch.ops.tables import rindex_to_device
    from pangenome_index_tpu_torch.utils.synth import synth_reads
    from pangenome_index_tpu_torch.parallel import sharding
    from pangenome_index_tpu_torch.serve import prepare

    dev = torch.device("cuda", 0)
    _build.lib()
    providers = ("DenseRank", "BucketRank", "gather_rows")
    out = {"root": root, "card": gather_probe.card_name(dev),
           "registers": {p: {} for p in providers}}
    entry = ""
    for line in _build.build_log().splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:  # the mangled kernel name, its provider included
            entry = found.group(1)
        elif used := re.search(r"Used (\d+) registers", line):
            for p in providers:
                if p in entry:
                    out["registers"][p][entry] = int(used.group(1))
    idx, lines, reads, codes, lens, tags, _ = bench_workload(args.cache)

    def digest(x):
        x = x.reshape(-1).long()
        return int((x * torch.arange(1, x.numel() + 1, device=dev)).sum())

    def k3(name, bt):
        def call():
            return mems.find_mems(bt.tables, bt.codes, bt.lengths, MIN_LEN, MIN_OCC,
                                  capacity=MEM_CAP, **bt.seed_kw)

        spent, res = launch_ms(call, "pgt_find_mems")
        out[name + "_ms"] = spent["pgt_find_mems"][0]
        out[name + "_digest"] = sum(digest(f) for f in res)

    def levels(name, n, bt, m):
        """The level kernels' device ms and launches of a whole dictionary
        build and a whole m-mer table build through bt's tables."""
        for kernel, build in (
                ("sdict_level", lambda: sparsedict.build_sparse_dict_device(n, bt.tables,
                                                                           SDICT_S)),
                ("mer_level", lambda: mertable.build_mer_table_device(bt.tables, m))):
            spent, res = launch_ms(build, kernel)
            out[f"{kernel}_{name}_ms"], out[f"{kernel}_{name}_launches"] = spent[kernel]
            res = res if isinstance(res, tuple) else (res,)
            out[f"{kernel}_{name}_digest"] = sum(digest(f) for f in res)

    # K1's row gather: every record in order, and random records
    t_dn = rindex_to_device(idx, dev, dense=True)
    runs = torch.arange(idx.n_runs, dtype=torch.int32, device=dev)
    picks = torch.from_numpy(np.random.default_rng(7).integers(
        0, idx.n_runs, 32768).astype(np.int32)).to(dev)
    for name, rows in (("runs", runs), ("random", picks)):
        out[f"gather_rows_{name}_ms"] = gather_probe.time_ms(
            lambda: dense_rank.gather_rows(t_dn.rec, rows))
        out[f"gather_rows_{name}_digest"] = digest(dense_rank.gather_rows(t_dn.rec, rows))
    del t_dn, runs, picks

    # K3, K7 and both levels through dense records and checkpoint rows
    qcodes, qlens = (torch.from_numpy(a).to(dev) for a in pack_reads(
        synth_reads(lines, N_READS, READ_LEN, error_rate=0.0, seed=2) + reads[:1024]))
    for mode in ("dense", "checkpoint"):
        bt = prepare(idx, tags, codes, lens, dev, rank_mode=mode, min_occ=MIN_OCC,
                     mer_m=MER_M, sdict_s=SDICT_S)
        k3(f"find_mems_{mode}", bt)
        spent, res = launch_ms(lambda: count.count(bt.tables, qcodes, qlens), "pgt_count")
        out[f"count_{mode}_ms"] = spent["pgt_count"][0]
        out[f"count_{mode}_digest"] = sum(digest(f) for f in res)
        levels(mode, idx.n, bt, MER_M)
        if mode == "dense":  # the seed table's rows, 3 words wide
            table, keys = bt.seed_kw["mer_table"], bt.seed_kw["mer_keys"].reshape(-1)
            out["gather_rows_seed_shape"] = [keys.numel(), table.shape[1]]
            out["gather_rows_seed_ms"] = gather_probe.time_ms(
                lambda: dense_rank.gather_rows(table, keys))
            out["gather_rows_seed_digest"] = digest(dense_rank.gather_rows(table, keys))
            del table, keys
        del bt, res
    del qcodes, qlens

    bt = prepare(idx, tags, codes, lens, dev, rank_mode="bucketed", min_occ=MIN_OCC,
                 mer_m=MER_M, sdict_s=SDICT_S)
    k3("find_mems_bucketed", bt)
    levels("bucketed", idx.n, bt, MER_M)

    # 3b, the fused step and the engine over the runs of 2 virtual shards
    t = sharding.pad_rindex_tables(idx, 4, device=dev)
    prov = sharding.virtual_shards(t, 2, dev)
    n_reads, read_len = bt.codes.shape
    padded, _ = mems._prepare(bt.codes, align=8)
    seeds = mems.resolve_seeds(n_reads, read_len + 1, MIN_OCC, **bt.seed_kw)
    step_args = (prov.C, prov.n, padded, bt.lengths, seeds, read_len, MIN_LEN, MIN_OCC,
                 prov.super_base, prov.super_shift)
    state = mems.step_state(n_reads, MEM_CAP, t.pos_dtype, dev)
    ranks = torch.zeros((2 * n_reads, 6), dtype=t.pos_dtype, device=dev)
    mems.mem_step_fused(state, ranks, prov.shards, *step_args, apply=False)
    pos = mems.query_positions(state)[1].to(t.pos_dtype)
    sh = prov.shards[0]
    out["shard_run_rank6_ms"] = gather_probe.time_ms(lambda: sh.rank6(pos))
    out["shard_run_rank6_digest"] = digest(sh.rank6(pos))
    for _ in range(MID_ITERS - 1):
        mems.mem_step_fused(state, ranks, prov.shards, *step_args)
    mid = (mems.StepState(*(f.clone() for f in state)), ranks.clone())
    timed = (mems.StepState(*(f.clone() for f in state)), ranks.clone())
    out["mem_step_fused_runs_ms"] = gather_probe.time_ms(
        lambda: mems.mem_step_fused(*timed, prov.shards, *step_args))
    mems.mem_step_fused(*mid, prov.shards, *step_args)
    out["mem_step_fused_runs_digest"] = digest(mid[1]) + sum(digest(f) for f in mid[0])

    def engine():
        return mems.find_mems_lockstep(prov.shards, prov.C, prov.n, bt.codes, bt.lengths,
                                       MIN_LEN, MIN_OCC, capacity=MEM_CAP,
                                       super_base=prov.super_base,
                                       super_shift=prov.super_shift, **bt.seed_kw)

    res = engine()
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    out["engine_runs_ms"] = best * 1e3
    out["engine_runs_digest"] = sum(digest(f) for f in res)
    del bt, t, prov, state, ranks, mid, timed, seeds, padded

    # K3 through int64 bucketed runs past 2^31
    big, big_tags = chip_smoke.k_copy_index(idx, tags, K_COPIES)
    bt2 = prepare(big, big_tags, codes, lens, dev, rank_mode="bucketed", min_occ=MIN_OCC,
                  mer_m=MER_M_2G, sdict_s=SDICT_S)
    k3("find_mems_bucketed64", bt2)
    levels("bucketed64", big.n, bt2, MER_M_2G)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
