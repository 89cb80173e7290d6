"""Extension steps a read of the MEM engine (K3's with_stats count, its
sum the JAX engine's "steps"), over the pool's batches, each served once
more with the count on: the work the seed tiers leave to K3's chain."""

UNIT = "steps/read"
MOVES = "reads_per_s"
SOURCE = "program_counter"


def probe(readings, pool, run_kw):
    from pangenome_index_tpu_torch.ops.mems import find_mems

    steps = 0
    for b in pool:
        _, stats = find_mems(b.tables, b.codes, b.lengths, run_kw["min_len"],
                             run_kw["min_occ"], capacity=run_kw["capacity"],
                             with_stats=True, **b.seed_kw)
        steps += int(stats["steps"].sum())
    readings["mems_steps"] = steps


def read(r):
    if "mems_steps" not in r:
        return None
    return r["mems_steps"] / r["pool_reads"]
