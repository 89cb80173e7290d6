"""What the ranks of the port's spawned process groups run (driven by
tests/test_torch_distributed.py and tests/test_torch_mesh_cli.py through
parallel/multihost.py:spawn_group). It imports the port only, so a spawned
rank starts without the JAX package; its results go to npz files that the
test, rank 0 in the pytest process, holds against the JAX package."""

import os

import numpy as np
import torch

from pangenome_index_tpu_torch import cli
from pangenome_index_tpu_torch.ops.mertable import build_mer_table, read_mer_keys_fast
from pangenome_index_tpu_torch.ops.sparsedict import build_sparse_dict, read_windows_fast
from pangenome_index_tpu_torch.ops.tables import tags_to_device
from pangenome_index_tpu_torch.parallel.engine import (make_distributed_mem_step,
                                                       make_distributed_serving_step)
from pangenome_index_tpu_torch.parallel.merge import merge_tags_device
from pangenome_index_tpu_torch.parallel.multihost import (global_read_batch, init_distributed,
                                                          put_global)
from pangenome_index_tpu_torch.parallel.sharding import (ShardedRank, distributed_ckpt_rank6,
                                                         distributed_rank6, make_mesh,
                                                         pad_rindex_tables, shard_tables)
from pangenome_index_tpu_torch.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu_torch.utils.synth import (build_synth_index, synth_reads,
                                                   synth_tag_array)

#: the padded tables' forms the engine is served through
FORMS = {"checkpoint": dict(checkpoint=True),
         "two-level": dict(checkpoint=True, super_shift=9), "runs": {}}
TIERS = ("none", "both")
MER_M, SDICT_S, MIN_LEN, MIN_OCC, CAPACITY, TAG_CAPACITY = 6, 15, 12, 1, 6, 8


def workload():
    """The index, its tags and 24 reads of 44 codes (the last ones short),
    with both seed tiers' host arrays."""
    idx, lines = build_synth_index(6_000, 4, seed=2)
    reads = synth_reads(lines, 22, 44, error_rate=0.03, seed=11) + [lines[0][:9],
                                                                    lines[1][:30]]
    codes = np.zeros((len(reads), 44), np.int32)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    mk, mv = read_mer_keys_fast(codes, lens, MER_M)
    keys, vals = build_sparse_dict(idx, SDICT_S)
    seeds = dict(mer_table=build_mer_table(idx, MER_M), mer_keys=np.asarray(mk, np.int32),
                 mer_valid=np.asarray(mv), sdict_vals=np.asarray(vals),
                 sdict_idx=np.asarray(read_windows_fast(codes, lens, SDICT_S, keys)[2],
                                      np.int32))
    return idx, synth_tag_array(idx), codes, lens, seeds


def rank_positions(idx) -> np.ndarray:
    """Every 7th position, and 0, n - 1 and n."""
    return np.concatenate((np.arange(0, idx.n + 1, 7), [0, idx.n - 1, idx.n]))


def engine_rank(rank: int, world: int, n_data: int, n_model: int, out_dir: str) -> None:
    """Both distributed steps on this rank, for every form and seed tier:
    out_dir/<form>-<tiers>-<rank>.npz holds the serving step's MemResult,
    TagQueryResult and total, and the MEM step's MemResult and total; with
    model shards, out_dir/<form>-rank6-<rank>.npy the model group's
    distributed rank6 (distributed_ckpt_rank6 / distributed_rank6) at
    rank_positions."""
    mesh = make_mesh(n_data, n_model, "cpu")
    idx, tags, codes, lens, seeds = workload()
    tt = tags_to_device(tags, "cpu")
    c, n = global_read_batch(mesh, codes, lens)
    local = put_global(mesh, {k: seeds[k] for k in ("mer_keys", "mer_valid", "sdict_idx")},
                       dict.fromkeys(("mer_keys", "mer_valid", "sdict_idx"), "data"))
    for form, kw in FORMS.items():
        t = pad_rindex_tables(idx, n_model, device="cpu", **kw)
        placed = shard_tables(t, mesh)
        if isinstance(placed, ShardedRank):
            sh = placed.shards[0]
            pos = torch.from_numpy(rank_positions(idx)).to(t.pos_dtype)
            r6 = (distributed_rank6(sh.run_start, sh.run_sym, sh.cum, pos, mesh, sh.upper)
                  if form == "runs" else
                  distributed_ckpt_rank6(sh.planes, pos, mesh, placed.super_base))
            np.save(os.path.join(out_dir, f"{form}-rank6-{rank}.npy"), r6.long().numpy())
        for tiers in TIERS:
            seed, ms = [], {}
            if tiers == "both":
                seed = [torch.from_numpy(seeds["mer_table"]).to(t.pos_dtype),
                        local["mer_keys"], local["mer_valid"],
                        torch.from_numpy(seeds["sdict_vals"]).to(t.pos_dtype),
                        local["sdict_idx"]]
                ms = dict(mer_m=MER_M, sdict_m=SDICT_S)
            serve = make_distributed_serving_step(mesh, capacity=CAPACITY,
                                                  tag_capacity=TAG_CAPACITY, **ms)
            res, tq, total = serve(placed, tt, c, n, MIN_LEN, MIN_OCC, *seed)
            res2, total2 = make_distributed_mem_step(mesh, capacity=CAPACITY, **ms)(
                placed, c, n, MIN_LEN, MIN_OCC, *seed)
            out = {f"mem_{f}": getattr(res, f).numpy() for f in res._fields}
            out.update({f"tq_{f}": getattr(tq, f).numpy() for f in tq._fields})
            out.update({f"mem2_{f}": getattr(res2, f).numpy() for f in res2._fields})
            np.savez(os.path.join(out_dir, f"{form}-{tiers}-{rank}.npz"), total=int(total),
                     total2=int(total2), **out)


def merge_rank(rank: int, world: int, cases: dict, out_dir: str) -> None:
    """The cross-card merge of every case (name -> (comp_per_row, streams))
    on a data mesh of `world` ranks; each rank writes the tags it gathered."""
    mesh = make_mesh(world, 1, "cpu")
    for name, (cpr, streams) in cases.items():
        np.save(os.path.join(out_dir, f"{name}-{rank}.npy"),
                merge_tags_device(mesh, cpr, streams))


def cli_rank(rank: int, world: int, argv: list) -> int:
    """One command line run as a rank of the joined group."""
    return cli.main(argv)


def coordinator_rank(rank: int, address: str, world: int, out_path: str) -> None:
    """Join through JAX's environment names, sum the ranks, write it."""
    os.environ.update(COORDINATOR_ADDRESS=address, NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    dev = init_distributed(device="cpu")
    t = torch.tensor([rank + 1], dtype=torch.int64, device=dev)
    torch.distributed.all_reduce(t)
    with open(out_path, "w") as fh:
        fh.write(f"{torch.distributed.get_world_size()} {int(t)}")
    torch.distributed.destroy_process_group()
