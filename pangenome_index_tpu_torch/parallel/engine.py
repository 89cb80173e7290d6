"""The distributed query engine: reads over `data`, the index over `model`.

Counterpart of pangenome_index_tpu/parallel/engine.py, whose steps run under
shard_map on a (data, model) mesh; here each rank of the mesh runs the step
on its own slice of the reads (multihost.global_read_batch) and its own
placement of the index (sharding.shard_tables), and the steps return this
rank's MemResult (and TagQueryResult) with the total MEM count summed over
the data group.

* model = 1: the tables are whole on every card (the deployment ROADMAP A.8
  recommends up to 2.3 Gbp of index), and the rank provider is local: the
  one-card kernels serve the slice (resolve_seeds, K3 find_mems, K6
  query_tags_batch), then one all_reduce of the count.
* model > 1: the lockstep engine (ops/mems.py:find_mems_lockstep): each
  iteration one launch of the MEM step (csrc/memstep.cu), which also makes
  the shard's rank partials of the next positions (checkpoint rows, or the
  run table for every other rank mode), then one all_reduce over the model
  group, as JAX's psum inside its while_loop; on a card the iterations run
  as a CUDA graph. Every rank of a model group holds the same reads and
  receives the same ranks, so all leave the loop at the same iteration.
"""

from __future__ import annotations

import torch

from ..ops.mems import MemResult, find_mems, find_mems_lockstep
from ..ops.tagquery import TagQueryResult, query_tags_batch
from .sharding import Mesh, ShardedRank


def _seed_kwargs(mer_m: int, sdict_m: int, seed_args) -> dict:
    """The seed tiers' keyword arguments from the step's trailing ones:
    (mer_table, mer_keys, mer_valid) when mer_m, then (sdict_vals,
    sdict_idx) when sdict_m; tables replicated, per-read arrays this rank's."""
    kw = {}
    if mer_m:
        kw.update(mer_table=seed_args[0], mer_keys=seed_args[1], mer_valid=seed_args[2],
                  mer_m=mer_m)
        seed_args = seed_args[3:]
    if sdict_m:
        kw.update(sdict_vals=seed_args[0], sdict_idx=seed_args[1], sdict_m=sdict_m)
    return kw


def _mems(placed, codes, lengths, min_len, min_occ, capacity, seed_kw) -> MemResult:
    if isinstance(placed, ShardedRank):
        return find_mems_lockstep(placed.shards, placed.C, placed.n, codes, lengths,
                                  int(min_len), int(min_occ), capacity=capacity,
                                  super_base=placed.super_base,
                                  super_shift=placed.super_shift, reduce=placed.reduce,
                                  **seed_kw)
    return find_mems(placed, codes, lengths, int(min_len), int(min_occ), capacity=capacity,
                     **seed_kw)


def _total(mesh: Mesh, res: MemResult) -> torch.Tensor:
    total = res.count.sum().to(torch.int64).reshape(1)
    return mesh.all_reduce(total, "data")[0]


def make_distributed_mem_step(mesh: Mesh, capacity: int = 16, mer_m: int = 0,
                              sdict_m: int = 0):
    """Returns step(placed, codes, lengths, min_len, min_occ [, mer_table,
    mer_keys, mer_valid][, sdict_vals, sdict_idx]) -> (MemResult of this
    rank's reads, the total MEM count over the data group). `placed`:
    shard_tables' placement of the padded tables (or virtual_shards');
    codes/lengths and the per-read seed keys: this rank's slice."""
    def step(placed, codes, lengths, min_len, min_occ, *seed):
        res = _mems(placed, codes, lengths, min_len, min_occ, capacity,
                    _seed_kwargs(mer_m, sdict_m, seed))
        return res, _total(mesh, res)

    return step


def make_distributed_serving_step(mesh: Mesh, capacity: int = 16, tag_capacity: int = 32,
                                  mer_m: int = 0, sdict_m: int = 0):
    """The full serving step: MEM finding as make_distributed_mem_step, then
    the tag positions of every found MEM (K6 on the replicated tag tables
    `tt`): step(placed, tt, codes, lengths, min_len, min_occ, *seed) ->
    (MemResult, TagQueryResult with positions [b, M * tag_capacity] and
    n_unique, n_runs, overflow [b, M], total). Slots past a read's count
    query the interval [0, 0] and are masked to 0 (overflow False), as in
    the JAX step."""
    def step(placed, tt, codes, lengths, min_len, min_occ, *seed):
        res = _mems(placed, codes, lengths, min_len, min_occ, capacity,
                    _seed_kwargs(mer_m, sdict_m, seed))
        B, M = res.bwt_start.shape
        starts = res.bwt_start.reshape(B * M)
        ends = (res.bwt_start + res.size - 1).reshape(B * M)
        valid = (torch.arange(M, device=starts.device)[None, :]
                 < res.count[:, None]).reshape(B * M)
        starts = torch.where(valid, starts, 0)
        ends = torch.where(valid, ends, 0)
        tq = query_tags_batch(tt, starts, ends, capacity=tag_capacity)
        tq = TagQueryResult(
            positions=tq.positions.reshape(B, M * tag_capacity),
            n_unique=torch.where(valid, tq.n_unique, 0).reshape(B, M),
            n_runs=torch.where(valid, tq.n_runs, 0).reshape(B, M),
            overflow=(tq.overflow & valid).reshape(B, M))
        return res, tq, _total(mesh, res)

    return step
