"""find-mems serving on one device, end to end.

The pipeline bench.py:serve_measure measures for the JAX package, on the
port: r-index tables -> m-mer seed table (K2 launches) -> long-seed
dictionary (host build, cached) -> host read windows -> work sort by seed
difficulty -> MEM finding over the sorted batch (K3, one launch) -> tag
counts per buffered MEM (K4) -> results back in input read order.

Two rank configurations: checkpoint rows (the serving default) or dense run
records (the counterpart of the TPU's Pallas rank path).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .models.rindex import RIndex
from .models.tagarray import TagArray
from .ops.dense_rank import rank6_dense
from .ops.mems import find_mems
from .ops.mertable import (build_mer_table_device, read_mer_keys_fast,
                           seed_difficulty)
from .ops.sparsedict import get_sparse_dict, read_windows_fast, sdict_to_device
from .ops.tables import (RIndexTables, TagTables, rindex_to_device,
                         tags_to_device)
from .ops.tagquery import query_mem_tags


@dataclass
class ServeResult:
    """Per-read results in input order, and seconds per phase."""

    count: np.ndarray        # [B] MEMs per read (exact past capacity)
    start: np.ndarray        # [B, M] buffered MEMs
    end: np.ndarray
    bwt_start: np.ndarray
    size: np.ndarray
    tag_nu: np.ndarray       # [B, M] distinct tag positions per MEM
    tag_ov: np.ndarray       # [B, M] tag window overflow
    seconds: dict[str, float]
    dict_entries: int
    dict_hit_rate: float     # valid read windows found in the dictionary


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_dense_tables(t: RIndexTables) -> None:
    """Exactness guard for dense tables: rank6 at every run head must equal
    that run's record, i.e. pos_to_run and rec describe the same runs (a
    mismatch would make every answer silently wrong)."""
    heads = t.rec[:, 0].contiguous()
    if not torch.equal(rank6_dense(t.rec, t.pos_to_run, heads), t.rec[:, 2:8]):
        raise ValueError("dense tables disagree: pos_to_run does not map run "
                         "heads to their records")


@dataclass
class Batch:
    """A read batch resident on the device, sorted by seed difficulty, with
    the tables and seed tiers that serve it (what `prepare` builds)."""

    tables: RIndexTables
    tag_tables: TagTables
    codes: torch.Tensor      # [B, L] int32, sorted order
    lengths: torch.Tensor    # [B] int32, sorted order
    order: torch.Tensor      # sorted position -> input read index
    seed_kw: dict            # seed tiers for find_mems (per-read rows sorted)
    seconds: dict[str, float]
    dict_entries: int
    dict_hit_rate: float


def prepare(idx: RIndex, tags: TagArray, codes: np.ndarray, lens: np.ndarray,
            device, *, dense: bool = False, min_occ: int = 1, mer_m: int = 14,
            sdict_s: int = 19, sdict_path=None) -> Batch:
    """Tables, m-mer seed table, length-sdict_s dictionary and read windows
    for one batch of reads (codes [B, L] int32, lens [B]) on `device`,
    sorted by seed difficulty. dense=False ranks through checkpoint rows,
    dense=True through dense run records; sdict_path caches the host
    dictionary build."""
    device = torch.device(device)
    sec: dict[str, float] = {}

    def phase(name, t0):
        _sync(device)
        sec[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    t = rindex_to_device(idx, device, checkpoint=not dense, dense=dense)
    if dense:
        check_dense_tables(t)
    tt = tags_to_device(tags, device)
    phase("tables", t0)

    t0 = time.perf_counter()
    mer_table = build_mer_table_device(t, mer_m)
    phase("mer_table", t0)

    t0 = time.perf_counter()
    keys_sd, vals_sd = get_sparse_dict(idx, sdict_s, path=sdict_path)
    phase("sdict", t0)

    t0 = time.perf_counter()
    mk, mv = read_mer_keys_fast(codes, lens, mer_m)
    _, rv, di = read_windows_fast(codes, lens, sdict_s, keys_sd)
    phase("windows", t0)

    t0 = time.perf_counter()
    lens_d = torch.from_numpy(np.ascontiguousarray(lens, np.int32)).to(device)
    mer_keys = torch.from_numpy(np.ascontiguousarray(mk, np.int32)).to(device)
    mer_valid = torch.from_numpy(np.ascontiguousarray(mv)).to(device)
    # work sort: reads of like difficulty share a warp (results are
    # inverse-permuted back to input order)
    proxy = seed_difficulty(mer_table, mer_keys, mer_valid, min_occ, lens_d, mer_m)
    order = torch.argsort(proxy, stable=True)
    vals_d, di_d = sdict_to_device(vals_sd, di, device)
    kw = dict(mer_table=mer_table, mer_keys=mer_keys[order].contiguous(),
              mer_valid=mer_valid[order].contiguous(), mer_m=mer_m,
              sdict_vals=vals_d, sdict_idx=di_d[order].contiguous(),
              sdict_m=sdict_s)
    codes_d = torch.from_numpy(np.ascontiguousarray(codes, np.int32)).to(device)
    batch = Batch(tables=t, tag_tables=tt, codes=codes_d[order].contiguous(),
                  lengths=lens_d[order].contiguous(), order=order, seed_kw=kw,
                  seconds=sec, dict_entries=len(keys_sd),
                  dict_hit_rate=float((di >= 0).sum() / max(rv.sum(), 1)))
    phase("sort", t0)
    return batch


def run(batch: Batch, min_len: int = 20, min_occ: int = 1, capacity: int = 8,
        tag_capacity: int = 8, repeats: int = 0) -> ServeResult:
    """MEM finding (one K3 launch over the sorted batch) and tag counts (K4),
    back in input read order. repeats > 0 runs both phases that many more
    times after the first and reports their mean seconds (steady state)."""
    device = batch.codes.device
    sec = dict(batch.seconds)
    runs = []
    for _ in range(1 + repeats):
        t0 = time.perf_counter()
        res = find_mems(batch.tables, batch.codes, batch.lengths, min_len,
                        min_occ, capacity=capacity, **batch.seed_kw)
        _sync(device)
        t1 = time.perf_counter()
        nu, ov = query_mem_tags(batch.tag_tables, res.bwt_start, res.size,
                                res.count, capacity=tag_capacity)
        _sync(device)
        runs.append((t1 - t0, time.perf_counter() - t1))
    sec["mems_first"], sec["tags_first"] = runs[0]
    steady = runs[1:] or runs
    sec["mems"] = sum(r[0] for r in steady) / len(steady)
    sec["tags"] = sum(r[1] for r in steady) / len(steady)
    t0 = time.perf_counter()
    inv = torch.empty_like(batch.order)
    inv[batch.order] = torch.arange(batch.order.shape[0], device=device)

    def back(a):
        return a[inv].cpu().numpy()

    out = ServeResult(
        count=back(res.count), start=back(res.start), end=back(res.end),
        bwt_start=back(res.bwt_start), size=back(res.size), tag_nu=back(nu),
        tag_ov=back(ov), seconds=sec, dict_entries=batch.dict_entries,
        dict_hit_rate=batch.dict_hit_rate)
    sec["fetch"] = time.perf_counter() - t0
    return out


def serve(idx: RIndex, tags: TagArray, codes: np.ndarray, lens: np.ndarray,
          device, *, dense: bool = False, min_len: int = 20, min_occ: int = 1,
          mer_m: int = 14, sdict_s: int = 19, sdict_path=None,
          capacity: int = 8, tag_capacity: int = 8,
          repeats: int = 0) -> ServeResult:
    """Serve one batch of reads end to end: `prepare`, then `run`."""
    batch = prepare(idx, tags, codes, lens, device, dense=dense,
                    min_occ=min_occ, mer_m=mer_m, sdict_s=sdict_s,
                    sdict_path=sdict_path)
    return run(batch, min_len=min_len, min_occ=min_occ, capacity=capacity,
               tag_capacity=tag_capacity, repeats=repeats)
