"""find-mems serving on one device, end to end.

The pipeline bench.py:serve_measure measures for the JAX package, on the
port: r-index tables -> m-mer seed table (its level kernel) -> long-seed
dictionary (built on the device at first use, cached) -> host read windows
-> MEM finding over the batch in input read order (K3, one launch) -> tag
counts per buffered MEM (K4). K3 gives every read a thread of its own, so
the batch is not sorted by work: on the card what a sorted batch of mixed
reads saved K3 was less than the sort and its inverse gathers cost (PERF.md).

Four rank configurations, the reference's --rank-mode choices: checkpoint
rows (the serving default), dense run records (the counterpart of the TPU's
Pallas rank path), ultra rows (one 32-byte row of counts a position) and
bucketed runs (a bucket index into the per-run tables). Checkpoint rows,
dense records and bucketed runs serve any n: past 2^31 positions their
tables are int64 (the rows two-level) and every kernel runs its int64
instantiation; ultra rows are int32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import spans
from .models.rindex import RIndex
from .models.tagarray import TagArray
from .ops.dense_rank import gather_rows, rank6_dense
from .ops.mems import find_mems
from .ops.rank import rank6_bucketed, rank6_ultra
from .ops.mertable import get_mer_table, read_mer_keys_fast
from .ops.sparsedict import get_sparse_dict, read_windows_fast, sdict_to_device
from .ops.tables import (RIndexTables, TagTables, rindex_to_device,
                         tags_to_device)
from .ops.tagquery import query_mem_tags


@dataclass
class ServeResult:
    """Per-read results in input order, host arrays of the call's own
    (page-locked where they came from a card), and seconds per phase."""

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
    that run's record, i.e. the lines the kernels read (derived from
    pos_to_run) and rec describe the same runs (a mismatch would make every
    answer silently wrong). The records come through the row gather as
    int32 words (an int64 record is 16 of them), at either position
    dtype."""
    runs = torch.arange(t.rec.shape[0], dtype=torch.int32, device=t.rec.device)
    # the records, through the row gather
    rows = gather_rows(t.rec.view(torch.int32), runs).view(t.rec.dtype)
    heads = rows[:, 0].contiguous()
    if not torch.equal(rank6_dense(t, heads), rows[:, 2:8]):
        raise ValueError("dense tables disagree: the run of a run head is not "
                         "its record")


#: the rank configurations: --rank-mode choice -> rindex_to_device flag
RANK_MODES = ("checkpoint", "dense", "ultra", "bucketed")


def check_rank_tables(t: RIndexTables, rank_mode: str) -> None:
    """Exactness guard of a rank configuration's tables, through its rank6:
    dense (check_dense_tables); ultra, the rows at consecutive run heads
    differ by the run's length in the run's symbol and the row at n holds
    the totals C gives; bucketed, rank6 at every run head is that run's cum
    row (the run index, which the kernels read, lands each head in its own
    run). Checkpoint rows need none (tests/test_torch_kernels.py holds
    their planes)."""
    if rank_mode == "dense":
        check_dense_tables(t)
    elif rank_mode == "ultra":
        heads = torch.cat((t.run_start, torch.full((1,), t.n, dtype=t.pos_dtype,
                                                   device=t.device)))
        r6 = rank6_ultra(t, heads)
        step = r6[1:] - r6[:-1]
        onehot = torch.arange(6, device=t.device)[None, :] == t.run_sym.long()[:, None]
        want = onehot.to(t.pos_dtype) * (heads[1:] - heads[:-1])[:, None]
        if not (torch.equal(step, want) and torch.equal(r6[-1], t.C[1:7] - t.C[:6])):
            raise ValueError("ultra tables disagree with the runs: rank_table "
                             "does not count the run heads' symbols")
    elif rank_mode == "bucketed":
        if not torch.equal(rank6_bucketed(t, t.run_start), t.cum):
            raise ValueError("bucketed tables disagree: the run index does not "
                             "lead each run head to its run")


@dataclass
class Batch:
    """A read batch resident on the device, in input read order, with the
    tables and seed tiers that serve it (what `prepare` builds)."""

    tables: RIndexTables
    tag_tables: TagTables
    codes: torch.Tensor      # [B, L] int32
    lengths: torch.Tensor    # [B] int32
    seed_kw: dict            # seed tiers for find_mems
    seconds: dict[str, float]
    dict_entries: int
    dict_hit_rate: float


def prepare(idx: RIndex, tags: TagArray, codes: np.ndarray, lens: np.ndarray,
            device, *, rank_mode: str = "checkpoint", min_occ: int = 1,
            mer_m: int = 14, sdict_s: int = 19, sdict_path=None) -> Batch:
    """Tables, m-mer seed table (get_mer_table: m steps down where the
    device could not hold it, and the reads are keyed with the m it used),
    length-sdict_s dictionary and read windows for one batch of reads
    (codes [B, L] int32, lens [B]) on `device`.
    rank_mode (RANK_MODES) picks the rank tables, as find-mems --rank-mode
    does (without its mapping past 2^31: there dense records serve at int64
    positions, and ultra tables, which are int32, are refused); the seed
    table and the dictionary
    are built through them, the dictionary on `device` (the kernels of
    csrc/sparsedict.cu on a card) unless sdict_path holds it."""
    if rank_mode not in RANK_MODES:
        raise ValueError(f"rank_mode must be one of {RANK_MODES}, not {rank_mode!r}")
    device = torch.device(device)
    sec: dict[str, float] = {}

    def phase(name):
        """The phase's span, its host seconds in sec[name]; a phase with
        device work ends with a synchronize, so they cover that work."""
        return spans.span("prepare." + name, into=sec, key=name)

    with phase("tables"):
        t = rindex_to_device(idx, device, **{rank_mode: True})
        check_rank_tables(t, rank_mode)
        tt = tags_to_device(tags, device)
        _sync(device)

    with phase("mer_table"):
        mer_table, mer_m = get_mer_table(idx, mer_m, t)
        _sync(device)

    with phase("sdict"):
        keys_sd, vals_sd = get_sparse_dict(idx, sdict_s, path=sdict_path, tables=t)
        _sync(device)

    with phase("windows"):
        mk, mv = read_mer_keys_fast(codes, lens, mer_m)
        _, rv, di = read_windows_fast(codes, lens, sdict_s, keys_sd)

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    with phase("upload"):
        vals_d, di_d = sdict_to_device(vals_sd, di, device, t.pos_dtype)
        kw = dict(mer_table=mer_table, mer_keys=put(mk, np.int32), mer_valid=put(mv),
                  mer_m=mer_m, sdict_vals=vals_d, sdict_idx=di_d, sdict_m=sdict_s)
        batch = Batch(tables=t, tag_tables=tt, codes=put(codes, np.int32),
                      lengths=put(lens, np.int32), seed_kw=kw, seconds=sec,
                      dict_entries=len(keys_sd),
                      dict_hit_rate=float((di >= 0).sum() / max(rv.sum(), 1)))
        _sync(device)
    return batch


#: the result tensors `run` copies back, in this order, and their spans
FETCHED = ("count", "start", "end", "bwt_start", "size", "tag_nu", "tag_ov")
_COPY_SPANS = tuple("serve.copy." + name for name in FETCHED)


def _to_host(a: torch.Tensor) -> np.ndarray:
    """A host array of `a` that owns its memory. From a card: one blocking
    copy straight into page-locked memory from PyTorch's caching host
    allocator (one DMA, no staging through a pageable buffer); the array
    keeps the block alive, and once it is dropped the allocator takes the
    block back for the next call of the same shape. On the CPU: the
    tensor's own memory, as before."""
    if a.device.type != "cuda":
        return a.cpu().numpy()
    host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    host.copy_(a)
    return host.numpy()


def _host_allocs(device: torch.device) -> int:
    """Page-locked blocks the caching host allocator has created so far
    (0 on the CPU, which pins nothing; its statistics are empty until it
    first allocates)."""
    if device.type != "cuda":
        return 0
    return torch.cuda.host_memory_stats().get("num_host_alloc", 0)


def run(batch: Batch, min_len: int = 20, min_occ: int = 1, capacity: int = 8,
        tag_capacity: int = 8) -> ServeResult:
    """MEM finding (one K3 launch over the batch) and tag counts (K4), in
    input read order; then one wait for the device, and the seven result
    tensors copied back, on a card into page-locked host arrays of the
    call's own (_to_host). Spans (spans.py): serve.run, the call's root;
    mems.find (resolve_seeds, K3) and tags.k4 inside the kernels' wrappers;
    serve.wait, the one synchronize; serve.fetch, the copies, a
    serve.copy.<field> each, its host seconds in seconds["fetch"].
    Counters: serve.copy_back_bytes, the bytes of the returned arrays;
    serve.copy_back_pinned_bytes, those of them in page-locked memory;
    serve.copy.host_allocs, the page-locked blocks the copies had to
    allocate (0 where the allocator's cache served every one)."""
    device = batch.codes.device
    sec = dict(batch.seconds)
    with spans.span("serve.run", call=True):
        res = find_mems(batch.tables, batch.codes, batch.lengths, min_len,
                        min_occ, capacity=capacity, **batch.seed_kw)
        nu, ov = query_mem_tags(batch.tag_tables, res.bwt_start, res.size,
                                res.count, capacity=tag_capacity)
        with spans.span("serve.wait"):
            _sync(device)
        out = {}
        nbytes = 0
        with spans.span("serve.fetch", into=sec, key="fetch"):
            allocs = _host_allocs(device) if spans.recording_now() else None
            for name, label, a in zip(FETCHED, _COPY_SPANS, (
                    res.count, res.start, res.end, res.bwt_start, res.size, nu, ov)):
                with spans.span(label, device=True):
                    out[name] = _to_host(a)
                nbytes += out[name].nbytes
            if allocs is not None:
                spans.count("serve.copy.host_allocs", _host_allocs(device) - allocs)
        spans.count("serve.copy_back_bytes", nbytes)
        spans.count("serve.copy_back_pinned_bytes", nbytes if device.type == "cuda" else 0)
        return ServeResult(**out, seconds=sec, dict_entries=batch.dict_entries,
                           dict_hit_rate=batch.dict_hit_rate)


def serve(idx: RIndex, tags: TagArray, codes: np.ndarray, lens: np.ndarray,
          device, *, rank_mode: str = "checkpoint", min_len: int = 20,
          min_occ: int = 1, mer_m: int = 14, sdict_s: int = 19,
          sdict_path=None, capacity: int = 8, tag_capacity: int = 8) -> ServeResult:
    """Serve one batch of reads end to end: `prepare`, then `run`."""
    batch = prepare(idx, tags, codes, lens, device, rank_mode=rank_mode,
                    min_occ=min_occ, mer_m=mer_m, sdict_s=sdict_s,
                    sdict_path=sdict_path)
    return run(batch, min_len=min_len, min_occ=min_occ, capacity=capacity,
               tag_capacity=tag_capacity)
