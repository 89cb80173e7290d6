"""K4: tag counts for every buffered MEM (csrc/tagquery.cu), and K6: tag
positions for a batch of BWT intervals (csrc/tagbatch.cu).

K4 is the counterpart of pangenome_index_tpu/ops/tagquery.py:query_mem_tags.
For each (read, slot) below min(count, M): the run range of [bwt_start,
bwt_start + size - 1] by two upper-bound searches over the tag run heads,
started with the reference's mod-10 quirk (START_EVERY_K), a `capacity`
window of pos_enc, and the number of distinct positions in it (pairwise
first occurrence). Other slots give 0; `overflow` marks slots whose run span
exceeds `capacity`.

K6 is the counterpart of query_tags_batch: per interval, the same run range
(the mod-10 quirk, or the runs overlapping the interval exactly), and the
distinct positions of the window ascending at the front of a `capacity`
row padded with -1, for the command-line output.

Both kernels search the run heads through the tables' search tree
(tables.derive_search_tree; csrc/tags.cuh). tag_upper_bound is that search
alone (csrc/tagsearch.cu), the counterpart of the jnp.searchsorted calls of
the two JAX functions; its plain version walks the same tree with torch
indexing, so the structure can be held against torch.searchsorted on any
device. The plain versions of K4 and K6 keep torch.searchsorted.

The run heads are int32 below 2^31 BWT rows and int64 past it (a tree node
then holds 8 keys); each kernel has an instantiation for either, picked by
the heads' dtype, and takes the intervals in that dtype (converted where
they come in the other: _keys).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build, spans
from .tables import TagTables, tree_upper_bound_plain

#: encoded_start_every_k_run of the reference (tag_arrays.hpp:120); the JAX
#: module that defines it imports jax, so it is restated here
START_EVERY_K = 10


#: widest row K6 takes: its block sorts a row in shared memory
MAX_BATCH_CAPACITY = 1 << 14

def _require_tree(tt: TagTables) -> None:
    if tt.search_tree is None:
        raise ValueError("tag tables without a search tree: build them with "
                         "tags_to_device or tables_from_numpy")


def _tree_args(tt: TagTables, dev) -> tuple:
    """(entry point suffix: "" for int32 heads, "64" for int64; the kernels'
    view of the tag tables: heads, their count, the search tree and its
    lines). Raises when the tables carry no tree."""
    _require_tree(tt)
    kd = tt.bwt_start.dtype
    if kd not in (torch.int32, torch.int64):
        raise ValueError(f"tag run heads of {kd}: the kernels take int32 or int64")
    heads = _build.check("tag bwt_start", tt.bwt_start, kd, dev)
    tree = _build.check("tag search tree", tt.search_tree, kd, dev)
    if heads % 16 or tree % 16:
        raise ValueError("tag run heads and search tree must be 16-byte aligned")
    return ("64" if kd == torch.int64 else ""), (heads, tt.n_runs, tree,
                                                 tt.search_tree.shape[0])


def _keys(name: str, v: torch.Tensor, kd: torch.dtype, dev) -> torch.Tensor:
    """v in the heads' dtype. int32 values are widened for int64 heads;
    int64 values (the MEM buffers of int64 r-index tables beside int32 tag
    heads, where n_seq * max_len passes 2^31 and n does not) are clamped
    into int32, which keeps every search's answer: every head lies below
    the int32 maximum and at or above 0."""
    if v.dtype == torch.int64 and kd == torch.int32:
        info = torch.iinfo(torch.int32)
        v = v.clamp(info.min, info.max).int()
    elif v.dtype != kd:
        v = v.to(kd)
    _build.check(name, v, kd, dev)
    return v


def tag_upper_bound_plain(tt: TagTables, v: torch.Tensor) -> torch.Tensor:
    """Number of run heads <= v[i] (searchsorted side="right"), found by
    walking the tables' search tree with torch indexing
    (tables.tree_upper_bound_plain). [B] int32."""
    _require_tree(tt)
    return tree_upper_bound_plain(tt.search_tree, tt.tree_levels, tt.bwt_start,
                                  v).to(torch.int32)


def tag_upper_bound(tt: TagTables, v: torch.Tensor) -> torch.Tensor:
    """v [B] (the run heads' dtype) -> number of run heads <= v[i], [B]
    int32: one kernel launch on the card, the plain walk of the tree on the
    CPU."""
    if v.dim() != 1:
        raise ValueError("tag_upper_bound: v must be [B]")
    if v.device.type == "cpu":
        return tag_upper_bound_plain(tt, v)
    dev = tt.bwt_start.device
    sfx, targs = _tree_args(tt, dev)
    v = _keys("v", v, tt.bwt_start.dtype, dev)
    out = torch.empty(v.shape[0], dtype=torch.int32, device=dev)
    _build.launch(f"pgt_tag_upper_bound{sfx}", *targs, v.data_ptr(), v.shape[0],
                  out.data_ptr(), _build.stream(dev))
    tag_upper_bound.launches += 1
    return out


tag_upper_bound.launches = 0


def query_mem_tags_plain(tt: TagTables, bwt_start, size, count,
                         capacity: int = 32):
    """(n_unique [B, M] int32, overflow [B, M] bool)."""
    B, M = bwt_start.shape
    dev = bwt_start.device
    t = tt.n_runs
    valid = torch.arange(M, device=dev)[None, :] < count.clamp(max=M)[:, None]
    s = torch.where(valid, bwt_start, 0).reshape(-1).to(tt.bwt_start.dtype)
    e = torch.where(valid, bwt_start + size - 1, 0).reshape(-1) \
        .to(tt.bwt_start.dtype)
    first_bit = torch.searchsorted(tt.bwt_start, s, right=True)
    end_bit = torch.searchsorted(tt.bwt_start, e, right=True)
    run_nums = end_bit - first_bit + 1
    rs = torch.where(first_bit % START_EVERY_K == 0, first_bit, first_bit - 1)
    slots = torch.arange(capacity, device=dev)
    win = rs[:, None] + slots[None, :]
    ok = (slots[None, :] < run_nums[:, None]) & (win < t) & (win >= 0)
    big = torch.iinfo(tt.pos_enc.dtype).max
    vals = torch.where(ok, tt.pos_enc[win.clamp(0, t - 1)], big)
    earlier = slots[None, :, None] > slots[None, None, :]
    dup = ((vals[:, :, None] == vals[:, None, :]) & earlier).any(dim=2)
    uniq = (vals != big) & ~dup
    nu = torch.where(valid, uniq.sum(dim=1).to(torch.int32).reshape(B, M), 0)
    ov = (run_nums > capacity).reshape(B, M) & valid
    return nu, ov


def query_mem_tags(tt: TagTables, bwt_start, size, count, capacity: int = 32):
    """bwt_start/size [B, M] and count [B] (MemResult buffers) ->
    (n_unique [B, M] int32, overflow [B, M] bool); one kernel launch on the
    card (buffers converted to the run heads' dtype), the plain version on
    the CPU. Span (spans.py): tags.k4, with a device interval."""
    with spans.span("tags.k4", device=True):
        if bwt_start.device.type == "cpu":
            return query_mem_tags_plain(tt, bwt_start, size, count, capacity)
        dev = tt.bwt_start.device
        B, M = bwt_start.shape
        sfx, targs = _tree_args(tt, dev)
        kd = tt.bwt_start.dtype
        bwt_start, size = (_keys(name, a, kd, dev)
                           for name, a in (("bwt_start", bwt_start), ("size", size)))
        nu = torch.empty((B, M), dtype=torch.int32, device=dev)
        ov = torch.empty((B, M), dtype=torch.bool, device=dev)
        _build.launch(f"pgt_query_mem_tags{sfx}", *targs,
                      _build.check("pos_enc", tt.pos_enc, torch.int64, dev),
                      bwt_start.data_ptr(), size.data_ptr(),
                      _build.check("count", count, torch.int32, dev), B, M,
                      int(capacity), nu.data_ptr(), ov.data_ptr(), _build.stream(dev))
        query_mem_tags.launches += 1
        return nu, ov


query_mem_tags.launches = 0


class TagQueryResult(NamedTuple):
    positions: torch.Tensor  # [B, capacity] int64 distinct positions, then -1
    n_unique: torch.Tensor   # [B] int32
    n_runs: torch.Tensor     # [B] int32 the reference's reported run count
    overflow: torch.Tensor   # [B] bool: n_runs > capacity


def query_tags_batch_plain(tt: TagTables, start, end, capacity: int = 64,
                           exact: bool = False) -> TagQueryResult:
    """start/end [B] inclusive BWT intervals (the run heads' dtype)."""
    t = tt.n_runs
    dev = start.device
    first_bit = torch.searchsorted(tt.bwt_start, start, right=True)
    end_bit = torch.searchsorted(tt.bwt_start, end, right=True)
    run_nums = end_bit - first_bit + 1
    if exact:
        s = (first_bit - 1).clamp(min=0)
    else:
        s = torch.where(first_bit % START_EVERY_K == 0, first_bit, first_bit - 1)
    slots = torch.arange(capacity, device=dev)
    win = s[:, None] + slots[None, :]
    valid = (slots[None, :] < run_nums[:, None]) & (win < t) & (win >= 0)
    big = torch.iinfo(torch.int64).max
    vals = torch.where(valid, tt.pos_enc[win.clamp(0, t - 1)], big)
    vals = torch.sort(vals, dim=1).values
    keep = torch.cat((torch.ones_like(vals[:, :1], dtype=torch.bool),
                      vals[:, 1:] != vals[:, :-1]), dim=1) & (vals != big)
    # compact the kept values to the front of each row, in order
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    kept = torch.take_along_dim(keep, order, dim=1)
    out = torch.where(kept, torch.take_along_dim(vals, order, dim=1), -1)
    return TagQueryResult(out, keep.sum(dim=1).to(torch.int32),
                          run_nums.to(torch.int32), run_nums > capacity)


def query_tags_batch(tt: TagTables, start, end, capacity: int = 64,
                     exact: bool = False) -> TagQueryResult:
    """start/end [B] inclusive BWT intervals -> TagQueryResult; one kernel
    launch on the card (intervals converted to the run heads' dtype), the
    plain version on the CPU. The kernel writes every slot of `positions`
    itself."""
    if capacity < 1:
        raise ValueError("query_tags_batch: capacity must be >= 1")
    if start.dim() != 1 or end.shape != start.shape:
        raise ValueError("query_tags_batch: start and end must be [B] each")
    if start.device.type == "cpu":
        return query_tags_batch_plain(tt, start, end, capacity, exact)
    if capacity > MAX_BATCH_CAPACITY:
        raise ValueError(f"query_tags_batch: the kernel takes capacities up "
                         f"to {MAX_BATCH_CAPACITY}, got {capacity}")
    dev = tt.bwt_start.device
    B = start.shape[0]
    sfx, targs = _tree_args(tt, dev)
    start, end = (_keys(name, a, tt.bwt_start.dtype, dev)
                  for name, a in (("start", start), ("end", end)))
    positions = torch.empty((B, capacity), dtype=torch.int64, device=dev)
    n_unique, n_runs = (torch.empty(B, dtype=torch.int32, device=dev)
                        for _ in range(2))
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    # the block's sort buffer: the power of two that holds the widest row
    sort_slots = max(64, 1 << (capacity - 1).bit_length())
    _build.launch(f"pgt_query_tags_batch{sfx}", *targs,
                  _build.check("pos_enc", tt.pos_enc, torch.int64, dev),
                  start.data_ptr(), end.data_ptr(), B, int(capacity),
                  int(bool(exact)), sort_slots, positions.data_ptr(),
                  n_unique.data_ptr(), n_runs.data_ptr(), overflow.data_ptr(),
                  _build.stream(dev))
    query_tags_batch.launches += 1
    return TagQueryResult(positions, n_unique, n_runs, overflow)


query_tags_batch.launches = 0
