"""K8: batched locate, the packed SA values of BWT intervals (csrc/locate.cu).

The counterpart of pangenome_index_tpu/ops/locate.py:locate_batch. Lanes
are intervals (start, size): the SA value at the head of the run holding
`start` (samples[run_of(start)]), locateNext chased from the run head up to
`start` (r-index.cpp:1260-1283), then min(size, capacity) values into the
lane's row of a [B, capacity] buffer, a locateNext between two, zeros after
them. Document-array results (sequence ids) come from dividing by max_len,
as in the JAX package.

On the card one launch, one thread an interval: run_of through the search
tree over the run heads, then each locate_next step through the bucket index
over the run tails and the fused (tail, delta) pairs (two dependent loads a
step where the bucket fits a line; tables.with_locate_tables), at int32
positions or, past 2^31, int64; on the CPU the plain version, which takes
the JAX function's steps with torch.searchsorted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from .rank import locate_next, search_run
from .tables import RIndexTables


class LocateResult(NamedTuple):
    positions: torch.Tensor  # [B, capacity] packed (seq, offset) SA values
    count: torch.Tensor      # [B] int32 number of valid entries
    overflow: torch.Tensor   # [B] bool


def locate_batch_plain(t: RIndexTables, start: torch.Tensor, size: torch.Tensor,
                       capacity: int = 64) -> LocateResult:
    """start/size: [B] BWT intervals (the tables' position dtype). Packed SA
    values of rows start .. start + min(size, capacity) - 1 per lane, step
    for step as the JAX function."""
    B = start.shape[0]
    j = search_run(t, start)
    first = t.samples[j]
    off = t.run_start[j]
    while bool((off < start).any()):   # the chase from the run head
        first = torch.where(off < start, locate_next(t, first), first)
        off = torch.minimum(off + 1, start)
    out = torch.zeros((B, capacity), dtype=t.pos_dtype, device=start.device)
    cur = first
    for i in range(capacity):
        valid = i < size
        out[:, i] = torch.where(valid, cur, out[:, i])
        cur = torch.where(valid, locate_next(t, cur), cur)
    return LocateResult(out, size.clamp(max=capacity).to(torch.int32),
                        size > capacity)


def _locate_args(t: RIndexTables, dev) -> tuple:
    """The kernel's view of the locate tables: the run heads and their
    search tree, the samples, the tail pairs and their bucket index."""
    pd = t.pos_dtype
    if pd not in (torch.int32, torch.int64):
        raise ValueError(f"locate: int32 or int64 positions, not {pd}")
    if t.run_tree is None or t.tail_pairs is None or t.tail_lo is None:
        raise ValueError("tables without the locate tables' search tree and tail "
                         "index: build them with rindex_to_device or tables_from_numpy")
    r = t.run_start.shape[0]
    if t.tail_pairs.shape != (r, 2) or t.samples.shape[0] != r + 1:
        raise ValueError("tables without the locate tables (samples and the tail "
                         "pairs of every run)")
    ptrs = [_build.check(name, a, pd, dev) for name, a in (
        ("run_start", t.run_start), ("run search tree", t.run_tree),
        ("samples", t.samples), ("tail pairs", t.tail_pairs))]
    lo_p = _build.check("tail_lo", t.tail_lo, torch.int32, dev)
    if any(p % 16 for p in (ptrs[0], ptrs[1], ptrs[3])):
        raise ValueError("the run heads, their tree and the tail pairs must be "
                         "16-byte aligned")
    return (ptrs[0], ptrs[1], t.run_tree.shape[0], ptrs[2], ptrs[3], lo_p,
            t.tail_lo.shape[0] - 1, t.tail_shift, r)


def locate_batch(t: RIndexTables, start: torch.Tensor, size: torch.Tensor,
                 capacity: int = 64) -> LocateResult:
    """start/size [B] BWT intervals -> LocateResult (positions [B, capacity]
    in the tables' position dtype, count [B] int32 = min(size, capacity),
    overflow [B] bool = size > capacity); one kernel launch on the card
    (intervals in the tables' position dtype: int32, or int64 past 2^31),
    the plain version on the CPU."""
    if capacity < 1:
        raise ValueError("locate_batch: capacity must be >= 1")
    if start.dim() != 1 or size.shape != start.shape:
        raise ValueError("locate_batch: start and size must be [B] each")
    if start.device.type == "cpu":
        return locate_batch_plain(t, start, size, capacity)
    dev = t.device
    pd = t.pos_dtype
    B = start.shape[0]
    args = _locate_args(t, dev)
    positions = torch.empty((B, capacity), dtype=pd, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    _build.launch("pgt_locate64" if pd == torch.int64 else "pgt_locate", *args,
                  _build.check("start", start, pd, dev),
                  _build.check("size", size, pd, dev), B, int(capacity),
                  positions.data_ptr(), count.data_ptr(), overflow.data_ptr(),
                  _build.stream(dev))
    locate_batch.launches += 1
    return LocateResult(positions, count, overflow)


locate_batch.launches = 0
