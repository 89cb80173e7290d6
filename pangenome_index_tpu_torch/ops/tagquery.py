"""K4: tag counts for every buffered MEM (csrc/tagquery.cu).

Counterpart of pangenome_index_tpu/ops/tagquery.py:query_mem_tags. For each
(read, slot) below min(count, M): the run range of [bwt_start,
bwt_start + size - 1] by two upper-bound searches over the tag run heads,
started with the reference's mod-10 quirk (START_EVERY_K), a `capacity`
window of pos_enc, and the number of distinct positions in it (pairwise
first occurrence). Other slots give 0; `overflow` marks slots whose run span
exceeds `capacity`.
"""

from __future__ import annotations

import torch

from .. import _build
from .tables import TagTables

#: encoded_start_every_k_run of the reference (tag_arrays.hpp:120); the JAX
#: module that defines it imports jax, so it is restated here
START_EVERY_K = 10


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
    card (int32 buffers and run heads), the plain version on the CPU."""
    if bwt_start.device.type == "cpu":
        return query_mem_tags_plain(tt, bwt_start, size, count, capacity)
    dev = tt.bwt_start.device
    B, M = bwt_start.shape
    nu = torch.empty((B, M), dtype=torch.int32, device=dev)
    ov = torch.empty((B, M), dtype=torch.bool, device=dev)
    _build.launch("pgt_query_mem_tags",
                  _build.check("tag bwt_start", tt.bwt_start, torch.int32, dev),
                  tt.n_runs, _build.check("pos_enc", tt.pos_enc, torch.int64, dev),
                  _build.check("bwt_start", bwt_start, torch.int32, dev),
                  _build.check("size", size, torch.int32, dev),
                  _build.check("count", count, torch.int32, dev), B, M,
                  int(capacity), nu.data_ptr(), ov.data_ptr(), _build.stream(dev))
    query_mem_tags.launches += 1
    return nu, ov


query_mem_tags.launches = 0
