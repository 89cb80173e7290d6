"""K7: batched backward search, count (csrc/count.cu).

Counterpart of pangenome_index_tpu/ops/rank.py:count: each read, right to
left from (0, n - 1), through lf_range; the result is the read's BWT
interval (first, second), or the reference's (1, 0) sentinel when it does
not occur. The kernel runs one thread per read, with the block's codes
staged in shared memory ahead of the chain, and stops at the sentinel; the
plain version keeps JAX's lockstep loop over the longest read. The kernel
ranks through checkpoint rows or dense records, at int32 or int64 positions
(query-tags builds checkpoint rows in every rank mode, as the reference
does); the plain version through any tables.
"""

from __future__ import annotations

import torch

from .. import _build
from .fmd import check_kernel_tables, rank_args
from .rank import lf_range
from .tables import RIndexTables

#: the rank providers the kernel is instantiated for (fmd.rank_args kinds)
COUNT_KINDS = ("ckpt", "ckpt64", "dense", "dense64")


def count_plain(t: RIndexTables, codes: torch.Tensor, lengths: torch.Tensor):
    """codes [B, L] (right-padded), lengths [B] -> (first, second) [B]."""
    B, L = codes.shape
    dev = codes.device
    first = torch.zeros(B, dtype=t.pos_dtype, device=dev)
    second = torch.full((B,), t.n - 1, dtype=t.pos_dtype, device=dev)
    lane = torch.arange(B, device=dev)
    for i in range(L):
        pos = lengths.long() - 1 - i
        active = pos >= 0
        # a position past the padded width reads code 0, as the one-hot does
        c = torch.where(active & (pos < L), codes[lane, pos.clamp(0, L - 1)], 0)
        nf, ns = lf_range(t, first, second, c.to(t.pos_dtype))
        first = torch.where(active, nf, first)
        second = torch.where(active, ns, second)
    return first, second


def count(t: RIndexTables, codes: torch.Tensor, lengths: torch.Tensor):
    """(first, second) [B] in the tables' position dtype, as count_plain; on
    the card one launch over the batch (int32 codes and lengths), the plain
    version on the CPU."""
    if codes.dim() != 2 or lengths.shape != codes.shape[:1]:
        raise ValueError("count: codes must be [B, L] and lengths [B]")
    if codes.device.type == "cpu":
        return count_plain(t, codes, lengths)
    check_kernel_tables(t)
    dev = t.device
    pd = t.pos_dtype
    B, L = codes.shape
    kind, rargs = rank_args(t)
    if kind not in COUNT_KINDS:
        raise ValueError(f"count: the backward search ranks through checkpoint "
                         f"rows or dense records, not {kind} tables")
    first = torch.empty(B, dtype=pd, device=dev)
    second = torch.empty(B, dtype=pd, device=dev)
    _build.launch(f"pgt_count_{kind}", *rargs,
                  _build.check("C", t.C, pd, dev),
                  _build.check("codes", codes, torch.int32, dev), L,
                  _build.check("lengths", lengths, torch.int32, dev), B, t.n,
                  first.data_ptr(), second.data_ptr(), _build.stream(dev))
    count.launches += 1
    return first, second


count.launches = 0
