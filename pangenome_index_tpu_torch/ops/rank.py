"""Rank and LF primitives, plain PyTorch.

The plain versions of the rank providers in csrc/rank.cuh, which extend
(K2), find_mems (K3) and count (K7) instantiate, and of
pangenome_index_tpu/ops/rank.py: rank6, rank and lf_range over the three
table kinds - checkpoint rows (CkptRank), dense run records (DenseRank), and
base tables (the per-run cum table, run_of by searchsorted; no kernel).

Each checkpoint row holds the occ counts before its bucket (cols 0..5) and
the bucket's 64 BWT codes as 4-bit nibbles (cols 6..13, LSB first, 0xF past
n); rank6(pos) is the row of pos >> 6 plus the count of each code among its
first pos & 63 nibbles. Row indices clamp into the table as JAX gathers do.
The kernels read the same counts from a bit-plane form of the rows (and,
for int64 positions, the superblock bases super_S of two-level rows);
planes_rank6 is its plain reader, held against ckpt_rank6 by the tests.
run_of and locate_next are the two searches of locate (ops/locate.py).
"""

from __future__ import annotations

import torch

from ..utils.alphabet import COMP_CODE
from .dense_rank import rank6_dense_plain
from .tables import SINGLE_LEVEL_SHIFT, RIndexTables

_NIBBLE_SHIFTS = torch.arange(0, 32, 4, dtype=torch.int32)


def ckpt_rank6(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """pos [B] -> [B, 6] occ counts, including the two-level ckpt_super add."""
    ckpt = t.ckpt
    row = ckpt[(pos.long() >> 6).clamp(0, ckpt.shape[0] - 1)]     # [B, 16]
    shifts = _NIBBLE_SHIFTS.to(ckpt.device)
    nib = (row[:, 6:14, None] >> shifts) & 0xF                    # [B, 8, 8]
    nib = nib.reshape(-1, 64)                                     # LSB first
    before = torch.arange(64, device=ckpt.device)[None, :] \
        < (pos.long() & 63)[:, None]
    codes = torch.arange(6, device=ckpt.device, dtype=nib.dtype)
    hits = (nib[:, None, :] == codes[None, :, None]) & before[:, None, :]
    r6 = row[:, :6].to(t.pos_dtype) + hits.sum(dim=2).to(t.pos_dtype)
    if t.ckpt_super is not None:
        ss = t.ckpt_super.shape[1] - 6
        sup = t.ckpt_super[(pos.long() >> ss).clamp(0, t.ckpt_super.shape[0] - 1)]
        r6 = sup[:, :6] + r6
    return r6


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 (SWAR; the shifts are arithmetic, the masks
    drop the sign copies)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def planes_rank6(planes: torch.Tensor, pos: torch.Tensor,
                 super_S: torch.Tensor | None = None,
                 super_shift: int = SINGLE_LEVEL_SHIFT) -> torch.Tensor:
    """rank6 ([B] -> [B, 6]) read from the bit-plane rows the kernels use
    (tables.derive_rank_planes; csrc/rank.cuh:CkptRank): per code, the row's
    count below the code's q = COMP_CODE[code] and one popcount of the
    positions before pos whose planes spell q. int32; with super_S
    (tables.derive_super_S, the bases of two-level rows) int64, the count
    below q in the superblock of the row added, the superblock being
    (row << 6) >> super_shift as in the kernels."""
    ri = (pos.long() >> 6).clamp(0, planes.shape[0] - 1)
    row = planes[ri]
    words = row[:, :6].contiguous().view(torch.int64)              # [B, 3]
    before = (torch.ones_like(pos, dtype=torch.int64) << (pos.long() & 63)) - 1
    # S[0..6] back out of the overlapping pairs (S[1], S[2]) ... (S[5], S[6])
    below = torch.cat((torch.zeros_like(row[:, :1]), row[:, 6:7], row[:, 7::2]), dim=1)
    sup = None if super_S is None else super_S[(ri << 6) >> super_shift]
    out = []
    for code in range(6):
        q = int(COMP_CODE[code])
        hit = before
        for b in range(3):
            hit = hit & (words[:, b] if (q >> b) & 1 else ~words[:, b])
        r = below[:, q + 1] - below[:, q] + _popcount64(hit).to(torch.int32)
        out.append(r if sup is None else r.long() + sup[:, q + 1] - sup[:, q])
    return torch.stack(out, dim=1)


def run_of(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """Run id containing each position (0..n inclusive), by searchsorted."""
    pos = pos.to(t.run_start.dtype)
    return torch.searchsorted(t.run_start, pos, right=True) - 1


def locate_next(t: RIndexTables, prev: torch.Tensor) -> torch.Tensor:
    """Batched locateNext (r-index.cpp:1369-1372): the packed SA value that
    follows each prev, through the predecessor of prev among the sorted run
    tails (searchsorted; an index of -1 wraps, as the JAX gather does)."""
    prev = prev.to(t.pos_dtype)
    i = torch.searchsorted(t.last_sorted, prev, right=True) - 1
    run = t.last_to_run[i] + 1
    return t.samples[run] + (prev - t.last_sorted[i])


def rank6(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """The table's rank provider ([B] -> [B, 6]): checkpoint rows when
    present, else dense records, else the per-run cum table."""
    if t.ckpt is not None:
        return ckpt_rank6(t, pos)
    if t.rec is not None:
        return rank6_dense_plain(t.rec, t.pos_to_run, pos)
    j = run_of(t, pos)
    onehot = torch.arange(6, device=pos.device)[None, :] \
        == t.run_sym[j].long()[:, None]
    extra = (pos.to(t.pos_dtype) - t.run_start[j])[:, None]
    return t.cum[j] + onehot.to(t.pos_dtype) * extra


def rank(t: RIndexTables, pos: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """occ(code, [0, pos)) for pos/code [B]; a one-hot select, so codes
    outside 0..5 give 0 as in the JAX code."""
    oh = torch.arange(6, device=pos.device)[None, :] == code.long()[:, None]
    return torch.where(oh, rank6(t, pos), 0).sum(dim=1).to(t.pos_dtype)


def lf_range(t: RIndexTables, first, second, code):
    """Batched LF mapping of [first, second] by `code` ([B] each). Empty
    results are the reference's (1, 0) sentinel."""
    valid = (code > 0) & (first <= second)
    lo = rank(t, torch.where(valid, first, 0), code)
    inside = rank(t, torch.where(valid, second, 0) + 1, code) - lo
    ok = valid & (inside > 0)
    start = lo + t.C[code.long().clamp(0, t.C.shape[0] - 1)]
    return (torch.where(ok, start, 1).to(first.dtype),
            torch.where(ok, start + inside - 1, 0).to(first.dtype))
