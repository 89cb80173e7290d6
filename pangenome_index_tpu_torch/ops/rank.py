"""Rank and LF primitives, plain PyTorch, and the ultra and bucketed rank6
kernels (csrc/rankmodes.cu).

The plain versions of the rank providers in csrc/rank.cuh, which extend
(K2), find_mems (K3), count (K7), the seed table's level and the
dictionary's level instantiate, and
of pangenome_index_tpu/ops/rank.py: rank6, rank and lf_range over the table
kinds, in the JAX package's order - checkpoint rows (CkptRank), ultra rows
(UltraRank: rank_table[pos][:6]), dense run records (DenseRank), and the
per-run cum table, found through bucket_lo (run_of: the JAX package's
bucket jump and seven halving probes) or, in base tables, by searchsorted
(no kernel). The kernels rank bucketed tables through the run index derived
beside bucket_lo (BucketRank; tables.derive_run_index): a position's bucket
entry, then its run's record, two dependent loads; run_of_index and
records_rank6 are their plain readers, which rank6_bucketed_plain takes.

Each checkpoint row holds the occ counts before its bucket (cols 0..5) and
the bucket's 64 BWT codes as 4-bit nibbles (cols 6..13, LSB first, 0xF past
n), or, in rows of 24 words, its 128 codes (cols 6..21; the JAX package's
ckpt_block=128); rank6(pos) is the row of pos >> 6 (pos >> 7) plus the
count of each code among its first pos & 63 (pos & 127) nibbles, the block
read from the row width as the JAX _ckpt_rank6 reads it. Row indices clamp
into the table as JAX gathers do.
The kernels read the same counts from a bit-plane form of the rows (and,
for int64 positions, the superblock bases super_S of two-level rows);
planes_rank6 is its plain reader, held against ckpt_rank6 by the tests.
run_of and locate_next are the two searches of locate (ops/locate.py).

rank6_ultra and rank6_bucketed launch their kernel for CUDA tensors (and
count the launch in their `launches` attribute) and run the plain version
for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils.alphabet import COMP_CODE
from .dense_rank import rank6_dense_plain
from .tables import (BUCKET_SHIFT, SINGLE_LEVEL_SHIFT, RIndexTables, run_index_fields,
                     run_index_slots)

_NIBBLE_SHIFTS = torch.arange(0, 32, 4, dtype=torch.int32)


def ckpt_rank6(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """pos [B] -> [B, 6] occ counts, including the two-level ckpt_super add."""
    ckpt = t.ckpt
    nwords = ckpt.shape[1] - 8                                    # 8 or 16
    block = 8 * nwords                                            # 64 or 128
    shift = block.bit_length() - 1
    row = ckpt[(pos.long() >> shift).clamp(0, ckpt.shape[0] - 1)]
    shifts = _NIBBLE_SHIFTS.to(ckpt.device)
    nib = (row[:, 6 : 6 + nwords, None] >> shifts) & 0xF         # [B, nwords, 8]
    nib = nib.reshape(-1, block)                                  # LSB first
    before = torch.arange(block, device=ckpt.device)[None, :] \
        < (pos.long() & (block - 1))[:, None]
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
    out = plane_rows_rank6(row, pos)
    if super_S is None:
        return out
    sup = super_S[(ri << 6) >> super_shift]
    comp = torch.as_tensor(COMP_CODE, dtype=torch.int64, device=pos.device)
    return out.long() + sup[:, comp + 1] - sup[:, comp]


def plane_rows_rank6(row: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """rank6 [B, 6] int32 at pos [B] from each position's bit-plane row
    [B, 16] (its row's count below q = COMP_CODE[code] and one popcount of
    the positions before pos whose planes spell q); relative to the
    superblock for two-level rows."""
    words = row[:, :6].contiguous().view(torch.int64)              # [B, 3]
    before = (torch.ones_like(pos, dtype=torch.int64) << (pos.long() & 63)) - 1
    # S[0..6] back out of the overlapping pairs (S[1], S[2]) ... (S[5], S[6])
    below = torch.cat((torch.zeros_like(row[:, :1]), row[:, 6:7], row[:, 7::2]), dim=1)
    out = []
    for code in range(6):
        q = int(COMP_CODE[code])
        hit = before
        for b in range(3):
            hit = hit & (words[:, b] if (q >> b) & 1 else ~words[:, b])
        out.append(below[:, q + 1] - below[:, q] + _popcount64(hit).to(torch.int32))
    return torch.stack(out, dim=1)


def search_run(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """Run id containing each position, by searchsorted over run_start (-1
    before the first run). [B] int64."""
    pos = pos.to(t.run_start.dtype)
    return torch.searchsorted(t.run_start, pos, right=True) - 1


def run_of(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """Run id containing each position (0..n inclusive). With bucket_lo:
    the JAX package's bucket jump and seven halving probes (the bucket of
    2^BUCKET_SHIFT positions bounds the window to 64 runs; a bucket index
    is clamped into the table, as the kernels do); else search_run. [B]
    int64."""
    if t.bucket_lo is None:
        return search_run(t, pos)
    pos = pos.to(t.run_start.dtype)
    r = t.run_start.shape[0]
    b = (pos.long() >> BUCKET_SHIFT).clamp(0, t.bucket_lo.shape[0] - 1)
    j = t.bucket_lo[b].long()
    for step in (64, 32, 16, 8, 4, 2, 1):
        cand = j + step
        ok = (cand <= r - 1) & (t.run_start[cand.clamp(max=r - 1)] <= pos)
        j = torch.where(ok, cand, j)
    return j


def locate_next(t: RIndexTables, prev: torch.Tensor) -> torch.Tensor:
    """Batched locateNext (r-index.cpp:1369-1372): the packed SA value that
    follows each prev, through the predecessor of prev among the sorted run
    tails (searchsorted; an index of -1 wraps, as the JAX gather does)."""
    prev = prev.to(t.pos_dtype)
    i = torch.searchsorted(t.last_sorted, prev, right=True) - 1
    run = t.last_to_run[i] + 1
    return t.samples[run] + (prev - t.last_sorted[i])


def rank6_ultra_plain(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """Ultra rank6: rank_table[pos][:6], the row index clamped into the
    table ([B] -> [B, 6])."""
    return t.rank_table[pos.long().clamp(0, t.rank_table.shape[0] - 1), :6]


def run_of_index(index: torch.Tensor, first_bucket: int, shift: int,
                 run_start: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The run of each position through a run index (tables.derive_run_index
    over run_start, its buckets from first_bucket on), as the kernels read
    it (csrc/rank.cuh:RunIndex): the position's entry (its bucket clamped
    into the index, its offset p - B into the bucket), j0 plus the stored
    offsets <= p - B; where the entry is full and every stored offset
    counted, the heads after them read from run_start a 64-byte line at a
    time and counted where <= p (a run id below 0, an earlier model
    shard's run in a shard's slice, counts without a read), until a line is
    not all counted. [B] int64."""
    p = pos.long()
    nb, r = index.shape[0], run_start.shape[0]
    b = ((p >> shift) - first_bucket).clamp(0, nb - 1)
    d = (p - ((b + first_bucket) << shift)).clamp(0, (1 << shift) - 1)
    e = index[b]
    j, cnt = run_index_fields(e)
    by = e.contiguous().view(torch.uint8).long()              # [B, 16]
    cap = run_index_slots(shift)
    off = by[:, 6:] if cap == 10 else by[:, 6::2] | (by[:, 7::2] << 8)
    c = (off <= d[:, None]).sum(dim=1)
    j = j + c
    more = (cnt > cap) & (c == cap)
    line = 64 // run_start.element_size()
    k = torch.arange(line, device=p.device)
    while bool(more.any()):
        at = j[:, None] + 1 + k
        h = run_start[at.clamp(0, max(r - 1, 0))].long()
        c = (more[:, None] & ((at < 0) | ((at < r) & (h <= p[:, None])))).sum(dim=1)
        j = j + c
        more = more & (c == line)
    return j


def records_rank6(rec: torch.Tensor, j: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """rank6 [B, 6] from each position's run record rec[j] (start, sym,
    cum0..cum5; j clamped into the records): cum + onehot(sym) * (pos -
    start), in rec's dtype."""
    row = rec[j.clamp(0, rec.shape[0] - 1)]
    onehot = torch.arange(6, device=pos.device)[None, :] == row[:, 1:2].long()
    return row[:, 2:] + onehot.to(rec.dtype) * (pos.to(rec.dtype) - row[:, 0])[:, None]


def rank6_bucketed_plain(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """rank6 through the per-run tables ([B] -> [B, 6]). With the run
    index (bucketed tables): the run of pos through it (run_of_index), then
    its record, as BucketRank reads them; else (base tables) the run by the
    search, then cum[j] + onehot(run_sym[j]) * (pos - run_start[j])."""
    if t.run_index is not None:
        return records_rank6(t.run_rec, run_of_index(t.run_index, 0, t.run_shift,
                                                     t.run_start, pos), pos)
    j = run_of(t, pos)
    onehot = torch.arange(6, device=pos.device)[None, :] \
        == t.run_sym[j].long()[:, None]
    extra = (pos.to(t.pos_dtype) - t.run_start[j])[:, None]
    return t.cum[j] + onehot.to(t.pos_dtype) * extra


def ultra_args(t: RIndexTables) -> tuple:
    """The ultra provider's C arguments (rank_table, rows); the kernels take
    int32 rows and positions, as the reference builds them (n < 2^31)."""
    if t.pos_dtype != torch.int32:
        raise ValueError("ultra rows take int32 positions (n < 2^31): the "
                         "reference serves larger indexes through bucketed rank")
    if t.rank_table.dim() != 2 or t.rank_table.shape[1] != 8 or not t.rank_table.shape[0]:
        raise ValueError("rank_table must be [n + 2, 8]")
    return (_build.check("rank_table", t.rank_table, torch.int32, t.device),
            t.rank_table.shape[0])


def bucket_args(t: RIndexTables) -> tuple:
    """The bucketed provider's C arguments (run_index, buckets, run_shift,
    run_rec, run_start, runs): the run index [nb, 4] int32 and the records
    [r, 8] and heads in the position dtype."""
    dev, pd = t.device, t.pos_dtype
    r = t.run_start.shape[0]
    if not r or t.run_index is None or t.run_index.dim() != 2 or t.run_index.shape[1] != 4 \
            or not t.run_index.shape[0] or t.run_rec is None \
            or tuple(t.run_rec.shape) != (r, 8):
        raise ValueError("bucketed tables need the run index [nb, 4] and records "
                         "[r, 8] (ops/tables.py:with_run_index)")
    return (_build.check("run_index", t.run_index, torch.int32, dev), t.run_index.shape[0],
            int(t.run_shift), _build.check("run_rec", t.run_rec, pd, dev),
            _build.check("run_start", t.run_start, pd, dev), r)


def rank6_ultra(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """Ultra rank6 of int32 positions over the int32 rank_table ([B] ->
    [B, 6]): one launch on the card, the plain version on the CPU."""
    if pos.device.type == "cpu":
        return rank6_ultra_plain(t, pos)
    args = ultra_args(t)
    out = torch.empty((pos.shape[0], 6), dtype=torch.int32, device=t.device)
    _build.launch("pgt_rank6_ultra", *args,
                  _build.check("pos", pos, torch.int32, t.device), pos.shape[0],
                  out.data_ptr(), _build.stream(t.device))
    rank6_ultra.launches += 1
    return out


rank6_ultra.launches = 0


def rank6_bucketed(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """Bucketed rank6 ([B] -> [B, 6]) of positions in the tables' dtype:
    one launch on the card (the int32 or int64 entry point by that dtype),
    the plain version on the CPU."""
    if pos.device.type == "cpu":
        return rank6_bucketed_plain(t, pos)
    if t.bucket_lo is None:
        raise ValueError("rank6_bucketed: the tables carry no bucket_lo")
    pd = t.pos_dtype
    args = bucket_args(t)
    out = torch.empty((pos.shape[0], 6), dtype=pd, device=t.device)
    _build.launch("pgt_rank6_bucketed" + ("64" if pd == torch.int64 else ""), *args,
                  _build.check("pos", pos, pd, t.device), pos.shape[0],
                  out.data_ptr(), _build.stream(t.device))
    rank6_bucketed.launches += 1
    return out


rank6_bucketed.launches = 0


def rank6(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """The table's rank provider ([B] -> [B, 6]), in the JAX package's
    order: checkpoint rows when present, else ultra rows, else dense
    records, else the per-run cum table (bucketed or base)."""
    if t.ckpt is not None:
        return ckpt_rank6(t, pos)
    if t.rank_table is not None:
        return rank6_ultra_plain(t, pos)
    if t.rec is not None:
        return rank6_dense_plain(t.rec, t.pos_to_run, pos)
    return rank6_bucketed_plain(t, pos)


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
