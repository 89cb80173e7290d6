"""Device-resident index tables as dataclasses of torch tensors.

The layouts are those of the JAX package (pangenome_index_tpu/ops/tables.py),
field for field, so tables carry across between the two packages
(`tables_from_numpy`) and the tests can compare them directly. The port keeps
the four rank representations of the JAX package, and its kernels read each:
checkpoint rows (the serving default: one 64-byte row per rank6 query;
`ckpt` in the layout shared with the JAX package, `ckpt_planes` derived from
it for the kernels), dense run records (`pos_to_run`, the run of each
position, and one 32-byte record a run; the kernels read the run from the
lines derived from `pos_to_run`, `derive_dense_lines`: a 16-byte line for
each 64 positions, then the record), ultra rows (`rank_table`, one 32-byte
row of counts per position) and bucketed runs (`bucket_lo`, the run of each
bucket of 2^BUCKET_SHIFT positions, beside the full per-run cum table; the kernels read the run index
derived from them, `derive_run_index`: a 16-byte entry a bucket, then the
run's record). Base tables (the cum table
with no bucket index) serve the plain versions only. n, n_seq and max_len are host integers: every
kernel takes them as launch arguments, and reading them never waits on the
card. The tag tables carry, beside the JAX package's fields, the search tree
over their run heads that the tag kernels descend (`derive_search_tree`);
the r-index tables carry what locate reads (`with_locate_tables`): the same
tree over the run heads, and the sorted run tails fused with their next
samples and indexed by buckets of their values (`derive_tail_index`).

Positions are int32 while every value fits and int64 past 2^31, as in the
JAX package; the kernels take either (an instantiation for each). At n >=
2^31 the checkpoint rows are the two-level form: int32 counts relative to
their superblock of 2^SUPER_SHIFT positions, and `ckpt_super` the absolute
counts at each superblock start, which the kernels read as `super_S`
(`derive_super_S`) from shared memory. Checkpoint rows hold 64 positions
(16 words) or, as the JAX package's ckpt_block=128, 128 (24 words); the
kernels read 64-position bit-plane rows of either (`derive_rank_planes`).
With mem_only the per-run and locate tables ship as the JAX package's
one-row stubs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.rindex import RIndex
from ..models.tagarray import TagArray
from ..utils.alphabet import COMP_CODE

#: default superblock width of the two-level checkpoint layout (n >= 2^31)
SUPER_SHIFT = 30
#: positions per checkpoint row by default (the JAX package's ckpt_block)
CKPT_BLOCK = 64
#: a checkpoint row's width in int32 words at each block the JAX package
#: takes: six occ counts and the block's 4-bit codes, padded to a multiple
#: of 8
CKPT_WIDTH = {64: 16, 128: 24}
#: the superblock shift that single-level rows are read with
SINGLE_LEVEL_SHIFT = 62
#: superblocks the kernels take (csrc/rank.cuh:kMaxSuper, staged in shared
#: memory): 2^36 positions at SUPER_SHIFT
MAX_SUPER = 64
#: positions a bucket of the bucketed rank mode covers: 2^BUCKET_SHIFT
#: (pangenome_index_tpu/ops/tables.py:BUCKET_SHIFT)
BUCKET_SHIFT = 6
#: the largest bucket shift of the run index (its offsets are 16 bits)
MAX_RUN_SHIFT = 15


@dataclass
class RIndexTables:
    """r-index tables on one device; r runs, 6 symbol codes."""

    run_sym: torch.Tensor      # int8 [r]
    run_start: torch.Tensor    # [r]
    cum: torch.Tensor          # [r, 6] (a 1-row stub beside a row rank table)
    C: torch.Tensor            # [7] exclusive prefix counts per code
    samples: torch.Tensor      # [r+1]
    last_sorted: torch.Tensor  # [r]
    last_to_run: torch.Tensor  # [r]
    n: int                     # BWT size
    n_seq: int
    max_len: int
    # bucketed: [(n >> BUCKET_SHIFT) + 2] the run holding each bucket's first
    # position (beside the full cum)
    bucket_lo: torch.Tensor | None = None
    pos_to_run: torch.Tensor | None = None  # dense: [n+2] run of each position
    rec: torch.Tensor | None = None         # dense: [r, 8] start, sym, cum0..5
    rank_table: torch.Tensor | None = None  # ultra: [n+2, 8] occ before each position
    # dense: what the kernels read in place of pos_to_run (derive_dense_lines):
    # [ceil((n+2) / 64), 4] int32, a 16-byte line for each 64 positions
    dense_lines: torch.Tensor | None = None
    # checkpoint: [n//64+2, 16] int32, or [n//128+2, 24] (ckpt_block=128)
    ckpt: torch.Tensor | None = None
    # the kernels' form of ckpt: [rows, 16] int32, 64 positions a row
    ckpt_planes: torch.Tensor | None = None
    ckpt_super: torch.Tensor | None = None  # two-level: [n_super, 6+shift] int64
    # int64 checkpoint tables: the kernels' form of ckpt_super (one row of
    # zeros for single-level rows), derive_super_S
    super_S: torch.Tensor | None = None
    # what locate (K8) reads beside the JAX package's fields, and refuses
    # tables without (with_locate_tables): the search tree over run_start
    # (derive_search_tree) and the first line of each of its levels; the run
    # tails fused with their next samples, [r, 2] (last_sorted[i],
    # delta[i]), and their bucket index [nb + 1] int32 over buckets of
    # 2^tail_shift packed values (derive_tail_index)
    run_tree: torch.Tensor | None = None
    run_tree_levels: tuple[int, ...] | None = None
    tail_pairs: torch.Tensor | None = None
    tail_lo: torch.Tensor | None = None
    tail_shift: int | None = None
    # bucketed: what the kernels rank through beside the JAX package's
    # fields (derive_run_index): the run index [nb, 4] int32, a 16-byte
    # entry for each bucket of 2^run_shift positions, and the run records
    # [r, 8] of the position dtype (start, sym, cum0..cum5)
    run_index: torch.Tensor | None = None
    run_shift: int | None = None
    run_rec: torch.Tensor | None = None

    @property
    def pos_dtype(self) -> torch.dtype:
        return self.run_start.dtype

    @property
    def device(self) -> torch.device:
        return self.C.device

    @property
    def super_shift(self) -> int:
        """log2 of the superblock width of two-level rows; single-level
        rows read as one superblock (every position's pos >> 62 is 0)."""
        if self.ckpt_super is None:
            return SINGLE_LEVEL_SHIFT
        return self.ckpt_super.shape[1] - 6


@dataclass
class TagTables:
    """Tag-array tables on one device: t runs."""

    pos_enc: torch.Tensor    # int64 [t] packed graph positions
    bwt_start: torch.Tensor  # [t] run head BWT offsets (sorted)
    total: int               # covered BWT length
    # the search tree over bwt_start (derive_search_tree) and the first line
    # of each of its levels; the kernels search through it and refuse
    # tables without it
    search_tree: torch.Tensor | None = None
    tree_levels: tuple[int, ...] | None = None

    @property
    def n_runs(self) -> int:
        return self.bwt_start.shape[0]


def _pick_dtype(*maxvals: int) -> torch.dtype:
    return torch.int32 if all(v < 2**31 for v in maxvals) else torch.int64


def pos_dtype_for(idx: RIndex) -> torch.dtype:
    """The position type rindex_to_device gives an index's tables by default."""
    return _pick_dtype(idx.n, idx.n_seq * idx.max_len, idx.n_runs)


class DeferredTables:
    """Tables that a seed tier's build reads, made by `build` only when one
    needs them (a cache miss); their device and position type are known
    without them."""

    def __init__(self, build, device, pos_dtype: torch.dtype):
        self._build, self._t = build, None
        self.device, self.pos_dtype = torch.device(device), pos_dtype

    def get(self) -> RIndexTables:
        if self._t is None:
            self._t = self._build()
        return self._t


def resolve_tables(t):
    """RIndexTables from tables or DeferredTables (built now if need be)."""
    return t.get() if isinstance(t, DeferredTables) else t


def _put(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def build_ckpt_rows(idx: RIndex, ckpt_block: int = CKPT_BLOCK, chunk: int = 1 << 22,
                    super_shift: int | None = None):
    """Host construction of the checkpoint rank table.

    A copy of pangenome_index_tpu/ops/tables.py:build_ckpt_rows: the JAX
    module imports jax when it is loaded, so the port cannot import it from
    there. Returns (rows [(n >> shift) + 2, width] int32, 2^shift =
    ckpt_block of 64 (width 16) or 128 (width 24), super_base [n_super, 6 +
    super_shift] int64 or None). For n >= 2^31, or an explicit super_shift,
    the occ columns are relative to their 2^super_shift-position superblock
    and super_base holds the absolute occ at each superblock start;
    otherwise rows are absolute."""
    if ckpt_block not in CKPT_WIDTH:
        raise ValueError("ckpt_block must be 64 or 128")
    shift = ckpt_block.bit_length() - 1
    if super_shift is None:
        super_shift = SUPER_SHIFT if idx.n >= 2**31 else 0
    ss = super_shift
    if idx.n >= 2**31 and (not ss or ss > 31):
        raise ValueError("n >= 2^31 requires a two-level layout with "
                         "super_shift <= 31 (int32 relative counts)")
    if ss and ss < shift:
        raise ValueError("super_shift must be >= the bucket shift")
    nwords = ckpt_block // 8                 # 4-bit codes, 8 per int32
    width = CKPT_WIDTH[ckpt_block]           # 6 + nwords, padded to x8
    n_buckets = (int(idx.n) >> shift) + 2
    chunk = max(ckpt_block, chunk - chunk % ckpt_block)  # bucket-aligned
    row = np.zeros((n_buckets, width), dtype=np.int32)
    super_base = None
    if ss:
        n_super = (((n_buckets - 1) << shift) >> ss) + 1
        super_base = np.zeros((n_super, 6 + ss), dtype=np.int64)
    run_end = idx.run_start + idx.run_len
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, None, :]
    running = np.zeros(6, dtype=np.int64)
    filled = 0
    for p0 in range(0, int(idx.n), chunk):
        p1 = min(p0 + chunk, int(idx.n))
        j0 = max(int(np.searchsorted(idx.run_start, p0, side="right")) - 1, 0)
        j1 = int(np.searchsorted(idx.run_start, p1, side="left"))
        seg = (np.minimum(run_end[j0:j1], p1)
               - np.maximum(idx.run_start[j0:j1], p0))
        codes = np.repeat(idx.run_sym[j0:j1], seg)
        b0 = p0 >> shift
        nb = (p1 - p0 + ckpt_block - 1) >> shift
        padded = np.full(nb * ckpt_block, 15, dtype=np.uint8)
        padded[: p1 - p0] = codes
        nib = padded.reshape(nb, nwords, 8).astype(np.uint32)
        row[b0 : b0 + nb, 6 : 6 + nwords] = (
            (nib << shifts).sum(axis=2, dtype=np.uint32).view(np.int32))
        key = (np.arange(p1 - p0, dtype=np.int32) >> shift) * 6 \
            + codes.astype(np.int32)
        counts = np.bincount(key, minlength=nb * 6).reshape(nb, 6)
        cum_local = np.zeros((nb, 6), dtype=np.int64)
        np.cumsum(counts[:-1], axis=0, out=cum_local[1:])
        abs_rows = running[None, :] + cum_local
        if ss:
            sb_lo = (p0 + (1 << ss) - 1) >> ss
            sb_hi = (p1 - 1) >> ss
            for sb in range(sb_lo, sb_hi + 1):
                super_base[sb, :6] = abs_rows[((sb << ss) >> shift) - b0]
            sbv = ((b0 + np.arange(nb, dtype=np.int64)) << shift) >> ss
            abs_rows = abs_rows - super_base[sbv, :6]
        row[b0 : b0 + nb, :6] = abs_rows
        running += counts.sum(axis=0)
        filled = b0 + nb
    # buckets at/past n: checkpoint = totals, payload = all-0xF pad nibbles
    if ss:
        tail = np.arange(filled, n_buckets, dtype=np.int64)
        sbv = (tail << shift) >> ss
        first_unset = ((int(idx.n) - 1) >> ss) + 1 if idx.n else 0
        super_base[first_unset:, :6] = running[None, :]
        row[filled:, :6] = running[None, :] - super_base[sbv, :6]
    else:
        row[filled:, :6] = running[None, :]
    row[filled:, 6 : 6 + nwords] = -1  # 0xFFFFFFFF: all-0xF nibbles
    return row, super_base


def split_ckpt_rows(rows: torch.Tensor) -> torch.Tensor:
    """128-position checkpoint rows [R, 24] (ckpt_block=128: six occ counts,
    128 four-bit codes in words 6..21) -> the 64-position rows [2R, 16] of
    the same positions: row 2i keeps row i's counts and its first 64 codes,
    row 2i + 1 takes its last 64 codes and its counts plus those of each code
    among the first 64 (the 0xF fillers past n count for none). The counts
    of two-level rows stay relative to the superblock of their 128
    positions, which holds both halves (superblocks are at least 2^7
    positions)."""
    dev = rows.device
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=dev)
    nib = ((rows[:, 6:14, None] >> shifts) & 0xF).reshape(-1, 64)
    first = torch.stack([(nib == c).sum(dim=1) for c in range(6)], dim=1)
    out = torch.zeros((2 * rows.shape[0], 16), dtype=torch.int32, device=dev)
    out[0::2, :14] = rows[:, :14]
    out[1::2, :6] = rows[:, :6] + first.to(torch.int32)
    out[1::2, 6:14] = rows[:, 14:22]
    return out


def derive_rank_planes(ckpt: torch.Tensor, chunk_rows: int = 1 << 16) -> torch.Tensor:
    """The kernels' checkpoint table, derived from `ckpt` on its device.

    `ckpt` rows (six occ bases, 64 four-bit codes: the layout shared with
    the JAX package; 128-position rows of 24 words are read as two such
    rows each, split_ckpt_rows) become rows of the same 64 bytes laid out
    for 64-bit popcounts (csrc/rank.cuh:CkptRank), with q = COMP_CODE[code]:
      words 0..5   three 64-bit planes of q (lo word, hi word; bit i =
                   position i of the row), q = 7 for the 0xF fillers past n
      words 6..15  the pairs (S[1], S[2]), (S[2], S[3]), (S[3], S[4]),
                   (S[4], S[5]), (S[5], S[6]), S[j] = positions before the
                   row with q < j (overlapping, so that S[q] and S[q + 1]
                   are one aligned 8-byte load)
    So the kernels read 64-position rows whatever the block of `ckpt`.
    Two-level rows (n >= 2^31) keep the same form: their S[j] count from
    the superblock start and fit int32; derive_super_S gives the bases."""
    if ckpt.dim() != 2 or ckpt.shape[1] not in CKPT_WIDTH.values():
        raise ValueError(f"checkpoint rows must be [rows, 16] or [rows, 24], not "
                         f"{list(ckpt.shape)}")
    halves = 2 if ckpt.shape[1] == CKPT_WIDTH[128] else 1
    dev = ckpt.device
    comp = torch.as_tensor(COMP_CODE.astype(np.int64), device=dev)
    q_of_nibble = torch.full((16,), 7, dtype=torch.int64, device=dev)
    q_of_nibble[:6] = comp
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=dev)
    bit = torch.ones(64, dtype=torch.int64, device=dev) \
        << torch.arange(64, dtype=torch.int64, device=dev)
    out = torch.zeros((halves * ckpt.shape[0], 16), dtype=torch.int32, device=dev)
    for r0 in range(0, ckpt.shape[0], chunk_rows):
        rows = ckpt[r0 : r0 + chunk_rows]
        if halves == 2:
            rows = split_ckpt_rows(rows)
        o0 = halves * r0
        nib = ((rows[:, 6:14, None] >> shifts) & 0xF).reshape(-1, 64)  # LSB first
        q = q_of_nibble[nib.long()]
        planes = torch.stack([(((q >> b) & 1) * bit).sum(dim=1)
                              for b in range(3)], dim=1)
        out[o0 : o0 + rows.shape[0], :6] = planes.view(torch.int32)
        below = torch.cumsum(rows[:, :6].long()[:, comp], dim=1)   # S[1..6]
        pairs = torch.stack((below[:, :5], below[:, 1:]), dim=2)
        out[o0 : o0 + rows.shape[0], 6:] = pairs.reshape(-1, 10).to(torch.int32)
    return out


def derive_super_S(ckpt_super: torch.Tensor) -> torch.Tensor:
    """The kernels' superblock bases, derived from `ckpt_super` [n_super,
    6 + shift] (absolute occ of each code at each superblock start) on its
    device: [n_super, 8] int64, S[0..6] comp-permuted as the rows' pairs
    (S[j] = positions before the superblock with q = COMP_CODE[code] < j)
    and S[6] again as a pad."""
    comp = torch.as_tensor(COMP_CODE.astype(np.int64), device=ckpt_super.device)
    out = torch.zeros((ckpt_super.shape[0], 8), dtype=torch.int64,
                      device=ckpt_super.device)
    out[:, 1:7] = torch.cumsum(ckpt_super[:, :6].long()[:, comp], dim=1)
    out[:, 7] = out[:, 6]
    return out


def with_rank_planes(t: "RIndexTables") -> "RIndexTables":
    """The kernels' forms of the checkpoint rows, derived on their device:
    ckpt_planes, and for int64 positions super_S (returns t)."""
    if t.ckpt is not None:
        t.ckpt_planes = derive_rank_planes(t.ckpt)
        if t.pos_dtype == torch.int64:
            t.super_S = (derive_super_S(t.ckpt_super) if t.ckpt_super is not None
                         else torch.zeros((1, 8), dtype=torch.int64, device=t.device))
    return t


def node_keys(dtype: torch.dtype) -> int:
    """Keys of a search-tree node of `dtype` keys: one 64-byte line (16
    int32 keys, 8 int64 keys); a node has one child more."""
    return 64 * 8 // torch.iinfo(dtype).bits


def derive_search_tree(heads: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """The static search tree over the sorted run heads `heads` [t], derived
    on their device: (lines [rows, K] of the heads' dtype, the first line
    of each level), K = node_keys(dtype): 16 for int32 heads, 8 for int64.

    A node is one 64-byte line of K keys with F = K + 1 children. The leaf
    level is `heads` itself read as lines of K (the last may be short); node
    j of height h covers the leaf lines [j * F^h, (j + 1) * F^h), and its key
    i is the first head of the leaf line where its child i + 1 begins, or the
    dtype's maximum where the heads end before it. The tensor holds the
    internal levels, root first, then one more line: the last leaf line
    padded to K keys with the maximum. levels[d] is the first line of level
    d, and levels[depth] that padded line. With c = the keys of a node that
    are <= v, the descent goes to child F * j + c, and the number of heads
    <= v is K * (leaf line) + the keys of that line that are <= v
    (ops/tagquery.py:tag_upper_bound_plain, csrc/tags.cuh:upper_bound_quad).
    A head equal to the dtype's maximum could not be told from the padding
    and is refused (heads are BWT offsets or packed text positions, below
    it wherever the kernels take them)."""
    t = heads.shape[0]
    dev = heads.device
    keys_n = node_keys(heads.dtype)
    fan = keys_n + 1
    big = torch.iinfo(heads.dtype).max
    if t and int(heads[-1]) == big:
        raise ValueError("a head of the search tree equals the dtype's maximum")
    n_lines = max(1, -(-t // keys_n))
    depth = 0
    while fan ** depth < n_lines:
        depth += 1
    child = torch.arange(1, fan, device=dev)
    parts, levels, at = [], [], 0
    for h in range(depth, 0, -1):
        n_nodes = -(-n_lines // fan ** h)
        line = (torch.arange(n_nodes, device=dev)[:, None] * fan ** h
                + child[None, :] * fan ** (h - 1))
        keys = torch.full((n_nodes, keys_n), big, dtype=heads.dtype, device=dev)
        there = line < n_lines
        keys[there] = heads[line[there] * keys_n]
        parts.append(keys)
        levels.append(at)
        at += n_nodes
    last = torch.full((1, keys_n), big, dtype=heads.dtype, device=dev)
    tail = heads[(n_lines - 1) * keys_n :]
    last[0, : tail.shape[0]] = tail
    parts.append(last)
    levels.append(at)
    return torch.cat(parts), tuple(levels)


def tree_upper_bound_plain(tree: torch.Tensor, levels: tuple[int, ...],
                           heads: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Number of heads <= v[i] (searchsorted side="right"), found by walking
    the search tree (tree, levels) = derive_search_tree(heads) with torch
    indexing: one line of keys a level, the child chosen by the count of
    keys <= v. [B] int64."""
    t = heads.shape[0]
    if t == 0:
        return torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    keys_n = node_keys(tree.dtype)
    fan = keys_n + 1
    big = torch.iinfo(tree.dtype).max
    key = v.to(tree.dtype).clamp(max=big - 1)[:, None]   # the padding never counts
    node = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    for first in levels[:-1]:
        node = node * fan + (tree[first + node] <= key).sum(dim=1)
    slots = node[:, None] * keys_n + torch.arange(keys_n, device=v.device)
    # the last leaf line is read from the tree, where it is padded
    leaf = torch.where((node == (t - 1) // keys_n)[:, None], tree[levels[-1]][None, :],
                       heads[slots.clamp(max=t - 1)])
    return node * keys_n + (leaf <= key).sum(dim=1)


def derive_tail_index(last_sorted: torch.Tensor, samples: torch.Tensor,
                      last_to_run: torch.Tensor,
                      value_range: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """What locate_next reads, derived on the tables' device: (tail_pairs,
    tail_lo, tail_shift).

    locate_next(prev) = samples[last_to_run[i] + 1] + (prev - last_sorted[i])
    with i the last tail <= prev (-1 wrapping to r - 1) is prev + delta[i],
    delta[i] = samples[last_to_run[i] + 1] - last_sorted[i] a constant of
    the tail (in the position dtype, wrapping as its sums do; the sample
    index clamped into `samples`, as the JAX gather clamps it on the one-row
    stubs). tail_pairs [r, 2] holds (last_sorted[i], delta[i]): one 16-byte
    pair at int64, 8 at int32. Buckets of 2^tail_shift packed values cover
    [0, value_range) (n_seq * max_len: every SA value lies below it), with
    tail_shift = floor(log2(value_range / r)): about one tail a bucket, and
    never fewer buckets than tails; tail_lo [nb + 1] int32 holds the first
    tail >= b << tail_shift of each bucket b < nb and r at nb, so that the
    last bucket also holds the tails past the range (the sentinels of padded
    tables). The predecessor of prev is then tail_lo[b] - 1 plus the tails of
    bucket b <= prev, b = prev >> tail_shift clamped into [0, nb - 1]
    (tail_next_plain; csrc/locate.cu). last_sorted must be sorted."""
    r = last_sorted.shape[0]
    dev = last_sorted.device
    run = (last_to_run.long() + 1).clamp(0, samples.shape[0] - 1)
    pairs = torch.stack((last_sorted, samples[run] - last_sorted), dim=1).contiguous()
    value_range = max(int(value_range), 1)
    shift = max(value_range // max(r, 1), 1).bit_length() - 1
    nb = -(-value_range >> shift)
    bounds = torch.arange(nb, dtype=torch.int64, device=dev) << shift
    lo = torch.searchsorted(last_sorted.long(), bounds)
    tail_lo = torch.cat((lo, torch.tensor([r], device=dev))).to(torch.int32)
    return pairs, tail_lo, shift


def tail_bucket(t: RIndexTables, prev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, m) [B] int64 of each prev's bucket: its first tail and its
    number of tails (0 where the bucket index is not monotone, as on
    unsorted tails)."""
    nb = t.tail_lo.shape[0] - 1
    b = (prev.long() >> t.tail_shift).clamp(0, nb - 1)
    lo, hi = t.tail_lo[b].long(), t.tail_lo[b + 1].long()
    return lo, (hi - lo).clamp(min=0)


def tail_next_plain(t: RIndexTables, prev: torch.Tensor) -> torch.Tensor:
    """locate_next through the bucket index, as a step of csrc/locate.cu
    takes it: the bucket of prev, the count of its tails <= prev, i = the
    bucket's first tail - 1 + that count (-1 wrapping to r - 1), then prev +
    delta[i] in the position dtype. [B]."""
    r = t.tail_pairs.shape[0]
    prev = prev.to(t.pos_dtype)
    lo, m = tail_bucket(t, prev)
    c = torch.zeros_like(lo)
    for j in range(int(m.max()) if m.numel() else 0):
        tail = t.tail_pairs[(lo + j).clamp(max=r - 1), 0]
        c += (j < m) & (tail <= prev)
    i = lo - 1 + c
    return prev + t.tail_pairs[torch.where(i < 0, i + r, i), 1]


def with_locate_tables(t: RIndexTables) -> RIndexTables:
    """The tables with what locate reads derived on their device: the search
    tree over run_start, and the tail pairs and their bucket index over the
    packed values below n_seq * max_len (returns t)."""
    t.run_tree, t.run_tree_levels = derive_search_tree(t.run_start)
    t.tail_pairs, t.tail_lo, t.tail_shift = derive_tail_index(
        t.last_sorted, t.samples, t.last_to_run, t.n_seq * t.max_len)
    return t


def build_rank_table(idx: RIndex, dtype: torch.dtype) -> np.ndarray:
    """The ultra rank table on the host: [n+2, 8] of `dtype`, row p the
    occurrences of each code before position p (row n+1 = row n; columns
    6 and 7 zero), the values of the JAX package's
    cumsum(onehot(bwt)) build, one code's column at a time."""
    codes = np.repeat(idx.run_sym, idx.run_len)
    table = np.zeros((int(idx.n) + 2, 8),
                     dtype=np.int32 if dtype == torch.int32 else np.int64)
    for c in range(6):
        np.cumsum(codes == c, dtype=table.dtype, out=table[1 : int(idx.n) + 1, c])
    table[-1] = table[-2]
    return table


def derive_bucket_lo(run_start: torch.Tensor, n: int) -> torch.Tensor:
    """bucket_lo on run_start's device: for each bucket b < (n >>
    BUCKET_SHIFT) + 2, the last run whose head is <= b << BUCKET_SHIFT (0
    where none is), in run_start's dtype."""
    nb = (n >> BUCKET_SHIFT) + 2
    bucket_pos = torch.arange(nb, dtype=torch.int64, device=run_start.device) << BUCKET_SHIFT
    j = torch.searchsorted(run_start, bucket_pos.to(run_start.dtype), right=True) - 1
    return j.clamp(min=0).to(run_start.dtype)


def run_index_shift(span: int, runs: int) -> int:
    """The run index's bucket shift for `runs` heads over `span` positions:
    floor(log2(2 * span / runs)), so that a bucket holds one to two heads on
    average, within [0, MAX_RUN_SHIFT]."""
    return min(max((2 * max(span, 1) // max(runs, 1)).bit_length() - 1, 0), MAX_RUN_SHIFT)


def run_index_slots(shift: int) -> int:
    """Offsets an entry holds: ten of 8 bits below shift 8, else five of 16."""
    return 10 if shift < 8 else 5


def derive_run_index(run_start: torch.Tensor, shift: int, first_bucket: int,
                     n_buckets: int, j_min: int = 0) -> torch.Tensor:
    """The run index over the sorted heads run_start [r] on their device:
    [n_buckets, 4] int32, one 16-byte entry for each bucket b of 2^shift
    positions from first_bucket on (base B = b << shift):
      bytes 0..4   j0, the last run whose head is <= B (at least j_min: 0
                   over a whole table, as JAX's bucket_lo clamps it; -1 in
                   a model shard whose heads all lie past B), a signed
                   40-bit value
      byte  5      the number of heads of the runs after j0 that start in
                   the bucket (each > B), saturated at 255
      bytes 6..15  the first of those heads' offsets h - B, ascending:
                   run_index_slots(shift) of them, 8 bits each below shift
                   8, else 16; unused slots all ones (above every offset
                   within a bucket, so they never count)
    The run of a position p of bucket b is j0 + the stored offsets <= p - B,
    exact unless the bucket holds more heads than its entry: then the heads
    after the stored ones are counted from run_start (run_of_index;
    csrc/rank.cuh:RunIndex). A bucket index is clamped into the table and
    p - B into [0, 2^shift - 1], so positions past the last bucket find the
    last run whose head is <= p."""
    if not 0 <= shift <= MAX_RUN_SHIFT:
        raise ValueError(f"run index shift {shift} outside 0..{MAX_RUN_SHIFT}")
    dev = run_start.device
    heads = run_start.long()
    r = heads.shape[0]
    base = (first_bucket + torch.arange(n_buckets, dtype=torch.int64, device=dev)) << shift
    j0 = (torch.searchsorted(heads, base, right=True) - 1).clamp(min=j_min)
    end = torch.searchsorted(heads, base + (1 << shift))
    cnt = (end - 1 - j0).clamp(min=0)
    slots = run_index_slots(shift)
    k = torch.arange(slots, device=dev)
    at = (j0[:, None] + 1 + k).clamp(0, max(r - 1, 0))
    pad = 0xFF if slots == 10 else 0xFFFF
    off = torch.where(k < cnt[:, None], heads[at] - base[:, None], pad) if r else \
        torch.full((n_buckets, slots), pad, dtype=torch.int64, device=dev)
    out = torch.empty((n_buckets, 16), dtype=torch.uint8, device=dev)
    for i in range(5):
        out[:, i] = ((j0 >> (8 * i)) & 0xFF).to(torch.uint8)
    out[:, 5] = cnt.clamp(max=255).to(torch.uint8)
    if slots == 10:
        out[:, 6:] = off.to(torch.uint8)
    else:
        out[:, 6::2] = (off & 0xFF).to(torch.uint8)
        out[:, 7::2] = (off >> 8).to(torch.uint8)
    return out.view(torch.int32)


def run_index_fields(entries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(j0, head count) [B] int64 of run index entries [B, 4] int32 (j0 the
    signed 40-bit value of bytes 0..4, the count byte 5)."""
    w1 = entries[:, 1].long()
    j0 = (entries[:, 0].long() & 0xFFFFFFFF) | ((((w1 & 0xFF) ^ 0x80) - 0x80) << 32)
    return j0, (w1 >> 8) & 0xFF


def slice_run_index(index: torch.Tensor, first: int, last: int, j_lo: int) -> torch.Tensor:
    """Entries first..last of a run index, their run ids rebased by -j_lo
    (a model shard of runs j_lo.. over the buckets of its heads): j0 may
    turn negative where a bucket starts in an earlier shard's run, and its
    offsets keep the earlier shard's heads, which lie below every position
    the shard owns (the lookups count run ids below 0 as heads <= p)."""
    e = index[first : last + 1]
    j0 = run_index_fields(e)[0] - j_lo
    out = e.clone()
    out[:, 0] = (((j0 & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)
    out[:, 1] = ((e[:, 1].long() & ~0xFF) | ((j0 >> 32) & 0xFF)).to(torch.int32)
    return out


def derive_run_records(run_start: torch.Tensor, run_sym: torch.Tensor,
                       cum: torch.Tensor) -> torch.Tensor:
    """The run records [r, 8] of run_start's dtype: (start, sym,
    cum0..cum5), the layout of the dense records' `rec` (32 bytes a run at
    int32, 64 at int64, aligned; no tables hold both `rec` and bucket_lo,
    so the bucketed tables derive their own)."""
    return torch.cat((run_start[:, None], run_sym.to(run_start.dtype)[:, None],
                      cum.to(run_start.dtype)), dim=1).contiguous()


#: positions a dense line covers
DENSE_LINE = 64
#: dense lines derived at a time, which bounds the derivation's int64
#: temporaries (a few KB a line)
DENSE_CHUNK_LINES = 1 << 16


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 values as int32 (two's complement)."""
    return (((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def derive_dense_lines(pos_to_run: torch.Tensor) -> torch.Tensor:
    """The lines the kernels find a position's run through, on pos_to_run's
    device: [ceil(m / 64), 4] int32 for the m = n + 2 entries of pos_to_run
    (the two pads included), one aligned 16-byte line for each 64 positions
    from B = 64 i:
      word 0      j0 = pos_to_run[B]
      words 1, 2  a 64-bit mask (low word first) whose bit k, 1 <= k <= 63,
                  is set where pos_to_run[B + k] != pos_to_run[B + k - 1]
                  (bit 0 and the bits past the last position are clear)
      word 3      0 (spare)
    so that pos_to_run[p] = j0 + popcount(mask & ((2 << (p & 63)) - 1))
    (dense_run_of_plain; csrc/rank.cuh:DenseRank). Raises ValueError where a
    step of pos_to_run is neither 0 nor 1 (the dense tables' construction,
    a run id repeated over each run's positions, never makes one) or a run
    id does not fit 32 bits."""
    dev = pos_to_run.device
    m = pos_to_run.shape[0]
    n_lines = -(-m // DENSE_LINE)
    out = torch.zeros((n_lines, 4), dtype=torch.int32, device=dev)
    bit = torch.arange(32, dtype=torch.int64, device=dev)
    for a in range(0, n_lines, DENSE_CHUNK_LINES):
        b = min(a + DENSE_CHUNK_LINES, n_lines)
        lo, hi = DENSE_LINE * a, min(DENSE_LINE * b, m)
        # the steps into and inside this chunk
        x = pos_to_run[max(lo - 1, 0):hi].long()
        step = x[1:] - x[:-1]
        if bool(((step != 0) & (step != 1)).any()):
            raise ValueError("pos_to_run steps by other than 0 or 1: not the run of "
                             "each position")
        if not (-2**31 <= int(x[0]) and int(x[-1]) < 2**31):  # x is nondecreasing
            raise ValueError("pos_to_run holds a run id past 32 bits")
        seg = x[lo - max(lo - 1, 0):]
        # the last line repeats the last entry: no head past it
        seg = torch.cat((seg, seg[-1:].expand(DENSE_LINE * (b - a) - seg.shape[0])))
        seg = seg.view(b - a, DENSE_LINE)
        head = torch.zeros(seg.shape, dtype=torch.int64, device=dev)
        head[:, 1:] = (seg[:, 1:] != seg[:, :-1]).long()
        out[a:b, 0] = seg[:, 0].to(torch.int32)
        out[a:b, 1] = _wrap32((head[:, :32] << bit).sum(dim=1))
        out[a:b, 2] = _wrap32((head[:, 32:] << bit).sum(dim=1))
    return out


def with_dense_lines(t: "RIndexTables") -> "RIndexTables":
    """The dense tables' lines (derive_dense_lines), derived on their device
    at either position dtype (returns t; other tables are left as they
    are)."""
    if t.pos_to_run is not None:
        t.dense_lines = derive_dense_lines(t.pos_to_run)
    return t


def with_run_index(t: "RIndexTables") -> "RIndexTables":
    """The bucketed tables' run index and records, derived on their device
    (returns t; tables without bucket_lo are left as they are). The index's
    buckets cover positions 0..n + 1 (a padded table's sentinel heads at
    n + 1 fall into the last one)."""
    if t.bucket_lo is not None:
        r = t.run_start.shape[0]
        t.run_shift = run_index_shift(t.n, r)
        t.run_index = derive_run_index(t.run_start, t.run_shift, 0,
                                       ((t.n + 1) >> t.run_shift) + 1)
        t.run_rec = derive_run_records(t.run_start, t.run_sym, t.cum)
    return t


#: runs whose positions dense_pos_to_run fills at a time, which bounds its
#: temporaries on the device (their positions, 8 bytes each at int64)
DENSE_CHUNK_RUNS = 1 << 16


def dense_pos_to_run(idx: RIndex, dtype: torch.dtype, device) -> torch.Tensor:
    """pos_to_run [n + 2] of `dtype` on `device`: each run's id over its
    positions, then two pads of the last run (the JAX package's np.repeat
    and concatenate), filled on the device DENSE_CHUNK_RUNS runs at a time
    from the run lengths, so that the host holds no n-sized array (17 GB of
    int64 at n = 2.16 G)."""
    device = torch.device(device)
    n, r = int(idx.n), int(idx.n_runs)
    out = torch.empty(n + 2, dtype=dtype, device=device)
    lens = np.ascontiguousarray(idx.run_len, dtype=np.int64)
    at = 0
    for j0 in range(0, r, DENSE_CHUNK_RUNS):
        j1 = min(j0 + DENSE_CHUNK_RUNS, r)
        span = int(lens[j0:j1].sum())
        out[at : at + span] = torch.repeat_interleave(
            torch.arange(j0, j1, dtype=dtype, device=device),
            torch.from_numpy(lens[j0:j1]).to(device), output_size=span)
        at += span
    if at != n:
        raise ValueError(f"the run lengths sum to {at}, not n = {n}")
    out[n:] = r - 1
    return out


def rindex_to_device(idx: RIndex, device, checkpoint: bool = False,
                     dense: bool = False, ultra: bool = False,
                     bucketed: bool = False, ckpt_block: int = CKPT_BLOCK,
                     super_shift: int | None = None, mem_only: bool = False,
                     dtype: torch.dtype | None = None) -> RIndexTables:
    """r-index -> tables on `device` with checkpoint rows, dense records,
    ultra rows, or any of them together (rank reads the checkpoint rows
    first, then the ultra rows, then the dense records, as in the JAX
    package); with none of them, bucketed=True gives the bucketed tables
    (bucket_lo beside the full per-run cum table), and bucketed=False base
    tables that rank through the cum table by a search over run_start
    (plain PyTorch only: the kernels refuse them). Same fields and values
    as the JAX rindex_to_device with the same flags (whose bucketed is True
    by default: here False, base tables), what locate reads
    (with_locate_tables), for bucketed tables the run index and records
    the kernels rank through (with_run_index), and for dense tables the
    lines the kernels find a position's run through (with_dense_lines), at
    either position dtype.

    Positions are `dtype`, by default int32 where every value fits and int64
    past 2^31; checkpoint rows hold ckpt_block (64 or 128) positions and are
    two-level at n >= 2^31 or with an explicit super_shift (the kernels take
    two-level rows with int64 positions). mem_only (with checkpoint, as in
    the JAX package) ships one-row stubs of the per-run and locate tables
    (run_sym, run_start, last_sorted, last_to_run, samples; cum is a stub
    beside any row table): MEM finding and counting read only the rank
    tables, C and n; locate needs the full tables."""
    if mem_only and not checkpoint:
        raise ValueError("mem_only requires checkpoint mode")
    device = torch.device(device)
    pd = dtype or pos_dtype_for(idx)
    ckpt = ckpt_super = pos_to_run = rec = rank_table = None
    if checkpoint:
        rows, sup = build_ckpt_rows(idx, ckpt_block, super_shift=super_shift)
        ckpt = _put(rows, torch.int32, device)
        if sup is not None:
            ckpt_super = _put(sup, torch.int64, device)
    if ultra:
        rank_table = torch.from_numpy(build_rank_table(idx, pd)).to(device)
    if dense:
        pos_to_run = dense_pos_to_run(idx, pd, device)
        rec_np = np.zeros((idx.n_runs, 8), dtype=np.int64)
        rec_np[:, 0] = idx.run_start
        rec_np[:, 1] = idx.run_sym
        rec_np[:, 2:8] = idx.cum
        rec = _put(rec_np, pd, device)
    row_table = checkpoint or dense or ultra
    keep = slice(0, 1) if mem_only else slice(None)
    run_start = _put(idx.run_start[keep], pd, device)
    return with_dense_lines(with_run_index(with_locate_tables(with_rank_planes(RIndexTables(
        run_sym=_put(idx.run_sym[keep], torch.int8, device),
        run_start=run_start,
        # only the run-based modes rank through the per-run cum table;
        # beside a row rank table it ships a 1-row stub, as in the JAX package
        cum=_put(idx.cum[:1] if row_table else idx.cum, pd, device),
        C=_put(idx.C, pd, device),
        samples=_put(np.concatenate((idx.samples, [0]))[keep], pd, device),
        last_sorted=_put(idx.last_sorted[keep], pd, device),
        last_to_run=_put(idx.last_to_run[keep], pd, device),
        n=int(idx.n), n_seq=int(idx.n_seq), max_len=int(idx.max_len),
        bucket_lo=(derive_bucket_lo(run_start, int(idx.n))
                   if bucketed and not row_table else None),
        pos_to_run=pos_to_run, rec=rec, rank_table=rank_table, ckpt=ckpt,
        ckpt_super=ckpt_super)))))


def tags_to_device(tags: TagArray, device,
                   dtype: torch.dtype | None = None) -> TagTables:
    """Tag array -> tables on `device`, with the search tree over the run
    heads; run heads `dtype`, by default int32 below 2^31 rows and int64
    past it."""
    device = torch.device(device)
    pd = dtype or _pick_dtype(tags.total)
    heads = _put(tags.bwt_start, pd, device)
    tree, levels = derive_search_tree(heads)
    return TagTables(pos_enc=_put(tags.pos_enc, torch.int64, device),
                     bwt_start=heads, total=int(tags.total),
                     search_tree=tree, tree_levels=levels)


def tables_from_numpy(rindex: dict[str, np.ndarray],
                      tags: dict[str, np.ndarray] | None, device):
    """The JAX package's RIndexTables / TagTables fields, each as a numpy
    array (None or absent: None), -> (RIndexTables, TagTables or None) on
    `device`, with the same dtypes and values, and what the port derives
    beside them: the search trees (over the tag run heads; over run_start),
    the tail pairs and their bucket index, the bit-plane rows and, for int64
    positions, the superblock bases (two-level rows included), and beside
    bucket_lo the run index and records, beside int32 pos_to_run its lines."""
    device = torch.device(device)

    def put(a):  # np.array copies: arrays from JAX are read-only
        return None if a is None else torch.from_numpy(np.array(a)).to(device)

    t = RIndexTables(
        **{f: put(rindex.get(f)) for f in (
            "run_sym", "run_start", "cum", "C", "samples", "last_sorted",
            "last_to_run", "bucket_lo", "pos_to_run", "rec", "rank_table",
            "ckpt", "ckpt_super")},
        n=int(rindex["n"]), n_seq=int(rindex["n_seq"]),
        max_len=int(rindex["max_len"]))
    if t.ckpt_super is not None:
        t.ckpt_super = t.ckpt_super.to(torch.int64)
    with_dense_lines(with_run_index(with_locate_tables(with_rank_planes(t))))
    tt = None
    if tags is not None:
        heads = put(tags["bwt_start"])
        tree, levels = derive_search_tree(heads)
        tt = TagTables(pos_enc=put(tags["pos_enc"]).to(torch.int64),
                       bwt_start=heads, total=int(tags["total"]),
                       search_tree=tree, tree_levels=levels)
    return t, tt
