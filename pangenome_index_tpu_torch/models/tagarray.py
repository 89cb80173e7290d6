"""Host-side tag-array model: flat arrays and the interval query.

The port's copy of pangenome_index_tpu/models/tagarray.py. The tag array
maps every BWT position to the pangenome graph position that produced it,
run-length compressed, as two flat arrays:

    pos_enc[t]   i64  compact packed graph position per run:
                      (node_id << 11) | (is_rev << 10) | node_offset
    bwt_start[t] i64  BWT offset of each run head

The interval query is two searchsorteds, a slice and a unique.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LENGTH_BITS = 9
MAX_TAG_LEN = 1 << LENGTH_BITS
START_EVERY_K = 10       # the reference samples every 10th run start


def encode_compact(node_id, is_rev, offset):
    """(node_id, is_rev, offset) -> the compact packed graph position."""
    return ((np.asarray(node_id, dtype=np.int64) << 11)
            | (np.asarray(is_rev, dtype=np.int64) << 10)
            | (np.asarray(offset, dtype=np.int64) & 0x3FF))


def decode_compact(enc):
    """The compact packed graph position -> (node_id, is_rev, offset)."""
    enc = np.asarray(enc, dtype=np.int64)
    return enc >> 11, (enc >> 10) & 1, enc & 0x3FF


def split_long_runs(pos_enc: np.ndarray, lengths: np.ndarray):
    """Split runs >= MAX_TAG_LEN as the reference writers do: a run of length
    l becomes l // 511 pieces of 511 plus an l % 511 remainder piece."""
    pos_enc = np.asarray(pos_enc, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    cap = MAX_TAG_LEN - 1
    if not len(lengths) or int(lengths.max(initial=0)) < MAX_TAG_LEN:
        return pos_enc, lengths
    q, rem = np.divmod(lengths, cap)
    pieces = q + (rem > 0)
    pos_out = np.repeat(pos_enc, pieces)
    len_out = np.full(int(pieces.sum()), cap, dtype=np.int64)
    last = np.cumsum(pieces) - 1
    len_out[last] = np.where(rem > 0, rem, cap)
    return pos_out, len_out


@dataclass
class TagArray:
    pos_enc: np.ndarray    # int64 [t]
    bwt_start: np.ndarray  # int64 [t]
    total: int             # total BWT length covered

    @property
    def n_runs(self) -> int:
        return len(self.pos_enc)

    def run_lengths(self) -> np.ndarray:
        return np.diff(np.concatenate((self.bwt_start, [self.total])))

    @classmethod
    def from_runs(cls, pos_enc, lengths) -> "TagArray":
        pos_enc, lengths = split_long_runs(np.asarray(pos_enc, np.int64),
                                           np.asarray(lengths, np.int64))
        starts = np.zeros(len(lengths), dtype=np.int64)
        np.cumsum(lengths[:-1], out=starts[1:])
        return cls(pos_enc=pos_enc, bwt_start=starts, total=int(lengths.sum()))

    # ------------------------------------------------------------------ query
    def query_runs(self, start: int, end: int) -> tuple[int, int]:
        """Run-index range decoded by the reference's compact query.

        first_bit = #run-starts <= start; the decode begins at run
        first_bit - 1 except when first_bit is a multiple of START_EVERY_K,
        where the reference's skip loop starts one run late. That off-by-one
        is reproduced for output parity."""
        first_bit = int(np.searchsorted(self.bwt_start, start, side="right"))
        end_bit = int(np.searchsorted(self.bwt_start, end, side="right"))
        run_nums = end_bit - first_bit + 1
        s = first_bit if (first_bit % START_EVERY_K == 0) else first_bit - 1
        return s, run_nums

    def query(self, start: int, end: int):
        """Returns (unique sorted packed positions, number_of_runs reported)."""
        s, run_nums = self.query_runs(start, end)
        lo = max(s, 0)
        hi = min(s + run_nums, self.n_runs)
        vals = np.unique(self.pos_enc[lo:hi])
        return vals, run_nums
