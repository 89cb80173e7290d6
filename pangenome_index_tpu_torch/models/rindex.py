"""Host-side r-index model: flat per-run tables and numpy queries.

The port's copy of pangenome_index_tpu/models/rindex.py, cut to what the
port uses: the RIndex tables with rank, LF, count, locate and FMD
extension, and construction from a run-length BWT, either by the native psi
walk (build_rindex, the build-rindex and build-tags commands; keep_sa=True
keeps the per-row suffix array the tag build gathers through) or from a
known suffix array (build_rindex_from_sa, the path utils/synth.py takes).
Same fields, dtypes and values as the JAX package's RIndex, so either
package's index serves the other's functions.

    run_sym[r]     int8  dense code of each logical run
    run_start[r]   i64   BWT offset of the run head
    cum[r, 6]      i64   occ counts of every code before the run head
    C[7]           i64   exclusive prefix counts per code over the whole BWT
    samples[r]     i64   packed (seq_id, seq_offset) SA sample at each run head
    last_sorted[r] i64   sorted packed text positions of run tails
    last_to_run[r] i64   run id of each sorted tail

Every endmarker occurrence is its own logical run; samples are packed as
seq_id * max_len + offset.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..formats.rlbwt import RLBWT
from ..utils.alphabet import (BYTE_TO_CODE, COMP_CODE, KP_WEIGHT, NUC, SIGMA)


@dataclass
class RIndex:
    run_sym: np.ndarray      # int8 [r]
    run_start: np.ndarray    # int64 [r]
    run_len: np.ndarray      # int64 [r]
    cum: np.ndarray          # int64 [r, 6]
    C: np.ndarray            # int64 [7]
    n: int                   # BWT size (total text length incl endmarkers)
    n_seq: int
    max_len: int             # longest sequence length incl endmarker
    samples: np.ndarray      # int64 [r]
    last_sorted: np.ndarray  # int64 [r]
    last_to_run: np.ndarray  # int64 [r]
    # full SA (kept when built with keep_sa=True): per BWT row, the sequence
    # id and the suffix start offset within that sequence
    sa_seq: np.ndarray | None = None
    sa_pos: np.ndarray | None = None
    seq_lengths: np.ndarray | None = None

    @property
    def n_runs(self) -> int:
        return len(self.run_sym)

    # --------------------------------------------------------------- rank
    def run_of(self, pos):
        """Run id containing BWT position pos (pos == n maps to last run)."""
        return np.searchsorted(self.run_start, pos, side="right") - 1

    def rank(self, pos, code):
        """occ(code, [0, pos))."""
        j = self.run_of(pos)
        extra = np.where(self.run_sym[j] == code, pos - self.run_start[j], 0)
        return self.cum[j, code] + extra

    def rank6(self, pos):
        """All-symbol rank vector at pos."""
        pos = np.asarray(pos)
        j = self.run_of(pos)
        out = self.cum[j].copy()
        sym = self.run_sym[j]
        out[..., :] += (np.arange(SIGMA) == sym[..., None]) \
            * (pos - self.run_start[j])[..., None]
        return out

    # ----------------------------------------------------------------- LF
    def lf_range(self, first, second, code):
        """LF mapping of a range for one symbol; the empty sentinel (1, 0)
        when the symbol is the endmarker/unknown (code 0) or the range is or
        becomes empty."""
        if code == 0 or first > second:
            return (1, 0)
        lo = int(self.rank(first, code))
        inside = int(self.rank(second + 1, code)) - lo
        if inside == 0:
            return (1, 0)
        start = lo + int(self.C[code])
        return (start, start + inside - 1)

    def count(self, pattern: bytes):
        """Backward search; returns the BWT range."""
        rng = (0, self.n - 1)
        for b in reversed(pattern):
            rng = self.lf_range(rng[0], rng[1], int(BYTE_TO_CODE[b]))
        return rng

    # -------------------------------------------------------------- locate
    def locate_first(self) -> int:
        return int(self.samples[0])

    def locate_next(self, prev):
        idx = np.searchsorted(self.last_sorted, prev, side="right") - 1
        run = self.last_to_run[idx] + 1
        return self.samples[run] + (prev - self.last_sorted[idx])

    def decompress_sa(self) -> np.ndarray:
        """SA in packed coords for every row (r-index.cpp:1345-1356 chains
        locateNext row by row; here lanes = runs and each lane walks its own
        run via locateNext, so the wall time is max run length batches of
        vectorized work, not n scalar steps)."""
        out = np.zeros(self.n, dtype=np.int64)
        cur = self.samples.copy()
        lens = self.run_len
        active = np.ones(self.n_runs, dtype=bool)
        t = 0
        while active.any():
            out[self.run_start[active] + t] = cur[active]
            t += 1
            active = active & (lens > t)
            if active.any():
                cur[active] = self.locate_next(cur[active])
        return out

    # ----------------------------------------------------------------- FMD
    def backward_extend(self, bint, code):
        """FMD backward extension of the bi-interval (k, kp, s)."""
        k, kp, s = bint
        r_ks = self.rank6(k + s)
        r_k = self.rank6(k)
        delta = r_ks - r_k
        kp = kp + int((KP_WEIGHT[code] * delta).sum())
        if r_k[code] >= r_ks[code]:
            return (0, 0, 0)
        return (int(r_k[code] + self.C[code]), int(kp), int(delta[code]))

    def forward_extend(self, bint, code):
        k, kp, s = bint
        t = self.backward_extend((kp, k, s), int(COMP_CODE[code]))
        return (t[1], t[0], t[2])


def _rindex_head(rlbwt: RLBWT):
    """The tables every build shares: the endmarker runs split into unit
    runs, C and the per-run counts. Returns (RIndex with zero samples,
    last_sorted and last_to_run and max_len 1, run_sym as int64)."""
    syms = BYTE_TO_CODE[rlbwt.syms].astype(np.int8)
    freqs = rlbwt.freqs.astype(np.int64)
    # the index is defined over the fixed 6-symbol alphabet; an unknown byte
    # would alias to the endmarker and corrupt every structure downstream
    bad = ~np.isin(rlbwt.syms, NUC)
    if bad.any():
        vals = sorted(set(int(b) for b in rlbwt.syms[bad]))[:10]
        raise ValueError(
            f"BWT contains bytes outside the {{\\n,A,C,G,N,T}} alphabet: {vals}")

    # split endmarker runs into unit runs
    is_end = syms == 0
    reps = np.where(is_end, freqs, 1)
    run_sym = np.repeat(syms, reps)
    run_len = np.where(np.repeat(is_end, reps), 1, np.repeat(freqs, reps))
    r = run_sym.size
    run_start = np.zeros(r, dtype=np.int64)
    np.cumsum(run_len[:-1], out=run_start[1:])
    n = int(run_len.sum())

    # per-code totals and exclusive prefix C over the full 6-code space
    sym = run_sym.astype(np.int64)
    totals = np.zeros(SIGMA, dtype=np.int64)
    np.add.at(totals, sym, run_len)
    C = np.zeros(SIGMA + 1, dtype=np.int64)
    np.cumsum(totals, out=C[1:])

    # per-run cumulative occ before the run head
    cum = np.zeros((r, SIGMA), dtype=np.int64)
    contrib = np.zeros((r, SIGMA), dtype=np.int64)
    contrib[np.arange(r), sym] = run_len
    np.cumsum(contrib[:-1], axis=0, out=cum[1:])

    n_seq = int(totals[0])
    if n_seq == 0:
        raise ValueError("BWT contains no endmarkers")
    zeros = np.zeros(r, dtype=np.int64)
    return RIndex(run_sym=run_sym, run_start=run_start, run_len=run_len,
                  cum=cum, C=C, n=n, n_seq=n_seq, max_len=1, samples=zeros,
                  last_sorted=zeros, last_to_run=zeros), sym


def _set_tails(idx: RIndex, tail_packed: np.ndarray) -> None:
    """last_sorted / last_to_run from the packed text position of every run
    tail."""
    order = np.argsort(tail_packed, kind="stable")
    idx.last_sorted = tail_packed[order]
    idx.last_to_run = order.astype(np.int64)


def build_rindex(rlbwt: RLBWT, keep_sa: bool = False, _sa_hint=None) -> RIndex:
    """Construct the r-index from a run-length BWT by the run-length-bounded
    native psi walk (src/cpp/psi_walk.cpp): O(r) memory, the samples taken
    at run heads and tails during the walk, positions from the distance
    flip (a row's suffix starts seq_len - 1 - t into its sequence, t the
    walk's step); the reference's per-sequence psi walk
    (r-index.cpp:1025-1094). A failed native build raises.

    keep_sa: also keep the per-row suffix array (sa_seq, sa_pos) and the
    sequence lengths, which the tag build gathers through (16 bytes a row).
    _sa_hint = (seq_of_row, pos_of_row, seq_lengths): a known suffix array,
    which skips the walk (build_rindex_from_sa)."""
    if _sa_hint is not None:
        return build_rindex_from_sa(rlbwt, *_sa_hint, keep_sa=keep_sa)
    from .. import native

    idx, sym = _rindex_head(rlbwt)
    r = idx.n_runs
    psi_base = idx.C[sym] + idx.cum[np.arange(r), sym]
    res = native.psi_walk_native(idx.run_start, psi_base, idx.run_sym == 0, idx.n,
                                 idx.n_seq, full_sa=keep_sa)
    h_seq, h_t, t_seq, t_t, seq_len = res[:5]
    idx.max_len = max_len = int(seq_len.max())
    idx.samples = h_seq * max_len + (seq_len[h_seq] - 1 - h_t)
    _set_tails(idx, t_seq * max_len + (seq_len[t_seq] - 1 - t_t))
    if keep_sa:
        sa_seq, sa_t = res[5], res[6]
        idx.sa_seq, idx.sa_pos, idx.seq_lengths = sa_seq, seq_len[sa_seq] - 1 - sa_t, seq_len
    return idx


def build_rindex_from_sa(rlbwt: RLBWT, seq_of_row: np.ndarray,
                         pos_of_row: np.ndarray, seq_lengths: np.ndarray,
                         keep_sa: bool = False) -> RIndex:
    """Construct the r-index from a run-length BWT and its suffix array
    (per BWT row: sequence id and suffix start offset; per sequence: length
    incl. endmarker)."""
    idx, _ = _rindex_head(rlbwt)
    # the caller's dtype is kept (the native SA-IS hands int32 below 2^31);
    # packing upcasts on the r-sized slice
    seq_of_row, pos_of_row = np.asarray(seq_of_row), np.asarray(pos_of_row)
    seq_len = np.asarray(seq_lengths, np.int64)
    idx.max_len = max_len = int(seq_len.max())

    def packed_at(rows):
        return seq_of_row[rows].astype(np.int64) * max_len + pos_of_row[rows]

    idx.samples = packed_at(idx.run_start)
    _set_tails(idx, packed_at(idx.run_start + idx.run_len - 1))
    if keep_sa:
        idx.sa_seq, idx.sa_pos, idx.seq_lengths = seq_of_row, pos_of_row, seq_len
    return idx
