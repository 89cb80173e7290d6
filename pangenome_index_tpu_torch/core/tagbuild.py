"""Tag-array construction (the build-tags command).

The port's copy of pangenome_index_tpu/core/tagbuild.py. The reference's
traversal asserts that anchored and extended tags equal the ground truth
(algorithm.hpp:446-461), so the final array is exactly

    tag[row] = graph position of the character at the suffix start of row

for every non-endmarker BWT row, run-length encoded in row order. The build
computes that directly: the r-index build gives the suffix array (the
native psi walk), the GBZ paths give every character's graph position, so
tagging is a gather and an RLE. The anchored pipeline (unique k-mers,
interval anchoring, extension) is core/anchor.py, for `--stats`.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import native
from ..formats.gbz import GBZ
from ..models.rindex import RIndex, build_rindex
from ..models.tagarray import TagArray

#: byte-level reverse-complement LUT (identity off ACGT)
_COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCAtgca"):
    _COMP_LUT[_a] = _b


def graph_arrays(gbz: GBZ):
    """(blob, starts, lens, first_node): all node sequences as one uint8 blob
    with per-node offsets, the array form of GBWTGraph.sequences (cached)."""
    ga = getattr(gbz, "_graph_arrays", None)
    if ga is None:
        seqs = gbz.graph.sequences
        lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
        starts = np.concatenate(([0], np.cumsum(lens)))[:-1]
        blob = np.frombuffer(b"".join(seqs), np.uint8)
        ga = (blob, starts, lens, int(gbz.graph.node_ids[0]))
        object.__setattr__(gbz, "_graph_arrays", ga)
    return ga


def _expand_visits(gbz: GBZ, visits: np.ndarray):
    """Per-character expansion of a flat node-visit array: (vi, offs, nid,
    rev, char_counts), vi the visit of each character and offs its offset
    in the node."""
    _, _, lens, first = graph_arrays(gbz)
    nid = visits >> 1
    rev = (visits & 1).astype(np.int64)
    vl = lens[nid - first]
    vi = np.repeat(np.arange(len(visits), dtype=np.int64), vl)
    base = np.cumsum(vl) - vl
    offs = np.arange(int(vl.sum()), dtype=np.int64) - base[vi]
    return vi, offs, nid, rev, vl


def visits_to_tags(gbz: GBZ, visits: np.ndarray) -> np.ndarray:
    """Compact-packed graph position of every character along the visits."""
    vi, offs, nid, rev, _ = _expand_visits(gbz, visits)
    return (nid[vi] << 11) | (rev[vi] << 10) | offs


def visits_to_text(gbz: GBZ, visits: np.ndarray) -> np.ndarray:
    """Concatenated oriented node sequences along the visits (uint8)."""
    blob, starts, lens, first = graph_arrays(gbz)
    vi, offs, nid, rev, _ = _expand_visits(gbz, visits)
    row = nid[vi] - first
    fwd = starts[row] + offs
    bwd = starts[row] + lens[row] - 1 - offs
    ch = blob[np.where(rev[vi] == 1, bwd, fwd)]
    return np.where(rev[vi] == 1, _COMP_LUT[ch], ch)


def path_tag_array(gbz: GBZ, seq_id: int) -> np.ndarray:
    """Compact-packed graph position of every character of sequence seq_id
    (terminator excluded), in path order."""
    return visits_to_tags(gbz, np.array(gbz.index.extract(seq_id), np.int64))


def text_seq_map(gbz: GBZ, n_seq: int) -> list[int]:
    """GBWT sequence id of each text sequence: text sequence i is GBWT
    sequence i when the text holds both strands, GBWT sequence 2i when it
    holds the forward strands only."""
    if n_seq == gbz.index.sequences:
        return list(range(n_seq))
    if 2 * n_seq == gbz.index.sequences:
        return [2 * i for i in range(n_seq)]
    raise ValueError(f"text has {n_seq} sequences but GBWT has {gbz.index.sequences}")


def tags_per_row(gbz: GBZ, idx: RIndex) -> np.ndarray:
    """tag[row] for rows [n_seq, n): packed graph positions in BWT row order
    (the record table's native path walk, a per-character expansion, one
    gather through the SA)."""
    if idx.sa_seq is None:
        raise ValueError("r-index must be built with keep_sa=True")
    n_seq = idx.n_seq
    seq_map = text_seq_map(gbz, n_seq)
    visits, vptr = gbz.index.table().extract_all(np.array(seq_map, np.int64))
    vi, offs, nid, rev, vl = _expand_visits(gbz, visits)
    flat = (nid[vi] << 11) | (rev[vi] << 10) | offs
    # characters per text sequence = sum of node lengths over its visit span
    cum_vl = np.concatenate(([0], np.cumsum(vl)))
    lengths = cum_vl[vptr[1:]] - cum_vl[vptr[:-1]]
    expect = idx.seq_lengths - 1
    if not np.array_equal(lengths, expect):
        raise ValueError(f"path lengths {lengths} != BWT sequence lengths {expect}")
    starts = np.concatenate(([0], np.cumsum(lengths)))[:-1]
    rows = np.arange(n_seq, idx.n)
    return flat[starts[idx.sa_seq[rows]] + idx.sa_pos[rows]]


def rle(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    if values.size == 0:
        return values, np.zeros(0, np.int64)
    boundaries = np.flatnonzero(values[1:] != values[:-1]) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [values.size]))
    return values[starts], (ends - starts).astype(np.int64)


class PsiSAWindows:
    """Windowed per-row SA by repeated native psi walks: each window() call
    re-runs the O(r)-memory walk and records only rows [lo, hi), trading
    one O(n) pass a window for the 16 bytes a row of the whole SA."""

    def __init__(self, idx: RIndex, n_threads: int = 0):
        sym = idx.run_sym.astype(np.int64)
        self.idx = idx
        self.psi_base = idx.C[sym] + idx.cum[np.arange(idx.n_runs), sym]
        self.is_end = idx.run_sym == 0
        self.n_threads = n_threads
        self.seq_lengths = idx.seq_lengths

    def window(self, lo: int, hi: int):
        """(sa_seq, sa_pos) for BWT rows [lo, hi)."""
        res = native.psi_walk_native(
            self.idx.run_start, self.psi_base, self.is_end, self.idx.n, self.idx.n_seq,
            n_threads=self.n_threads, full_sa=True, window=(lo, hi))
        seq_len, sa_seq, sa_t = res[4], res[5], res[6]
        self.seq_lengths = seq_len
        return sa_seq, seq_len[sa_seq] - 1 - sa_t


def build_tags(gbz: GBZ, idx: RIndex, chunk: int = 1 << 24,
               sa_window_bytes: int = 2 << 30, flat_bytes_cap: int = 8 << 30,
               n_threads: int = 0) -> TagArray:
    """Tag array over BWT rows [n_seq, n) in the algorithm-format coordinates
    (positions relative to the first non-endmarker row): the chunked form of
    rle(tags_per_row(...)), the SA gather and the RLE run a row window at a
    time with a boundary-run carry, so the temporaries are O(chunk).

    The per-row SA comes from idx.sa_seq/sa_pos where the index kept them,
    else from windowed native psi walks (PsiSAWindows) of
    sa_window_bytes / 16 rows a pass. The per-character tags are one array
    (8 bytes a character) while it fits flat_bytes_cap, else a searchsorted
    into the per-visit cumulative lengths."""
    stream_sa = idx.sa_seq is None
    n_seq = idx.n_seq
    seq_map = text_seq_map(gbz, n_seq)
    visits, vptr = gbz.index.table().extract_all(np.array(seq_map, np.int64))
    _, _, node_lens, first = graph_arrays(gbz)
    nid = visits >> 1
    rev = (visits & 1).astype(np.int64)
    vl = node_lens[nid - first]
    cum_vl = np.concatenate(([0], np.cumsum(vl)))
    lengths = cum_vl[vptr[1:]] - cum_vl[vptr[:-1]]

    def check_lengths(seq_lengths):
        expect = seq_lengths - 1
        if not np.array_equal(lengths, expect):
            raise ValueError(f"path lengths {lengths} != BWT sequence lengths {expect}")

    if stream_sa:
        provider = PsiSAWindows(idx, n_threads)
        if provider.seq_lengths is not None:
            check_lengths(provider.seq_lengths)
        # the budget holds even below the RLE chunk; at least 64 rows a pass
        win = max(64, (sa_window_bytes // 16) & ~63)
    else:
        provider = None
        check_lengths(idx.seq_lengths)
        win = idx.n  # resident arrays: one window

    total = int(cum_vl[-1])
    packed = (nid << 11) | (rev << 10)
    flat = None
    if total * 8 <= flat_bytes_cap:
        flat = np.empty(total, np.int64)
        v0 = 0
        while v0 < len(visits):
            v1 = min(max(int(np.searchsorted(cum_vl, cum_vl[v0] + chunk)), v0 + 1),
                     len(visits))
            a, b = int(cum_vl[v0]), int(cum_vl[v1])
            reps = vl[v0:v1]
            offs = np.arange(b - a, dtype=np.int64) - np.repeat(cum_vl[v0:v1] - a, reps)
            flat[a:b] = np.repeat(packed[v0:v1], reps) | offs
            v0 = v1

    starts = np.concatenate(([0], np.cumsum(lengths)))[:-1]

    def tags_of(seq, pos):
        gidx = starts[np.asarray(seq, np.int64)] + pos
        if flat is not None:
            return flat[gidx]
        vi = np.searchsorted(cum_vl, gidx, side="right") - 1
        return packed[vi] | (gidx - cum_vl[vi])

    out_v, out_l = [], []
    carry_v, carry_l = None, 0
    checked = not stream_sa
    for w0 in range(n_seq, idx.n, win):
        w1 = min(idx.n, w0 + win)
        if provider is not None:
            w_seq, w_pos = provider.window(w0, w1)
            if not checked:
                check_lengths(provider.seq_lengths)
                checked = True
        else:
            w_seq, w_pos = idx.sa_seq[w0:w1], idx.sa_pos[w0:w1]
        for s in range(0, w1 - w0, chunk):
            e = min(w1 - w0, s + chunk)
            v, ln = rle(tags_of(w_seq[s:e], w_pos[s:e]))
            if v.size == 0:
                continue
            if carry_v is not None:
                if v[0] == carry_v:
                    ln = ln.copy()
                    ln[0] += carry_l
                else:
                    out_v.append(np.array([carry_v], np.int64))
                    out_l.append(np.array([carry_l], np.int64))
            carry_v, carry_l = int(v[-1]), int(ln[-1])
            out_v.append(v[:-1])
            out_l.append(ln[:-1])
    if carry_v is not None:
        out_v.append(np.array([carry_v], np.int64))
        out_l.append(np.array([carry_l], np.int64))
    if not out_v:
        return TagArray.from_runs(np.zeros(0, np.int64), np.zeros(0, np.int64))
    return TagArray.from_runs(np.concatenate(out_v), np.concatenate(out_l))


def build_tags_pipeline(gbz_path: str, rlbwt_path: str, output_path: str,
                        k: int = 31, stats: bool = False, stream_sa: bool = False,
                        sa_window_bytes: int = 2 << 30, seconds: dict | None = None) -> int:
    """The build-tags command: the SA-based build, written in the algorithm
    format; with stats=True also the anchored pipeline for the coverage
    fractions the reference reports (build_tags.cpp:124-126, 163-165). Each
    phase's wall-clock seconds go to stderr, as the reference's chrono
    prints do (build_tags.cpp:71-73, 90-92, 135-138, 193-196); `seconds`,
    when given, receives them by phase."""
    from ..formats import tags as tagfmt
    from ..formats.gbz import load_gbz
    from ..formats.rlbwt import read_rlbwt

    print("Loading the graph file", file=sys.stderr)
    t = time.perf_counter()
    gbz = load_gbz(gbz_path)
    t = _phase(t, "Loading the graph", seconds)
    # stream_sa: the SA is never materialized; the tag gather re-walks psi
    # a row window at a time (PsiSAWindows)
    idx = build_rindex(read_rlbwt(rlbwt_path), keep_sa=not stream_sa)
    t = _phase(t, "Building the r-index", seconds)
    if stats:
        from .anchor import anchor_kmers, extend_runs
        from .kmers import unique_kmers

        keys, pos = unique_kmers(gbz, k)
        print(f"The number of unique kmers in the index is: {len(keys)}", file=sys.stderr)
        t = _phase(t, "Indexing unique kmers", seconds)
        rs, rl, rp = anchor_kmers(idx, keys, pos, k)
        covered = int(rl.sum())
        print(f"The fraction of the tag arrays covered by unique kmers is: "
              f"{covered} / {idx.n} = {covered / idx.n}", file=sys.stderr)
        t = _phase(t, "Anchoring kmers", seconds)
        _, el, _, _ = extend_runs(gbz, idx, rs, rl, rp, max_rounds=10_000)
        covered2 = int(el.sum())
        print(f"The fraction of the tag arrays covered after extending the kmers is: "
              f"{covered2} / {idx.n} = {covered2 / idx.n}", file=sys.stderr)
        t = _phase(t, "Extending kmers", seconds)
    tags = build_tags(gbz, idx, sa_window_bytes=sa_window_bytes)
    t = _phase(t, "Traversing all paths (tag gather + RLE)", seconds)
    data = tagfmt.write_algorithm(tags)
    with open(output_path, "wb") as fh:
        fh.write(data)
    _phase(t, "Serializing tag runs", seconds)
    print(f"build-tags: {tags.n_runs} runs covering {tags.total} BWT positions",
          file=sys.stderr)
    return 0


def _phase(t0: float, label: str, seconds: dict | None = None) -> float:
    """Print one phase's seconds on stderr (the reference's chrono prints),
    add them to seconds[label] where a dict is given, and return the next
    phase's start time."""
    t1 = time.perf_counter()
    print(f"{label} took {t1 - t0:.3f} seconds", file=sys.stderr)
    if seconds is not None:
        seconds[label] = seconds.get(label, 0.0) + t1 - t0
    return t1
