"""K-mer anchoring and run extension (the reference's coverage-building
phases, re-designed as level-synchronous batched array ops).

The port's copy of pangenome_index_tpu/core/anchor.py (build-tags --stats).

Anchoring (replaces the recursive per-thread DFS of
kmers_to_bplustree_worker, algorithm.hpp:134-226): maintain a frontier of
(BWT interval, partial key); each level extends every frontier entry by all
four bases with ONE batched LF over the whole frontier, pruning (a) empty
intervals and (b) suffixes no unique k-mer ends with — the latter via a
binary search against the char-reversed sorted key set, which bounds the
frontier by the unique-kmer count instead of by the number of distinct
d-mers in the text (genome scale instead of fixture scale). After k levels,
join surviving k-mers against the unique-kmer index with a sorted lookup.

Extension (replaces extend_kmers_bfs_parallel, algorithm.hpp:231-375):
level-synchronous BFS where every live run steps one base left — within its
node, or fanning out across in-edges, one candidate per base carried by
exactly one predecessor node — with batched LF for all runs at once and a
coverage bitmap standing in for the B+-tree's overlap rejection
(insert_success). Per-round work is pure array ops: the deterministic
predecessor set is a CSR table derived once from the flat GBWT record table
(formats/gbwt_table), candidate bases come from vectorized gathers over the
node-sequence blob, and the covered-overlap test is one logical_or.reduceat.
"""

from __future__ import annotations

import numpy as np

from ..formats.gbz import GBZ
from ..models.rindex import RIndex
from ..utils.alphabet import BYTE_TO_CODE


def _lf_batch(idx: RIndex, lo: np.ndarray, hi: np.ndarray, code: int):
    """Batched LF over intervals [lo, hi] for one symbol code."""
    start = idx.rank(lo, code)
    inside = idx.rank(hi + 1, code) - start
    nlo = start + idx.C[code]
    nhi = nlo + inside - 1
    return nlo, nhi, inside > 0


def _reverse_packed(keys: np.ndarray, k: int) -> np.ndarray:
    """Char-wise reversal of 2-bit packed k-mers (leftmost char stays in the
    highest bits of the result)."""
    out = np.zeros_like(keys)
    v = keys.copy()
    for _ in range(k):
        out = (out << 2) | (v & 3)
        v >>= 2
    return out


def anchor_kmers(idx: RIndex, keys: np.ndarray, positions: np.ndarray, k: int):
    """Enumerate k-mers with nonempty BWT interval that some unique k-mer
    could still complete; anchor those present in the unique index. Returns
    (run_start, run_len, pos_enc) arrays.

    keys must be sorted (output of core/kmers.unique_kmers).
    """
    if len(keys) == 0:
        # no unique k-mers -> nothing can anchor; also keeps the frontier
        # pruned (with an empty oracle the loop below would enumerate every
        # distinct d-mer of the text before finding zero hits)
        e = np.zeros(0, np.int64)
        return e, e.copy(), e.copy()
    # suffix-membership oracle: backward search builds k-mers right-to-left,
    # so after d levels the partial key holds the d RIGHTMOST chars. "Some
    # unique k-mer ends with suffix S" == "some char-reversed key starts
    # with reverse(S)" — a contiguous range of the sorted reversed keys.
    rev_sorted = np.sort(_reverse_packed(np.asarray(keys, np.int64), k))

    lo = np.zeros(1, dtype=np.int64)
    hi = np.full(1, idx.n - 1, dtype=np.int64)
    key = np.zeros(1, dtype=np.int64)   # suffix in final orientation
    rkey = np.zeros(1, dtype=np.int64)  # char-reversed suffix
    for depth in range(k):
        los, his, kys, rks = [], [], [], []
        for base, code2 in [(0, 1), (1, 2), (2, 3), (3, 5)]:  # A,C,G,T codes
            nlo, nhi, ok = _lf_batch(idx, lo, hi, code2)
            # prepending char c to a suffix S of length d gives
            # key = c << 2d | key(S) and rkey = rkey(S) << 2 | c
            nk = (base << (2 * depth)) | key
            nr = (rkey << 2) | base
            if len(rev_sorted):
                shift = 2 * (k - depth - 1)
                lo_b = np.searchsorted(rev_sorted, nr << shift, side="left")
                hi_b = np.searchsorted(rev_sorted, (nr + 1) << shift, side="left")
                ok = ok & (lo_b < hi_b)
            los.append(nlo[ok])
            his.append(nhi[ok])
            kys.append(nk[ok])
            rks.append(nr[ok])
        lo = np.concatenate(los)
        hi = np.concatenate(his)
        key = np.concatenate(kys)
        rkey = np.concatenate(rks)
    # join against unique kmers
    j = np.searchsorted(keys, key)
    j_c = np.clip(j, 0, max(len(keys) - 1, 0))
    hit = (len(keys) > 0) & (keys[j_c] == key)
    return lo[hit], (hi - lo + 1)[hit], positions[j_c[hit]]


def predecessor_map(gbz: GBZ):
    """For every oriented node (gbwt node id), the list of (pred gbwt node,
    pred base), by flipping successor edges (follow_edges backwards,
    algorithm.hpp:311). An oriented node without a record has no edges."""
    from ..formats.gbz import node_seq

    preds: dict[int, list[int]] = {}
    for nid in gbz.graph.node_ids:
        for orient in (0, 1):
            node = 2 * int(nid) + orient
            try:
                rec = gbz.index.record(node)
            except IndexError:
                continue
            for succ, _ in rec.edges:
                if succ != 0:
                    preds.setdefault(succ, []).append(node)
    return {node: [(p, node_seq(gbz, p >> 1, bool(p & 1))[-1]) for p in set(plist)]
            for node, plist in preds.items()}


def det_predecessor_csr(gbz: GBZ):
    """(dst_sorted, base, pred_pos): for every oriented node, its
    DETERMINISTIC predecessor entries — bases carried by exactly one
    predecessor node across all in-edges — sorted by (dst node, base byte).
    pred_pos is the packed graph position of the predecessor's last char.
    Derived in one pass over the flat GBWT record table's successor edges
    (follow_edges backwards, algorithm.hpp:311)."""
    from .tagbuild import _COMP_LUT, graph_arrays

    tbl = gbz.index.table()
    blob, starts, lens, first = graph_arrays(gbz)

    counts = np.diff(tbl.edge_ptr)
    src_comp = np.repeat(np.arange(tbl.n_rec, dtype=np.int64), counts)
    src = np.where(src_comp == 0, 0, src_comp + tbl.offset)
    dst = tbl.edge_node
    keep = (src != 0) & (dst != 0)
    src, dst = src[keep], dst[keep]

    row = (src >> 1) - first
    fwd = blob[starts[row] + lens[row] - 1]
    bwd = _COMP_LUT[blob[starts[row]]]
    base = np.where((src & 1) == 1, bwd, fwd).astype(np.int64)

    order = np.lexsort((src, base, dst))
    d, b, s = dst[order], base[order], src[order]
    gkey = (d << 8) | b
    new = np.concatenate(([True], gkey[1:] != gkey[:-1])) if len(gkey) else \
        np.zeros(0, bool)
    gid = np.cumsum(new) - 1 if len(gkey) else gkey
    gsize = np.bincount(gid) if len(gkey) else gkey
    det = gsize[gid] == 1 if len(gkey) else np.zeros(0, bool)
    d, b, s = d[det], b[det], s[det]
    plen = lens[(s >> 1) - first]
    ppos = ((s >> 1) << 11) | ((s & 1) << 10) | (plen - 1)
    return d, b, ppos


def extend_runs(gbz: GBZ, idx: RIndex, run_start, run_len, pos_enc,
                max_rounds: int = 10**9):
    """BFS-extend anchored runs one base left per round; returns augmented
    (run_start, run_len, pos_enc) plus the coverage bitmap."""
    from .tagbuild import _COMP_LUT, graph_arrays

    n = idx.n
    covered = np.zeros(n + 1, dtype=bool)  # +1: reduceat sentinel slot
    for s, l in zip(run_start.tolist(), run_len.tolist()):
        covered[s : s + l] = True

    blob, starts, lens, first = graph_arrays(gbz)
    det_dst, det_base, det_pos = det_predecessor_csr(gbz)

    out_start = [run_start]
    out_len = [run_len]
    out_pos = [pos_enc]

    cur_start, cur_len, cur_pos = run_start, run_len, pos_enc
    rounds = 0
    while len(cur_start) and rounds < max_rounds:
        rounds += 1
        nid = cur_pos >> 11
        rev = (cur_pos >> 10) & 1
        off = cur_pos & 0x3FF

        # within a node there is one candidate: the previous oriented char
        w = np.flatnonzero(off > 0)
        row = nid[w] - first
        o = off[w] - 1
        w_fwd = blob[starts[row] + o]
        w_bwd = _COMP_LUT[blob[starts[row] + lens[row] - 1 - o]]
        w_base = np.where(rev[w] == 1, w_bwd, w_fwd).astype(np.int64)
        w_npos = (nid[w] << 11) | (rev[w] << 10) | o

        # at a node start the run FANS OUT to one candidate per base carried
        # by exactly one predecessor node (the reference's per-base loop over
        # base_to_nodes, algorithm.hpp:324-355)
        sidx = np.flatnonzero(off == 0)
        node = 2 * nid[sidx] + rev[sidx]
        elo = np.searchsorted(det_dst, node, side="left")
        ehi = np.searchsorted(det_dst, node, side="right")
        cnt = ehi - elo
        vi = np.repeat(np.arange(len(sidx), dtype=np.int64), cnt)
        intra = np.arange(int(cnt.sum()), dtype=np.int64) - \
            np.repeat(np.cumsum(cnt) - cnt, cnt)
        e = elo[vi] + intra
        s_src = sidx[vi]
        s_base = det_base[e]
        s_npos = det_pos[e]

        src = np.concatenate((w, s_src))
        base = np.concatenate((w_base, s_base))
        npos = np.concatenate((w_npos, s_npos))
        ordr = np.lexsort((base, src))  # candidate order: (run, base byte)
        src, base, npos = src[ordr], base[ordr], npos[ordr]

        codes = BYTE_TO_CODE[base].astype(np.int64)
        nlo = np.zeros(len(src), dtype=np.int64)
        nhi = np.zeros(len(src), dtype=np.int64)
        good = np.zeros(len(src), dtype=bool)
        for c in np.unique(codes):
            m = codes == c
            s_m = cur_start[src[m]]
            lo2, hi2, nz = _lf_batch(idx, s_m, s_m + cur_len[src[m]] - 1, int(c))
            nlo[m], nhi[m] = lo2, hi2
            good[m] = nz

        # acceptance = target range fully uncovered (the B+-tree's
        # insert_success overlap rejection), candidates processed in order.
        # Vectorized: overlap with PRE-ROUND coverage is one reduceat; only
        # candidates that overlap another candidate need sequential order.
        gi = np.flatnonzero(good)
        accept = np.zeros(len(src), dtype=bool)
        if len(gi):
            cs, ce = nlo[gi], nhi[gi]
            seg = np.column_stack((cs, ce + 1)).ravel()
            pre_cov = np.logical_or.reduceat(covered, seg)[::2]
            ok = np.flatnonzero(~pre_cov)
            if len(ok):
                os_, oe_ = cs[ok], ce[ok]
                so = np.argsort(os_, kind="stable")
                run_max = np.maximum.accumulate(oe_[so])
                conflict_sorted = np.zeros(len(ok), dtype=bool)
                if len(ok) > 1:
                    with_prev = os_[so][1:] <= run_max[:-1]
                    conflict_sorted[1:] = with_prev
                    conflict_sorted[:-1] |= with_prev  # both sides conflict
                conflict = np.zeros(len(ok), dtype=bool)
                conflict[so] = conflict_sorted
                free = ok[~conflict]
                accept[gi[free]] = True
                for s0, e0 in zip(os_[~conflict].tolist(), oe_[~conflict].tolist()):
                    covered[s0 : e0 + 1] = True
                # conflicting candidates: resolve in candidate order against
                # the live bitmap (exactly the sequential semantics)
                for j in ok[conflict].tolist():
                    s0, e0 = int(cs[j]), int(ce[j])
                    if not covered[s0 : e0 + 1].any():
                        covered[s0 : e0 + 1] = True
                        accept[gi[j]] = True

        acc = np.flatnonzero(accept)
        cur_start = nlo[acc]
        cur_len = nhi[acc] - nlo[acc] + 1
        cur_pos = npos[acc]
        if len(cur_start):
            out_start.append(cur_start)
            out_len.append(cur_len)
            out_pos.append(cur_pos)
    return (np.concatenate(out_start), np.concatenate(out_len),
            np.concatenate(out_pos), covered[:n])
