"""GBWT/GBZ construction from haplotype paths (in-memory).

The port's copy of pangenome_index_tpu/core/gbwt_build.py, for the synthetic
graphs of utils/synth.py, the tests and chip_smoke.py. The record bytes come
from the native encoder only (no Python fallback). The reference consumes
GBZ files produced by the external gbwt/gbwtgraph toolchain; this module
builds the same structures directly from a node set and path list.

GBWT semantics (matching formats/gbz.py's Record.lf / extract):
  * sequences start at the endmarker record (node 0), offset = sequence id
  * lf(v, i) -> (w, j): w is the node following visit i of v; the visits of
    each node are ordered by their *reversed path prefix* (predecessor node,
    then predecessor's visit order, recursively; sequence id breaks ties),
    which makes j = edge_offset(v->w) + #(earlier visits of v continuing to w)
  * edge_offset(v->w) = #visits of w whose predecessor node id < v

Construction here materializes every visit, sorts each node's visits by
reversed prefix (with sequence-id tiebreak), and emits records with the
gbwt Run/ByteCode codecs; tests/test_torch_graph.py holds the records
byte-equal to the JAX package's.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native
from ..formats.gbz import GBZ, GBWT, GBWTGraph


def _suffix_ranks(T: np.ndarray) -> np.ndarray:
    """Rank of every suffix of integer array T (prefix doubling, numpy
    lexsort). Callers ensure suffixes become distinct before comparisons can
    run past their own region (per-sequence unique terminators)."""
    N = len(T)
    rank = np.unique(T, return_inverse=True)[1].astype(np.int64)
    k = 1
    while int(rank.max()) < N - 1:
        key2 = np.zeros(N, np.int64)
        key2[: N - k] = rank[k:] + 1
        order = np.lexsort((key2, rank))
        r1, k1 = rank[order], key2[order]
        bump = np.concatenate(([0], ((r1[1:] != r1[:-1]) | (k1[1:] != k1[:-1])).astype(np.int64)))
        nxt = np.empty(N, np.int64)
        nxt[order] = np.cumsum(bump)
        rank = nxt
        k *= 2
    return rank


def _encode_records_native(edge_ptr, edge_node, edge_off, run_ptr, run_rank, run_len):
    """Record bytes of the CSR arrays by the native encoder
    (src/cpp/gbwt_decode.cpp, two passes: sizes, then the bytes):
    (data, record starts)."""
    lib = native.get_lib()

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n_rec = len(edge_ptr) - 1
    args = (ptr(edge_ptr, ctypes.c_int64), ptr(edge_node, ctypes.c_int64),
            ptr(edge_off, ctypes.c_int64), ptr(run_ptr, ctypes.c_int64),
            ptr(run_rank, ctypes.c_int32), ptr(run_len, ctypes.c_int64),
            ctypes.c_int64(n_rec))
    sizes = np.zeros(n_rec, np.int64)
    lib.panindex_gbwt_encode(*args, ptr(sizes, ctypes.c_int64),
                             ptr(sizes, ctypes.c_int64), ptr(sizes.view(np.uint8), ctypes.c_uint8),
                             ctypes.c_int32(0), ctypes.c_int32(0))
    starts = np.concatenate(([0], np.cumsum(sizes)))
    out = np.zeros(int(starts[-1]), np.uint8)
    lib.panindex_gbwt_encode(*args, ptr(sizes, ctypes.c_int64),
                             ptr(starts, ctypes.c_int64), ptr(out, ctypes.c_uint8),
                             ctypes.c_int32(1), ctypes.c_int32(0))
    return out.tobytes(), starts[:-1]


def gbwt_from_paths(paths: list[list[int]], alphabet_size: int | None = None) -> GBWT:
    """Build a GBWT from paths of gbwt node ids (2*node + orientation).

    paths[i] is sequence i (callers wanting a bidirectional index pass both
    orientations explicitly, like the fixtures).

    Array program throughout (scales to chromosome-length paths): the visit
    order at each node is by *reversed path prefix*, which is exactly the
    suffix order of the reversed paths - computed once with prefix doubling -
    and edge offsets / run lists follow from sorted key lookups. Record bytes
    are emitted by the native encoder (src/cpp/gbwt_decode.cpp).
    """
    n_seq = len(paths)
    arrs = [np.asarray(p, dtype=np.int64) for p in paths]
    if any(len(a) == 0 for a in arrs):
        raise ValueError("empty paths are not representable")
    lens = np.array([len(a) for a in arrs], np.int64)
    max_node = int(max(int(a.max()) for a in arrs))
    if alphabet_size is None:
        alphabet_size = max_node + 1
    offset = int(min(int(a.min()) for a in arrs)) - 1

    L = int(lens.sum())
    flat = np.concatenate(arrs)
    starts = np.concatenate(([0], np.cumsum(lens)))[:-1]
    seq_of = np.repeat(np.arange(n_seq, dtype=np.int64), lens)
    step_of = np.arange(L, dtype=np.int64) - starts[seq_of]
    succ = np.concatenate((flat[1:], [0]))
    succ[step_of == lens[seq_of] - 1] = 0
    pred = np.concatenate(([0], flat[:-1]))
    pred[step_of == 0] = 0

    # reversed concatenation with per-seq terminators (terminator of seq s =
    # value s, nodes shifted above them): the suffix starting at
    # base2[seq] + (len - step) spells visit (seq, step)'s reversed prefix,
    # and unique terminators give the sequence-id tiebreak for free
    parts = []
    for s, a in enumerate(arrs):
        parts.append(a[::-1] + n_seq)
        parts.append(np.array([s], np.int64))
    T = np.concatenate(parts)
    base2 = np.concatenate(([0], np.cumsum(lens + 1)))[:-1]
    rank = _suffix_ranks(T)
    vrank = rank[base2[seq_of] + lens[seq_of] - step_of]

    order = np.lexsort((vrank, flat))           # visits by (node, visit order)
    v_s = flat[order]
    succ_s = succ[order]
    BIG = max_node + 2
    pair_keys = v_s * BIG + succ_s
    uniq = np.unique(pair_keys)                 # per-node successor lists, w-sorted
    edge_v = uniq // BIG
    edge_w = uniq % BIG
    # edge offset of v->w = #visits at w whose predecessor node id < v: one
    # searchsorted against the sorted (node, pred) visit keys
    visit_keys = np.sort(flat * BIG + pred)
    cnt = (np.searchsorted(visit_keys, edge_w * BIG + edge_v)
           - np.searchsorted(visit_keys, edge_w * BIG))
    edge_offs = np.where(edge_w == 0, 0, cnt)
    # per-visit edge rank (index of succ within its node's successor list)
    c_s = np.searchsorted(uniq, pair_keys) - np.searchsorted(uniq, v_s * BIG)
    # run-length encode successor ranks within each node's visit segment
    newrun = np.concatenate(([True], (v_s[1:] != v_s[:-1]) | (c_s[1:] != c_s[:-1])))
    run_idx = np.flatnonzero(newrun)
    run_v = v_s[run_idx]
    run_c = c_s[run_idx].astype(np.int32)
    run_l = np.diff(np.concatenate((run_idx, [L])))

    # endmarker record: every sequence starts there in sequence order
    first_nodes = np.unique(flat[starts])
    c0 = np.searchsorted(first_nodes, flat[starts])
    nr0 = np.concatenate(([True], c0[1:] != c0[:-1]))
    r0 = np.flatnonzero(nr0)
    runs0_rank = c0[r0].astype(np.int32)
    runs0_len = np.diff(np.concatenate((r0, [n_seq])))

    # assemble the record CSR (comp 0 = endmarker, comp c>0 = node c+offset;
    # uniq/run_v are already node-sorted so concatenation is placement)
    comp_count = alphabet_size - offset
    edge_counts = np.bincount(edge_v - offset, minlength=comp_count)
    edge_counts[0] = len(first_nodes)
    edge_ptr = np.concatenate(([0], np.cumsum(edge_counts)))
    edge_node_a = np.empty(int(edge_ptr[-1]), np.int64)
    edge_off_a = np.empty_like(edge_node_a)
    nf = len(first_nodes)
    edge_node_a[:nf], edge_off_a[:nf] = first_nodes, 0
    edge_node_a[nf:], edge_off_a[nf:] = edge_w, edge_offs
    run_counts = np.bincount(run_v - offset, minlength=comp_count)
    run_counts[0] = len(r0)
    run_ptr = np.concatenate(([0], np.cumsum(run_counts)))
    run_rank_a = np.empty(int(run_ptr[-1]), np.int32)
    run_len_a = np.empty(int(run_ptr[-1]), np.int64)
    nr = len(r0)
    run_rank_a[:nr], run_len_a[:nr] = runs0_rank, runs0_len
    run_rank_a[nr:], run_len_a[nr:] = run_c, run_l

    data, rec_starts = _encode_records_native(edge_ptr, edge_node_a, edge_off_a,
                                              run_ptr, run_rank_a, run_len_a)
    size = int((lens + 1).sum())
    return GBWT(sequences=n_seq, size=size, offset=offset,
                alphabet_size=alphabet_size, flags=GBWT.FLAG_BIDIRECTIONAL,
                record_starts=np.asarray(rec_starts, np.int64), bwt_data=bytes(data),
                tags=[])


def gbz_from_graph(node_seqs: dict[int, bytes], paths: list[list[int]]) -> GBZ:
    """In-memory GBZ from forward node sequences + gbwt-node-id paths."""
    index = gbwt_from_paths(paths)
    node_ids = np.array(sorted(node_seqs), dtype=np.int64)
    first = int(node_ids[0])
    full = [node_seqs.get(i, b"") for i in range(first, int(node_ids[-1]) + 1)]
    graph = GBWTGraph(nodes=2 * len(full), flags=0, sequences=full,
                      node_ids=np.arange(first, int(node_ids[-1]) + 1, dtype=np.int64))
    return GBZ(tags=[b"source", b"pangenome_index_tpu"], index=index, graph=graph)


def random_pangenome_gbz(rng: np.random.Generator, n_nodes: int = 40,
                         n_paths: int = 3, bidirectional: bool = True) -> GBZ:
    """A random variation-graph-like GBZ: a backbone chain with bubble
    branches; paths pick a branch at each bubble."""
    node_seqs: dict[int, bytes] = {}
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    nid = 1
    backbone: list[tuple[int, int | None]] = []  # (main node, alt node or None)
    while nid <= n_nodes - 1:
        ln = int(rng.integers(1, 12))
        node_seqs[nid] = rng.choice(alphabet, ln).tobytes()
        main = nid
        nid += 1
        alt = None
        if nid <= n_nodes - 1 and rng.random() < 0.4:
            node_seqs[nid] = rng.choice(alphabet, int(rng.integers(1, 12))).tobytes()
            alt = nid
            nid += 1
        backbone.append((main, alt))
    paths = []
    for _ in range(n_paths):
        fwd = []
        for main, alt in backbone:
            pick = alt if (alt is not None and rng.random() < 0.5) else main
            fwd.append(2 * pick)
        paths.append(fwd)
        if bidirectional:
            paths.append([n ^ 1 for n in reversed(fwd)])
    return gbz_from_graph(node_seqs, paths)
