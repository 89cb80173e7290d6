"""Unique k-mer indexing over the pangenome graph.

The port's copy of pangenome_index_tpu/core/kmers.py (build-tags --stats).
It re-implements unique_kmers_parallel (include/pangenome_index/unique_kmer.hpp:
95-191): enumerate forward-strand k-mers over every haplotype path
traversal, map each to the graph position of its first character, keep only
k-mers that occur at exactly one distinct graph position.

Instead of window callbacks + thread-local caches + a mutex-guarded hash map,
we enumerate per-path (the path character positions are exactly
core/tagbuild.path_tag_array), pack k-mers into 2-bit uint64 keys with a
vectorized rolling window, and resolve uniqueness with one sort over
(key, position) pairs.
"""

from __future__ import annotations

import numpy as np

from ..formats.gbz import GBZ

#: 2-bit packing matching gbwtgraph::Key64::encode: A=0, C=1, G=2, T=3
PACK = np.full(256, -1, dtype=np.int8)
for i, b in enumerate(b"ACGT"):
    PACK[b] = i
for i, b in enumerate(b"acgt"):
    PACK[b] = i


def kmer_keys(seq: bytes, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(keys, offsets) of all valid (ACGT-only) k-mers of seq."""
    arr = PACK[np.frombuffer(seq, np.uint8)].astype(np.int64)
    n = arr.size
    if n < k:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    valid = arr >= 0
    # rolling 2-bit pack via strided windows (k <= 31 fits in int64)
    win = np.lib.stride_tricks.sliding_window_view(arr, k)
    ok = np.lib.stride_tricks.sliding_window_view(valid, k).all(axis=1)
    shifts = (2 * (k - 1 - np.arange(k))).astype(np.int64)
    keys = (win << shifts[None, :]).sum(axis=1)
    offs = np.arange(n - k + 1, dtype=np.int64)
    return keys[ok], offs[ok]


def unique_kmers(gbz: GBZ, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(sorted keys, packed positions) of k-mers with exactly one graph
    position across all haplotype sequences (both GBWT orientations, matching
    for_each_haplotype_window's coverage of both strands).

    One batched path walk for all sequences (formats/gbwt_table), then the
    text/positions of every path come from two vectorized expansions
    (core/tagbuild.visits_to_text/_tags) - no per-node interpreter loop."""
    from .tagbuild import graph_arrays, visits_to_tags, visits_to_text

    visits, vptr = gbz.index.table().extract_all(
        np.arange(gbz.index.sequences, dtype=np.int64))
    text_all = visits_to_text(gbz, visits)
    pos_all = visits_to_tags(gbz, visits)
    # per-sequence char spans (k-mer windows must not straddle sequences)
    _, _, node_lens, first = graph_arrays(gbz)
    vl = node_lens[(visits >> 1) - first]
    cum_vl = np.concatenate(([0], np.cumsum(vl)))
    all_keys = []
    all_pos = []
    for sid in range(gbz.index.sequences):
        c0, c1 = int(cum_vl[vptr[sid]]), int(cum_vl[vptr[sid + 1]])
        keys, offs = kmer_keys(text_all[c0:c1].tobytes(), k)
        all_keys.append(keys)
        all_pos.append(pos_all[c0:c1][offs])
    keys = np.concatenate(all_keys)
    pos = np.concatenate(all_pos)
    # dedupe (key, pos) pairs, then drop keys with >1 distinct position
    pairs = np.stack((keys, pos), axis=1)
    pairs = np.unique(pairs, axis=0)
    uk, counts = np.unique(pairs[:, 0], return_counts=True)
    unique_mask = counts == 1
    sel = np.isin(pairs[:, 0], uk[unique_mask])
    out = pairs[sel]
    return out[:, 0], out[:, 1]
