"""Naive multi-string BWT: the host rotation sort of `build-bwt --engine
host`, and the textbook MEMs that the MEM engines are held against.

The port's copy of pangenome_index_tpu/models/oracle.py (oracle_from_file,
oracle_from_lines, _rotation_order, brute_force_mems): concatenate
the input lines, replace each terminating '\\n' with a *distinct* separator
ordered by sequence index (so separator comparisons tie-break by sequence),
sort all rotations by prefix doubling on the host, and read off the last
column, the document array and the suffix positions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class OracleBWT:
    bwt: np.ndarray        # uint8 [n]  BWT bytes (separators restored to '\n')
    da: np.ndarray         # int64 [n]  document (sequence) index per row
    sa_pos: np.ndarray     # int64 [n]  offset of the suffix within its sequence
                           #            (0-based, terminator at position len(seq))
    seq_lengths: np.ndarray  # int64 [n_seq]  sequence lengths incl. terminator


def _rotation_order(keys: np.ndarray) -> np.ndarray:
    """The permutation sorting all rotations of `keys`, by prefix doubling
    on the cyclic string."""
    n = keys.size
    rank = np.unique(keys, return_inverse=True)[1].astype(np.int64)
    k = 1
    idx = np.arange(n)
    while k < n:
        second = rank[(idx + k) % n]
        pair = rank * (n + 1) + second
        order = np.argsort(pair, kind="stable")
        new_rank = np.zeros(n, dtype=np.int64)
        sorted_pairs = pair[order]
        new_rank[order] = np.concatenate(([0], np.cumsum(sorted_pairs[1:] != sorted_pairs[:-1])))
        rank = new_rank
        if rank.max() == n - 1:
            break
        k *= 2
    return np.argsort(rank, kind="stable")


def oracle_from_lines(lines: list[bytes]) -> OracleBWT:
    n_seq = len(lines)
    parts = []
    seq_idx = []
    seq_lengths = []
    sa_pos_parts = []
    for i, line in enumerate(lines):
        # distinct separator per sequence (key i), ordered by sequence index,
        # strictly below every real character (key byte + n_seq)
        arr = np.frombuffer(line, dtype=np.uint8).astype(np.int64) + n_seq
        full = np.concatenate((arr, [i]))
        parts.append(full)
        seq_idx.append(np.full(full.size, i, dtype=np.int64))
        seq_lengths.append(full.size)
        sa_pos_parts.append(np.arange(full.size, dtype=np.int64))
    keys = np.concatenate(parts)
    seq_idx = np.concatenate(seq_idx)
    sa_pos = np.concatenate(sa_pos_parts)
    n = keys.size
    order = _rotation_order(keys)
    prev = (order - 1) % n
    bwt_keys = keys[prev]
    bwt = np.where(bwt_keys >= n_seq, bwt_keys - n_seq, ord("\n")).astype(np.uint8)
    return OracleBWT(
        bwt=bwt,
        da=seq_idx[order],
        sa_pos=sa_pos[order],
        seq_lengths=np.array(seq_lengths, dtype=np.int64),
    )


def oracle_from_file(path: str) -> OracleBWT:
    with open(path, "rb") as fh:
        data = fh.read()
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines = lines[:-1]
    return oracle_from_lines(lines)


def brute_force_mems(text_lines: list[bytes], pattern: bytes, min_len: int, min_occ: int):
    """Textbook MEMs of `pattern` against the text (which holds both
    strands in the bidirectional indexes): a MEM [x, e) is a match of
    pattern[x:e] with at least min_occ occurrences, length >= min_len, that
    cannot be extended left or right without dropping below min_occ. The
    semantics of find_mems_function (algorithm.hpp:653-736). Returns a list
    of (x, e, occurrences)."""
    def occ(s: bytes) -> int:
        if not s:
            return sum(len(t) for t in text_lines)
        c = 0
        for t in text_lines:
            start = 0
            while True:
                i = t.find(s, start)
                if i < 0:
                    break
                c += 1
                start = i + 1
        return c

    def passes(s: bytes) -> bool:
        k = occ(s)
        return k >= min_occ and k > 0

    n = len(pattern)
    mems = []
    for x in range(n - min_len + 1):
        e = x + min_len
        if not passes(pattern[x:e]):
            continue
        while e < n and passes(pattern[x : e + 1]):
            e += 1
        if x == 0 or not passes(pattern[x - 1 : e]):
            mems.append((x, e, occ(pattern[x:e])))
    return mems
