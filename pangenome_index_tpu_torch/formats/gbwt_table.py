"""Flat decoded-record table for the GBWT: the build plane's array form.

The port's copy of pangenome_index_tpu/formats/gbwt_table.py. Every record
is decoded once into flat CSR arrays, so that path extraction, component
detection and tag construction are array programs:

  edge_ptr[c]..edge_ptr[c+1]  edges of record c: absolute successor node id
                              (edge_node) + BWT offset (edge_off)
  run_ptr[c]..run_ptr[c+1]    runs of record c: edge rank (run_rank) and
                              length (run_len), plus two derived prefix sums
                              that make LF a binary search:
  run_cum[j]                  within-record position before run j
  occ_before[j]               occurrences of run j's rank earlier in its record

LF(c, off): find the run j covering off (binary search on run_cum), then
successor = edges[run_rank[j]], offset = edge_off + occ_before[j] +
(off - run_cum[j]): the arithmetic of Record.lf (formats/gbz.py) with the
scan replaced by precomputed sums.

Decode and path extraction run in the native engine
(src/cpp/gbwt_decode.cpp through native.py, OpenMP over records and
sequences). The JAX package falls back to a numpy decode where that
library is missing; the port raises instead (native.get_lib()).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from .. import native
from .gbz import GBWT


def _segmented_exclusive_cumsum(values: np.ndarray, group_key: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum of `values` within runs of equal `group_key`
    (keys need not be grouped; a stable sort keeps the in-group order)."""
    order = np.argsort(group_key, kind="stable")
    v = values[order]
    cs = np.cumsum(v) - v
    k = group_key[order]
    is_start = np.concatenate(([True], k[1:] != k[:-1]))
    base = np.maximum.accumulate(np.where(is_start, cs, 0))
    out = np.empty_like(cs)
    out[order] = cs - base
    return out


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


@dataclass
class RecordTable:
    """All GBWT records as flat CSR arrays (see module docstring)."""

    offset: int                # gbwt node id offset: comp c>0 <-> node c+offset
    edge_ptr: np.ndarray       # [n_rec+1] int64
    edge_node: np.ndarray      # int64, absolute successor gbwt node ids
    edge_off: np.ndarray       # int64
    run_ptr: np.ndarray        # [n_rec+1] int64
    run_rank: np.ndarray       # int32
    run_len: np.ndarray        # int64
    run_cum: np.ndarray        # int64, exclusive within-record prefix of run_len
    occ_before: np.ndarray     # int64, prior occurrences of this run's rank

    @property
    def n_rec(self) -> int:
        return len(self.edge_ptr) - 1

    @classmethod
    def from_gbwt(cls, g: GBWT) -> "RecordTable":
        """Decode every record by the native engine (two passes: sizes, then
        the arrays)."""
        lib = native.get_lib()
        starts = np.ascontiguousarray(g.record_starts, np.int64)
        data = np.frombuffer(g.bwt_data, np.uint8)
        ec = np.zeros(len(starts), np.int64)
        rc = np.zeros(len(starts), np.int64)
        head = (_ptr(data, ctypes.c_uint8), ctypes.c_int64(data.size),
                _ptr(starts, ctypes.c_int64), ctypes.c_int64(len(starts)))
        lib.panindex_gbwt_count(*head, _ptr(ec, ctypes.c_int64),
                                _ptr(rc, ctypes.c_int64), ctypes.c_int32(0))
        edge_ptr = np.concatenate(([0], np.cumsum(ec)))
        run_ptr = np.concatenate(([0], np.cumsum(rc)))
        edge_node = np.zeros(edge_ptr[-1], np.int64)
        edge_off = np.zeros(edge_ptr[-1], np.int64)
        run_rank = np.zeros(run_ptr[-1], np.int32)
        run_len = np.zeros(run_ptr[-1], np.int64)
        lib.panindex_gbwt_fill(
            *head, _ptr(edge_ptr, ctypes.c_int64), _ptr(run_ptr, ctypes.c_int64),
            _ptr(edge_node, ctypes.c_int64), _ptr(edge_off, ctypes.c_int64),
            _ptr(run_rank, ctypes.c_int32), _ptr(run_len, ctypes.c_int64),
            ctypes.c_int32(0))

        n_runs_per = np.diff(run_ptr)
        rec_of_run = np.repeat(np.arange(len(starts), dtype=np.int64), n_runs_per)
        cs = np.cumsum(run_len) - run_len
        # within-record exclusive position of each run (empty records repeat 0x)
        safe_starts = np.minimum(run_ptr[:-1], max(len(run_len) - 1, 0))
        run_cum = cs - np.repeat(cs[safe_starts] if len(run_len) else
                                 np.zeros(len(safe_starts), np.int64), n_runs_per)
        occ_before = _segmented_exclusive_cumsum(
            run_len, (rec_of_run << 32) | run_rank.astype(np.int64))
        return cls(offset=g.offset, edge_ptr=edge_ptr, edge_node=edge_node,
                   edge_off=edge_off, run_ptr=run_ptr, run_rank=run_rank,
                   run_len=run_len, run_cum=run_cum, occ_before=occ_before)

    def lf(self, comps: np.ndarray, offs: np.ndarray):
        """Vectorized LF: (record comp, offset) -> (successor node, offset)."""
        comps = np.asarray(comps, np.int64)
        offs = np.asarray(offs, np.int64)
        # per-element binary search over each record's run_cum slice (a
        # global searchsorted would leak across record boundaries): j ends as
        # the last run of its record with run_cum <= off
        j = self.run_ptr[comps].copy()
        hi = self.run_ptr[comps + 1].copy()
        top = max(len(self.run_cum) - 1, 0)
        while True:
            live = hi - j > 1
            if not live.any():
                break
            mid = (j + hi) >> 1
            take = self.run_cum[np.minimum(mid, top)] <= offs
            j = np.where(live & take, mid, j)
            hi = np.where(live & ~take, mid, hi)
        e = self.edge_ptr[comps] + self.run_rank[j].astype(np.int64)
        return (self.edge_node[e],
                self.edge_off[e] + self.occ_before[j] + (offs - self.run_cum[j]))

    def first_nodes(self, seq_ids: np.ndarray) -> np.ndarray:
        """First path node of each sequence: one LF on record 0."""
        node, _ = self.lf(np.zeros(len(seq_ids), np.int64),
                          np.asarray(seq_ids, np.int64))
        return node

    def extract_all(self, seq_ids) -> tuple[np.ndarray, np.ndarray]:
        """Node visits of every sequence (gbwt::GBWT::extract), concatenated:
        (visits, ptr) with sequence s at visits[ptr[s]:ptr[s+1]], by the
        native walker (two passes: lengths, then the visits)."""
        lib = native.get_lib()
        seq_ids = np.ascontiguousarray(seq_ids, np.int64)
        args = (
            _ptr(self.edge_ptr, ctypes.c_int64), _ptr(self.edge_node, ctypes.c_int64),
            _ptr(self.edge_off, ctypes.c_int64), _ptr(self.run_ptr, ctypes.c_int64),
            _ptr(self.run_rank, ctypes.c_int32), _ptr(self.run_cum, ctypes.c_int64),
            _ptr(self.occ_before, ctypes.c_int64), ctypes.c_int64(self.offset),
            _ptr(seq_ids, ctypes.c_int64), ctypes.c_int64(len(seq_ids)),
        )
        counts = np.zeros(len(seq_ids), np.int64)
        unused = _ptr(counts, ctypes.c_int64)  # the slots the first pass skips
        lib.panindex_gbwt_extract(*args, _ptr(counts, ctypes.c_int64), unused,
                                  unused, ctypes.c_int32(0), ctypes.c_int32(0))
        ptr = np.concatenate(([0], np.cumsum(counts)))
        visits = np.zeros(ptr[-1], np.int64)
        lib.panindex_gbwt_extract(*args, _ptr(counts, ctypes.c_int64),
                                  _ptr(ptr, ctypes.c_int64), _ptr(visits, ctypes.c_int64),
                                  ctypes.c_int32(1), ctypes.c_int32(0))
        return visits, ptr

    def component_labels(self, first_node: int, n_nodes: int) -> np.ndarray:
        """Weakly-connected-component representative (smallest member graph
        node id) for graph nodes [first_node, first_node + n_nodes), from the
        successor edges of all records."""
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        src_comp = np.repeat(np.arange(self.n_rec, dtype=np.int64), np.diff(self.edge_ptr))
        src_node = np.where(src_comp == 0, 0, src_comp + self.offset)
        dst_node = self.edge_node
        keep = (src_node != 0) & (dst_node != 0)
        u = (src_node[keep] >> 1) - first_node
        v = (dst_node[keep] >> 1) - first_node
        m = coo_matrix((np.ones(len(u), np.int8), (u, v)), shape=(n_nodes, n_nodes))
        _, labels = connected_components(m, directed=True, connection="weak")
        reps = np.full(int(labels.max()) + 1 if len(labels) else 1, np.iinfo(np.int64).max)
        np.minimum.at(reps, labels, np.arange(n_nodes, dtype=np.int64) + first_node)
        return reps[labels]
