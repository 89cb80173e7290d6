"""GBZ container parser: GBWT + GBWTGraph (simple-sds format).

The port's copy of pangenome_index_tpu/formats/gbz.py. It parses the
container from scratch and exposes what the graph commands need:

* GBWT: the record-compressed path index; `extract(seq_id)` gives the node
  visits of a path, `table()` every record decoded once into flat arrays
  (formats/gbwt_table.py)
* GBWTGraph: the node sequences
* Metadata: path, sample and contig names

GBWT node ids encode (graph node, orientation) as 2*node + is_reverse;
record i covers gbwt node i == 0 ? 0 : i + offset.

Record byte format (gbwt Run/ByteCode codecs):
  [outdegree sigma: varint]
  sigma x [successor node delta: varint][successor BWT offset: varint]
  runs: if sigma < 255 one byte encodes (edge_rank, len) as rank + sigma*(len-1)
        with lengths >= 256//sigma spilling to a varint extension; else
        varint pairs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .simple_sds import Reader

GBZ_TAG = 0x205A4247
GBWT_TAG = 0x6B376B37
GRAPH_TAG = 0x6B3764AF
META_TAG = 0x6B375E7A


def _bytecode(d, o):
    v, sh = 0, 0
    while True:
        b = d[o]
        o += 1
        v |= (b & 0x7F) << sh
        sh += 7
        if not (b & 0x80):
            return v, o


@dataclass
class Record:
    sigma: int
    edges: list[tuple[int, int]]     # (successor gbwt node id, bwt offset)
    runs: list[tuple[int, int]]      # (edge rank, length)

    def lf(self, offset: int) -> tuple[int, int]:
        """Map (this record, offset) -> (successor node, successor offset)."""
        occ = [0] * self.sigma
        pos = 0
        for c, l in self.runs:
            if pos + l > offset:
                node, off = self.edges[c]
                return node, off + occ[c] + offset - pos
            occ[c] += l
            pos += l
        raise IndexError(f"offset {offset} beyond record (size {pos})")


def parse_record(data: bytes, start: int, end: int) -> Record:
    o = start
    sigma, o = _bytecode(data, o)
    edges = []
    prev = 0
    for _ in range(sigma):
        dn, o = _bytecode(data, o)
        prev += dn
        off, o = _bytecode(data, o)
        edges.append((prev, off))
    runs = []
    rc = (256 // sigma) if 0 < sigma < 255 else 0
    while o < end and sigma > 0:
        if sigma >= 255:
            c, o = _bytecode(data, o)
            l, o = _bytecode(data, o)
            l += 1
        else:
            byteval = data[o]
            o += 1
            c = byteval % sigma
            l = byteval // sigma + 1
            if l == rc:
                ext, o = _bytecode(data, o)
                l += ext
        runs.append((c, l))
    return Record(sigma, edges, runs)


@dataclass
class GBWT:
    sequences: int
    size: int
    offset: int
    alphabet_size: int
    flags: int
    record_starts: np.ndarray
    bwt_data: bytes
    tags: list[bytes] = field(default_factory=list)
    path_names: np.ndarray | None = None      # [paths, 4] sample/contig/phase/count
    sample_names: list[bytes] = field(default_factory=list)
    contig_names: list[bytes] = field(default_factory=list)
    haplotype_count: int = 0

    FLAG_BIDIRECTIONAL = 0x1

    def node_to_comp(self, node: int) -> int:
        return 0 if node == 0 else node - self.offset

    def record(self, node: int) -> Record:
        comp = self.node_to_comp(node)
        s = int(self.record_starts[comp])
        e = (int(self.record_starts[comp + 1]) if comp + 1 < len(self.record_starts)
             else len(self.bwt_data))
        return parse_record(self.bwt_data, s, e)

    def table(self):
        """The flat decoded-record table (formats/gbwt_table.RecordTable),
        decoded once and cached: the array form of all records that every
        build phase uses."""
        t = getattr(self, "_table", None)
        if t is None:
            from .gbwt_table import RecordTable

            t = RecordTable.from_gbwt(self)
            object.__setattr__(self, "_table", t)
        return t

    def extract(self, seq_id: int) -> list[int]:
        """Node visits of sequence seq_id (gbwt::GBWT::extract). For a
        bidirectional GBWT, sequence 2p is path p forward, 2p+1 reverse."""
        out = []
        node, off = self.record(0).lf(seq_id)
        cache: dict[int, Record] = {}
        while node != 0:
            out.append(node)
            r = cache.get(node)
            if r is None:
                r = cache[node] = self.record(node)
            node, off = r.lf(off)
        return out


@dataclass
class GBWTGraph:
    nodes: int                   # number of node records (2 per graph node)
    flags: int
    sequences: list[bytes]       # forward sequence per graph node id from the first
    node_ids: np.ndarray         # graph node id per sequences entry
    segments: list[bytes] = field(default_factory=list)
    node_to_segment: tuple | None = None


@dataclass
class GBZ:
    tags: list[bytes]
    index: GBWT
    graph: GBWTGraph


REVCOMP = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def node_seq(gbz: GBZ, node_id: int, is_rev: bool) -> bytes:
    s = gbz.graph.sequences[int(node_id) - int(gbz.graph.node_ids[0])]
    return s.translate(REVCOMP)[::-1] if is_rev else s


def parse_gbwt(r: Reader) -> GBWT:
    tag_ver = r.u64()
    if tag_ver & 0xFFFFFFFF != GBWT_TAG:
        raise ValueError(f"bad GBWT tag {tag_ver:#x}")
    sequences = r.u64()
    size = r.u64()
    offset = r.u64()
    alphabet_size = r.u64()
    flags = r.u64()
    tags = r.string_array()
    _, rec_starts = r.sparse_vector()
    bwt_data = r.byte_vector()
    r.option_raw()  # document array samples (unused here)
    g = GBWT(sequences=sequences, size=size, offset=offset,
             alphabet_size=alphabet_size, flags=flags,
             record_starts=rec_starts, bwt_data=bwt_data, tags=tags)
    meta_bytes = r.option_raw()  # metadata is an Option
    if meta_bytes:
        r = Reader(meta_bytes)
        meta_tag = r.u64()
        if meta_tag & 0xFFFFFFFF != META_TAG:
            raise ValueError(f"bad metadata tag {meta_tag:#x}")
        r.u64()  # sample count
        g.haplotype_count = r.u64()
        r.u64()  # contig count
        mflags = r.u64()
        # path names: Vector of PathName {u32 sample, u32 contig, u32 phase, u32 count}
        n_paths = r.u64()
        raw = np.frombuffer(r.bytes_padded(n_paths * 16), "<u4").reshape(n_paths, 4)
        g.path_names = raw.astype(np.int64)
        if mflags & 0x2:  # sample names present
            g.sample_names = r.dictionary()
        if mflags & 0x4:  # contig names present
            g.contig_names = r.dictionary()
    return g


def parse_graph(r: Reader, gbwt: GBWT) -> GBWTGraph:
    tag_ver = r.u64()
    if tag_ver & 0xFFFFFFFF != GRAPH_TAG:
        raise ValueError(f"bad GBWTGraph tag {tag_ver:#x}")
    nodes = r.u64()
    flags = r.u64()
    # forward sequence per graph node id in [first, first + entries)
    seqs = r.string_array()
    segments: list[bytes] = []
    node_to_segment = None
    if flags & 0x1:  # segment translation present
        segments = r.string_array()
        node_to_segment = r.sparse_vector()
    first_node = (gbwt.offset + 1) // 2 if gbwt.offset else 1
    node_ids = np.arange(len(seqs), dtype=np.int64) + first_node
    return GBWTGraph(nodes=nodes, flags=flags, sequences=seqs, node_ids=node_ids,
                     segments=segments, node_to_segment=node_to_segment)


def parse_gbz(data: bytes) -> GBZ:
    r = Reader(data)
    magic = r.u64()
    if magic & 0xFFFFFFFF != GBZ_TAG:
        raise ValueError(f"bad GBZ tag {magic:#x}")
    r.u64()  # flags
    tags = r.string_array()
    gbwt = parse_gbwt(r)
    graph = parse_graph(r, gbwt)
    return GBZ(tags=tags, index=gbwt, graph=graph)


def load_gbz(path) -> GBZ:
    with open(path, "rb") as fh:
        return parse_gbz(fh.read())
