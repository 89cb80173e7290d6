"""GBZ container writer (simple-sds format).

The port's copy of pangenome_index_tpu/formats/gbz_write.py, with the same
bytes (the source tags name the JAX package, as its writer's do): an
in-memory GBZ (formats/gbz.py, e.g. built by core/gbwt_build.gbz_from_graph)
as a .gbz file that formats/gbz.py reads back.
"""

from __future__ import annotations

import numpy as np

from .gbz import GBZ, GBWT_TAG, GBZ_TAG, GRAPH_TAG
from .simple_sds_write import Writer


def _gbwt_payload(g) -> bytes:
    w = Writer()
    w.u64((5 << 32) | GBWT_TAG)  # version 5
    w.u64(g.sequences)
    w.u64(g.size)
    w.u64(g.offset)
    w.u64(g.alphabet_size)
    w.u64(g.flags & 0x1 | 0x4)  # bidirectional flag preserved; simple-sds bit
    w.string_array([b"source", b"pangenome_index_tpu"])
    # BWT: record start offsets (sparse) + byte data
    universe = max(len(g.bwt_data), 1)
    w.sparse_vector(universe, np.asarray(g.record_starts, np.int64))
    w.byte_vector(bytes(g.bwt_data))
    w.option(None)  # document array samples
    w.option(None)  # metadata (synthetic graphs carry none)
    return w.getvalue()


def _graph_payload(graph) -> bytes:
    w = Writer()
    w.u64((3 << 32) | GRAPH_TAG)  # version 3
    w.u64(sum(1 for s in graph.sequences if s))
    w.u64(0x2)  # simple-sds flag, no translation
    w.string_array(list(graph.sequences))
    return w.getvalue()


def write_gbz(gbz: GBZ) -> bytes:
    w = Writer()
    w.u64((1 << 32) | GBZ_TAG)
    w.u64(0)
    w.string_array([b"source", b"pangenome_index_tpu"])
    w.buf.write(_gbwt_payload(gbz.index))
    w.buf.write(_graph_payload(gbz.graph))
    return w.getvalue()


def save_gbz(gbz: GBZ, path) -> None:
    with open(path, "wb") as fh:
        fh.write(write_gbz(gbz))
