"""merge_tags: combine per-chromosome tag arrays into whole-genome tags.

The port's copy of pangenome_index_tpu/core/merge.py (the merge-tags
command). The reference (src/merge_tags.cpp) walks windows of the
whole-genome r-index with locateNext, routes every BWT position to its
component's tag file and re-run-length-encodes. The invariant it exploits:
restricted to one component, whole-genome BWT rows appear in the same
relative order as that component's own BWT rows, so each per-chromosome
tag stream is consumed strictly in order.

  1. the sequence of every BWT row by run-parallel locateNext chains
  2. the component of every sequence: weakly connected components of the
     GBWT record edges, and the first node of each path
  3. each row's rank within its component picks its tag from that
     component's stream; endmarker rows get tag 0 (merge_tags.cpp:620-624)
  4. RLE, 511-splitting, and the compact width 11 + bits(max node id)
     (merge_tags.cpp:630-638)

Step 3 runs on the host in order (merge_tags, merge_tags_streamed), or as
one kernel on a torch device (merge_tags_on_device: ops/merge.py).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..formats.gbz import GBZ
from ..models.rindex import RIndex
from ..models.tagarray import TagArray
from .tagbuild import rle, text_seq_map


def seq_of_rows(idx: RIndex) -> np.ndarray:
    """Sequence id of every BWT row by run-parallel locateNext chains."""
    out = np.zeros(idx.n, dtype=np.int64)
    cur = idx.samples.copy()
    lens = idx.run_len
    active = np.ones(idx.n_runs, dtype=bool)
    t = 0
    while active.any():
        out[idx.run_start[active] + t] = cur[active] // idx.max_len
        t += 1
        active = active & (lens > t)
        if active.any():
            cur[active] = idx.locate_next(cur[active])
    return out


class NodeComponents:
    """Array-backed node -> component-representative map (the smallest
    member graph node id), from the decoded record table's successor edges
    (gbwt_table.component_labels; the semantics of
    gbwtgraph::weakly_connected_components, algorithm.hpp:600-618)."""

    def __init__(self, gbz: GBZ):
        self.first = int(gbz.graph.node_ids[0])
        self.labels = gbz.index.table().component_labels(
            self.first, len(gbz.graph.node_ids))

    def __getitem__(self, node_id: int) -> int:
        return int(self.labels[int(node_id) - self.first])


def node_components(gbz: GBZ) -> NodeComponents:
    """Weakly-connected components over the graph's edges, the smallest
    node id as representative."""
    return NodeComponents(gbz)


def _seq_components(gbz: GBZ, comp_of_node: NodeComponents, n_seq: int) -> np.ndarray:
    """Component of each text sequence, by the first node of its path (one
    vectorized LF on record 0; merge_tags.cpp:508-515 walks the whole path)."""
    seq_map = np.array(text_seq_map(gbz, n_seq), np.int64)
    firsts = gbz.index.table().first_nodes(seq_map)
    return comp_of_node.labels[(firsts >> 1) - comp_of_node.first]


def merge_tags(gbz: GBZ, idx: RIndex, comp_tags: dict[int, TagArray]) -> TagArray:
    """comp_tags: component representative -> that component's tag array
    (algorithm coordinates: positions for the component's non-endmarker rows
    in its own BWT order)."""
    n, n_seq = idx.n, idx.n_seq
    seq_comp = _seq_components(gbz, node_components(gbz), n_seq)
    comp_per_row = seq_comp[seq_of_rows(idx)]
    tag_per_row = np.zeros(n, dtype=np.int64)
    rows = np.arange(n_seq, n)
    crows = comp_per_row[rows]
    for c in sorted(comp_tags):
        mask = crows == c
        stream = comp_tags[c]
        per_pos = np.repeat(stream.pos_enc, stream.run_lengths())
        if mask.sum() != len(per_pos):
            raise ValueError(
                f"component {c}: {mask.sum()} rows but stream covers {len(per_pos)}")
        tag_per_row[rows[mask]] = per_pos
    return TagArray.from_runs(*rle(tag_per_row))


class _StreamCursor:
    """Sequential consumer of one component's run-level tag stream: the BWT
    order invariant means each stream is only read forward, so a cursor
    into the run arrays suffices; `take(k)` materializes exactly the k
    consumed positions."""

    def __init__(self, tags: TagArray):
        self.vals = tags.pos_enc
        self.cum = np.concatenate(([0], np.cumsum(tags.run_lengths())))
        self.consumed = 0

    @property
    def remaining(self) -> int:
        return int(self.cum[-1]) - self.consumed

    def take(self, k: int) -> np.ndarray:
        a, b = self.consumed, self.consumed + int(k)
        if b > self.cum[-1]:
            raise ValueError(
                f"tag stream exhausted: need {b} positions, have {self.cum[-1]}")
        i0 = int(np.searchsorted(self.cum, a, side="right")) - 1
        i1 = int(np.searchsorted(self.cum, b, side="left"))
        reps = np.minimum(self.cum[i0 + 1 : i1 + 1], b) - np.maximum(self.cum[i0:i1], a)
        self.consumed = b
        return np.repeat(self.vals[i0:i1], reps)


def merge_tags_streamed(gbz: GBZ, idx: RIndex, comp_tags: dict, window: int = 1 << 22
                        ) -> TagArray:
    """Bounded-memory merge, the output of `merge_tags`: the BWT is walked in
    run batches of ~`window` rows (lane-per-run locateNext chains restricted
    to the batch), each component stream is consumed through a cursor, and
    runs are RLE-carried across batch boundaries; O(window + output runs)
    memory. comp_tags values are TagArrays or cursors with take(k) and
    `remaining` (formats/tags_stream.PositionCursor)."""
    n, n_seq, r = idx.n, idx.n_seq, idx.n_runs
    seq_comp = _seq_components(gbz, node_components(gbz), n_seq)
    cursors = {c: (_StreamCursor(t) if isinstance(t, TagArray) else t)
               for c, t in comp_tags.items()}

    out_vals: list[np.ndarray] = []
    out_lens: list[np.ndarray] = []
    prev_val, prev_len = None, 0
    j0 = 0
    while j0 < r:
        row0 = int(idx.run_start[j0])
        j1 = max(int(np.searchsorted(idx.run_start, row0 + window, side="left")), j0 + 1)
        row1 = int(idx.run_start[j1]) if j1 < r else n
        W = row1 - row0
        # sequence of each batch row by lane-per-run locateNext
        lens_b = idx.run_len[j0:j1]
        starts_b = idx.run_start[j0:j1] - row0
        cur = idx.samples[j0:j1].copy()
        srows_w = np.zeros(W, dtype=np.int64)
        active = np.ones(j1 - j0, dtype=bool)
        t = 0
        while active.any():
            srows_w[starts_b[active] + t] = cur[active] // idx.max_len
            t += 1
            active = active & (lens_b > t)
            if active.any():
                cur[active] = idx.locate_next(cur[active])
        # rows to component streams; endmarker rows tag 0 (merge_tags.cpp:620-624)
        tag_w = np.zeros(W, dtype=np.int64)
        body = np.arange(W)[row0 + np.arange(W) >= n_seq]
        comp_w = seq_comp[srows_w[body]]
        for c in np.unique(comp_w):
            if int(c) not in cursors:
                raise ValueError(f"no tag stream for component {c}")
            mask = comp_w == c
            tag_w[body[mask]] = cursors[int(c)].take(int(mask.sum()))
        vals_w, lens_w = rle(tag_w)
        if prev_val is not None and len(vals_w) and vals_w[0] == prev_val:
            lens_w = lens_w.copy()
            lens_w[0] += prev_len
        elif prev_val is not None:
            out_vals.append(np.array([prev_val], np.int64))
            out_lens.append(np.array([prev_len], np.int64))
        if len(vals_w):
            out_vals.append(vals_w[:-1])
            out_lens.append(lens_w[:-1])
            prev_val, prev_len = int(vals_w[-1]), int(lens_w[-1])
        j0 = j1
    if prev_val is not None:
        out_vals.append(np.array([prev_val], np.int64))
        out_lens.append(np.array([prev_len], np.int64))
    for c, cur_ in cursors.items():
        if cur_.remaining:
            raise ValueError(f"component {c}: {cur_.remaining} unconsumed tag positions")
    return TagArray.from_runs(np.concatenate(out_vals), np.concatenate(out_lens))


def _no_mark(name: str) -> None:
    pass


def device_merge_inputs(gbz: GBZ, idx: RIndex, comp_tags: dict[int, TagArray]):
    """What the device merge takes, from the host's routing: (comp int32 [n],
    each row's dense component label in the order of the component
    representatives, -1 for endmarker rows and rows of a component with no
    stream, as parallel/merge.py relabels; stream int64 [t], the streams'
    per-position tags in that order; offsets int64 [C + 1], their starts).
    Each component's row count must equal its stream's length (ValueError)."""
    seq_comp = _seq_components(gbz, node_components(gbz), idx.n_seq)
    comp_per_row = seq_comp[seq_of_rows(idx)].astype(np.int64)
    comp_per_row[: idx.n_seq] = -1  # endmarker rows -> tag 0 (merge_tags.cpp:620-624)
    comps = np.array(sorted(comp_tags), np.int64)
    # one lookup for every row (the JAX wrapper loops over the rows)
    j = np.minimum(np.searchsorted(comps, comp_per_row), max(len(comps) - 1, 0))
    labels = (np.where(comps[j] == comp_per_row, j, -1) if len(comps)
              else np.full(idx.n, -1)).astype(np.int32)
    rows_of = np.bincount(labels[labels >= 0], minlength=len(comps))
    streams = []
    for i, c in enumerate(comps.tolist()):
        t = comp_tags[c]
        per_pos = np.repeat(t.pos_enc, t.run_lengths())
        if int(rows_of[i]) != len(per_pos):
            raise ValueError(
                f"component {c}: {int(rows_of[i])} rows but stream covers {len(per_pos)}")
        streams.append(per_pos)
    offsets = np.zeros(len(comps) + 1, np.int64)
    np.cumsum([len(s) for s in streams], out=offsets[1:])
    return labels, np.concatenate(streams).astype(np.int64), offsets


def _no_mark(name: str) -> None:
    pass


def merge_tags_on_device(gbz: GBZ, idx: RIndex, comp_tags: dict[int, TagArray],
                         device="cuda", mark=_no_mark, mesh=None) -> TagArray:
    """The device merge, the output of `merge_tags`: each row's rank within
    its component and the gather of its tag as one kernel on `device`
    (ops/merge.py:merge_rows; its plain version on the CPU), or, on a mesh
    of more than one data shard (parallel/sharding.py:Mesh), the cross-card
    form: each rank merges its range of the rows (ops/merge.py:
    merge_rows_shard) and the ranges are gathered, as the JAX package's
    sharded scan. The routing (device_merge_inputs) and the RLE of the
    result stay on the host. mark(phase) is called as each phase ends:
    route, rows (the kernel with the copies to and from the device), rle."""
    import torch

    from ..ops.merge import merge_rows
    from ..parallel.merge import merge_rows_on_mesh

    inputs = device_merge_inputs(gbz, idx, comp_tags)
    mark("route")
    if mesh is not None and mesh.shape["data"] > 1:
        tag = merge_rows_on_mesh(mesh, *inputs)
    else:
        dev = torch.device(device)
        tag = merge_rows(*(torch.from_numpy(a).to(dev) for a in inputs)).cpu().numpy()
    mark("rows")
    merged = TagArray.from_runs(*rle(tag))
    mark("rle")
    return merged


def merge_tags_pipeline(gbz_path: str, ri_path: str, tags_dir: str, output: str,
                        window: int = 1 << 22, chunk_runs: int = 1 << 20,
                        engine: str = "host", device="cuda", mark=_no_mark,
                        mesh=None) -> int:
    """The merge-tags command: every `.tags` file of tags_dir (any format,
    found by its first graph position's component), merged on the host
    through file-backed cursors (engine host) or on `device` (engine
    device; across the data shards of `mesh` where it has more than one,
    rank 0 writing the file), written as compressed sdsl. mark(phase) is
    called as each phase ends (load, merge or the device merge's phases,
    write)."""
    from ..formats import ri as rifmt
    from ..formats import tags as tagfmt
    from ..formats.gbz import load_gbz
    from ..formats.tags_stream import PositionCursor, TagRunStream

    gbz = load_gbz(gbz_path)
    idx = rifmt.load_file(ri_path)
    comp_of_node = node_components(gbz)
    comp_tags: dict = {}
    for name in sorted(os.listdir(tags_dir)):
        if not name.endswith(".tags"):
            continue
        # a chunked file cursor keeps a host merge's inputs O(chunk) resident
        # (FileReader::refill_tags, merge_tags.cpp:221-245); the device merge
        # takes each stream whole
        stream = TagRunStream(os.path.join(tags_dir, name), chunk_runs=chunk_runs)
        comp = comp_of_node[stream.peek_first_pos() >> 11]
        if engine == "device":
            comp_tags[comp] = tagfmt.load_tags_file(os.path.join(tags_dir, name))
        else:
            comp_tags[comp] = PositionCursor(stream)
        print(f"{name}: component {comp} ({stream.fmt} stream)", file=sys.stderr)
    mark("load")
    if engine == "device":
        merged = merge_tags_on_device(gbz, idx, comp_tags, device, mark, mesh)
    else:
        merged = merge_tags_streamed(gbz, idx, comp_tags, window=window)
        mark("merge")
    if mesh is not None and mesh.rank != 0:
        return 0
    with open(output, "wb") as fh:
        fh.write(tagfmt.write_compressed_sdsl(
            merged, width=11 + max(int(n) for n in gbz.graph.node_ids).bit_length()))
    mark("write")
    print(f"merge-tags: {merged.n_runs} runs covering {merged.total} positions",
          file=sys.stderr)
    return 0
