"""The port's tag merge against the JAX package's, exactly: the streamed
readers of .tags files (every format, wrapped or not), the sequence of each
BWT row, the host merges (resident and streamed in windows), the device
merge on the CPU (the kernel's plain version, merge_rows_plain) against the
JAX scan-merge on meshes of 1 and 4 CPU devices, merge_rows_plain at its
edges, and the merged tags against the direct whole-genome build. The
graphs come from the JAX package's generators, from a seed."""

import jax
import numpy as np
import pytest
import torch

from pangenome_index_tpu.core import merge as jmerge
from pangenome_index_tpu.core import tagbuild as jtagbuild
from pangenome_index_tpu.formats import gbz as jgbz
from pangenome_index_tpu.formats import gbz_write as jgbz_write
from pangenome_index_tpu.formats import rlbwt as jrlbwt
from pangenome_index_tpu.formats import tags_stream as jtags_stream
from pangenome_index_tpu.models import rindex as jrindex
from pangenome_index_tpu.models import tagarray as jtagarray
from pangenome_index_tpu.parallel import merge as jparallel_merge
from pangenome_index_tpu.parallel.sharding import make_mesh
from pangenome_index_tpu.utils import synth as jsynth
from pangenome_index_tpu_torch import native
from pangenome_index_tpu_torch.core import merge, tagbuild
from pangenome_index_tpu_torch.formats import gbz, rlbwt, tags as tagfmt, tags_stream
from pangenome_index_tpu_torch.models import rindex
from pangenome_index_tpu_torch.models.tagarray import TagArray
from pangenome_index_tpu_torch.ops.merge import TILE, merge_rows, merge_rows_plain


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def text_lines(g):
    return [b"".join(jgbz.node_seq(g, nd >> 1, bool(nd & 1)) for nd in g.index.extract(s))
            for s in range(g.index.sequences)]


def indexes(g):
    """Both packages' r-indexes (suffix array kept) of a graph's text."""
    bwt = native.build_bwt_native(text_lines(g))[0].tobytes()
    return (rindex.build_rindex(rlbwt.rlbwt_from_text(bwt), keep_sa=True),
            jrindex.build_rindex(jrlbwt.rlbwt_from_text(bwt), keep_sa=True))


@pytest.fixture(scope="module")
def genome():
    """Three synthetic chromosomes: the whole genome's graph (JAX and port
    parse of its file) and index, each component's tag array (the JAX
    build on its own graph and text) keyed by its representative, and the
    direct whole-genome tag build."""
    whole, subs, _ = jsynth.synth_multi_component_gbz(6000, 3, n_comps=3,
                                                      site_rate=0.01, seed=11)
    data = jgbz_write.write_gbz(whole)
    jg, g = jgbz.parse_gbz(data), gbz.parse_gbz(data)
    idx, jidx = indexes(jg)
    comps = jmerge.node_components(jg)
    comp_tags = {}
    for sub in subs:
        sub_g = jgbz.parse_gbz(jgbz_write.write_gbz(sub))
        t = jtagbuild.build_tags(sub_g, indexes(sub_g)[1])
        comp_tags[comps[int(t.pos_enc[0]) >> 11]] = TagArray.from_runs(t.pos_enc,
                                                                      t.run_lengths())
    return dict(g=g, jg=jg, idx=idx, jidx=jidx, comp_tags=comp_tags,
                direct=jtagbuild.build_tags(jg, jidx))


def jax_tags(t):
    return jtagarray.TagArray.from_runs(t.pos_enc, t.run_lengths())


def tag_files(tmp_path, t):
    """The tag array in every format the merge reads: algorithm, compressed
    sdsl, compressed bytecode (full and compact values), each bare and
    wrapped."""
    payloads = {"algorithm": tagfmt.write_algorithm(t),
                "sdsl": tagfmt.write_compressed_sdsl(t),
                "bytecode": tagfmt.write_compressed_bytecode(t),
                "bytecode-compact": tagfmt.write_compressed_bytecode(t, compact=True)}
    paths = {}
    for fmt, data in payloads.items():
        for wrapped in (False, True):
            path = tmp_path / f"{fmt}{'-wrapped' if wrapped else ''}.tags"
            path.write_bytes(tagfmt.wrap_payload(data, fmt) if wrapped else data)
            paths[path.stem] = path
    return paths


@pytest.fixture(scope="module")
def stream_tags():
    """Runs of lengths 1 to 1500 (past the 511 split) over large and small
    node ids."""
    rng = np.random.default_rng(3)
    nodes = rng.integers(1, 1 << 20, 1000)
    vals = (nodes << 11) | (rng.integers(0, 2, 1000) << 10) | rng.integers(0, 1024, 1000)
    return TagArray.from_runs(vals, rng.integers(1, 1500, 1000))


@pytest.mark.parametrize("chunk_runs", [2, 7, 1000, 1 << 20])
def test_tag_run_stream_matches_jax(stream_tags, tmp_path, chunk_runs):
    """TagRunStream reads every format's file, wrapped or not, in the JAX
    reader's chunks (format, first position, every chunk's runs), and
    their runs are the tag array's. A bare compact-bytecode file reads as
    full bytecode in both (the formats carry no magic: the wrapper or the
    caller names it), so its runs are only held against the JAX reader."""
    for stem, path in tag_files(tmp_path, stream_tags).items():
        p = tags_stream.TagRunStream(path, chunk_runs=chunk_runs)
        j = jtags_stream.TagRunStream(path, chunk_runs=chunk_runs)
        assert p.fmt == j.fmt
        assert p.peek_first_pos() == j.peek_first_pos()
        vals, lens = [], []
        while True:
            (pv, pl), (jv, jl) = p.read_runs(), j.read_runs()
            same(pv, jv)
            same(pl, jl)
            if not len(pv):
                break
            vals.append(pv)
            lens.append(pl)
        p.close()
        j.close()
        if stem == "bytecode-compact":
            assert p.fmt == "bytecode"
            continue
        back = TagArray.from_runs(np.concatenate(vals), np.concatenate(lens))
        same(np.repeat(back.pos_enc, back.run_lengths()),
             np.repeat(stream_tags.pos_enc, stream_tags.run_lengths()))


@pytest.mark.parametrize("chunk_runs", [3, 1 << 20])
def test_position_cursor_matches_jax(stream_tags, tmp_path, chunk_runs):
    """PositionCursor.take(k) for random k (0 included) gives the JAX
    cursor's positions and `remaining`, to the end of the stream; past it
    both raise."""
    rng = np.random.default_rng(chunk_runs)
    total = stream_tags.total
    for stem in ("sdsl", "bytecode-compact-wrapped", "algorithm"):
        path = tag_files(tmp_path, stream_tags)[stem]
        p = tags_stream.PositionCursor(tags_stream.TagRunStream(path, chunk_runs=chunk_runs))
        j = jtags_stream.PositionCursor(jtags_stream.TagRunStream(path, chunk_runs=chunk_runs))
        taken = 0
        while taken < total:
            k = int(min(rng.integers(0, 3000), total - taken))
            same(p.take(k), j.take(k))
            taken += k
            assert p.remaining == j.remaining
        assert p.remaining == j.remaining == 0
        with pytest.raises(ValueError):
            p.take(1)


def test_seq_of_rows_matches_jax(genome):
    """The sequence of every BWT row by locateNext chains: the JAX result
    and the suffix array's sequences."""
    got = merge.seq_of_rows(genome["idx"])
    same(got, jmerge.seq_of_rows(genome["jidx"]))
    same(got, genome["idx"].sa_seq)


def test_components_match_jax(genome):
    """The node components and each sequence's component."""
    c, jc = merge.node_components(genome["g"]), jmerge.node_components(genome["jg"])
    same(c.labels, jc.labels)
    assert c.first == jc.first
    assert [c[n] for n in c.first + np.arange(len(c.labels))] == jc.labels.tolist()
    n_seq = genome["idx"].n_seq
    same(merge._seq_components(genome["g"], c, n_seq),
         jmerge._seq_components(genome["jg"], jc, n_seq))


def merged_equal(got, want):
    same(got.pos_enc, want.pos_enc)
    same(got.bwt_start, want.bwt_start)
    assert got.total == want.total


@pytest.mark.parametrize("how", ["resident", "window-97", "window-4096",
                                 "window-97-cursors"])
def test_host_merges_match_jax(genome, tmp_path, how):
    """merge_tags and merge_tags_streamed (windows of 97 and 4096 rows, on
    the tag arrays and on file cursors of mixed formats) give the JAX
    merge's runs."""
    g, idx, comp_tags = genome["g"], genome["idx"], genome["comp_tags"]
    want = jmerge.merge_tags(genome["jg"], genome["jidx"],
                             {c: jax_tags(t) for c, t in comp_tags.items()})
    if how == "resident":
        got = merge.merge_tags(g, idx, comp_tags)
    elif how.endswith("cursors"):
        cursors = {}
        for i, (c, t) in enumerate(sorted(comp_tags.items())):
            sub = tmp_path / str(i)
            sub.mkdir()
            path = tag_files(sub, t)[("algorithm", "sdsl-wrapped", "bytecode")[i]]
            cursors[c] = tags_stream.PositionCursor(tags_stream.TagRunStream(path,
                                                                             chunk_runs=5))
        got = merge.merge_tags_streamed(g, idx, cursors, window=97)
    else:
        got = merge.merge_tags_streamed(g, idx, comp_tags, window=int(how.split("-")[1]))
    merged_equal(got, want)


@pytest.mark.parametrize("n_data", [1, 4])
def test_device_merge_on_the_cpu_matches_jax(genome, n_data):
    """merge_tags_on_device(device="cpu") (the kernel's plain version) gives
    the JAX scan-merge's runs on a mesh of 1 and of 4 CPU devices."""
    if len(jax.devices()) < n_data:
        pytest.skip(f"needs {n_data} JAX devices")
    comp_tags = genome["comp_tags"]
    want = jmerge.merge_tags_on_device(genome["jg"], genome["jidx"],
                                       {c: jax_tags(t) for c, t in comp_tags.items()},
                                       mesh=make_mesh(n_data, 1))
    merged_equal(merge.merge_tags_on_device(genome["g"], genome["idx"], comp_tags, "cpu"),
                 want)


def test_merges_equal_the_direct_build(genome):
    """Every merge's positions from row n_seq on equal the direct
    whole-genome build_tags of the whole graph; the endmarker rows are 0."""
    direct = genome["direct"]
    want = np.repeat(direct.pos_enc, direct.run_lengths())
    n_seq = genome["idx"].n_seq
    marks = []
    for got in (merge.merge_tags(genome["g"], genome["idx"], genome["comp_tags"]),
                merge.merge_tags_on_device(genome["g"], genome["idx"],
                                           genome["comp_tags"], "cpu",
                                           mark=marks.append)):
        per_pos = np.repeat(got.pos_enc, got.run_lengths())
        assert not per_pos[:n_seq].any()
        same(per_pos[n_seq:], want)
    assert marks == ["route", "rows", "rle"]


def test_device_merge_refuses_a_short_stream(genome):
    """A component whose stream does not cover its rows: ValueError before
    any launch, as in the JAX merge."""
    comp_tags = dict(genome["comp_tags"])
    c = sorted(comp_tags)[1]
    t = comp_tags[c]
    comp_tags[c] = TagArray.from_runs(t.pos_enc[:-1], t.run_lengths()[:-1])
    with pytest.raises(ValueError, match=f"component {c}"):
        merge.merge_tags_on_device(genome["g"], genome["idx"], comp_tags, "cpu")


def by_definition(comp, stream, offsets):
    """tag[i] = stream[offsets[c] + #{j < i: comp[j] = c}], 0 where c is
    outside [0, C): a loop over the rows."""
    C = len(offsets) - 1
    seen = np.zeros(max(C, 1), np.int64)
    out = np.zeros(len(comp), np.int64)
    for i, c in enumerate(comp):
        if 0 <= c < C:
            out[i] = stream[offsets[c] + seen[c]]
            seen[c] += 1
    return out


def well_formed(comp, C, rng):
    counts = np.bincount(comp[(comp >= 0) & (comp < C)], minlength=C)
    offsets = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    return offsets, rng.integers(0, 1 << 40, int(offsets[-1])).astype(np.int64)


EDGES = {
    "one-row": (np.array([0]), 1),
    "one-endmarker": (np.array([-1]), 1),
    "every-row-minus-one": (np.full(3 * TILE + 5, -1), 3),
    "one-component": (np.zeros(TILE + 1, np.int64), 1),
    "no-components": (np.full(17, -1), 0),
    "rare-component": (None, 3),
    "random": (None, 5),
    "tile-edges": (None, 2),
}


@pytest.mark.parametrize("case", list(EDGES))
def test_merge_rows_plain_edges(case):
    """merge_rows_plain (the CPU form of merge_rows) by the definition, at
    its edges: one row; every row -1; one component; no component; a
    component absent from most tiles; random interleavings; one below, at
    and one above a tile."""
    rng = np.random.default_rng(len(case))
    comp, C = EDGES[case]
    if case == "rare-component":
        comp = rng.integers(0, 2, 5 * TILE)
        comp[rng.choice(comp.size, 7, replace=False)] = 2
        comp[: 11] = -1
    elif case == "random":
        comp = rng.integers(-1, C, 3 * TILE + 77)
    cases = [comp] if case != "tile-edges" else [
        rng.integers(-1, C, n) for n in (TILE - 1, TILE, TILE + 1)]
    for comp in cases:
        comp = comp.astype(np.int32)
        offsets, stream = well_formed(comp, C, rng)
        got = merge_rows(*(torch.from_numpy(a) for a in (comp, stream, offsets)))
        assert got.dtype == torch.int64
        same(got.numpy(), by_definition(comp, stream, offsets))
        same(merge_rows_plain(*(torch.from_numpy(a) for a in (comp, stream, offsets))).numpy(),
             got.numpy())


def test_merge_rows_plain_matches_jax_make_device_merge():
    """merge_rows_plain against the JAX make_device_merge step (through
    merge_tags_device on one CPU device) on random interleavings of 4
    components with rows of none."""
    rng = np.random.default_rng(8)
    reps = np.array([3, 17, 40, 1000])
    comp_per_row = rng.choice(np.array([-1, *reps]), 5000)
    streams = {int(c): rng.integers(0, 1 << 30, int((comp_per_row == c).sum()))
               for c in reps}
    want = jparallel_merge.merge_tags_device(make_mesh(1, 1), comp_per_row, streams)
    labels = np.searchsorted(reps, comp_per_row).astype(np.int32)
    labels[comp_per_row < 0] = -1
    offsets = np.concatenate(([0], np.cumsum([len(streams[int(c)]) for c in reps])))
    flat = np.concatenate([streams[int(c)] for c in reps]).astype(np.int64)
    got = merge_rows(torch.from_numpy(labels), torch.from_numpy(flat),
                     torch.from_numpy(offsets.astype(np.int64)))
    same(got.numpy(), np.asarray(want).astype(np.int64))


def test_merge_rows_refuses_bad_shapes():
    with pytest.raises(ValueError):
        merge_rows(torch.zeros((2, 2), dtype=torch.int32), torch.zeros(0, dtype=torch.int64),
                   torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError):
        merge_rows(torch.zeros(2, dtype=torch.int32), torch.zeros(0, dtype=torch.int64),
                   torch.zeros(0, dtype=torch.int64))
