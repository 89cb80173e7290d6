"""The port's graph modules against the JAX package's, exactly: GBZ reading
and writing (simple-sds), the GBWT built from paths, the decoded record
table, the r-index with its suffix array, the tag build (resident, chunked
and with the suffix array streamed in windows) and the k-mer coverage
statistics of build-tags --stats. Every graph is made from a seed by the
JAX package's generators, at 20,000 bp or less."""

import numpy as np
import pytest

from pangenome_index_tpu.core import anchor as janchor
from pangenome_index_tpu.core import gbwt_build as jgbwt_build
from pangenome_index_tpu.core import kmers as jkmers
from pangenome_index_tpu.core import tagbuild as jtagbuild
from pangenome_index_tpu.formats import gbwt_table as jgbwt_table
from pangenome_index_tpu.formats import gbz as jgbz
from pangenome_index_tpu.formats import gbz_write as jgbz_write
from pangenome_index_tpu.formats import rlbwt as jrlbwt
from pangenome_index_tpu.formats import simple_sds as jsds
from pangenome_index_tpu.formats import simple_sds_write as jsds_write
from pangenome_index_tpu.models import rindex as jrindex
from pangenome_index_tpu import native as jnative
from pangenome_index_tpu.utils import synth as jsynth
from pangenome_index_tpu_torch import native
from pangenome_index_tpu_torch.core import anchor, gbwt_build, kmers, tagbuild
from pangenome_index_tpu_torch.formats import gbz, gbz_write, rlbwt, simple_sds
from pangenome_index_tpu_torch.formats import simple_sds_write
from pangenome_index_tpu_torch.formats.gbwt_table import RecordTable
from pangenome_index_tpu_torch.models import rindex
from pangenome_index_tpu_torch.utils import synth

#: the graphs every case runs on: (kind, arguments)
GRAPHS = {
    "random": ("random", dict(seed=23, n_nodes=40, n_paths=3)),
    "random-one-strand": ("random", dict(seed=5, n_nodes=60, n_paths=4,
                                         bidirectional=False)),
    "synth": ("synth", dict(base_len=6000, n_haps=4, site_rate=0.01, seed=3)),
    "multi": ("multi", dict(base_len=4000, n_haps=3, n_comps=3, site_rate=0.01,
                            seed=7)),
}
INDEX_FIELDS = ("run_sym", "run_start", "run_len", "cum", "C", "n", "n_seq",
                "max_len", "samples", "last_sorted", "last_to_run")


def jax_graph(name):
    kind, kw = GRAPHS[name]
    kw = dict(kw)
    if kind == "random":
        return jgbwt_build.random_pangenome_gbz(np.random.default_rng(kw.pop("seed")), **kw)
    if kind == "synth":
        return jsynth.synth_graph_gbz(**kw)[0]
    return jsynth.synth_multi_component_gbz(**kw)[0]


def port_graph(name):
    kind, kw = GRAPHS[name]
    kw = dict(kw)
    if kind == "random":
        return gbwt_build.random_pangenome_gbz(np.random.default_rng(kw.pop("seed")), **kw)
    if kind == "synth":
        return synth.synth_graph_gbz(**kw)[0]
    return synth.synth_multi_component_gbz(**kw)[0]


def text_lines(g):
    """The haplotype texts of every GBWT sequence, by the JAX record walk."""
    return [b"".join(jgbz.node_seq(g, nd >> 1, bool(nd & 1)) for nd in g.index.extract(s))
            for s in range(g.index.sequences)]


@pytest.fixture(scope="module")
def world():
    """Per graph: the JAX GBZ, its file bytes (the JAX writer), the port's
    parse of them, and both packages' r-indexes (suffix array kept) of the
    graph's text."""
    out = {}
    for name in GRAPHS:
        jg = jax_graph(name)
        data = jgbz_write.write_gbz(jg)
        lines = text_lines(jg)
        bwt = native.build_bwt_native(lines)[0].tobytes()
        out[name] = dict(
            jgbz=jgbz.parse_gbz(data), data=data, gbz=gbz.parse_gbz(data), lines=lines,
            jidx=jrindex.build_rindex(jrlbwt.rlbwt_from_text(bwt), keep_sa=True),
            idx=rindex.build_rindex(rlbwt.rlbwt_from_text(bwt), keep_sa=True),
            rl=bwt)
    return out


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_simple_sds_reader_matches_jax():
    """Reader's primitives on bytes of the JAX writer: words, int vectors of
    several widths, sparse vectors (empty, dense, sparse), string arrays,
    dictionaries and options, each equal to the JAX Reader's result."""
    rng = np.random.default_rng(4)
    w = jsds_write.Writer()
    w.u64(7)
    w.int_vector(rng.integers(0, 1 << 13, 100), 13)
    w.int_vector(np.zeros(0, np.int64), 5)
    for universe, m in ((1000, 0), (1000, 1000), (1 << 20, 37)):
        w.sparse_vector(universe, np.sort(rng.choice(universe, m, replace=False)))
    strings = [b"ACGT", b"", b"GATTACA", b"N" * 17]
    w.string_array(strings)
    w.dictionary([b"sample1", b"a", b"zz"])
    w.option(b"\x01" * 16)
    w.option(None)
    data = w.getvalue()
    j, p = jsds.Reader(data), simple_sds.Reader(data)
    assert p.u64() == j.u64() == 7
    for _ in range(2):
        same(p.int_vector(), j.int_vector())
    for _ in range(3):
        (pl, pp), (jl, jp) = p.sparse_vector(), j.sparse_vector()
        assert pl == jl
        same(pp, jp)
    assert p.string_array() == j.string_array() == strings
    assert p.dictionary() == j.dictionary()
    assert p.option_raw() == j.option_raw() == b"\x01" * 16
    assert p.option_raw() == j.option_raw() == b""
    assert p.o == j.o == len(data)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_parse_gbz_matches_jax(world, name, tmp_path):
    """parse_gbz and load_gbz on the JAX writer's file: every field of the
    GBWT and the graph equals the JAX parse; node_seq and extract too."""
    w = world[name]
    (tmp_path / "g.gbz").write_bytes(w["data"])
    j = jgbz.load_gbz(tmp_path / "g.gbz")
    for g in (w["gbz"], gbz.load_gbz(tmp_path / "g.gbz")):
        assert g.tags == j.tags
        for f in ("sequences", "size", "offset", "alphabet_size", "flags", "bwt_data",
                  "haplotype_count"):
            assert getattr(g.index, f) == getattr(j.index, f), f
        same(g.index.record_starts, j.index.record_starts)
        assert (g.graph.nodes, g.graph.flags, g.graph.sequences) == \
            (j.graph.nodes, j.graph.flags, j.graph.sequences)
        same(g.graph.node_ids, j.graph.node_ids)
    g = w["gbz"]
    for s in range(g.index.sequences):
        assert g.index.extract(s) == j.index.extract(s)
    for nid in g.graph.node_ids[::7]:
        for rev in (False, True):
            assert gbz.node_seq(g, nid, rev) == jgbz.node_seq(j, nid, rev)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_write_gbz_matches_jax(world, name, tmp_path):
    """The port's writer gives the JAX writer's bytes for the parsed graph,
    and for the port's own build of the same seeded graph."""
    w = world[name]
    assert gbz_write.write_gbz(w["gbz"]) == w["data"]
    assert gbz_write.write_gbz(port_graph(name)) == jgbz_write.write_gbz(jax_graph(name))
    gbz_write.save_gbz(w["gbz"], tmp_path / "p.gbz")
    assert (tmp_path / "p.gbz").read_bytes() == w["data"]
    wj, wp = jsds_write.Writer(), simple_sds_write.Writer()
    for wr in (wj, wp):
        wr.string_array([b"TTGA", b"", b"CCCC"])
        wr.dictionary([b"b", b"a"])
    assert wp.getvalue() == wj.getvalue()


@pytest.mark.parametrize("name", list(GRAPHS))
def test_gbz_from_graph_records_match_jax(name):
    """gbz_from_graph (the native record encoder) gives the JAX build's
    records byte for byte, on the seeded graph's nodes and paths."""
    kind, kw = GRAPHS[name]
    if kind == "random":
        j, p = jax_graph(name), port_graph(name)
    else:
        kw = dict(kw)
        if kind == "multi":
            kw.pop("n_comps")
        nodes, paths, _ = jsynth.synth_graph_gbz(**kw, _raw=True)
        j, p = jgbwt_build.gbz_from_graph(nodes, paths), gbwt_build.gbz_from_graph(nodes, paths)
    assert p.index.bwt_data == j.index.bwt_data
    same(p.index.record_starts, j.index.record_starts)
    for f in ("sequences", "size", "offset", "alphabet_size", "flags"):
        assert getattr(p.index, f) == getattr(j.index, f), f
    assert p.graph.sequences == j.graph.sequences and p.tags == j.tags


def test_synth_generators_match_jax():
    """synth_graph_gbz's lines and synth_multi_component_gbz's sub-graphs
    and lines equal the JAX generators'."""
    p_g, p_lines = synth.synth_graph_gbz(5000, 3, site_rate=0.01, seed=9, first_id=4)
    j_g, j_lines = jsynth.synth_graph_gbz(5000, 3, site_rate=0.01, seed=9, first_id=4)
    assert p_lines == j_lines
    assert gbz_write.write_gbz(p_g) == jgbz_write.write_gbz(j_g)
    pw, psubs, pl = synth.synth_multi_component_gbz(3000, 2, n_comps=3, seed=1)
    jw, jsubs, jl = jsynth.synth_multi_component_gbz(3000, 2, n_comps=3, seed=1)
    assert pl == jl
    for p, j in zip([pw, *psubs], [jw, *jsubs]):
        assert gbz_write.write_gbz(p) == jgbz_write.write_gbz(j)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_record_table_matches_jax_numpy_decode(world, name):
    """RecordTable.from_gbwt by the native decoder against the JAX table's
    numpy decode: every array; lf, first_nodes and component_labels equal
    the JAX table's; extract_all equals the JAX record walk."""
    w = world[name]
    t = RecordTable.from_gbwt(w["gbz"].index)
    jt = jgbwt_table.RecordTable.from_gbwt(w["jgbz"].index, use_native=False)
    assert t.offset == jt.offset
    for f in ("edge_ptr", "edge_node", "edge_off", "run_ptr", "run_rank", "run_len",
              "run_cum", "occ_before"):
        same(getattr(t, f), getattr(jt, f))
    rng = np.random.default_rng(1)
    comps, offs = [], []
    for c in rng.integers(0, t.n_rec, 300):
        size = int(t.run_len[t.run_ptr[c]:t.run_ptr[c + 1]].sum())
        if size:
            comps.append(c)
            offs.append(int(rng.integers(0, size)))
    for g, e in zip(t.lf(np.array(comps), np.array(offs)), jt.lf(np.array(comps),
                                                                  np.array(offs))):
        same(g, e)
    seqs = np.arange(w["gbz"].index.sequences)
    same(t.first_nodes(seqs), jt.first_nodes(seqs))
    visits, ptr = t.extract_all(seqs)
    for s in seqs:
        assert visits[ptr[s]:ptr[s + 1]].tolist() == w["jgbz"].index.extract(int(s))
    first, count = int(w["gbz"].graph.node_ids[0]), len(w["gbz"].graph.node_ids)
    same(t.component_labels(first, count), jt.component_labels(first, count))
    assert w["gbz"].index.table() is w["gbz"].index.table()


@pytest.mark.parametrize("name", list(GRAPHS))
def test_build_rindex_keep_sa_matches_jax(world, name):
    """build_rindex(keep_sa=True): the index and sa_seq, sa_pos and
    seq_lengths equal the JAX build's; keep_sa=False keeps none; a known
    suffix array (_sa_hint) gives the same index."""
    w = world[name]
    idx, jidx = w["idx"], w["jidx"]
    for f in INDEX_FIELDS + ("sa_seq", "sa_pos", "seq_lengths"):
        same(getattr(idx, f), getattr(jidx, f))
    bare = rindex.build_rindex(rlbwt.rlbwt_from_text(w["rl"]))
    assert bare.sa_seq is None and bare.sa_pos is None
    for f in INDEX_FIELDS:
        same(getattr(bare, f), getattr(jidx, f))
    hinted = rindex.build_rindex(rlbwt.rlbwt_from_text(w["rl"]), keep_sa=True,
                                 _sa_hint=(idx.sa_seq, idx.sa_pos, idx.seq_lengths))
    for f in INDEX_FIELDS + ("sa_seq", "sa_pos"):
        same(getattr(hinted, f), getattr(jidx, f))


@pytest.mark.parametrize("window", [(0, 1), (0, 64), (5, 133), (64, 128), (-1, None)])
def test_psi_walk_window_matches_full_walk(world, window):
    """psi_walk_native with window (lo, hi) records rows [lo, hi) of the
    whole walk's sa_seq/sa_t (the last: the final 64 rows), and equals the
    JAX binding's windowed walk."""
    idx = world["synth"]["idx"]
    sym = idx.run_sym.astype(np.int64)
    args = (idx.run_start, idx.C[sym] + idx.cum[np.arange(idx.n_runs), sym],
            idx.run_sym == 0, idx.n, idx.n_seq)
    full = native.psi_walk_native(*args, full_sa=True)
    lo, hi = window if window[0] >= 0 else (idx.n - 64, idx.n)
    part = native.psi_walk_native(*args, full_sa=True, window=(lo, hi))
    for g, e in zip(part[:5], full[:5]):
        same(g, e)
    same(part[5], full[5][lo:hi])
    same(part[6], full[6][lo:hi])
    jpart = jnative.psi_walk_native(*args, full_sa=True, window=(lo, hi))
    for g, e in zip(part, jpart):
        same(g, e)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_tags_per_row_and_build_tags_match_jax(world, name):
    """tags_per_row, and build_tags resident (default chunk, a chunk of 97
    rows, below the data size, and the per-character tags by search in
    place of the flat array) and with the suffix array streamed in windows
    of 64 rows: the JAX build's values and runs."""
    w = world[name]
    g, jg, idx, jidx = w["gbz"], w["jgbz"], w["idx"], w["jidx"]
    same(tagbuild.tags_per_row(g, idx), jtagbuild.tags_per_row(jg, jidx))
    want = jtagbuild.build_tags(jg, jidx)
    assert want.total == idx.n - idx.n_seq
    streamed = rindex.build_rindex(rlbwt.rlbwt_from_text(w["rl"]))
    for got in (tagbuild.build_tags(g, idx), tagbuild.build_tags(g, idx, chunk=97),
                tagbuild.build_tags(g, idx, chunk=97, flat_bytes_cap=0),
                tagbuild.build_tags(g, streamed, chunk=97, sa_window_bytes=64 * 16)):
        same(got.pos_enc, want.pos_enc)
        same(got.bwt_start, want.bwt_start)
        assert got.total == want.total
    values, lengths = tagbuild.rle(tagbuild.tags_per_row(g, idx))
    jvalues, jlengths = jtagbuild.rle(jtagbuild.tags_per_row(jg, jidx))
    same(values, jvalues)
    same(lengths, jlengths)


def test_tag_build_refuses_another_graph(world):
    """A text of another graph: the path lengths differ from the BWT's
    sequences (or their count), a ValueError as in the JAX build."""
    g, idx = world["synth"]["gbz"], world["multi"]["idx"]
    with pytest.raises(ValueError):
        tagbuild.build_tags(g, idx)
    with pytest.raises(ValueError):
        tagbuild.tags_per_row(g, idx)


@pytest.mark.parametrize("name", ["random", "synth", "multi"])
@pytest.mark.parametrize("k", [11, 31])
def test_kmer_statistics_match_jax(world, name, k):
    """unique_kmers, anchor_kmers and extend_runs (build-tags --stats) give
    the JAX package's arrays."""
    w = world[name]
    g, jg, idx, jidx = w["gbz"], w["jgbz"], w["idx"], w["jidx"]
    keys, pos = kmers.unique_kmers(g, k)
    jkeys, jpos = jkmers.unique_kmers(jg, k)
    same(keys, jkeys)
    same(pos, jpos)
    anchored = anchor.anchor_kmers(idx, keys, pos, k)
    janchored = janchor.anchor_kmers(jidx, jkeys, jpos, k)
    for a, b in zip(anchored, janchored):
        same(a, b)
    ext = anchor.extend_runs(g, idx, *anchored, max_rounds=10_000)
    jext = janchor.extend_runs(jg, jidx, *janchored, max_rounds=10_000)
    for a, b in zip(ext, jext):
        same(a, b)
