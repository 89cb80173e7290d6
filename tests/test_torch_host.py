"""The port's own host code against the JAX package's, exactly: the same
seeded numpy inputs through the JAX package's host function and the port's
copy of it (index model and synthetic data, the .ri and .tags codecs, the
seed-table and dictionary builds, the read-window passes, the host MEM finder
and the native engine's binding, the alphabet, sdsl, ByteCode and graph
helpers, and the public loaders and build_index). One case per copied
function."""

import dataclasses
import io
import os

import numpy as np
import pytest

import pangenome_index_tpu as jpx
import pangenome_index_tpu_torch as px
from pangenome_index_tpu import cli as jcli
from pangenome_index_tpu import utils as jutils
from pangenome_index_tpu.core import anchor as janchor
from pangenome_index_tpu.core import tagbuild as jtagbuild
from pangenome_index_tpu.core.gbwt_build import random_pangenome_gbz
from pangenome_index_tpu.formats import gbz as jgbz
from pangenome_index_tpu.formats import sdsl as jsdsl
from pangenome_index_tpu.formats.gbz_write import save_gbz
from pangenome_index_tpu.models import tagarray as jtagarray
from pangenome_index_tpu import native as jnative
from pangenome_index_tpu.formats import bytecode as jbytecode
from pangenome_index_tpu.formats import ri as jri
from pangenome_index_tpu.formats import tags as jtagfmt
from pangenome_index_tpu.models import mems as jmems
from pangenome_index_tpu.models import oracle as joracle
from pangenome_index_tpu.ops import mertable as jmertable
from pangenome_index_tpu.ops import sparsedict as jsparsedict
from pangenome_index_tpu.utils import synth as jsynth
from pangenome_index_tpu_torch import cli, native, utils
from pangenome_index_tpu_torch.core import anchor, tagbuild
from pangenome_index_tpu_torch.formats import bytecode, ri, sdsl, tags as tagfmt
from pangenome_index_tpu_torch.models import tagarray
from pangenome_index_tpu_torch.models.rindex import RIndex
from pangenome_index_tpu_torch.models.tagarray import TagArray
from pangenome_index_tpu_torch.models import mems, oracle
from pangenome_index_tpu_torch.ops import mertable, sparsedict
from pangenome_index_tpu_torch.utils import synth

INDEX_FIELDS = ("run_sym", "run_start", "run_len", "cum", "C", "n", "n_seq",
                "max_len", "samples", "last_sorted", "last_to_run")


def same_arrays(got, expect):
    """Equal values and dtypes, element by element of a tuple."""
    assert len(got) == len(expect)
    for g, e in zip(got, expect):
        g, e = np.asarray(g), np.asarray(e)
        assert g.dtype == e.dtype and g.shape == e.shape
        np.testing.assert_array_equal(g, e)


def same_index(got, expect):
    for f in INDEX_FIELDS:
        same_arrays((getattr(got, f),), (getattr(expect, f),))


def same_tags(got, expect):
    same_arrays((got.pos_enc, got.bwt_start), (expect.pos_enc, expect.bwt_start))
    assert got.total == expect.total


@pytest.fixture(scope="module")
def world():
    """The JAX package's index, lines, reads, tags and seed tiers: the inputs
    every case feeds to both sides."""
    idx, lines = jsynth.build_synth_index(20_000, 4, seed=2)
    reads = jsynth.synth_reads(lines, 48, 100, error_rate=0.02, seed=5)
    reads[3] = reads[3][:40] + b"N" + reads[3][41:]
    reads[7] = reads[7][:33]
    codes, lens = jcli._pack_reads(reads)
    tags = jsynth.synth_tag_array(idx, lines=lines)
    return dict(idx=idx, lines=lines, reads=reads, codes=codes, lens=lens,
                tags=tags)


def case_build_synth_index(w, tmp_path):
    idx, lines = synth.build_synth_index(20_000, 4, seed=2)
    assert lines == w["lines"]
    same_index(idx, w["idx"])
    # the cache file is the JAX package's: each side reads the other's
    a = synth.build_synth_index(6_000, 3, seed=4, cache_dir=str(tmp_path))[0]
    b = jsynth.build_synth_index(6_000, 3, seed=4, cache_dir=str(tmp_path))[0]
    assert len(os.listdir(tmp_path)) == 1
    same_index(a, b)
    same_index(synth.build_synth_index(6_000, 3, seed=4,
                                       cache_dir=str(tmp_path))[0], b)


def case_synth_reads(w, tmp_path):
    for err, seed in ((0.0, 2), (0.02, 5)):
        assert synth.synth_reads(w["lines"], 64, 100, error_rate=err, seed=seed) \
            == jsynth.synth_reads(w["lines"], 64, 100, error_rate=err, seed=seed)


def case_synth_tag_array(w, tmp_path):
    same_tags(synth.synth_tag_array(w["idx"]), w["tags"])
    same_tags(synth.synth_tag_array(w["idx"], cache_dir=str(tmp_path)), w["tags"])
    same_tags(jsynth.synth_tag_array(w["idx"], cache_dir=str(tmp_path)), w["tags"])
    assert len(os.listdir(tmp_path)) == 1


def case_ri_round_trip(w, tmp_path):
    data = ri.serialize_encoded(w["idx"])
    assert data == jri.serialize_encoded(w["idx"])
    same_index(ri.load(data), jri.load(data))
    same_index(ri.load(data), w["idx"])
    legacy = jri.serialize_legacy(w["idx"])
    same_index(ri.load(legacy), jri.load(legacy))
    path = tmp_path / "x.ri"
    path.write_bytes(data)
    same_index(ri.load_file(path), w["idx"])


def case_tags_round_trip(w, tmp_path):
    for compact in (False, True):
        data = tagfmt.write_compressed_bytecode(w["tags"], compact=compact)
        assert data == jtagfmt.write_compressed_bytecode(w["tags"], compact=compact)
        fmt = "bytecode-compact" if compact else "bytecode"
        for f in ("auto", fmt):
            same_tags(tagfmt.load_tags(data, fmt=f), jtagfmt.load_tags(data, fmt=f))
        same_tags(tagfmt.load_tags(data), w["tags"])
    for data, fmt in ((jtagfmt.write_algorithm(w["tags"]), "algorithm"),
                      (jtagfmt.write_compressed_sdsl(w["tags"]), "sdsl")):
        for f in ("auto", fmt):
            same_tags(tagfmt.load_tags(data, fmt=f), jtagfmt.load_tags(data, fmt=f))
        wrapped = jtagfmt.wrap_payload(data, fmt)
        same_tags(tagfmt.load_tags(wrapped), jtagfmt.load_tags(wrapped))
    path = tmp_path / "x.tags"
    path.write_bytes(tagfmt.write_compressed_bytecode(w["tags"]))
    same_tags(tagfmt.load_tags_file(path, fmt="bytecode"), w["tags"])


def case_ri_file_sections(w, tmp_path):
    """The .ri sizes print-stats reports, on the encoded and the legacy
    file: the JAX function's sections, summing to the file's size."""
    for data in (jri.serialize_encoded(w["idx"]), jri.serialize_legacy(w["idx"])):
        got = ri.file_sections(data)
        assert got == jri.file_sections(data)
        assert sum(b for _, b in got) == len(data)
    with pytest.raises(ValueError, match="invalid .ri tag"):
        ri.file_sections(b"\0" * 64)


def tag_payloads(tags):
    """fmt -> the JAX writers' bytes of `tags` in every on-disk format."""
    return {"algorithm": jtagfmt.write_algorithm(tags),
            "sdsl": jtagfmt.write_compressed_sdsl(tags),
            "bytecode": jtagfmt.write_compressed_bytecode(tags),
            "bytecode-compact": jtagfmt.write_compressed_bytecode(tags, compact=True)}


def case_tags_file_sections(w, tmp_path):
    """The .tags sizes print-stats reports on algorithm, sdsl and bytecode
    files (full and compact values), summing to the file's size."""
    for fmt, data in tag_payloads(w["tags"]).items():
        got = tagfmt.file_sections(data)
        assert got == jtagfmt.file_sections(data), fmt
        assert sum(b for _, b in got) == len(data)
        assert len(got) == (1 if fmt == "algorithm" else 3)


def case_convert_algorithm(w, tmp_path):
    """convert-tags' conversion of an algorithm file, under both compact and
    both compat, gives the JAX function's bytes, which load back."""
    raw = jtagfmt.write_algorithm(w["tags"])
    for compact in (False, True):
        for compat in (False, True):
            got = tagfmt.convert_algorithm(raw, compact=compact, compat=compat)
            assert got == jtagfmt.convert_algorithm(raw, compact=compact, compat=compat)
            fmt = "bytecode-compact" if compact else "bytecode"
            loaded = tagfmt.load_tags(got, fmt=fmt)
            if not compat:
                same_tags(loaded, w["tags"])


def case_wrap_payload(w, tmp_path):
    for fmt, data in tag_payloads(w["tags"]).items():
        wrapped = tagfmt.wrap_payload(data, fmt)
        assert wrapped == jtagfmt.wrap_payload(data, fmt)
        assert tagfmt.unwrap_payload(wrapped) == (data, fmt)


def case_write_algorithm(w, tmp_path):
    """write_algorithm's bytes, on the synthetic tags and on runs longer
    than the 9-bit length field (split as the JAX writer splits them)."""
    long_runs = TagArray(pos_enc=np.array([5 << 11, 7 << 11 | 1024 | 3], np.int64),
                         bwt_start=np.array([0, 1500], np.int64), total=1600)
    for tags in (w["tags"], long_runs):
        data = tagfmt.write_algorithm(tags)
        assert data == jtagfmt.write_algorithm(tags)
        same_tags(tagfmt.load_tags(data, fmt="algorithm"),
                  jtagfmt.load_tags(data, fmt="algorithm"))
    assert bytecode.write_values([0, 127, 128, 1 << 40]) == \
        jbytecode.write_values([0, 127, 128, 1 << 40])


def case_write_compressed_sdsl(w, tmp_path):
    """write_compressed_sdsl's bytes at the width the reference sizes from
    the largest node id and at a given width, and write_compressed_bytecode
    (now through the shared sidecar writer) still the JAX bytes."""
    for width in (None, 40):
        data = tagfmt.write_compressed_sdsl(w["tags"], width=width)
        assert data == jtagfmt.write_compressed_sdsl(w["tags"], width=width)
        same_tags(tagfmt.load_tags(data, fmt="sdsl"), w["tags"])
    empty = TagArray(pos_enc=np.zeros(0, np.int64), bwt_start=np.zeros(0, np.int64), total=0)
    for tags in (w["tags"], empty):
        assert tagfmt.write_compressed_sdsl(tags) == jtagfmt.write_compressed_sdsl(tags)
        for compact in (False, True):
            assert tagfmt.write_compressed_bytecode(tags, compact=compact) == \
                jtagfmt.write_compressed_bytecode(tags, compact=compact)


def case_build_mer_table(w, tmp_path):
    for m in (1, 6):
        same_arrays((mertable.build_mer_table(w["idx"], m),),
                    (jmertable.build_mer_table(w["idx"], m),))


def case_mer_table_key(w, tmp_path):
    other = jsynth.build_synth_index(6_000, 3, seed=4)[0]
    keys = {mertable.mer_table_key(i, m) for i in (w["idx"], other) for m in (6, 8)}
    assert len(keys) == 4
    for i in (w["idx"], other):
        for m in (6, 8, -512):
            assert mertable.mer_table_key(i, m) == jmertable.mer_table_key(i, m)


def case_read_mer_keys_fast(w, tmp_path):
    for m in (6, 14, 19):
        same_arrays(mertable.read_mer_keys_fast(w["codes"], w["lens"], m),
                    jmertable.read_mer_keys_fast(w["codes"], w["lens"], m))
        # and the JAX package's numpy scan, which the native pass stands for
        same_arrays(mertable.read_mer_keys_fast(w["codes"], w["lens"], m),
                    jmertable.read_mer_keys(w["codes"], w["lens"], m))


@pytest.mark.parametrize("s", [16, 30, 31])
def test_get_sparse_dict_matches_host_build(world, tmp_path, s):
    """The port's dictionary against the JAX package's *host* build (the JAX
    device build wraps its keys at s = 31), built, cached and re-read by
    either side."""
    expect = jsparsedict.build_sparse_dict(world["idx"], s)
    assert len(expect[0]) > 0
    same_arrays(sparsedict.build_sparse_dict(world["idx"], s), expect)
    assert sparsedict.sparse_dict_key(world["idx"], s) \
        == jsparsedict.sparse_dict_key(world["idx"], s)
    path = str(tmp_path / f"x.sdict{s}.npz")
    same_arrays(sparsedict.get_sparse_dict(world["idx"], s, path=path), expect)
    assert os.path.exists(path)
    same_arrays(sparsedict.get_sparse_dict(world["idx"], s, path=path), expect)
    same_arrays(jsparsedict.get_sparse_dict(world["idx"], s, path=path), expect)
    assert sparsedict.DEVICE_BYTES_CAP == jsparsedict.DEVICE_BYTES_CAP


def case_read_windows_fast(w, tmp_path):
    for s in (16, 19):
        keys, _ = jsparsedict.build_sparse_dict(w["idx"], s)
        got = sparsedict.read_windows_fast(w["codes"], w["lens"], s, keys)
        same_arrays(got, jsparsedict.read_windows_fast(w["codes"], w["lens"], s, keys))
        assert (got[2] >= 0).any() and (got[2] < 0).any()
        # the JAX package's numpy pair, and an empty dictionary
        rk, rv = jmertable.read_mer_keys(w["codes"], w["lens"], s)
        same_arrays(got, (rk, rv, jsparsedict.lookup_read_windows(keys, rk, rv)))
        none = np.zeros(0, np.int64)
        same_arrays(sparsedict.read_windows_fast(w["codes"], w["lens"], s, none),
                    jsparsedict.read_windows_fast(w["codes"], w["lens"], s, none))


def case_pack_reads(w, tmp_path):
    same_arrays(cli.pack_reads(w["reads"]), (w["codes"], w["lens"]))
    path = tmp_path / "reads.txt"
    path.write_bytes(b"\n".join(w["reads"]) + b"\n\n")
    assert cli.read_reads(str(path)) == jcli._read_reads(str(path)) == w["reads"]
    for arg, min_len, m in ((-1, 20, 14), (-1, 40, 14), (0, 20, 14), (19, 20, 14),
                            (12, 20, 14), (-1, 4, 0)):
        assert cli.resolve_long_seed(arg, min_len, m) \
            == jcli._resolve_long_seed(arg, min_len, m)


def case_find_all_mems(w, tmp_path):
    n_mems = 0
    for read in w["reads"][:12]:
        for min_len, min_occ in ((20, 1), (12, 3)):
            got = mems.find_all_mems(w["idx"], read, min_len, min_occ)
            expect = jmems.find_all_mems(w["idx"], read, min_len, min_occ)
            assert [(m.start, m.end, m.bwt_start, m.size) for m in got] \
                == [(m.start, m.end, m.bwt_start, m.size) for m in expect]
            n_mems += len(got)
    assert n_mems > 12


def case_find_mems_native(w, tmp_path):
    for capacity in (4, 64):
        got = native.find_mems_native(w["idx"], w["codes"], w["lens"], 20, 1,
                                      capacity=capacity)
        same_arrays(got, jnative.find_mems_native(w["idx"], w["codes"], w["lens"],
                                                  20, 1, capacity=capacity))
        assert int(got[4].max()) > 4
    same_arrays(native.count_native(w["idx"], w["codes"], w["lens"]),
                jnative.count_native(w["idx"], w["codes"], w["lens"]))


def _mem_intervals(w):
    s, e, b, z, cnt = jnative.find_mems_native(w["idx"], w["codes"], w["lens"],
                                               20, 1, capacity=64)
    counts = np.minimum(cnt, 64).astype(np.int64)
    ii = np.repeat(np.arange(len(counts)), counts)
    within = np.arange(len(ii)) - np.repeat(np.cumsum(counts) - counts, counts)
    return counts, s[ii, within], e[ii, within], b[ii, within], z[ii, within]


def case_query_tags_native(w, tmp_path):
    _, _, _, b, z = _mem_intervals(w)
    for capacity, exact in ((256, False), (2, False), (256, True)):
        same_arrays(native.query_tags_native(w["tags"], b, b + z - 1,
                                             capacity=capacity, exact=exact),
                    jnative.query_tags_native(w["tags"], b, b + z - 1,
                                              capacity=capacity, exact=exact))


def case_format_mems_native(w, tmp_path):
    counts, s, e, b, z = _mem_intervals(w)
    tpos, tuniq, _ = jnative.query_tags_native(w["tags"], b, b + z - 1)
    out = []
    for mod, name in ((native, "port.txt"), (jnative, "jax.txt")):
        for tags_too in (True, False):
            with open(tmp_path / name, "wb") as fh:
                n = mod.format_mems_native(counts, s, e, b, z,
                                           tuniq if tags_too else None,
                                           tpos if tags_too else None, fh.fileno())
            data = (tmp_path / name).read_bytes()
            assert n == len(data) > 0
            out.append(data)
    assert out[0] == out[2] and out[1] == out[3] and out[0] != out[1]


def case_native_build_is_the_ports_own(w, tmp_path):
    """The binding compiles src/cpp into the port's build directory, not
    beside the sources, and a failed build raises with the compiler's
    output."""
    lib = native.build()
    assert native.BUILD_ROOT in lib.parents and native.SRC not in lib.parents
    assert lib.exists()
    flags = native.CXX_FLAGS
    try:
        native.CXX_FLAGS = (*flags, "--no-such-compiler-flag")
        with pytest.raises(RuntimeError, match="no-such-compiler-flag"):
            native.build()
    finally:
        native.CXX_FLAGS = flags
    assert native.build() == lib


def case_locate(w, tmp_path):
    """The host locate of the port's model (locate_first, locate_next,
    decompress_sa) against the JAX model's, on the same index."""
    idx = synth.build_synth_index(20_000, 4, seed=2)[0]
    j = w["idx"]
    assert idx.locate_first() == j.locate_first()
    rng = np.random.default_rng(9)
    prev = np.concatenate((j.samples, j.last_sorted,
                           rng.integers(0, j.n_seq * j.max_len, 4096)))
    # the models keep no pad after the last sample: leave out the values
    # whose tail belongs to the last run (the device tables carry the pad)
    tail = np.searchsorted(j.last_sorted, prev, side="right") - 1
    prev = prev[j.last_to_run[tail] + 1 < j.n_runs]
    same_arrays((idx.locate_next(prev),), (j.locate_next(prev),))
    sa = idx.decompress_sa()
    same_arrays((sa,), (j.decompress_sa(),))
    assert len(np.unique(sa)) == idx.n


def case_oracle(w, tmp_path):
    """The host rotation sort of build-bwt --engine host: the same BWT,
    document array, suffix positions and lengths from the lines and from
    the text file (its last newline dropped, inner empty lines kept)."""
    fields = ("bwt", "da", "sa_pos", "seq_lengths")
    got = oracle.oracle_from_lines(w["lines"])
    same_arrays([getattr(got, f) for f in fields],
                [getattr(joracle.oracle_from_lines(w["lines"]), f) for f in fields])
    path = tmp_path / "text.txt"
    path.write_bytes(b"\n".join(w["lines"][:2] + [b""] + w["lines"][2:]) + b"\n")
    got = oracle.oracle_from_file(str(path))
    same_arrays([getattr(got, f) for f in fields],
                [getattr(joracle.oracle_from_file(str(path)), f) for f in fields])
    assert len(got.seq_lengths) == len(w["lines"]) + 1


def case_alphabet_helpers(w, tmp_path):
    """utils re-exports the JAX package's alphabet names with its values, and
    encode_bytes / decode_codes map as the JAX functions do (bytes, a
    bytearray, a uint8 array, bytes outside the alphabet)."""
    names = ("NENDMARKER", "NUC", "SIGMA", "BYTE_TO_CODE", "CODE_TO_BYTE", "COMP_CODE")
    for name in names:
        same_arrays((getattr(utils, name),), (getattr(jutils, name),))
    text = b"".join(w["lines"])[:5000] + b"\nNnXACGT"
    for data in (text, bytearray(text), np.frombuffer(text, np.uint8), b""):
        same_arrays((utils.encode_bytes(data),), (jutils.encode_bytes(data),))
    codes = jutils.encode_bytes(text)
    assert utils.decode_codes(codes) == jutils.decode_codes(codes)
    assert utils.decode_codes(codes.astype(np.int64)) == jutils.decode_codes(codes)


def case_compact_encoding(w, tmp_path):
    """encode_compact / decode_compact on every tag run's position."""
    parts = jtagarray.decode_compact(w["tags"].pos_enc)
    same_arrays(tagarray.decode_compact(w["tags"].pos_enc), parts)
    same_arrays((tagarray.encode_compact(*parts),), (jtagarray.encode_compact(*parts),))
    same_arrays((tagarray.encode_compact(*parts),), (w["tags"].pos_enc,))
    # scalars, and offsets past the 10-bit field (masked)
    assert tagarray.encode_compact(7, 1, 1500) == jtagarray.encode_compact(7, 1, 1500)


def case_read_bit_vector(w, tmp_path):
    """read_bit_vector on the JAX writer's bytes: the index's run-head bit
    vector, 64 bits of it, and an empty one."""
    heads = np.zeros(w["idx"].n, np.uint8)
    heads[w["idx"].run_start] = 1
    for bits in (heads, heads[:64], np.zeros(0, np.uint8)):
        buf = io.BytesIO()
        jsdsl.write_bit_vector(buf, bits)
        got = sdsl.read_bit_vector(io.BytesIO(buf.getvalue()))
        same_arrays((got,), (jsdsl.read_bit_vector(io.BytesIO(buf.getvalue())),))
        same_arrays((got.astype(np.uint8),), (bits,))


def case_read_select_mcl(w, tmp_path):
    """read_select_mcl on the JAX writer's bytes: the select structures over
    the high bits of the run heads' sd_vector (pattern 1 and 0; one with no
    argument), read to their end, and written back to the same bytes."""
    idx = w["idx"]
    high = jsdsl.SdVector(idx.n, idx.run_start.astype(np.int64)).high_bits()
    for pattern in (1, 0, 7):
        sel = jsdsl.build_select_mcl(high, pattern)
        buf = io.BytesIO()
        jsdsl.write_select_mcl(buf, sel)
        raw = buf.getvalue() + b"tail"
        r1, r2 = io.BytesIO(raw), io.BytesIO(raw)
        got, expect = sdsl.read_select_mcl(r1), jsdsl.read_select_mcl(r2)
        assert r1.tell() == r2.tell() == len(raw) - 4
        assert got.arg_cnt == expect.arg_cnt and got.superblock_width == expect.superblock_width
        same_arrays((got.superblock, got.mini_or_long),
                    (expect.superblock, expect.mini_or_long))
        assert len(got.blocks) == len(expect.blocks)
        for (gv, gw), (ev, ew) in zip(got.blocks, expect.blocks):
            assert gw == ew
            same_arrays((gv,), (ev,))
        out = io.BytesIO()
        sdsl.write_select_mcl(out, got)
        assert out.getvalue() == raw[:-4]


def case_read_value(w, tmp_path):
    """read_value walks a ByteCode stream value by value, as the JAX
    function does (bytes and a mapping-like bytearray)."""
    values = [0, 1, 127, 128, 16383, 16384, 1 << 35, *w["tags"].pos_enc[:200].tolist()]
    data = jbytecode.write_values(values)
    for buf in (data, bytearray(data)):
        loc, got = 0, []
        while loc < len(buf):
            v, nxt = bytecode.read_value(buf, loc)
            assert (v, nxt) == jbytecode.read_value(buf, loc)
            got.append(v)
            loc = nxt
        assert got == values


def demo_graph(tmp_path):
    """The end-to-end demo's graph (seed 0, 60 nodes, 3 paths) as the JAX
    writer writes it, loaded by the port's load_gbz and the JAX one."""
    path = tmp_path / "demo.gbz"
    save_gbz(random_pangenome_gbz(np.random.default_rng(0), n_nodes=60, n_paths=3), path)
    g, jg = px.load_gbz(path), jgbz.load_gbz(path)
    assert g.index.sequences == jg.index.sequences
    assert g.graph.sequences == jg.graph.sequences
    return g, jg


def case_predecessor_map(w, tmp_path):
    """Every oriented node's predecessors (node and base, in the JAX order)."""
    g, jg = demo_graph(tmp_path)
    got = anchor.predecessor_map(g)
    assert got == janchor.predecessor_map(jg) and len(got) > 0


def case_path_tag_array(w, tmp_path):
    """Every sequence's graph positions, forward and reverse paths."""
    g, jg = demo_graph(tmp_path)
    for i in range(jg.index.sequences):
        same_arrays((tagbuild.path_tag_array(g, i),), (jtagbuild.path_tag_array(jg, i),))


class ReadLog(io.BytesIO):
    """A file-like with a mapping's interface (read, seek, tell, len and
    slices) that keeps the size of every read and slice."""

    def __init__(self, data):
        super().__init__(data)
        self.sizes = []

    def read(self, n=-1):
        out = super().read(n)
        self.sizes.append(len(out))
        return out

    def __len__(self):
        return len(self.getbuffer())

    def __getitem__(self, key):
        out = self.getbuffer()[key]
        out = out.tobytes() if isinstance(out, memoryview) else out
        self.sizes.append(len(out) if isinstance(out, bytes) else 1)
        return out


def case_load_rindex_mmap(w, tmp_path):
    """load_rindex with and without use_mmap, on the encoded and the legacy
    file: every field the JAX loaders' (both ways) and the index's; the parse
    of a file-like reads sections, never the whole file."""
    for name, data in (("enc", jri.serialize_encoded(w["idx"])),
                       ("legacy", jri.serialize_legacy(w["idx"]))):
        path = tmp_path / f"{name}.ri"
        path.write_bytes(data)
        expect = jpx.load_rindex(path, use_mmap=True)
        same_index(jpx.load_rindex(path), expect)
        for use_mmap in (False, True):
            same_index(px.load_rindex(path, use_mmap=use_mmap), expect)
            same_index(ri.load_file(path, use_mmap=use_mmap), w["idx"])
        log = ReadLog(data)
        same_index(ri.load(log), expect)
        assert max(log.sizes) < len(data)


def case_load_tags_mmap(w, tmp_path):
    """load_tags with and without use_mmap, on every on-disk format (and a
    wrapped payload): the JAX loaders' runs, auto-detected and by name; the
    compressed formats' parse reads sections, never the whole file."""
    payloads = tag_payloads(w["tags"])
    payloads["wrapped"] = jtagfmt.wrap_payload(payloads["sdsl"], "sdsl")
    for fmt, data in payloads.items():
        path = tmp_path / f"{fmt}.tags"
        path.write_bytes(data)
        expect = jtagfmt.load_tags_file(path, use_mmap=True)
        same_tags(jpx.load_tags(path), expect)
        same_tags(expect, w["tags"])
        named = "auto" if fmt == "wrapped" else fmt
        for use_mmap in (False, True):
            same_tags(px.load_tags(path, use_mmap=use_mmap), expect)
            same_tags(tagfmt.load_tags_file(path, use_mmap=use_mmap, fmt=named),
                      jtagfmt.load_tags_file(path, use_mmap=use_mmap, fmt=named))
        if fmt in ("sdsl", "bytecode", "bytecode-compact"):
            log = ReadLog(data)
            same_tags(tagfmt.load_tags(log, fmt=fmt), expect)
            assert max(log.sizes) < len(data)


def case_build_index(w, tmp_path):
    """build_index on the index's lines, with and without the suffix array:
    every field of the JAX build_index's result, values and dtypes; with
    keep_sa the index's own fields too."""
    for keep_sa in (True, False):
        got = px.build_index(w["lines"], keep_sa=keep_sa)
        expect = jpx.build_index(w["lines"], keep_sa=keep_sa)
        for f in dataclasses.fields(RIndex):
            g, e = getattr(got, f.name), getattr(expect, f.name)
            if e is None:
                assert g is None, f.name
            else:
                same_arrays((g,), (e,))
        assert (got.sa_seq is not None) == keep_sa
        same_index(got, w["idx"])


CASES = [case_build_synth_index, case_synth_reads, case_synth_tag_array,
         case_ri_round_trip, case_tags_round_trip, case_ri_file_sections,
         case_tags_file_sections, case_convert_algorithm, case_wrap_payload,
         case_write_algorithm, case_write_compressed_sdsl, case_build_mer_table,
         case_mer_table_key, case_read_mer_keys_fast, case_read_windows_fast,
         case_pack_reads, case_find_all_mems, case_find_mems_native,
         case_query_tags_native, case_format_mems_native,
         case_native_build_is_the_ports_own, case_locate, case_oracle,
         case_alphabet_helpers, case_compact_encoding, case_read_bit_vector,
         case_read_select_mcl, case_read_value, case_predecessor_map,
         case_path_tag_array, case_load_rindex_mmap, case_load_tags_mmap,
         case_build_index]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_host_copy_matches_jax(world, tmp_path, case):
    case(world, tmp_path)
