"""The port's ultra and bucketed rank modes against the JAX package, exactly
(every value is an integer: tolerance 0), on a small synthetic index, at
int32 positions and at int64 (the JAX package under 64-bit types, as
tests/test_torch_int64.py runs it). CPU: the port's plain versions, which
the card's kernels (csrc/rankmodes.cu and the ultra and bucketed
instantiations of K2, K3 and the dictionary's level) are held against in
tests/test_torch_cuda.py and chip_smoke.py. Each mode's seed table,
dictionary and MEMs also equal the port's checkpoint results."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenome_index_tpu.ops import rank as jrank
from pangenome_index_tpu.ops import sparsedict as jax_sd
from pangenome_index_tpu.ops.fmd import extend as jax_extend
from pangenome_index_tpu.ops.mems import find_mems_batch
from pangenome_index_tpu.ops.mertable import (build_mer_table, build_mer_table_device,
                                              read_mer_keys_fast)
from pangenome_index_tpu.ops.sparsedict import build_sparse_dict, read_windows_fast
from pangenome_index_tpu.ops.tables import rindex_to_device as jax_rindex_to_device
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu.utils.synth import build_synth_index, synth_reads
from pangenome_index_tpu_torch.ops import count, fmd, mems, mertable, rank, sparsedict
from pangenome_index_tpu_torch.ops.tables import rindex_to_device, tables_from_numpy
from pangenome_index_tpu_torch.serve import check_rank_tables

MIN_LEN, MIN_OCC, MER_M, SDICT_S = 20, 1, 6, 12
FIELDS = ("run_sym", "run_start", "cum", "C", "samples", "last_sorted", "last_to_run",
          "bucket_lo", "pos_to_run", "rec", "rank_table", "ckpt", "ckpt_super")
MODES = ("ultra", "bucketed")
DTYPES = {"int32": (torch.int32, jnp.int32), "int64": (torch.int64, jnp.int64)}
#: (mode, positions) cases the kernels take: ultra rows are int32 only
CASES = [("ultra", "int32"), ("bucketed", "int32"), ("bucketed", "int64")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def x64_restored():
    """Each JAX reference below runs under the type width of its case; the
    process's flag is restored after the module."""
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def index():
    return build_synth_index(20_000, 4, seed=2)


@pytest.fixture(scope="module")
def reads(index):
    idx, lines = index
    rs = synth_reads(lines, 48, 100, error_rate=0.01, seed=5)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)] for r in rs]).astype(np.int32)
    lens = np.full(len(rs), 100, np.int32)
    lens[::5] = np.random.default_rng(5).integers(30, 100, len(lens[::5]))
    for i, n in enumerate(lens):
        codes[i, n:] = 0
    codes[3, 40] = 4  # an N
    return codes, lens


def x64(width):
    """The JAX package's type width for a case: a context manager."""
    return jax.enable_x64(width == "int64")


def jax_tables(idx, mode, width):
    """The JAX package's tables of a mode (numpy fields), its flags those of
    the port's call (bucketed is the JAX default)."""
    with x64(width):
        jt = jax_rindex_to_device(idx, dtype=DTYPES[width][1], **{mode: True})
        return {f: None if getattr(jt, f) is None else np.asarray(getattr(jt, f))
                for f in FIELDS + ("n", "n_seq", "max_len")}


def port_tables(idx, mode, width):
    return rindex_to_device(idx, "cpu", dtype=DTYPES[width][0], **{mode: True})


def as_jax(fields, width):
    """The JAX RIndexTables of numpy fields (made under the case's width)."""
    from pangenome_index_tpu.ops.tables import RIndexTables

    with x64(width):
        return RIndexTables(**{f: None if v is None else jnp.asarray(v)
                               for f, v in fields.items()})


def positions(idx, width, seed=0):
    """Random positions, 0, n, n + 1, every run head and the positions
    beside the heads."""
    rng = np.random.default_rng(seed)
    heads = idx.run_start.astype(np.int64)
    pos = np.concatenate((rng.integers(0, idx.n + 2, 2000), [0, 1, idx.n - 1, idx.n,
                                                             idx.n + 1],
                          heads, heads[1:] - 1, heads + 1))
    return pos.astype(np.int32 if width == "int32" else np.int64)


def same(got, expect, what=""):
    g, e = np.asarray(got), np.asarray(expect)
    assert g.shape == e.shape, what
    np.testing.assert_array_equal(g, e, err_msg=what)


@pytest.mark.parametrize("width", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_tables_match_jax_field_for_field(index, mode, width):
    idx, _ = index
    jt = jax_tables(idx, mode, width)
    pt = port_tables(idx, mode, width)
    assert pt.pos_dtype == DTYPES[width][0]
    for f in FIELDS:
        got = getattr(pt, f)
        assert (got is None) == (jt[f] is None), f
        if got is not None:
            assert got.numpy().dtype == jt[f].dtype, f
            same(got, jt[f], f)
    assert (pt.rank_table is not None) == (mode == "ultra")
    assert (pt.bucket_lo is not None) == (mode == "bucketed")
    assert pt.cum.shape[0] == (idx.n_runs if mode == "bucketed" else 1)


@pytest.mark.parametrize("mode,width", CASES)
def test_run_of_and_rank6_match_jax(index, mode, width):
    idx, _ = index
    jt = as_jax(jax_tables(idx, mode, width), width)
    pt = port_tables(idx, mode, width)
    pos = positions(idx, width)
    with x64(width):
        expect = np.asarray(jrank.rank6(jt, jnp.asarray(pos)))
        if mode == "bucketed":
            same(rank.run_of(pt, torch.from_numpy(pos)), jrank.run_of(jt, jnp.asarray(pos)))
    got = rank.rank6(pt, torch.from_numpy(pos))
    assert got.dtype == pt.pos_dtype
    same(got, expect)
    plain = rank.rank6_ultra if mode == "ultra" else rank.rank6_bucketed
    same(plain(pt, torch.from_numpy(pos)), expect)  # CPU tensors: the plain version
    # inside the BWT every mode gives the host model's counts
    inside = pos[pos <= idx.n]
    same(rank.rank6(pt, torch.from_numpy(inside)), idx.rank6(inside.astype(np.int64)))


@pytest.mark.parametrize("mode,width", CASES)
def test_extend_matches_jax_and_checkpoint(index, mode, width):
    idx, _ = index
    jt = as_jax(jax_tables(idx, mode, width), width)
    pt = port_tables(idx, mode, width)
    ck = port_tables(idx, "checkpoint", width)
    rng = np.random.default_rng(1)
    B = 1024
    k = rng.integers(0, idx.n, B)
    s = rng.integers(0, np.minimum(idx.n - k, 3000) + 1)
    s[::4] = rng.integers(0, 4, len(s[::4]))
    s = np.minimum(s, idx.n - k)
    npd = np.int32 if width == "int32" else np.int64
    args = [a.astype(npd) for a in (k, rng.integers(0, idx.n, B), s)]
    code = rng.integers(-1, 8, B).astype(np.int32)
    fwd = rng.integers(0, 2, B).astype(bool)
    for f in (None, fwd):
        with x64(width):
            expect = jax_extend(jt, *(jnp.asarray(a) for a in args), jnp.asarray(code),
                                forward=None if f is None else jnp.asarray(f))
            expect = [np.asarray(e) for e in expect]
        tensors = [torch.from_numpy(a) for a in args] + [torch.from_numpy(code)]
        fw = None if f is None else torch.from_numpy(f)
        got = fmd.extend_plain(pt, *tensors, forward=fw)
        for g, c, e in zip(got, fmd.extend_plain(ck, *tensors, forward=fw), expect):
            assert g.dtype == pt.pos_dtype
            same(g, e)
            same(g, c)


@pytest.mark.parametrize("mode,width", CASES)
def test_seed_table_matches_jax_and_checkpoint(index, mode, width):
    idx, _ = index
    jt = as_jax(jax_tables(idx, mode, width), width)
    pt = port_tables(idx, mode, width)
    with x64(width):
        expect = np.asarray(build_mer_table_device(jt, 5))
    got = mertable.build_mer_table_device(pt, 5)
    same(got, expect)
    same(got, mertable.build_mer_table_device(port_tables(idx, "checkpoint", width), 5))
    same(got, build_mer_table(idx, 5))


@pytest.mark.parametrize("s,min_keep", [(6, 1), (12, 2)])
@pytest.mark.parametrize("mode,width", CASES)
def test_dictionary_matches_jax_and_checkpoint(index, mode, width, s, min_keep):
    """The device dictionary build's plain levels through the mode's tables
    against the JAX frontier program on the same tables, the port's
    checkpoint build and the host build."""
    idx, _ = index
    jt = as_jax(jax_tables(idx, mode, width), width)
    pt = port_tables(idx, mode, width)
    keys, vals = sparsedict.build_sparse_dict_device(idx, pt, s, min_keep)
    assert vals.dtype == pt.pos_dtype
    with x64(width):
        ek, ev = jax_sd.build_sparse_dict_device(idx, jt, s, min_keep=min_keep,
                                                 host_levels_max=4)
        ek, ev = np.asarray(ek), np.asarray(ev)
    same(keys, ek)
    same(vals, ev)
    ck, cv = sparsedict.build_sparse_dict_device(idx, port_tables(idx, "checkpoint", width),
                                                 s, min_keep)
    same(keys, ck)
    same(vals, cv)
    hk, hv = build_sparse_dict(idx, s, min_keep)
    same(keys, hk)
    same(vals, hv)


@pytest.mark.parametrize("tiers", ["none", "dense+sdict"])
@pytest.mark.parametrize("mode,width", CASES)
def test_find_mems_matches_jax_and_checkpoint(index, reads, mode, width, tiers):
    """Counts and every buffered slot of the MEM engine through the mode's
    tables, with and without the seed tiers, against the JAX engine on the
    same tables and the port's checkpoint run."""
    idx, _ = index
    codes, lens = reads
    jt = as_jax(jax_tables(idx, mode, width), width)
    pt = port_tables(idx, mode, width)
    npd = np.int32 if width == "int32" else np.int64
    seeds = {}
    if tiers != "none":
        keys, vals = build_sparse_dict(idx, SDICT_S)
        mk, mv = read_mer_keys_fast(codes, lens, MER_M)
        _, _, di = read_windows_fast(codes, lens, SDICT_S, keys)
        seeds = dict(mer_table=build_mer_table(idx, MER_M).astype(npd), mer_keys=mk,
                     mer_valid=mv, sdict_vals=vals.astype(npd), sdict_idx=di)
    with x64(width):
        expect = find_mems_batch(jt, jnp.asarray(codes), jnp.asarray(lens), MIN_LEN, MIN_OCC,
                                 capacity=8, **{k: jnp.asarray(v) for k, v in seeds.items()},
                                 **({} if not seeds else dict(mer_m=MER_M, sdict_m=SDICT_S)))
        expect = [np.asarray(e) for e in expect]
    kw = {k: torch.from_numpy(v) for k, v in seeds.items()}
    kw.update({} if not seeds else dict(mer_m=MER_M, sdict_m=SDICT_S))
    args = (torch.from_numpy(codes), torch.from_numpy(lens), MIN_LEN, MIN_OCC)
    got = mems.find_mems(pt, *args, capacity=8, **kw)
    ck = mems.find_mems(port_tables(idx, "checkpoint", width), *args, capacity=8, **kw)
    for name, g, c, e in zip(got._fields, got, ck, expect):
        same(g, e, name)
        same(g, c, name)
    assert int(got.count.sum()) > len(lens)


@pytest.mark.parametrize("mode,width", CASES)
def test_count_matches_jax(index, reads, mode, width):
    """The backward search's plain version through the mode's tables (the
    kernel ranks through checkpoint rows or dense records only)."""
    idx, _ = index
    codes, lens = reads
    jt = as_jax(jax_tables(idx, mode, width), width)
    pt = port_tables(idx, mode, width)
    with x64(width):
        ef, es = (np.asarray(a) for a in jrank.count(jt, jnp.asarray(codes),
                                                     jnp.asarray(lens)))
    f, s = count.count(pt, torch.from_numpy(codes), torch.from_numpy(lens))
    same(f, ef)
    same(s, es)
    assert count.COUNT_KINDS == ("ckpt", "ckpt64", "dense", "dense64")


@pytest.mark.parametrize("mode,width", CASES)
def test_tables_from_numpy_carries_the_mode(index, mode, width):
    """bucket_lo and rank_table carried across from the JAX package's
    arrays: the port's own tables, and both packages give the same rank6 on
    them."""
    idx, _ = index
    fields = jax_tables(idx, mode, width)
    pt, _ = tables_from_numpy(fields, None, "cpu")
    own = port_tables(idx, mode, width)
    for f in FIELDS:
        a, b = getattr(pt, f), getattr(own, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    pos = positions(idx, width, seed=3)
    with x64(width):
        expect = np.asarray(jrank.rank6(as_jax(fields, width), jnp.asarray(pos)))
    same(rank.rank6(pt, torch.from_numpy(pos)), expect)
    assert fmd.rank_args(pt)[0] == {"ultra": "ultra", "bucketed": "bucketed"}[mode] + (
        "64" if width == "int64" else "")


def test_kernel_tables_refuse_what_the_kernels_cannot_take(index):
    """The checks before a launch (the same on any device): ultra rows at
    int64 positions, run records of another dtype than run_start, bucketed
    tables without a record of every run, base tables."""
    idx, _ = index
    with pytest.raises(ValueError, match="ultra rows take int32"):
        fmd.check_kernel_tables(port_tables(idx, "ultra", "int64"))
    t = port_tables(idx, "bucketed", "int32")
    fmd.check_kernel_tables(t)
    t.run_rec = t.run_rec.long()
    with pytest.raises(ValueError, match="run_rec: expected torch.int32"):
        fmd.check_kernel_tables(t)
    t = port_tables(idx, "bucketed", "int64")
    fmd.check_kernel_tables(t)
    t.run_rec = t.run_rec[:1]
    with pytest.raises(ValueError, match="records"):
        fmd.check_kernel_tables(t)
    with pytest.raises(ValueError, match="neither"):
        fmd.check_kernel_tables(rindex_to_device(idx, "cpu"))


@pytest.mark.parametrize("mode,width", CASES)
def test_rank_table_guard(index, mode, width):
    """serve.check_rank_tables passes the mode's own tables and catches a
    table that disagrees with the runs."""
    idx, _ = index
    t = port_tables(idx, mode, width)
    check_rank_tables(t, mode)
    if mode == "ultra":
        t.rank_table[int(idx.run_start[8]), 0] += 1
    else:  # the run index entry of run 9's head sends it past its run
        t.run_index[int(idx.run_start[9]) >> t.run_shift, 0] += 1
    with pytest.raises(ValueError, match="disagree"):
        check_rank_tables(t, mode)
