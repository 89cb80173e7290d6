"""The port at n >= 2^31, on the CPU: int64 positions over two-level
checkpoint rows, held against the JAX package exactly (every value is an
integer: tolerance 0) on a small synthetic index whose tables are made as
past 2^31 - the JAX package's own two-level test form,
rindex_to_device(idx, dtype=jnp.int64, checkpoint=True, super_shift=9) and
tags_to_device(tags, dtype=jnp.int64) - and carried across with
tables_from_numpy (CPU tensors: the port's plain versions, which the card's
int64 kernels are held against in tests/test_torch_cuda.py and
chip_smoke.py). Also: the kernels' superblock bases and bit-plane reader
across superblock boundaries, the int64 search tree over heads past 2^31,
locate's int64 tail pairs and bucket index (carried, padded, stubbed and
past 2^31) through the plain walk of the kernel's step, and the k-copy index of chip_smoke.py's serve-2g path against the native
BWT build of the repeated lines."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenome_index_tpu.ops import locate as jax_locate
from pangenome_index_tpu.ops import rank as jrank
from pangenome_index_tpu.ops import sparsedict as jax_sd
from pangenome_index_tpu.ops.fmd import extend as jax_extend
from pangenome_index_tpu.ops.mems import find_mems_batch
from pangenome_index_tpu.ops.mertable import (build_mer_table, build_mer_table_device,
                                              read_mer_keys_fast)
from pangenome_index_tpu.ops.sparsedict import build_sparse_dict, read_windows_fast
from pangenome_index_tpu.ops.tables import rindex_to_device as jax_rindex_to_device
from pangenome_index_tpu.ops.tables import tags_to_device as jax_tags_to_device
from pangenome_index_tpu.ops.tagquery import query_mem_tags as jax_query_mem_tags
from pangenome_index_tpu.ops.tagquery import query_tags_batch as jax_query_tags_batch
from pangenome_index_tpu.parallel import sharding as jax_sharding
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu.utils.synth import build_synth_index, synth_reads, synth_tag_array
from pangenome_index_tpu_torch import native
from pangenome_index_tpu_torch.formats.rlbwt import rlbwt_from_text
from pangenome_index_tpu_torch.models.rindex import build_rindex
from pangenome_index_tpu_torch.models.tagarray import TagArray
from pangenome_index_tpu_torch.ops import (count, fmd, locate, mems, mertable, rank,
                                           sparsedict, tagquery)
from pangenome_index_tpu_torch.ops.tables import (RIndexTables, TagTables,
                                                  derive_search_tree, derive_super_S,
                                                  derive_tail_index, rindex_to_device,
                                                  tables_from_numpy, tail_bucket,
                                                  tail_next_plain, tree_upper_bound_plain)
from pangenome_index_tpu_torch.parallel import sharding
from pangenome_index_tpu_torch.utils import synth as port_synth

SUPER_SHIFT = 9
MIN_LEN, MIN_OCC, MER_M, SDICT_S = 20, 1, 6, 12
RINDEX_FIELDS = ("run_sym", "run_start", "cum", "C", "samples", "last_sorted",
                 "last_to_run", "pos_to_run", "rec", "ckpt", "ckpt_super",
                 "bucket_lo", "rank_table")


@pytest.fixture(autouse=True, scope="module")
def x64_restored():
    """JAX computes at 64 bits here (int64 tables; _pick_dtype would also
    turn it on for the whole process); the flag is restored after the
    module, so that no later test file on this worker computes at 64 bits."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def index():
    return build_synth_index(20_000, 4, seed=2)


@pytest.fixture(scope="module")
def jax_tables(index):
    idx, lines = index
    tags = synth_tag_array(idx, lines)
    jt = jax_rindex_to_device(idx, dtype=jnp.int64, checkpoint=True, super_shift=SUPER_SHIFT)
    jtt = jax_tags_to_device(tags, dtype=jnp.int64)
    assert jt.pos_dtype == jnp.int64 and jt.ckpt_super.shape[1] == 6 + SUPER_SHIFT
    return jt, jtt


@pytest.fixture(scope="module")
def tables(jax_tables):
    """The JAX tables carried across: int64 positions, two-level rows with
    their planes and superblock bases, int64 tag heads and search tree."""
    jt, jtt = jax_tables
    fields = {f: (None if getattr(jt, f) is None else np.asarray(getattr(jt, f)))
              for f in RINDEX_FIELDS}
    fields.update(n=jt.n, n_seq=jt.n_seq, max_len=jt.max_len)
    t, tt = tables_from_numpy(fields, {f: np.asarray(getattr(jtt, f))
                                       for f in ("pos_enc", "bwt_start", "total")}, "cpu")
    assert t.pos_dtype == torch.int64 and t.super_shift == SUPER_SHIFT
    assert t.super_S.shape == (t.ckpt_super.shape[0], 8) and t.super_S.shape[0] > 100
    assert tt.bwt_start.dtype == tt.search_tree.dtype == torch.int64
    assert tt.search_tree.shape[1] == 8
    return t, tt


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


def same(got, expect, what=""):
    g, e = np.asarray(got), np.asarray(expect)
    assert g.shape == e.shape, what
    np.testing.assert_array_equal(g, e, err_msg=what)


def positions(n, B, seed):
    pos = np.random.default_rng(seed).integers(0, n + 1, B)
    pos[:4] = (0, 1, n - 1, n)
    return pos.astype(np.int64)


def test_rank6_matches_jax(index, jax_tables, tables):
    """rank6 of the carried two-level tables at every position: the plain
    reader of the checkpoint rows, the kernels' bit planes with their
    superblock bases, the JAX _ckpt_rank6 and the host model."""
    idx, _ = index
    jt, _ = jax_tables
    t, _ = tables
    pos = np.arange(idx.n + 1, dtype=np.int64)
    expect = np.asarray(jrank.rank6(jt, jnp.asarray(pos)))
    via_rows = rank.rank6(t, torch.from_numpy(pos))
    via_planes = rank.planes_rank6(t.ckpt_planes, torch.from_numpy(pos), t.super_S,
                                   t.super_shift)
    assert via_rows.dtype == via_planes.dtype == torch.int64
    same(via_rows, expect)
    same(via_planes, expect)
    same(via_planes, idx.rank6(pos))


@pytest.mark.parametrize("shift", [6, 7, SUPER_SHIFT, 13])
def test_planes_across_superblock_boundaries(index, shift):
    """The bit-plane reader with the superblock bases against ckpt_rank6
    at pos and pos + s on either side of each superblock boundary, and the
    counts an extension takes between them (rank6(pos + s) - rank6(pos))."""
    idx, _ = index
    t = rindex_to_device(idx, "cpu", checkpoint=True, super_shift=shift, dtype=torch.int64)
    n_super = t.ckpt_super.shape[0]
    assert t.super_S.shape == (n_super, 8) and n_super > 2
    bounds = np.arange(1, n_super, dtype=np.int64) << shift
    bounds = bounds[bounds <= idx.n]
    rng = np.random.default_rng(shift)
    lo = bounds - rng.integers(1, 70, bounds.size)
    hi = np.minimum(bounds + rng.integers(0, 70, bounds.size), idx.n)
    edges = np.concatenate((lo, bounds - 1, bounds, hi, [0, idx.n, idx.n + 1, -1]))
    pt = torch.from_numpy(edges)
    expect = rank.ckpt_rank6(t, pt)
    got = rank.planes_rank6(t.ckpt_planes, pt, t.super_S, shift)
    same(got, expect)
    same(expect[:-3], idx.rank6(np.clip(edges[:-3], 0, idx.n)))
    a, b = rank.planes_rank6(t.ckpt_planes, torch.from_numpy(lo), t.super_S, shift), \
        rank.planes_rank6(t.ckpt_planes, torch.from_numpy(hi), t.super_S, shift)
    same(b - a, idx.rank6(hi) - idx.rank6(lo))
    # the bases: S[j] = positions before the superblock whose q = comp(code) < j
    sup = t.ckpt_super.numpy()[:, :6]
    comp = np.array([0, 5, 3, 2, 4, 1])
    want = np.zeros((n_super, 8), np.int64)
    want[:, 1:7] = np.cumsum(sup[:, comp], axis=1)
    want[:, 7] = want[:, 6]
    same(derive_super_S(t.ckpt_super), want)


def test_extend_matches_jax(index, jax_tables, tables):
    idx, _ = index
    jt, _ = jax_tables
    t, _ = tables
    rng = np.random.default_rng(1)
    B = 2048
    k = rng.integers(0, idx.n, B)
    s = rng.integers(0, np.minimum(idx.n - k, 3000) + 1)
    kp = rng.integers(0, idx.n, B)
    code = rng.integers(0, 6, B)
    fwd = rng.integers(0, 2, B).astype(bool)
    args = [a.astype(np.int64) for a in (k, kp, s)]
    for f in (None, fwd):
        expect = jax_extend(jt, *(jnp.asarray(a) for a in args), jnp.asarray(code, jnp.int32),
                            forward=None if f is None else jnp.asarray(f))
        got = fmd.extend(t, *(torch.from_numpy(a) for a in args),
                         torch.from_numpy(code.astype(np.int32)),
                         forward=None if f is None else torch.from_numpy(f))
        for g, e in zip(got, expect):
            assert g.dtype == torch.int64
            same(g, e)


@pytest.mark.parametrize("tiers", ["none", "dense+sdict"])
def test_find_mems_matches_jax(index, jax_tables, tables, reads, tiers):
    """Counts and every buffered slot of the MEM engine, with and without
    the seed tiers (int64 seed tables, as the port serves them past 2^31)."""
    idx, _ = index
    jt, _ = jax_tables
    t, _ = tables
    codes, lens = reads
    jkw, pkw = {}, {}
    if tiers != "none":
        mt = build_mer_table(idx, MER_M).astype(np.int64)
        mk, mv = read_mer_keys_fast(codes, lens, MER_M)
        keys, vals = build_sparse_dict(idx, SDICT_S)
        _, _, di = read_windows_fast(codes, lens, SDICT_S, keys)
        vals = vals.astype(np.int64)
        jkw = dict(mer_table=jnp.asarray(mt), mer_keys=jnp.asarray(mk),
                   mer_valid=jnp.asarray(mv), mer_m=MER_M, sdict_vals=jnp.asarray(vals),
                   sdict_idx=jnp.asarray(di), sdict_m=SDICT_S)
        pkw = dict(mer_table=torch.from_numpy(mt), mer_keys=torch.from_numpy(mk),
                   mer_valid=torch.from_numpy(mv), mer_m=MER_M,
                   sdict_vals=torch.from_numpy(vals), sdict_idx=torch.from_numpy(di),
                   sdict_m=SDICT_S)
    expect = find_mems_batch(jt, jnp.asarray(codes), jnp.asarray(lens), MIN_LEN, MIN_OCC,
                             capacity=8, **jkw)
    got = mems.find_mems(t, torch.from_numpy(codes), torch.from_numpy(lens), MIN_LEN,
                         MIN_OCC, capacity=8, **pkw)
    assert got.bwt_start.dtype == got.size.dtype == torch.int64
    for name, g, e in zip(got._fields, got, expect):
        same(g, e, name)
    assert int(got.count.sum()) > len(lens)


@pytest.fixture(scope="module")
def buffered(index, tables, reads):
    """A MEM batch's buffers through the int64 tables."""
    t, _ = tables
    codes, lens = reads
    return mems.find_mems(t, torch.from_numpy(codes), torch.from_numpy(lens), MIN_LEN,
                          MIN_OCC, capacity=8)


@pytest.mark.parametrize("capacity", [1, 8])
def test_query_mem_tags_matches_jax(jax_tables, tables, buffered, capacity):
    _, jtt = jax_tables
    _, tt = tables
    r = buffered
    expect = jax_query_mem_tags(jtt, jnp.asarray(r.bwt_start.numpy()),
                                jnp.asarray(r.size.numpy()), jnp.asarray(r.count.numpy()),
                                capacity=capacity)
    got = tagquery.query_mem_tags(tt, r.bwt_start, r.size, r.count, capacity=capacity)
    for g, e in zip(got, expect):
        same(g, e)


@pytest.mark.parametrize("exact", [False, True])
def test_query_tags_batch_matches_jax(index, jax_tables, tables, exact):
    idx, _ = index
    _, jtt = jax_tables
    _, tt = tables
    rng = np.random.default_rng(9)
    start = rng.integers(0, idx.n, 600)
    end = np.minimum(start + rng.integers(0, 400, 600), idx.n - 1)
    expect = jax_query_tags_batch(jtt, jnp.asarray(start), jnp.asarray(end), capacity=64,
                                  exact=exact)
    got = tagquery.query_tags_batch(tt, torch.from_numpy(start), torch.from_numpy(end),
                                    capacity=64, exact=exact)
    for name, g, e in zip(got._fields, got, expect):
        same(g, e, name)
    # the tree walk the kernels take, against the searches of the plain version
    same(tagquery.tag_upper_bound_plain(tt, torch.from_numpy(start)),
         np.searchsorted(np.asarray(jtt.bwt_start), start, side="right"))


def test_count_matches_jax(jax_tables, tables, reads):
    jt, _ = jax_tables
    t, _ = tables
    codes, lens = reads
    ef, es = jrank.count(jt, jnp.asarray(codes), jnp.asarray(lens))
    f, s = count.count(t, torch.from_numpy(codes), torch.from_numpy(lens))
    assert f.dtype == s.dtype == torch.int64
    same(f, ef)
    same(s, es)


def test_locate_batch_matches_jax(index, jax_tables, tables, buffered):
    """locate over int64 tables (and their int64 search trees) at the
    buffered MEMs' intervals and random ones."""
    idx, _ = index
    jt, _ = jax_tables
    t, _ = tables
    assert t.run_tree.dtype == t.tail_pairs.dtype == torch.int64
    r = buffered
    held = r.count.numpy()[:, None] > np.arange(8)[None, :]
    rng = np.random.default_rng(4)
    start = np.concatenate((r.bwt_start.numpy()[held], rng.integers(0, idx.n, 200)))
    size = np.concatenate((r.size.numpy()[held], rng.integers(0, 90, 200)))
    expect = jax_locate.locate_batch(jt, jnp.asarray(start), jnp.asarray(size), capacity=64)
    got = locate.locate_batch(t, torch.from_numpy(start), torch.from_numpy(size), 64)
    for name, g, e in zip(got._fields, got, expect):
        same(g, e, name)
    assert got.positions.dtype == torch.int64


def test_mer_table_matches_jax(jax_tables, tables):
    jt, _ = jax_tables
    t, _ = tables
    got = mertable.build_mer_table_device(t, 5)
    assert got.dtype == torch.int64
    same(got, build_mer_table_device(jt, 5))


@pytest.mark.parametrize("m", [1, 2, 7])
def test_mer_table_plain_over_two_level_rows(index, jax_tables, tables, m):
    """The seed table's plain version (one level a step, the last two
    levels as the card's last launch takes them) over the int64 two-level
    rows equals the JAX device build over the same rows and the host
    build."""
    jt, _ = jax_tables
    t, _ = tables
    got = mertable.build_mer_table_plain(t, m)
    assert got.dtype == torch.int64 and got.shape == (4**m, 3)
    same(got, build_mer_table_device(jt, m))
    same(got, build_mer_table(index[0], m))


@pytest.mark.parametrize("s,min_keep", [(6, 1), (11, 1), (16, 2)])
def test_device_dictionary_matches_jax(index, jax_tables, tables, s, min_keep):
    """The device dictionary build's plain levels over the int64 two-level
    tables against the JAX frontier program on the same tables (s <= 16)
    and the host build."""
    idx, _ = index
    jt, _ = jax_tables
    t, _ = tables
    keys, vals = sparsedict.build_sparse_dict_device(idx, t, s, min_keep)
    assert vals.dtype == torch.int64
    ek, ev = jax_sd.build_sparse_dict_device(idx, jt, s, min_keep=min_keep, host_levels_max=4)
    same(keys, ek)
    same(vals, ev)
    hk, hv = build_sparse_dict(idx, s, min_keep)
    same(keys, hk)
    same(vals, hv)


def test_bucketed_tables_match_jax_and_the_two_level_rows(index, tables, buffered, reads):
    """The int64 bucketed tables (the form find-mems serves --rank-mode dense
    and ultra with past 2^31), carried across from the JAX package's: rank6
    at every position equal to the JAX rank6 on them and to the two-level
    rows', and the MEM batch equal to the two-level tables' (buffered)."""
    idx, _ = index
    t, _ = tables
    jb = jax_rindex_to_device(idx, dtype=jnp.int64)
    assert jb.bucket_lo is not None and jb.bucket_lo.dtype == jnp.int64
    fields = {f: (None if getattr(jb, f) is None else np.asarray(getattr(jb, f)))
              for f in RINDEX_FIELDS}
    fields.update(n=jb.n, n_seq=jb.n_seq, max_len=jb.max_len)
    tb, _ = tables_from_numpy(fields, None, "cpu")
    assert tb.pos_dtype == torch.int64 and fmd.rank_args(tb)[0] == "bucketed64"
    pos = np.arange(idx.n + 2, dtype=np.int64)
    got = rank.rank6(tb, torch.from_numpy(pos))
    same(got, jrank.rank6(jb, jnp.asarray(pos)))
    same(got[:-1], rank.rank6(t, torch.from_numpy(pos[:-1])))
    codes, lens = reads
    res = mems.find_mems(tb, torch.from_numpy(codes), torch.from_numpy(lens), MIN_LEN,
                         MIN_OCC, capacity=8)
    for name, g, e in zip(res._fields, res, buffered):
        same(g, e, name)


def test_int64_search_tree_past_int32():
    """The int64 tree (8 keys a node) over heads past 2^31, against
    torch.searchsorted at every head, its neighbours, values between and
    past them; the tag tables' tree search gives the same."""
    rng = np.random.default_rng(21)
    heads = np.unique(rng.integers(0, 1 << 40, 5000)).astype(np.int64)
    heads[0] = 0
    heads[-1] = 2**33 + 5
    heads = np.unique(heads)
    h = torch.from_numpy(heads)
    tree, levels = derive_search_tree(h)
    assert tree.dtype == torch.int64 and tree.shape[1] == 8 and len(levels) >= 4
    v = torch.cat((h, h - 1, h + 1, torch.tensor([-1, 2**31 - 1, 2**31, 2**62]),
                   torch.from_numpy(rng.integers(0, 1 << 41, 4000))))
    want = torch.searchsorted(h, v, right=True)
    same(tree_upper_bound_plain(tree, levels, h, v), want)
    tt = TagTables(pos_enc=torch.zeros_like(h), bwt_start=h, total=int(heads[-1]) + 1,
                   search_tree=tree, tree_levels=levels)
    same(tagquery.tag_upper_bound(tt, v), want.to(torch.int32))
    # a head of the dtype's maximum could not be told from the padding
    with pytest.raises(ValueError, match="maximum"):
        derive_search_tree(torch.tensor([1, 2**63 - 1]))


def tail_walk_values(t, seed, extra=()):
    """Every tail, its neighbours, below the first tail, around and past the
    packed range, and random values in it (int64)."""
    rng = np.random.default_rng(seed)
    ls = t.last_sorted.long()
    V = t.n_seq * t.max_len
    return torch.cat((ls, ls - 1, ls + 1, torch.tensor([0, -1, int(ls[0]) - 1, V - 1, V, V + 1,
                                                        2**31 - 1, 2**31, 2**40, *extra]),
                      torch.from_numpy(rng.integers(0, V + 10, 4000))))


def jax_view(t):
    """The locate tables of the port's t as the JAX locate_next reads them."""
    from types import SimpleNamespace

    return SimpleNamespace(**{f: jnp.asarray(getattr(t, f).numpy()) for f in (
        "last_sorted", "last_to_run", "samples")}, pos_dtype=jnp.int64)


def test_tail_index_over_int64_tables(index, jax_tables, tables):
    """The int64 tail pairs (16 bytes, 4 a line) and their bucket index of
    the tables carried from JAX equal their definition, and the plain walk
    of the kernel's step equals the JAX locate_next over the JAX tables."""
    jt, _ = jax_tables
    t, _ = tables
    r = t.last_sorted.shape[0]
    run = t.last_to_run + 1
    assert t.tail_pairs.dtype == torch.int64 and t.tail_pairs.shape == (r, 2)
    same(t.tail_pairs[:, 1], t.samples[run] - t.last_sorted)
    bounds = torch.arange(t.tail_lo.shape[0] - 1) << t.tail_shift
    same(t.tail_lo[:-1], torch.searchsorted(t.last_sorted, bounds).int())
    assert int(t.tail_lo[-1]) == r
    v = tail_walk_values(t, 3)
    same(tail_next_plain(t, v), jrank.locate_next(jt, jnp.asarray(v.numpy())))


@pytest.mark.parametrize("S", [3, 5, 8, "mem-only"])
def test_tail_walk_on_padded_int64_tables(index, S):
    """pad_rindex_tables at int64 positions: the sentinel tails (int64 max /
    4, sorted at int64) fall into the last bucket, which reaches r; the
    mem_only stubs hold one tail. The walk equals the JAX locate_next over
    the same arrays."""
    idx, _ = index
    kw = dict(mem_only=True, checkpoint=True) if S == "mem-only" else {}
    t = sharding.pad_rindex_tables(idx, 4 if S == "mem-only" else S, device="cpu",
                                   dtype=torch.int64, **kw)
    pad = t.last_sorted.shape[0] - idx.n_runs
    if S != "mem-only":
        assert pad == (-idx.n_runs) % S and (pad > 0) == (S != 8)
        assert int(t.tail_lo[-1]) == t.last_sorted.shape[0]
    v = tail_walk_values(t, 5)
    same(tail_next_plain(t, v), jrank.locate_next(jax_view(t), jnp.asarray(v.numpy())))


def test_tail_walk_past_int32():
    """Tails past 2^31 in clusters: buckets of 2^27 values, some holding
    more tails than a line of pairs (the kernel's halving search) and most
    none; the walk equals the searchsorted locate_next, wrapping sums
    included."""
    rng = np.random.default_rng(22)
    V = 1 << 40
    spread = rng.integers(0, V, 4000)
    clusters = (rng.integers(0, V >> 20, 40)[:, None] << 20) + rng.integers(0, 1 << 12, (40, 50))
    ls = np.unique(np.concatenate((spread, clusters.ravel(), [2**31 - 1, 2**31])))
    r = len(ls)
    samples = np.append(rng.integers(0, V, r), 0)
    z = torch.zeros(r, dtype=torch.int64)
    t = RIndexTables(run_sym=z.to(torch.int8), run_start=z, cum=z[:, None], C=z[:7],
                     samples=torch.from_numpy(samples), last_sorted=torch.from_numpy(ls),
                     last_to_run=torch.from_numpy(rng.permutation(r)), n=r, n_seq=1,
                     max_len=V)
    t.tail_pairs, t.tail_lo, t.tail_shift = derive_tail_index(
        t.last_sorted, t.samples, t.last_to_run, V)
    assert t.tail_shift == int(np.log2(V // r))
    _, m = tail_bucket(t, t.last_sorted)
    sizes = t.tail_lo[1:] - t.tail_lo[:-1]
    assert int(m.max()) > 4 and bool((sizes == 0).any())
    v = tail_walk_values(t, 6, extra=(2**63 - 1, -2**63))
    same(tail_next_plain(t, v), rank.locate_next(t, v))


def test_k_copy_index_matches_the_native_build():
    """The k-copy index of the serve-2g path at k = 3 and its tag array,
    field for field, against build_rindex of the native BWT of the text in
    which each line is repeated 3 times in a row."""
    import chip_smoke

    k = 3
    idx, lines = port_synth.build_synth_index(3_000, 3, seed=4)
    tags = port_synth.synth_tag_array(idx)
    big, big_tags = chip_smoke.k_copy_index(idx, tags, k)
    repeated = [line for line in lines for _ in range(k)]
    bwt, da, sa_pos, seq_lengths = native.build_bwt_native(repeated)
    want = build_rindex(rlbwt_from_text(bwt.tobytes()))
    for f in ("run_sym", "run_start", "run_len", "cum", "C", "samples", "last_sorted",
              "last_to_run"):
        g, e = getattr(big, f), getattr(want, f)
        assert g.dtype == e.dtype, f
        same(g, e, f)
    assert (big.n, big.n_seq, big.max_len) == (want.n, want.n_seq, want.max_len)
    assert big.n == k * idx.n and (big.run_sym == 0).sum() == k * (idx.run_sym == 0).sum()
    # the tag array: row k * p + j maps to row p's graph position
    per_row = np.repeat(big_tags.pos_enc, big_tags.run_lengths())
    same(per_row, np.repeat(np.repeat(tags.pos_enc, tags.run_lengths()), k))
    assert big_tags.total == k * tags.total
    assert big_tags.run_lengths().max() < 512
    # the port's own index of the repeated text serves the same MEMs, scaled
    sa = build_rindex(rlbwt_from_text(bwt.tobytes())).decompress_sa()
    same(big.decompress_sa(), sa)


def test_index_files_round_trip_past_int32(tmp_path):
    """An index of n >= 2^31 (the k-copy index of a small one: r-sized, so
    cheap) and a tag array covering as many rows write and load back field
    for field: the .ri in both formats, the .tags as compressed bytecode."""
    import chip_smoke
    from pangenome_index_tpu_torch.formats import ri
    from pangenome_index_tpu_torch.formats import tags as tagfmt

    idx, _ = port_synth.build_synth_index(3_000, 3, seed=4)
    k = 2**31 // idx.n + 3
    big, _ = chip_smoke.k_copy_index(idx, None, k)
    assert big.n >= 2**31 and int(big.samples.max()) >= 2**31
    for fmt, data in (("encoded", ri.serialize_encoded(big)),
                      ("legacy", ri.serialize_legacy(big))):
        path = tmp_path / f"big_{fmt}.ri"
        path.write_bytes(data)
        back = ri.load_file(str(path))
        assert (back.n, back.n_seq, back.max_len) == (big.n, big.n_seq, big.max_len)
        for f in ("run_sym", "run_start", "run_len", "cum", "C", "samples",
                  "last_sorted", "last_to_run"):
            same(getattr(back, f), getattr(big, f), f"{fmt} {f}")
    tags = TagArray.from_runs(np.array([0, 5 << 11, 7 << 11, 5 << 11]),
                              np.array([3, 2**31, 1000, 7]))
    path = tmp_path / "big.tags"
    path.write_bytes(tagfmt.write_compressed_bytecode(tags))
    back = tagfmt.load_tags_file(str(path))
    assert back.total == tags.total > 2**31
    same(back.pos_enc, tags.pos_enc)
    same(back.bwt_start, tags.bwt_start)


def test_tag_keys_convert_to_the_heads_dtype():
    """The tag kernels take intervals in their heads' dtype: int32 values
    widen beside int64 heads, and int64 values (the MEM buffers of int64
    r-index tables beside int32 tag heads) clamp into int32, which keeps
    every search's answer since the heads lie in [0, 2^31 - 1)."""
    cpu = torch.device("cpu")
    wide = tagquery._keys("v", torch.tensor([-5, 7], dtype=torch.int32), torch.int64, cpu)
    assert wide.dtype == torch.int64 and wide.tolist() == [-5, 7]
    big = torch.tensor([-2**40, -1, 0, 2**31 - 2, 2**31, 2**50])
    narrow = tagquery._keys("v", big, torch.int32, cpu)
    assert narrow.dtype == torch.int32
    assert narrow.tolist() == [-2**31, -1, 0, 2**31 - 2, 2**31 - 1, 2**31 - 1]
    heads = torch.tensor([0, 3, 2**31 - 2], dtype=torch.int32)
    same(torch.searchsorted(heads, narrow, right=True), torch.searchsorted(heads.long(), big, right=True))
