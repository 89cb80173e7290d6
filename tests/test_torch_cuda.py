"""The port's CUDA kernels against their plain PyTorch versions on the card,
exactly. Needs an NVIDIA Hopper GPU and nvcc; skipped elsewhere. It imports
the port only, so it runs where the JAX package cannot be imported: on the
card, python -m pytest --noconftest tests/test_torch_cuda.py -q"""

import numpy as np
import pytest
import torch

from pangenome_index_tpu_torch import _build, native, serve, spans
from pangenome_index_tpu_torch.ops import (bwt, count, dense_rank, fmd, gather_probe,
                                           mertable,
                                           locate, mems, rank, sparsedict, tagquery)
from pangenome_index_tpu_torch.ops.mertable import build_mer_table, read_mer_keys_fast
from pangenome_index_tpu_torch.ops.sparsedict import build_sparse_dict, read_windows_fast
from pangenome_index_tpu_torch.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu_torch.utils.synth import (build_synth_index, synth_haplotypes,
                                                   synth_reads, synth_tag_array)
from pangenome_index_tpu_torch.models.tagarray import TagArray
from pangenome_index_tpu_torch.ops.tables import (TagTables, rindex_to_device,
                                                  tags_to_device)

pytestmark = pytest.mark.cuda
#: the rank configurations of the chain kernels (K2, K3, the dictionary's
#: level); K7 takes checkpoint rows and dense records only
MODES = ["checkpoint", "dense", "ultra", "bucketed"]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def index():
    return build_synth_index(20_000, 4, seed=2)


@pytest.mark.parametrize("width", [3, 8, 16, 4, 5])
@pytest.mark.parametrize("rows_out", [0, 1, 33, 70_001])
def test_gather_rows_widths(dev, width, rows_out):
    """The row gather at the widths the port gives it (3: the seed table's
    rows, 8: int32 records, 16: int64 records as int32 words) and others,
    against gather_rows_plain: indices clamped at both ends, no rows, one
    row, a table of one row, a table that is a view at an offset of 4 bytes
    (the scalar path) and the records of the bench-like index viewed as
    words (every record, in order)."""
    rng = np.random.default_rng(width * 7 + rows_out)
    for n_rows in (1, 5000):
        rec = torch.from_numpy(rng.integers(-2**31, 2**31, (n_rows, width))
                               .astype(np.int32)).to(dev)
        idx = torch.from_numpy(rng.integers(-5, n_rows + 5, rows_out).astype(np.int32)).to(dev)
        got = dense_rank.gather_rows(rec, idx)
        assert got.shape == (rows_out, width)
        assert torch.equal(got, dense_rank.gather_rows_plain(rec, idx))
        flat = torch.from_numpy(rng.integers(-2**31, 2**31, n_rows * width + 1)
                                .astype(np.int32)).to(dev)
        view = flat[1:].view(n_rows, width)  # 4 bytes past an aligned start
        assert torch.equal(dense_rank.gather_rows(view, idx),
                           dense_rank.gather_rows_plain(view, idx))
    with pytest.raises(ValueError, match="empty table"):
        dense_rank.gather_rows(rec[:0], torch.zeros(1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_gather_rows_of_every_record(dev, index, dtype):
    """Every record of the bench-like index, in order, through the row gather
    as the dense table check takes them (int32 words: 8 a record, 16 at
    int64), equal to the records."""
    idx, _ = index
    t = rindex_to_device(idx, dev, dense=True, dtype=dtype)
    words = t.rec.view(torch.int32)
    assert words.shape[1] == (8 if dtype == torch.int32 else 16)
    runs = torch.arange(idx.n_runs, dtype=torch.int32, device=dev)
    got = dense_rank.gather_rows(words, runs)
    assert torch.equal(got, words) and torch.equal(got.view(dtype), t.rec)


def test_gather_rows_and_rank6_dense(dev, index):
    idx, _ = index
    t = rindex_to_device(idx, dev, dense=True)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.integers(0, idx.n + 1, 1001).astype(np.int32)).to(dev)
    assert torch.equal(dense_rank.rank6_dense(t, pos),
                       dense_rank.rank6_dense_plain(t.rec, t.pos_to_run, pos))
    rows = torch.from_numpy(rng.integers(-5, idx.n_runs + 5, 777).astype(np.int32)).to(dev)
    assert torch.equal(dense_rank.gather_rows(t.rec, rows),
                       dense_rank.gather_rows_plain(t.rec, rows))


def heads_index():
    """An r-index whose lines are full of heads: clusters of 300 one-position
    runs between runs of 70 (random symbols 1..5, run 0 the endmarker's code
    0; no locate data: one sample a run)."""
    from pangenome_index_tpu_torch.models.rindex import RIndex

    rng = np.random.default_rng(9)
    lengths = np.tile(np.concatenate((np.ones(300, np.int64), [70])), 30)
    r = len(lengths)
    sym = rng.integers(1, 6, r).astype(np.int8)
    sym[0] = 0
    start = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    contrib = np.zeros((r, 6), np.int64)
    contrib[np.arange(r), sym] = lengths
    cum = np.zeros((r, 6), np.int64)
    np.cumsum(contrib[:-1], axis=0, out=cum[1:])
    C = np.concatenate(([0], np.cumsum(contrib.sum(axis=0)))).astype(np.int64)
    n = int(lengths.sum())
    return RIndex(run_sym=sym, run_start=start, run_len=lengths, cum=cum, C=C, n=n,
                  n_seq=1, max_len=n, samples=np.zeros(r, np.int64),
                  last_sorted=np.arange(r), last_to_run=np.arange(r))


@pytest.mark.parametrize("which", ["bench-like", "full-of-heads", "bench-like-int64",
                                   "full-of-heads-int64"])
def test_dense_kernels_at_the_line_edges(dev, index, which):
    """Every kernel over dense tables - rank6_dense, K2, K3, K7, the seed
    table's level (one and two deep) and the dictionary's level - equals its
    plain version (which reads pos_to_run, not the lines) at positions with
    p & 63 of 0 and 63, on the bench-like index and on one whose lines are
    full of heads, at int32 positions and at int64 (the *_dense64 entry
    points: int64 records, the same int32 lines); and the dense table guard
    catches a line that disagrees with the records."""
    from pangenome_index_tpu_torch.serve import check_dense_tables

    which, _, width = which.partition("-int")
    pd = torch.int64 if width == "64" else torch.int32
    npd = np.int64 if width == "64" else np.int32
    idx = index[0] if which == "bench-like" else heads_index()
    t = rindex_to_device(idx, dev, dense=True, dtype=pd)
    assert t.pos_dtype == t.rec.dtype == pd and fmd.rank_args(t)[0] == (
        "dense64" if width == "64" else "dense")
    lo, hi = t.dense_lines[:, 1].cpu(), t.dense_lines[:, 2].cpu()
    full = (lo == -2) & (hi == -1)  # bits 1..63 set: 64 heads in a row
    assert bool(full.any()) == (which == "full-of-heads")
    edges = np.concatenate((np.arange(0, idx.n + 2, 64), np.arange(63, idx.n + 2, 64)))
    pos = torch.from_numpy(np.concatenate((edges, [-1, idx.n + 2, idx.n + 70]))
                           .astype(npd)).to(dev)
    r6 = dense_rank.rank6_dense(t, pos)
    assert r6.dtype == pd
    assert torch.equal(r6, dense_rank.rank6_dense_plain(t.rec, t.pos_to_run, pos))
    rng = np.random.default_rng(43)
    B = 6000
    k = rng.choice(edges[edges < idx.n], B)
    s = np.minimum(rng.choice(np.array([0, 1, 63, 64, 65, 128, 1000]), B), idx.n - k)
    args = [torch.from_numpy(a.astype(npd)).to(dev)
            for a in (k, rng.choice(edges[edges < idx.n], B), s)]
    code = torch.from_numpy(rng.integers(-1, 8, B).astype(np.int32)).to(dev)
    fwd = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    for f in (None, fwd):
        for g, e in zip(fmd.extend(t, *args, code, forward=f),
                        fmd.extend_plain(t, *args, code, forward=f)):
            assert torch.equal(g, e)
    if which == "bench-like":
        reads = synth_reads(index[1], 200, 150, error_rate=0.02, seed=14)
        codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                          for r in reads]).astype(np.int32)
    else:
        codes = rng.choice(np.array([1, 2, 3, 5], np.int32), (200, 150))
    c = torch.from_numpy(codes).to(dev)
    n = torch.full((codes.shape[0],), codes.shape[1], dtype=torch.int32, device=dev)
    got, gs = mems.find_mems(t, c, n, 3, 1, capacity=8, with_stats=True)
    want, ws = mems.find_mems_plain(t, c, n, 3, 1, capacity=8, with_stats=True)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    assert torch.equal(gs["steps"], ws["steps"]) and bool((got.count > 0).any())
    lens = torch.from_numpy(rng.integers(0, 151, codes.shape[0]).astype(np.int32)).to(dev)
    for g, e in zip(count.count(t, c, lens), count.count_plain(t, c, lens)):
        assert torch.equal(g, e)
    level = mertable.mer_root(t)
    for _ in range(6):
        for depth in (1, 2):
            assert torch.equal(mertable.mer_level(t, level, depth),
                               mertable.mer_level_plain(t, level, depth))
        level = mertable.mer_level(t, level)
    keys = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    vals = torch.tensor([[[0, 0, idx.n]]], dtype=pd, device=dev)
    counts = [1]
    for lv in range(12):
        got = sparsedict.sdict_level(t, keys, vals, counts, 1, lv)
        counts = same_level(got, sparsedict.sdict_level_plain(t, keys, vals, counts, 1, lv))
        keys, vals = got[:2]
    check_dense_tables(t)
    # a line with a head past its first position: full of them, or with
    # none at its second position (so that filling it moves a head's run)
    line = int(torch.nonzero(full if which == "full-of-heads"
                             else ((lo != 0) | (hi != 0)) & ((lo & 2) == 0))[0])
    t.dense_lines[line, 0] += 1  # the line's runs one later than their records
    with pytest.raises(ValueError, match="disagree"):
        check_dense_tables(t)
    t.dense_lines[line, 0] -= 1
    t.dense_lines[line, 1:3] = torch.tensor([-2, -1] if which == "bench-like" else [0, 0])
    with pytest.raises(ValueError, match="disagree"):
        check_dense_tables(t)


@pytest.mark.parametrize("mode", MODES)
def test_extend(dev, index, mode):
    idx, _ = index
    t = rindex_to_device(idx, dev, **{mode: True})
    rng = np.random.default_rng(1)
    B = 4099
    k = rng.integers(0, idx.n, B)
    s = rng.integers(0, idx.n - k + 1)
    args = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (k, rng.integers(0, idx.n, B), s, rng.integers(0, 6, B))]
    for fwd in (None, torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)):
        got = fmd.extend(t, *args, forward=fwd)
        expect = fmd.extend_plain(t, *args, forward=fwd)
        for g, e in zip(got, expect):
            assert torch.equal(g, e)


def held_mer_table(t, idx, m):
    """The seed table built by the level kernel equals its plain version and
    the host build; the build is max(m - 1, 1) launches, m through
    int64 bucketed runs (the last launch one level deep)."""
    before = mertable.mer_level.launches
    got = mertable.build_mer_table_device(t, m)
    assert mertable.mer_level.launches - before == max(m - mertable.last_depth(t) + 1, 1)
    want = mertable.build_mer_table_plain(t, m)
    assert got.dtype == want.dtype == t.pos_dtype and torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), build_mer_table(idx, m))


@pytest.mark.parametrize("m", [1, 2, 3, 8])
@pytest.mark.parametrize("mode", MODES)
def test_mer_table(dev, index, mode, m):
    """The seed table's level kernel through every rank provider at int32,
    one and two levels a launch."""
    idx, _ = index
    held_mer_table(rindex_to_device(idx, dev, **{mode: True}), idx, m)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_mer_level_at_every_level(dev, index, mode, depth):
    """One launch of the level kernel from each level 0 to 7 against its
    plain version on the same parents (most of them empty past level 7 of
    the small index)."""
    idx, _ = index
    t = rindex_to_device(idx, dev, **{mode: True})
    level = mertable.mer_root(t)
    for _ in range(8):
        assert torch.equal(mertable.mer_level(t, level, depth),
                           mertable.mer_level_plain(t, level, depth))
        level = mertable.mer_level(t, level)


@pytest.mark.parametrize("mode,dtype", [("ultra", torch.int32), ("bucketed", torch.int32),
                                        ("bucketed", torch.int64)])
def test_rank6_ultra_and_bucketed(dev, index, mode, dtype):
    """The ultra and bucketed rank6 kernels against their plain versions at
    every position of the index, the run heads and the positions beside
    them, and the table edges and past them."""
    idx, _ = index
    t = rindex_to_device(idx, dev, dtype=dtype, **{mode: True})
    heads = idx.run_start.astype(np.int64)
    pos = np.concatenate((np.arange(idx.n + 2), heads - 1, heads + 1,
                          [-1, idx.n + 70, 64 * (idx.n // 64 + 5)]))
    pos = torch.from_numpy(pos).to(dev, dtype)
    fn, plain = ((rank.rank6_ultra, rank.rank6_ultra_plain) if mode == "ultra"
                 else (rank.rank6_bucketed, rank.rank6_bucketed_plain))
    before = fn.launches
    got = fn(t, pos)
    assert fn.launches == before + 1 and got.dtype == dtype
    assert torch.equal(got, plain(t, pos))


def test_count_refuses_the_row_modes(dev, index):
    """K7 is instantiated for checkpoint rows and dense records: ultra and
    bucketed tables are refused, not served by another provider."""
    idx, _ = index
    c = torch.ones((2, 4), dtype=torch.int32, device=dev)
    n = torch.full((2,), 4, dtype=torch.int32, device=dev)
    for mode in ("ultra", "bucketed"):
        with pytest.raises(ValueError, match="checkpoint rows or dense records"):
            count.count(rindex_to_device(idx, dev, **{mode: True}), c, n)


def test_rank_planes_match_ckpt(dev, index):
    """The bit-plane table derived on the card: rank6 through it equals
    rank6 through ckpt at every position and at the table's edges."""
    idx, _ = index
    t = rindex_to_device(idx, dev, checkpoint=True)
    edges = [0, 63, 64, idx.n - 1, idx.n, idx.n + 1, 64 * t.ckpt.shape[0] - 1, -1]
    pos = torch.from_numpy(np.concatenate((np.arange(idx.n + 1), edges))
                           .astype(np.int32)).to(dev)
    assert torch.equal(rank.planes_rank6(t.ckpt_planes, pos), rank.ckpt_rank6(t, pos))
    assert torch.equal(t.ckpt_planes.cpu(),
                       rindex_to_device(idx, "cpu", checkpoint=True).ckpt_planes)


@pytest.mark.parametrize("levels", ["one-level", "two-level"])
def test_kernels_through_128_position_rows(dev, index, levels):
    """Checkpoint rows of 128 positions (ckpt_block=128) give the kernels'
    64-position planes derived on the card equal to those on the CPU and to
    the 64-position rows' over their rows; rank6 through them equals the
    128-position rows' at every position; K2, K3 and K7 through them equal
    their plain versions (which read the 128-position rows) and the
    64-position tables' kernels."""
    idx, lines = index
    kw = dict(checkpoint=True) if levels == "one-level" else dict(
        checkpoint=True, super_shift=12, dtype=torch.int64)  # 20 superblocks
    t = rindex_to_device(idx, dev, ckpt_block=128, **kw)
    t64 = rindex_to_device(idx, dev, **kw)
    pd = t.pos_dtype
    assert t.ckpt.shape[1] == 24 and t.ckpt_planes.shape[0] == 2 * t.ckpt.shape[0]
    assert torch.equal(t.ckpt_planes.cpu(),
                       rindex_to_device(idx, "cpu", ckpt_block=128, **kw).ckpt_planes)
    assert torch.equal(t.ckpt_planes[: t64.ckpt_planes.shape[0]], t64.ckpt_planes)
    pos = torch.arange(idx.n + 2, dtype=pd, device=dev)
    sup = {} if t.super_S is None else dict(super_S=t.super_S, super_shift=t.super_shift)
    assert torch.equal(rank.planes_rank6(t.ckpt_planes, pos, **sup).long(),
                       rank.ckpt_rank6(t, pos).long())
    rng = np.random.default_rng(5)
    B = 4096
    k = rng.integers(0, idx.n, B)
    args = [torch.from_numpy(a).to(pd).to(dev) for a in (
        k, rng.integers(0, idx.n, B), np.minimum(rng.integers(0, 3000, B), idx.n - k))]
    code = torch.from_numpy(rng.integers(-1, 8, B).astype(np.int32)).to(dev)
    fwd = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    for g, e, c in zip(fmd.extend(t, *args, code, forward=fwd),
                       fmd.extend_plain(t, *args, code, forward=fwd),
                       fmd.extend(t64, *args, code, forward=fwd)):
        assert torch.equal(g, e) and torch.equal(g, c)
    reads = synth_reads(lines, 200, 150, error_rate=0.02, seed=14)
    c = torch.from_numpy(np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                                   for r in reads]).astype(np.int32)).to(dev)
    n = torch.full((c.shape[0],), c.shape[1], dtype=torch.int32, device=dev)
    got = mems.find_mems(t, c, n, 20, 1, capacity=8)
    for g, e, o in zip(got, mems.find_mems_plain(t, c, n, 20, 1, capacity=8),
                       mems.find_mems(t64, c, n, 20, 1, capacity=8)):
        assert torch.equal(g, e) and torch.equal(g, o)
    assert int(got.count.sum()) > 200
    for g, e, o in zip(count.count(t, c, n), count.count_plain(t, c, n), count.count(t64, c, n)):
        assert torch.equal(g, e) and torch.equal(g, o)


@pytest.mark.parametrize("rows", ["shared", "straddled"])
@pytest.mark.parametrize("mode", MODES)
def test_extend_interval_ends_share_or_straddle_a_row(dev, index, mode, rows):
    idx, _ = index
    t = rindex_to_device(idx, dev, **{mode: True})
    rng = np.random.default_rng(11)
    B = 4096
    if rows == "shared":
        k = rng.integers(0, idx.n - 64, B)
        s = rng.integers(1, 64 - (k & 63) + 1)
        s[::5] = 64 - (k[::5] & 63)           # bk + s exactly on the row edge
    else:
        k = rng.integers(0, idx.n - 4096, B)
        s = rng.integers(64, 4096, B)
    args = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (k, rng.integers(0, idx.n, B), s, rng.integers(-1, 8, B))]
    fwd = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    for g, e in zip(fmd.extend(t, *args, forward=fwd),
                    fmd.extend_plain(t, *args, forward=fwd)):
        assert torch.equal(g, e)


@pytest.mark.parametrize("tiers", ["none", "dense", "sdict"])
def test_find_mems_seed_tiers(dev, index, tiers):
    """K3 with no seed tier and with either one alone (both together:
    test_find_mems_and_tags), at a capacity that overflows, ragged lengths,
    and an N."""
    idx, lines = index
    t = rindex_to_device(idx, dev, checkpoint=True)
    reads = synth_reads(lines, 130, 100, error_rate=0.01, seed=5)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                      for r in reads]).astype(np.int32)
    lens = np.full(len(reads), 100, np.int32)
    lens[::7] = np.random.default_rng(5).integers(0, 100, len(lens[::7]))
    for i, n in enumerate(lens):
        codes[i, n:] = 0
    codes[3, 40] = 4

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    kw = {}
    if tiers == "dense":
        mk, mv = read_mer_keys_fast(codes, lens, 6)
        kw = dict(mer_table=T(build_mer_table(idx, 6).astype(np.int32)),
                  mer_keys=T(mk), mer_valid=T(mv), mer_m=6)
    if tiers == "sdict":
        keys, vals = build_sparse_dict(idx, 19)
        kw = dict(sdict_vals=T(vals), sdict_m=19,
                  sdict_idx=T(read_windows_fast(codes, lens, 19, keys)[2]))
    for min_occ, capacity in ((1, 4), (3, 32)):
        expect, es = mems.find_mems_plain(t, T(codes), T(lens), 20, min_occ,
                                          capacity=capacity, with_stats=True, **kw)
        got, gs = mems.find_mems(t, T(codes), T(lens), 20, min_occ,
                                 capacity=capacity, with_stats=True, **kw)
        for g, e in zip(got, expect):
            assert torch.equal(g, e)
        assert torch.equal(gs["steps"], es["steps"])
    assert bool(expect.count.max() > 4)


@pytest.mark.parametrize("tiers", ["dense", "sdict", "dense+sdict"])
def test_resolve_seeds(dev, index, tiers):
    """The seed-resolving kernel against its plain version: either tier
    alone and both, min_occ 1 and 3."""
    idx, lines = index
    reads = synth_reads(lines, 77, 100, error_rate=0.03, seed=6)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                      for r in reads]).astype(np.int32)
    lens = np.random.default_rng(6).integers(0, 101, len(reads)).astype(np.int32)
    codes[2, 50] = 4

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    kw = {}
    if "dense" in tiers:
        mk, mv = read_mer_keys_fast(codes, lens, 6)
        kw.update(mer_table=T(build_mer_table(idx, 6).astype(np.int32)),
                  mer_keys=T(mk), mer_valid=T(mv), mer_m=6)
    if "sdict" in tiers:
        keys, vals = build_sparse_dict(idx, 19)
        di = read_windows_fast(codes, lens, 19, keys)[2]
        kw.update(sdict_vals=T(vals), sdict_idx=T(di), sdict_m=19)
    for min_occ in (1, 3):
        expect = mems.resolve_seeds_plain(len(reads), 101, min_occ, **kw)
        assert torch.equal(mems.resolve_seeds(len(reads), 101, min_occ, **kw), expect)
    assert bool((expect[..., 3] > 0).any()) and bool((expect[..., 3] == 0).any())
    assert mems.resolve_seeds(4, 101, 1) is None


@pytest.mark.parametrize("mode", MODES)
def test_find_mems_and_tags(dev, index, mode):
    idx, lines = index
    t = rindex_to_device(idx, dev, **{mode: True})
    reads = synth_reads(lines, 200, 150, error_rate=0.02, seed=3)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                      for r in reads]).astype(np.int32)
    lens = np.full(len(reads), 150, np.int32)
    mk, mv = read_mer_keys_fast(codes, lens, 8)
    keys, vals = build_sparse_dict(idx, 19)
    _, _, di = read_windows_fast(codes, lens, 19, keys)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    kw = dict(mer_table=T(build_mer_table(idx, 8).astype(np.int32)),
              mer_keys=T(mk), mer_valid=T(mv), mer_m=8, sdict_vals=T(vals),
              sdict_idx=T(di), sdict_m=19)
    got, gs = mems.find_mems(t, T(codes), T(lens), 20, 1, capacity=8,
                             with_stats=True, **kw)
    expect, es = mems.find_mems_plain(t, T(codes), T(lens), 20, 1, capacity=8,
                                      with_stats=True, **kw)
    for g, e in zip(got, expect):
        assert torch.equal(g, e)
    assert torch.equal(gs["steps"], es["steps"])
    tt = tags_to_device(synth_tag_array(idx), dev)
    for g, e in zip(tagquery.query_mem_tags(tt, got.bwt_start, got.size, got.count, 8),
                    tagquery.query_mem_tags_plain(tt, got.bwt_start, got.size,
                                                  got.count, 8)):
        assert torch.equal(g, e)


def test_kernels_refuse_two_level_tables(dev, index):
    idx, _ = index
    t = rindex_to_device(idx, dev, checkpoint=True, super_shift=9)
    z = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="two-level"):
        fmd.extend(t, z, z, z, z)


@pytest.mark.parametrize("group", [1, 8, 64])
def test_row_gather(dev, group):
    rng = np.random.default_rng(group)
    R, B = 4099, 4096
    T = torch.from_numpy(rng.integers(0, 1 << 20, (R, gather_probe.WIDTH))
                         .astype(np.int32)).to(dev)
    heads = rng.integers(0, (R - group) // group, B // group) * group
    idx = torch.from_numpy(heads.repeat(group).astype(np.int32)).to(dev)
    expect = gather_probe.row_gather_plain(T, idx, group)
    for depth in gather_probe.DEPTHS:
        assert torch.equal(gather_probe.row_gather(T, idx, group, depth), expect)


def test_gather_chain(dev):
    rng = np.random.default_rng(0)
    T = torch.from_numpy(rng.integers(0, 1 << 20, (312_500, gather_probe.WIDTH))
                         .astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 312_500, 1000).astype(np.int32)).to(dev)
    assert torch.equal(gather_probe.gather_chain(T, idx),
                       gather_probe.gather_chain_plain(T, idx))


@pytest.mark.parametrize("mode", ["checkpoint", "dense"])
def test_count(dev, index, mode):
    idx, lines = index
    t = rindex_to_device(idx, dev, **{mode: True})
    reads = synth_reads(lines, 300, 120, error_rate=0.01, seed=4)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                      for r in reads]).astype(np.int32)
    lens = np.random.default_rng(4).integers(0, 121, len(reads)).astype(np.int32)
    codes[5, 7] = 4  # an N
    c, n = (torch.from_numpy(a).to(dev) for a in (codes, lens))
    got = count.count(t, c, n)
    expect = count.count_plain(t, c, n)
    for g, e in zip(got, expect):
        assert torch.equal(g, e)
    assert bool((got[0] <= got[1]).any()) and bool((got[0] > got[1]).any())


@pytest.mark.parametrize("width,n_reads", [(0, 5), (1, 70), (150, 1000),
                                           (256, 130), (257, 64), (700, 333)])
@pytest.mark.parametrize("mode", ["checkpoint", "dense"])
def test_count_staged_windows(dev, index, mode, width, n_reads):
    """K7 across its staging windows (256 positions) and block edges (64
    reads): reads that occur over their whole length, reads with an N or an
    endmarker code, codes outside 0..5, length 0, and lengths past the padded
    width (code 0 there: no match)."""
    idx, lines = index
    t = rindex_to_device(idx, dev, **{mode: True})
    rng = np.random.default_rng(width + n_reads)
    codes = np.zeros((n_reads, width), np.int32)
    if width:
        reads = synth_reads(lines, n_reads, width, error_rate=0.0, seed=width)
        codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                          for r in reads]).astype(np.int32)
    lens = rng.integers(0, width + 1, n_reads).astype(np.int32)
    lens[::3] = width                      # whole reads: every step taken
    lens[1::11] = width + rng.integers(1, 400, len(lens[1::11]))  # past the width
    lens[2::13] = 0
    if width:
        spoil = rng.integers(0, width, n_reads)
        for i in range(4, n_reads, 5):     # an N, an endmarker, codes off the alphabet
            codes[i, spoil[i]] = (4, 0, 6, -1, 15, 16)[(i // 5) % 6]
    c, n = (torch.from_numpy(a).to(dev) for a in (codes, lens))
    got = count.count(t, c, n)
    expect = count.count_plain(t, c, n)
    for g, e in zip(got, expect):
        assert torch.equal(g, e)
    if width >= 150:
        found = got[0] <= got[1]
        assert bool(found[::3].any()) and bool((~found).any())


def same_level(got, expect):
    """Two sdict_level results: the regions as far as their totals, the
    offsets and the totals equal, dtypes too (the kernel leaves a region's
    rows past its total unwritten)."""
    (gk, gv, go, gt), (ek, ev, eo, et) = got, expect
    assert gk.shape == ek.shape and gv.shape == ev.shape
    assert go.dtype == eo.dtype and torch.equal(go, eo)
    assert gt.dtype == et.dtype and torch.equal(gt, et)
    counts = gt.tolist()
    for g, e in zip(sparsedict.sdict_pack(gk, gv, counts),
                    sparsedict.sdict_pack(ek, ev, counts)):
        assert g.dtype == e.dtype and torch.equal(g, e)
    return counts


@pytest.mark.parametrize("min_keep", [1, 2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_sdict_levels(dev, index, mode, min_keep):
    """The dictionary's level kernel against its plain version at every
    level of a build (one entry, a partial block, many blocks, so a
    look-back over many predecessors), and the whole build against the host
    build."""
    idx, _ = index
    t = rindex_to_device(idx, dev, **{mode: True})
    keys = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    vals = torch.tensor([[[0, 0, idx.n]]], dtype=torch.int32, device=dev)
    counts = [1]
    for level in range(20):
        got = sparsedict.sdict_level(t, keys, vals, counts, min_keep, level)
        expect = sparsedict.sdict_level_plain(t, keys, vals, counts, min_keep, level)
        counts = same_level(got, expect)
        keys, vals = got[:2]
    keys, vals = sparsedict.sdict_pack(keys, vals, counts)
    assert keys.shape[0] > 10 * sparsedict.LEVEL_BLOCK
    hk, hv = build_sparse_dict(idx, 20, min_keep)
    assert np.array_equal(keys.cpu().numpy(), hk) and np.array_equal(vals.cpu().numpy(), hv)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("blocks", [1, 3, 64])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_sdict_level_across_the_block_partition(dev, index, mode, blocks, edge):
    """D = k LEVEL_BLOCK - 1, k LEVEL_BLOCK, k LEVEL_BLOCK + 1 entries cut
    into four regions off the blocks' edges, kernel against plain."""
    idx, _ = index
    t = rindex_to_device(idx, dev, **{mode: True})
    hk, hv = build_sparse_dict(idx, 11, 1)
    D = blocks * sparsedict.LEVEL_BLOCK + edge
    assert len(hk) > D
    cuts = [0, D // 5, D // 5 + 1, (3 * D) // 4, D]
    w = max(b - a for a, b in zip(cuts, cuts[1:])) + 5
    keys = torch.full((4, w), -7, dtype=torch.int64)
    vals = torch.full((4, w, 3), -7, dtype=torch.int32)
    for r, (a, b) in enumerate(zip(cuts, cuts[1:])):
        keys[r, : b - a] = torch.from_numpy(hk[a:b])
        vals[r, : b - a] = torch.from_numpy(hv[a:b])
    counts = [b - a for a, b in zip(cuts, cuts[1:])]
    keys, vals = keys.to(dev), vals.to(dev)
    same_level(sparsedict.sdict_level(t, keys, vals, counts, 1, 11),
               sparsedict.sdict_level_plain(t, keys, vals, counts, 1, 11))


@pytest.mark.parametrize("s,min_keep", [(1, 1), (19, 1), (31, 1), (31, 2), (12, 3)])
@pytest.mark.parametrize("mode", MODES)
def test_sdict_build_matches_host(dev, index, mode, s, min_keep, tmp_path):
    idx, _ = index
    t = rindex_to_device(idx, dev, **{mode: True})
    hk, hv = build_sparse_dict(idx, s, min_keep)
    before = sparsedict.sdict_level.launches
    keys, vals = sparsedict.get_sparse_dict(idx, s, path=str(tmp_path / "d.npz"),
                                            min_keep=min_keep, tables=t)
    assert sparsedict.sdict_level.launches - before == s
    assert vals.device == dev and vals.dtype == torch.int32
    assert np.array_equal(keys, hk) and np.array_equal(vals.cpu().numpy(), hv)
    with np.load(tmp_path / "d.npz", allow_pickle=False) as z:
        assert np.array_equal(z["keys"], hk) and np.array_equal(z["vals"], hv)


def test_sdict_empty_and_budget(dev, index):
    idx, _ = index
    t = rindex_to_device(idx, dev, checkpoint=True)
    keys, vals = sparsedict.build_sparse_dict_device(idx, t, 6, min_keep=idx.n + 1)
    assert keys.shape == (0,) and vals.shape == (0, 3) and keys.device == dev
    with pytest.raises(MemoryError, match="needs"):
        sparsedict.build_sparse_dict_device(idx, t, 12, max_bytes=4096)
    sparsedict.build_sparse_dict_device(idx, t, 12)  # the card's own budget


@pytest.mark.parametrize("capacity", [1, 48, 64])
def test_locate_batch(dev, index, capacity):
    """K8 against its plain version on the card and against the host SA:
    intervals at run heads, mid-run and anywhere, sizes 0 to 200 and to
    the end of the BWT; a warp whose lanes chase for different lengths."""
    idx, _ = index
    t = rindex_to_device(idx, dev, checkpoint=True)
    rng = np.random.default_rng(capacity)
    B = 3001
    j = rng.integers(0, idx.n_runs, B)
    start = idx.run_start[j] + np.where(rng.random(B) < 0.5, 0,
                                        rng.integers(0, idx.run_len[j]))
    start[::7] = rng.integers(0, idx.n, len(start[::7]))
    size = np.minimum(rng.integers(0, 201, B), idx.n - start)
    size[5:9] = idx.n - start[5:9]
    st = torch.from_numpy(start.astype(np.int32)).to(dev)
    sz = torch.from_numpy(size.astype(np.int32)).to(dev)
    before = locate.locate_batch.launches
    got = locate.locate_batch(t, st, sz, capacity)
    assert locate.locate_batch.launches == before + 1
    expect = locate.locate_batch_plain(t, st, sz, capacity)
    for g, e in zip(got, expect):
        assert g.dtype == e.dtype and torch.equal(g, e)
    sa = idx.decompress_sa()
    pos, cnt = got.positions.cpu().numpy(), got.count.cpu().numpy()
    for i in range(0, B, 37):
        assert np.array_equal(pos[i, : cnt[i]], sa[start[i] : start[i] + cnt[i]])


@pytest.mark.parametrize("capacity", [1, 64])
def test_locate_batch_outside_the_bwt(dev, index, capacity):
    """K8 against its plain version where start lies before the BWT (down to
    the least int32: the last sample, no chase) or at and just past its end,
    sizes -2 to 200, beside lanes inside it in the same warps."""
    idx, _ = index
    t = rindex_to_device(idx, dev, checkpoint=True)
    rng = np.random.default_rng(capacity + 5)
    B = 1000
    start = rng.integers(0, idx.n, B)
    start[::3] = -rng.integers(1, 1000, len(start[::3]))
    start[1::5] = idx.n + rng.integers(0, 4, len(start[1::5]))
    start[:2] = (-2**31, -1)
    size = rng.integers(-2, 201, B)
    st = torch.from_numpy(start.astype(np.int32)).to(dev)
    sz = torch.from_numpy(size.astype(np.int32)).to(dev)
    got = locate.locate_batch(t, st, sz, capacity)
    expect = locate.locate_batch_plain(t, st, sz, capacity)
    for g, e in zip(got, expect):
        assert g.dtype == e.dtype and torch.equal(g, e)


def test_locate_refuses_tables_without_trees(dev, index):
    """Tables without the run tree or the tail index are refused on the
    card, before any launch."""
    idx, _ = index
    from dataclasses import replace

    t = rindex_to_device(idx, dev, checkpoint=True)
    z = torch.zeros(4, dtype=torch.int32, device=dev)
    before = locate.locate_batch.launches
    for missing in ("run_tree", "tail_pairs", "tail_lo"):
        with pytest.raises(ValueError, match="search tree and tail index"):
            locate.locate_batch(replace(t, **{missing: None}), z, z)
    assert locate.locate_batch.launches == before


def rebucketed(t, shift):
    """t with its tail bucket index over buckets of 2^shift values: fuller
    buckets than the derivation's, which the kernel searches by halving."""
    from dataclasses import replace

    V = t.n_seq * t.max_len
    nb = -(-V >> shift)
    lo = torch.searchsorted(t.last_sorted.long(),
                            torch.arange(nb, device=t.device, dtype=torch.int64) << shift)
    r = torch.tensor([t.last_sorted.shape[0]], device=t.device)
    return replace(t, tail_lo=torch.cat((lo, r)).int(), tail_shift=shift)


def held_locate(t, start, size, capacity, dev):
    """K8 equals locate_batch_plain on the card, in one counted launch."""
    dt = t.pos_dtype
    st, sz = (torch.from_numpy(np.asarray(a, np.int64)).to(dev, dt) for a in (start, size))
    before = locate.locate_batch.launches
    got = locate.locate_batch(t, st, sz, capacity)
    torch.cuda.synchronize()
    assert locate.locate_batch.launches == before + 1
    expect = locate.locate_batch_plain(t, st, sz, capacity)
    for g, e in zip(got, expect):
        assert g.dtype == e.dtype and torch.equal(g, e)
    return got


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("extra", [0, 3, 6])
def test_locate_batch_through_full_buckets(dev, index, dtype, extra):
    """K8 through buckets 2^extra times wider than the derivation's: at 3
    and 6 most steps meet a bucket of more tails than a line holds pairs (8
    at int32, 4 at int64) and take the halving search, at 0 (the derived
    index) few or none; intervals inside and outside the BWT."""
    idx, _ = index
    t = rindex_to_device(idx, dev, checkpoint=True, dtype=dtype)
    t = rebucketed(t, t.tail_shift + extra)
    sizes = (t.tail_lo[1:] - t.tail_lo[:-1]).long()
    line = 64 // (2 * t.pos_dtype.itemsize)
    if extra:
        assert int(sizes.max()) > line
    rng = np.random.default_rng(extra)
    B = 2000
    start = rng.integers(0, idx.n, B)
    start[::9] = -rng.integers(1, 100, len(start[::9]))
    start[1::13] = idx.n + rng.integers(0, 3, len(start[1::13]))
    size = np.minimum(rng.integers(-1, 120, B), idx.n - start)
    got = held_locate(t, start, size, 64, dev)
    sa = idx.decompress_sa()
    pos, cnt = got.positions.cpu().numpy(), got.count.cpu().numpy().clip(min=0)
    for i in range(0, B, 41):
        if 0 <= start[i] < idx.n:
            assert np.array_equal(pos[i, : cnt[i]], sa[start[i] : start[i] + cnt[i]])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_locate_batch_single_run(dev, dtype):
    """An index of one run (one tail, one or two buckets): every step wraps
    to the lone tail; starts before, inside and past the run, capacity 1
    and 8."""
    from pangenome_index_tpu_torch.ops.tables import RIndexTables, with_locate_tables

    def put(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    t = with_locate_tables(RIndexTables(
        run_sym=torch.zeros(1, dtype=torch.int8, device=dev), run_start=put([0]),
        cum=put([[0] * 6]), C=put([0] * 7), samples=put([5, 0]), last_sorted=put([7]),
        last_to_run=put([0]), n=40, n_seq=1, max_len=64))
    assert t.tail_pairs.shape == (1, 2)
    start = np.array([-3, -1, 0, 1, 5, 39, 40, 41, 20, 0])
    size = np.array([4, 1, 0, 12, 3, 1, 2, -1, 8, 8])
    for capacity in (1, 8):
        held_locate(t, start, size, capacity, dev)


@pytest.mark.parametrize("capacity", [1, 8, 256])
@pytest.mark.parametrize("exact", [False, True])
def test_query_tags_batch(dev, index, capacity, exact):
    idx, _ = index
    tt = tags_to_device(synth_tag_array(idx), dev)
    rng = np.random.default_rng(capacity)
    B = 2000
    start = rng.integers(0, idx.n, B)
    end = np.minimum(start + np.where(rng.random(B) < 0.5, rng.integers(0, 4, B),
                                      rng.integers(0, 5000, B)), idx.n - 1)
    start[-16:], end[-16:] = end[-16:] + 1, start[-16:].copy()  # start > end
    s, e = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (start, end))
    got = tagquery.query_tags_batch(tt, s, e, capacity, exact)
    expect = tagquery.query_tags_batch_plain(tt, s, e, capacity, exact)
    for name, g, x in zip(got._fields, got, expect):
        assert torch.equal(g, x), name


def repeating_tags(t=3000, seed=0):
    """A tag array whose positions repeat (the dedupe has work) and hold one
    INT64_MAX (never kept); runs of 1 to 5 rows."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 400, t) * 7
    pos[1234 % t] = np.iinfo(np.int64).max
    return TagArray.from_runs(pos, rng.integers(1, 6, t))


@pytest.mark.parametrize("t", [0, 1, 16, 17, 273, 4625, 21142])
def test_tag_upper_bound(dev, t):
    """The tree descent on the card against torch.searchsorted and the plain
    walk of the same tree."""
    rng = np.random.default_rng(t)
    heads = np.sort(rng.integers(3, 3 + 4 * max(t, 1), t))
    tags = TagArray(pos_enc=np.zeros(t, np.int64), bwt_start=heads, total=int(4 * t + 8))
    tt = tags_to_device(tags, dev)
    v = np.concatenate((heads, heads - 1, heads + 1, [0, -1, -2**31, 2**31 - 2, 2**31 - 1],
                        rng.integers(0, 4 * t + 20, 5000))).astype(np.int32)
    vd = torch.from_numpy(v).to(dev)
    got = tagquery.tag_upper_bound(tt, vd)
    assert torch.equal(got.long(), torch.searchsorted(tt.bwt_start, vd, right=True))
    assert torch.equal(got, tagquery.tag_upper_bound_plain(tt, vd))


@pytest.mark.parametrize("capacity", [1, 8, 9, 32])
def test_query_mem_tags_partial_and_empty_reads(dev, capacity):
    """Reads with count < M, count = 0 and count > M, MEMs of one row to
    hundreds of runs; the slots past min(count, M) hold arbitrary values."""
    tags = repeating_tags(seed=capacity)
    tt = tags_to_device(tags, dev)
    rng = np.random.default_rng(capacity)
    B, M = 700, 8
    bwt = rng.integers(0, tags.total - 1, (B, M))
    size = np.where(rng.random((B, M)) < 0.6, rng.integers(1, 12, (B, M)),
                    rng.integers(1, 900, (B, M)))
    size = np.minimum(size, tags.total - bwt)
    count = rng.integers(0, M + 3, B)
    count[:40] = 0
    args = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (bwt, size, count)]
    got = tagquery.query_mem_tags(tt, *args, capacity=capacity)
    expect = tagquery.query_mem_tags_plain(tt, *args, capacity=capacity)
    for g, e in zip(got, expect):
        assert torch.equal(g, e)
    assert bool(got[1].any()) and not bool(got[0][:40].any())


@pytest.mark.parametrize("capacity", [1, 8, 33, 256, 300])
@pytest.mark.parametrize("exact", [False, True])
def test_query_tags_batch_wide_rows(dev, capacity, exact):
    """Rows of every width from 1 run to past the capacity: the thread's,
    the warp's and the block's sort, and a batch that is no multiple of a
    block's rows."""
    tags = repeating_tags(seed=capacity)
    tt = tags_to_device(tags, dev)
    rng = np.random.default_rng(capacity)
    t = tags.n_runs
    spans = np.concatenate((np.arange(1, 70), [127, 128, 129, 255, 256, 257, 300, 511,
                                               600], rng.integers(1, 400, 1000)))
    first = rng.integers(0, t, len(spans))
    last = np.minimum(first + spans - 1, t - 1)
    start, end = tags.bwt_start[first], tags.bwt_start[last]
    start[-3:] = (0, tags.bwt_start[-3], tags.bwt_start[1230])
    end[-3:] = (tags.bwt_start[40], tags.total - 1, tags.bwt_start[1240])
    s, e = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (start, end))
    got = tagquery.query_tags_batch(tt, s, e, capacity, exact)
    expect = tagquery.query_tags_batch_plain(tt, s, e, capacity, exact)
    for name, g, x in zip(got._fields, got, expect):
        assert torch.equal(g, x), name
    assert bool(got.overflow.any()) and not bool(got.overflow.all())
    assert len(spans) % 128 != 0


def test_query_tags_batch_refuses_a_capacity_past_the_sort_buffer(dev, index):
    idx, _ = index
    tt = tags_to_device(synth_tag_array(idx), dev)
    z = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="capacities up to"):
        tagquery.query_tags_batch(tt, z, z, tagquery.MAX_BATCH_CAPACITY + 1)
    got = tagquery.query_tags_batch(tt, z, z, tagquery.MAX_BATCH_CAPACITY)
    expect = tagquery.query_tags_batch_plain(tt, z, z, tagquery.MAX_BATCH_CAPACITY)
    assert torch.equal(got.positions, expect.positions)


def test_tag_kernels_refuse_tables_without_the_tree(dev, index):
    """No binary-search route on the card: tables built by hand, without
    the search tree, are refused by every wrapper that searches."""
    idx, _ = index
    tt = tags_to_device(synth_tag_array(idx), dev)
    bare = TagTables(pos_enc=tt.pos_enc, bwt_start=tt.bwt_start, total=tt.total)
    z = torch.zeros(8, dtype=torch.int32, device=dev)
    for call in (lambda: tagquery.tag_upper_bound(bare, z),
                 lambda: tagquery.query_tags_batch(bare, z, z, 8),
                 lambda: tagquery.query_mem_tags(bare, z[None, :], z[None, :], z[:1], 8)):
        with pytest.raises(ValueError, match="search tree"):
            call()


def bwt_lines(case):
    """Line sets of the BWT kernels' cases, from seeds."""
    rng = np.random.default_rng(41)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if case == "one-char":  # n = 2
        return [b"A"]
    if case == "below-a-block":
        return [rng.choice(acgt, n).tobytes() for n in (1, 30, 2, 60)]
    if case == "ragged":  # n = 3 tiles of 4096 + 17
        return synth_reads([rng.choice(acgt, 5000).tobytes()], 5, 2460, 0.05, seed=3)
    if case == "past-255":  # 300 separators: symbol keys of 9 bits
        return [rng.choice(acgt, int(n)).tobytes() for n in rng.integers(1, 13, 300)]
    if case == "identical":
        return [rng.choice(acgt, 1000).tobytes()] * 4
    if case == "empty-lines":  # lines of length 0: lone separators
        return [b"AC", b"", b"G", b"", b""]
    if case == "many-lines":  # 2100 lines, most of length 0 to 3
        return [rng.choice(acgt, int(n)).tobytes() for n in rng.integers(0, 4, 2100)]
    return build_synth_index(100_000, 3, seed=5)[1]  # "many-tiles": 300003


@pytest.mark.parametrize("case", ["one-char", "below-a-block", "ragged", "past-255",
                                  "identical", "empty-lines", "many-lines",
                                  "many-tiles"])
def test_bwt_kernels(dev, case):
    """Every round's sort (keys and payload) and rerank (ranks and largest)
    equal their plain versions; the last round's payload is the inverse of
    its ranks; the finish on it equals its plain version; the build equals
    native SA-IS."""
    lines = bwt_lines(case)
    keys, starts, _, top = bwt.text_keys(lines)
    n = keys.size
    if case == "ragged":
        assert n == 3 * bwt.TILE + 17
    keys_d = torch.from_numpy(keys).to(dev)
    rank, k = keys_d, 0
    while True:
        bits = max(1, top.bit_length())
        got = bwt.bwt_sort_pairs(rank, k, bits)
        want = bwt.bwt_sort_pairs_plain(rank, k, bits)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), k
        new, new_top = bwt.bwt_rerank(*got)
        want = bwt.bwt_rerank_plain(*got)
        assert torch.equal(new, want[0]) and torch.equal(new_top, want[1]), k
        rank, top, order = new, int(new_top), got[1]
        if top == n - 1 or k >= n:
            break
        k = 1 if k == 0 else 2 * k
    assert top == n - 1
    assert torch.equal(rank[order.long()], torch.arange(n, dtype=torch.int32, device=dev))
    starts_d = torch.from_numpy(starts).to(dev)
    got = bwt.bwt_finish(order, keys_d, starts_d)
    want = bwt.bwt_finish_plain(order, keys_d, starts_d)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for g, w in zip(bwt.bwt_from_lines_device(lines, dev), native.build_bwt_native(lines)):
        np.testing.assert_array_equal(g, w)


def held_finish(dev, order, keys, starts, misaligned=False):
    """The finish against its plain version; misaligned: the inputs are
    views one element past their allocation (the kernels' scalar path)."""
    def T(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        if not misaligned:
            return t
        flat = torch.empty(a.size + 1, dtype=t.dtype, device=dev)
        flat[1:] = t
        return flat[1:]

    args = [T(a) for a in (order.astype(np.int32), keys.astype(np.int32), starts)]
    before = bwt.bwt_finish.launches
    got, want = bwt.bwt_finish(*args), bwt.bwt_finish_plain(*args)
    assert bwt.bwt_finish.launches == before + 2
    assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


#: rows a block of the finish's read-off takes (a row a thread), and keys a
#: block of its first launch takes (4 a thread)
FINISH_ROWS, SYMBOL_KEYS = 256, 1024


@pytest.mark.parametrize("n,lines", [
    (1, 1), (FINISH_ROWS - 1, 1), (FINISH_ROWS, 1), (FINISH_ROWS + 1, 1),
    (SYMBOL_KEYS - 1, 1), (SYMBOL_KEYS, 1), (SYMBOL_KEYS + 1, 1), (4099, 7),
    (50_001, 2049), (50_001, 25_000)],
    ids=["n-1", "block-1", "block", "block+1", "keys-block-1", "keys-block",
         "keys-block+1", "ragged", "many-lines", "short-lines"])
def test_bwt_finish_at_the_edges(dev, n, lines):
    """The two-launch finish against its plain version at n = 1, one below,
    at and one above a block's rows in each launch, with one line, many
    lines (a deep search of the line starts) and lines of length 0 (lone
    separators: starts one apart) among many; through a random order and a
    reversed one, on aligned inputs and on offset ones (the first launch's
    scalar path)."""
    rng = np.random.default_rng(n + lines)
    cuts = np.sort(rng.choice(np.arange(1, n), lines - 1, replace=False))
    starts = np.concatenate(([0], cuts, [n])).astype(np.int64)
    keys = rng.integers(0, lines + 256, n)
    if lines == 25_000:
        assert (np.diff(starts) == 1).any()
    for order in (rng.permutation(n), np.arange(n)[::-1]):
        for misaligned in (False, True):
            held_finish(dev, order, keys, starts, misaligned)


def test_bwt_finish_bench_text(dev):
    """The finish on the bench text (20,000,008 keys, 8 lines) through the
    order rotation_rank keeps (the last round's payload, checked to be the
    inverse of its ranks), against its plain version."""
    lines = synth_haplotypes(2_500_000, 8, 0.002, 3)
    keys, starts, _, top_key = bwt.text_keys(lines)
    keys_d = torch.from_numpy(keys).to(dev)
    rank, top, order = bwt.rotation_rank(keys_d, top_key)
    n = keys.size
    assert top == n - 1 and n == 20_000_008
    assert torch.equal(rank[order.long()], torch.arange(n, dtype=torch.int32, device=dev))
    args = (order, keys_d, torch.from_numpy(starts).to(dev))
    got, want = bwt.bwt_finish(*args), bwt.bwt_finish_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_bwt_sort_pairs_at_every_shift(dev):
    """The radix sort on random ranks of every width from 1 to 31 bits, at
    k = 0 and k > 0 (up to 62-bit keys, 8 passes)."""
    rng = np.random.default_rng(9)
    n = 70_001
    for bits in (1, 4, 8, 9, 16, 25, 31):
        rank = torch.from_numpy(rng.integers(0, 2**bits, n).astype(np.int32)).to(dev)
        for k in (0, 1, 12345):
            got = bwt.bwt_sort_pairs(rank, k, bits)
            want = bwt.bwt_sort_pairs_plain(rank, k, bits)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (bits, k)


@pytest.mark.parametrize("n", [1, 2, 4095, 4096, 4097, 3 * 4096 + 17, 300_001])
@pytest.mark.parametrize("k,bits", [(0, 8), (1, 4), (0, 9), (1, 5), (1, 17), (7, 25),
                                    (5, 31)])
def test_bwt_sort_pairs_at_the_digit_edges(dev, n, k, bits):
    """The onesweep sort at the key widths where its digit plan changes (one
    pass, two, a partial last digit, 62 bits) and at tile edges, on random
    ranks, on ranks of a few values (long runs of one digit through the
    look-back), and on one rank value."""
    if k >= n:
        k = n - 1
    rng = np.random.default_rng(n + 7 * bits + k)
    for r in (rng.integers(0, 2**bits, n), rng.integers(0, min(4, 2**bits), n),
              np.full(n, 2**bits - 1)):
        rank = torch.from_numpy(r.astype(np.int32)).to(dev)
        got = bwt.bwt_sort_pairs(rank, k, bits)
        want = bwt.bwt_sort_pairs_plain(rank, k, bits)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (n, k, bits)


#: n at the rerank's edges: one key; the group count at its largest (1024
#: groups of one destination) and one past it (513 of two); a tile (4096
#: keys) one below, at and one above; 1024 groups of 1024 and one past
RERANK_N = [1, 2, 1023, 1024, 1025, 4095, 4096, 4097, 2**20 - 1, 2**20, 2**20 + 1]


def rerank_case(n, kind, rng):
    """Sorted int64 keys of one kind: all equal, all distinct, or with ties."""
    if kind == "equal":
        return np.full(n, 7, np.int64)
    if kind == "distinct":
        return np.arange(n, dtype=np.int64) * 3 + (1 << 40)
    return np.sort(rng.integers(0, max(n // 4, 1), n)).astype(np.int64)


def held_rerank(dev, keys, order):
    k, o = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (keys, order))
    got, want = bwt.bwt_rerank(k, o), bwt.bwt_rerank_plain(k, o)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["equal", "distinct", "ties"])
@pytest.mark.parametrize("n", RERANK_N)
def test_bwt_rerank_at_the_edges(dev, n, kind):
    """The two-launch rerank against its plain version at tile and group
    edges, on keys all equal, all distinct and with ties, through a random
    order, the identity (a tile's destinations in as few groups as can be)
    and its reverse."""
    rng = np.random.default_rng(n)
    keys = rerank_case(n, kind, rng)
    for order in (rng.permutation(n), np.arange(n), np.arange(n)[::-1]):
        held_rerank(dev, keys, order.astype(np.int32))


def test_bwt_rerank_every_tile_into_one_group(dev):
    """Groups of 8192 destinations: through the identity and through an
    order that shuffles each tile inside its span, every tile's 4096 pairs
    go to one group (one shared count and one cursor take them all)."""
    n = 5_000_011
    assert 1 << bwt.rerank_group_shift(n) >= 2 * bwt.TILE
    rng = np.random.default_rng(3)
    keys = rerank_case(n, "ties", rng)
    shuffled = np.arange(n)
    for a in range(0, n, bwt.TILE):
        shuffled[a:a + bwt.TILE] = rng.permutation(shuffled[a:a + bwt.TILE])
    for order in (np.arange(n), shuffled):
        held_rerank(dev, keys, order.astype(np.int32))


@pytest.mark.parametrize("n", [2**25, 2**25 + 1])
def test_bwt_rerank_past_the_shared_slices(dev, n):
    """The largest n whose groups' slices of rank fit in shared memory
    (2^15 destinations a group) and the first past it, where the second
    launch scatters through L2 instead."""
    assert (bwt.rerank_group_shift(n) > 15) == (n > 2**25)
    rng = np.random.default_rng(n)
    keys = rerank_case(n, "ties", rng)
    for order in (rng.permutation(n), np.arange(n)):
        held_rerank(dev, keys, order.astype(np.int32))


def test_bwt_rerank_bench_round(dev):
    """The rerank at the bench text's round k = 256 (20,000,008 keys)."""
    lines = synth_haplotypes(2_500_000, 8, 0.002, 3)
    keys, _, _, top = bwt.text_keys(lines)
    rank, k = torch.from_numpy(keys).to(dev), 0
    while k < 256:
        rank, top_t, _ = bwt.doubling_round(rank, k, max(1, top.bit_length()))
        top, k = int(top_t), (1 if k == 0 else 2 * k)
    srt = bwt.bwt_sort_pairs(rank, 256, max(1, top.bit_length()))
    got, want = bwt.bwt_rerank(*srt), bwt.bwt_rerank_plain(*srt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [4_000_037, 2**25 + 1])
def test_bwt_rerank_group_launch_under_cursor_contention(dev, n):
    """The rerank's first launch alone through a random order, so that every
    tile reserves a run at nearly every group's cursor while the other
    tiles do the same, with its state and pairs filled with garbage before:
    each cursor ends at its group's size (the launch zeroes them), each
    group's region of pairs holds its own destinations once each, and each
    pair carries its destination's rank."""
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rerank_case(n, "ties", rng)).to(dev)
    order = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    shift, groups = bwt.rerank_group_shift(n), bwt.rerank_groups(n)
    tiles = -(-n // bwt.TILE)
    # the wrapper's state: the look-back words, the ticket, a group's cursor
    # a 128-byte line (32 ints) apart
    state = torch.full((tiles + 1 + 16 * groups,), -1, dtype=torch.int64, device=dev)
    pairs = torch.full((n,), -1, dtype=torch.int64, device=dev)
    top = torch.full((1,), -1, dtype=torch.int32, device=dev)
    _build.launch("pgt_bwt_rerank_group", keys.data_ptr(), order.data_ptr(), n, shift,
                  pairs.data_ptr(), top.data_ptr(), state.data_ptr(), _build.stream(dev))
    want, want_top = bwt.bwt_rerank_plain(keys, order)
    at = torch.arange(n, device=dev)
    cursors = state[tiles + 1:].view(torch.int32)[::32].long()
    assert torch.equal(cursors, torch.bincount(at >> shift, minlength=groups))
    dest, val = pairs >> 32, pairs & 0xFFFFFFFF
    assert torch.equal(dest >> shift, at >> shift)
    assert torch.equal(torch.sort(dest).values, at)
    assert torch.equal(val, want.long()[dest]) and torch.equal(top, want_top)


def seed_inputs(dev, B, W, pd, case, rng, misaligned=False):
    """Random seed tiers of both kinds at [B, W] positions: m-mer rows of
    sizes 0..4 (0: none), dictionary rows of sizes 1..4 (under min_occ 3
    at times: the m-mer row after it); case "all-miss": no position has a
    dictionary entry; misaligned: the per-position arrays are views that
    start one element past their allocation."""
    def T(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        if not misaligned:
            return t
        flat = torch.empty(a.size + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    mer = torch.from_numpy(rng.integers(0, 5, (64, 3))).to(dev, pd)
    vals = torch.from_numpy(rng.integers(1, 5, (50, 3))).to(dev, pd)
    di = rng.integers(-1, 50, (B, W)).astype(np.int32)
    if case == "all-miss":
        di[:] = -1
    return dict(mer_table=mer, mer_keys=T(rng.integers(-3, 70, (B, W)).astype(np.int32)),
                mer_valid=T(rng.random((B, W)) < 0.8), mer_m=3, sdict_vals=vals,
                sdict_idx=T(di), sdict_m=19)


@pytest.mark.parametrize("pd", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("B,W", [(1, 1), (1, 3), (3, 5), (7, 151), (129, 33)])
def test_resolve_seeds_at_the_edges(dev, B, W, pd):
    """resolve_seeds against its plain version at position counts from one
    to past a block of 256 (1, 3, 15, 1057, 4257), every position missing
    the dictionary, each tier switched off, per-position arrays that are
    offset views, min_occ 1 and 3; int32 and int64 tables."""
    rng = np.random.default_rng(B * W)
    for case, misaligned in (("mixed", False), ("all-miss", False), ("mixed", True)):
        full = seed_inputs(dev, B, W, pd, case, rng, misaligned)
        mer = {k: v for k, v in full.items() if k.startswith("mer")}
        sdict = {k: v for k, v in full.items() if k.startswith("sdict")}
        for kw in (full, mer, sdict):
            for min_occ in (1, 3):
                got = mems.resolve_seeds(B, W, min_occ, **kw)
                want = mems.resolve_seeds_plain(B, W, min_occ, **kw)
                assert got.dtype == pd and torch.equal(got, want), (case, sorted(kw), min_occ)


# --- the int64 instantiations (n >= 2^31): two-level rows, int64 positions ---

#: superblocks of 2^11 positions: the small index spans 40 of them
WIDE_SHIFT = 11


@pytest.fixture(scope="module", params=["two-level", "single-level"])
def wide(request, dev, index):
    """int64 tables on the card: two-level rows (the n >= 2^31 form, many
    superblocks) or single-level rows read with one superblock of zeros."""
    idx, _ = index
    shift = WIDE_SHIFT if request.param == "two-level" else None
    t = rindex_to_device(idx, dev, checkpoint=True, super_shift=shift, dtype=torch.int64)
    assert t.pos_dtype == torch.int64 and t.super_S is not None
    assert t.super_S.shape[0] == (40 if shift else 1)
    return t


def T64(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(dev)


def test_int64_planes_and_extend(dev, index, wide):
    """K2's int64 instantiation against its plain version: intervals inside
    one row, across rows and across superblock boundaries, both directions;
    the bit planes with the superblock bases against ckpt_rank6."""
    idx, _ = index
    t = wide
    rng = np.random.default_rng(31)
    B = 6000
    k = rng.integers(0, idx.n, B)
    bounds = np.arange(1, 40, dtype=np.int64) << WIDE_SHIFT
    k[:2000] = bounds[rng.integers(0, len(bounds), 2000)] - rng.integers(1, 200, 2000)
    s = rng.integers(0, np.minimum(idx.n - k, 4096) + 1)
    s[:1000] = rng.integers(0, 64 - (k[:1000] & 63) + 1)
    args = [T64(a, dev) for a in (k, rng.integers(0, idx.n, B), s)]
    code = torch.from_numpy(rng.integers(-1, 8, B).astype(np.int32)).to(dev)
    fwd = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    for f in (None, fwd):
        got = fmd.extend(t, *args, code, forward=f)
        expect = fmd.extend_plain(t, *args, code, forward=f)
        for g, e in zip(got, expect):
            assert g.dtype == torch.int64 and torch.equal(g, e)
    pos = T64(np.concatenate((np.arange(idx.n + 1), [-1, idx.n + 70])), dev)
    assert torch.equal(rank.planes_rank6(t.ckpt_planes, pos, t.super_S, t.super_shift),
                       rank.ckpt_rank6(t, pos))


def int64_seed_tiers(idx, codes, lens, dev):
    mk, mv = read_mer_keys_fast(codes, lens, 6)
    keys, vals = build_sparse_dict(idx, 19)
    di = read_windows_fast(codes, lens, 19, keys)[2]

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return dict(mer_table=T64(build_mer_table(idx, 6), dev), mer_keys=T(mk),
                mer_valid=T(mv), mer_m=6, sdict_vals=T64(vals, dev), sdict_idx=T(di),
                sdict_m=19)


def test_int64_resolve_seeds_find_mems_and_tags(dev, index, wide):
    """resolve_seeds, K3 and K4 (over int64 tag run heads) at int64,
    against their plain versions."""
    idx, lines = index
    t = wide
    reads = synth_reads(lines, 300, 150, error_rate=0.02, seed=8)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                      for r in reads]).astype(np.int32)
    lens = np.full(len(reads), 150, np.int32)
    lens[::9] = np.random.default_rng(8).integers(0, 150, len(lens[::9]))
    for i, n in enumerate(lens):
        codes[i, n:] = 0
    codes[4, 33] = 4
    kw = int64_seed_tiers(idx, codes, lens, dev)
    for min_occ in (1, 3):
        expect = mems.resolve_seeds_plain(len(reads), 151, min_occ, **kw)
        got = mems.resolve_seeds(len(reads), 151, min_occ, **kw)
        assert got.dtype == torch.int64 and torch.equal(got, expect)
    c, n = (torch.from_numpy(a).to(dev) for a in (codes, lens))
    for min_occ, capacity in ((1, 8), (2, 3)):
        got, gs = mems.find_mems(t, c, n, 20, min_occ, capacity=capacity,
                                 with_stats=True, **kw)
        expect, es = mems.find_mems_plain(t, c, n, 20, min_occ, capacity=capacity,
                                          with_stats=True, **kw)
        for g, e in zip(got, expect):
            assert torch.equal(g, e)
        assert torch.equal(gs["steps"], es["steps"])
    assert got.bwt_start.dtype == torch.int64 and bool((got.count > 0).any())
    tags = synth_tag_array(idx)
    tt = tags_to_device(tags, dev, dtype=torch.int64)
    assert tt.search_tree.shape[1] == 8
    # int64 heads, and int32 heads beside the int64 buffers (an index whose
    # n_seq * max_len passes 2^31 while its n does not)
    for heads in (tt, tags_to_device(tags, dev)):
        for cap in (8, 9):
            for g, e in zip(tagquery.query_mem_tags(heads, got.bwt_start, got.size,
                                                    got.count, cap),
                            tagquery.query_mem_tags_plain(heads, got.bwt_start, got.size,
                                                          got.count, cap)):
                assert torch.equal(g, e)
        q = got.bwt_start[got.count > 0, 0]
        for name, g, e in zip(tagquery.TagQueryResult._fields,
                              tagquery.query_tags_batch(heads, q, q + 3, 64),
                              tagquery.query_tags_batch_plain(heads, q, q + 3, 64)):
            assert torch.equal(g, e), name


@pytest.mark.parametrize("width,n_reads", [(1, 70), (150, 1000), (700, 333)])
def test_int64_count(dev, index, wide, width, n_reads):
    idx, lines = index
    reads = synth_reads(lines, n_reads, width, error_rate=0.0, seed=width)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                      for r in reads]).astype(np.int32)
    rng = np.random.default_rng(width)
    lens = rng.integers(0, width + 1, n_reads).astype(np.int32)
    lens[::3] = width
    codes[4::5, 0] = 4
    c, n = (torch.from_numpy(a).to(dev) for a in (codes, lens))
    got = count.count(wide, c, n)
    expect = count.count_plain(wide, c, n)
    for g, e in zip(got, expect):
        assert g.dtype == torch.int64 and torch.equal(g, e)
    if width >= 150:
        assert bool((got[0] <= got[1]).any()) and bool((got[0] > got[1]).any())


@pytest.mark.parametrize("min_keep", [1, 2])
def test_int64_sdict_levels(dev, index, wide, min_keep):
    """sdict_level's int64 instantiation (32-byte entries) at every level of
    a build against its plain version, and the build against the host's."""
    idx, _ = index
    t = wide
    keys = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    vals = torch.tensor([[[0, 0, idx.n]]], dtype=torch.int64, device=dev)
    counts = [1]
    for level in range(19):
        got = sparsedict.sdict_level(t, keys, vals, counts, min_keep, level)
        expect = sparsedict.sdict_level_plain(t, keys, vals, counts, min_keep, level)
        counts = same_level(got, expect)
        keys, vals = got[:2]
    keys, vals = sparsedict.sdict_pack(keys, vals, counts)
    hk, hv = build_sparse_dict(idx, 19, min_keep)
    assert vals.dtype == torch.int64
    assert np.array_equal(keys.cpu().numpy(), hk) and np.array_equal(vals.cpu().numpy(), hv)


def test_int64_bucketed_chain_kernels(dev, index):
    """K2, resolve_seeds and K3, and the dictionary's level at every level
    of a build, through int64 bucketed tables (the --rank-mode dense and
    ultra tables past 2^31), against their plain versions."""
    idx, lines = index
    t = rindex_to_device(idx, dev, bucketed=True, dtype=torch.int64)
    rng = np.random.default_rng(33)
    B = 6000
    k = rng.integers(0, idx.n, B)
    s = rng.integers(0, np.minimum(idx.n - k, 4096) + 1)
    s[:1000] = rng.integers(0, 4, 1000)
    args = [T64(a, dev) for a in (k, rng.integers(0, idx.n, B), s)]
    code = torch.from_numpy(rng.integers(-1, 8, B).astype(np.int32)).to(dev)
    fwd = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    for f in (None, fwd):
        for g, e in zip(fmd.extend(t, *args, code, forward=f),
                        fmd.extend_plain(t, *args, code, forward=f)):
            assert g.dtype == torch.int64 and torch.equal(g, e)
    reads = synth_reads(lines, 300, 150, error_rate=0.02, seed=9)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                      for r in reads]).astype(np.int32)
    lens = np.full(len(reads), 150, np.int32)
    kw = int64_seed_tiers(idx, codes, lens, dev)
    c, n = (torch.from_numpy(a).to(dev) for a in (codes, lens))
    got, gs = mems.find_mems(t, c, n, 20, 1, capacity=8, with_stats=True, **kw)
    expect, es = mems.find_mems_plain(t, c, n, 20, 1, capacity=8, with_stats=True, **kw)
    for g, e in zip(got, expect):
        assert torch.equal(g, e)
    assert torch.equal(gs["steps"], es["steps"]) and bool((got.count > 0).any())
    keys = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    vals = torch.tensor([[[0, 0, idx.n]]], dtype=torch.int64, device=dev)
    counts = [1]
    for level in range(19):
        got = sparsedict.sdict_level(t, keys, vals, counts, 1, level)
        counts = same_level(got, sparsedict.sdict_level_plain(t, keys, vals, counts, 1,
                                                              level))
        keys, vals = got[:2]
    keys, vals = sparsedict.sdict_pack(keys, vals, counts)
    hk, hv = build_sparse_dict(idx, 19, 1)
    assert np.array_equal(keys.cpu().numpy(), hk) and np.array_equal(vals.cpu().numpy(), hv)


@pytest.mark.parametrize("m", [2, 7])
def test_int64_mer_table(dev, index, wide, m):
    """The level kernel over int64 checkpoint rows, two-level (many
    superblocks) and single-level."""
    held_mer_table(wide, index[0], m)


@pytest.mark.parametrize("m", [2, 7])
def test_int64_bucketed_mer_table(dev, index, m):
    idx, _ = index
    held_mer_table(rindex_to_device(idx, dev, bucketed=True, dtype=torch.int64), idx, m)


@pytest.mark.parametrize("capacity", [1, 64])
def test_int64_locate_batch(dev, index, wide, capacity):
    """K8's int64 instantiation (int64 search trees of 8 keys a line)
    against its plain version and the host SA, intervals outside the BWT
    included."""
    idx, _ = index
    t = wide
    assert t.run_tree.shape[1] == 8
    rng = np.random.default_rng(capacity)
    B = 3001
    j = rng.integers(0, idx.n_runs, B)
    start = idx.run_start[j] + np.where(rng.random(B) < 0.5, 0,
                                        rng.integers(0, idx.run_len[j]))
    start[::7] = rng.integers(0, idx.n, len(start[::7]))
    start[1::11] = -rng.integers(1, 1000, len(start[1::11]))
    start[:2] = (-2**40, idx.n + 2)
    size = np.minimum(rng.integers(-2, 201, B), idx.n - start)
    st, sz = T64(start, dev), T64(size, dev)
    got = locate.locate_batch(t, st, sz, capacity)
    expect = locate.locate_batch_plain(t, st, sz, capacity)
    for g, e in zip(got, expect):
        assert g.dtype == e.dtype and torch.equal(g, e)
    assert got.positions.dtype == torch.int64
    sa = idx.decompress_sa()
    pos, cnt = got.positions.cpu().numpy(), got.count.cpu().numpy()
    for i in range(2, B, 37):
        if start[i] >= 0:
            assert np.array_equal(pos[i, : cnt[i]], sa[start[i] : start[i] + cnt[i]])


@pytest.mark.parametrize("t", [1, 8, 9, 81, 4000, 70000])
def test_int64_tag_search_past_int32(dev, t):
    """The int64 tree descent (tag_upper_bound's int64 instantiation) over
    heads past 2^31 against torch.searchsorted, and K6 / K4 over them."""
    rng = np.random.default_rng(t)
    heads = np.unique(rng.integers(2**31 - 10 * t, 2**31 + 40 * t, t))
    heads = np.concatenate(([0], heads))
    tags = TagArray(pos_enc=rng.integers(0, 50, heads.size) * 3, bwt_start=heads,
                    total=int(heads[-1]) + 5)
    tt = tags_to_device(tags, dev)
    assert tt.bwt_start.dtype == torch.int64
    v = np.concatenate((heads, heads - 1, heads + 1, [-1, 2**31 - 1, 2**31, 2**62],
                        rng.integers(0, 2**31 + 50 * t, 5000)))
    vd = T64(v, dev)
    got = tagquery.tag_upper_bound(tt, vd)
    assert torch.equal(got.long(), torch.searchsorted(tt.bwt_start, vd, right=True))
    assert torch.equal(got, tagquery.tag_upper_bound_plain(tt, vd))
    s = T64(np.sort(rng.choice(heads, 3000)), dev)
    e = s + T64(rng.integers(0, 60 * 3, 3000), dev)
    for cap in (8, 256):
        for ex in (False, True):
            for name, g, x in zip(tagquery.TagQueryResult._fields,
                                  tagquery.query_tags_batch(tt, s, e, cap, ex),
                                  tagquery.query_tags_batch_plain(tt, s, e, cap, ex)):
                assert torch.equal(g, x), name
    B, M = 300, 10
    bwt, size = s[: B * M].view(B, M), (e - s + 1)[: B * M].view(B, M)
    cnt = torch.from_numpy(rng.integers(0, M + 2, B).astype(np.int32)).to(dev)
    for cap in (8, 32):
        for g, x in zip(tagquery.query_mem_tags(tt, bwt, size, cnt, cap),
                        tagquery.query_mem_tags_plain(tt, bwt, size, cnt, cap)):
            assert torch.equal(g, x)


def test_int64_refuses_more_superblocks_than_a_block_stages(dev, index):
    idx, _ = index
    t = rindex_to_device(idx, dev, checkpoint=True, super_shift=6, dtype=torch.int64)
    z = torch.zeros(8, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="superblocks"):
        fmd.extend(t, z, z, z, z.int())


# --- the one-card tag merge (csrc/merge.cu) ----------------------------------

def merge_inputs(comp, C, dev, seed=0):
    """comp -> (comp, stream, offsets) on dev, the streams exactly as long
    as their components' rows (the kernel's precondition)."""
    comp = np.asarray(comp, np.int32)
    counts = np.bincount(comp[(comp >= 0) & (comp < C)], minlength=C)
    offsets = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    stream = np.random.default_rng(seed).integers(0, 1 << 45, int(offsets[-1]))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (comp, stream.astype(np.int64), offsets))


def merge_launches(C):
    """merge_rows' launches a call: one up to C = 255; past it the
    histogram, the scan and one a pass of the sort."""
    from pangenome_index_tpu_torch.ops import merge

    passes = len(merge.merge_passes(C))
    return 1 if passes == 1 else passes + 2


def held_merge(dev, comp, C, passes=None):
    """merge_rows equals merge_rows_plain on the card (torch.equal), in
    merge_launches(C) launches (one where the sort takes one pass)."""
    from pangenome_index_tpu_torch.ops import merge

    args = merge_inputs(comp, C, dev)
    before = merge.merge_rows.launches
    got = merge.merge_rows(*args)
    torch.cuda.synchronize()
    made = merge.merge_rows.launches - before
    assert made == (merge_launches(C) if len(comp) else 0)
    if passes is not None:
        assert len(merge.merge_passes(C)) == passes
    want = merge.merge_rows_plain(*args)
    assert got.dtype == want.dtype == torch.int64 and torch.equal(got, want)
    return got


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 1])
def test_merge_rows_at_tile_edges(dev, n):
    rng = np.random.default_rng(n)
    held_merge(dev, rng.integers(-1, 3, n), 3, passes=1)


@pytest.mark.parametrize("C", [1, 3, 255, 256, 300, 70_000])
def test_merge_rows_any_component_count(dev, C):
    """One pass up to C = 255; two past the 256 digits a pass holds; three
    past 2^16."""
    rng = np.random.default_rng(C)
    n = 50_000
    comp = rng.integers(-1, C, n)
    comp[rng.random(n) < 0.3] = C - 1     # a large component beside many small ones
    held_merge(dev, comp, C)


def test_merge_rows_edges(dev):
    """Every row -1; no component at all; a component absent from most
    tiles; labels outside [0, C) get 0; no rows."""
    held_merge(dev, np.full(3 * 4096 + 7, -1), 3)
    held_merge(dev, np.full(100, -1), 0)
    comp = np.zeros(20 * 4096, np.int64)
    comp[[5, 40_000, 81_000]] = 2
    comp[::7] = 1
    held_merge(dev, comp, 3)
    got = held_merge(dev, np.array([0, 5, -3, 1, 7, 0]), 2)
    assert got[[1, 2, 4]].tolist() == [0, 0, 0]
    held_merge(dev, np.zeros(0, np.int64), 3)


def test_merge_rows_random_interleavings(dev):
    rng = np.random.default_rng(11)
    for C in (2, 3, 24):
        comp = np.repeat(rng.integers(-1, C, 3000), rng.integers(1, 60, 3000))
        held_merge(dev, comp, C)


def test_merge_rows_at_40m_rows(dev):
    """The whole genome's rows of chip_smoke.py's graph-build path: 48
    sequences, 3 components, 40,000,080 rows."""
    rng = np.random.default_rng(40)
    n = 40_000_080
    comp = rng.integers(0, 3, n).astype(np.int32)
    comp[:48] = -1
    held_merge(dev, comp, 3, passes=1)


def test_merge_tags_on_device_equals_the_cpu(dev):
    """merge_tags_on_device on the card equals it on the CPU (the plain
    version) and the host merge, on a genome of three synthetic
    chromosomes."""
    from pangenome_index_tpu_torch.core import merge, tagbuild
    from pangenome_index_tpu_torch.formats import rlbwt
    from pangenome_index_tpu_torch.models.rindex import build_rindex
    from pangenome_index_tpu_torch.utils.synth import synth_multi_component_gbz

    def index(g):
        visits, ptr = g.index.table().extract_all(np.arange(g.index.sequences))
        text = tagbuild.visits_to_text(g, visits).tobytes()
        _, _, lens, first = tagbuild.graph_arrays(g)
        cum = np.concatenate(([0], np.cumsum(lens[(visits >> 1) - first])))
        lines = [text[cum[ptr[s]]:cum[ptr[s + 1]]] for s in range(g.index.sequences)]
        return build_rindex(rlbwt.rlbwt_from_text(native.build_bwt_native(lines)[0].tobytes()),
                            keep_sa=True)

    whole, subs, _ = synth_multi_component_gbz(20_000, 4, n_comps=3, seed=5)
    comps = merge.node_components(whole)
    comp_tags = {}
    for sub in subs:
        t = tagbuild.build_tags(sub, index(sub))
        comp_tags[comps[int(t.pos_enc[0]) >> 11]] = t
    idx = index(whole)
    on_card = merge.merge_tags_on_device(whole, idx, comp_tags, dev)
    for want in (merge.merge_tags_on_device(whole, idx, comp_tags, "cpu"),
                 merge.merge_tags(whole, idx, comp_tags)):
        np.testing.assert_array_equal(on_card.pos_enc, want.pos_enc)
        np.testing.assert_array_equal(on_card.bwt_start, want.bwt_start)


# --- the multi-card path's kernels: a model shard's rank6 partials
# (csrc/shard.cu), the lockstep MEM step (csrc/memstep.cu), the data
# shard's merge (csrc/merge.cu) ------------------------------------------

from pangenome_index_tpu_torch.ops import merge as merge_ops  # noqa: E402
from pangenome_index_tpu_torch.ops import shard_rank  # noqa: E402
from pangenome_index_tpu_torch.parallel import merge as pmerge  # noqa: E402
from pangenome_index_tpu_torch.parallel import sharding  # noqa: E402

#: the sharded table forms: checkpoint rows, two-level rows (int64), runs
SHARD_FORMS = {"checkpoint": dict(checkpoint=True),
               "two-level": dict(checkpoint=True, super_shift=11, dtype=torch.int64),
               "runs": dict()}


def shard_positions(idx, t, S, dtype, dev):
    """Random positions, 0 and n, and each shard's first position and the
    one before it (rows, or run heads)."""
    rng = np.random.default_rng(9)
    edges = [0, idx.n, max(idx.n - 1, 0)]
    if t.ckpt is not None:
        rows = t.ckpt.shape[0] // S
        edges += [min(64 * rows * m + d, idx.n) for m in range(S) for d in (-1, 0)]
    else:
        runs = t.run_start.shape[0] // S
        edges += [min(int(t.run_start[runs * m]) + d, idx.n) for m in range(S) for d in (-1, 0)]
    pos = np.concatenate((rng.integers(0, idx.n + 1, 5000), np.maximum(edges, 0)))
    return torch.from_numpy(pos).to(dev, dtype)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("form", list(SHARD_FORMS))
def test_shard_rank6(dev, index, form, S):
    """Each shard's partials equal the plain version's, written and
    accumulated; summed over the shards they are the whole index's rank6."""
    idx, _ = index
    t = sharding.pad_rindex_tables(idx, S, device="cpu", **SHARD_FORMS[form])
    on_card = sharding.virtual_shards(t, S, dev)
    on_cpu = sharding.virtual_shards(t, S, "cpu")
    pos = shard_positions(idx, t, S, t.pos_dtype, dev)
    before = (shard_rank.shard_ckpt_rank6.launches, shard_rank.shard_run_rank6.launches)
    for a, b in zip(on_card.shards, on_cpu.shards):
        assert torch.equal(a.rank6(pos).cpu(), b.rank6(pos.cpu()))
    got = on_card(pos)
    assert torch.equal(got.cpu(), on_cpu(pos.cpu()))
    assert torch.equal(got.cpu().long(), rank.rank6(t, pos.cpu()).long())
    after = (shard_rank.shard_ckpt_rank6.launches, shard_rank.shard_run_rank6.launches)
    assert sum(after) - sum(before) == 2 * S


def lockstep_inputs(dev, idx, lines, pd, tiers):
    """300 reads of up to 80 codes on the card, with both seed tiers
    (tiers "both") or none, resolved: (codes, lengths, seed kwargs, padded,
    seeds)."""
    reads = synth_reads(lines, 300, 80, error_rate=0.02, seed=4)
    codes = np.zeros((len(reads), 80), np.int32)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    c, n = (torch.from_numpy(a).to(dev) for a in (codes, lens))
    kw = {}
    if tiers == "both":
        mk, mv = read_mer_keys_fast(codes, lens, 6)
        keys, vals = build_sparse_dict(idx, 15)
        _, _, di = read_windows_fast(codes, lens, 15, keys)
        kw = dict(mer_table=torch.from_numpy(build_mer_table(idx, 6)).to(dev, pd),
                  mer_keys=torch.from_numpy(np.ascontiguousarray(mk, np.int32)).to(dev),
                  mer_valid=torch.from_numpy(mv).to(dev), mer_m=6,
                  sdict_vals=torch.from_numpy(vals).to(dev, pd),
                  sdict_idx=torch.from_numpy(np.ascontiguousarray(di, np.int32)).to(dev),
                  sdict_m=15)
    padded, _ = mems._prepare(c, align=8)
    seeds = mems.resolve_seeds(c.shape[0], c.shape[1] + 1, 1, **kw)
    return c, n, kw, padded, seeds


def step_args(prov, padded, n, seeds, read_len, to=None):
    """The step's arguments after the shards (on `to` if given)."""
    def mv(a):
        return a if a is None or to is None else a.to(to)

    return (mv(prov.C), prov.n, mv(padded), mv(n), mv(seeds), read_len, 12, 1,
            mv(prov.super_base), prov.super_shift)


#: the fused step's forms: the sharded table forms at both position types
FUSED_FORMS = {"checkpoint": dict(checkpoint=True),
               "checkpoint-int64": dict(checkpoint=True, dtype=torch.int64),
               "two-level": dict(checkpoint=True, super_shift=11, dtype=torch.int64),
               "runs": dict(), "runs-int64": dict(dtype=torch.int64)}


@pytest.mark.parametrize("tiers", ["none", "both"])
@pytest.mark.parametrize("S", [1, 2, 4, 16])
@pytest.mark.parametrize("form", list(FUSED_FORMS))
def test_fused_step(dev, index, form, S, tiers):
    """The fused step (one launch: the step, then the partials of its new
    query positions over the shards' table) equals its plain version, state
    and ranks, from the first launch (the entry, seeded or not) through 60
    iterations, with every shard in the table and with one shard's alone
    (a mesh rank's); each call is one counted launch and no 3a or 3b
    launch."""
    idx, lines = index
    t = sharding.pad_rindex_tables(idx, S, **FUSED_FORMS[form])
    prov = sharding.virtual_shards(t, S, dev)
    cpu = sharding.virtual_shards(t, S, "cpu")
    c, n, _, padded, seeds = lockstep_inputs(dev, idx, lines, t.pos_dtype, tiers)
    assert (seeds is None) == (tiers == "none")
    B = c.shape[0]
    args = step_args(prov, padded, n, seeds, c.shape[1])
    cargs = step_args(prov, padded, n, seeds, c.shape[1], "cpu")
    # every shard in the table, and the last shard alone (a mesh rank's
    # partials) on the same state
    tables = [(prov.shards, cpu.shards)] + ([([prov.shards[-1]], [cpu.shards[-1]])]
                                            if S > 1 else [])
    st = mems.step_state(B, 8, t.pos_dtype, dev)
    ranks = torch.zeros((2 * B, 6), dtype=t.pos_dtype, device=dev)
    before = (mems.mem_step_fused.launches, shard_rank.shard_ckpt_rank6.launches,
              shard_rank.shard_run_rank6.launches)
    for it in range(61):
        for card_shards, cpu_shards in reversed(tables):  # the whole table's last
            ref, ref_ranks = mems.StepState(*(f.cpu() for f in st)), ranks.cpu()
            got = st if card_shards is prov.shards else mems.StepState(
                *(f.clone() for f in st))
            got_ranks = ranks if card_shards is prov.shards else ranks.clone()
            active = torch.zeros(1, dtype=torch.int32, device=dev)
            mems.mem_step_fused(got, got_ranks, card_shards, *args, active=active,
                                apply=it > 0)
            live = mems.mem_step_fused_plain(ref, ref_ranks, cpu_shards, *cargs,
                                              apply=it > 0)
            for f, a, b in zip(got._fields, got, ref):
                assert torch.equal(a.cpu(), b), (it, len(card_shards), f)
            assert torch.equal(got_ranks.cpu(), ref_ranks), (it, len(card_shards))
            assert int(active) == live
    after = (mems.mem_step_fused.launches, shard_rank.shard_ckpt_rank6.launches,
             shard_rank.shard_run_rank6.launches)
    assert (after[0] - before[0], after[1:]) == (61 * len(tables), before[1:])


@pytest.mark.parametrize("tiers", ["none", "both"])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("form", list(SHARD_FORMS))
def test_lockstep_engine(dev, index, form, S, tiers):
    """The lockstep engine over S shards on the card, its iterations
    replayed as a CUDA graph: every MemResult field equal to K3's on the
    same reads; iters the first multiple of ACTIVE_CHECK_EVERY at or past
    the iteration after which no read is active (found by eager launches of
    the fused step); launches counted replays x ACTIVE_CHECK_EVERY, and no
    launch of 3a or 3b."""
    idx, lines = index
    t = sharding.pad_rindex_tables(idx, S, **SHARD_FORMS[form])
    prov = sharding.virtual_shards(t, S, dev)
    c, n, kw, padded, seeds = lockstep_inputs(dev, idx, lines, t.pos_dtype, tiers)
    B = c.shape[0]
    args = step_args(prov, padded, n, seeds, c.shape[1])
    st = mems.step_state(B, 8, t.pos_dtype, dev)
    ranks = torch.zeros((2 * B, 6), dtype=t.pos_dtype, device=dev)
    mems.mem_step_fused(st, ranks, prov.shards, *args, apply=False)
    done, active = 0, torch.zeros(1, dtype=torch.int32, device=dev)
    while True:
        done += 1
        active.zero_()
        mems.mem_step_fused(st, ranks, prov.shards, *args, active=active)
        if int(active) == 0:
            break
    t_k3 = rindex_to_device(idx, dev, **({"checkpoint": True, "super_shift": 11,
                                          "dtype": torch.int64} if form == "two-level"
                                         else {"checkpoint": True}))
    want = mems.find_mems(t_k3, c, n, 12, 1, capacity=8, **kw)
    counts = (mems.mem_step_fused.launches, shard_rank.shard_ckpt_rank6.launches,
              shard_rank.shard_run_rank6.launches)
    got, stats = mems.find_mems_lockstep(prov.shards, prov.C, prov.n, c, n, 12, 1, capacity=8,
                                         with_stats=True, super_base=prov.super_base,
                                         super_shift=prov.super_shift, **kw)
    after = (mems.mem_step_fused.launches, shard_rank.shard_ckpt_rank6.launches,
             shard_rank.shard_run_rank6.launches)
    for g, w in zip(got, want):
        assert torch.equal(g.long(), w.long())
    every = mems.ACTIVE_CHECK_EVERY
    assert stats["iters"] == -(-done // every) * every
    # the first launch, then ACTIVE_CHECK_EVERY a replay
    assert after[0] - counts[0] == 1 + stats["iters"]
    assert after[1:] == counts[1:]
    assert torch.equal(stats["steps"].cpu(), st.steps.cpu())


@pytest.mark.parametrize("n", [0, 1, merge_ops.TILE - 1, merge_ops.TILE + 1, 3 * merge_ops.TILE])
@pytest.mark.parametrize("C", [1, 3, 255, 256, 300])
def test_merge_rows_shard_with_a_base(dev, n, C):
    """merge_rows_shard with a nonzero base (rows of each component on
    earlier shards) and merge_rows equal their plain versions, -1 rows and
    labels past C among them; a shard's call is two launches up to C = 255
    (the counts, then the placement) and none for no rows, with base_of
    called once either way."""
    rng = np.random.default_rng(7 * n + C)
    comp = rng.integers(-1, C + 2, n).astype(np.int32)
    inside = comp[(comp >= 0) & (comp < C)]
    counts = np.bincount(inside, minlength=C)
    base = rng.integers(0, 40, C)
    offsets = np.zeros(C + 1, np.int64)
    np.cumsum(counts + base + rng.integers(0, 3, C), out=offsets[1:])
    stream = rng.integers(0, 1 << 40, int(offsets[-1])).astype(np.int64)
    on = [torch.from_numpy(a).to(dev) for a in (comp, stream, offsets)]
    seen = []

    def base_of(c):
        seen.append(c.clone())
        return torch.from_numpy(base).to(dev)

    before = merge_ops.merge_rows_shard.launches
    got = merge_ops.merge_rows_shard(*on, base_of)
    torch.cuda.synchronize()
    made = merge_ops.merge_rows_shard.launches - before
    passes = len(merge_ops.merge_passes(C))
    assert made == (0 if n == 0 else 2 if passes == 1 else passes + 2)
    assert len(seen) == 1 and torch.equal(seen[0].cpu(), torch.from_numpy(counts))
    want = merge_ops.merge_rows_shard_plain(*on, lambda c: torch.from_numpy(base).to(dev))
    assert got.dtype == want.dtype == torch.int64 and torch.equal(got, want)
    zero = [on[0], on[1][: int(counts.sum())].contiguous(),
            torch.from_numpy(np.concatenate(([0], np.cumsum(counts)))).to(dev)]
    assert torch.equal(merge_ops.merge_rows(*zero), merge_ops.merge_rows_plain(*zero))


@pytest.mark.parametrize("n,C", [(1, 1), (4096, 3), (4097, 3), (100_000, 300),
                                 (200_003, 70_000)])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_merge_rows_shard(dev, n, C, S):
    """The data shards' merge on the card equals its plain version shard by
    shard and merge_rows on all the rows."""
    rng = np.random.default_rng(n + C)
    comp = rng.integers(-1, C, n).astype(np.int32)
    counts = np.bincount(comp[comp >= 0], minlength=C)
    stream = rng.integers(0, 1 << 40, int(counts.sum())).astype(np.int64)
    offsets = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    on = [torch.from_numpy(a).to(dev) for a in (comp, stream, offsets)]
    want = merge_ops.merge_rows(*on)
    before = merge_ops.merge_rows_shard.launches
    got = pmerge.merge_virtual_shards(*on, S)
    assert merge_ops.merge_rows_shard.launches > before
    assert torch.equal(got, want)
    assert torch.equal(pmerge.merge_virtual_shards(*(a.cpu() for a in on), S), want.cpu())


@pytest.mark.parametrize("dense", [True, False, "int64", "ckpt128", "mem-only"])
def test_public_api_on_the_card(dev, index, dense):
    """The public route to_device -> find_mems on the card (K3 through
    DenseRank, and through BucketRank with dense=False; dense records at
    int64 positions, DenseRank<int64_t>; checkpoint rows of 128 positions
    and mem_only stubs, CkptRank over their 64-position planes; one launch
    a call, no seed tier) equals the same route on the CPU; to_device
    places on the card by default."""
    import pangenome_index_tpu_torch as px

    idx, lines = index
    reads = synth_reads(lines, 300, 100, error_rate=0.02, seed=5)
    kw = {True: {}, False: dict(dense=False), "int64": dict(dtype=torch.int64),
          "ckpt128": dict(checkpoint=True, ckpt_block=128),
          "mem-only": dict(checkpoint=True, mem_only=True)}[dense]
    t = px.to_device(idx, **kw)
    assert t.run_start.device.type == "cuda"
    assert (t.rec is not None) == (dense is not False)
    assert (t.bucket_lo is not None) == (dense is False)
    before, seeds = mems.find_mems.launches, mems.resolve_seeds.launches
    got = px.find_mems(t, reads, 20, 1, capacity=8)
    assert mems.find_mems.launches == before + 1
    assert mems.resolve_seeds.launches == seeds
    assert got == px.find_mems(px.to_device(idx, "cpu", **kw), reads, 20, 1, capacity=8)


def test_end_to_end_on_the_card(dev):
    """The demo's lines with K3 and K6 on the card equal its lines on the
    CPU."""
    from pangenome_index_tpu_torch import end_to_end

    before = (mems.find_mems.launches, tagquery.query_tags_batch.launches)
    assert end_to_end.main(device=dev) == end_to_end.main(device="cpu")
    assert mems.find_mems.launches == before[0] + 1
    assert tagquery.query_tags_batch.launches > before[1]


#: run index shifts the BucketRank and 3b tests read through: the tables'
#: own, 7 (8-bit offsets, most entries full) and 12 (16-bit offsets, every
#: entry of the small index full: the lookups read run_start past them)
RUN_SHIFTS = [None, 7, 12]


def at_run_shift(t, shift):
    """t with its run index derived anew at `shift` (None: as it is)."""
    from pangenome_index_tpu_torch.ops.tables import derive_run_index

    if shift is not None:
        t.run_shift = shift
        t.run_index = derive_run_index(t.run_start, shift, 0, ((t.n + 1) >> shift) + 1)
    return t


@pytest.mark.parametrize("shift", RUN_SHIFTS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
def test_bucket_rank_through_the_run_index(dev, index, dtype, shift):
    """Every kernel that takes BucketRank - rank6_bucketed, K2, K3, the seed
    table's level (one and two deep) and the dictionary's level - equals its
    plain version through the run index at the tables' shift and at shifts
    whose entries are full."""
    idx, lines = index
    t = at_run_shift(rindex_to_device(idx, dev, bucketed=True, dtype=dtype), shift)
    rng = np.random.default_rng(41)
    heads = idx.run_start.astype(np.int64)
    pos = np.concatenate((np.arange(idx.n + 2), heads - 1, heads + 1,
                          [-1, idx.n + 70, 1 << 20]))
    pos = torch.from_numpy(pos).to(dev, dtype)
    assert torch.equal(rank.rank6_bucketed(t, pos), rank.rank6_bucketed_plain(t, pos))
    B = 5000
    k = rng.integers(0, idx.n, B)
    s = rng.integers(0, np.minimum(idx.n - k, 4096) + 1)
    args = [torch.from_numpy(a).to(dev, dtype) for a in (k, rng.integers(0, idx.n, B), s)]
    code = torch.from_numpy(rng.integers(-1, 8, B).astype(np.int32)).to(dev)
    fwd = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    for f in (None, fwd):
        for g, e in zip(fmd.extend(t, *args, code, forward=f),
                        fmd.extend_plain(t, *args, code, forward=f)):
            assert torch.equal(g, e)
    reads = synth_reads(lines, 120, 150, error_rate=0.02, seed=12)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                      for r in reads]).astype(np.int32)
    c = torch.from_numpy(codes).to(dev)
    n = torch.full((len(reads),), 150, dtype=torch.int32, device=dev)
    got, gs = mems.find_mems(t, c, n, 20, 1, capacity=8, with_stats=True)
    want, ws = mems.find_mems_plain(t, c, n, 20, 1, capacity=8, with_stats=True)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    assert torch.equal(gs["steps"], ws["steps"]) and bool((got.count > 0).any())
    level = mertable.mer_root(t)
    for _ in range(7):
        for depth in (1, 2):
            assert torch.equal(mertable.mer_level(t, level, depth),
                               mertable.mer_level_plain(t, level, depth))
        level = mertable.mer_level(t, level)
    keys = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    vals = torch.tensor([[[0, 0, idx.n]]], dtype=dtype, device=dev)
    counts = [1]
    for lv in range(14):
        got = sparsedict.sdict_level(t, keys, vals, counts, 1, lv)
        counts = same_level(got, sparsedict.sdict_level_plain(t, keys, vals, counts, 1, lv))
        keys, vals = got[:2]


@pytest.mark.parametrize("shift", RUN_SHIFTS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
def test_run_shards_through_their_slices(dev, index, dtype, shift):
    """3b over each of 4 shards' slices of the run index, and the fused
    step through runs (both positions' lookups together) for 40
    iterations, equal their plain versions, full entries included; 3b
    gives zeros for the positions another shard owns."""
    idx, lines = index
    S = 4
    t = at_run_shift(sharding.pad_rindex_tables(idx, S, device="cpu", dtype=dtype), shift)
    on_card = sharding.virtual_shards(t, S, dev)
    on_cpu = sharding.virtual_shards(t, S, "cpu")
    pos = shard_positions(idx, t, S, dtype, dev)
    for a, b in zip(on_card.shards, on_cpu.shards):
        assert a.shift == t.run_shift
        got = a.rank6(pos)
        assert torch.equal(got.cpu(), b.rank6(pos.cpu()))
        mine = (pos >= a.lo) & (pos < a.upper)
        assert not bool(got[~mine].any())
    assert torch.equal(on_card(pos).cpu().long(), rank.rank6(t, pos.cpu()).long())
    c, n, _, padded, seeds = lockstep_inputs(dev, idx, lines, dtype, "both")
    args = step_args(on_card, padded, n, seeds, c.shape[1])
    cargs = step_args(on_card, padded, n, seeds, c.shape[1], "cpu")
    B = c.shape[0]
    st = mems.step_state(B, 8, dtype, dev)
    ranks = torch.zeros((2 * B, 6), dtype=dtype, device=dev)
    for it in range(40):
        ref, ref_ranks = mems.StepState(*(f.cpu() for f in st)), ranks.cpu()
        mems.mem_step_fused(st, ranks, on_card.shards, *args, apply=it > 0)
        mems.mem_step_fused_plain(ref, ref_ranks, on_cpu.shards, *cargs, apply=it > 0)
        for f, a, b in zip(st._fields, st, ref):
            assert torch.equal(a.cpu(), b), (it, f)
        assert torch.equal(ranks.cpu(), ref_ranks), it


@pytest.fixture(scope="module")
def served(dev):
    """A small batch of reads prepared for serve.run on the card."""
    idx, lines = build_synth_index(6000, 3, seed=5)
    reads = synth_reads(lines, 16, 60, error_rate=0.01, seed=3)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)] for r in reads]).astype(np.int32)
    lens = np.full(len(reads), 60, np.int32)
    return serve.prepare(idx, synth_tag_array(idx), codes, lens, dev, mer_m=5, sdict_s=11)


def test_run_copies_back_into_page_locked_arrays(dev, served, monkeypatch):
    """serve.run on a card: every array it returns is page-locked and equals
    a.cpu().numpy() of its result tensor bit for bit (dtype, shape, bytes);
    after a warm call a recorded call allocates no page-locked block and
    counts every byte copied back as page-locked; the first call's arrays
    share no memory with two later calls' and hold what they held."""
    kw = dict(min_len=20, min_occ=1, capacity=8, tag_capacity=8)
    seen = []
    with monkeypatch.context() as m:
        to_host = serve._to_host
        m.setattr(serve, "_to_host", lambda a: seen.append((a, to_host(a))) or seen[-1][1])
        first = serve.run(served, **kw)
    assert len(seen) == len(serve.FETCHED)
    for name, (a, arr) in zip(serve.FETCHED, seen):
        want = a.cpu().numpy()
        assert arr is getattr(first, name)
        assert (arr.dtype, arr.shape) == (want.dtype, want.shape), name
        assert arr.tobytes() == want.tobytes(), name
        assert torch.from_numpy(arr).is_pinned(), name
    seen.clear()
    kept = [getattr(first, f).copy() for f in serve.FETCHED]
    second = serve.run(served, **kw)
    for name in serve.FETCHED:
        assert not np.shares_memory(getattr(first, name), getattr(second, name)), name
    del second  # its blocks back to the cache, for the recorded call to draw
    with spans.recording(dev) as rec:
        third = serve.run(served, **kw)
    nbytes = sum(getattr(third, f).nbytes for f in serve.FETCHED)
    assert rec.counters["serve.copy.host_allocs"] == 0
    assert rec.counters["serve.copy_back_pinned_bytes"] == nbytes
    assert rec.counters["serve.copy_back_bytes"] == nbytes
    for name, want in zip(serve.FETCHED, kept):
        a = getattr(first, name)
        assert a.tobytes() == want.tobytes(), name
        assert not np.shares_memory(a, getattr(third, name)), name


@pytest.fixture(scope="module")
def long_index(dev):
    """Both strands of 2 haplotypes of 70,000 bases (the benchmark's
    generator, so that the plain reference's FMD extension is exact), its
    index and tag array built on the card as the benchmark builds them."""
    from benchmark import data

    cfg = {"base_len": 70_000, "haplotypes": 2, "snp_rate": 0.002, "strands": 2,
           "copies": 1, "node_len": 512,
           "repeats": {"share": 0.1, "length": 300, "families": 4, "divergence": 0.03}}
    lines = data.sequences(cfg, 2**35 + 11)
    idx, tags = data.index(cfg, lines, dev)
    return cfg, lines, idx, tags


@pytest.mark.parametrize("n_reads, read_len", [(256, 15_000), (1, 65_534)])
def test_k3_on_long_reads(dev, long_index, n_reads, read_len):
    """K3 over HiFi-like reads (0.1% substitutions, every MEM kept at
    capacity 64) equals its plain version, steps included, and the
    benchmark's plain reference, counts, MEMs and tag counts: 256 reads of
    15,000 bases, and one read at the engine's 65,534-base limit; a read a
    base longer is refused by _prepare."""
    from benchmark import data, reference

    cfg, lines, idx, tags = long_index
    codes, lens = data.reads(lines, n_reads, read_len, 0.001, data.rng(7, read_len))
    kw = dict(mer_m=10, sdict_s=15)
    got_b = serve.prepare(idx, tags, codes, lens, dev, **kw)
    cpu_b = serve.prepare(idx, tags, codes, lens, "cpu", **kw)
    res, stats = mems.find_mems(got_b.tables, got_b.codes, got_b.lengths, 20, 1, capacity=64,
                                with_stats=True, **got_b.seed_kw)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        want, want_stats = mems.find_mems_plain(cpu_b.tables, cpu_b.codes, cpu_b.lengths, 20,
                                                1, 64, True, **cpu_b.seed_kw)
        fmd = reference.fmd_index(lines, "cpu")
        ref = reference.answers(fmd, torch.from_numpy(codes), torch.from_numpy(lens),
                                min_len=20, min_occ=1, capacity=64, tag_capacity=8,
                                tags=reference.tag_runs(fmd, cfg["node_len"], 1), copies=1)
    finally:
        torch.set_num_threads(n)
    for f in mems.MemResult._fields:
        assert torch.equal(getattr(res, f).cpu(), getattr(want, f).to(getattr(res, f).dtype)), f
    assert torch.equal(stats["steps"].cpu(), want_stats["steps"])
    assert int(stats["steps"].max()) >= 0.9 * read_len
    count, slots, nu, ov = (a.numpy() for a in ref)
    np.testing.assert_array_equal(res.count.cpu().numpy(), count)
    kept = np.minimum(count, 64)
    got = np.stack([res.start.cpu(), res.end.cpu(), res.bwt_start.cpu(), res.size.cpu()], axis=2)
    for r in range(n_reads):
        np.testing.assert_array_equal(got[r, :kept[r]], slots[r, :kept[r]])
    tnu, tov = tagquery.query_mem_tags(got_b.tag_tables, res.bwt_start, res.size, res.count,
                                       capacity=8)
    np.testing.assert_array_equal(tnu.cpu().numpy(), nu)
    np.testing.assert_array_equal(tov.cpu().numpy(), ov.astype(tov.cpu().numpy().dtype))
    if read_len == 65_534:
        over = torch.zeros((1, 65_535), dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="65534 engine limit"):
            mems.find_mems(got_b.tables, over, torch.full((1,), 65_535, dtype=torch.int32,
                                                          device=dev), 20, 1, capacity=64)


def test_k3_resident_lanes(dev):
    """Every K3 instantiation (each rank provider's pgt_find_mems_resident_*
    entry) keeps a whole number of blocks resident on each multiprocessor,
    at least one, counted over the whole card; the count is asked once and
    kept."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind in ("ckpt", "ckpt64", "dense", "dense64", "ultra", "bucketed", "bucketed64"):
        lanes = mems.resident_lanes(kind, dev)
        assert lanes >= 64 * sms and lanes % (64 * sms) == 0, kind
        assert mems.resident_lanes(kind, dev) == lanes
