"""The PyTorch port's tables, rank providers, extension and tag counts against
the JAX package, exactly, on a small synthetic index (CPU: the port runs each
kernel's plain version; the JAX Pallas kernels run in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenome_index_tpu.ops import fmd as jfmd
from pangenome_index_tpu.ops import rank as jrank
from pangenome_index_tpu.ops.pallas_rank import gather_rows_pallas, rank6_pallas
from pangenome_index_tpu.ops.tables import rindex_to_device as jax_rindex_to_device
from pangenome_index_tpu.ops.tables import tags_to_device as jax_tags_to_device
from pangenome_index_tpu.ops.tagquery import query_mem_tags as jax_query_mem_tags
from pangenome_index_tpu.utils.synth import build_synth_index, synth_tag_array
from pangenome_index_tpu_torch.ops import dense_rank, fmd, rank, tagquery
from pangenome_index_tpu_torch.ops.tables import (TagTables, derive_rank_planes,
                                                  derive_search_tree,
                                                  rindex_to_device,
                                                  tables_from_numpy,
                                                  tags_to_device)

JAX_FIELDS = ("run_sym", "run_start", "cum", "C", "samples", "last_sorted",
              "last_to_run", "n", "n_seq", "max_len", "bucket_lo",
              "pos_to_run", "rec", "rank_table", "ckpt", "ckpt_super")
MODES = {"checkpoint": dict(checkpoint=True), "dense": dict(dense=True),
         "two_level": dict(checkpoint=True, super_shift=9),
         "ultra": dict(ultra=True), "bucketed": dict(bucketed=True)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def index():
    return build_synth_index(20_000, 4, seed=2)


def as_numpy(tables):
    return {f: None if getattr(tables, f) is None else np.asarray(getattr(tables, f))
            for f in JAX_FIELDS}


def positions(idx, n=512, seed=0):
    pos = np.random.default_rng(seed).integers(0, idx.n + 1, n)
    pos[:4] = (0, 1, idx.n - 1, idx.n)
    return pos.astype(np.int32)


def random_intervals(idx, B=256, seed=3):
    """(k, kp, s, code, forward) lanes from short random FMD walks."""
    rng = np.random.default_rng(seed)
    k = np.zeros(B, np.int64)
    kp = np.zeros(B, np.int64)
    s = np.full(B, idx.n, np.int64)
    for _ in range(int(rng.integers(2, 7))):
        c = rng.integers(1, 6, B)
        for i in range(B):
            k[i], kp[i], s[i] = idx.backward_extend((k[i], kp[i], s[i]), int(c[i]))
            if s[i] == 0:
                k[i], kp[i], s[i] = 0, 0, idx.n
    code = rng.integers(0, 6, B)
    fwd = rng.integers(0, 2, B).astype(bool)
    return k, kp, s, code, fwd


@pytest.mark.parametrize("mode", list(MODES))
def test_tables_match_jax_field_for_field(index, mode):
    idx, _ = index
    jt = as_numpy(jax_rindex_to_device(idx, **MODES[mode]))
    pt = rindex_to_device(idx, "cpu", **MODES[mode])
    for f in JAX_FIELDS:
        got = getattr(pt, f)
        if jt[f] is None:
            assert got is None, f
        else:
            got = got if isinstance(got, int) else got.numpy()
            np.testing.assert_array_equal(got, jt[f], err_msg=f)


@pytest.mark.parametrize("mode", list(MODES))
def test_rank6_matches_jax(index, mode):
    idx, _ = index
    jt = jax_rindex_to_device(idx, **MODES[mode])
    pt = rindex_to_device(idx, "cpu", **MODES[mode])
    pos = positions(idx)
    expect = np.asarray(jrank.rank6(jt, jnp.asarray(pos)))
    got = fmd.rank6_plain(pt, torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), expect)
    if pt.ckpt is not None:
        np.testing.assert_array_equal(rank.ckpt_rank6(pt, torch.from_numpy(pos)).numpy(),
                                      expect)


@pytest.mark.parametrize("seed", [2, 4])
def test_rank_planes_match_ckpt(seed):
    """The kernels' bit-plane form of the checkpoint rows against `ckpt`:
    rank6 read from either is the same at every position of the index, at
    the row and table edges and past them, and equals the JAX package's
    _ckpt_rank6; tables carried across from JAX get the same planes."""
    idx, _ = build_synth_index(20_000 if seed == 2 else 6_011, 4, seed=seed)
    jt = jax_rindex_to_device(idx, checkpoint=True)
    pt = rindex_to_device(idx, "cpu", checkpoint=True)
    planes = pt.ckpt_planes
    assert planes.shape == pt.ckpt.shape and planes.dtype == torch.int32
    assert torch.equal(planes, derive_rank_planes(pt.ckpt, chunk_rows=7))
    n = idx.n
    edges = [0, 1, 63, 64, 65, n - 1, n, n + 1, n + 63, 64 * (pt.ckpt.shape[0] - 1),
             64 * pt.ckpt.shape[0] - 1]
    pos = torch.from_numpy(np.concatenate((np.arange(n + 1), edges)).astype(np.int32))
    via_ckpt = rank.ckpt_rank6(pt, pos)
    via_planes = rank.planes_rank6(planes, pos)
    assert via_planes.dtype == torch.int32
    np.testing.assert_array_equal(via_planes.numpy(), via_ckpt.numpy())
    np.testing.assert_array_equal(
        via_planes.numpy(), np.asarray(jrank._ckpt_rank6(jt, jnp.asarray(pos.numpy()))))
    np.testing.assert_array_equal(via_planes[: n + 1].numpy(),
                                  idx.rank6(np.arange(n + 1)))
    # positions outside the table clamp to its end rows, as in ckpt_rank6
    out = torch.tensor([-1, -64, 64 * pt.ckpt.shape[0] + 5], dtype=torch.int32)
    np.testing.assert_array_equal(rank.planes_rank6(planes, out).numpy(),
                                  rank.ckpt_rank6(pt, out).numpy())
    # fillers past n are q = 7 in all three planes; the prefix counts are
    # stored as overlapping pairs, the last of them the positions before the row
    last = planes[-1, :6].contiguous().view(torch.int64)
    assert bool((last == -1).all())
    assert torch.equal(planes[:, 7:14:2], planes[:, 8:15:2])
    before = torch.arange(planes.shape[0]) * 64
    assert torch.equal(planes[:, 15].long(), before.clamp(max=n))
    carried, _ = tables_from_numpy(as_numpy(jt), None, "cpu")
    assert torch.equal(carried.ckpt_planes, planes)
    # two-level rows (int64 positions) have a kernel form too: the planes of
    # the superblock-relative rows and the superblock bases beside them
    t2 = rindex_to_device(idx, "cpu", checkpoint=True, super_shift=9, dtype=torch.int64)
    assert t2.super_S.shape == (t2.ckpt_super.shape[0], 8)
    np.testing.assert_array_equal(
        rank.planes_rank6(t2.ckpt_planes, pos.long(), t2.super_S, t2.super_shift).numpy(),
        via_ckpt.numpy())


def test_dense_rank6_matches_pallas(index):
    idx, _ = index
    jt = jax_rindex_to_device(idx, dense=True)
    pt = rindex_to_device(idx, "cpu", dense=True)
    pos = positions(idx, 256, seed=1)
    expect = np.asarray(rank6_pallas(jt.rec, jt.pos_to_run, jnp.asarray(pos),
                                     interpret=True))
    got = dense_rank.rank6_dense(pt, torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), expect)


def test_gather_rows_matches_pallas(index):
    idx, _ = index
    jt = jax_rindex_to_device(idx, dense=True)
    pt = rindex_to_device(idx, "cpu", dense=True)
    # the Pallas kernel fetches aligned 8-row windows; the port takes any rows
    rng = np.random.default_rng(2)
    aligned = rng.integers(0, idx.n_runs // 8, 64) * 8
    win = (aligned[:, None] + np.arange(8)[None, :]).reshape(-1).astype(np.int32)
    expect = np.asarray(gather_rows_pallas(jt.rec, jnp.asarray(win), interpret=True))
    got = dense_rank.gather_rows(pt.rec, torch.from_numpy(win))
    np.testing.assert_array_equal(got.numpy(), expect)
    # any batch size; indices clamp into the table (as mems.py clips them)
    odd = np.array([-3, 0, 5, idx.n_runs - 1, idx.n_runs + 7], np.int32)
    got = dense_rank.gather_rows(pt.rec, torch.from_numpy(odd))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jt.rec)[np.clip(odd, 0, idx.n_runs - 1)])


@pytest.mark.parametrize("mode", list(MODES))
def test_extend_matches_jax(index, mode):
    idx, _ = index
    jt = jax_rindex_to_device(idx, **MODES[mode])
    pt = rindex_to_device(idx, "cpu", **MODES[mode])
    k, kp, s, code, fwd = random_intervals(idx)
    for forward in (None, fwd, np.ones_like(fwd)):
        jf = None if forward is None else jnp.asarray(forward)
        expect = jfmd.extend(jt, *(jnp.asarray(a, jnp.int32) for a in (k, kp, s, code)),
                             forward=jf)
        pf = None if forward is None else torch.from_numpy(forward)
        got = fmd.extend(pt, *(torch.from_numpy(a.astype(np.int32))
                               for a in (k, kp, s, code)), forward=pf)
        for g, e in zip(got, expect):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("capacity", [8, 32])
def test_query_mem_tags_matches_jax(index, capacity):
    idx, lines = index
    tags = synth_tag_array(idx, lines=lines)
    rng = np.random.default_rng(capacity)
    B, M = 96, 8
    bwt = rng.integers(0, idx.n - 1, (B, M))
    # spans from one position to thousands of rows: window overflow included
    size = np.where(rng.random((B, M)) < 0.5, rng.integers(1, 5, (B, M)),
                    rng.integers(1, 4000, (B, M)))
    size = np.minimum(size, idx.n - bwt)
    count = rng.integers(0, M + 3, B)
    expect = jax_query_mem_tags(jax_tags_to_device(tags), *(jnp.asarray(a, jnp.int32)
                                                           for a in (bwt, size, count)),
                                capacity=capacity)
    got = tagquery.query_mem_tags(tags_to_device(tags, "cpu"),
                                  *(torch.from_numpy(a.astype(np.int32))
                                    for a in (bwt, size, count)), capacity=capacity)
    for g, e in zip(got, expect):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    assert got[1].any() and not got[1].all()


#: hand-made head arrays: t heads, by the tree's shape at that size (a line
#: holds 16 heads, a node has 17 children)
TREE_SIZES = {"one head": 1, "one full line": 16, "two lines": 17,
              "17 lines: one full node": 272, "18 lines: a second level": 273,
              "289 heads": 289, "290 heads": 290,
              "289 lines: two full levels": 4624, "290 lines: a third level": 4625}


def check_tree_search(heads: np.ndarray, extra: np.ndarray):
    """The plain walk of the derived tree against torch.searchsorted and the
    JAX package's jnp.searchsorted, at every head, its neighbours, the ends
    of the int32 range and `extra`."""
    h = torch.from_numpy(heads)
    tree, levels = derive_search_tree(h)
    assert tree.dtype == h.dtype and tree.shape[1] == 16
    assert len(levels) >= 1 and levels[-1] == tree.shape[0] - 1
    # the structure costs about t / 16 keys beside the heads
    assert tree.numel() <= len(heads) / 16 * 1.07 + 16 * (len(levels) + 1)
    tt = TagTables(pos_enc=torch.zeros(len(heads), dtype=torch.int64), bwt_start=h,
                   total=0, search_tree=tree, tree_levels=levels)
    wide = heads.astype(np.int64)
    v = np.concatenate((wide, wide - 1, wide + 1, extra,
                        [0, -1, -2**31, 2**31 - 2, 2**31 - 1])).astype(np.int32)
    got = tagquery.tag_upper_bound(tt, torch.from_numpy(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), torch.searchsorted(h, torch.from_numpy(v), right=True).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.searchsorted(jnp.asarray(heads), jnp.asarray(v),
                                                 side="right")))


def test_tag_search_tree_on_the_synthetic_index(index):
    idx, lines = index
    tags = synth_tag_array(idx, lines=lines)
    rng = np.random.default_rng(5)
    check_tree_search(tags.bwt_start.astype(np.int32),
                      rng.integers(-100, idx.n + 100, 4096))


@pytest.mark.parametrize("size", list(TREE_SIZES))
@pytest.mark.parametrize("heads", ["distinct", "equal runs"])
def test_tag_search_tree_on_hand_made_heads(size, heads):
    t = TREE_SIZES[size]
    rng = np.random.default_rng(t)
    a = np.sort(rng.choice(np.arange(5, 5 + 8 * t), t, replace=False))
    if heads == "equal runs":      # equal heads across line and node borders
        a = np.sort(rng.integers(5, 5 + max(t // 9, 1), t))
    check_tree_search(a.astype(np.int32), rng.integers(0, 8 * t + 10, 512))


def test_tag_search_tree_refuses_a_head_at_the_padding_value():
    with pytest.raises(ValueError, match="maximum"):
        derive_search_tree(torch.tensor([3, 2**31 - 1], dtype=torch.int32))


def test_tag_tables_carry_the_search_tree(index):
    """tags_to_device and tables_from_numpy both derive the tree from the
    run heads they place; an empty tag array gets its one padded line."""
    idx, lines = index
    tags = synth_tag_array(idx, lines=lines)
    own = tags_to_device(tags, "cpu")
    tree, levels = derive_search_tree(own.bwt_start)
    assert torch.equal(own.search_tree, tree) and own.tree_levels == levels
    assert len(levels) == 4 and tree.shape[0] > tags.n_runs // (16 * 17)
    jtt = jax_tags_to_device(tags)
    jt = as_numpy(jax_rindex_to_device(idx, checkpoint=True))
    _, carried = tables_from_numpy(jt, {f: np.asarray(getattr(jtt, f))
                                        for f in ("pos_enc", "bwt_start", "total")},
                                   "cpu")
    assert torch.equal(carried.search_tree, tree) and carried.tree_levels == levels
    empty = derive_search_tree(torch.zeros(0, dtype=torch.int32))
    assert empty[1] == (0,) and bool((empty[0] == 2**31 - 1).all())


@pytest.mark.parametrize("mode", list(MODES))
def test_tables_carried_from_jax(index, mode):
    idx, lines = index
    tags = synth_tag_array(idx, lines=lines)
    jt = jax_rindex_to_device(idx, **MODES[mode])
    jtt = jax_tags_to_device(tags)
    pt, ptt = tables_from_numpy(as_numpy(jt), {f: np.asarray(getattr(jtt, f))
                                               for f in ("pos_enc", "bwt_start",
                                                         "total")}, "cpu")
    own = rindex_to_device(idx, "cpu", **MODES[mode])
    for f in JAX_FIELDS:
        a, b = getattr(pt, f), getattr(own, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a == b if isinstance(a, int) else torch.equal(a, b), f
    np.testing.assert_array_equal(ptt.pos_enc.numpy(), tags.pos_enc)
    np.testing.assert_array_equal(ptt.bwt_start.numpy(), tags.bwt_start)
    # both packages give the same answers on the carried tables
    pos = positions(idx, seed=4)
    np.testing.assert_array_equal(fmd.rank6_plain(pt, torch.from_numpy(pos)).numpy(),
                                  np.asarray(jrank.rank6(jt, jnp.asarray(pos))))


def test_tables_from_numpy_carries_the_jax_default_tables(index):
    """The JAX package's default tables (bucketed: bucket_lo beside the full
    cum table) carried across: the same bucket_lo, and both packages find
    the same runs and give the same rank6 on them."""
    idx, _ = index
    jt = jax_rindex_to_device(idx)
    assert jt.bucket_lo is not None and jt.rank_table is None
    pt, _ = tables_from_numpy(as_numpy(jt), None, "cpu")
    np.testing.assert_array_equal(pt.bucket_lo.numpy(), np.asarray(jt.bucket_lo))
    assert pt.cum.shape == (idx.n_runs, 6) and pt.rank_table is None
    pos = np.concatenate((positions(idx, seed=6), idx.run_start, [idx.n + 1])).astype(np.int32)
    np.testing.assert_array_equal(rank.run_of(pt, torch.from_numpy(pos)).numpy(),
                                  np.asarray(jrank.run_of(jt, jnp.asarray(pos))))
    np.testing.assert_array_equal(rank.rank6(pt, torch.from_numpy(pos)).numpy(),
                                  np.asarray(jrank.rank6(jt, jnp.asarray(pos))))


def test_failed_build_is_not_retried(monkeypatch):
    """After a failed kernel build, every later call raises the same error
    without running nvcc again (each retry took seconds)."""
    from pangenome_index_tpu_torch import _build

    calls = []

    def failing():
        calls.append(1)
        raise RuntimeError("nvcc failed on mems.cu: the message")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_build_error", None)
    monkeypatch.setattr(_build, "build", failing)
    for _ in range(3):
        with pytest.raises(RuntimeError, match="nvcc failed on mems.cu"):
            _build.lib()
    assert len(calls) == 1
