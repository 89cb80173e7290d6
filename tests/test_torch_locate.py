"""The port's locate (ops/locate.py, K8) against the JAX package's
locate_batch and the host SA, on the CPU (a small synthetic index; every
value is an integer, tolerance 0).

On CPU tensors locate_batch runs its plain version; the kernel of
csrc/locate.cu is held against that on the card (tests/test_torch_cuda.py).
What the kernel reads is held here: the search tree over the run heads
against torch.searchsorted through its plain walk, and the tail pairs and
their bucket index against their definition and, through the plain walk of
the kernel's step (tables.tail_next_plain), against the JAX locate_next."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenome_index_tpu.ops.locate import locate_batch as jax_locate_batch
from pangenome_index_tpu.ops.rank import locate_next as jax_locate_next
from pangenome_index_tpu.ops.tables import rindex_to_device as jax_tables
from pangenome_index_tpu.parallel import sharding as jax_sharding
from pangenome_index_tpu.utils.synth import build_synth_index
from pangenome_index_tpu_torch import KERNELS
from pangenome_index_tpu_torch.ops import locate
from pangenome_index_tpu_torch.ops.rank import locate_next, run_of
from pangenome_index_tpu_torch.ops.tables import (derive_search_tree,
                                                  rindex_to_device,
                                                  tables_from_numpy,
                                                  tail_bucket, tail_next_plain,
                                                  tree_upper_bound_plain)
from pangenome_index_tpu_torch.parallel import sharding
from pangenome_index_tpu_torch.utils.synth import build_synth_index as port_synth


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def idx():
    return build_synth_index(20_000, 4, seed=2)[0]


@pytest.fixture(scope="module")
def jt(idx):
    """The JAX package's tables with every locate table (not mem_only)."""
    return jax_tables(idx, checkpoint=True)


@pytest.fixture(scope="module")
def tables(idx, jt):
    """The port's tables, made from the index and carried across from the
    JAX package's."""
    fields = {f: (None if getattr(jt, f) is None else np.asarray(getattr(jt, f)))
              for f in ("run_sym", "run_start", "cum", "C", "samples", "last_sorted",
                        "last_to_run", "pos_to_run", "rec", "ckpt", "ckpt_super",
                        "bucket_lo", "rank_table")}
    fields.update(n=jt.n, n_seq=jt.n_seq, max_len=jt.max_len)
    return {"own": rindex_to_device(idx, "cpu", checkpoint=True),
            "carried": tables_from_numpy(fields, None, "cpu")[0]}


@pytest.fixture(scope="module")
def sa(idx):
    """The SA in packed coordinates by the port's host model."""
    return port_synth(20_000, 4, seed=2)[0].decompress_sa()


def intervals(idx, kind: str, B: int, seed: int):
    """(start, size) [B] int64 of one kind: starts at run heads, mid-run
    (and at run ends), or anywhere, with sizes 1 to 200 inside the BWT, a
    few of 0 and of exactly the room left; or outside the BWT: starts
    before it (down to the least int32) and at or just past its end, sizes
    -2 to 200."""
    rng = np.random.default_rng(seed)
    heads = idx.run_start
    if kind == "outside":
        start = np.concatenate((-rng.integers(1, 1000, B - B // 4),
                                idx.n + rng.integers(0, 4, B // 4)))
        start[:2] = (-2**31, -1)
        size = rng.integers(-2, 201, B)
        size[2] = 0
        return start.astype(np.int64), size.astype(np.int64)
    if kind == "heads":
        start = heads[rng.integers(0, idx.n_runs, B)]
    elif kind == "mid-run":
        long_runs = np.flatnonzero(idx.run_len > 1)
        j = long_runs[rng.integers(0, len(long_runs), B)]
        start = heads[j] + rng.integers(1, idx.run_len[j])
        start[:4] = heads[j[:4]] + idx.run_len[j[:4]] - 1   # a run's last row
    else:
        start = rng.integers(0, idx.n, B)
    size = np.minimum(rng.integers(1, 201, B), idx.n - start)
    size[:3] = 0
    size[3:6] = idx.n - start[3:6]
    return start.astype(np.int64), size.astype(np.int64)


def port_locate(t, start, size, capacity):
    return locate.locate_batch(t, torch.from_numpy(start.astype(np.int32)),
                               torch.from_numpy(size.astype(np.int32)), capacity)


def same_as_jax(got, expect):
    for name in ("positions", "count", "overflow"):
        g, e = getattr(got, name).numpy(), np.asarray(getattr(expect, name))
        assert g.dtype == e.dtype and g.shape == e.shape, name
        np.testing.assert_array_equal(g, e, err_msg=name)


@pytest.mark.parametrize("which", ["own", "carried"])
@pytest.mark.parametrize("capacity", [1, 48, 64])
@pytest.mark.parametrize("kind", ["heads", "mid-run", "anywhere", "outside"])
def test_locate_batch_matches_jax(idx, jt, tables, kind, capacity, which):
    """Every lane as the JAX function answers it, intervals outside the BWT
    too (a start before it reads the last sample and chases nothing)."""
    start, size = intervals(idx, kind, 96, seed=capacity)
    assert (size > capacity).any() and (size == 0).any()
    expect = jax_locate_batch(jt, jnp.asarray(start, jt.pos_dtype),
                              jnp.asarray(size, jt.pos_dtype), capacity=capacity)
    same_as_jax(port_locate(tables[which], start, size, capacity), expect)


@pytest.mark.parametrize("capacity", [1, 48, 64])
@pytest.mark.parametrize("kind", ["heads", "mid-run", "anywhere"])
def test_locate_batch_matches_the_host_sa(idx, tables, sa, kind, capacity):
    start, size = intervals(idx, kind, 160, seed=100 + capacity)
    res = port_locate(tables["own"], start, size, capacity)
    count = res.count.numpy()
    np.testing.assert_array_equal(count, np.minimum(size, capacity))
    np.testing.assert_array_equal(res.overflow.numpy(), size > capacity)
    pos = res.positions.numpy()
    for i in range(len(start)):
        np.testing.assert_array_equal(pos[i, : count[i]], sa[start[i] : start[i] + count[i]])
        assert not pos[i, count[i]:].any()


@pytest.mark.parametrize("which", ["run_start"])
def test_locate_search_trees_match_searchsorted(idx, tables, which):
    """The plain walk of the tree the kernel descends for run_of (over
    run_start) against torch.searchsorted, at every head, its neighbours,
    the ends of the int32 range and random values; the tables made here and
    carried from JAX hold the same tree."""
    t = tables["own"]
    heads = getattr(t, which)
    tree, levels = t.run_tree, t.run_tree_levels
    assert torch.equal(tree, derive_search_tree(heads)[0])
    assert levels == derive_search_tree(heads)[1] and len(levels) >= 3
    assert torch.equal(tree, tables["carried"].run_tree)
    rng = np.random.default_rng(4)
    h = heads.long()
    v = torch.cat((h, h - 1, h + 1, torch.tensor([0, 2**31 - 1]),
                   torch.from_numpy(rng.integers(0, int(h[-1]) + 10, 5000)))).to(heads.dtype)
    np.testing.assert_array_equal(tree_upper_bound_plain(tree, levels, heads, v).numpy(),
                                  torch.searchsorted(heads, v, right=True).numpy())


def tail_index_by_definition(t):
    """(tail_pairs, tail_lo, tail_shift) of t from their definition:
    (last_sorted[i], samples[last_to_run[i] + 1] - last_sorted[i]); the
    first tail >= b << shift of each bucket b (torch.searchsorted), r after
    the last; shift = floor(log2(n_seq * max_len / r))."""
    r = t.last_sorted.shape[0]
    V = t.n_seq * t.max_len
    shift = int(np.floor(np.log2(V / r))) if V >= r else 0
    nb = -(-V >> shift)
    run = (t.last_to_run.long() + 1).clamp(max=t.samples.shape[0] - 1)
    pairs = torch.stack((t.last_sorted, t.samples[run] - t.last_sorted), dim=1)
    lo = torch.searchsorted(t.last_sorted.long(), torch.arange(nb) << shift)
    return pairs, torch.cat((lo, torch.tensor([r]))).int(), shift


def walk_values(t, seed):
    """Where the step is held: every tail, its neighbours, values below the
    first tail (the wrap), the end of the packed range, the ends of the
    dtype's range below its wrap and random values."""
    rng = np.random.default_rng(seed)
    ls = t.last_sorted.long()
    V = t.n_seq * t.max_len
    return torch.cat((ls, ls - 1, ls + 1, torch.tensor([0, -1, -7, int(ls[0]) - 1, V - 1, V,
                                                        V + 1, 2**31 - 1, -2**31]),
                      torch.from_numpy(rng.integers(0, V + 10, 5000)))).to(t.pos_dtype)


def held_tail_walk(t, jt, seed=0):
    """tail_next_plain on t equals the JAX locate_next on jt (the same
    tables) exactly, and the port's own locate_next where its gathers are
    in range (not on the stubs, whose sample index only JAX clamps)."""
    v = walk_values(t, seed)
    got = tail_next_plain(t, v)
    assert got.dtype == t.pos_dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_locate_next(jt, jnp.asarray(v.numpy()))))
    if t.samples.shape[0] == t.last_sorted.shape[0] + 1:
        np.testing.assert_array_equal(got.numpy(), locate_next(t, v).numpy())


@pytest.mark.parametrize("which", ["own", "carried", "own-int64"])
def test_tail_index_matches_its_definition(idx, tables, which):
    """The tail pairs and their bucket index, derived with the tables made
    here (int32 and int64) and with the JAX tables carried across, equal
    their definition; buckets cover the packed range, about one tail
    each."""
    t = rindex_to_device(idx, "cpu", dtype=torch.int64) if which == "own-int64" \
        else tables[which]
    pairs, lo, shift = tail_index_by_definition(t)
    assert t.tail_pairs.dtype == t.pos_dtype and t.tail_pairs.is_contiguous()
    assert torch.equal(t.tail_pairs, pairs) and t.tail_shift == shift
    assert t.tail_lo.dtype == torch.int32 and torch.equal(t.tail_lo, lo)
    nb = lo.shape[0] - 1
    assert nb << shift >= t.n_seq * t.max_len and idx.n_runs <= nb < 2 * idx.n_runs
    _, m = tail_bucket(t, t.last_sorted)
    assert 0.5 < idx.n_runs / nb <= 1 and int(m.max()) < 16


@pytest.mark.parametrize("which", ["own", "carried"])
def test_tail_walk_matches_jax_locate_next(jt, tables, which):
    """The kernel's step (bucket, in-bucket count, prev + delta[i]) equals
    the JAX locate_next at every tail, its neighbours, below the first tail
    and past the packed range, including sums that wrap at int32."""
    held_tail_walk(tables[which], jt, seed=1)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_tail_walk_on_padded_tables(idx, S):
    """The walk over pad_rindex_tables' tables at int32 equals the JAX
    locate_next over the JAX function's padded tables (this index's runs
    divide among 8 shards: no sentinel run; those, whose int64 sentinel
    wraps at int32 and leaves the tails unsorted, are held at int64 in
    tests/test_torch_int64.py)."""
    assert idx.n_runs % 8 == 0
    with jax.enable_x64(False):
        jt = jax_sharding.pad_rindex_tables(idx, S, checkpoint=True)
        t = sharding.pad_rindex_tables(idx, S, checkpoint=True, device="cpu")
        held_tail_walk(t, jt, seed=S)


def test_tail_walk_on_mem_only_stubs(idx):
    """The one-row stubs of mem_only tables take the derivation (one tail,
    one bucket's worth of the range), and the walk over them equals the JAX
    locate_next over the JAX function's stubs (whose sample index clamps)."""
    with jax.enable_x64(False):
        jt = jax_sharding.pad_rindex_tables(idx, 4, checkpoint=True, mem_only=True)
        t = sharding.pad_rindex_tables(idx, 4, checkpoint=True, mem_only=True, device="cpu")
        assert t.tail_pairs.shape == (1, 2) and t.tail_lo.shape[0] <= 3
        held_tail_walk(t, jt, seed=9)


def test_plain_steps_match_the_host_model(idx, tables):
    """run_of and locate_next of ops/rank.py against the port's host model."""
    model = port_synth(20_000, 4, seed=2)[0]
    t = tables["own"]
    rng = np.random.default_rng(8)
    pos = rng.integers(0, idx.n, 3000)
    np.testing.assert_array_equal(run_of(t, torch.from_numpy(pos)).numpy(),
                                  model.run_of(pos))
    prev = np.concatenate((model.samples, rng.integers(0, idx.n_seq * idx.max_len, 3000)))
    # the model keeps no pad after the last sample, the tables do
    tail = np.searchsorted(model.last_sorted, prev, side="right") - 1
    prev = prev[model.last_to_run[tail] + 1 < model.n_runs]
    np.testing.assert_array_equal(
        locate_next(t, torch.from_numpy(prev)).numpy(), model.locate_next(prev))


def test_locate_batch_is_a_kernel_with_a_count(tables):
    """locate_batch is listed among the kernel wrappers; CPU tensors run the
    plain version and count no launch."""
    assert KERNELS["locate_batch"] is locate.locate_batch
    before = locate.locate_batch.launches
    port_locate(tables["own"], np.array([0, 5]), np.array([3, 1]), 4)
    assert locate.locate_batch.launches == before


def test_locate_refuses_bad_arguments_and_tables(tables):
    """Shapes and capacity are checked on every device; the kernel's view of
    the tables refuses tables without the run tree or the tail index,
    stubbed locate tables and tables whose positions are not of one dtype,
    and takes int32 or int64 positions (an instantiation of the kernel for
    each)."""
    t = tables["own"]
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="capacity"):
        locate.locate_batch(t, z, z, 0)
    with pytest.raises(ValueError, match="must be"):
        locate.locate_batch(t, z, z[:3])
    from dataclasses import replace

    cpu = torch.device("cpu")
    for missing in ("run_tree", "tail_pairs", "tail_lo"):
        with pytest.raises(ValueError, match="search tree and tail index"):
            locate._locate_args(replace(t, **{missing: None}), cpu)
    with pytest.raises(ValueError, match="locate tables"):
        locate._locate_args(replace(t, tail_pairs=t.tail_pairs[:1]), cpu)
    with pytest.raises(ValueError, match="expected torch.int64"):
        locate._locate_args(replace(t, run_start=t.run_start.long()), cpu)
    with pytest.raises(ValueError, match="expected torch.int32"):
        locate._locate_args(replace(t, tail_lo=t.tail_lo.long()), cpu)
    assert len(locate._locate_args(t, cpu)) == 9
    wide = {f: getattr(t, f).long() for f in ("run_start", "samples", "tail_pairs")}
    wide["run_tree"], _ = derive_search_tree(wide["run_start"])
    assert len(locate._locate_args(replace(t, **wide), cpu)) == 9
