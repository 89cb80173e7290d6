"""The run index that the port's bucketed kernels rank through
(ops/tables.py:derive_run_index: a 16-byte entry for each bucket of
2^shift positions, then the run's record), read by its plain versions
(ops/rank.py:run_of_index, records_rank6; ops/shard_rank.py:
shard_run_rank6_plain), against the JAX package exactly (every value is an
integer: tolerance 0): the run of a position against JAX's run_of and
jnp.searchsorted over the heads, rank6 against JAX's rank6 on bucketed
tables (base tables past 2^31, where bucket_lo would take 2^25 entries),
and the model shards' slices against JAX's distributed_rank6 under
shard_map on int64 padded tables. The indexes: the synthetic bench-like
one, long runs (buckets without a head), clusters of one-position runs
(buckets fuller than their entry, read past it), a single run, and runs
past 2^31. The card's kernels are held against these plain versions in
tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pangenome_index_tpu.models.rindex import RIndex as JaxRIndex
from pangenome_index_tpu.ops import rank as jrank
from pangenome_index_tpu.ops.tables import rindex_to_device as jax_rindex_to_device
from pangenome_index_tpu.parallel import sharding as jax_sharding
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu.utils.synth import build_synth_index, synth_reads
from pangenome_index_tpu_torch.models.rindex import RIndex
from pangenome_index_tpu_torch.ops import mems, rank
from pangenome_index_tpu_torch.ops.shard_rank import run_shard
from pangenome_index_tpu_torch.ops.tables import (derive_run_index, derive_run_records,
                                                  rindex_to_device, run_index_shift,
                                                  run_index_slots, tables_from_numpy)
from pangenome_index_tpu_torch.parallel import sharding
from pangenome_index_tpu_torch.serve import check_rank_tables

DTYPES = {"int32": (torch.int32, jnp.int32), "int64": (torch.int64, jnp.int64)}
FIELDS = ("run_sym", "run_start", "cum", "C", "samples", "last_sorted", "last_to_run",
          "bucket_lo", "pos_to_run", "rec", "rank_table", "ckpt", "ckpt_super")
#: run-length layouts of the made-up indexes (run_lengths)
CASES = ("long-runs", "clustered", "single-run", "past-2^31")


@pytest.fixture(autouse=True, scope="module")
def restored():
    """One intra-op thread (tiny tensors), and JAX's type width restored
    after the module."""
    n, prev = torch.get_num_threads(), jax.config.jax_enable_x64
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def index():
    return build_synth_index(20_000, 4, seed=2)


def run_lengths(case):
    rng = np.random.default_rng(CASES.index(case))
    if case == "long-runs":    # 3000-9000 positions a run: buckets without a head
        return rng.integers(3000, 9000, 200)
    if case == "clustered":    # 300 one-position runs, then a run of 20,000
        return np.tile(np.concatenate((np.ones(300, np.int64), [20_000])), 20)
    if case == "single-run":
        return np.array([1000])
    # a first run past 2^31, then short runs: every bucket of the index
    # there holds far more heads than its entry
    return np.concatenate(([2**31 + 5], rng.integers(1, 40, 3000)))


def made_index(lengths, cls, seed=0):
    """An r-index of these run lengths (random symbols 1..5, run 0 the
    endmarker's code 0; no locate data: one sample a run)."""
    rng = np.random.default_rng(seed)
    r = len(lengths)
    sym = rng.integers(1, 6, r).astype(np.int8)
    sym[0] = 0
    lengths = np.asarray(lengths, np.int64)
    start = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    contrib = np.zeros((r, 6), np.int64)
    contrib[np.arange(r), sym] = lengths
    cum = np.zeros((r, 6), np.int64)
    np.cumsum(contrib[:-1], axis=0, out=cum[1:])
    counts = contrib.sum(axis=0)
    C = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    n = int(lengths.sum())
    return cls(run_sym=sym, run_start=start, run_len=lengths, cum=cum, C=C, n=n, n_seq=1,
               max_len=n, samples=np.zeros(r, np.int64), last_sorted=np.arange(r),
               last_to_run=np.arange(r))


def positions(n, heads, rng, k=3000):
    """Random positions (half of them among the last 10^5), 0, 1, n - 1, n,
    n + 1, the heads and the positions beside them."""
    heads = np.asarray(heads, np.int64)
    return np.concatenate((rng.integers(0, n + 2, k // 2),
                           rng.integers(max(n - 100_000, 0), n + 2, k // 2),
                           [0, 1, n - 1, n, n + 1], heads, np.maximum(heads - 1, 0),
                           heads + 1))


def same(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64), err_msg=what)


@pytest.mark.parametrize("width", list(DTYPES))
def test_run_of_every_position_matches_jax(index, width):
    """On the bench-like index: the run of every position 0..n + 1 and of
    random positions through the run index equals JAX's run_of (bucket_lo)
    and jnp.searchsorted over the heads; rank6 through the index and the
    records equals JAX's rank6 on the bucketed tables."""
    idx, _ = index
    pd, jd = DTYPES[width]
    t = rindex_to_device(idx, "cpu", bucketed=True, dtype=pd)
    assert t.run_index.dtype == torch.int32 and t.run_index.shape[1] == 4
    assert tuple(t.run_rec.shape) == (idx.n_runs, 8) and t.run_rec.dtype == pd
    assert t.run_shift == run_index_shift(idx.n, idx.n_runs)
    rng = np.random.default_rng(1)
    pos = np.concatenate((np.arange(idx.n + 2), rng.integers(0, idx.n + 2, 5000)))
    with jax.enable_x64(width == "int64"):
        jt = jax_rindex_to_device(idx, dtype=jd)
        jp = jnp.asarray(pos, jd)
        want_run = np.asarray(jrank.run_of(jt, jp))
        want_ss = np.asarray(jnp.searchsorted(jt.run_start, jp, side="right")) - 1
        want_r6 = np.asarray(jrank.rank6(jt, jp))
    tp = torch.from_numpy(pos).to(pd)
    got = rank.run_of_index(t.run_index, 0, t.run_shift, t.run_start, tp)
    same(got, want_run, "run_of")
    same(got, want_ss, "searchsorted")
    same(rank.rank6_bucketed_plain(t, tp), want_r6, "rank6")


@pytest.mark.parametrize("width", list(DTYPES))
def test_tables_from_numpy_derive_the_same_index(index, width):
    """The JAX package's bucketed arrays carried across derive the run
    index and records the port's own build derives."""
    idx, _ = index
    pd, jd = DTYPES[width]
    with jax.enable_x64(width == "int64"):
        jt = jax_rindex_to_device(idx, dtype=jd)
        fields = {f: None if getattr(jt, f) is None else np.asarray(getattr(jt, f))
                  for f in FIELDS}
    fields.update(n=idx.n, n_seq=idx.n_seq, max_len=idx.max_len)
    pt, _ = tables_from_numpy(fields, None, "cpu")
    own = rindex_to_device(idx, "cpu", bucketed=True, dtype=pd)
    assert pt.run_shift == own.run_shift
    assert torch.equal(pt.run_index, own.run_index) and torch.equal(pt.run_rec, own.run_rec)


@pytest.mark.parametrize("case,width", [(c, w) for c in CASES for w in DTYPES
                                        if c != "past-2^31" or w == "int64"])
def test_run_index_cases_match_jax(case, width):
    """Long runs, buckets fuller than their entry, a single run and runs
    past 2^31 (int64 only): the run and rank6 of every kind of position
    through the run index equal jnp.searchsorted, JAX's run_of and JAX's
    rank6 (on bucketed tables; past 2^31 on base tables, whose rank6 is
    searchsorted's)."""
    pd, jd = DTYPES[width]
    lengths = run_lengths(case)
    idx = made_index(lengths, RIndex)
    big = idx.n >= 2**31
    t = rindex_to_device(idx, "cpu", bucketed=not big, dtype=pd)
    if big:  # bucket_lo would take 2^25 entries: the index alone
        t.run_shift = run_index_shift(idx.n, idx.n_runs)
        t.run_index = derive_run_index(t.run_start, t.run_shift, 0,
                                       ((idx.n + 1) >> t.run_shift) + 1)
        t.run_rec = derive_run_records(t.run_start, t.run_sym, t.cum)
    full = ((t.run_index[:, 1] >> 8) & 0xFF) > run_index_slots(t.run_shift)
    empty = ((t.run_index[:, 1] >> 8) & 0xFF) == 0
    if case in ("clustered", "past-2^31"):
        assert int(full.sum()) > 0  # the lookups read past the entry
    if case == "long-runs":
        assert int(empty.sum()) > 0
    pos = positions(idx.n, idx.run_start, np.random.default_rng(2))
    pos = pos[pos <= idx.n + 1]
    with jax.enable_x64(width == "int64"):
        jt = jax_rindex_to_device(made_index(lengths, JaxRIndex), dtype=jd, bucketed=not big)
        jp = jnp.asarray(pos, jd)
        want_run = np.asarray(jrank.run_of(jt, jp))
        want_ss = np.asarray(jnp.searchsorted(jt.run_start, jp, side="right")) - 1
        want_r6 = np.asarray(jrank.rank6(jt, jp))
    tp = torch.from_numpy(pos).to(pd)
    got = rank.run_of_index(t.run_index, 0, t.run_shift, t.run_start, tp)
    same(got, want_run, "run_of")
    same(got, want_ss, "searchsorted")
    same(rank.rank6_bucketed_plain(t, tp), want_r6, "rank6")


@pytest.mark.parametrize("shift", range(0, 16))
def test_every_shift_and_offset_width(index, shift):
    """The index at every bucket shift (8-bit offsets below 8, 16-bit from
    8; from no full entry to every entry full) finds the run searchsorted
    finds, for positions before 0 and past n + 1 too."""
    idx, _ = index
    t = rindex_to_device(idx, "cpu", bucketed=True, dtype=torch.int64)
    ix = derive_run_index(t.run_start, shift, 0, ((idx.n + 1) >> shift) + 1)
    rng = np.random.default_rng(shift)
    pos = torch.from_numpy(np.concatenate((rng.integers(-5, idx.n + 300, 4000),
                                           idx.run_start[::7])))
    want = (torch.searchsorted(t.run_start, pos, right=True) - 1).clamp(min=0)
    assert torch.equal(rank.run_of_index(ix, 0, shift, t.run_start, pos), want)


def at_shift(t, shift):
    """t with its run index derived anew at `shift` (None: as it is)."""
    if shift is not None:
        t.run_shift = shift
        t.run_index = derive_run_index(t.run_start, shift, 0, ((t.n + 1) >> shift) + 1)
    return t


def jax_distributed_rank6(t_jax, pos, S):
    mesh = jax_sharding.make_mesh(1, S)
    fn = jax.jit(jax.shard_map(jax_sharding.distributed_rank6, mesh=mesh,
                               in_specs=(P("model"), P("model"), P("model", None), P()),
                               out_specs=P(), check_vma=False))
    return np.asarray(fn(jnp.asarray(t_jax.run_start, jnp.int64), t_jax.run_sym,
                         jnp.asarray(t_jax.cum, jnp.int64), pos))


@pytest.mark.parametrize("shift", [None, 9])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_shard_slices_match_jax_distributed_rank6(index, S, shift):
    """int64 padded tables over S shards: each shard's slice of the run
    index (the tables' own shift, or 9: most entries full) read by the
    plain 3b gives the owner's rank6 and zeros before the shard's first
    head and at or past its upper bound; the sum equals JAX's
    distributed_rank6 under shard_map."""
    idx, _ = index
    t = at_shift(sharding.pad_rindex_tables(idx, S, device="cpu", dtype=torch.int64), shift)
    with jax.enable_x64(True):
        t_jax = jax_sharding.pad_rindex_tables(idx, S)
    prov = sharding.virtual_shards(t, S, "cpu")
    rng = np.random.default_rng(S)
    edges = [int(sh.lo) + d for sh in prov.shards for d in (-1, 0, 1)]
    pos = np.clip(np.concatenate((positions(idx.n, idx.run_start[::5], rng), edges)), 0,
                  idx.n + 1)
    tp = torch.from_numpy(pos)
    total = torch.zeros((len(pos), 6), dtype=torch.int64)
    for sh in prov.shards:
        assert sh.shift == t.run_shift and sh.index.dtype == torch.int32
        part = sh.rank6_plain(tp)
        mine = (tp >= sh.lo) & (tp < sh.upper)
        assert not bool(part[~mine].any())
        total += part
    with jax.enable_x64(True):
        want = jax_distributed_rank6(t_jax, jnp.asarray(pos, jnp.int64), S)
    same(total, want)
    same(total, rank.rank6(t, tp))


def test_distributed_rank6_takes_the_slice_alone(index):
    """run_shard of a slice alone (its own shift, as distributed_rank6
    makes it) equals the placed shard: the same partials."""
    idx, _ = index
    S = 4
    t = sharding.pad_rindex_tables(idx, S, device="cpu", dtype=torch.int64)
    prov = sharding.virtual_shards(t, S, "cpu")
    pos = torch.from_numpy(positions(idx.n, idx.run_start[::9], np.random.default_rng(3)))
    for sh in prov.shards:
        alone = run_shard(sh.run_start, sh.run_sym, sh.cum, sh.upper)
        assert torch.equal(alone.rec, sh.rec)
        assert torch.equal(alone.rank6_plain(pos), sh.rank6_plain(pos))


@pytest.mark.parametrize("shift", [None, 9])
def test_lockstep_engine_through_run_slices_equals_k3(index, shift):
    """The lockstep engine over 4 virtual run shards (the fused step's
    plain version through the slices; full entries at shift 9) equals K3's
    MEMs on checkpoint rows, field for field."""
    idx, lines = index
    reads = synth_reads(lines, 24, 80, error_rate=0.02, seed=9)
    codes = torch.from_numpy(np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                                       for r in reads]).astype(np.int32))
    lens = torch.full((len(reads),), 80, dtype=torch.int32)
    t = at_shift(sharding.pad_rindex_tables(idx, 4, device="cpu"), shift)
    prov = sharding.virtual_shards(t, 4, "cpu")
    got = mems.find_mems_lockstep(prov.shards, prov.C, prov.n, codes, lens, 20, 1,
                                  capacity=8)
    want = mems.find_mems(rindex_to_device(idx, "cpu", checkpoint=True), codes, lens, 20, 1,
                          capacity=8)
    for f, g, w in zip(got._fields, got, want):
        assert torch.equal(g.long(), w.long()), f


@pytest.mark.parametrize("width", list(DTYPES))
def test_rank_guard_catches_a_wrong_entry(index, width):
    """serve.check_rank_tables catches a run index entry that sends a run
    head to another run."""
    idx, _ = index
    t = rindex_to_device(idx, "cpu", bucketed=True, dtype=DTYPES[width][0])
    check_rank_tables(t, "bucketed")
    b = int(idx.run_start[9]) >> t.run_shift
    t.run_index[b, 0] += 3
    with pytest.raises(ValueError, match="disagree"):
        check_rank_tables(t, "bucketed")


def test_records_are_the_dense_layout(index):
    """At int32 the run records are the dense records' rec, row for row."""
    idx, _ = index
    bk = rindex_to_device(idx, "cpu", bucketed=True)
    dn = rindex_to_device(idx, "cpu", dense=True)
    assert torch.equal(bk.run_rec, dn.rec)
    assert torch.equal(derive_run_records(bk.run_start, bk.run_sym, bk.cum), dn.rec)
