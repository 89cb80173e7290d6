"""The dense lines the port's dense kernels find a position's run through
(ops/tables.py:derive_dense_lines: a 16-byte line for each 64 positions, j0
and a mask of the run heads), read by their plain reader
(ops/dense_rank.py:dense_run_of_plain), against pos_to_run as the JAX package
builds it (np.repeat of each run id over its run, then two pads), exactly
(every value is an integer: tolerance 0): every position 0..n + 1 of
made-up run layouts (n off a multiple of 64, runs longer than a line, lines
whose 64 positions are all heads, a single run) and of the bench-like index;
steps other than 0 or 1 refused; the port's dense tables, through the plain
path and through the lines, against the JAX rank6_pallas in interpret mode,
at int32 and at int64 positions (the JAX package under 64-bit types); the
int64 tables field for field against the JAX ones; and, on a made-up index
whose first run ends past 2^31, the run and rank6 of positions past 2^31
through the lines (held in a sparse file: 537 MB of lines, almost all
zero) against the JAX rank6 of its base tables. The card's kernels are held
against these plain versions in tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenome_index_tpu.models.rindex import RIndex as JaxRIndex
from pangenome_index_tpu.ops import rank as jrank
from pangenome_index_tpu.ops.pallas_rank import rank6_pallas
from pangenome_index_tpu.ops.tables import rindex_to_device as jax_rindex_to_device
from pangenome_index_tpu.utils.synth import build_synth_index
import pangenome_index_tpu_torch as port
from pangenome_index_tpu_torch.models.rindex import RIndex
from pangenome_index_tpu_torch.ops import dense_rank, fmd, rank
from pangenome_index_tpu_torch.ops import tables
from pangenome_index_tpu_torch.ops.tables import (DENSE_LINE, derive_dense_lines,
                                                  rindex_to_device, tables_from_numpy)

#: run-length layouts of the made-up indexes (run_lengths)
LAYOUTS = ("long-runs", "all-heads", "mixed", "single-run", "one-line", "two-lines")
#: the tables' fields shared with the JAX package
FIELDS = ("run_sym", "run_start", "cum", "C", "samples", "last_sorted", "last_to_run",
          "bucket_lo", "pos_to_run", "rec", "rank_table", "ckpt", "ckpt_super")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: intra-op threads only contend with the
    other test workers; JAX's type width is restored after the module (the
    int64 cases run the JAX package under 64-bit types)."""
    n, prev = torch.get_num_threads(), jax.config.jax_enable_x64
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def index():
    return build_synth_index(20_000, 4, seed=2)


def run_lengths(layout):
    rng = np.random.default_rng(LAYOUTS.index(layout))
    if layout == "long-runs":   # 65-300 positions a run: lines without a head
        return rng.integers(65, 300, 150)
    if layout == "all-heads":   # one-position runs: every line full of heads
        return np.ones(1000, np.int64)
    if layout == "mixed":       # clusters of one-position runs between long runs
        return np.tile(np.concatenate((np.ones(130, np.int64), [70, 1, 2, 200])), 9)
    if layout == "single-run":
        return np.array([1000])
    if layout == "one-line":    # n + 2 = 64: one full line
        return np.array([20, 1, 1, 40])
    return np.ones(63, np.int64)  # n + 2 = 65: a second line of one entry


def jax_pos_to_run(lengths):
    """pos_to_run as the JAX package builds it
    (pangenome_index_tpu/ops/tables.py: the run id over each run, then two
    pads of the last run)."""
    r = len(lengths)
    runs = np.repeat(np.arange(r, dtype=np.int64), lengths)
    return np.concatenate((runs, [r - 1, r - 1])).astype(np.int32)


def made_index(lengths, cls, seed=0):
    """An r-index (of class cls: the JAX package's or the port's) of these
    run lengths (random symbols 1..5, run 0 the
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
    C = np.concatenate(([0], np.cumsum(contrib.sum(axis=0)))).astype(np.int64)
    n = int(lengths.sum())
    return cls(run_sym=sym, run_start=start, run_len=lengths, cum=cum, C=C, n=n,
               n_seq=1, max_len=n, samples=np.zeros(r, np.int64),
               last_sorted=np.arange(r), last_to_run=np.arange(r))


def every_position(m):
    """0..m - 1, and positions outside them (clamped as the gathers clamp)."""
    return torch.cat((torch.arange(m), torch.tensor([-1, -64, m, m + 63, m + 1000])))


def held_lines(p2r):
    """The lines of pos_to_run [m], their layout, and the run of every
    position through them equal to pos_to_run's (clamped into 0..m - 1)."""
    p2r = torch.from_numpy(np.array(p2r))
    m = p2r.shape[0]
    lines = derive_dense_lines(p2r)
    assert lines.dtype == torch.int32 and tuple(lines.shape) == (-(-m // DENSE_LINE), 4)
    assert torch.equal(lines[:, 0], p2r[::DENSE_LINE])
    assert not bool(lines[:, 3].any())
    pos = every_position(m)
    got = dense_rank.dense_run_of_plain(lines, pos)
    assert torch.equal(got, p2r[pos.clamp(0, m - 1)].long())
    return lines


@pytest.mark.parametrize("layout", LAYOUTS)
def test_run_of_every_position_through_the_lines(layout, monkeypatch):
    """The run of every position 0..n + 1 (the two pads included) and of
    positions outside them, through the lines, equals pos_to_run's; a line
    holds j0 = pos_to_run[64 i] and its heads' bits, whatever the chunk the
    derivation takes at a time."""
    p2r = jax_pos_to_run(run_lengths(layout))
    lines = held_lines(p2r)
    for chunk in (1, 3):
        monkeypatch.setattr(tables, "DENSE_CHUNK_LINES", chunk)
        assert torch.equal(held_lines(p2r), lines)
    heads = (np.diff(p2r) != 0).reshape(-1)
    bits = [(int(e[1]) & 0xFFFFFFFF) | ((int(e[2]) & 0xFFFFFFFF) << 32) for e in lines]
    assert sum(bin(b).count("1") for b in bits) == int(heads.sum()) - sum(
        bool(heads[DENSE_LINE * i - 1]) for i in range(1, len(lines)))
    if layout == "all-heads":  # every line but the last: 63 heads
        assert all(b == (1 << 64) - 2 for b in bits[:-1])
    if layout == "long-runs":
        assert any(b == 0 for b in bits)


def test_run_of_every_position_of_the_bench_like_index(index):
    """On the bench-like index: the JAX package's pos_to_run, the port's
    tables' lines, and the run of every position through them."""
    idx, _ = index
    jt = jax_rindex_to_device(idx, dense=True)
    p2r = np.asarray(jt.pos_to_run)
    lines = held_lines(p2r)
    t = rindex_to_device(idx, "cpu", dense=True)
    assert torch.equal(t.dense_lines, lines)
    assert t.dense_lines.numel() * 4 == 16 * -(-(idx.n + 2) // DENSE_LINE)


@pytest.mark.parametrize("step", [2, -1, 7])
@pytest.mark.parametrize("at", ["inside-a-line", "across-lines", "the-pads"])
def test_steps_other_than_0_or_1_raise(step, at, monkeypatch):
    """A pos_to_run whose step is neither 0 nor 1 anywhere (inside a line,
    from one line into the next, into the pads) has no lines."""
    p2r = jax_pos_to_run(run_lengths("mixed"))
    i = {"inside-a-line": 100, "across-lines": 3 * DENSE_LINE,
         "the-pads": len(p2r) - 1}[at]
    p2r[i:] += step - (p2r[i] - p2r[i - 1])
    for chunk in (1, 1 << 16):
        monkeypatch.setattr(tables, "DENSE_CHUNK_LINES", chunk)
        with pytest.raises(ValueError, match="0 or 1"):
            derive_dense_lines(torch.from_numpy(p2r))


def test_run_ids_past_32_bits_raise():
    p2r = torch.tensor([2**31 - 1, 2**31 - 1, 2**31], dtype=torch.int64)
    with pytest.raises(ValueError, match="32 bits"):
        derive_dense_lines(p2r)


def seeded_positions(n, seed):
    """Random positions in 0..n + 1, every p & 63 in {0, 63} of the first
    lines, and 0, 1, n - 1, n, n + 1."""
    rng = np.random.default_rng(seed)
    edges = np.concatenate((np.arange(0, min(n + 2, 64 * 40), 64),
                            np.arange(63, min(n + 2, 64 * 40), 64)))
    return np.concatenate(([0, 1, n - 1, n, n + 1], edges,
                           rng.integers(0, n + 2, 700))).astype(np.int32)


def records_rank6(rec, j, pos):
    """rec[j, 2:8] + onehot(rec[j, 1]) * (pos - rec[j, 0])."""
    row = rec[j.clamp(0, rec.shape[0] - 1)]
    onehot = torch.arange(6)[None, :] == row[:, 1:2]
    return row[:, 2:8] + onehot.to(rec.dtype) * (pos.to(rec.dtype) - row[:, 0])[:, None]


@pytest.mark.parametrize("layout", ["bench-like", "all-heads", "mixed", "long-runs",
                                    "bench-like-int64", "all-heads-int64", "mixed-int64",
                                    "long-runs-int64"])
def test_dense_rank6_matches_pallas(index, layout):
    """The port's dense tables give, through the plain path (pos_to_run)
    and through the lines, the JAX rank6_pallas in interpret mode, exactly,
    at seeded positions (p & 63 of 0 and 63 among them); at int32
    positions, and at int64 (dtype=int64 tables and positions, the JAX
    package under 64-bit types: int64 ranks from both)."""
    layout, _, width = layout.partition("-int")
    wide = width == "64"
    if layout == "bench-like":
        idx = jidx = index[0]
    else:
        idx, jidx = (made_index(run_lengths(layout), cls) for cls in (RIndex, JaxRIndex))
    with jax.enable_x64(wide):
        jt = jax_rindex_to_device(jidx, dense=True, dtype=jnp.int64 if wide else None)
        pos = seeded_positions(idx.n, 5).astype(np.int64 if wide else np.int32)
        pos = pos[: len(pos) // 8 * 8]
        expect = np.asarray(rank6_pallas(jt.rec, jt.pos_to_run, jnp.asarray(pos),
                                         interpret=True))
        jp2r = np.asarray(jt.pos_to_run)
    pt = rindex_to_device(idx, "cpu", dense=True, dtype=torch.int64 if wide else None)
    assert pt.pos_dtype == (torch.int64 if wide else torch.int32)
    assert expect.dtype == (np.int64 if wide else np.int32)
    np.testing.assert_array_equal(pt.pos_to_run.numpy(), jp2r)
    p = torch.from_numpy(pos)
    for got in (dense_rank.rank6_dense(pt, p), rank.rank6(pt, p),
                records_rank6(pt.rec, dense_rank.dense_run_of_plain(pt.dense_lines, p), p)):
        assert got.dtype == pt.pos_dtype
        np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("layout", ["bench-like", "all-heads", "mixed", "single-run"])
def test_int64_dense_tables_match_jax(index, layout):
    """rindex_to_device(dense=True, dtype=int64) against the JAX
    rindex_to_device(dense=True, dtype=jnp.int64) under 64-bit types: every
    field equal, of the same dtype; the lines derived from the int64
    pos_to_run equal those of the int32 one, and the kernels' provider is
    the int64 one (its records int64, its lines int32)."""
    if layout == "bench-like":
        idx = jidx = index[0]
    else:
        idx, jidx = (made_index(run_lengths(layout), cls) for cls in (RIndex, JaxRIndex))
    with jax.enable_x64(True):
        jt = jax_rindex_to_device(jidx, dense=True, dtype=jnp.int64)
        jf = {f: None if getattr(jt, f) is None else np.asarray(getattr(jt, f))
              for f in FIELDS}
    pt = rindex_to_device(idx, "cpu", dense=True, dtype=torch.int64)
    for f in FIELDS:
        got = getattr(pt, f)
        assert (got is None) == (jf[f] is None), f
        if got is not None:
            assert got.numpy().dtype == jf[f].dtype, f
            np.testing.assert_array_equal(got.numpy(), jf[f], err_msg=f)
    assert pt.rec.dtype == pt.pos_to_run.dtype == torch.int64
    narrow = rindex_to_device(idx, "cpu", dense=True)
    assert pt.dense_lines.dtype == torch.int32
    assert torch.equal(pt.dense_lines, narrow.dense_lines)
    kind, args = fmd.rank_args(pt)
    assert kind == "dense64" and args[1] == pt.dense_lines.shape[0] and args[3] == idx.n_runs


def past_2_31_lengths():
    """tests/test_torch_runindex.py's "past-2^31" layout: a first run past
    2^31, then 3000 short runs."""
    rng = np.random.default_rng(3)
    return np.concatenate(([2**31 + 5], rng.integers(1, 40, 3000)))


def test_dense_lines_past_2_31(tmp_path):
    """On an index whose first run ends past 2^31 (n ~ 2^31 + 60,000): the
    lines, written into a sparse file where they are not all zero (the
    lines inside the first run are: j0 = 0, no head), give the run of every
    position past 2^31, and of positions inside the first run, at the line
    edges and outside the BWT, that the run heads give (the values
    pos_to_run holds), and through the int64 records the JAX rank6 of the
    index's base tables (its searchsorted over run_start) under 64-bit
    types, int64 ranks past 2^31."""
    lengths = past_2_31_lengths()
    idx, jidx = (made_index(lengths, cls) for cls in (RIndex, JaxRIndex))
    n, r = idx.n, idx.n_runs
    m = n + 2
    n_lines = -(-m // DENSE_LINE)
    first = int(lengths[0]) // DENSE_LINE  # the lines before it lie inside run 0
    lines = np.memmap(tmp_path / "lines", dtype=np.int32, mode="w+", shape=(n_lines, 4))
    tail = np.arange(DENSE_LINE * first, m, dtype=np.int64)
    tail_p2r = np.searchsorted(idx.run_start, np.minimum(tail, n - 1), side="right") - 1
    lines[first:] = derive_dense_lines(torch.from_numpy(tail_p2r)).numpy()
    lines.flush()
    rng = np.random.default_rng(9)
    edges = DENSE_LINE * (first + np.arange(-3, n_lines - first))
    pos = np.concatenate((rng.integers(2**31 - 10, m, 3000), rng.integers(0, 2**31, 500),
                          edges, edges + 63, [0, 1, 2**31 - 1, 2**31, n - 1, n, n + 1,
                                              n + 64, -5])).astype(np.int64)
    p = torch.from_numpy(pos)
    run = dense_rank.dense_run_of_plain(torch.from_numpy(lines), p)
    want = np.searchsorted(idx.run_start, np.clip(pos, 0, n - 1), side="right") - 1
    np.testing.assert_array_equal(run.numpy(), want)
    assert int(run.max()) == r - 1 and bool((p >= 2**31).sum() > 3000)
    rec = rindex_to_device(idx, "cpu", bucketed=False, dtype=torch.int64)
    records = torch.cat((rec.run_start[:, None], rec.run_sym.long()[:, None],
                         torch.from_numpy(idx.cum)), dim=1)
    inside = (pos >= 0) & (pos <= n)
    got = records_rank6(records, run, p)[torch.from_numpy(inside)]
    with jax.enable_x64(True):
        jt = jax_rindex_to_device(jidx, bucketed=False, dtype=jnp.int64)
        expect = np.asarray(jrank.rank6(jt, jnp.asarray(pos[inside])))
    assert got.dtype == torch.int64 and expect.dtype == np.int64
    np.testing.assert_array_equal(got.numpy(), expect)
    assert int(got.max()) >= 2**31


def test_every_dense_table_form_carries_its_lines(index):
    """rindex_to_device(dense=True), the public to_device (its default) and
    tables_from_numpy of the JAX tables attach the lines of their pos_to_run,
    at int32 and at int64 positions (the same lines); the kernels' dense
    arguments are the lines and the records; tables without pos_to_run
    carry none."""
    idx, _ = index
    want = derive_dense_lines(rindex_to_device(idx, "cpu", dense=True).pos_to_run)
    jt = jax_rindex_to_device(idx, dense=True)
    fields = ("run_sym", "run_start", "cum", "C", "samples", "last_sorted", "last_to_run",
              "bucket_lo", "pos_to_run", "rec", "rank_table", "ckpt", "ckpt_super")
    from_jax, _ = tables_from_numpy(
        {**{f: None if getattr(jt, f) is None else np.asarray(getattr(jt, f))
            for f in fields}, "n": jt.n, "n_seq": jt.n_seq, "max_len": jt.max_len},
        None, "cpu")
    for t in (rindex_to_device(idx, "cpu", dense=True), port.to_device(idx, "cpu"),
              from_jax, rindex_to_device(idx, "cpu", dense=True, dtype=torch.int64),
              port.to_device(idx, "cpu", dtype=torch.int64)):
        assert torch.equal(t.dense_lines, want)
        kind, args = fmd.rank_args(t)
        assert kind == {torch.int32: "dense", torch.int64: "dense64"}[t.pos_dtype]
        assert args[1] == want.shape[0] and args[3] == idx.n_runs
    for kw in (dict(checkpoint=True), dict(ultra=True), dict(bucketed=True)):
        assert rindex_to_device(idx, "cpu", **kw).dense_lines is None
    t = rindex_to_device(idx, "cpu", dense=True)
    t.dense_lines = None
    with pytest.raises(ValueError, match="lines"):
        fmd.rank_args(t)
