"""The dense lines the port's dense kernels find a position's run through
(ops/tables.py:derive_dense_lines: a 16-byte line for each 64 positions, j0
and a mask of the run heads), read by their plain reader
(ops/dense_rank.py:dense_run_of_plain), against pos_to_run as the JAX package
builds it (np.repeat of each run id over its run, then two pads), exactly
(every value is an integer: tolerance 0): every position 0..n + 1 of
made-up run layouts (n off a multiple of 64, runs longer than a line, lines
whose 64 positions are all heads, a single run) and of the bench-like index;
steps other than 0 or 1 refused; the port's dense tables, through the plain
path and through the lines, against the JAX rank6_pallas in interpret mode.
The card's kernels are held against these plain versions in
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenome_index_tpu.models.rindex import RIndex as JaxRIndex
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


@pytest.mark.parametrize("layout", ["bench-like", "all-heads", "mixed", "long-runs"])
def test_dense_rank6_matches_pallas(index, layout):
    """The port's dense tables give, through the plain path (pos_to_run)
    and through the lines, the JAX rank6_pallas in interpret mode, exactly,
    at seeded positions (p & 63 of 0 and 63 among them)."""
    if layout == "bench-like":
        idx = jidx = index[0]
    else:
        idx, jidx = (made_index(run_lengths(layout), cls) for cls in (RIndex, JaxRIndex))
    jt = jax_rindex_to_device(jidx, dense=True)
    pt = rindex_to_device(idx, "cpu", dense=True)
    assert pt.pos_dtype == torch.int32
    np.testing.assert_array_equal(pt.pos_to_run.numpy(), np.asarray(jt.pos_to_run))
    pos = seeded_positions(idx.n, 5)
    pos = pos[: len(pos) // 8 * 8]
    expect = np.asarray(rank6_pallas(jt.rec, jt.pos_to_run, jnp.asarray(pos),
                                     interpret=True))
    p = torch.from_numpy(pos)
    np.testing.assert_array_equal(dense_rank.rank6_dense(pt, p).numpy(), expect)
    np.testing.assert_array_equal(rank.rank6(pt, p).numpy(), expect)
    through_lines = records_rank6(pt.rec, dense_rank.dense_run_of_plain(pt.dense_lines, p), p)
    np.testing.assert_array_equal(through_lines.numpy(), expect)


def test_every_dense_table_form_carries_its_lines(index):
    """rindex_to_device(dense=True), the public to_device (its default) and
    tables_from_numpy of the JAX tables attach the lines of their pos_to_run;
    the kernels' dense arguments are the lines and the records; tables
    without int32 pos_to_run carry none."""
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
              from_jax):
        assert torch.equal(t.dense_lines, want)
        kind, args = fmd.rank_args(t)
        assert kind == "dense" and args[1] == want.shape[0] and args[3] == idx.n_runs
    assert rindex_to_device(idx, "cpu", dense=True, dtype=torch.int64).dense_lines is None
    for kw in (dict(checkpoint=True), dict(ultra=True), dict(bucketed=True)):
        assert rindex_to_device(idx, "cpu", **kw).dense_lines is None
    t = rindex_to_device(idx, "cpu", dense=True)
    t.dense_lines = None
    with pytest.raises(ValueError, match="lines"):
        fmd.rank_args(t)
