"""The port's query-tags pieces against the JAX package, exactly, on a small
synthetic index (CPU: the port's plain versions): lf_range and backward
search (K7 count) over checkpoint, two-level checkpoint, dense and base
tables; tag positions per interval (K6 query_tags_batch); and the seed
table's npz cache, shared with the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenome_index_tpu.cli import _resolve_mer_len
from pangenome_index_tpu.ops import mertable as jax_mertable
from pangenome_index_tpu.ops import rank as jrank
from pangenome_index_tpu.ops.tables import rindex_to_device as jax_rindex_to_device
from pangenome_index_tpu.ops.tables import tags_to_device as jax_tags_to_device
from pangenome_index_tpu.models.tagarray import TagArray as JaxTagArray
from pangenome_index_tpu.ops.tagquery import query_tags_batch as jax_query_tags_batch
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu.utils.synth import build_synth_index, synth_tag_array
from pangenome_index_tpu_torch.ops import mertable, rank
from pangenome_index_tpu_torch.ops.count import count
from pangenome_index_tpu_torch.ops.tables import rindex_to_device, tags_to_device
from pangenome_index_tpu_torch.ops.tagquery import query_tags_batch

#: (JAX rindex_to_device options, port rindex_to_device options)
MODES = {"checkpoint": (dict(checkpoint=True), dict(checkpoint=True)),
         "two_level": (dict(checkpoint=True, super_shift=9),
                       dict(checkpoint=True, super_shift=9)),
         "dense": (dict(dense=True), dict(dense=True)),
         "base": (dict(bucketed=False), dict())}


@pytest.fixture(autouse=True, scope="module")
def jax_at_32_bits():
    """The JAX references here run at 32 bits, as the port's int32 tables
    do. A test file that ran earlier on this worker may have turned 64-bit
    types on for the whole process (the JAX package does so for int64
    tables), under which the JAX loops' carried types no longer match; the
    flag is restored after the module."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


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


@pytest.fixture(scope="module")
def reads(index):
    """Reads, their codes [B, L] (0-padded) and lengths: substrings of the
    haplotypes (present), random strings (mostly absent), reads with an N,
    ragged lengths and one empty read."""
    _, lines = index
    rng = np.random.default_rng(7)
    out = []
    for _ in range(48):
        line = lines[int(rng.integers(len(lines)))]
        n = int(rng.integers(1, 60))
        s = int(rng.integers(0, len(line) - n))
        out.append(line[s : s + n])
    out += [rng.choice(np.frombuffer(b"ACGT", np.uint8), int(rng.integers(4, 40)))
            .tobytes() for _ in range(16)]
    out[3] = out[3][:5] + b"N" + out[3][6:]
    out[20] = b"N" + out[20]
    out.append(b"")
    L = max(len(r) for r in out)
    codes = np.zeros((len(out), L), np.int32)
    lens = np.array([len(r) for r in out], np.int32)
    for i, r in enumerate(out):
        codes[i, : len(r)] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    return out, codes, lens


@pytest.mark.parametrize("mode", list(MODES))
def test_lf_range_matches_jax(index, mode):
    idx, _ = index
    jt = jax_rindex_to_device(idx, **MODES[mode][0])
    pt = rindex_to_device(idx, "cpu", **MODES[mode][1])
    rng = np.random.default_rng(3)
    B = 512
    first = rng.integers(0, idx.n, B)
    second = np.minimum(first + rng.integers(-5, 3000, B), idx.n - 1)
    code = rng.integers(0, 6, B)
    first[:3], second[:3], code[:3] = (0, 5, 9), (idx.n - 1, 4, 9), (1, 1, 0)
    args = [a.astype(np.int32) for a in (first, second, code)]
    expect = jrank.lf_range(jt, *(jnp.asarray(a) for a in args))
    got = rank.lf_range(pt, *(torch.from_numpy(a) for a in args))
    for g, e in zip(got, expect):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    np.testing.assert_array_equal(
        rank.rank(pt, torch.from_numpy(args[0]), torch.from_numpy(args[2])).numpy(),
        np.asarray(jrank.rank(jt, jnp.asarray(args[0]), jnp.asarray(args[2]))))


@pytest.mark.parametrize("mode", list(MODES))
def test_count_matches_jax(index, reads, mode):
    idx, _ = index
    raw, codes, lens = reads
    jt = jax_rindex_to_device(idx, **MODES[mode][0])
    pt = rindex_to_device(idx, "cpu", **MODES[mode][1])
    ef, es = jrank.count(jt, jnp.asarray(codes), jnp.asarray(lens))
    f, s = count(pt, torch.from_numpy(codes), torch.from_numpy(lens))
    np.testing.assert_array_equal(f.numpy(), np.asarray(ef))
    np.testing.assert_array_equal(s.numpy(), np.asarray(es))
    found = f.numpy() <= s.numpy()
    with_n = np.isin(np.arange(len(found)), [3, 20])
    assert found[:48][~with_n[:48]].all() and not found[with_n].any()
    # the host model agrees on the interval of every read that occurs
    for i in np.flatnonzero(found)[:8]:
        assert idx.count(raw[i]) == (int(f[i]), int(s[i]))


def test_count_kernel_refuses_base_tables(index, reads):
    """Only the plain version reads base tables; the wrapper takes the
    plain path here because the tensors lie on the CPU."""
    from pangenome_index_tpu_torch.ops.fmd import check_kernel_tables

    idx, _ = index
    with pytest.raises(ValueError, match="neither"):
        check_kernel_tables(rindex_to_device(idx, "cpu"))


@pytest.mark.parametrize("capacity", [1, 8, 256])
@pytest.mark.parametrize("exact", [False, True])
def test_query_tags_batch_matches_jax(index, capacity, exact):
    idx, lines = index
    tags = synth_tag_array(idx, lines=lines)
    rng = np.random.default_rng(capacity)
    B = 384
    start = rng.integers(0, idx.n, B)
    span = np.where(rng.random(B) < 0.5, rng.integers(0, 4, B),
                    rng.integers(0, 5000, B))
    end = np.minimum(start + span, idx.n - 1)
    # first_bit % 10 == 0: starts on the head before a multiple-of-10 run
    heads = tags.bwt_start[np.arange(9, min(tags.n_runs, 400), 10)]
    start[: len(heads)] = heads
    end[: len(heads)] = heads + rng.integers(0, 3, len(heads))
    # start > end, across runs: negative run counts
    start[-8:], end[-8:] = np.minimum(end[-8:] + 5000, idx.n - 1), start[-8:].copy()
    args = [a.astype(np.int32) for a in (start, end)]
    expect = jax_query_tags_batch(jax_tags_to_device(tags),
                                  *(jnp.asarray(a) for a in args),
                                  capacity=capacity, exact=exact)
    got = query_tags_batch(tags_to_device(tags, "cpu"),
                           *(torch.from_numpy(a) for a in args),
                           capacity=capacity, exact=exact)
    for name, g, e in zip(got._fields, got, expect):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=name)
    assert got.overflow.any() and (got.n_runs <= 0).any()
    if capacity < 256:
        assert not got.overflow.all()


def wide_intervals(bwt_start: np.ndarray, total: int, spans, rng):
    """Intervals that span the given numbers of tag runs: from inside run i
    to inside run i + span - 1 (clipped to the array)."""
    t = len(bwt_start)
    spans = np.asarray(spans)
    first = rng.integers(0, t, len(spans))
    last = np.minimum(first + spans - 1, t - 1)
    ends = np.concatenate((bwt_start[1:], [total]))
    start = rng.integers(bwt_start[first], ends[first])
    end = np.maximum(rng.integers(bwt_start[last], ends[last]), start)
    return start.astype(np.int32), end.astype(np.int32)


@pytest.mark.parametrize("capacity", [1, 8, 33, 256])
@pytest.mark.parametrize("exact", [False, True])
def test_query_tags_batch_wide_rows_match_jax(capacity, exact):
    """Rows of 1 run to past the capacity, over a tag array whose positions
    repeat (so the dedupe has work) and hold one INT64_MAX (never kept)."""
    rng = np.random.default_rng(100 + capacity)
    t = 3000
    pos = rng.integers(0, 400, t) * 7
    pos[rng.integers(0, t, 40)] = pos[rng.integers(0, t, 40)]
    pos[1234] = np.iinfo(np.int64).max
    tags = JaxTagArray.from_runs(pos, rng.integers(1, 6, t))
    spans = np.concatenate((np.arange(1, 70), [127, 128, 129, 255, 256, 257, 300,
                                               511, 600], rng.integers(2, 300, 120)))
    start, end = wide_intervals(tags.bwt_start, tags.total, spans, rng)
    # rows at the array's two ends, and the run that holds INT64_MAX
    start[-3:] = (0, tags.bwt_start[-3], tags.bwt_start[1230])
    end[-3:] = (tags.bwt_start[40], tags.total - 1, tags.bwt_start[1240])
    expect = jax_query_tags_batch(jax_tags_to_device(tags), jnp.asarray(start),
                                  jnp.asarray(end), capacity=capacity, exact=exact)
    got = query_tags_batch(tags_to_device(tags, "cpu"), torch.from_numpy(start),
                           torch.from_numpy(end), capacity=capacity, exact=exact)
    for name, g, e in zip(got._fields, got, expect):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=name)
    assert got.overflow.any() and not got.overflow.all()
    assert int(got.n_runs.max()) > 256 and int(got.n_unique.max()) >= min(capacity, 100)
    if capacity > 1:   # some windows hold a position twice
        assert (got.n_unique < got.n_runs.clamp(max=capacity)).any()
    assert not (got.positions == np.iinfo(np.int64).max).any()


@pytest.mark.parametrize("kernel", ["count", "query_tags_batch"])
def test_wrappers_refuse_mismatched_shapes(index, kernel):
    """Shapes are checked before any pointer reaches a kernel, on every
    device alike."""
    idx, lines = index
    z = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be"):
        if kernel == "count":
            count(rindex_to_device(idx, "cpu", checkpoint=True),
                  torch.zeros((6, 10), dtype=torch.int32), z[:5])
        else:
            query_tags_batch(tags_to_device(synth_tag_array(idx, lines=lines), "cpu"),
                             z, z[:5])


def test_mer_table_cache_shared_with_jax(index, tmp_path, monkeypatch):
    idx, _ = index
    m = 5
    pt = rindex_to_device(idx, "cpu", checkpoint=True)
    host = jax_mertable.build_mer_table(idx, m)   # int64, as JAX's host build
    # the port reads a table the JAX package wrote, and builds nothing
    jax_path = str(tmp_path / "jax.mer5.npz")
    jax_mertable._persist_mer(jax_path, host, jax_mertable.mer_table_key(idx, m))

    def no_build(*a, **k):
        raise AssertionError("the cache was not read")

    with monkeypatch.context() as mp:
        mp.setattr(mertable, "build_mer_table_device", no_build)
        got, m_used = mertable.get_mer_table(idx, m, pt, jax_path)
    assert got.dtype == torch.int32 and m_used == m
    np.testing.assert_array_equal(got.numpy(), host)
    # the JAX package reads a table the port built and wrote (int32)
    port_path = str(tmp_path / "port.mer5.npz")
    built, _ = mertable.get_mer_table(idx, m, pt, port_path)
    table, _, m_used = jax_mertable.get_mer_table(idx, m, path=port_path)
    assert m_used == m and table.dtype == np.int32
    np.testing.assert_array_equal(table, host)
    np.testing.assert_array_equal(built.numpy(), host)
    # a table for other content is rebuilt, not served
    other = build_synth_index(2_000, 2, seed=5)[0]
    assert not np.array_equal(
        mertable.get_mer_table(other, m, rindex_to_device(other, "cpu", dense=True),
                               port_path)[0].numpy(), host)


@pytest.mark.parametrize("steps", [0, 1, 2])
def test_get_mer_table_steps_m_down(index, tmp_path, capfd, steps):
    """Under a byte budget get_mer_table tries m, then m - 1, down to
    min_m = max(m - 2, 4), names each step on stderr in the reference's
    words, and returns the table it built with the m it used, keyed by that
    m in the cache; the table equals the host build at that m."""
    idx, _ = index
    m = 7
    pt = rindex_to_device(idx, "cpu", checkpoint=True)
    budget = mertable.mer_table_bytes(m - steps)
    capfd.readouterr()
    table, m_used = mertable.get_mer_table(
        idx, m, pt, lambda mt: str(tmp_path / f"x.mer{mt}.npz"), max_bytes=budget)
    err = capfd.readouterr().err
    assert m_used == m - steps
    np.testing.assert_array_equal(table.numpy(), jax_mertable.build_mer_table(idx, m_used))
    for mt in range(m, m - steps, -1):
        assert f"mer table: device build failed at m={mt} (MemoryError: " in err
        assert not (tmp_path / f"x.mer{mt}.npz").exists()
    assert err.count("stepping down") == steps
    with np.load(tmp_path / f"x.mer{m_used}.npz", allow_pickle=False) as z:
        assert str(z["key"]) == jax_mertable.mer_table_key(idx, m_used)


def test_get_mer_table_below_min_m_raises(index):
    """No m down to min_m fits: MemoryError with the sizes (no host build
    behind the device's)."""
    idx, _ = index
    pt = rindex_to_device(idx, "cpu", checkpoint=True)
    with pytest.raises(MemoryError, match=r"from 6 down to 4 .* budget of 1000 bytes"):
        mertable.get_mer_table(idx, 6, pt, max_bytes=1000)


@pytest.mark.parametrize("arg,min_len", [(-1, 20), (-1, 6), (-1, 4), (6, 20),
                                         (6, 6), (0, 20)])
def test_resolve_mer_len_matches_jax_on_cpu(index, arg, min_len):
    idx, _ = index
    assert mertable.resolve_mer_len(arg, min_len, idx.n, "cpu") == \
        _resolve_mer_len(arg, min_len, idx.n)
