"""The JAX table arguments ckpt_block and mem_only in the port, against the
JAX package on the CPU, exactly (every value is an integer: tolerance 0).

Checkpoint rows of 128 positions (24 words: the JAX package's
ckpt_block=128), in one level and in two (superblocks of 2^9 positions, int64
positions, the JAX package under 64-bit types), with and without mem_only's
one-row stubs of the per-run and locate tables: every field of
rindex_to_device and of pad_rindex_tables equal to the JAX one's; the
kernels' 64-position bit-plane rows derived from 128-position rows equal to
those derived from 64-position rows (over the (n >> 6) + 2 rows of the
latter; the rows past them are pad rows that give the same rank6 at every
position, clamped or not) and read back to the JAX package's rank6; the
plain extension, MEM finding and backward search through 128-position rows
equal to the JAX ones on the same tables; the JAX errors. The card's kernels
read the same planes (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenome_index_tpu.models.rindex import RIndex as JaxRIndex
from pangenome_index_tpu.ops import rank as jrank
from pangenome_index_tpu.ops.fmd import extend as jax_extend
from pangenome_index_tpu.ops.mems import find_mems_batch
from pangenome_index_tpu.ops.tables import rindex_to_device as jax_rindex_to_device
from pangenome_index_tpu.parallel import sharding as jax_sharding
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu.utils.synth import build_synth_index, synth_reads
from pangenome_index_tpu_torch.ops import count, fmd, mems, rank
from pangenome_index_tpu_torch.ops.tables import (build_ckpt_rows, derive_rank_planes,
                                                  derive_super_S, rindex_to_device,
                                                  split_ckpt_rows)
from pangenome_index_tpu_torch.parallel import sharding

FIELDS = ("run_sym", "run_start", "cum", "C", "samples", "last_sorted", "last_to_run",
          "bucket_lo", "pos_to_run", "rec", "rank_table", "ckpt", "ckpt_super")
#: the table forms: (levels, super_shift, position dtypes)
LEVELS = {"one-level": (None, torch.int32, jnp.int32),
          "two-level": (9, torch.int64, jnp.int64)}
MIN_LEN, MIN_OCC = 20, 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
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


@pytest.fixture(scope="module")
def reads(index):
    idx, lines = index
    rs = synth_reads(lines, 32, 100, error_rate=0.01, seed=5)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)] for r in rs]).astype(np.int32)
    lens = np.full(len(rs), 100, np.int32)
    lens[::5] = 60
    for i, n in enumerate(lens):
        codes[i, n:] = 0
    return codes, lens


def made_index(n, seed):
    """An r-index of n positions in random runs of 1 to 90 (random symbols
    1..5, run 0 the endmarker's code 0; one sample a run)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 90, n)
    lengths = lengths[: int(np.searchsorted(np.cumsum(lengths), n)) + 1]
    lengths[-1] -= int(lengths.sum()) - n
    lengths = lengths[lengths > 0]
    r = len(lengths)
    sym = rng.integers(1, 6, r).astype(np.int8)
    sym[0] = 0
    start = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    contrib = np.zeros((r, 6), np.int64)
    contrib[np.arange(r), sym] = lengths
    cum = np.zeros((r, 6), np.int64)
    np.cumsum(contrib[:-1], axis=0, out=cum[1:])
    C = np.concatenate(([0], np.cumsum(contrib.sum(axis=0)))).astype(np.int64)
    return JaxRIndex(run_sym=sym, run_start=start, run_len=lengths, cum=cum, C=C, n=n,
                     n_seq=1, max_len=n, samples=np.zeros(r, np.int64),
                     last_sorted=np.arange(r), last_to_run=np.arange(r))


def jax_fields(t):
    return {f: None if getattr(t, f) is None else np.asarray(getattr(t, f)) for f in FIELDS}


def same_fields(pt, jf):
    for f in FIELDS:
        got = getattr(pt, f)
        assert (got is None) == (jf[f] is None), f
        if got is not None:
            assert got.numpy().dtype == jf[f].dtype, f
            np.testing.assert_array_equal(got.numpy(), jf[f], err_msg=f)


def wide(levels):
    return jax.enable_x64(levels == "two-level")


@pytest.mark.parametrize("mem_only", [False, True], ids=["full", "mem-only"])
@pytest.mark.parametrize("levels", list(LEVELS))
@pytest.mark.parametrize("block", [64, 128])
def test_rindex_to_device_matches_jax(index, block, levels, mem_only):
    """Every field of rindex_to_device(checkpoint=True, ckpt_block=block,
    mem_only=...) equal to the JAX function's with the same arguments, of
    the same dtype; the rows 16 or 24 words wide, the kernels' planes 16
    words, twice as many as the rows at 128."""
    idx, _ = index
    ss, pd, jd = LEVELS[levels]
    with wide(levels):
        jf = jax_fields(jax_rindex_to_device(idx, dtype=jd, checkpoint=True, ckpt_block=block,
                                             super_shift=ss, mem_only=mem_only))
    pt = rindex_to_device(idx, "cpu", checkpoint=True, ckpt_block=block, super_shift=ss,
                          mem_only=mem_only, dtype=pd)
    same_fields(pt, jf)
    assert pt.ckpt.shape[1] == {64: 16, 128: 24}[block]
    assert pt.ckpt_planes.shape == ((block // 64) * pt.ckpt.shape[0], 16)
    assert (pt.run_start.shape[0] == 1) == mem_only
    assert (pt.ckpt_super is not None) == (levels == "two-level")


@pytest.mark.parametrize("mem_only", [False, True], ids=["full", "mem-only"])
@pytest.mark.parametrize("levels", list(LEVELS))
@pytest.mark.parametrize("block", [64, 128])
def test_pad_rindex_tables_matches_jax(index, block, levels, mem_only):
    """pad_rindex_tables over 4 model shards: every field equal to the JAX
    function's (the checkpoint rows padded to a multiple of 4 rows, the
    stubs tiled to 4); the planes follow the padded rows and divide over the
    shards."""
    idx, _ = index
    ss, pd, jd = LEVELS[levels]
    with wide(levels):
        jt = jax_sharding.pad_rindex_tables(idx, 4, checkpoint=True, ckpt_block=block,
                                            super_shift=ss, mem_only=mem_only)
        if levels == "two-level":  # the JAX function takes the default dtype
            jt = jt._replace(**{f: getattr(jt, f).astype(jnp.int64) for f in (
                "run_start", "cum", "C", "samples", "last_sorted", "last_to_run")})
        jf = jax_fields(jt)
    pt = sharding.pad_rindex_tables(idx, 4, checkpoint=True, ckpt_block=block,
                                    super_shift=ss, mem_only=mem_only, device="cpu",
                                    dtype=pd)
    same_fields(pt, jf)
    assert pt.ckpt.shape[0] % 4 == 0 and pt.ckpt_planes.shape[0] % 4 == 0
    assert torch.equal(pt.ckpt_planes, derive_rank_planes(pt.ckpt))


#: indexes of n off and on multiples of 64 and 128
SIZES = {"n%128=0": 128 * 97, "n%128=64": 128 * 97 + 64, "n%128=100": 128 * 97 + 100,
         "n%128=30": 128 * 97 + 30, "bench-like": None}


@pytest.mark.parametrize("levels", list(LEVELS))
@pytest.mark.parametrize("size", list(SIZES))
def test_planes_of_128_rows_equal_those_of_64_rows(index, size, levels):
    """The bit-plane rows derived from 128-position rows equal those derived
    from 64-position rows over the (n >> 6) + 2 rows of the latter, and the
    superblock bases over the latter's superblocks; the 128-position form's
    pad rows past them give the same rank6 at every position 0..n + 1 and
    past it (clamped), through planes_rank6 (the kernels' read), which
    equals the JAX _ckpt_rank6 of the 128-position rows. split_ckpt_rows
    gives the 64-position rows themselves."""
    idx = index[0] if SIZES[size] is None else made_index(SIZES[size], seed=len(size))
    ss, pd, jd = LEVELS[levels]
    r64, s64 = build_ckpt_rows(idx, 64, super_shift=ss)
    r128, s128 = build_ckpt_rows(idx, 128, super_shift=ss)
    r64, r128 = torch.from_numpy(r64), torch.from_numpy(r128)
    rows = r64.shape[0]
    assert rows == (idx.n >> 6) + 2
    split = split_ckpt_rows(r128)
    assert torch.equal(split[:rows], r64)
    p64, p128 = derive_rank_planes(r64), derive_rank_planes(r128)
    assert p128.shape[0] == 2 * r128.shape[0] >= rows + 1
    assert torch.equal(p128[:rows], p64)
    for chunk in (1, 3):
        assert torch.equal(derive_rank_planes(r128, chunk_rows=chunk), p128)
    sup64 = sup128 = None
    if ss is not None:
        sup64 = derive_super_S(torch.from_numpy(s64))
        sup128 = derive_super_S(torch.from_numpy(s128))
        assert torch.equal(sup128[: sup64.shape[0]], sup64)
    pos = torch.arange(-3, idx.n + 300, dtype=torch.int64)
    kw64 = {} if ss is None else dict(super_S=sup64, super_shift=ss)
    kw128 = {} if ss is None else dict(super_S=sup128, super_shift=ss)
    got = rank.planes_rank6(p128, pos.clamp(min=0), **kw128)
    assert torch.equal(got.long(), rank.planes_rank6(p64, pos.clamp(min=0), **kw64).long())
    inside = torch.arange(0, idx.n + 2, dtype=torch.int64)
    with wide(levels):
        jt = jax_rindex_to_device(idx, dtype=jd, checkpoint=True, ckpt_block=128,
                                  super_shift=ss)
        expect = np.asarray(jrank._ckpt_rank6(jt, jnp.asarray(inside.numpy().astype(
            np.int64 if ss else np.int32))))
    np.testing.assert_array_equal(got[3 : 3 + inside.shape[0]].numpy().astype(np.int64),
                                  expect.astype(np.int64))
    pt = rindex_to_device(idx, "cpu", checkpoint=True, ckpt_block=128, super_shift=ss,
                          dtype=pd)
    np.testing.assert_array_equal(rank.ckpt_rank6(pt, inside.to(pd)).numpy(), expect)


@pytest.mark.parametrize("mem_only", [False, True], ids=["full", "mem-only"])
@pytest.mark.parametrize("levels", list(LEVELS))
def test_chain_functions_through_128_rows_match_jax(index, reads, levels, mem_only):
    """extend, find_mems and count (their plain versions: CPU tensors)
    through 128-position rows equal the JAX functions on the JAX package's
    128-position tables, and the port's own results through 64-position
    rows."""
    idx, _ = index
    codes, lens = reads
    ss, pd, jd = LEVELS[levels]
    npd = np.int64 if ss else np.int32
    kw = dict(checkpoint=True, super_shift=ss, mem_only=mem_only)
    pt = rindex_to_device(idx, "cpu", ckpt_block=128, dtype=pd, **kw)
    p64 = rindex_to_device(idx, "cpu", ckpt_block=64, dtype=pd, **kw)
    rng = np.random.default_rng(1)
    B = 512
    k = rng.integers(0, idx.n, B)
    s = rng.integers(0, np.minimum(idx.n - k, 3000) + 1)
    s[::4] = rng.integers(0, 4, len(s[::4]))
    s = np.minimum(s, idx.n - k)
    lanes = [a.astype(npd) for a in (k, rng.integers(0, idx.n, B), s)]
    code = rng.integers(-1, 8, B).astype(np.int32)
    fwd = rng.integers(0, 2, B).astype(bool)
    with wide(levels):
        jt = jax_rindex_to_device(idx, dtype=jd, ckpt_block=128, **kw)
        e_ext = [np.asarray(a) for a in jax_extend(
            jt, *(jnp.asarray(a) for a in lanes), jnp.asarray(code), forward=jnp.asarray(fwd))]
        e_mem = [np.asarray(a) for a in find_mems_batch(
            jt, jnp.asarray(codes), jnp.asarray(lens), MIN_LEN, MIN_OCC, capacity=8)]
        e_cnt = [np.asarray(a) for a in jrank.count(jt, jnp.asarray(codes), jnp.asarray(lens))]
    args = [torch.from_numpy(a) for a in lanes] + [torch.from_numpy(code)]
    for t, want in ((pt, None), (p64, None)):
        got = fmd.extend(t, *args, forward=torch.from_numpy(fwd))
        for g, e in zip(got, e_ext):
            assert g.dtype == pd
            np.testing.assert_array_equal(g.numpy(), e)
        got = mems.find_mems(t, torch.from_numpy(codes), torch.from_numpy(lens), MIN_LEN,
                             MIN_OCC, capacity=8)
        for name, g, e in zip(got._fields, got, e_mem):
            np.testing.assert_array_equal(g.numpy(), e, err_msg=name)
        assert int(got.count.sum()) > len(lens)
        for g, e in zip(count.count(t, torch.from_numpy(codes), torch.from_numpy(lens)),
                        e_cnt):
            np.testing.assert_array_equal(g.numpy(), e)


@pytest.mark.parametrize("call", ["rindex_to_device", "pad_rindex_tables"])
def test_the_jax_errors(index, call):
    """mem_only without checkpoint rows, and a block of 96 positions, raise
    the JAX functions' errors in the port's."""
    idx, _ = index
    port = {"rindex_to_device": lambda **kw: rindex_to_device(idx, "cpu", **kw),
            "pad_rindex_tables": lambda **kw: sharding.pad_rindex_tables(
                idx, 4, device="cpu", **kw)}[call]
    ref = {"rindex_to_device": lambda **kw: jax_rindex_to_device(idx, **kw),
           "pad_rindex_tables": lambda **kw: jax_sharding.pad_rindex_tables(idx, 4, **kw)}[call]
    for kw, msg in ((dict(mem_only=True), "mem_only requires checkpoint mode"),
                    (dict(checkpoint=True, ckpt_block=96), "ckpt_block must be 64 or 128")):
        for fn in (port, ref):
            with pytest.raises(ValueError, match=msg):
                fn(**kw)
    with pytest.raises(ValueError, match="must be 64 or 128"):
        build_ckpt_rows(idx, 32)
    with pytest.raises(ValueError, match=r"\[rows, 16\] or \[rows, 24\]"):
        derive_rank_planes(torch.zeros((4, 20), dtype=torch.int32))
