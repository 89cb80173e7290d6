"""The PyTorch port's MEM engine and seed table against the JAX package,
exactly, on a small synthetic index (CPU: the port's plain versions; the
JAX dense-rank path runs its Pallas kernel in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenome_index_tpu.ops.mems import find_mems_batch, find_mems_impl
from pangenome_index_tpu.ops.mertable import (build_mer_table, read_mer_keys_fast,
                                              seed_difficulty as jax_seed_difficulty)
from pangenome_index_tpu.ops.pallas_rank import rank6_pallas
from pangenome_index_tpu.ops.sparsedict import build_sparse_dict, read_windows_fast
from pangenome_index_tpu.ops.tables import rindex_to_device as jax_rindex_to_device
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu.utils.synth import build_synth_index, synth_reads
from pangenome_index_tpu_torch.ops import mertable
from pangenome_index_tpu_torch.ops.mems import find_mems
from pangenome_index_tpu_torch.ops.tables import rindex_to_device

MIN_LEN, MIN_OCC, MER_M, SDICT_S = 20, 1, 6, 19


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
def setup():
    idx, lines = build_synth_index(20_000, 4, seed=2)
    reads = synth_reads(lines, 64, 100, error_rate=0.01, seed=5)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)] for r in reads])
    codes = codes.astype(np.int32)
    lens = np.full(len(reads), 100, np.int32)
    lens[::7] = np.random.default_rng(5).integers(30, 100, len(lens[::7]))
    for i, n in enumerate(lens):
        codes[i, n:] = 0
    codes[3, 40] = codes[9, 5] = 4  # an N: invalid seed windows
    mt = build_mer_table(idx, MER_M).astype(np.int32)
    mk, mv = read_mer_keys_fast(codes, lens, MER_M)
    keys, vals = build_sparse_dict(idx, SDICT_S)
    _, _, di = read_windows_fast(codes, lens, SDICT_S, keys)
    return idx, codes, lens, dict(mt=mt, mk=mk, mv=mv, vals=vals, di=di)


def seed_kwargs(tiers, s, lib):
    asarray = jnp.asarray if lib == "jax" else torch.from_numpy
    kw = {}
    if "dense" in tiers:
        kw.update(mer_table=asarray(s["mt"]), mer_keys=asarray(s["mk"]),
                  mer_valid=asarray(s["mv"]), mer_m=MER_M)
    if "sdict" in tiers:
        kw.update(sdict_vals=asarray(s["vals"]), sdict_idx=asarray(s["di"]),
                  sdict_m=SDICT_S)
    return kw


def assert_same(got, expect):
    for name, g, e in zip(got._fields, got, expect):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=name)


@pytest.mark.parametrize("capacity", [8, 32])
@pytest.mark.parametrize("tiers", ["none", "dense", "sdict", "dense+sdict"])
def test_find_mems_matches_jax(setup, tiers, capacity):
    idx, codes, lens, s = setup
    jt = jax_rindex_to_device(idx, checkpoint=True)
    expect, jstats = find_mems_batch(jt, jnp.asarray(codes), jnp.asarray(lens),
                                     MIN_LEN, MIN_OCC, capacity=capacity,
                                     with_stats=True,
                                     **seed_kwargs(tiers, s, "jax"))
    pt = rindex_to_device(idx, "cpu", checkpoint=True)
    got, stats = find_mems(pt, torch.from_numpy(codes), torch.from_numpy(lens),
                           MIN_LEN, MIN_OCC, capacity=capacity, with_stats=True,
                           **seed_kwargs(tiers, s, "torch"))
    assert_same(got, expect)
    assert int(stats["steps"].sum()) == int(jstats["steps"])
    if capacity == 8:
        assert bool(got.overflow.any())  # counts stay exact past the capacity


#: seed inputs where a tier finds nothing: no dictionary entry at any
#: position, no valid m-mer window, neither, the dictionary alone with no
#: entry, and min_occ 3 (dictionary rows under it fall to the m-mer table)
SEED_MISSES = {"dict-all-miss": ("dense+sdict", ("di",), 1),
               "mer-all-invalid": ("dense+sdict", ("mv",), 1),
               "both-miss": ("dense+sdict", ("di", "mv"), 1),
               "sdict-only-all-miss": ("sdict", ("di",), 1),
               "min-occ-3": ("dense+sdict", (), 3)}


@pytest.mark.parametrize("case", list(SEED_MISSES))
def test_find_mems_matches_jax_when_seeds_miss(setup, case):
    """The seed merge (resolve_seeds_plain against the JAX engine's,
    mems.py:87-116, reached through find_mems_impl) where a tier misses
    everywhere or is off."""
    idx, codes, lens, s = setup
    tiers, missing, min_occ = SEED_MISSES[case]
    s = dict(s)
    if "di" in missing:
        s["di"] = np.full_like(s["di"], -1)
    if "mv" in missing:
        s["mv"] = np.zeros_like(s["mv"])
    jt = jax_rindex_to_device(idx, checkpoint=True)
    expect, jstats = find_mems_batch(jt, jnp.asarray(codes), jnp.asarray(lens),
                                     MIN_LEN, min_occ, capacity=8, with_stats=True,
                                     **seed_kwargs(tiers, s, "jax"))
    pt = rindex_to_device(idx, "cpu", checkpoint=True)
    got, stats = find_mems(pt, torch.from_numpy(codes), torch.from_numpy(lens),
                           MIN_LEN, min_occ, capacity=8, with_stats=True,
                           **seed_kwargs(tiers, s, "torch"))
    assert_same(got, expect)
    assert int(stats["steps"].sum()) == int(jstats["steps"])


@pytest.mark.parametrize("rows", ["shared", "straddled"])
@pytest.mark.parametrize("mode", ["checkpoint", "dense"])
def test_extend_interval_ends_share_or_straddle_a_row(setup, mode, rows):
    """Extensions whose interval ends bk and bk + s lie in one 64-position
    checkpoint row, and ones whose ends lie in two (also with bk + s on the
    row edge), against the JAX extend and the host model."""
    idx = setup[0]
    rng = np.random.default_rng(11)
    B = 384
    if rows == "shared":
        k = rng.integers(0, idx.n - 64, B)
        s = rng.integers(1, 64 - (k & 63) + 1)        # bk + s <= row end
        s[::5] = 64 - (k[::5] & 63)                   # exactly on the edge
        assert (((k + s - 1) >> 6) == (k >> 6)).all()
    else:
        k = rng.integers(0, idx.n - 4096, B)
        s = rng.integers(64, 4096, B)
        s[::5] = 64 - (k[::5] & 63) + 64 * rng.integers(1, 9, len(k[::5]))
        assert (((k + s) >> 6) > (k >> 6)).all()
    kp = rng.integers(0, idx.n, B)
    code = rng.integers(0, 6, B)
    fwd = rng.integers(0, 2, B).astype(bool)
    jt = jax_rindex_to_device(idx, **{mode: True})
    pt = rindex_to_device(idx, "cpu", **{mode: True})
    from pangenome_index_tpu.ops.fmd import extend as jax_extend
    from pangenome_index_tpu_torch.ops.fmd import extend

    expect = jax_extend(jt, *(jnp.asarray(a, jnp.int32) for a in (k, kp, s, code)),
                        forward=jnp.asarray(fwd))
    got = extend(pt, *(torch.from_numpy(a.astype(np.int32)) for a in (k, kp, s, code)),
                 forward=torch.from_numpy(fwd))
    for g, e in zip(got, expect):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    for i in range(0, B, 16):
        a, b = (int(kp[i]), int(k[i])) if fwd[i] else (int(k[i]), int(kp[i]))
        ext = (idx.forward_extend if fwd[i] else idx.backward_extend)(
            (int(k[i]), int(kp[i]), int(s[i])), int(code[i]))
        assert tuple(int(g[i]) for g in got) == ext, (i, a, b)


def test_dense_config_matches_pallas_closure(setup):
    """Dense-rank configuration: the JAX engine with rank6 answered by the
    Pallas kernel (interpret mode) against the port on dense tables."""
    idx, codes, lens, s = setup
    jt = jax_rindex_to_device(idx, dense=True)
    kw = seed_kwargs("dense+sdict", s, "jax")

    @jax.jit
    def closure(codes, lens):
        return find_mems_impl(
            jt, codes, lens, MIN_LEN, MIN_OCC, capacity=8,
            rank6_fn=lambda p: rank6_pallas(jt.rec, jt.pos_to_run, p,
                                            interpret=True), **kw)

    expect = closure(jnp.asarray(codes), jnp.asarray(lens))
    pt = rindex_to_device(idx, "cpu", dense=True)
    got = find_mems(pt, torch.from_numpy(codes), torch.from_numpy(lens),
                    MIN_LEN, MIN_OCC, capacity=8,
                    **seed_kwargs("dense+sdict", s, "torch"))
    assert_same(got, expect)


@pytest.mark.parametrize("mode", ["checkpoint", "dense"])
def test_mer_table_matches_host(setup, mode):
    idx, _, _, s = setup
    pt = rindex_to_device(idx, "cpu", **{mode: True})
    got = mertable.build_mer_table_device(pt, MER_M)
    np.testing.assert_array_equal(got.numpy(), s["mt"])


def test_seed_difficulty_matches_jax(setup):
    _, _, lens, s = setup
    expect = jax_seed_difficulty(s["mt"], s["mk"], s["mv"], MIN_OCC,
                                 lengths=lens, m=MER_M)
    got = mertable.seed_difficulty(torch.from_numpy(s["mt"]),
                                   torch.from_numpy(s["mk"]),
                                   torch.from_numpy(s["mv"]), MIN_OCC,
                                   torch.from_numpy(lens), MER_M)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_long_reads_refused(setup):
    idx, _, _, _ = setup
    pt = rindex_to_device(idx, "cpu", checkpoint=True)
    codes = torch.zeros((1, 0xFFFF), dtype=torch.int32)
    with pytest.raises(ValueError, match="65534"):
        find_mems(pt, codes, torch.ones(1, dtype=torch.int32), MIN_LEN, MIN_OCC)
