"""The m-mer seed table's plain version (ops/mertable.py: mer_level_plain,
build_mer_table_plain, and build_mer_table_device on CPU tensors) against
the JAX package's build_mer_table_device on JAX's CPU backend and the host
build_mer_table, exactly (every value is an integer: tolerance 0), through
every rank provider at int32 and int64 positions, on a small synthetic
index. The card's level kernel (csrc/mertable.cu) is held against the same
plain version in tests/test_torch_cuda.py and chip_smoke.py; the two-level
int64 rows are held in tests/test_torch_int64.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenome_index_tpu.ops.mertable import build_mer_table, build_mer_table_device
from pangenome_index_tpu.ops.tables import rindex_to_device as jax_rindex_to_device
from pangenome_index_tpu.utils.synth import build_synth_index
from pangenome_index_tpu_torch.ops import mertable
from pangenome_index_tpu_torch.ops.tables import rindex_to_device

#: (rank provider, positions) the port's tables take: ultra rows and dense
#: records are int32 only
CASES = [("checkpoint", "int32"), ("dense", "int32"), ("ultra", "int32"),
         ("bucketed", "int32"), ("checkpoint", "int64"), ("bucketed", "int64")]
DTYPES = {"int32": (torch.int32, jnp.int32), "int64": (torch.int64, jnp.int64)}


@pytest.fixture(autouse=True, scope="module")
def restored():
    """The JAX references run under the type width of their case; the
    process's flag and torch's thread count are restored after the module,
    so that no later test file on this worker computes at 64 bits."""
    prev = jax.config.jax_enable_x64
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def index():
    return build_synth_index(20_000, 4, seed=2)[0]


def port_tables(idx, mode, width):
    return rindex_to_device(idx, "cpu", dtype=DTYPES[width][0], **{mode: True})


def same(got, expect):
    g, e = np.asarray(got), np.asarray(expect)
    assert g.shape == e.shape
    np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("mode,width", CASES, ids=[f"{m}-{w}" for m, w in CASES])
def test_seed_table_plain_matches_jax_and_host(index, mode, width):
    """m = 8: the plain build through each provider equals the JAX device
    build through the JAX package's tables of the same provider and width,
    and the host build; the wrapper on CPU tables is the plain version and
    launches nothing."""
    pt = port_tables(index, mode, width)
    with jax.enable_x64(width == "int64"):
        jt = jax_rindex_to_device(index, dtype=DTYPES[width][1], **{mode: True})
        expect = np.asarray(build_mer_table_device(jt, 8))
    got = mertable.build_mer_table_plain(pt, 8)
    assert got.dtype == DTYPES[width][0] and got.shape == (4**8, 3)
    same(got, expect)
    same(got, build_mer_table(index, 8))
    before = mertable.mer_level.launches
    same(mertable.build_mer_table_device(pt, 8), got)
    assert mertable.mer_level.launches == before


@pytest.mark.parametrize("m", [0, 1, 2, 3, 5])
def test_seed_table_at_every_small_m(index, m):
    """The schedule's edges: m = 0 (the root alone), 1 (one level), 2 (the
    two-deep launch alone), 3 and 5, against the host build."""
    pt = port_tables(index, "checkpoint", "int32")
    same(mertable.build_mer_table_plain(pt, m), build_mer_table(index, m))


@pytest.mark.parametrize("mode,width", [("checkpoint", "int32"), ("bucketed", "int64")],
                         ids=["checkpoint-int32", "bucketed-int64"])
def test_two_deep_level_is_two_levels(index, mode, width, monkeypatch):
    """A level two deep equals two levels one deep, from levels 0 to 3;
    slabs that do not divide the level (7 parents a step) change nothing;
    the wrapper takes CPU tensors to the plain version."""
    pt = port_tables(index, mode, width)
    level = mertable.mer_root(pt)
    assert level.tolist() == [[0, 0, index.n]]
    for _ in range(4):
        one = mertable.mer_level_plain(pt, mertable.mer_level_plain(pt, level))
        same(mertable.mer_level_plain(pt, level, 2), one)
        with monkeypatch.context() as mp:
            mp.setattr(mertable, "PLAIN_SLAB", 7)
            same(mertable.mer_level_plain(pt, level, 2), one)
        same(mertable.mer_level(pt, level, 2), one)
        level = mertable.mer_level(pt, level)
    assert level.shape == (4**4, 3) and level.dtype == DTYPES[width][0]


def test_mer_level_refuses_bad_shapes(index):
    pt = port_tables(index, "checkpoint", "int32")
    for parents, depth in ((torch.zeros((5, 3), dtype=torch.int32), 1),
                           (torch.zeros((4, 2), dtype=torch.int32), 1),
                           (torch.zeros((4, 3), dtype=torch.int32), 3),
                           (torch.zeros((4, 3), dtype=torch.int32), 0)):
        with pytest.raises(ValueError, match="mer_level"):
            mertable.mer_level(pt, parents, depth)


def test_mer_table_bytes_is_the_last_launch():
    """The build's peak: the last launch reads level m - 2 and writes the
    table (the levels before it are smaller)."""
    assert mertable.mer_table_bytes(14) == 3 * 4 * (4**14 + 4**12)
    assert mertable.mer_table_bytes(13, 8) == 3 * 8 * (4**13 + 4**11)
    assert mertable.mer_table_bytes(1) == 3 * 4 * (4 + 1)
    assert mertable.mer_table_bytes(14, 4, 1) == 3 * 4 * (4**14 + 4**13)
    for m in range(2, 15):
        for depth in (1, 2):
            assert all(mertable.mer_table_bytes(m, 4, depth) > 3 * 4 * (4**(v + 1) + 4**v)
                       for v in range(m - depth))


@pytest.mark.parametrize("mode", ["checkpoint", "dense", "ultra", "bucketed"])
def test_last_launch_depth_follows_the_provider(index, mode, monkeypatch):
    """The last launch is two levels deep except through int64 bucketed
    runs; the build makes max(m - depth + 1, 1) level calls, the last one
    last_depth levels deep, and get_mer_table's need is that schedule's
    peak."""
    pt = port_tables(index, mode, "int32")
    depth = mertable.last_depth(pt)
    assert depth == 2
    if mode == "bucketed":
        assert mertable.last_depth(port_tables(index, mode, "int64")) == 1
    calls = []

    def level(t, parents, d):
        calls.append(d)
        return mertable.mer_level_plain(t, parents, d)

    for m in (1, 2, 5):
        calls.clear()
        same(mertable.build_mer_table_device(pt, m, level=level),
             build_mer_table(index, m))
        assert calls == [1] * (m - min(m, depth)) + [min(m, depth)]
    needs = []
    monkeypatch.setattr(mertable, "build_mer_table_device",
                        lambda t, m: needs.append(m) or mertable.build_mer_table_plain(t, m))
    with pytest.raises(MemoryError, match=str(mertable.mer_table_bytes(4, 4, depth))):
        mertable.get_mer_table(index, 6, pt, max_bytes=mertable.mer_table_bytes(4, 4, depth) - 1)
    assert needs == []
