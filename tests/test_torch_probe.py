"""The port's gather-rate probe kernels (K5) against the JAX probe, exactly:
row_gather against the Pallas kernel make_pallas_rowdma run in interpret
mode, gather_chain against the XLA program xla_gather_loop (CPU: the port's
plain versions and its wrappers on CPU tensors)."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenome_index_tpu_torch.ops import gather_probe

PROBE = pathlib.Path(__file__).resolve().parent.parent / "examples" / "gather_pipeline_probe.py"
ROWS, BATCH = 1000, 256


@pytest.fixture(scope="module")
def probe():
    """examples/ is not a package: load the JAX probe by its path."""
    spec = importlib.util.spec_from_file_location("gather_pipeline_probe", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(0)
    return rng.integers(0, 1 << 20, (ROWS, gather_probe.WIDTH)).astype(np.int32)


def grouped(group, seed):
    """Group-aligned starts, each repeated `group` times, as the probe's
    grouped sweep makes them (gather_pipeline_probe.py:172-173)."""
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, (ROWS - group) // group, BATCH // group) * group)
            .repeat(group).astype(np.int32))


@pytest.mark.parametrize("group", [1, 8])
def test_row_gather_matches_pallas_rowdma(probe, table, group, monkeypatch):
    monkeypatch.setenv("PROBE_INTERPRET", "1")
    idx = grouped(group, seed=group)
    expect = np.asarray(probe.make_pallas_rowdma(4, group)(jnp.asarray(table),
                                                           jnp.asarray(idx)))
    T, I = torch.from_numpy(table), torch.from_numpy(idx)
    rows = gather_probe.row_gather_plain(T, I, group)
    # the sum over rows stays outside the kernel, as in JAX; torch sums int32
    # into int64, JAX keeps int32 (wrapping)
    np.testing.assert_array_equal(rows.sum(0).to(torch.int32).numpy(), expect)
    # row j*G + g is T[idx[j*G] + g], not T[idx[j*G + g]]
    src = idx[::group, None] + np.arange(group)[None, :]
    np.testing.assert_array_equal(rows.numpy(), table[src.reshape(-1)])
    for depth in gather_probe.DEPTHS:
        assert torch.equal(gather_probe.row_gather(T, I, group, depth), rows)


@pytest.mark.parametrize("call,match", [
    (lambda T: gather_probe.row_gather(T, torch.zeros(12, dtype=torch.int32), 8),
     "multiple of the group"),
    (lambda T: gather_probe.row_gather(T, torch.zeros((4, 2), dtype=torch.int32)),
     "indices must be"),
    (lambda T: gather_probe.gather_chain(T, torch.zeros((4, 2), dtype=torch.int32)),
     "indices must be"),
    (lambda T: gather_probe.row_gather(T, torch.zeros(8, dtype=torch.int32), 1, 2),
     "depth must be"),
], ids=["ragged-group", "row-gather-2d", "chain-2d", "depth"])
def test_probe_refuses_bad_shapes(table, call, match):
    with pytest.raises(ValueError, match=match):
        call(torch.from_numpy(table))


def test_gather_chain_matches_xla_loop(probe, table):
    idx = np.random.default_rng(1).integers(0, ROWS, BATCH).astype(np.int32)
    # a test file run earlier by this worker may have switched jax to 64-bit
    # types (the JAX package does so when it makes int64 tables), under which
    # the probe's sum would not wrap: the probe's own types are 32 bits
    with jax.enable_x64(False):
        expect = int(probe.xla_gather_loop(jnp.asarray(table), jnp.asarray(idx)))
    T, I = torch.from_numpy(table), torch.from_numpy(idx)
    acc = gather_probe.gather_chain_plain(T, I, probe.ITERS)
    assert acc.dtype == torch.int32
    # 64 steps x 256 lanes of values below 2^20 wrap the int32 sum
    assert int(acc.long().sum()) >= 2**31
    assert int(acc.sum().to(torch.int32)) == expect
    assert torch.equal(gather_probe.gather_chain(T, I, probe.ITERS), acc)
