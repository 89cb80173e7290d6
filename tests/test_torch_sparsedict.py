"""The port's device build of the long-seed dictionary against the JAX
package's builds and the port's own host build, element for element (CPU,
small synthetic index; every value is an integer, tolerance 0).

On CPU tensors the level wrappers (sdict_expand, sdict_scatter) run their
plain PyTorch versions; the kernels of csrc/sparsedict.cu are held against
those on the card (tests/test_torch_cuda.py)."""

import re

import numpy as np
import pytest
import torch

from pangenome_index_tpu import cli as jax_cli
from pangenome_index_tpu.formats import ri as jax_ri
from pangenome_index_tpu.ops import sparsedict as jax_sd
from pangenome_index_tpu.ops.tables import rindex_to_device as jax_tables
from pangenome_index_tpu.utils.synth import build_synth_index
from pangenome_index_tpu_torch import cli
from pangenome_index_tpu_torch.ops import sparsedict as sd
from pangenome_index_tpu_torch.ops.tables import rindex_to_device


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
def tables(idx):
    return {"checkpoint": rindex_to_device(idx, "cpu", checkpoint=True),
            "dense": rindex_to_device(idx, "cpu", dense=True)}


@pytest.fixture(scope="module")
def host_builds(idx):
    """The JAX package's host build, once per (s, min_keep)."""
    made = {}

    def build(s, min_keep):
        if (s, min_keep) not in made:
            made[s, min_keep] = jax_sd.build_sparse_dict(idx, s, min_keep)
        return made[s, min_keep]

    return build


def same(got, expect):
    """(keys, vals) tensors or arrays equal to the numpy pair, dtypes too."""
    keys, vals = (a.numpy() if isinstance(a, torch.Tensor) else a for a in got)
    assert keys.dtype == expect[0].dtype and vals.dtype == expect[1].dtype
    np.testing.assert_array_equal(keys, expect[0])
    np.testing.assert_array_equal(vals, expect[1])


@pytest.mark.parametrize("mode", ["checkpoint", "dense"])
@pytest.mark.parametrize("min_keep", [1, 2])
@pytest.mark.parametrize("s", [1, 8, 16, 19, 30, 31])
def test_device_build_matches_host_builds(idx, tables, host_builds, s, min_keep,
                                          mode):
    expect = host_builds(s, min_keep)
    assert len(expect[0]) > 0 and np.all(np.diff(expect[0]) > 0)
    same(sd.build_sparse_dict_device(idx, tables[mode], s, min_keep), expect)
    if mode == "checkpoint":  # the port's own host build, once per (s, min_keep)
        same(sd.build_sparse_dict(idx, s, min_keep), expect)


@pytest.mark.parametrize("s,min_keep,host_max", [(6, 1, 4), (11, 1, 64),
                                                 (9, 3, 4), (16, 2, 4)])
def test_device_build_matches_jax_device_build(idx, tables, s, min_keep, host_max):
    """Against the JAX frontier program itself, run on the CPU as the JAX
    package's own tests run it (s <= 16: its 30-bit key halves wrap at 31)."""
    expect = jax_sd.build_sparse_dict_device(
        idx, jax_tables(idx, checkpoint=True), s, min_keep=min_keep,
        host_levels_max=host_max)
    same(sd.build_sparse_dict_device(idx.n, tables["checkpoint"], s, min_keep),
         expect)


@pytest.mark.parametrize("mode", ["checkpoint", "dense"])
@pytest.mark.parametrize("level,min_keep", [(0, 1), (5, 1), (7, 3), (12, 1),
                                            (18, 2), (30, 1)])
def test_one_level_step(idx, tables, host_builds, level, min_keep, mode):
    """One plain level step (expand, then scatter) takes the frontier of
    length `level` to the one of length `level` + 1, and its block offsets are
    the places the kept children are written at."""
    t = tables[mode]
    if level == 0:
        keys, vals = np.zeros(1, np.int64), np.array([[0, 0, idx.n]], np.int32)
    else:
        keys, vals = host_builds(level, min_keep)
    keys, vals = torch.from_numpy(keys), torch.from_numpy(vals)
    child_sz, child_kkp, offsets, total = sd.sdict_expand(t, vals, min_keep)
    D, blocks = len(keys), -(-len(keys) // sd.LEVEL_BLOCK)
    assert child_sz.shape == (4, D) and child_kkp.shape == (4, D, 2)
    assert offsets.shape == (4, blocks) and total.shape == (1,)
    kept = torch.nn.functional.pad(child_sz != 0, (0, blocks * sd.LEVEL_BLOCK - D))
    counts = kept.view(4, blocks, -1).sum(dim=2).reshape(-1)
    assert int(total) == int(counts.sum())
    np.testing.assert_array_equal(offsets.reshape(-1).numpy(),
                                  (torch.cumsum(counts, 0) - counts).numpy())
    assert not child_kkp[child_sz == 0].any()
    same(sd.sdict_scatter(keys, child_sz, child_kkp, offsets, int(total), level),
         host_builds(level + 1, min_keep))


def test_empty_dictionary(idx, tables):
    """No substring occurs more often than the index has rows."""
    expect = sd.build_sparse_dict(idx, 5, min_keep=idx.n + 1)
    assert expect[0].shape == (0,) and expect[1].shape == (0, 3)
    same(sd.build_sparse_dict_device(idx, tables["checkpoint"], 5, idx.n + 1),
         expect)
    vals_d, rows_d = sd.sdict_to_device(
        sd.build_sparse_dict_device(idx, tables["dense"], 5, idx.n + 1)[1],
        np.full((2, 4), -1, np.int32), "cpu")
    assert vals_d.shape == (1, 3) and not vals_d.any() and rows_d.shape == (2, 4)


@pytest.mark.parametrize("max_bytes", [0, 1024, 200_000])
def test_budget_refusal(idx, tables, max_bytes):
    with pytest.raises(MemoryError, match=r"level \d+.* needs \d+ bytes"):
        sd.build_sparse_dict_device(idx, tables["checkpoint"], 12,
                                    max_bytes=max_bytes)


def test_build_refuses_bad_arguments(idx, tables):
    t = tables["checkpoint"]
    for s in (0, 32):
        with pytest.raises(ValueError, match="s must be"):
            sd.build_sparse_dict_device(idx, t, s)
    with pytest.raises(ValueError, match="rows"):
        sd.build_sparse_dict_device(idx.n + 1, t, 4)
    z = torch.zeros((3, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="vals must be"):
        sd.sdict_expand(t, z[:, :2], 1)
    with pytest.raises(ValueError, match="children must be"):
        sd.sdict_scatter(torch.zeros(3, dtype=torch.int64), z, z, z, 0, 0)


@pytest.mark.parametrize("s,min_keep", [(7, 1), (19, 2)])
def test_get_sparse_dict_tables_route_shares_the_jax_cache(idx, tables, tmp_path,
                                                           capfd, s, min_keep):
    """The tables route builds on the tables' device, returns keys for the
    host and vals as a tensor, and writes the npz the JAX package reads back
    under the same content key (and the other way round)."""
    expect = jax_sd.build_sparse_dict(idx, s, min_keep)
    path = str(tmp_path / "d.npz")
    keys, vals = sd.get_sparse_dict(idx, s, path=path, min_keep=min_keep,
                                    tables=tables["checkpoint"])
    assert isinstance(keys, np.ndarray) and isinstance(vals, torch.Tensor)
    same((keys, vals), expect)
    with np.load(path, allow_pickle=False) as z:
        assert str(z["key"]) == jax_sd.sparse_dict_key(idx, s, min_keep)
        same((z["keys"], z["vals"]), expect)
    capfd.readouterr()
    same(jax_sd.get_sparse_dict(idx, s, path=path, min_keep=min_keep), expect)
    assert "rebuilding" not in capfd.readouterr().err   # a cache hit there
    # and a file the JAX package wrote is a hit here, vals on the device
    jpath = str(tmp_path / "j.npz")
    jax_sd.get_sparse_dict(idx, s, path=jpath, min_keep=min_keep)
    launches = sd.sdict_expand.launches
    hit = sd.get_sparse_dict(idx, s, path=jpath, min_keep=min_keep,
                             tables=tables["dense"])
    assert isinstance(hit[1], torch.Tensor) and sd.sdict_expand.launches == launches
    same(hit, expect)
    assert "rebuilding" not in capfd.readouterr().err


def test_get_sparse_dict_does_not_fall_back(idx, tables, monkeypatch):
    """With tables a failed device build raises: no host build behind it."""
    def broken(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(sd, "sdict_expand", broken)
    monkeypatch.setattr(sd, "build_sparse_dict",
                        lambda *a, **k: pytest.fail("fell back to the host build"))
    with pytest.raises(RuntimeError, match="launch failed"):
        sd.get_sparse_dict(idx, 6, tables=tables["checkpoint"])


@pytest.mark.parametrize("extra", [["-s", "12", "--min-keep", "2"],
                                   ["--min-len", "9"]],
                         ids=["s-and-min-keep", "from-min-len"])
def test_build_sdict_command_matches_jax(idx, tmp_path, capfd, extra):
    """`build-sdict --device cpu` against the JAX `build-sdict --engine host`:
    the same arrays and content key in the file, the same summary line."""
    ri_path = str(tmp_path / "synth.ri")
    with open(ri_path, "wb") as fh:
        fh.write(jax_ri.serialize_encoded(idx))
    capfd.readouterr()
    assert jax_cli.main(["build-sdict", ri_path, "-o", str(tmp_path / "j.npz"),
                         *extra, "--engine", "host"]) == 0
    jax_err = capfd.readouterr().err
    seconds = {}
    assert cli.main(["build-sdict", ri_path, "-o", str(tmp_path / "p.npz"),
                     *extra, "--device", "cpu"], seconds) == 0
    port_err = capfd.readouterr().err
    with np.load(tmp_path / "j.npz", allow_pickle=False) as j, \
            np.load(tmp_path / "p.npz", allow_pickle=False) as p:
        assert sorted(j.files) == sorted(p.files) == ["key", "keys", "vals"]
        assert str(j["key"]) == str(p["key"])
        same((p["keys"], p["vals"]), (j["keys"], j["vals"]))
        assert len(j["keys"]) > 1000

    def summary(err, name):
        line = [l for l in err.splitlines() if l.startswith("sparse dict s=")]
        assert len(line) == 1
        return re.sub(r"\(\d+\.\ds\)$", "", line[0].replace(name, "X.npz"))

    assert summary(port_err, "p.npz") == summary(jax_err, "j.npz")
    assert {"load", "tables", "sdict"} <= set(seconds)
    # the default artifact path is the one find-mems --long-seed reads
    assert cli.main(["build-sdict", ri_path, "-s", "5", "--device", "cpu"]) == 0
    with np.load(ri_path + ".sdict5.npz", allow_pickle=False) as z:
        assert str(z["key"]) == jax_sd.sparse_dict_key(idx, 5, 1)
