"""The port's device build of the long-seed dictionary against the JAX
package's builds and the port's own host build, element for element (CPU,
small synthetic index; every value is an integer, tolerance 0).

On CPU tensors the level wrapper (sdict_level) runs its plain PyTorch
version; the kernel of csrc/sparsedict.cu is held against it on the card
(tests/test_torch_cuda.py)."""

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
from pangenome_index_tpu_torch.utils.alphabet import BASE_CODES, KP_WEIGHT


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


def host_level(idx, keys, vals, thresh, level):
    """One level by the host model's rank6, as build_sparse_dict's loop
    body: the kept children of each branch, (keys, vals) per branch, and
    the index of the entry each came from."""
    k, kp, sz = (vals[:, c].astype(np.int64) for c in range(3))
    r_k, r_ks = idx.rank6(k), idx.rank6(k + sz)
    delta = r_ks - r_k
    out = []
    for b, code in enumerate(BASE_CODES):
        code = int(code)
        keep = delta[:, code] >= thresh
        kid = np.stack((r_k[:, code] + idx.C[code],
                        kp + (KP_WEIGHT[code][None, :] * delta).sum(axis=1),
                        delta[:, code]), axis=1)[keep].astype(vals.dtype)
        out.append((keys[keep] | (np.int64(b) << (2 * level)), kid,
                    np.flatnonzero(keep)))
    return out


def regions_of(keys, vals, cuts, fill=-7):
    """The entries cut into len(cuts) + 1 regions of one width, padded with
    a value no entry has: (keys [R, w], vals [R, w, 3], counts)."""
    parts = np.split(np.arange(len(keys)), cuts)
    w = max(max(len(p) for p in parts), 1) + 3
    rk = np.full((len(parts), w), fill, np.int64)
    rv = np.full((len(parts), w, 3), fill, vals.dtype)
    for r, p in enumerate(parts):
        rk[r, : len(p)], rv[r, : len(p)] = keys[p], vals[p]
    return torch.from_numpy(rk), torch.from_numpy(rv), [len(p) for p in parts]


def check_level(idx, t, keys, vals, cuts, thresh, level):
    """sdict_level over the entries cut into regions at `cuts`, against the
    host model: each region holds its branch's kept children in source
    order (zeros after them), totals count them, and offsets[b, j] counts
    the kept children of branch b of the LEVEL_BLOCK-entry blocks before
    block j."""
    rk, rv, counts = regions_of(keys, vals, cuts)
    out_keys, out_vals, offsets, totals = sd.sdict_level(t, rk, rv, counts, thresh,
                                                         level)
    D = len(keys)
    blocks = -(-D // sd.LEVEL_BLOCK)
    assert out_keys.shape == (4, D) and out_vals.shape == (4, D, 3)
    assert offsets.shape == (4, blocks) and totals.shape == (4,)
    for b, (hk, hv, src) in enumerate(host_level(idx, keys, vals, thresh, level)):
        n_b = len(hk)
        assert int(totals[b]) == n_b
        np.testing.assert_array_equal(out_keys[b, :n_b].numpy(), hk)
        np.testing.assert_array_equal(out_vals[b, :n_b].numpy(), hv)
        assert not out_keys[b, n_b:].any() and not out_vals[b, n_b:].any()
        per_block = np.bincount(src // sd.LEVEL_BLOCK, minlength=blocks)
        np.testing.assert_array_equal(offsets[b].numpy(),
                                      np.cumsum(per_block) - per_block)
    return out_keys, out_vals, totals.tolist()


@pytest.mark.parametrize("mode", ["checkpoint", "dense"])
@pytest.mark.parametrize("level,min_keep", [(0, 1), (5, 1), (7, 3), (12, 1),
                                            (18, 2), (30, 1)])
def test_one_level_step(idx, tables, host_builds, level, min_keep, mode):
    """One plain level step takes the frontier of length `level`, in the
    four regions the level before left it in (one a branch), to the one of
    length `level` + 1: its regions, block offsets and totals are the host
    model's, and packed they are the host build's next level."""
    t = tables[mode]
    if level == 0:
        keys, vals = np.zeros(1, np.int64), np.array([[0, 0, idx.n]], np.int32)
        cuts = []
    else:
        keys, vals = host_builds(level, min_keep)
        # the regions of the level before: by the base prepended last
        cuts = np.searchsorted(keys >> (2 * (level - 1)), [1, 2, 3])
    out_keys, out_vals, totals = check_level(idx, t, keys, vals, cuts, min_keep,
                                             level)
    same(sd.sdict_pack(out_keys, out_vals, totals), host_builds(level + 1, min_keep))


@pytest.mark.parametrize("mode", ["checkpoint", "dense"])
@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_level_across_the_block_partition(idx, tables, host_builds, blocks, edge,
                                          mode):
    """Levels of D = k LEVEL_BLOCK - 1, k LEVEL_BLOCK and k LEVEL_BLOCK + 1
    entries (the first D of the s=9 frontier), cut into four regions at
    places that do not fall on a block's edge: with k = 3 the offsets are a
    scan over several blocks."""
    keys, vals = host_builds(9, 1)
    D = blocks * sd.LEVEL_BLOCK + edge
    assert len(keys) > D
    cuts = [D // 5, D // 5 + 1, (3 * D) // 4]
    check_level(idx, tables[mode], keys[:D], vals[:D], cuts, 1, 9)


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
    keys = torch.zeros((4, 3), dtype=torch.int64)
    vals = torch.zeros((4, 3, 3), dtype=torch.int32)
    for bad in ((keys[:, :2], vals, [1, 0, 0, 0]), (keys, vals[:, :, :2], [1, 0, 0, 0]),
                (keys, vals, [1, 0, 0]), (keys, vals, [4, 0, 0, 0]),
                (keys, vals, [0, 0, 0, 0]), (torch.zeros((5, 3), dtype=torch.int64),
                                             torch.zeros((5, 3, 3), dtype=torch.int32),
                                             [1] * 5)):
        with pytest.raises(ValueError, match="must be"):
            sd.sdict_level(t, *bad, 1, 0)
    with pytest.raises(ValueError, match="level must be"):
        sd.sdict_level(t, keys, vals, [1, 0, 0, 0], 1, 31)


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
    launches = sd.sdict_level.launches
    hit = sd.get_sparse_dict(idx, s, path=jpath, min_keep=min_keep,
                             tables=tables["dense"])
    assert isinstance(hit[1], torch.Tensor) and sd.sdict_level.launches == launches
    same(hit, expect)
    assert "rebuilding" not in capfd.readouterr().err


def test_get_sparse_dict_does_not_fall_back(idx, tables, monkeypatch):
    """With tables a failed device build raises: no host build behind it."""
    def broken(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(sd, "sdict_level", broken)
    monkeypatch.setattr(sd, "build_sparse_dict",
                        lambda *a, **k: pytest.fail("fell back to the host build"))
    with pytest.raises(RuntimeError, match="launch failed"):
        sd.get_sparse_dict(idx, 6, tables=tables["checkpoint"])


@pytest.mark.parametrize("extra", [["-s", "12", "--min-keep", "2"],
                                   ["--min-len", "9"],
                                   ["-s", "7", "--engine", "device"]],
                         ids=["s-and-min-keep", "from-min-len", "engine-device"])
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
