"""The PyTorch port's serving pipeline end to end against the native engine,
and its library entry points against the JAX package's (CPU, small index)."""

import jax
import numpy as np
import pytest
import torch

import pangenome_index_tpu as jax_pkg
import pangenome_index_tpu_torch as port
from pangenome_index_tpu import native
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu.utils.synth import (build_synth_index, synth_reads,
                                             synth_tag_array)
from pangenome_index_tpu_torch.mems_probe import mixed_reads
from pangenome_index_tpu_torch.serve import RANK_MODES, prepare, serve

CAP = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workload():
    idx, lines = build_synth_index(20_000, 4, seed=2)
    reads = synth_reads(lines, 64, 150, error_rate=0.01, seed=1)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                      for r in reads]).astype(np.int32)
    lens = np.full(len(reads), 150, np.int32)
    return idx, lines, reads, codes, lens, synth_tag_array(idx, lines=lines)


@pytest.fixture(scope="module")
def native_result(workload):
    idx, _, _, codes, lens, tags = workload
    s, e, b, z, cnt = native.find_mems_native(idx, codes, lens, 20, 1,
                                              capacity=CAP, n_threads=0)
    return s, e, b, z, cnt


@pytest.mark.parametrize("rank_mode", RANK_MODES)
def test_serve_matches_native(workload, native_result, rank_mode, tmp_path):
    idx, _, _, codes, lens, tags = workload
    out = serve(idx, tags, codes, lens, "cpu", rank_mode=rank_mode, mer_m=6,
                sdict_s=19, sdict_path=str(tmp_path / "sdict.npz"),
                capacity=CAP, tag_capacity=8)
    s, e, b, z, cnt = native_result
    np.testing.assert_array_equal(out.count, cnt)
    for got, expect in ((out.start, s), (out.end, e), (out.bwt_start, b),
                        (out.size, z)):
        np.testing.assert_array_equal(got, expect)
    assert out.dict_entries > 0 and out.dict_hit_rate > 0.5
    # tag unique counts per buffered MEM, as bench.py cross-checks them
    eff = np.minimum(cnt, CAP)
    ii = np.repeat(np.arange(len(cnt)), eff)
    within = np.arange(len(ii)) - np.repeat(np.cumsum(eff) - eff, eff)
    qs = b[ii, within]
    _, tuniq, _ = native.query_tags_native(tags, qs, qs + z[ii, within] - 1,
                                           capacity=256, n_threads=0)
    ok = ~out.tag_ov[ii, within]
    assert ok.all()
    np.testing.assert_array_equal(out.tag_nu[ii, within][ok], tuniq[ok])
    assert not out.tag_nu[out.count[:, None] <= np.arange(CAP)[None, :]].any()
    assert {"tables", "mer_table", "sdict", "windows", "upload", "fetch"} <= set(out.seconds)
    assert "sort" not in out.seconds


@pytest.mark.parametrize("rank_mode", RANK_MODES)
def test_serve_mixed_batch_in_input_order(workload, rank_mode, tmp_path):
    """Reads of 50 to 1000 bp with 0 to 10% errors, unsorted: every result row
    is its own read's (the native engine's, in input order), and the batch
    `prepare` builds holds the reads as they were given."""
    idx, lines, _, _, _, tags = workload
    codes, lens = mixed_reads(lines, 48, seed=9)
    assert lens.min() >= 50 and lens.max() <= 1000 and len(set(lens)) > 40
    path = str(tmp_path / "sdict.npz")
    batch = prepare(idx, tags, codes, lens, "cpu", rank_mode=rank_mode, mer_m=6,
                    sdict_s=19, sdict_path=path)
    np.testing.assert_array_equal(batch.codes.numpy(), codes)
    np.testing.assert_array_equal(batch.lengths.numpy(), lens)
    assert not hasattr(batch, "order")
    out = serve(idx, tags, codes, lens, "cpu", rank_mode=rank_mode, mer_m=6, sdict_s=19,
                sdict_path=path, capacity=CAP, tag_capacity=8)
    s, e, b, z, cnt = native.find_mems_native(idx, codes, lens, 20, 1,
                                              capacity=CAP, n_threads=0)
    np.testing.assert_array_equal(out.count, cnt)
    for got, expect in ((out.start, s), (out.end, e), (out.bwt_start, b),
                        (out.size, z)):
        np.testing.assert_array_equal(got, expect)
    assert len(set(cnt)) > 5  # unlike reads: a permuted answer would differ


def test_serve_builds_the_dictionary_from_its_tables(workload, tmp_path):
    """A cold cache is filled by the device build (the level wrapper runs),
    a warm one is read, and both serve the same dictionary as the host build."""
    from pangenome_index_tpu_torch.ops import sparsedict as sd

    idx, _, _, codes, lens, tags = workload
    path = str(tmp_path / "sdict.npz")
    before = sd.sdict_level.launches
    cold = prepare(idx, tags, codes[:4], lens[:4], "cpu", mer_m=6, sdict_s=12,
                   sdict_path=path)
    warm = prepare(idx, tags, codes[:4], lens[:4], "cpu", mer_m=6, sdict_s=12,
                   sdict_path=path)
    assert sd.sdict_level.launches == before  # CPU tensors: the plain version
    keys, vals = sd.build_sparse_dict(idx, 12)
    for b in (cold, warm):
        assert b.dict_entries == len(keys)
        np.testing.assert_array_equal(b.seed_kw["sdict_vals"].numpy(), vals)
    with np.load(path, allow_pickle=False) as z:
        np.testing.assert_array_equal(z["keys"], keys)


def test_library_entry_points_match_jax(workload):
    idx, _, reads, _, _, _ = workload
    few = [r[:60] for r in reads[:8]]
    # a test file run earlier by this worker may have switched jax to 64-bit
    # types (the JAX package does so when it makes int64 tables), which its
    # int32 MEM loop does not take: this index needs the default, 32 bits
    with jax.enable_x64(False):
        expect = jax_pkg.find_mems(jax_pkg.to_device(idx), few, 20, 1, capacity=16)
    got = port.find_mems(port.to_device(idx, "cpu"), few, 20, 1, capacity=16)
    assert got == expect
