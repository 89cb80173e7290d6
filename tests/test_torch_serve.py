"""The PyTorch port's serving pipeline end to end against the native engine,
and its library entry points against the JAX package's (CPU, small index)."""

import numpy as np
import pytest
import torch

import pangenome_index_tpu as jax_pkg
import pangenome_index_tpu_torch as port
from pangenome_index_tpu import native
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu.utils.synth import (build_synth_index, synth_reads,
                                             synth_tag_array)
from pangenome_index_tpu_torch.serve import serve

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


@pytest.mark.parametrize("dense", [False, True])
def test_serve_matches_native(workload, native_result, dense, tmp_path):
    idx, _, _, codes, lens, tags = workload
    out = serve(idx, tags, codes, lens, "cpu", dense=dense, mer_m=6,
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
    assert {"tables", "mer_table", "sdict", "windows", "sort", "mems",
            "tags"} <= set(out.seconds)


def test_library_entry_points_match_jax(workload):
    idx, _, reads, _, _, _ = workload
    few = [r[:60] for r in reads[:8]]
    expect = jax_pkg.find_mems(jax_pkg.to_device(idx), few, 20, 1, capacity=16)
    got = port.find_mems(port.to_device(idx, "cpu"), few, 20, 1, capacity=16)
    assert got == expect
