"""The port's CUDA kernels against their plain PyTorch versions on the card,
exactly. Needs an NVIDIA Hopper GPU and nvcc; skipped elsewhere. Run on the
card with: python -m pytest tests/test_torch_cuda.py -q"""

import numpy as np
import pytest
import torch

from pangenome_index_tpu.ops.mertable import build_mer_table, read_mer_keys_fast
from pangenome_index_tpu.ops.sparsedict import build_sparse_dict, read_windows_fast
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu.utils.synth import (build_synth_index, synth_reads,
                                             synth_tag_array)
from pangenome_index_tpu_torch.ops import dense_rank, fmd, mems, tagquery
from pangenome_index_tpu_torch.ops.tables import rindex_to_device, tags_to_device

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def index():
    return build_synth_index(20_000, 4, seed=2)


def test_gather_rows_and_rank6_dense(dev, index):
    idx, _ = index
    t = rindex_to_device(idx, dev, dense=True)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.integers(0, idx.n + 1, 1001).astype(np.int32)).to(dev)
    assert torch.equal(dense_rank.rank6_dense(t.rec, t.pos_to_run, pos),
                       dense_rank.rank6_dense_plain(t.rec, t.pos_to_run, pos))
    rows = torch.from_numpy(rng.integers(-5, idx.n_runs + 5, 777).astype(np.int32)).to(dev)
    assert torch.equal(dense_rank.gather_rows(t.rec, rows),
                       dense_rank.gather_rows_plain(t.rec, rows))


@pytest.mark.parametrize("mode", ["checkpoint", "dense"])
def test_extend(dev, index, mode):
    idx, _ = index
    t = rindex_to_device(idx, dev, **{mode: True})
    rng = np.random.default_rng(1)
    B = 4099
    k = rng.integers(0, idx.n, B)
    s = rng.integers(0, idx.n - k + 1)
    args = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (k, rng.integers(0, idx.n, B), s, rng.integers(0, 6, B))]
    for fwd in (None, torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)):
        got = fmd.extend(t, *args, forward=fwd)
        expect = fmd.extend_plain(t, *args, forward=fwd)
        for g, e in zip(got, expect):
            assert torch.equal(g, e)


@pytest.mark.parametrize("mode", ["checkpoint", "dense"])
def test_find_mems_and_tags(dev, index, mode):
    idx, lines = index
    t = rindex_to_device(idx, dev, **{mode: True})
    reads = synth_reads(lines, 200, 150, error_rate=0.02, seed=3)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
                      for r in reads]).astype(np.int32)
    lens = np.full(len(reads), 150, np.int32)
    mk, mv = read_mer_keys_fast(codes, lens, 8)
    keys, vals = build_sparse_dict(idx, 19)
    _, _, di = read_windows_fast(codes, lens, 19, keys)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    kw = dict(mer_table=T(build_mer_table(idx, 8).astype(np.int32)),
              mer_keys=T(mk), mer_valid=T(mv), mer_m=8, sdict_vals=T(vals),
              sdict_idx=T(di), sdict_m=19)
    got, gs = mems.find_mems(t, T(codes), T(lens), 20, 1, capacity=8,
                             with_stats=True, **kw)
    expect, es = mems.find_mems_plain(t, T(codes), T(lens), 20, 1, capacity=8,
                                      with_stats=True, **kw)
    for g, e in zip(got, expect):
        assert torch.equal(g, e)
    assert torch.equal(gs["steps"], es["steps"])
    tt = tags_to_device(synth_tag_array(idx, lines=lines), dev)
    for g, e in zip(tagquery.query_mem_tags(tt, got.bwt_start, got.size, got.count, 8),
                    tagquery.query_mem_tags_plain(tt, got.bwt_start, got.size,
                                                  got.count, 8)):
        assert torch.equal(g, e)


def test_kernels_refuse_two_level_tables(dev, index):
    idx, _ = index
    t = rindex_to_device(idx, dev, checkpoint=True, super_shift=9)
    z = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="two-level"):
        fmd.extend(t, z, z, z, z)
